"""Replay a ``carmen-serve-trace`` through the simulated PE array (the port's
own copy of ``repro.sim.replay``: a trace either package writes replays to
the same accounting).

The replayer streams a serving trace (:func:`repro_torch.obs.iter_trace` — O(1)
memory) and schedules every recorded span onto an :class:`ArrayConfig`:

* **prefill spans** — one pass of the whole weight bank at the span's
  execution point for the padded bucket's positions (the engine pads
  prompts to pow2 buckets; the array pays for the padding, so does the sim).
  Streaming-frontend traces carry ``prefill_chunk`` spans instead (one pass
  per chunk bucket; only the final chunk syncs the host) — both vocabularies
  replay, and ``admission_tick`` instants are counted.
* **burst spans** — ``steps`` bank passes with ``slots`` activation rows
  each (the burst scan computes every slot row every step, drained or not —
  the sim charges what the engine executes, not what it emits).
* **speculative rounds** — ``draft_len`` single-step passes at the draft
  point plus one multi-position verify pass at the verify point
  (``slots * (draft_len+1)`` rows).
* **controller switches** — ``switch_cycles`` each; **host round-trips** —
  ``host_sync_cycles`` per synced span, kept in their own phase (array
  idle, excluded from savings, included in predicted wall).

Traces are self-contained: the header's ``engine`` block (per-weight shape +
per-point depth/bits table, written by ``BatchedServer``) supplies the cost
model inputs, so replay needs no model reconstruction.

Attribution comes out per phase (prefill / decode / spec_draft / spec_verify
/ switch / host_sync), per execution point (with the measured wall time of
the same spans next to the predicted cycles), per layer, and per request
(span cost split proportionally over the tokens each request landed in it).

Two accountings come out of one replay, on purpose:

* **Totals / phases / layers / requests** charge what the array *executes*:
  padded prefill buckets, drained-but-computed slot rows, host idle. That
  is the honest utilization picture (PE occupancy, stalls).
* **Savings** (``est_cycle_savings_frac``) charges what the serving loop's
  telemetry charges — emitted tokens, at the simulator's per-token bank-pass
  cost for the executed point vs the reference point. Same token weighting
  as ``TelemetryRecorder``/``SpecTelemetry``, so the simulator's savings is
  directly comparable to the reported value and the comparison isolates
  exactly the *cost model* (depths, formats, overheads, stalls): drift
  beyond tolerance means the cycle model disagrees, not that the two sides
  counted different tokens. The reference's ``bench_sim`` gates this drift.

CLI::

    python -m repro_torch.sim.replay trace.jsonl --report [--json out.json]
        [--calibration calib.json] [--pes 256]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.trace import iter_trace

from .array import ArrayConfig, CostBreakdown, dot_pass_cost

__all__ = ["ReplayResult", "replay_trace"]


@dataclasses.dataclass
class ReplayResult:
    """Everything one replay produced (JSON-able via ``analyze.report_dict``)."""

    meta: Dict                      # the trace's run metadata
    config: Dict                    # ArrayConfig as a dict
    totals: Dict                    # cycle totals + occupancy
    phases: Dict[str, float]        # phase -> array cycles
    points: Dict[str, Dict]         # point -> predicted + measured aggregates
    layers: Dict[str, float]        # layer -> array cycles
    requests: Dict[str, Dict]       # rid -> tokens + attributed cycles
    counts: Dict[str, int]
    savings: Dict                   # predicted vs reported savings_frac
    measured: Dict                  # wall clock derived from the trace itself


class _BankCost:
    """Per-point bank-pass costs from the trace header's engine block."""

    def __init__(self, engine: Dict, cfg: ArrayConfig):
        self.cfg = cfg
        self.reference = engine["reference"]
        self.point_names = list(engine["points"])
        self.layers = engine["layers"]
        self._cache: Dict[Tuple[str, int], Tuple[CostBreakdown, List]] = {}

    def resolve(self, point: Optional[str]) -> str:
        if point is None:
            return "static" if "static" in self.point_names else self.reference
        return point

    def per_token(self, point: str) -> float:
        """Cycles one token (one activation row) costs through the bank at
        ``point`` — the simulator's refinement of the bank's
        ``cycles_per_token`` analytic estimate."""
        return self.pass_cost(point, 1)[0].total

    def pass_cost(self, point: str, positions: int):
        """(total CostBreakdown, [(layer, cycles)]) of one bank pass."""
        key = (point, positions)
        if key not in self._cache:
            total = CostBreakdown()
            per_layer = []
            for row in self.layers:
                shape = row["shape"]
                if len(shape) == 1:
                    k, n, reps = 1, shape[0], 1
                else:
                    k, n = shape[-2], shape[-1]
                    reps = 1
                    for s in shape[:-2]:
                        reps *= s
                pt = row["points"].get(point)
                if pt is None:  # point unknown to this layer: price at ref
                    pt = row["points"][self.reference]
                c = dot_pass_cost(self.cfg, k, n, pt["depth"],
                                  positions=positions, bits=pt.get("bits", 8),
                                  reps=reps)
                total = total + c
                per_layer.append((row["layer"], c.total))
            self._cache[key] = (total, per_layer)
        return self._cache[key]


class _Replayer:
    def __init__(self, header: Dict, cfg: ArrayConfig):
        meta = header.get("run") or header.get("meta") or {}
        engine = meta.get("engine")
        if engine is None:
            raise ValueError(
                "trace carries no engine cost table — record it with a "
                "precision-mode server (carmen/int8/kernel); exact-mode "
                "traces have no depth knob to attribute cycles to")
        self.header = header
        self.meta = meta
        self.cfg = cfg
        self.bank = _BankCost(engine, cfg)
        self.slots = int(meta.get("slots", 1))
        self.draft_len = int(meta.get("draft_len", 0))
        self.verify_point = meta.get("verify_point")
        # accumulators
        self.phase: Dict[str, float] = {}
        self.points: Dict[str, Dict] = {}
        self.layers: Dict[str, float] = {}
        self.requests: Dict[str, Dict] = {}
        self.counts = {"prefills": 0, "prefill_chunks": 0, "bursts": 0,
                       "spec_rounds": 0, "switches": 0, "tokens": 0,
                       "admission_ticks": 0}
        self.breakdown = CostBreakdown()
        self.host_cycles = 0.0
        self.switch_cycles = 0.0
        # savings accounting (vs reference): the adaptive mirror covers
        # prefill + decode bursts (what TelemetryRecorder charges), the
        # speculative mirror covers draft/verify rounds (SpecTelemetry)
        self.est_cycles = 0.0
        self.baseline_cycles = 0.0
        self.spec_est = 0.0
        self.spec_baseline = 0.0
        self.run_span = [None, None]
        self._open: Dict[Tuple[str, str], Dict] = {}
        self._pending_tokens: Dict[str, int] = {}
        self._prefill_point: Dict[str, str] = {}

    # -- charging -------------------------------------------------------------

    def _point_acc(self, point: str) -> Dict:
        return self.points.setdefault(point, {
            "cycles": 0.0, "steps": 0, "spans": 0, "tokens": 0, "wall_s": 0.0})

    def _req_acc(self, rid) -> Dict:
        return self.requests.setdefault(str(rid), {"tokens": 0, "cycles": 0.0})

    def _charge(self, phase: str, point: str, positions: int, steps: int,
                *, wall_s: float, tokens: int, rid=None) -> None:
        cost, per_layer = self.bank.pass_cost(point, positions)
        cost = cost.scale(steps)
        self.breakdown = self.breakdown + cost
        self.phase[phase] = self.phase.get(phase, 0.0) + cost.total
        for name, cyc in per_layer:
            self.layers[name] = self.layers.get(name, 0.0) + cyc * steps
        acc = self._point_acc(point)
        acc["cycles"] += cost.total
        acc["steps"] += steps
        acc["spans"] += 1
        acc["tokens"] += tokens
        acc["wall_s"] += wall_s
        # request attribution: full span to rid (prefill), else proportional
        # to tokens landed in the span
        if rid is not None:
            self._req_acc(rid)["cycles"] += cost.total
        elif self._pending_tokens:
            landed = sum(self._pending_tokens.values())
            for r, ntok in self._pending_tokens.items():
                req = self._req_acc(r)
                req["tokens"] += ntok
                req["cycles"] += cost.total * ntok / landed

    def _charge_savings(self, point: str, tokens: int) -> None:
        """Token-weighted savings accounting (the TelemetryRecorder mirror:
        tokens at the sim's per-token cost for ``point`` vs reference)."""
        if tokens <= 0:
            return
        self.est_cycles += tokens * self.bank.per_token(point)
        self.baseline_cycles += tokens * self.bank.per_token(self.bank.reference)

    # -- event dispatch -------------------------------------------------------

    def feed(self, ev: Dict) -> None:
        ph, name, track = ev["ph"], ev["name"], ev.get("track", "engine")
        args = ev.get("args", {})
        if ph == "B":
            self._open[(track, name)] = {"ts": ev["ts"], **args}
            if name in ("burst", "spec"):
                self._pending_tokens = {}
            elif name == "run":
                self.run_span[0] = ev["ts"]
            return
        if ph == "I":
            self._instant(name, args)
            return
        span = self._open.pop((track, name), {"ts": ev["ts"]})
        merged = {**span, **args}  # close_open Es carry no args: B's stand in
        wall = ev["ts"] - span["ts"]
        if name == "prefill":
            point = self.bank.resolve(merged.get("point"))
            bucket = int(merged.get("bucket", 1))
            self.counts["prefills"] += 1
            self._charge("prefill", point, bucket, 1, wall_s=wall, tokens=1,
                         rid=merged.get("rid"))
            # savings charge (prompt_len tokens) lands on the
            # request_prefilled instant that follows — it carries the
            # unpadded length the telemetry charged
            self._prefill_point[str(merged.get("rid"))] = point
            self.host_cycles += self.cfg.host_sync_cycles
        elif name == "prefill_chunk":
            # chunked (streaming-frontend) prefill: one bank pass per chunk
            # at the chunk's padded bucket; only the FINAL chunk runs the
            # admit program and syncs the host, so only it counts as a
            # completed prefill / pays host_sync. The request_prefilled
            # instant that follows the final chunk carries the savings
            # charge, same as the monolithic span.
            point = self.bank.resolve(merged.get("point"))
            bucket = int(merged.get("bucket", 1))
            final = bool(merged.get("final"))
            self.counts["prefill_chunks"] += 1
            self._charge("prefill", point, bucket, 1, wall_s=wall,
                         tokens=1 if final else 0, rid=merged.get("rid"))
            if final:
                self.counts["prefills"] += 1
                self._prefill_point[str(merged.get("rid"))] = point
                self.host_cycles += self.cfg.host_sync_cycles
        elif name == "burst":
            point = self.bank.resolve(merged.get("point"))
            steps = int(merged.get("steps", 0))
            tokens = int(merged.get("tokens", 0))
            if steps:
                self.counts["bursts"] += 1
                self._charge("decode", point, self.slots, steps,
                             wall_s=wall, tokens=tokens)
                self._charge_savings(point, tokens)
                self.host_cycles += self.cfg.host_sync_cycles
        elif name == "spec":
            self._spec_round(merged, wall)
            self.host_cycles += self.cfg.host_sync_cycles
        elif name == "run":
            self.run_span[1] = ev["ts"]

    def _spec_round(self, merged: Dict, wall: float) -> None:
        draft = self.bank.resolve(merged.get("point"))
        verify = self.bank.resolve(self.verify_point)
        tokens = int(merged.get("tokens", 0))
        active = len(merged.get("accepted") or []) or self.slots
        k = self.draft_len
        self.counts["spec_rounds"] += 1
        # k draft steps (all slot rows), then one verify pass over
        # slots * (k+1) positions
        self._charge("spec_draft", draft, self.slots, k, wall_s=wall,
                     tokens=0)
        self._charge("spec_verify", verify, self.slots * (k + 1), 1,
                     wall_s=0.0, tokens=tokens)
        # savings: the SpecTelemetry mirror in sim units — per active slot,
        # k draft tokens + one verify token vs the emitted tokens served at
        # the verify point
        self.spec_est += active * (k * self.bank.per_token(draft)
                                   + self.bank.per_token(verify))
        self.spec_baseline += tokens * self.bank.per_token(verify)

    def _instant(self, name: str, args: Dict) -> None:
        if name == "tokens":
            rid = str(args.get("rid"))
            n = int(args.get("n", 0))
            self._pending_tokens[rid] = self._pending_tokens.get(rid, 0) + n
            self.counts["tokens"] += n
        elif name == "request_prefilled":
            req = self._req_acc(args.get("rid"))
            req["tokens"] += 1
            req["prompt_len"] = args.get("prompt_len")
            self.counts["tokens"] += 1
            point = self._prefill_point.pop(str(args.get("rid")), None)
            if point is not None:
                self._charge_savings(point, int(args.get("prompt_len") or 0))
        elif name == "controller_switch":
            self.counts["switches"] += 1
            self.switch_cycles += self.cfg.switch_cycles
            self.phase["switch"] = self.phase.get("switch", 0.0) \
                + self.cfg.switch_cycles
        elif name == "request_submitted":
            self._req_acc(args.get("rid"))["prompt_len"] = args.get("prompt_len")
        elif name == "admission_tick":
            self.counts["admission_ticks"] += 1

    # -- result ---------------------------------------------------------------

    def result(self) -> ReplayResult:
        bd = self.breakdown
        array_cycles = bd.total + self.switch_cycles
        total_cycles = array_cycles + self.host_cycles
        self.phase["host_sync"] = self.host_cycles
        occupancy = (bd.ideal_macs / (self.cfg.n_pes * array_cycles)
                     if array_cycles > 0 else 0.0)
        reported = {rec.get("kind"): rec
                    for rec in self.header.get("telemetry") or []}

        def _savings(est, baseline, kind):
            frac = 1.0 - est / baseline if baseline > 0 else 0.0
            rec = reported.get(kind)
            rel_diff = None
            if rec is not None and rec.get("est_cycle_savings_frac"):
                r = float(rec["est_cycle_savings_frac"])
                rel_diff = abs(frac - r) / max(abs(r), 1e-12)
            return {
                "est_cycles": est,
                "baseline_cycles": baseline,
                "est_cycle_savings_frac": frac,
                "reported": rec,
                "rel_diff_vs_reported": rel_diff,
            }

        adaptive = _savings(self.est_cycles, self.baseline_cycles, "adaptive")
        wall = None
        if self.run_span[0] is not None and self.run_span[1] is not None:
            wall = self.run_span[1] - self.run_span[0]
        sec = self.cfg.sec_per_cycle
        return ReplayResult(
            meta={kk: v for kk, v in self.meta.items() if kk != "engine"},
            config=dataclasses.asdict(self.cfg),
            totals={
                "array_cycles": array_cycles,
                "host_sync_cycles": self.host_cycles,
                "total_cycles": total_cycles,
                "compute_cycles": bd.compute,
                "weight_stall_cycles": bd.weight_stall,
                "af_stall_cycles": bd.af_stall,
                "switch_cycles": self.switch_cycles,
                "ideal_macs": bd.ideal_macs,
                "pe_occupancy": occupancy,
                "predicted_wall_s": (total_cycles * sec
                                     if sec is not None else None),
            },
            phases=dict(self.phase),
            points={p: dict(a) for p, a in self.points.items()},
            layers=dict(self.layers),
            requests=dict(self.requests),
            counts=dict(self.counts),
            savings={
                "reference": self.bank.reference,
                **adaptive,
                "speculative": (_savings(self.spec_est, self.spec_baseline,
                                         "speculative")
                                if self.counts["spec_rounds"] else None),
            },
            measured={
                "wall_s": wall,
                "tokens": self.counts["tokens"],
                "tok_s": (self.counts["tokens"] / wall
                          if wall and wall > 0 else None),
            },
        )


def replay_trace(path: str, *, cfg: Optional[ArrayConfig] = None,
                 calibration: Optional[Dict] = None) -> ReplayResult:
    """Replay the trace at ``path`` onto ``cfg`` (default: 256-PE array built
    from ``calibration``, or the ideal analytic array). Streaming: the event
    list is never materialized."""
    if cfg is None:
        cfg = ArrayConfig.from_calibration(calibration)
    with iter_trace(path) as tr:
        rp = _Replayer(tr.header, cfg)
        for ev in tr:
            rp.feed(ev)
    return rp.result()


def main(argv: Optional[list] = None) -> None:
    from . import analyze
    from .calibrate import load_calibration

    ap = argparse.ArgumentParser(
        description="Replay a carmen-serve-trace through the PE-array "
                    "simulator")
    ap.add_argument("trace", help="carmen-serve-trace JSONL path")
    ap.add_argument("--report", action="store_true",
                    help="print the human-readable attribution report")
    ap.add_argument("--json", default=None,
                    help="write the full structured report to this path")
    ap.add_argument("--calibration", default=None,
                    help="sim.calibrate export (either package) to build the array from")
    ap.add_argument("--pes", type=int, default=256)
    args = ap.parse_args(argv)

    calibration = load_calibration(args.calibration) if args.calibration \
        else None
    cfg = ArrayConfig.from_calibration(calibration, n_pes=args.pes)
    result = replay_trace(args.trace, cfg=cfg)
    report = analyze.report_dict(result)
    if args.json:
        import os

        d = os.path.dirname(args.json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    if args.report or not args.json:
        print(analyze.render(result))
    else:
        print(json.dumps(report["totals"], indent=2))


if __name__ == "__main__":
    main()
