"""Attribution reports over a :class:`repro_torch.sim.replay.ReplayResult`
(the port's own copy of ``repro.sim.analyze``).

Two renderings of one replay:

* :func:`report_dict` — the full structured report (JSON-able): totals,
  phase/point/layer/request attribution, predicted-vs-reported savings, and
  the per-point predicted-vs-measured comparison rows.
* :func:`render` — the human-readable table (what
  ``python -m repro_torch.sim.replay trace.jsonl --report`` prints).

Plus the two checks the reference's ``bench_sim`` gates on:

* :func:`ordering_inversions` — per-config (or per-point) predicted cycle
  ordering vs measured wall ordering. Only pairs whose *predicted* costs
  differ by more than ``margin`` are comparable — CPU-measured near-ties
  (the fast error-model's wall time barely depends on depth) are excluded
  rather than letting scheduler noise flip a gate.
* :func:`savings_drift` — relative divergence of the simulator's
  ``est_cycle_savings_frac`` from the serving loop's reported value.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .replay import ReplayResult

__all__ = ["ordering_inversions", "render", "report_dict", "savings_drift"]


def report_dict(result: ReplayResult) -> Dict:
    """The full structured replay report (stable JSON shape)."""
    points = {}
    for name, acc in sorted(result.points.items()):
        steps = max(acc["steps"], 1)
        points[name] = dict(
            acc,
            cycles_per_step=acc["cycles"] / steps,
            measured_wall_s_per_step=(acc["wall_s"] / steps
                                      if acc["wall_s"] else None),
        )
    return {
        "meta": result.meta,
        "array": result.config,
        "totals": result.totals,
        "phases": result.phases,
        "points": points,
        "layers": dict(sorted(result.layers.items(),
                              key=lambda kv: -kv[1])),
        "requests": result.requests,
        "counts": result.counts,
        "savings": result.savings,
        "measured": result.measured,
    }


def savings_drift(result: ReplayResult) -> Optional[float]:
    """|simulated - reported| / |reported| savings fraction (None when the
    trace carries no adaptive telemetry record to compare against)."""
    return result.savings.get("rel_diff_vs_reported")


def ordering_inversions(rows: Sequence[Tuple[str, float, Optional[float]]],
                        *, margin: float = 0.10,
                        measured_margin: float = 0.03) -> List[Dict]:
    """Predicted-vs-measured ordering check over ``(name, predicted,
    measured)`` rows (predicted in cycles, measured in seconds — any
    monotone units).

    Returns one record per *inverted comparable pair*: a pair is comparable
    only when both sides show signal — predicted costs differ by more than
    ``margin`` (relative) AND measured costs differ by more than
    ``measured_margin`` (the wall-clock noise floor: the ordering of a
    measured near-tie is scheduler noise, not information). Pairs without a
    measurement are skipped.
    """
    inversions = []
    usable = [(n, p, m) for n, p, m in rows if m is not None and p > 0]
    for i in range(len(usable)):
        for j in range(i + 1, len(usable)):
            (na, pa, ma), (nb, pb, mb) = usable[i], usable[j]
            if abs(pa - pb) / max(pa, pb) <= margin:
                continue  # predicted near-tie: not comparable vs noise
            if abs(ma - mb) / max(ma, mb, 1e-12) <= measured_margin:
                continue  # measured near-tie: ordering is noise
            if (pa < pb) != (ma < mb):
                inversions.append({
                    "pair": [na, nb],
                    "predicted": [pa, pb],
                    "measured": [ma, mb],
                })
    return inversions


def _fmt_cycles(c: float) -> str:
    if c >= 1e9:
        return f"{c / 1e9:.2f}G"
    if c >= 1e6:
        return f"{c / 1e6:.2f}M"
    if c >= 1e3:
        return f"{c / 1e3:.1f}k"
    return f"{c:.0f}"


def render(result: ReplayResult, *, top_layers: int = 10) -> str:
    """The human-readable attribution table."""
    t = result.totals
    lines = []
    meta = result.meta
    lines.append("== PE-array replay "
                 f"({result.config['n_pes']} PEs, "
                 f"mode={meta.get('mode')}, family={meta.get('family')}, "
                 f"slots={meta.get('slots')}, burst={meta.get('burst')}) ==")
    occ = t["pe_occupancy"]
    lines.append(
        f"total {_fmt_cycles(t['total_cycles'])} cycles "
        f"(array {_fmt_cycles(t['array_cycles'])}, "
        f"host idle {_fmt_cycles(t['host_sync_cycles'])}) | "
        f"PE occupancy {occ:.1%} | "
        f"AF stalls {_fmt_cycles(t['af_stall_cycles'])} | "
        f"weight stalls {_fmt_cycles(t['weight_stall_cycles'])}")
    if t.get("predicted_wall_s") is not None:
        m = result.measured
        wall = f"predicted wall {t['predicted_wall_s'] * 1e3:.1f}ms"
        if m.get("wall_s"):
            wall += f" vs measured {m['wall_s'] * 1e3:.1f}ms"
        lines.append(wall)

    lines.append("-- where cycles go (phase) --")
    total = max(t["total_cycles"], 1e-12)
    for phase, cyc in sorted(result.phases.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {phase:<12} {_fmt_cycles(cyc):>10}  "
                     f"{cyc / total:6.1%}")

    lines.append("-- execution points (predicted vs measured per step) --")
    for name, acc in sorted(result.points.items(),
                            key=lambda kv: -kv[1]["cycles"]):
        steps = max(acc["steps"], 1)
        meas = (f"{acc['wall_s'] / steps * 1e3:8.2f}ms/step"
                if acc["wall_s"] else "        --")
        lines.append(
            f"  {name:<10} {_fmt_cycles(acc['cycles']):>10} cycles  "
            f"{_fmt_cycles(acc['cycles'] / steps):>9}/step  {meas}  "
            f"({acc['spans']} spans, {acc['tokens']} tokens)")

    sav = result.savings
    lines.append("-- savings vs reference "
                 f"({sav.get('reference')}) --")

    def _savings_line(label: str, s: Dict) -> str:
        line = (f"  {label}: simulated est_cycle_savings_frac="
                f"{s['est_cycle_savings_frac']:.4f}")
        if s.get("reported") is not None:
            line += (f"  reported="
                     f"{s['reported']['est_cycle_savings_frac']:.4f}")
            if s.get("rel_diff_vs_reported") is not None:
                line += f"  rel_diff={s['rel_diff_vs_reported']:.3f}"
        return line

    lines.append(_savings_line("adaptive", sav))
    if sav.get("speculative"):
        lines.append(_savings_line("speculative", sav["speculative"]))

    lines.append(f"-- top {top_layers} layers --")
    ranked = sorted(result.layers.items(), key=lambda kv: -kv[1])
    array_total = max(t["array_cycles"], 1e-12)
    for name, cyc in ranked[:top_layers]:
        lines.append(f"  {name:<28} {_fmt_cycles(cyc):>10}  "
                     f"{cyc / array_total:6.1%}")

    lines.append("-- requests --")
    for rid, req in sorted(result.requests.items(),
                           key=lambda kv: -kv[1]["cycles"]):
        lines.append(
            f"  rid={rid:<4} tokens={req['tokens']:<5} "
            f"cycles={_fmt_cycles(req['cycles']):>10}")
    return "\n".join(lines)
