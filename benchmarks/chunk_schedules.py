#!/usr/bin/env python3
"""Whether a chunked prefill's greedy stream depends on where its chunk
boundaries fall: full-width olmo-1b in kernel mode on an H100, under the
port's chunk rule and under the reference's.

    python3 benchmarks/chunk_schedules.py [--first 1-32] [--cpu-replay]

A server of full-width olmo-1b (16 layers, f32, random weights from seed 0
on the host; accurate FxP8; 4 slots, max_len 512, burst 8; every program a
captured CUDA graph) serves ``chip_smoke.py``'s six requests with ``run()``
(the monolithic prefill). Then it serves each request alone through the
streaming frontend with its prompt cut into the chunks ``[a, 32, ..., 32,
rest]``, for each first-chunk length ``a`` in ``--first``: the cuts that the
scheduler's shared 32-row budget gives a request admitted with ``a`` rows of
budget left in its tick. Each cut runs under two chunk rules:

* ``port``: ``BatchedServer.chunk_span``; every chunk of a prompt whose own
  bucket is 16 rows or more runs at least 16 wide, on the cache attention's
  tensor cores, as ``run()``'s bucket does;
* ``reference``: each chunk at its own power-of-two bucket, as the reference
  runs it; chunks below 16 rows run the cache attention on split keys.

Prints and writes to ``chiprun_out/chunk_schedules.json`` the streams and
f32 top-2 margins that differ from ``run()``'s under each rule, with each
diverging stream's cut, its first differing token and ``run()``'s margin
there. With ``--cpu-replay`` the first cut that diverges under the
reference's rule is served again on the host CPU (the plain version of
every kernel), under both rules, against the CPU's own ``run()``. Needs a
CUDA card and no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def cuts(plen: int, first: int, budget: int) -> list:
    """A prompt of ``plen`` rows in chunks: ``first`` rows, then ``budget``
    rows a chunk, the rest last."""
    out, done = [min(first, plen)], min(first, plen)
    while done < plen:
        out.append(min(budget, plen - done))
        done += out[-1]
    return out


def reference_rule(server, plen: int, start: int, n: int):
    from repro_torch.serve.kvcache import bucket_length

    return start, bucket_length(n, server.max_len)


def scripted_scheduler(server, chunks: list):
    """A ``ContinuousScheduler`` that prefills its one request in
    ``chunks``, one chunk a tick, each tick followed by the decode burst."""
    from repro_torch.serve.frontend import ContinuousScheduler, FrontendConfig, _PrefillJob

    class Scripted(ContinuousScheduler):
        def _prefill_tick(self) -> int:
            if self.job is None:
                if not (self.queue and self.free) or not chunks:
                    return 0
                req = self.queue.pop(0)
                row, last = self.server.fresh_row()
                self.job = _PrefillJob(req=req, slot=self.free.pop(0),
                                       prompt=np.asarray(req.prompt, np.int32),
                                       row=row, last=last)
            n = chunks.pop(0)
            self._advance_job(self.job, n)
            if self.job.done >= len(self.job.prompt):
                self.job = None
            return n

    return Scripted(server, FrontendConfig(chunk_tokens=max(chunks)))


def serve_cut(server, req, chunks: list, rule: str):
    """``req`` alone through the frontend in ``chunks`` under ``rule``:
    (stream, margins)."""
    if rule == "reference":
        server.chunk_span = types.MethodType(reference_rule, server)
    else:
        server.__dict__.pop("chunk_span", None)
    sched = scripted_scheduler(server, list(chunks))
    with sched:
        sched.submit(req)
        out = sched.drain()
    server.__dict__.pop("chunk_span", None)
    return out[req.rid], list(req.margins)


def compare(got, want) -> dict:
    """A cut's (stream, margins) against run()'s."""
    (toks, margins), (run_toks, run_margins) = got, want
    rep = dict(stream_equal=toks == run_toks, margins_bitwise=margins == run_margins)
    if toks != run_toks:
        j = next(i for i, (a, b) in enumerate(zip(toks, run_toks)) if a != b)
        rep.update(first_differing_token=j, run_margin_there=run_margins[j])
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", default="1-32", help="first-chunk lengths, 'lo-hi' or a,b,c")
    ap.add_argument("--cpu-replay", action="store_true")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chunk_schedules: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke  # configs, requests and serving sizes
    from repro_torch.kernels import _build
    from repro_torch.models import get_model
    from repro_torch.serve.engine import BatchedServer

    lo, _, hi = opts.first.partition("-")
    firsts = list(range(int(lo), int(hi) + 1)) if hi else [int(a) for a in opts.first.split(",")]
    budget = chip_smoke.CHUNK_TOKENS
    dev = torch.device("cuda")
    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cfg = chip_smoke.olmo()
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(chip_smoke.SEED))

    def make(device):
        return BatchedServer(model, chip_smoke.kernel_ctx(), params, slots=chip_smoke.SLOTS,
                             max_len=chip_smoke.MAX_LEN, burst=chip_smoke.BURST, device=device)

    def run_of(server, reqs):
        out = server.run(reqs)
        return {r.rid: (out[r.rid], list(r.margins)) for r in reqs}

    t0 = time.perf_counter()
    server = make(dev)
    run = run_of(server, chip_smoke.requests(cfg))
    report = dict(card=card, config="olmo-1b full width, 16 layers, f32, kernel mode (prepared), "
                  "FxP8 accurate, captured; weights from seed 0 on the host",
                  prompt_lens=list(chip_smoke.PROMPT_LENS), max_new=chip_smoke.MAX_NEW,
                  budget=budget, firsts=firsts, rules={})
    diverging = []
    for rule in ("port", "reference"):
        cases = []
        for req in chip_smoke.requests(cfg):
            seen = set()
            for a in firsts:
                chunks = cuts(len(req.prompt), a, budget)
                if tuple(chunks) in seen:
                    continue
                seen.add(tuple(chunks))
                one = chip_smoke.requests(cfg)[req.rid]
                rep = dict(rid=req.rid, chunks=chunks,
                           **compare(serve_cut(server, one, chunks, rule), run[req.rid]))
                cases.append(rep)
                if rule == "reference" and not rep["stream_equal"]:
                    diverging.append(rep)
        report["rules"][rule] = dict(
            cuts=len(cases), streams_differing=sum(not c["stream_equal"] for c in cases),
            margins_differing=sum(not c["margins_bitwise"] for c in cases),
            differing=[c for c in cases if not c["margins_bitwise"]])
        print(json.dumps({rule: {k: v for k, v in report["rules"][rule].items()
                                 if k != "differing"}}), flush=True)
    report["card_s"] = time.perf_counter() - t0
    del server
    chip_smoke.free_card()
    if opts.cpu_replay and diverging:
        case = diverging[0]
        t0 = time.perf_counter()
        cpu = make(torch.device("cpu"))
        head = case["first_differing_token"] + 1
        want = run_of(cpu, [chip_smoke.requests(cfg, max_new=head)[case["rid"]]])[case["rid"]]
        replay = dict(rid=case["rid"], chunks=case["chunks"], max_new=head,
                      card_run_stream=run[case["rid"]][0][:head], cpu_run_stream=want[0])
        for rule in ("port", "reference"):
            one = chip_smoke.requests(cfg, max_new=head)[case["rid"]]
            got = serve_cut(cpu, one, case["chunks"], rule)
            replay[rule] = dict(stream=got[0], **compare(got, want))
        replay["cpu_s"] = time.perf_counter() - t0
        report["cpu_replay"] = replay
        print(json.dumps({"cpu_replay": replay}), flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "chunk_schedules.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in ("card", "budget", "card_s")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
