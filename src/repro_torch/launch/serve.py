"""Batched serving CLI (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --reduced \\
        --requests 4 --slots 2 --max-new 8 --device cpu --mode carmen \\
        [--temperature 1.3 --seed 40]

Runs on the card by default (``--device cuda``), each prefill bucket and
decode burst one captured CUDA graph; ``--device cpu`` runs the kernels'
plain versions eagerly. ``--mode`` picks the engine mode, ``exact`` by
default as in the reference: ``exact`` (the f32 product, TF32 off),
``carmen`` (the f32 product of fake-quantized activations and signed-digit
grids), ``int8`` (int8 x int8 dots through the MAC-array kernel) or
``kernel`` (the fused CORDIC dot+AF kernel). Weights are prepared once or,
with ``--per-call``, re-rounded at every dot (in kernel mode the MAC-array
kernel and the standalone multi-AF). Every mode's cache attention runs the
GQA and MLA cache kernels (``attn_impl="decode_kernel"``). Greedy unless
``--temperature`` is above 0; request ``i`` samples from seed ``--seed + i``
(default: its index). Weights are random, drawn from seed 0. The full-width
config is served at ``dtype="float32"`` to match the f32 engine context.

The policy (not in ``exact`` mode) is accurate at FxP8 (``--fxp16``: FxP16)
unless ``--policy-file`` loads one (a file that either package saved) or
``--calibrate`` runs the startup sensitivity scan
(``repro_torch.runtime.calibration_scan``, per call, through the cache-free
flash kernels) and ``assign_depths`` meets ``--cycle-reduction``;
``--save-policy`` writes the policy served. A depth-demoted group gets its
own point vector from ``prepare_params``.

``--adaptive`` serves from a multi-point bank (``runtime.build_bank``: the
cheap point, accurate and ``hifi``, accurate FxP16; int8 has no hifi point,
it caps at 8 effective bits) under a ``runtime.ModeController`` steering
toward ``--cycle-budget``; ``--calibration`` prices the points with a
``sim.calibrate`` export. ``--speculative`` serves self-speculative rounds
(``spec``): ``--draft-len`` tokens drafted at ``--draft-point`` (default: the
cheapest point; with ``--adaptive`` the controller picks), verified at the
accurate point. Both need ``--mode carmen|int8|kernel`` and refuse
``--per-call``: the bank is the prepared path. Each prints the reference's
``telemetry:`` / ``speculative:`` summary line.

The reference's resilience group (``--deadline-ms``, ``--queue-limit``,
``--shed-policy``, ``--degrade``, ``--degrade-floor``; any of them serves
under a ``resilience.ResilienceConfig`` and prints the outcomes) and its
observability group (``--metrics``, ``--metrics-out``, ``--trace-out``,
``--chrome-trace``, ``--profile``). ``--profile DIR`` wraps the run in
``torch.profiler`` and writes its Chrome trace to ``DIR/torch_profile.json``.

Streaming frontend (``repro_torch.serve.frontend``): ``--frontend`` serves
the synthetic workload through the continuous-batching scheduler instead of
``run()``: requests arrive over time (``--arrival-rate`` req/s, seeded
Poisson from ``--arrival-seed``; 0 = all at once), admission, eviction and
shed sweeps run every tick, and prefill is chunked to ``--chunk-tokens``
rows a tick (``--monolithic-prefill``: whole prompts, the A/B contrast).
Deadlines become submit-relative. Two live drivers ride the same scheduler::

    # JSONL requests on stdin -> streamed {"rid", "token"} JSONL on stdout
    echo '{"rid": 0, "prompt": [5, 17, 3], "max_new": 8}' | \\
        ... --stdin-requests

    # minimal HTTP service on 127.0.0.1: POST /generate {"prompt": [...], "max_new": N}
    ... --http-port 8080

Tensor-parallel serving: ``--mesh DATA,MODEL`` (or ``auto``: one rank a
card) with ``--dist-backend gloo|nccl`` (no default: ``gloo`` for ranks that
share a card or run on the CPU, ``nccl`` for one card a rank) spawns
DATA x MODEL ranks (``launch.mesh.spawn``) that each run this CLI on their
shard of the weights (``BatchedServer(mesh=)``, uncaptured); rank 0 prints
and writes the files, and a trace's header carries the burst's collective
bytes. Refused with a mesh, as in the reference: the streaming frontend's
flags; and, waiting for their ROADMAP items, ``--per-call``, ``--mode int8``,
``--calibrate`` and the scan archs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced as reduce_cfg
from repro_torch.core import FXP8, FXP16, EngineContext, PrecisionPolicy, assign_depths
from repro_torch.models import get_model
from repro_torch.serve.engine import BatchedServer, Request


def resolve_policy(args, model, params, fmt, device) -> PrecisionPolicy:
    """--policy-file > --calibrate (startup sensitivity scan) > accurate."""
    if args.policy_file:
        policy = PrecisionPolicy.load(args.policy_file)
    elif args.calibrate:
        from repro_torch.runtime import calibration_scan

        rng = np.random.default_rng(0)
        tokens = rng.integers(0, model.cfg.vocab_size, (2, max(args.prompt_len, 8)))
        sens = calibration_scan(model, params, torch.as_tensor(tokens, device=device), fmt=fmt,
                                mode=args.mode, attn_impl="flash")
        policy = assign_depths(sens, fmt=fmt, cycle_reduction_target=args.cycle_reduction)
        print("calibration scan:", {k: round(v, 4) for k, v in sorted(sens.items())})
    else:
        policy = PrecisionPolicy.accurate(fmt)
    if args.save_policy:
        policy.save(args.save_policy)
        print(f"policy saved to {args.save_policy}")
    return policy


def _frontend_config(args):
    from repro_torch.serve.frontend import FrontendConfig

    return FrontendConfig(chunk_tokens=args.chunk_tokens,
                          monolithic_prefill=args.monolithic_prefill)


def _serve_synthetic(args, server, reqs):
    """The synthetic workload through the scheduler, ticked on this thread:
    a seeded arrival process decides *when* each request is submitted, and
    between arrivals the scheduler keeps admitting, prefilling and decoding."""
    from repro_torch.serve.frontend import ContinuousScheduler

    rng = np.random.default_rng(args.arrival_seed)
    if args.arrival_rate > 0:
        arrive = np.cumsum(rng.exponential(1.0 / args.arrival_rate, size=len(reqs)))
    else:
        arrive = np.zeros(len(reqs))
    pending = list(zip(arrive.tolist(), reqs))
    sched = ContinuousScheduler(server, _frontend_config(args))
    with sched:
        t0 = time.perf_counter()
        while pending or not sched.idle:
            now = time.perf_counter() - t0
            while pending and pending[0][0] <= now:
                sched.submit(pending.pop(0)[1])
            if not sched.step() and pending:
                # idle but arrivals remain: sleep until the next one is due
                time.sleep(min(0.01, max(0.0, pending[0][0] - now)))
        results = dict(sched.results)
    print(f"frontend: ticks={sched.stats['ticks']} bursts={sched.stats['bursts']} "
          f"prefill_rows={sched.stats['prefill_rows']} max_prefill_rows_between_bursts="
          f"{sched.stats['max_prefill_rows_between_bursts']} "
          f"(chunk budget {args.chunk_tokens})")
    return results


def _serve_stdin(args, server, stdin=None):
    """JSONL requests on stdin, streamed JSONL tokens on stdout. Each line
    in is one request; each token lands as its own line out, then a final
    ``done`` line with the outcome status."""
    import sys
    import threading

    from repro_torch.serve.frontend import AsyncFrontend

    fe = AsyncFrontend(server, _frontend_config(args)).start()
    results = {}
    out_lock = threading.Lock()

    def pump(handle):
        for tok in handle:
            with out_lock:
                print(json.dumps({"rid": handle.rid, "token": int(tok)}), flush=True)
        with out_lock:
            print(json.dumps({"rid": handle.rid, "done": True, "status": handle.status or "ok",
                              "tokens": len(handle.tokens)}), flush=True)
            results[handle.rid] = list(handle.tokens)

    pumps = []
    auto_rid = 0
    try:
        for line in (stdin if stdin is not None else sys.stdin):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            rid = int(d.get("rid", auto_rid))
            auto_rid = max(auto_rid, rid) + 1
            req = Request(rid, np.asarray(d["prompt"], np.int32),
                          int(d.get("max_new", args.max_new)),
                          temperature=float(d.get("temperature", args.temperature)),
                          seed=d.get("seed", args.seed), deadline_s=d.get("deadline_s"))
            try:
                handle = fe.submit(req)
            except ValueError as e:
                with out_lock:
                    print(json.dumps({"rid": rid, "done": True, "status": "rejected",
                                      "error": str(e)}), flush=True)
                continue
            t = threading.Thread(target=pump, args=(handle,), daemon=True)
            t.start()
            pumps.append(t)
        for t in pumps:
            t.join()
    finally:
        fe.stop()
    return results


def _serve_http(args, server, ready=None):
    """Minimal stdlib HTTP service over the async frontend, on 127.0.0.1.
    POST /generate with ``{"prompt": [...], "max_new": N, ...}`` blocks
    until the request settles and returns the full token stream (a broken
    connection mid-wait cancels the request: eviction at the next tick).
    GET /healthz for liveness. ``ready`` (a ``threading.Event``), if given,
    is set once the socket listens and holds the server as ``ready.server``
    (its ``shutdown()`` stops the loop)."""
    import itertools
    import select
    import socket
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from repro_torch.serve.frontend import AsyncFrontend

    fe = AsyncFrontend(server, _frontend_config(args)).start()
    results = {}
    counter = itertools.count()
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # keep stdout for the serving summary
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            self._reply(200, {"ok": True})

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                d = json.loads(self.rfile.read(n) or b"{}")
                with lock:
                    rid = int(d.get("rid", next(counter) + 100000))
                req = Request(rid, np.asarray(d["prompt"], np.int32),
                              int(d.get("max_new", args.max_new)),
                              temperature=float(d.get("temperature", args.temperature)),
                              seed=d.get("seed", args.seed), deadline_s=d.get("deadline_s"))
                handle = fe.submit(req)
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            # block until settled, but watch the socket: a client that
            # disconnects mid-generation cancels the request
            while not handle._done.wait(0.25):
                readable, _, _ = select.select([self.connection], [], [], 0)
                if readable and not self.connection.recv(1, socket.MSG_PEEK):
                    handle.cancel()
                    handle._done.wait(5.0)
                    return
            toks = list(handle.tokens)
            with lock:
                results[rid] = toks
            self._reply(200, {"rid": rid, "tokens": toks, "status": handle.status or "ok"})

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away; the request already settled

    srv = ThreadingHTTPServer(("127.0.0.1", args.http_port), Handler)
    print(f"serving on http://127.0.0.1:{srv.server_address[1]} (POST /generate, "
          "GET /healthz); Ctrl-C to stop", flush=True)
    if ready is not None:
        ready.server = srv
        ready.set()
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("\nshutting down")
    finally:
        srv.server_close()
        fe.stop()
    return results


def _serve_frontend(args, server, reqs):
    if args.http_port is not None:
        return _serve_http(args, server)
    if args.stdin_requests:
        return _serve_stdin(args, server)
    return _serve_synthetic(args, server, reqs)


def _mesh_rank(rank: int, world: int, argv, shape):
    """One rank of ``--mesh``: this CLI on the rank's mesh; only rank 0
    prints."""
    import contextlib
    import io

    from repro_torch.launch.mesh import mesh_from_shape

    mesh = mesh_from_shape(shape)
    out = contextlib.nullcontext() if rank == 0 else contextlib.redirect_stdout(io.StringIO())
    with out:
        return main(argv, mesh=mesh)


def _launch_mesh(args, argv):
    """Spawn the ranks of ``--mesh`` and return rank 0's streams."""
    from repro_torch.launch.mesh import parse_mesh, spawn

    if args.frontend or args.stdin_requests or args.http_port is not None:
        raise SystemExit("the streaming frontend is single-device for now: drop --mesh or "
                         "drop --frontend/--stdin-requests/--http-port")
    if args.dist_backend is None:
        raise SystemExit("--mesh needs --dist-backend gloo|nccl: gloo for ranks that share a "
                         "card or run on the CPU, nccl for one card a rank")
    cards = torch.cuda.device_count() if args.device.startswith("cuda") else 1
    shape = parse_mesh(args.mesh, world=cards)
    world = shape[0] * shape[1]
    if args.device.startswith("cuda"):
        resolve_device(args.device)
        device = "cuda" if args.dist_backend == "nccl" else "cuda:0"
    else:
        device = "cpu"
    results = spawn(_mesh_rank, world, args=(argv, shape), backend=args.dist_backend,
                    device=device, timeout=3600)
    return results[0]


def main(argv=None, mesh=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=["exact", "carmen", "int8", "kernel"], default="exact")
    ap.add_argument("--per-call", action="store_true",
                    help="skip prepare_params: re-quantize weights every step "
                         "(the seed behaviour; for A/B benchmarking)")
    ap.add_argument("--fxp16", action="store_true",
                    help="FxP16 operand format (default FxP8)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--burst", type=int, default=8,
                    help="decode steps per host round trip")
    ap.add_argument("--max-len", type=int, default=None,
                    help="KV rows per slot (default: prompt-len + max-new + 2)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--seed", type=int, default=None,
                    help="base sampling seed (request i uses seed + i)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy-file", default=None,
                    help="JSON precision policy (PrecisionPolicy.save / assign_depths)")
    ap.add_argument("--calibrate", action="store_true",
                    help="run the sensitivity scan on a calibration batch at startup")
    ap.add_argument("--save-policy", default=None,
                    help="write the resolved policy as JSON (round-trips via --policy-file)")
    ap.add_argument("--cycle-reduction", type=float, default=0.33,
                    help="assign_depths cycle-reduction budget for --calibrate")
    ap.add_argument("--adaptive", action="store_true",
                    help="runtime-adaptive precision: multi-point bank + mode controller")
    ap.add_argument("--cycle-budget", type=float, default=0.75,
                    help="--adaptive: target MAC-cycle fraction vs all-accurate")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="PE-array calibration JSON (a sim.calibrate export): prices "
                         "the bank's per-point cycle costs with fitted constants "
                         "instead of the analytic model")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative serving: draft on the shallow execution "
                         "point, verify on the accurate point")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="--speculative: tokens drafted per verify round")
    ap.add_argument("--draft-point", default=None,
                    help="--speculative: bank point to draft at (default: the "
                         "cheapest; with --adaptive the controller picks)")
    res_args = ap.add_argument_group(
        "resilience",
        "fault-tolerant serving (repro_torch.resilience): deadlines, bounded admission "
        "with load shedding, per-slot fault quarantine, graceful precision degradation; "
        "any flag here serves under the resilient contract (structured outcomes "
        "instead of raising)")
    res_args.add_argument("--deadline-ms", type=float, default=None,
                          help="per-request deadline in ms from run entry: expired queued "
                               "requests are shed, expired running requests are evicted "
                               "with partial output at the next burst boundary")
    res_args.add_argument("--queue-limit", type=int, default=None,
                          help="bounded admission queue: overflow is shed per "
                               "--shed-policy with reason queue_full")
    res_args.add_argument("--shed-policy", default="reject_newest",
                          choices=["reject_newest", "reject_largest", "deadline_aware"],
                          help="queue-overflow victim selection")
    res_args.add_argument("--degrade", action="store_true",
                          help="graceful degradation: cap the whole batch down the bank's "
                               "depth ladder under deadline misses / queue pressure, "
                               "promote back with hysteresis (needs a bank: --adaptive or "
                               "--speculative)")
    res_args.add_argument("--degrade-floor", default=None, metavar="POINT",
                          help="--degrade: cheapest bank point the cap may reach "
                               "(default: the cheapest rung)")
    obs_args = ap.add_argument_group(
        "observability",
        "SLO metrics + structured serve trace (repro_torch.obs); hooks run only at host "
        "sync points, so token streams are bit-identical with or without them")
    obs_args.add_argument("--metrics", action="store_true",
                          help="print the metrics snapshot (TTFT / inter-token / queue-wait "
                               "percentiles, counters, gauges)")
    obs_args.add_argument("--metrics-out", default=None, metavar="PATH",
                          help="write the metrics + per-request snapshot JSON")
    obs_args.add_argument("--trace-out", default=None, metavar="PATH",
                          help="write the versioned JSONL serve trace (carmen-serve-trace "
                               "v1; the reference's PE-array simulator replays it)")
    obs_args.add_argument("--chrome-trace", default=None, metavar="PATH",
                          help="write a Chrome-trace JSON (load in Perfetto or "
                               "chrome://tracing)")
    obs_args.add_argument("--profile", default=None, metavar="DIR",
                          help="wrap the run in torch.profiler (kernel-level; complements "
                               "the serve trace): DIR/torch_profile.json")
    fe_args = ap.add_argument_group(
        "streaming frontend",
        "continuous-batching scheduler (repro_torch.serve.frontend): requests arrive over "
        "time, admission/eviction sweeps run every tick, prefill is chunked so long prompts "
        "never stall decoding slots")
    fe_args.add_argument("--frontend", action="store_true",
                         help="serve the synthetic workload through the continuous-batching "
                              "scheduler instead of run() (deadlines become submit-relative)")
    fe_args.add_argument("--chunk-tokens", type=int, default=32,
                         help="prefill budget: prompt rows advanced per admission tick "
                              "(bounds how long a newly admitted prompt can stall decoding "
                              "slots)")
    fe_args.add_argument("--monolithic-prefill", action="store_true",
                         help="disable chunking: prefill whole prompts in one tick (the A/B "
                              "contrast arm)")
    fe_args.add_argument("--arrival-rate", type=float, default=0.0,
                         help="--frontend: synthetic request arrivals per second (seeded "
                              "Poisson process; 0 = all submitted at once)")
    fe_args.add_argument("--arrival-seed", type=int, default=0,
                         help="--frontend: seed for the arrival process")
    fe_args.add_argument("--stdin-requests", action="store_true",
                         help='read JSONL requests from stdin ({"rid", "prompt", "max_new", '
                              '...}) and stream {"rid", "token"} JSONL to stdout')
    fe_args.add_argument("--http-port", type=int, default=None,
                         help="serve a minimal HTTP API on 127.0.0.1: POST /generate with a "
                              "JSON request body; Ctrl-C to stop")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL|auto",
                    help="serve tensor-parallel on DATA x MODEL spawned ranks (auto: one a "
                         "card); needs --dist-backend")
    ap.add_argument("--dist-backend", choices=("gloo", "nccl"), default=None,
                    help="the ranks' torch.distributed backend (with --mesh)")
    args = ap.parse_args(argv)
    if args.mesh is not None and mesh is None:
        return _launch_mesh(args, argv)
    if mesh is not None:
        for flag, bad in (("--per-call", args.per_call), ("--calibrate", args.calibrate)):
            if bad:
                raise SystemExit(f"{flag} with --mesh waits for ROADMAP Queue 1 (kernel 6's "
                                 "partial-sum variant; the calibration scan on a mesh)")
    lead = mesh is None or mesh.rank == 0  # the rank that writes files
    if not lead:
        args.save_policy = None

    device = resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    # the exact and carmen products are f32; TF32 would round their operands
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    cfg = reduce_cfg(cfg) if args.reduced else dataclasses.replace(cfg, dtype="float32")
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    fmt = FXP16 if args.fxp16 else FXP8
    policy = None if args.mode == "exact" else resolve_policy(args, model, params, fmt, device)
    ctx = EngineContext(mode=args.mode, policy=policy, compute_dtype=torch.float32,
                        attn_impl="decode_kernel")
    controller = bank = speculate = None
    if args.adaptive or args.speculative:
        what = "--adaptive/--speculative"
        if args.mode == "exact":
            raise SystemExit(f"{what} needs --mode carmen|int8|kernel")
        if args.per_call:
            raise SystemExit(f"--per-call contradicts {what}: the multi-point "
                             "bank IS the prepared path")
        from repro_torch.runtime import ControllerConfig, ModeController, build_bank, default_points

        calibration = None
        if args.calibration:
            from repro_torch.sim import load_calibration

            calibration = load_calibration(args.calibration)
            print(f"cycle calibration: {calibration['id']} (from {args.calibration})")
        # int8 caps at 8 effective bits: an FxP16 point would cost 1.75x the
        # cycles for bit-identical arithmetic, so the ladder drops it
        hifi = None if args.mode == "int8" else FXP16
        bank = build_bank(params, args.mode, default_points(fmt, base_policy=policy,
                                                            hifi_fmt=hifi),
                          specs=model.specs(), calibration=calibration, mesh=mesh)
        print(f"bank: points={bank.names} shared_leaves={bank.shared_leaves}/"
              f"{bank.unique_leaves} rel_cycles="
              f"{ {n: round(bank.rel_cycles(n), 3) for n in bank.names} }")
        if args.adaptive:
            controller = ModeController(bank, ControllerConfig(
                cycle_budget=args.cycle_budget,
                # speculative rounds draft cheap from the first round; the
                # verify point guards accuracy regardless
                start=bank.names[0] if args.speculative else None,
            ))
    if args.speculative:
        from repro_torch.spec import SpecConfig

        speculate = SpecConfig(draft_len=args.draft_len, draft_point=args.draft_point)
    resilience = None
    if args.deadline_ms is not None or args.queue_limit is not None or args.degrade:
        from repro_torch.resilience import ResilienceConfig

        resilience = ResilienceConfig(
            queue_limit=args.queue_limit, shed_policy=args.shed_policy,
            default_deadline_s=args.deadline_ms / 1000.0 if args.deadline_ms is not None
            else None)
    if args.degrade:
        if bank is None:
            raise SystemExit("--degrade needs a multi-point bank: add --adaptive or "
                             "--speculative")
        from repro_torch.resilience import DegradationConfig, DegradationPolicy
        from repro_torch.runtime import ControllerConfig, ModeController

        # without --adaptive the inner controller pins the reference point:
        # degradation is then the only thing moving the ladder
        inner = controller or ModeController(bank, ControllerConfig(pin=bank.reference))
        controller = DegradationPolicy(inner, DegradationConfig(floor=args.degrade_floor))
    observer = None
    want_trace = bool(args.trace_out or args.chrome_trace)
    if args.metrics or args.metrics_out or want_trace:
        from repro_torch.obs import ServingObserver

        # the JSONL trace is flushed to its sink even if the run raises
        observer = ServingObserver(trace=want_trace,
                                   trace_sink=args.trace_out if lead else None)
    max_len = args.max_len or (args.prompt_len + args.max_new
                               + (args.draft_len if args.speculative else 0) + 2)
    server = BatchedServer(model, ctx, params, slots=args.slots, max_len=max_len,
                           burst=args.burst, device=device, prepare_weights=not args.per_call,
                           controller=controller, bank=bank, speculate=speculate,
                           observer=observer, resilience=resilience, mesh=mesh,
                           capture=mesh is None)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                    args.max_new, temperature=args.temperature,
                    seed=None if args.seed is None else args.seed + i)
            for i in range(args.requests)]
    profiler = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
    t0 = time.perf_counter()
    try:
        if args.frontend or args.stdin_requests or args.http_port is not None:
            results = _serve_frontend(args, server, reqs)
        else:
            results = server.run(reqs)
    finally:
        if profiler is not None:
            profiler.stop()
        if profiler is not None and lead:
            os.makedirs(args.profile, exist_ok=True)
            path = os.path.join(args.profile, "torch_profile.json")
            profiler.export_chrome_trace(path)
            print(f"torch profiler trace written to {path}")
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    weights = "adaptive" if args.adaptive else ("per-call" if args.per_call else "prepared")
    serving = "speculative " if args.speculative else ""
    print(f"served {len(results)} requests, {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, device={device}, burst={args.burst}, "
          f"{server.host_transfers} host round-trips, {server.graph_replays} graph replays, "
          f"{serving}{weights} {args.mode} weights, temperature {args.temperature})")
    if resilience is not None:
        statuses: dict = {}
        for o in server.outcomes.values():
            statuses[o.status] = statuses.get(o.status, 0) + 1
        met = sum(1 for o in server.outcomes.values() if o.deadline_met)
        print(f"outcomes: {statuses}; deadline_met {met}/{len(server.outcomes)}")
        shed = {rid: o.reason for rid, o in sorted(server.outcomes.items())
                if o.status in ("shed", "faulted", "expired")}
        if shed:
            print(f"shed/evicted reasons: {shed}")
        if args.degrade:
            print(f"degradation: cap={controller.cap} demotions={controller.demotions} "
                  f"promotions={controller.promotions}")
    if server.telemetry is not None:
        print("telemetry:", json.dumps(server.telemetry.summary()))
    if server.spec_telemetry is not None:
        print("speculative:", json.dumps(server.spec_telemetry.summary()))
    if observer is not None and mesh is not None and observer.trace is not None:
        # the mesh cost block rides on the trace header: the collective bytes
        # of one greedy decode burst, next to the sharding report (every rank
        # runs the burst: its collectives span them all)
        observer.trace.attach("collectives", server.collective_snapshot())
    if observer is not None and lead:
        for out in (args.metrics_out, args.trace_out, args.chrome_trace):
            if out and os.path.dirname(out):
                os.makedirs(os.path.dirname(out), exist_ok=True)
        if args.metrics or args.metrics_out:
            snap = observer.snapshot()
            if args.metrics:
                print("metrics:", json.dumps(snap["metrics"]))
            if args.metrics_out:
                with open(args.metrics_out, "w") as f:
                    json.dump(snap, f, indent=1)
                print(f"metrics snapshot written to {args.metrics_out}")
        if args.trace_out:
            observer.trace.write_jsonl(args.trace_out)
            print(f"serve trace (JSONL) written to {args.trace_out}")
        if args.chrome_trace:
            observer.trace.write_chrome(args.chrome_trace)
            print(f"chrome trace written to {args.chrome_trace}")
    for rid in sorted(results):
        print(f"  req {rid}: {results[rid][:8]}...")
    return results


if __name__ == "__main__":
    main()
