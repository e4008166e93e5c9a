"""Batched serving CLI (port of the kernel-mode subset of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --reduced \\
        --requests 4 --slots 2 --max-new 8 --device cpu [--temperature 1.3 --seed 40]

Runs on the card by default (``--device cuda``) through the Hopper kernels,
each prefill bucket and decode burst one captured CUDA graph; ``--device
cpu`` runs the kernels' plain versions eagerly. ``kernel``-mode weights,
prepared once (the fused dot+AF kernel) or, with ``--per-call``, re-rounded
at every dot (the MAC-array kernel and the standalone multi-AF). Greedy
unless ``--temperature`` is above 0; request ``i`` samples from seed
``--seed + i`` (default: its index). Weights are random, drawn from seed
0. The full-width config is served at ``dtype="float32"`` to match the f32
engine context.

The FxP8 policy is accurate unless ``--policy-file`` loads one (a file that
either package saved) or ``--calibrate`` runs the startup sensitivity scan
(``repro_torch.runtime.calibration_scan``, per call, through the cache-free
flash kernels) and ``assign_depths`` meets ``--cycle-reduction``;
``--save-policy`` writes the policy served. A depth-demoted group gets its
own point vector from ``prepare_params``.

``--adaptive`` serves from a multi-point bank (``runtime.build_bank``: the
cheap point, accurate FxP8 and ``hifi``, accurate FxP16) under a
``runtime.ModeController`` steering toward ``--cycle-budget``;
``--calibration`` prices the points with a ``sim.calibrate`` export.
``--speculative`` serves self-speculative rounds (``spec``): ``--draft-len``
tokens drafted at ``--draft-point`` (default: the cheapest point; with
``--adaptive`` the controller picks), verified at accurate FxP8. Both refuse
``--per-call``: the bank is the prepared path. Each prints the reference's
``telemetry:`` / ``speculative:`` summary line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=["kernel"], default="kernel",
                    help="engine mode (only the kernel backend is ported)")
    ap.add_argument("--per-call", action="store_true",
                    help="skip prepare_params: re-quantize weights every step "
                         "(the seed behaviour; for A/B benchmarking)")
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    cfg = reduce_cfg(cfg) if args.reduced else dataclasses.replace(cfg, dtype="float32")
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    policy = resolve_policy(args, model, params, FXP8, device)
    ctx = EngineContext(mode=args.mode, policy=policy, compute_dtype=torch.float32,
                        attn_impl="decode_kernel")
    controller = bank = speculate = None
    if args.adaptive or args.speculative:
        if args.per_call:
            raise SystemExit("--per-call contradicts --adaptive/--speculative: the "
                             "multi-point bank IS the prepared path")
        from repro_torch.runtime import ControllerConfig, ModeController, build_bank, default_points

        calibration = None
        if args.calibration:
            from repro_torch.sim import load_calibration

            calibration = load_calibration(args.calibration)
            print(f"cycle calibration: {calibration['id']} (from {args.calibration})")
        bank = build_bank(params, args.mode, default_points(FXP8, base_policy=policy,
                                                            hifi_fmt=FXP16),
                          specs=model.specs(), calibration=calibration)
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
    max_len = args.max_len or (args.prompt_len + args.max_new
                               + (args.draft_len if args.speculative else 0) + 2)
    server = BatchedServer(model, ctx, params, slots=args.slots, max_len=max_len,
                           burst=args.burst, device=device, prepare_weights=not args.per_call,
                           controller=controller, bank=bank, speculate=speculate)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                    args.max_new, temperature=args.temperature,
                    seed=None if args.seed is None else args.seed + i)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = server.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    weights = "adaptive" if args.adaptive else ("per-call" if args.per_call else "prepared")
    serving = "speculative " if args.speculative else ""
    print(f"served {len(results)} requests, {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, device={device}, burst={args.burst}, "
          f"{server.host_transfers} host round-trips, {server.graph_replays} graph replays, "
          f"{serving}{weights} {args.mode} weights, temperature {args.temperature})")
    if server.telemetry is not None:
        print("telemetry:", json.dumps(server.telemetry.summary()))
    if server.spec_telemetry is not None:
        print("speculative:", json.dumps(server.spec_telemetry.summary()))
    for rid in sorted(results):
        print(f"  req {rid}: {results[rid][:8]}...")
    return results


if __name__ == "__main__":
    main()
