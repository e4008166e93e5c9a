"""Fit the PE-array model's constants against Tables 2/3/5-style measurements
(port of ``repro.sim.calibrate``).

The analytic cycle model (``mac_cycles``: one CORDIC iteration per cycle)
has shape but no units. Calibration pins both against what this machine
measures, with the reference's protocol:

* **sec_per_cycle**: the seconds one MAC iteration costs, the slope of the
  bit-faithful ``cordic_matmul`` time over depth (its time is proportional
  to depth, since it runs the iteration loop);
* **mac_overhead**: extra cycles per MAC beyond depth+1, from the fit's
  intercept above the dispatch floor, clamped to [0, 1];
* **af_iter_cycles**: AF-block time per element per CORDIC iteration over
  the fitted sec_per_cycle (``multi_af_float`` for every AF);
* **parallel_overhead_exp**: the time exponent of ``carmen_matmul_fast``
  across 64 and 256 lanes;
* **host_sync_cycles**: the dispatch floor (the exact dot's time) in cycles.

**How a function is timed.** The reference times one ``jax.jit`` dispatch
a call (``time.perf_counter`` around ``block_until_ready``). The port's
analogue of one jitted dispatch on the card is one CUDA-graph replay: each
function is run once eagerly (warm-up), captured into a graph, and its
replays are timed back to back with CUDA events, ``reps`` of them, the
mean a replay. ``measure(device="cpu")`` runs each function eagerly under
``time.perf_counter`` instead, so the CPU tests can call it at smoke sizes.

:func:`fit_calibration` is pure (measurements in, calibration out) and
returns, for the same measurements, the same dict as the reference's, ``id``
included. The export is the reference's JSON: either package loads the
other's, and ``runtime.build_bank(calibration=...)`` prices a bank with it.

CLI::

    python -m repro_torch.sim.calibrate [--out cal.json] [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device

CALIBRATION_SCHEMA = "carmen-sim-calibration"
CALIBRATION_VERSION = 1

__all__ = ["CALIBRATION_SCHEMA", "CALIBRATION_VERSION", "fit_calibration",
           "load_calibration", "measure", "run_calibration", "save_calibration"]


# -- measurement (Tables 2/3/5 protocol, locally sized) -----------------------

def _timed(fn: Callable[[], torch.Tensor], reps: int, device: torch.device) -> float:
    """Seconds one call of ``fn`` takes: a CUDA-graph replay timed by events
    on a card, an eager call timed by the host clock on the CPU."""
    if device.type != "cuda":
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()  # eager warm-up, off the capture
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()  # first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / reps
    del graph
    return seconds


def measure(*, smoke: bool = False, device=None) -> Dict:
    """Run the calibration measurements on ``device`` (default: the card).

    The reference's shapes, depths, AFs and lane counts (``smoke`` shrinks
    shapes and rep counts). Returns the measurement dict
    :func:`fit_calibration` consumes.
    """
    from repro_torch.core import (AF_NAMES, FXP8, FXP8_UNIT, carmen_matmul_fast,
                                  cordic_matmul, full_depth, multi_af_float, quantize)

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    reps = 2 if smoke else 5

    def put(a):
        return torch.from_numpy(a).to(device)

    # Table 2: bit-faithful MAC time vs depth (the slope is sec/iteration)
    m, k, n = (32, 128, 32) if smoke else (64, 256, 64)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    xt, wt = put(x), put(w)
    xq, wq = quantize(xt, FXP8), quantize(wt, FXP8_UNIT)
    depths = (2, full_depth(FXP8_UNIT)) if smoke else (2, 4, full_depth(FXP8_UNIT))
    mac = {}
    for d in depths:
        mac[int(d)] = _timed(lambda d=d: cordic_matmul(xq, wq, d, FXP8_UNIT), reps, device)

    # dispatch floor: the exact dot on the same shape
    dispatch_s = _timed(lambda: xt @ wt, reps, device)

    # Table 3: AF-block time per element
    af_shape = (32, 256) if smoke else (64, 512)
    xa = put(rng.uniform(-1, 1, af_shape).astype(np.float32))
    af_depth = full_depth(FXP8)
    modes = AF_NAMES[:2] if smoke else AF_NAMES
    af = {}
    for mode in modes:
        af[mode] = _timed(lambda mm=mode: multi_af_float(xa, mm, af_depth, FXP8), reps, device)

    # Table 5: PE-lane scaling (fast model, fixed K and token count)
    lm, lk = (1024, 256) if smoke else (4096, 512)
    xl = put(rng.uniform(-1, 1, (lm, lk)).astype(np.float32))
    lanes = {}
    for nl in (64, 256):
        wl = put(rng.uniform(-1, 1, (lk, nl)).astype(np.float32))
        lanes[int(nl)] = _timed(
            lambda wl=wl: carmen_matmul_fast(xl, wl, full_depth(FXP8_UNIT), FXP8, FXP8_UNIT),
            reps, device)

    return {
        "mac": {"shape": [m, k, n], "times_by_depth": mac},
        "dispatch_s": dispatch_s,
        "af": {"shape": list(af_shape), "depth": af_depth,
               "n_elems": int(np.prod(af_shape)), "times_by_mode": af},
        "lanes": {"shape": [lm, lk], "times_by_n": lanes},
        "smoke": smoke,
    }


# -- fitting ------------------------------------------------------------------

def fit_calibration(measurements: Dict) -> Dict:
    """Fit array constants from a :func:`measure` dict (pure; testable with
    synthetic measurements). Every constant is clamped to its documented
    sane range: a noisy machine degrades toward the analytic model instead
    of producing a pathological one."""
    mac = measurements["mac"]
    m, k, n = mac["shape"]
    macs = float(m) * k * n
    pts = sorted((int(d), float(t)) for d, t in mac["times_by_depth"].items())
    if len(pts) < 2:
        raise ValueError("calibration needs bit-faithful timings at >= 2 depths")
    xs = np.array([d + 1 for d, _ in pts], np.float64)
    ys = np.array([t for _, t in pts], np.float64)
    slope, intercept = np.polyfit(xs, ys, 1)
    fallback = slope <= 0  # depth signal lost in noise: degrade gracefully
    if fallback:
        slope = float(ys.max() / (macs * xs.max()))
        intercept = 0.0
    sec_per_iter = float(slope) / macs  # seconds per MAC iteration
    resid = float(np.max(np.abs(np.polyval([slope, intercept], xs) - ys)) / ys.max())

    dispatch_s = float(measurements.get("dispatch_s", 0.0))
    mac_overhead = 0.0
    if not fallback and macs * sec_per_iter > 0:
        mac_overhead = (float(intercept) - dispatch_s) / (macs * sec_per_iter)
    mac_overhead = float(np.clip(mac_overhead, 0.0, 1.0))

    af = measurements.get("af")
    af_iter = 1.0
    if af and af.get("times_by_mode"):
        per_elem = [max(float(t) - dispatch_s, 0.0) / af["n_elems"]
                    for t in af["times_by_mode"].values()]
        iters = float(af.get("depth", 7)) + 1.0
        af_iter = float(np.clip(np.mean(per_elem) / (sec_per_iter * iters), 0.25, 8.0))

    lanes = measurements.get("lanes", {}).get("times_by_n", {})
    exp = 0.0
    if len(lanes) >= 2:
        ns = sorted(int(x) for x in lanes)
        lo, hi = ns[0], ns[-1]
        exp = math.log(float(lanes[hi]) / float(lanes[lo])) / math.log(hi / lo)
        exp = float(np.clip(exp, 0.0, 1.5))

    constants = {
        "sec_per_cycle": sec_per_iter,
        "mac_overhead": mac_overhead,
        "af_iter_cycles": af_iter,
        "parallel_overhead_exp": exp,
        "host_sync_cycles": max(dispatch_s, 0.0) / sec_per_iter,
    }
    digest = hashlib.sha256(
        json.dumps({kk: (round(v, 12) if isinstance(v, float) else v)
                    for kk, v in constants.items()},
                   sort_keys=True).encode()).hexdigest()[:8]
    return {
        "schema": CALIBRATION_SCHEMA,
        "version": CALIBRATION_VERSION,
        "id": f"calib-{digest}",
        "constants": constants,
        "fit": {
            "mac_fit_max_rel_resid": resid,
            "mac_slope_fallback": bool(fallback),
            "measured_scaling_exponent": exp,
        },
        "source": measurements,
    }


def run_calibration(*, smoke: bool = False, device=None) -> Dict:
    """Measure ``device`` (default: the card) and fit."""
    return fit_calibration(measure(smoke=smoke, device=device))


# -- persistence --------------------------------------------------------------

def save_calibration(calibration: Dict, path: str) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(calibration, f, indent=2)
    return path


def load_calibration(path: str) -> Dict:
    """Read a calibration export; raises ``ValueError`` for another schema or
    a version newer than this reader."""
    with open(path) as f:
        calibration = json.load(f)
    if calibration.get("schema") != CALIBRATION_SCHEMA:
        raise ValueError(
            f"{path}: not a {CALIBRATION_SCHEMA} export "
            f"(schema={calibration.get('schema')!r})")
    if calibration.get("version", 0) > CALIBRATION_VERSION:
        raise ValueError(
            f"{path}: calibration version {calibration['version']} is newer "
            f"than this reader ({CALIBRATION_VERSION})")
    return calibration


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Fit PE-array calibration from measurements on this machine")
    ap.add_argument("--out", default="artifacts/sim/calibration.json")
    ap.add_argument("--smoke", action="store_true", help="small shapes / few reps")
    ap.add_argument("--device", default=None,
                    help="torch device to measure (default: the card)")
    args = ap.parse_args(argv)
    calibration = run_calibration(smoke=args.smoke, device=args.device)
    save_calibration(calibration, args.out)
    print(json.dumps({"id": calibration["id"],
                      "constants": calibration["constants"],
                      "fit": calibration["fit"],
                      "out": args.out}, indent=2))


if __name__ == "__main__":
    main()
