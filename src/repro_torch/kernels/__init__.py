"""Hand-written Hopper kernels, one package each (``ops`` wrapper, ``ref``
plain version, ``csrc`` CUDA source); ``_build`` compiles them on first use.

Every wrapper counts its launches when the host issues one: ``.launches`` in
all, and ``.instantiations`` by the ``__global__`` it launched, which the
wrapper reads from the plan it already computes (``int_dot.plan``,
``decode_attention.ops.gqa_plan``). Under CUDA-graph capture a launch is
issued once, at capture; the graph's replays issue none.

On a meta tensor a wrapper takes the same plan, launches nothing and returns
an empty meta result of the kernel's shape and dtype. Launched or not, it
reports ``(kernel, instantiation, cost)`` (``costs.py``) to every active
cost analyzer (``launch/cost_analysis.py``) through :func:`kernel_call`;
the aten ops a wrapper dispatches between its entry and its return
(reshapes, its output, scratch) are the kernel's own, and the analyzers
skip them (:func:`entry`).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List

# each kernel's instantiations: the int_dot paths (``int_dot.PATH_NAMES``),
# the GQA plan's tensor-core and split-key paths, and the one __global__ of
# every other kernel
INSTANTIATIONS = {
    "fused_dot_af": ("narrow", "wgmma", "imad"),
    "fused_dot_partial": ("narrow", "wgmma", "imad"),
    "fused_epilogue": ("elementwise",),
    "cordic_mac": ("narrow", "wgmma", "imad"),
    "cordic_mac_partial": ("narrow", "wgmma", "imad"),
    "cordic_mac_epilogue": ("elementwise",),
    "gqa_decode_attention": ("tc", "split"),
    "mla_decode_attention": ("tc",),
    "af_elementwise": ("elementwise",),
    "af_softmax": ("cluster",),
    "flash_attention": ("tc",),
    "mla_flash_attention": ("tc",),
}


def new_counts(kernel: str) -> Dict[str, int]:
    """A zeroed per-instantiation count for ``kernel``."""
    return dict.fromkeys(INSTANTIATIONS[kernel], 0)


def count_launch(wrapper: Callable, instantiation: str) -> None:
    """Count one launch of ``wrapper``'s ``instantiation``; called where the
    host has just issued it."""
    wrapper.launches += 1
    wrapper.instantiations[instantiation] += 1


# the active cost analyzers, innermost last (launch/cost_analysis.Analyzer)
_listeners: List = []


def kernel_call(wrapper: Callable, instantiation: str, cost: Callable, *,
                launched: bool) -> None:
    """One call of ``wrapper``'s ``instantiation``: counted as a launch where
    the host has just issued it (``launched``), and reported to every active
    analyzer either way with its work, ``cost()`` (a ``costs.KernelCost``;
    computed only when an analyzer listens)."""
    if launched:
        count_launch(wrapper, instantiation)
    if _listeners:
        work = cost()
        for listener in _listeners:
            listener.kernel(wrapper.kernel, instantiation, work)


def entry(kernel: str) -> Callable:
    """Decorate the wrapper of ``kernel``: it gets its zeroed counts, and
    while it runs the active analyzers skip the aten ops it dispatches and
    then take its result as the kernel's output."""
    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _listeners:
                return fn(*args, **kwargs)
            active = list(_listeners)
            for listener in active:
                listener.enter_kernel()
            try:
                out = fn(*args, **kwargs)
            finally:
                for listener in active:
                    listener.exit_kernel()
            for listener in active:
                listener.kernel_output(out)
            return out

        run.kernel = kernel
        run.launches = 0
        run.instantiations = new_counts(kernel)
        return run

    return decorate


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper, by kernel name."""
    from .cordic_af import af_softmax, multi_af
    from .cordic_fused import fused_dot_af, fused_dot_partial, fused_epilogue
    from .cordic_mac import mac_epilogue, mac_matmul, mac_matmul_partial
    from .decode_attention import gqa_decode_attention, mla_decode_attention
    from .flash_attention import flash_attention
    from .mla_flash import mla_flash_attention

    return {"fused_dot_af": fused_dot_af, "fused_dot_partial": fused_dot_partial,
            "fused_epilogue": fused_epilogue, "cordic_mac": mac_matmul,
            "cordic_mac_partial": mac_matmul_partial, "cordic_mac_epilogue": mac_epilogue,
            "gqa_decode_attention": gqa_decode_attention,
            "mla_decode_attention": mla_decode_attention, "af_elementwise": multi_af,
            "af_softmax": af_softmax, "flash_attention": flash_attention,
            "mla_flash_attention": mla_flash_attention}


def launch_counts() -> Dict[str, int]:
    """Every wrapper's launches by instantiation, flat: ``"<kernel>/<inst>"``
    -> count, every instantiation present."""
    return {f"{name}/{inst}": n for name, w in wrappers().items()
            for inst, n in w.instantiations.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's counts to 0."""
    for name, w in wrappers().items():
        w.launches = 0
        w.instantiations = new_counts(name)


def kernel_totals(counts: Dict[str, int]) -> Dict[str, int]:
    """Per-kernel sums of a flat :func:`launch_counts`-style dict."""
    out: Dict[str, int] = {}
    for key, n in counts.items():
        name = key.split("/")[0]
        out[name] = out.get(name, 0) + n
    return out
