"""Hand-written Hopper kernels, one package each (``ops`` wrapper, ``ref``
plain version, ``csrc`` CUDA source); ``_build`` compiles them on first use.

Every wrapper counts its launches when the host issues one: ``.launches`` in
all, and ``.instantiations`` by the ``__global__`` it launched, which the
wrapper reads from the plan it already computes (``int_dot.plan``,
``decode_attention.ops.gqa_plan``). Under CUDA-graph capture a launch is
issued once, at capture; the graph's replays issue none.
"""
from __future__ import annotations

from typing import Callable, Dict

# each kernel's instantiations: the int_dot paths (``int_dot.PATH_NAMES``),
# the GQA plan's tensor-core and split-key paths, and the one __global__ of
# every other kernel
INSTANTIATIONS = {
    "fused_dot_af": ("narrow", "wgmma", "imad"),
    "cordic_mac": ("narrow", "wgmma", "imad"),
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


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper, by kernel name."""
    from .cordic_af import af_softmax, multi_af
    from .cordic_fused import fused_dot_af
    from .cordic_mac import mac_matmul
    from .decode_attention import gqa_decode_attention, mla_decode_attention
    from .flash_attention import flash_attention
    from .mla_flash import mla_flash_attention

    return {"fused_dot_af": fused_dot_af, "cordic_mac": mac_matmul,
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
