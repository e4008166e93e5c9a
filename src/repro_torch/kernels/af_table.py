"""The int32 AF table that the CUDA multi-AF datapath reads
(``kernels/include/cordic_af.cuh``), shared by the fused dot+AF kernel and
the standalone elementwise AF kernel.

It carries what the reference bakes into each compiled Pallas kernel: the
internal CORDIC depth, the I/O and guard-bit internal formats, the AF
constants and the hyperbolic shift/atanh tables, all from
``core/activations.py`` and ``core/cordic.py``. The layout (``T_*`` offsets)
is the header's.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import activations as afs
from repro_torch.core import cordic
from repro_torch.core.fxp import FxPFormat

AF_TAB_LEN = 80
MAX_HYPERBOLIC_DEPTH = 32


@functools.lru_cache(maxsize=None)
def af_table(af_depth: int, af_fmt: FxPFormat) -> tuple:
    """The table for an I/O-format depth ``af_depth`` and format ``af_fmt``."""
    ifmt = afs.internal_fmt(af_fmt)
    depth = afs.internal_depth(af_depth, af_fmt)
    if depth > MAX_HYPERBOLIC_DEPTH:
        raise ValueError(f"AF depth {depth} exceeds the kernel's {MAX_HYPERBOLIC_DEPTH}")
    seq, atanh, inv_gain, _ = cordic.hyperbolic_tables(depth, ifmt.frac)
    c = afs.af_constants(ifmt)
    tab = [0] * AF_TAB_LEN
    tab[0:10] = [depth, af_fmt.frac, af_fmt.qmin, af_fmt.qmax, ifmt.frac, ifmt.qmin, ifmt.qmax,
                 inv_gain, cordic.hyperbolic_zmax(depth, ifmt.frac), cordic.ln2_raw(ifmt.frac)]
    tab[10:15] = [c["gelu_cubic"], c["gelu_c"], c["half"], c["selu_lambda"], c["selu_alpha"]]
    tab[16:16 + depth] = seq
    tab[48:48 + depth] = atanh
    return tuple(tab)


_device_tables = {}


def af_table_on(device, af_depth: int, af_fmt: FxPFormat) -> torch.Tensor:
    """:func:`af_table` as an int32 tensor on ``device``, made once per key."""
    key = (str(device), af_depth, af_fmt)
    if key not in _device_tables:
        _device_tables[key] = torch.tensor(af_table(af_depth, af_fmt), dtype=torch.int32,
                                           device=device)
    return _device_tables[key]
