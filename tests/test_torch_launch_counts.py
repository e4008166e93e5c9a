"""PyTorch port: every kernel wrapper counts its launches by the
instantiation its plan picks, on the CPU.

No kernel runs here, so each wrapper's launch path (``ops._launch`` and the
like) is driven on CPU tensors with a stub library whose entry points
return 0, a stub stream and a no-op device guard: the wrapper checks its
arguments, computes its plan and scratch exactly as on the card, "launches"
and counts. ``int_dot.plan`` decides the fused and MAC paths (M <= 16:
``narrow``, M > 16 with int8: ``wgmma``, any int16: ``imad``) and
``gqa_plan`` the GQA path (S >= ``TC_MIN_S``: ``tc``, else ``split``).
"""
import contextlib
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core.fxp import FXP8  # noqa: E402
from repro_torch.kernels import int_dot  # noqa: E402
from repro_torch.kernels.cordic_af import ops as af_ops  # noqa: E402
from repro_torch.kernels.cordic_fused import ops as fused_ops  # noqa: E402
from repro_torch.kernels.cordic_mac import ops as mac_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.mla_flash import ops as mla_flash_ops  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

_ENTRY_POINTS = ("cordic_fused_launch", "cordic_mac_launch", "gqa_decode_launch",
                 "mla_decode_launch", "cordic_af_launch", "af_softmax_launch",
                 "flash_attention_launch", "mla_flash_launch")


@pytest.fixture
def stub_launch(monkeypatch):
    """Stub libraries, stream and device guard; every count zeroed."""
    lib = types.SimpleNamespace(**{name: (lambda *a: 0) for name in _ENTRY_POINTS})
    for mod in (af_ops, fused_ops, mac_ops, attn_ops, flash_ops, mla_flash_ops):
        monkeypatch.setattr(mod, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(af_ops, "launch_plan", lambda rows, n, dev: af_ops.softmax_plan(rows, n))
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


def _only(kernel, inst, n=1):
    want = {key: 0 for key in kernels.launch_counts()}
    want[f"{kernel}/{inst}"] = n
    assert kernels.launch_counts() == want
    assert kernels.wrappers()[kernel].launches == n


def _bank(k, n, dtype=torch.int8):
    return int_dot.to_k_major(torch.randint(-3, 4, (k, n), dtype=dtype))


@pytest.mark.parametrize("m,dtype,inst", [(1, torch.int8, "narrow"), (16, torch.int8, "narrow"),
                                          (17, torch.int8, "wgmma"), (512, torch.int8, "wgmma"),
                                          (4, torch.int16, "imad"), (64, torch.int16, "imad")])
def test_fused_counts_follow_int_dot_plan(stub_launch, m, dtype, inst):
    k, n = 96, 160
    assert int_dot.PATH_NAMES[int_dot.plan(m, n, k, dtype.itemsize, dtype.itemsize).path] == inst
    point = torch.zeros(5, dtype=torch.int32)
    fused_ops._launch(torch.randn(m, k), _bank(k, n, dtype), point, 0, 8, FXP8, False)
    _only("fused_dot_af", inst)


@pytest.mark.parametrize("m,dtype,inst", [(4, torch.int8, "narrow"), (33, torch.int8, "wgmma"),
                                          (8, torch.int16, "imad")])
def test_mac_counts_follow_int_dot_plan(stub_launch, m, dtype, inst):
    k, n = 128, 64
    x = torch.randint(-3, 4, (m, k), dtype=dtype)
    mac_ops._launch(x, _bank(k, n, dtype), torch.ones(m, 1), torch.ones(1, n), False)
    _only("cordic_mac", inst)


@pytest.mark.parametrize("s", [1, 4, attn_ops.TC_MIN_S - 1, attn_ops.TC_MIN_S, 64])
def test_gqa_counts_follow_gqa_plan(stub_launch, s):
    b, t, h, kv, hd = 2, 64, 4, 2, 32
    inst = "tc" if attn_ops.gqa_plan(b, s, h, t, kv).path == attn_ops.TENSOR_CORES else "split"
    assert inst == ("tc" if s >= attn_ops.TC_MIN_S else "split")
    positions = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    attn_ops._launch(torch.randn(b, s, h, hd), torch.randn(b, t, kv, hd),
                     torch.randn(b, t, kv, hd), positions, 0.1)
    _only("gqa_decode_attention", inst)


def test_single_instantiation_kernels_count(stub_launch):
    b, s, h, r, rd, t = 1, 3, 4, 16, 8, 20
    positions = torch.arange(s, dtype=torch.int32)[None].contiguous()
    attn_ops._mla_launch(torch.randn(b, s, h, r), torch.randn(b, s, h, rd), torch.randn(b, t, r),
                         torch.randn(b, t, rd), positions, 0.1)
    _only("mla_decode_attention", "tc")
    kernels.reset_launch_counts()
    af_ops._launch(torch.randn(3, 5), "swish", 8, FXP8)
    _only("af_elementwise", "elementwise")
    kernels.reset_launch_counts()
    af_ops._launch_softmax(torch.randn(3, 300), 8, FXP8)
    _only("af_softmax", "cluster")
    kernels.reset_launch_counts()
    flash_ops._launch(torch.randn(1, 8, 2, 32), torch.randn(1, 8, 2, 32),
                      torch.randn(1, 8, 2, 32), True)
    _only("flash_attention", "tc")
    kernels.reset_launch_counts()
    mla_flash_ops._launch(torch.randn(1, 8, 4, r), torch.randn(1, 8, 4, rd), torch.randn(1, 8, r),
                          torch.randn(1, 8, rd), 0.1, True)
    _only("mla_flash_attention", "tc")


def test_cpu_tensors_never_count():
    kernels.reset_launch_counts()
    fused_ops.fused_dot_af(torch.randn(2, 32), torch.randint(-3, 4, (32, 16), dtype=torch.int8),
                           torch.tensor([8, 6, 0, 0, 0], dtype=torch.int32))
    assert not any(kernels.launch_counts().values())


def test_kernel_totals_sum_instantiations():
    counts = {"fused_dot_af/narrow": 3, "fused_dot_af/wgmma": 2, "gqa_decode_attention/tc": 1}
    assert kernels.kernel_totals(counts) == {"fused_dot_af": 5, "gqa_decode_attention": 1}
