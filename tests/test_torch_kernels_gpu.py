"""The port's Hopper kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports only torch and the port, so it also runs on a host without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The fused dot+AF and the standalone multi-AF must be bitwise equal to their
plain versions; the GQA and MLA decode attentions within
``decode_attention.TOLERANCE`` (f32 reduction order).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cordic, fxp  # noqa: E402
from repro_torch.core.backends.kernel import make_point  # noqa: E402
from repro_torch.core.cordic import signed_digit_ints  # noqa: E402
from repro_torch.kernels.cordic_af import ELEMENTWISE_AFS, multi_af, multi_af_ref  # noqa: E402
from repro_torch.kernels.cordic_fused import FUSED_AFS, fused_dot_af, fused_dot_af_ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TOLERANCE,
    gqa_decode_attention,
    gqa_decode_attention_ref,
    mla_decode_attention,
    mla_decode_attention_ref,
)

FORMATS = {"fxp8": (fxp.FXP8, fxp.FXP8_UNIT), "fxp16": (fxp.FXP16, fxp.FXP16_UNIT)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (5, 300, 77), (40, 4100, 130),
                                   (200, 256, 512)])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_fused_kernel_bitwise_equal_to_plain_version(cuda, m, k, n, name):
    fmt, unit = FORMATS[name]
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda) * 2
    x[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.4
    ints = signed_digit_ints(w, unit.frac + 1, unit).to(unit.storage_dtype)
    point = make_point(unit.frac + 1, fmt, unit, device=cuda)
    for af in FUSED_AFS:
        for compute_round in (False, True):
            kw = dict(af_mode=af, af_depth=fmt.frac + 1, af_fmt=fmt,
                      compute_round=compute_round)
            before = fused_dot_af.launches
            got = fused_dot_af(x, ints, point, **kw)
            assert fused_dot_af.launches == before + 1
            want = fused_dot_af_ref(x, ints, point, **kw)
            assert torch.equal(got, want), (af, compute_round)


@pytest.mark.gpu
def test_fused_kernel_wraps_int32_overflow(cuda):
    fmt, unit = FORMATS["fxp16"]
    x = torch.full((2, 4096), 7.99, device=cuda)
    ints = torch.full((4096, 8), 32767, dtype=torch.int16, device=cuda)
    point = make_point(15, fmt, unit, device=cuda)
    got = fused_dot_af(x, ints, point, af_mode="identity", af_fmt=fmt)
    assert torch.equal(got, fused_dot_af_ref(x, ints, point, af_mode="identity", af_fmt=fmt))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd,t", [(4, 1, 16, 16, 128, 512), (1, 64, 16, 16, 128, 512),
                                           (3, 5, 8, 4, 64, 100), (2, 1, 4, 2, 32, 33)])
def test_attention_kernel_within_tolerance_of_plain_version(cuda, b, s, h, kv, hd, t):
    gen = torch.Generator(device=cuda).manual_seed(b * s * t)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    ck = torch.randn((b, t, kv, hd), generator=gen, device=cuda)
    cv = torch.randn((b, t, kv, hd), generator=gen, device=cuda)
    start = torch.randint(0, t - s + 1, (b, 1), generator=gen, device=cuda)
    pos = (start + torch.arange(s, device=cuda)[None]).to(torch.int32)
    pos[0, -1] = t + 7  # a drained slot whose index ran past the cache
    scale = 1.0 / math.sqrt(hd)
    before = gqa_decode_attention.launches
    got = gqa_decode_attention(q, ck, cv, pos, scale=scale)
    assert gqa_decode_attention.launches == before + 1
    want = gqa_decode_attention_ref(q, ck, cv, pos, scale=scale)
    assert (got - want).abs().max().item() <= TOLERANCE


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,r,rd,t", [(4, 1, 128, 512, 64, 512), (1, 64, 128, 512, 64, 512),
                                          (3, 5, 7, 512, 64, 100), (2, 3, 4, 16, 8, 33)])
def test_mla_kernel_within_tolerance_of_plain_version(cuda, b, s, h, r, rd, t):
    gen = torch.Generator(device=cuda).manual_seed(b * s * t + r)
    ql = torch.randn((b, s, h, r), generator=gen, device=cuda)
    qr = torch.randn((b, s, h, rd), generator=gen, device=cuda)
    ck = torch.randn((b, t, r), generator=gen, device=cuda)
    kr = torch.randn((b, t, rd), generator=gen, device=cuda)
    start = torch.randint(0, t - s + 1, (b, 1), generator=gen, device=cuda)
    pos = (start + torch.arange(s, device=cuda)[None]).to(torch.int32)
    pos[0, -1] = t + 7  # a drained slot whose index ran past the cache
    scale = 1.0 / math.sqrt(r + rd)
    before = mla_decode_attention.launches
    got = mla_decode_attention(ql, qr, ck, kr, pos, scale=scale)
    assert mla_decode_attention.launches == before + 1
    want = mla_decode_attention_ref(ql, qr, ck, kr, pos, scale=scale)
    assert (got - want).abs().max().item() <= TOLERANCE


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_af_kernel_bitwise_equal_to_plain_version(cuda, name):
    fmt, _ = FORMATS[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    x = torch.randn((3, 1000, 77), generator=gen, device=cuda) * 3
    x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    for depth in range(2, cordic.full_depth(fmt) + 1):
        for mode in ELEMENTWISE_AFS:
            before = multi_af.launches
            got = multi_af(x, mode, depth=depth, fmt=fmt)
            assert multi_af.launches == before + 1
            assert torch.equal(got, multi_af_ref(x, mode, depth=depth, fmt=fmt)), (depth, mode)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn((4, 64), device=cuda)
    point = make_point(7, fxp.FXP8, fxp.FXP8_UNIT, device=cuda)
    with pytest.raises(ValueError, match="int8/int16"):
        fused_dot_af(x, torch.zeros((64, 8), device=cuda), point)
    q = torch.randn((1, 1, 2, 48), device=cuda)
    kv = torch.randn((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        gqa_decode_attention(q, kv, kv, torch.zeros((1, 1), dtype=torch.int32, device=cuda),
                             scale=0.1)
    ql = torch.randn((1, 1, 2, 1024), device=cuda)
    lat = torch.randn((1, 8, 1024), device=cuda)
    with pytest.raises(ValueError, match="latent dim"):
        mla_decode_attention(ql, ql[..., :8], lat, lat[..., :8],
                             torch.zeros((1, 1), dtype=torch.int32, device=cuda), scale=0.1)
