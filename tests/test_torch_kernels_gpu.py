"""The port's Hopper kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports only torch and the port, so it also runs on a host without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The fused dot+AF and the MAC-array matmul take K-major weight banks (as
``prepare_params`` and ``quantize_weights`` store them) and refuse any
other layout; on every path (the tensor-core prefill loop at M > 16, the
narrow decode loop, the FxP16 CUDA-core loop) they, the standalone multi-AF
and its row softmax must be bitwise equal to their plain versions; the GQA and MLA
decode attentions and the cache-free flash and MLA flash attentions within
``decode_attention.TOLERANCE`` (f32 reduction order; a bf16 flash output
within one bf16 rounding step besides).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import EngineContext, PrecisionPolicy, cordic, fxp  # noqa: E402
from repro_torch.core.backends.kernel import make_point  # noqa: E402
from repro_torch.core.cordic import signed_digit_ints  # noqa: E402
from repro_torch.kernels.cordic_af import (  # noqa: E402
    ELEMENTWISE_AFS,
    af_softmax,
    af_softmax_ref,
    multi_af,
    multi_af_ref,
)
from repro_torch.kernels.cordic_af.ops import launch_plan as softmax_launch_plan  # noqa: E402
from repro_torch.kernels.cordic_af.ops import softmax_plan  # noqa: E402
from repro_torch.kernels.cordic_mac import mac_matmul, mac_matmul_ref  # noqa: E402
from repro_torch.kernels.cordic_fused import FUSED_AFS, fused_dot_af, fused_dot_af_ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    TOLERANCE,
    gqa_decode_attention,
    gqa_decode_attention_ref,
    mla_decode_attention,
    mla_decode_attention_ref,
)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    SPLIT_KEYS,
    TC_MIN_S,
    TENSOR_CORES,
    gqa_plan,
    mla_splits,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.kernels.int_dot import (IMAD, NARROW, PATH_NAMES, WGMMA, plan,  # noqa: E402
                                         to_k_major)
from repro_torch.kernels.mla_flash import mla_flash_attention, mla_flash_attention_ref  # noqa: E402

FORMATS = {"fxp8": (fxp.FXP8, fxp.FXP8_UNIT), "fxp16": (fxp.FXP16, fxp.FXP16_UNIT)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fused_case(cuda, m, k, n, name, seed):
    """x with NaN/±inf, a K-major bank and its point for one fused shape."""
    fmt, unit = FORMATS[name]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=cuda) * 2
    x[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.4
    ints = to_k_major(signed_digit_ints(w, unit.frac + 1, unit).to(unit.storage_dtype))
    return fmt, x, ints, make_point(unit.frac + 1, fmt, unit, device=cuda)


def _fused_all_modes(x, ints, point, fmt):
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
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (5, 300, 77), (40, 4100, 130),
                                   (200, 256, 512)])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_fused_kernel_bitwise_equal_to_plain_version(cuda, m, k, n, name):
    fmt, x, ints, point = _fused_case(cuda, m, k, n, name, m + k + n)
    _fused_all_modes(x, ints, point, fmt)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(17, 1000, 77), (33, 1000, 77), (64, 2048, 576),
                                   (100, 1000, 576), (512, 2048, 2048), (1024, 2048, 77),
                                   (1024, 1000, 576), (512, 2048, 8192), (300, 1000, 8200)])
def test_fused_tensor_core_path_bitwise_equal_to_plain_version(cuda, m, k, n):
    """M > 16 at FxP8: int8 wgmma on 128- and 256-wide tiles, ragged M and
    N, a padded K stride."""
    assert plan(m, n, k).path == WGMMA
    fmt, x, ints, point = _fused_case(cuda, m, k, n, "fxp8", m * k + n)
    assert k % 16 or ints.stride(1) == k
    _fused_all_modes(x, ints, point, fmt)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 2048, 2048), (8, 7168, 576), (16, 1000, 77),
                                   (12, 18432, 300)])
def test_fused_narrow_path_bitwise_equal_to_plain_version(cuda, m, k, n):
    """M <= 16 at FxP8: the streaming mma.sync loop, split K."""
    assert plan(m, n, k).path == NARROW
    fmt, x, ints, point = _fused_case(cuda, m, k, n, "fxp8", m * k + n)
    _fused_all_modes(x, ints, point, fmt)


@pytest.mark.gpu
def test_fused_kernel_wraps_int32_overflow(cuda):
    fmt, unit = FORMATS["fxp16"]
    x = torch.full((2, 4096), 7.99, device=cuda)
    ints = to_k_major(torch.full((4096, 8), 32767, dtype=torch.int16, device=cuda))
    point = make_point(15, fmt, unit, device=cuda)
    assert plan(2, 8, 4096, 2, 2).path == IMAD
    got = fused_dot_af(x, ints, point, af_mode="identity", af_fmt=fmt)
    assert torch.equal(got, fused_dot_af_ref(x, ints, point, af_mode="identity", af_fmt=fmt))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd,t", [(4, 1, 16, 16, 128, 512), (1, 64, 16, 16, 128, 512),
                                           (3, 5, 8, 4, 64, 100), (2, 1, 4, 2, 32, 33),
                                           (1, 16, 16, 16, 128, 512), (1, 512, 16, 16, 128, 512),
                                           (2, 8, 16, 8, 128, 512), (2, 17, 8, 2, 64, 100),
                                           (3, 15, 8, 4, 32, 77), (1, 100, 4, 1, 128, 300)])
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
@pytest.mark.parametrize("s", [1, 4, 8, 15, 16, 17, 64, 512])
@pytest.mark.parametrize("h,kv,hd", [(16, 16, 128), (8, 4, 64), (8, 2, 32)])
def test_attention_kernel_ragged_positions_and_masked_rows(cuda, s, h, kv, hd):
    """Both paths (split keys below TC_MIN_S query rows, the tensor cores from
    it on) at every S of a bucket edge: positions drawn independently per row
    (not a run), one row with pos < 0 (every key masked: a uniform softmax
    over all T), one past the cache, and T not a multiple of the 32-key tile."""
    b, t = 2, 300 if s < 512 else 520
    gen = torch.Generator(device=cuda).manual_seed(s * hd + kv)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    ck = torch.randn((b, t, kv, hd), generator=gen, device=cuda)
    cv = torch.randn((b, t, kv, hd), generator=gen, device=cuda)
    pos = torch.randint(0, t, (b, s), generator=gen, device=cuda, dtype=torch.int32)
    pos[0, 0] = -1
    pos[b - 1, s - 1] = t + 7
    scale = 1.0 / math.sqrt(hd)
    path, splits = gqa_plan(b, s, h, t, kv)
    assert path == (TENSOR_CORES if s >= TC_MIN_S else SPLIT_KEYS)
    before = gqa_decode_attention.launches
    got = gqa_decode_attention(q, ck, cv, pos, scale=scale)
    assert gqa_decode_attention.launches == before + 1
    want = gqa_decode_attention_ref(q, ck, cv, pos, scale=scale)
    assert (got - want).abs().max().item() <= TOLERANCE, (path, splits)
    # the row with pos < 0: every key weighs 1 / T
    assert (got[0, 0, 0] - cv[0, :, 0].mean(0)).abs().max().item() <= TOLERANCE


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,r,rd,t,start", [
    (4, 1, 128, 512, 64, 512, None), (1, 64, 128, 512, 64, 512, None),
    (3, 5, 7, 512, 64, 100, None), (2, 3, 4, 16, 8, 33, None), (2, 5, 7, 12, 8, 45, None),
    (3, 4, 4, 12, 4, 70, None), (1, 16, 128, 512, 64, 512, 0), (1, 512, 128, 512, 64, 512, 0)])
def test_mla_kernel_within_tolerance_of_plain_version(cuda, b, s, h, r, rd, t, start):
    """Random runs of positions (start None) or a serving prefill from row 0;
    R or R + r not a multiple of 8 (12 + 8, 12 + 4), H not a multiple of the
    32-head block; a drained slot (pos >= T) and a masked row (pos < 0)."""
    gen = torch.Generator(device=cuda).manual_seed(b * s * t + r)
    ql = torch.randn((b, s, h, r), generator=gen, device=cuda)
    qr = torch.randn((b, s, h, rd), generator=gen, device=cuda)
    ck = torch.randn((b, t, r), generator=gen, device=cuda)
    kr = torch.randn((b, t, rd), generator=gen, device=cuda)
    first = (torch.zeros((b, 1), dtype=torch.int64, device=cuda) if start == 0 else
             torch.randint(0, t - s + 1, (b, 1), generator=gen, device=cuda))
    pos = (first + torch.arange(s, device=cuda)[None]).to(torch.int32)
    if start is None:
        pos[0, -1] = t + 7  # a drained slot whose index ran past the cache
        pos[-1, 0] = -1  # a masked row: every key weighs 1 / T
    scale = 1.0 / math.sqrt(r + rd)
    before = mla_decode_attention.launches
    got = mla_decode_attention(ql, qr, ck, kr, pos, scale=scale)
    assert mla_decode_attention.launches == before + 1
    want = mla_decode_attention_ref(ql, qr, ck, kr, pos, scale=scale)
    assert (got - want).abs().max().item() <= TOLERANCE
    if start is None:
        assert (got[-1, 0] - ck[-1].mean(0)).abs().max().item() <= TOLERANCE


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd,causal", [
    (2, 512, 16, 16, 128, True), (1, 70, 16, 4, 128, True), (2, 33, 4, 2, 32, False),
    (1, 100, 2, 1, 256, True), (3, 17, 4, 4, 16, True), (2, 64, 8, 8, 64, False),
    (1, 200, 4, 2, 256, False), (2, 130, 8, 2, 16, False), (1, 1, 2, 2, 64, True),
    (1, 2048, 16, 16, 128, True), (2, 333, 16, 4, 128, False)])
def test_flash_kernel_within_tolerance_of_plain_version(cuda, b, s, h, kv, hd, causal):
    gen = torch.Generator(device=cuda).manual_seed(b * s + hd)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    k = torch.randn((b, s, kv, hd), generator=gen, device=cuda)
    v = torch.randn((b, s, kv, hd), generator=gen, device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= TOLERANCE


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,t,start", [
    (4, 1, 32, 32, 512, None), (2, 4, 32, 32, 512, None), (1, 16, 32, 32, 512, 0),
    (1, 64, 32, 32, 512, 0), (1, 512, 32, 32, 512, 0), (3, 5, 8, 2, 100, None),
    (2, 17, 8, 4, 77, None), (4, 1, 4, 4, 33, None)])
def test_attention_kernel_head_dim_112(cuda, b, s, h, kv, t, start):
    """zamba2's shared attention (H32/KV32, head_dim 112: not a multiple of
    the split path's 32 lanes, nor 8-dim groups a multiple of 8): decode,
    a burst of 4 and the prefill buckets from row 0, both paths, with
    grouped heads, a drained slot and a masked row on the random runs."""
    gen = torch.Generator(device=cuda).manual_seed(b * s * t + 112)
    q = torch.randn((b, s, h, 112), generator=gen, device=cuda)
    ck = torch.randn((b, t, kv, 112), generator=gen, device=cuda)
    cv = torch.randn((b, t, kv, 112), generator=gen, device=cuda)
    first = (torch.zeros((b, 1), dtype=torch.int64, device=cuda) if start == 0 else
             torch.randint(0, t - s + 1, (b, 1), generator=gen, device=cuda))
    pos = (first + torch.arange(s, device=cuda)[None]).to(torch.int32)
    if start is None and b > 1:
        pos[0, -1] = t + 7  # a drained slot
        pos[-1, 0] = -1  # a masked row: every key weighs 1 / T
    scale = 1.0 / math.sqrt(112)
    path, _ = gqa_plan(b, s, h, t, kv)
    assert path == (TENSOR_CORES if s >= TC_MIN_S else SPLIT_KEYS)
    got = gqa_decode_attention(q, ck, cv, pos, scale=scale)
    want = gqa_decode_attention_ref(q, ck, cv, pos, scale=scale)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOLERANCE, path
    if start is None and b > 1:
        g = h // kv
        assert (got[-1, 0, :g] - cv[-1, :, 0].mean(0)).abs().max().item() <= TOLERANCE


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd,causal", [
    (1, 512, 32, 32, 112, True), (1, 512, 32, 32, 112, False), (2, 70, 8, 2, 112, False),
    (2, 45, 4, 4, 112, True), (1, 256, 16, 16, 64, False), (2, 100, 16, 16, 64, False)])
def test_flash_kernel_head_dim_112_and_non_causal(cuda, b, s, h, kv, hd, causal):
    """zamba2's forward (head_dim 112, causal) and seamless's encoder (full,
    non-causal attention at head_dim 64; its pooled 256 frames), ragged S."""
    gen = torch.Generator(device=cuda).manual_seed(b * s + hd + causal)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    k = torch.randn((b, s, kv, hd), generator=gen, device=cuda)
    v = torch.randn((b, s, kv, hd), generator=gen, device=cuda)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOLERANCE
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    got, want = flash_attention(*bf, causal=causal), flash_attention_ref(*bf, causal=causal)
    diff = (got.float() - want.float()).abs()
    assert (diff / (want.float().abs() * 2.0**-7 + TOLERANCE)).max().item() <= 1.0


@pytest.mark.gpu
def test_flash_kernel_bf16_within_one_rounding_step(cuda):
    """bf16 in and out: the kernel and the plain version each round an f32
    result that agrees within TOLERANCE, so they differ by at most one bf16
    step where that rounding falls differently: 2^-7 of the value bounds it
    (8 significant bits)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((2, 300, 16, 128), generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    got = flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    worst = (diff / (want.float().abs() * 2.0**-7 + TOLERANCE)).max().item()
    assert worst <= 1.0, worst


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", [(70, 100), (100, 70)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_query_and_key_lengths_differ(cuda, sq, sk, causal):
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((2, sq, 8, 64), generator=gen, device=cuda)
    k = torch.randn((2, sk, 2, 64), generator=gen, device=cuda)
    v = torch.randn((2, sk, 2, 64), generator=gen, device=cuda)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert (got - want).abs().max().item() <= TOLERANCE


@pytest.mark.gpu
@pytest.mark.parametrize("s,kv,d,causal", [(77, 4, 16, True), (130, 2, 64, False),
                                           (512, 16, 128, True), (200, 1, 256, True),
                                           (64, 8, 256, False)])
def test_flash_kernel_bf16_every_head_dim(cuda, s, kv, d, causal):
    """bf16 at the edge head dims, ragged S, causal and not: within one bf16
    rounding step of the plain version (see the test above)."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn((2, s, 16, d), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((2, s, kv, d), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    diff = (got.float() - want.float()).abs()
    worst = (diff / (want.float().abs() * 2.0**-7 + TOLERANCE)).max().item()
    assert worst <= 1.0, worst


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,r,rd,causal", [(1, 512, 128, 512, 64, True),
                                               (2, 70, 7, 512, 64, True),
                                               (2, 70, 4, 32, 16, True),
                                               (2, 40, 4, 16, 8, False),
                                               (2, 45, 7, 12, 8, True),
                                               (1, 33, 5, 12, 4, False)])
def test_mla_flash_kernel_within_tolerance_of_plain_version(cuda, b, s, h, r, rd, causal):
    gen = torch.Generator(device=cuda).manual_seed(b * s + r)
    ql = torch.randn((b, s, h, r), generator=gen, device=cuda)
    qr = torch.randn((b, s, h, rd), generator=gen, device=cuda)
    ck = torch.randn((b, s, r), generator=gen, device=cuda)
    kr = torch.randn((b, s, rd), generator=gen, device=cuda)
    scale = 1.0 / math.sqrt(r + rd)
    before = mla_flash_attention.launches
    got = mla_flash_attention(ql, qr, ck, kr, scale=scale, causal=causal)
    assert mla_flash_attention.launches == before + 1
    want = mla_flash_attention_ref(ql, qr, ck, kr, scale=scale, causal=causal)
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
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (3, 1000, 300), (17, 2048, 300),
                                   (32, 512, 2048), (40, 4100, 130), (512, 2048, 512),
                                   (1, 16, 1), (33, 1000, 77), (64, 2048, 576),
                                   (100, 1000, 576), (1024, 2048, 2048), (300, 1000, 8200)])
@pytest.mark.parametrize("x_type,w_type", [(torch.int8, torch.int8), (torch.int16, torch.int16),
                                           (torch.int8, torch.int16)],
                         ids=["i8", "i16", "i8xi16"])
def test_mac_kernel_bitwise_equal_to_plain_version(cuda, m, k, n, x_type, w_type):
    gen = torch.Generator(device=cuda).manual_seed(m * k + n)

    def ints(shape, dtype):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, shape, generator=gen, device=cuda,
                             dtype=torch.int32).to(dtype)

    # x rows and bank columns K-contiguous, padded to 16 bytes
    x_q, w_q = to_k_major(ints((k, m), x_type)).T, to_k_major(ints((k, n), w_type))
    x_scale = torch.rand((m, 1), generator=gen, device=cuda) * 2 - 1
    w_scale = torch.full((1, n), 2.0**-14, device=cuda)
    want_path = IMAD if torch.int16 in (x_type, w_type) else (WGMMA if m > 16 else NARROW)
    assert plan(m, n, k, x_q.element_size(), w_q.element_size()).path == want_path
    for relu in (False, True):
        before = mac_matmul.launches
        got = mac_matmul(x_q, w_q, x_scale, w_scale, fuse_relu=relu)
        assert mac_matmul.launches == before + 1
        assert torch.equal(got, mac_matmul_ref(x_q, w_q, x_scale, w_scale, fuse_relu=relu))


@pytest.mark.gpu
def test_mac_kernel_wraps_int32_overflow(cuda):
    x_q = torch.full((4, 8192), 32000, dtype=torch.int16, device=cuda)
    w_q = to_k_major(torch.full((8192, 256), 30000, dtype=torch.int16, device=cuda))
    xs, ws = torch.full((4, 1), 2.0**-12, device=cuda), torch.full((1, 256), 2.0**-14, device=cuda)
    got = mac_matmul(x_q, w_q, xs, ws)
    assert torch.equal(got, mac_matmul_ref(x_q, w_q, xs, ws))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_per_call_dot_launches_the_mac_kernel(cuda, name):
    fmt, _ = FORMATS[name]
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 3, 512), generator=gen, device=cuda)
    w = torch.randn((512, 300), generator=gen, device=cuda) * 0.4
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(fmt),
                        compute_dtype=torch.float32)
    before = mac_matmul.launches
    got = ctx.dot(x, w, name="layer.mlp.up")
    assert mac_matmul.launches == before + 1
    want = ctx.dot(x.cpu(), w.cpu(), name="layer.mlp.up")
    assert torch.equal(got.cpu(), want)


# (rows, n) -> the softmax kernel's (cluster size, path) on an H100: every
# plan path launches (one CTA a row, clusters of 2 and 16, a row past the
# shared-memory cap staged in the output row)
SOFTMAX_PLANS = {(64, 512): (1, "shared"), (5, 300): (1, "shared"), (4, 50304): (16, "shared"),
                 (3, 1): (1, "shared"), (1, 50304): (16, "shared"), (1, 2048): (2, "shared"),
                 (4096, 64): (1, "shared"), (7, 17): (1, "shared"),
                 (2, 1_000_000): (16, "staged")}


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", list(SOFTMAX_PLANS))
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_softmax_kernel_bitwise_equal_to_plain_version(cuda, m, n, name):
    fmt, _ = FORMATS[name]
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn((m, n), generator=gen, device=cuda) * 3
    x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    if m > 1:
        x[-1, -1] = float("inf")  # the row max in the last CTA's slice
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = softmax_launch_plan(m, n, cuda)
    assert plan.planned_cluster == softmax_plan(m, n, sms=sms).cluster
    if sms == 132:  # an H100 SXM
        assert (plan.cluster, plan.path) == SOFTMAX_PLANS[(m, n)]
    for depth in (2, cordic.full_depth(fmt)):
        before = af_softmax.launches
        got = multi_af(x, "softmax", depth=depth, fmt=fmt)
        assert af_softmax.launches == before + 1
        assert torch.equal(got, af_softmax_ref(x, depth=depth, fmt=fmt)), depth


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn((4, 64), device=cuda)
    point = make_point(7, fxp.FXP8, fxp.FXP8_UNIT, device=cuda)
    with pytest.raises(ValueError, match="int8/int16"):
        fused_dot_af(x, torch.zeros((64, 8), device=cuda), point)
    scales = torch.ones((4, 1), device=cuda), torch.ones((1, 8), device=cuda)
    bank = to_k_major(torch.zeros((64, 8), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="int8/int16"):
        mac_matmul(x, bank, *scales)
    with pytest.raises(ValueError, match="scales"):
        mac_matmul(x.to(torch.int8), bank, scales[1], scales[0])
    q = torch.randn((1, 1, 2, 48), device=cuda)
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
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="one type"):
        flash_attention(q.to(torch.bfloat16)[..., :32], kv[..., :32], kv[..., :32])
    with pytest.raises(ValueError, match="latent dim"):
        mla_flash_attention(ql, ql[..., :8], lat, lat[..., :8], scale=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
def test_wrappers_refuse_banks_that_are_not_k_major(cuda, m):
    """An N-major bank, or a K-major one whose column stride is not a multiple
    of 16 bytes, is refused on every path, never copied."""
    point = make_point(7, fxp.FXP8, fxp.FXP8_UNIT, device=cuda)
    x = torch.randn((m, 64), device=cuda)
    n_major = torch.zeros((64, 32), dtype=torch.int8, device=cuda)
    misaligned = torch.zeros((32, 72), dtype=torch.int8, device=cuda)[:, :64].T
    assert misaligned.stride() == (1, 72)
    scales = torch.ones((m, 1), device=cuda), torch.ones((1, 32), device=cuda)
    x_q = to_k_major(torch.zeros((64, m), dtype=torch.int8, device=cuda)).T
    for bank in (n_major, misaligned):
        with pytest.raises(ValueError, match="K-major"):
            fused_dot_af(x, bank, point)
        with pytest.raises(ValueError, match="K-major"):
            mac_matmul(x_q, bank, *scales)
    with pytest.raises(ValueError, match="16-byte-aligned rows"):
        mac_matmul(torch.zeros((m, 72), dtype=torch.int8, device=cuda)[:, :64],
                   to_k_major(n_major), *scales)


# the instantiations that adaptive and speculative serving of olmo-1b reach
# (the hifi point's FxP16 banks; a verify of 4 drafts on 4 slots)
VERIFY_B, VERIFY_S = 4, 5


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 20, 512])
@pytest.mark.parametrize("k,n,af", [(2048, 8192, "swish"), (2048, 50304, "identity"),
                                    (8192, 2048, "identity")])
def test_fused_hifi_point_bitwise_equal_to_plain_version(cuda, m, k, n, af):
    """The hifi point's dots: int16 banks, activations quantized at FxP16,
    the AF epilogue at the serving context's FxP8 depth, on the CUDA-core
    loop at decode (4 rows), a verify (20 rows) and the largest bucket; once
    on inputs whose int32 sums wrap modulo 2^32."""
    assert plan(m, n, k, 2, 2).path == IMAD
    _, x, ints, point = _fused_case(cuda, m, k, n, "fxp16", m + k + n)
    kw = dict(af_mode=af, af_depth=fxp.FXP8.frac + 1, af_fmt=fxp.FXP8)
    for scale in (1.0, 1e3):
        got = fused_dot_af(x * scale, ints, point, **kw)
        assert torch.equal(got, fused_dot_af_ref(x * scale, ints, point, **kw)), scale


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 8192), (8192, 2048), (2048, 50304)])
def test_fused_verify_rows_bitwise_equal_to_plain_version(cuda, k, n):
    """A speculative verify's dots at FxP8: 4 slots x 5 rows on the int8
    tensor cores, every row the bits of its own single-row dot."""
    m = VERIFY_B * VERIFY_S
    assert plan(m, n, k).path == WGMMA
    fmt, x, ints, point = _fused_case(cuda, m, k, n, "fxp8", k + n)
    _fused_all_modes(x, ints, point, fmt)
    kw = dict(af_mode="identity", af_depth=fmt.frac + 1, af_fmt=fmt)
    block = fused_dot_af(x, ints, point, **kw)
    for i in (1, m - 1):
        assert torch.equal(fused_dot_af(x[i:i + 1], ints, point, **kw)[0], block[i])


@pytest.mark.gpu
@pytest.mark.parametrize("starts", [(125, 253, 30, 380), (0, 60, 127, 250)])
def test_gqa_verify_rows_equal_single_row_calls(cuda, starts):
    """A verify's GQA call at olmo-1b widths (B4 S5, T512, split keys): within
    tolerance of the plain version, and each query row bit for bit the
    single-row call of its position (windows that cross 128 and 256 keys)."""
    b, s, h, kv, hd, t = VERIFY_B, VERIFY_S, 16, 16, 128, 512
    gen = torch.Generator(device=cuda).manual_seed(sum(starts))
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    ck = torch.randn((b, t, kv, hd), generator=gen, device=cuda)
    cv = torch.randn((b, t, kv, hd), generator=gen, device=cuda)
    pos = (torch.tensor(starts, device=cuda)[:, None]
           + torch.arange(s, device=cuda)[None]).to(torch.int32)
    scale = 1.0 / math.sqrt(hd)
    path, splits = gqa_plan(b, s, h, t, kv)
    assert path == SPLIT_KEYS and (path, splits) == gqa_plan(b, 1, h, t, kv)
    block = gqa_decode_attention(q, ck, cv, pos, scale=scale)
    want = gqa_decode_attention_ref(q, ck, cv, pos, scale=scale)
    assert (block - want).abs().max().item() <= TOLERANCE
    for j in range(s):
        alone = gqa_decode_attention(q[:, j:j + 1].contiguous(), ck, cv,
                                     pos[:, j:j + 1].contiguous(), scale=scale)
        assert torch.equal(alone[:, 0], block[:, j]), j


@pytest.mark.gpu
def test_mla_decode_at_verify_rows(cuda):
    """A verify's MLA call at deepseek-v3 widths (B4 S5, H128, R512, r64,
    T512) within tolerance of the plain version, and each query row bit for
    bit the single-row call of its position (the key splits counted from
    one query step, split i taking tiles i, i + splits, ...)."""
    b, s, h, r, rd, t = VERIFY_B, VERIFY_S, 128, 512, 64, 512
    gen = torch.Generator(device=cuda).manual_seed(55)
    ql = torch.randn((b, s, h, r), generator=gen, device=cuda)
    qr = torch.randn((b, s, h, rd), generator=gen, device=cuda)
    ck = torch.randn((b, t, r), generator=gen, device=cuda)
    kr = torch.randn((b, t, rd), generator=gen, device=cuda)
    pos = (torch.tensor([125, 253, 30, 500], device=cuda)[:, None]
           + torch.arange(s, device=cuda)[None]).to(torch.int32)
    scale = 1.0 / math.sqrt(128 + rd)
    assert mla_splits(b, s, h, t) == mla_splits(b, 1, h, t) > 1
    got = mla_decode_attention(ql, qr, ck, kr, pos, scale=scale)
    want = mla_decode_attention_ref(ql, qr, ck, kr, pos, scale=scale)
    assert (got - want).abs().max().item() <= TOLERANCE
    for j in range(s):
        alone = mla_decode_attention(ql[:, j:j + 1].contiguous(), qr[:, j:j + 1].contiguous(),
                                     ck, kr, pos[:, j:j + 1].contiguous(), scale=scale)
        assert torch.equal(alone[:, 0], got[:, j]), j


@pytest.mark.gpu
@pytest.mark.parametrize("d", [4096, 7168, 5120, 1536, 512, 128])
def test_rmsnorm_rows_independent_of_the_rows_beside_them(cuda, d):
    """A row's rmsnorm bits do not depend on how many rows share the call (a
    decode step's 1 and 4 rows, a verify's 5 and 20, a bucket of 512), and
    agree with the CPU formula within f32 rounding (qwen3-8b, deepseek-v3,
    llama4, its q_a and kv_a norms, a head's q/k norm)."""
    from repro_torch.core.normalization import rmsnorm

    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((4, 128, d), generator=gen, device=cuda) * 3
    w = torch.randn((d,), generator=gen, device=cuda)
    assert (rmsnorm(x, w).cpu() - rmsnorm(x.cpu(), w.cpu())).abs().max().item() <= 1e-4
    one = rmsnorm(x[:1, :1].contiguous(), w)
    four = rmsnorm(x[:, :1].contiguous(), w)
    assert torch.equal(four[:1], one)
    assert torch.equal(rmsnorm(x[:1, :VERIFY_S].contiguous(), w)[:, :1], one)
    assert torch.equal(rmsnorm(x[:, :VERIFY_S].contiguous(), w)[:, :1], four)
    assert torch.equal(rmsnorm(x.reshape(512, d), w).reshape(4, 128, d)[:, :1], four)


@pytest.mark.gpu
def test_f32_products_rows_independent_of_the_rows_beside_them(cuda):
    """The per-token f32 products a decode step (4 rows) and a verify (20
    rows) run through cuBLAS give each row the same bits: deepseek-v3's MLA
    absorption (wk_b, wv_b over 128 heads) and router (7168 x 256)."""
    from repro_torch.models.blocks import rows_einsum

    gen = torch.Generator(device=cuda).manual_seed(7)
    cases = [("bshn,rhn->bshr", (VERIFY_B, VERIFY_S, 128, 128), (512, 128, 128)),
             ("bshr,rhv->bshv", (VERIFY_B, VERIFY_S, 128, 512), (512, 128, 128)),
             ("bsd,de->bse", (VERIFY_B, VERIFY_S, 7168), (7168, 256))]
    for eq, xs, ws in cases:
        x = torch.randn(xs, generator=gen, device=cuda)
        w = torch.randn(ws, generator=gen, device=cuda) * 0.05
        block = rows_einsum(eq, x, w)
        assert (block.cpu() - torch.einsum(eq, x.cpu(), w.cpu())).abs().max().item() <= 1e-3
        for j in range(VERIFY_S):
            assert torch.equal(rows_einsum(eq, x[:, j:j + 1].contiguous(), w)[:, 0],
                               block[:, j]), (eq, j)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "llama4-maverick-400b-a17b"])
def test_moe_rows_independent_of_the_rows_beside_them(cuda, arch):
    """The routed MoE at a model's widths (16 experts, its top-k, no shared
    experts): a verify's 5 tokens a slot on 4 slots give each token the
    output its single-token decode gives, bit for bit (router, dispatch at
    capacity 8 (deepseek) or 1 vs 5 (llama4, padded to 8), expert products,
    combine)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import blocks

    base = get_config(arch)
    cfg = dataclasses.replace(
        base, dtype="float32",
        moe=dataclasses.replace(base.moe, num_experts=16, num_shared_experts=0))
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, 16
    gen = torch.Generator(device=cuda).manual_seed(e)
    p = {"router": torch.randn((d, e), generator=gen, device=cuda) * 0.02,
         "up": torch.randn((e, d, f), generator=gen, device=cuda) * 0.02,
         "gate": torch.randn((e, d, f), generator=gen, device=cuda) * 0.02,
         "down": torch.randn((e, f, d), generator=gen, device=cuda) * 0.02}
    x = torch.randn((VERIFY_B, VERIFY_S, d), generator=gen, device=cuda)
    with torch.no_grad():
        block, _ = blocks.moe_ffn(p, x, cfg, ctx, name="layer.moe", dropless=True)
        for j in range(VERIFY_S):
            alone, _ = blocks.moe_ffn(p, x[:, j:j + 1].contiguous(), cfg, ctx,
                                      name="layer.moe", dropless=True)
            assert torch.equal(alone[:, 0], block[:, j]), j


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2048, 1024, 448, 5120])
def test_layernorm_rows_independent_of_the_rows_beside_them(cuda, d):
    """A row's layernorm bits (with and without its affine parameters) do
    not depend on how many rows share the call (decode 4 x 1, verify 4 x 5,
    a bucket of 512), and agree with the CPU formula within f32 rounding."""
    from repro_torch.core.normalization import layernorm, nonparametric_ln

    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((4, 512, d), generator=gen, device=cuda) * 3
    w, b = (torch.randn((d,), generator=gen, device=cuda) for _ in range(2))
    cpu = layernorm(x.cpu(), w.cpu(), b.cpu())
    assert (layernorm(x, w, b).cpu() - cpu).abs().max().item() <= 1e-4
    for norm in (lambda t: layernorm(t, w, b), nonparametric_ln):
        one = norm(x[:, :1].contiguous())
        assert torch.equal(norm(x[:, :VERIFY_S].contiguous())[:, :1], one)
        assert torch.equal(norm(x)[:, :1], one)
        assert torch.equal(norm(x[:1, :1].contiguous()), one[:1])


@pytest.mark.gpu
def test_verify_step_logits_equal_token_by_token_decode(cuda):
    """olmo-1b at full width (2 layers, prepared FxP8): a decode step of 5
    tokens a slot on 4 slots gives every position the logits, bit for bit,
    that 5 single-token steps give: greedy speculation's identity with
    token-by-token serving on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import prepare_params
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config("olmo-1b"), dtype="float32", num_layers=2)
    model = get_model(cfg)
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    params = prepare_params(model.init(torch.Generator(device=cuda).manual_seed(0)),
                            ctx.policy, "kernel", specs=model.specs())
    gen = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (VERIFY_B, 123), generator=gen, device=cuda)
    block = torch.randint(0, cfg.vocab_size, (VERIFY_B, VERIFY_S), generator=gen, device=cuda)
    with torch.no_grad():
        cache = model.make_cache(VERIFY_B, 512, device=cuda)
        model.decode_step(params, prompt, cache, ctx)
        seq_cache = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
        seq = torch.cat([model.decode_step(params, block[:, j:j + 1], seq_cache, ctx)[0]
                         for j in range(VERIFY_S)], dim=1)
        blk, _ = model.decode_step(params, block, cache, ctx)
    assert torch.equal(seq, blk), (seq - blk).abs().max().item()


# ---------------------------------------------------------------------------
# the streaming frontend's chunk rows and the int8 mode
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("start", [64, 130, 288])
@pytest.mark.parametrize("s", [1, 4, 16, 32])
def test_gqa_chunk_rows_from_nonzero_start(cuda, start, s):
    """A chunked prefill's GQA call at olmo-1b widths: one request's row
    cache (B1, T512), S query rows from a nonzero start, within tolerance of
    the plain version (the tensor-core tile loop skips the tiles past the
    block's last query position); on split keys (S < 16) each row bit for
    bit the single-row call of its position."""
    b, h, kv, hd, t = 1, 16, 16, 128, 512
    gen = torch.Generator(device=cuda).manual_seed(start * 100 + s)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda)
    ck = torch.randn((b, t, kv, hd), generator=gen, device=cuda)
    cv = torch.randn((b, t, kv, hd), generator=gen, device=cuda)
    pos = (start + torch.arange(s, device=cuda, dtype=torch.int32))[None].contiguous()
    scale = 1.0 / math.sqrt(hd)
    got = gqa_decode_attention(q, ck, cv, pos, scale=scale)
    want = gqa_decode_attention_ref(q, ck, cv, pos, scale=scale)
    assert (got - want).abs().max().item() <= TOLERANCE
    path, _ = gqa_plan(b, s, h, t, kv)
    assert path == (TENSOR_CORES if s >= TC_MIN_S else SPLIT_KEYS)
    if path == SPLIT_KEYS:
        for j in range(s):
            alone = gqa_decode_attention(q[:, j:j + 1].contiguous(), ck, cv,
                                         pos[:, j:j + 1].contiguous(), scale=scale)
            assert torch.equal(alone[:, 0], got[:, j]), j


@pytest.mark.gpu
@pytest.mark.parametrize("start", [130, 288])
@pytest.mark.parametrize("s", [4, 16, 32])
def test_mla_chunk_rows_from_nonzero_start(cuda, start, s):
    """A chunked prefill's MLA call at deepseek-v3 widths (B1, H128, R512,
    r64, T512) from a nonzero start, within tolerance of the plain version;
    below 16 rows (the key splits of ``mla_splits``) each row bit for bit
    the single-row call of its position."""
    b, h, r, rd, t = 1, 128, 512, 64, 512
    gen = torch.Generator(device=cuda).manual_seed(start * 10 + s)
    ql = torch.randn((b, s, h, r), generator=gen, device=cuda)
    qr = torch.randn((b, s, h, rd), generator=gen, device=cuda)
    ck = torch.randn((b, t, r), generator=gen, device=cuda)
    kr = torch.randn((b, t, rd), generator=gen, device=cuda)
    pos = (start + torch.arange(s, device=cuda, dtype=torch.int32))[None].contiguous()
    scale = 1.0 / math.sqrt(128 + rd)
    got = mla_decode_attention(ql, qr, ck, kr, pos, scale=scale)
    want = mla_decode_attention_ref(ql, qr, ck, kr, pos, scale=scale)
    assert (got - want).abs().max().item() <= TOLERANCE
    if s < 16:
        for j in range(s):
            alone = mla_decode_attention(ql[:, j:j + 1].contiguous(),
                                         qr[:, j:j + 1].contiguous(), ck, kr,
                                         pos[:, j:j + 1].contiguous(), scale=scale)
            assert torch.equal(alone[:, 0], got[:, j]), j


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 32, 512])
@pytest.mark.parametrize("k,n", [(2048, 8192), (8192, 2048), (2048, 50304), (1000, 300)])
def test_int8_dot_through_mac_matmul_bitwise(cuda, m, k, n):
    """The int8 mode's dot on the card: per-token x scales, a K-major int8
    bank with per-channel scales (``Int8Backend.prepare``'s layout), one
    MAC-array launch a call, bitwise equal to the plain version on the CPU;
    a per-call (float) weight takes the same path."""
    from repro_torch.core.backends.int8 import int8_dot, k_major_bank, quantize_weight
    from repro_torch.kernels.int_dot import is_k_major

    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda) * 2
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.3
    wq, ws = quantize_weight(w)
    bank = k_major_bank(wq)
    assert is_k_major(bank) and ws.shape == (1, n)
    before = mac_matmul.launches
    got = int8_dot(x, bank, w_scale=ws)
    assert mac_matmul.launches == before + 1
    want = int8_dot(x.cpu(), wq.cpu(), w_scale=ws.cpu())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(int8_dot(x, w).cpu(), int8_dot(x.cpu(), w.cpu()))
    with pytest.raises(ValueError, match="K-major"):
        int8_dot(x, wq, w_scale=ws)  # an N-major bank is refused, not copied


@pytest.mark.gpu
def test_captured_chunk_graph_replayed_after_a_burst_graph(cuda):
    """Reduced olmo-1b through the streaming frontend on the card, captured:
    requests submitted after two ticks replay the chunk graph captured
    before the burst graph (16 rows: every chunk of a prompt of 9 rows or
    more, ``BatchedServer.chunk_span``) and capture a new one (the 5-row
    prompt's bucket of 8) after it, from the one pool; streams and f32
    margins bitwise equal to the uncaptured frontend's and to run()'s; every
    prefill one admit transfer."""
    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import BatchedServer, Request
    from repro_torch.serve.capture import pool_live_bytes
    from repro_torch.serve.frontend import ContinuousScheduler, FrontendConfig

    cfg = reduced(get_config("olmo-1b"))
    model = get_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    ctx = EngineContext(mode="kernel", policy=PrecisionPolicy.accurate(),
                        compute_dtype=torch.float32, attn_impl="decode_kernel")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (12, 26, 5)]

    def serve(capture):
        server = BatchedServer(model, ctx, params, slots=2, max_len=64, burst=4, device=cuda,
                               capture=capture)
        reqs = [Request(i, p, 8) for i, p in enumerate(prompts)]
        sched = ContinuousScheduler(server, FrontendConfig(chunk_tokens=8))
        with sched:
            sched.submit(reqs[0])
            sched.step()
            sched.step()  # a burst graph ran before any chunk of the next request
            for r in reqs[1:]:
                sched.submit(r)
            out = sched.drain()
        return server, out, [r.margins for r in reqs]

    server, out, margins = serve(True)
    names = list(server.programs.graphs)  # in capture order
    assert names.index("prefill_chunk 16") < names.index("burst greedy") < names.index(
        "prefill_chunk 8")
    # 12 rows: 8 + 4; 26 rows: 8 + 8 + 8 + 2; 5 rows: one chunk
    assert server.programs.replays["prefill_chunk 16"] == 2 + 4
    assert server.programs.replays["prefill_chunk 8"] == 1
    assert pool_live_bytes(server.programs.pool) == 0
    assert server.host_transfers == len(prompts) + server.decode_steps // server.burst
    _, eager_out, eager_margins = serve(False)
    assert out == eager_out and margins == eager_margins
    run_reqs = [Request(i, p, 8) for i, p in enumerate(prompts)]
    run = BatchedServer(model, ctx, params, slots=2, max_len=64, burst=4, device=cuda).run(
        run_reqs)
    assert out == run and margins == [r.margins for r in run_reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["gqa", "mla"])
@pytest.mark.parametrize("start", [130, 288])
def test_chunk_rows_bitwise_the_prefill_bucket_rows(cuda, kernel, start):
    """The cache attention of a chunk at the bucket ``chunk_span`` gives it
    (16 rows from ``start``: the tensor cores) gives each row the bits of
    the same row in run()'s prefill bucket (512 rows from row 0), GQA at
    olmo-1b widths and MLA at deepseek-v3 widths; so a chunked prompt's rows
    are its monolithic prefill's, whatever the chunk boundaries."""
    from repro_torch.serve.engine import _TC_ROWS

    t = 512
    gen = torch.Generator(device=cuda).manual_seed(start)
    if kernel == "gqa":
        ck, cv = (torch.randn((1, t, 16, 128), generator=gen, device=cuda) for _ in range(2))
        qs = [torch.randn((1, t, 16, 128), generator=gen, device=cuda)]

        def call(q, pos):
            return gqa_decode_attention(q, ck, cv, pos, scale=1.0 / math.sqrt(128))
    else:
        ck = torch.randn((1, t, 512), generator=gen, device=cuda)
        kr = torch.randn((1, t, 64), generator=gen, device=cuda)
        qs = [torch.randn((1, t, 128, d), generator=gen, device=cuda) for d in (512, 64)]

        def call(ql, qr, pos):
            return mla_decode_attention(ql, qr, ck, kr, pos, scale=1.0 / math.sqrt(192))
    pos = torch.arange(t, device=cuda, dtype=torch.int32)[None].contiguous()
    whole = call(*qs, pos)
    part = call(*(x[:, start:start + _TC_ROWS].contiguous() for x in (*qs, pos)))
    assert torch.equal(part, whole[:, start:start + _TC_ROWS])


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 512, 300), (512, 2048, 2048), (512, 2048, 8192)])
def test_int8_dot_gradient_on_the_card_equals_the_plain_version(cuda, m, k, n):
    """Kernel 6 under autograd (``mac_matmul_scaled_grad``, the int8 mode's
    QAT dot): the forward is bitwise its plain version; the gradients of x
    and w (through the two scales only, as the reference's) agree with the
    plain version's on the CPU to f32 reduction order; the forward launches
    the kernel once and the backward once more (float(acc) at unit scales),
    by the path ``int_dot.plan`` gives the shape."""
    from repro_torch.core.backends.int8 import int8_dot

    gen = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn((m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.4
    g = torch.randn((m, n), generator=gen, device=cuda)
    path = PATH_NAMES[plan(m, n, k, 1, 1).path]
    leaves = [t.clone().requires_grad_(True) for t in (x, w)]
    before = dict(mac_matmul.instantiations)
    out = int8_dot(*leaves)
    assert mac_matmul.instantiations[path] == before[path] + 1
    (out * g).sum().backward()
    assert mac_matmul.instantiations[path] == before[path] + 2
    assert sum(mac_matmul.instantiations.values()) == sum(before.values()) + 2
    cpu = [t.cpu().requires_grad_(True) for t in (x, w)]
    want = int8_dot(*cpu)
    assert torch.equal(out.detach().cpu(), want.detach())
    (want * g.cpu()).sum().backward()
    for got, ref in zip(leaves, cpu):
        scale = ref.grad.abs().max()
        assert torch.equal(got.grad.cpu() != 0, ref.grad != 0)
        assert (got.grad.cpu() - ref.grad).abs().max() <= 1e-5 * scale


@pytest.mark.gpu
def test_mac_matmul_scaled_grad_scales_and_unit_scale_launch(cuda):
    """The scales' gradients of ``mac_matmul_scaled_grad`` on the card are
    the VJP of ``(acc * x_scale) * w_scale`` with ``acc`` the exact integer
    product (computed here in int64 on the CPU, not by the port); the
    backward launches the kernel once more (at unit scales)."""
    from repro_torch.kernels.cordic_mac import mac_matmul_scaled_grad

    gen = torch.Generator(device=cuda).manual_seed(11)
    x_q = to_k_major(torch.randint(-127, 128, (64, 256), generator=gen, device=cuda,
                                   dtype=torch.int8).T).T
    w_q = to_k_major(torch.randint(-127, 128, (256, 96), generator=gen, device=cuda,
                                   dtype=torch.int8))
    xs = (torch.rand((64, 1), generator=gen, device=cuda) + 0.5).requires_grad_(True)
    ws = (torch.rand((1, 96), generator=gen, device=cuda) + 0.5).requires_grad_(True)
    g = torch.randn((64, 96), generator=gen, device=cuda)
    before = sum(mac_matmul.instantiations.values())
    out = mac_matmul_scaled_grad(x_q, w_q, xs, ws)
    (out * g).sum().backward()
    assert sum(mac_matmul.instantiations.values()) == before + 2
    acc = (x_q.cpu().to(torch.int64) @ w_q.cpu().to(torch.int64)).to(torch.float64)
    gd, xd, wd = (t.detach().cpu().to(torch.float64) for t in (g, xs, ws))
    want_xs = (gd * acc * wd).sum(dim=1, keepdim=True)
    want_ws = (gd * acc * xd).sum(dim=0, keepdim=True)
    for got, want in ((xs.grad, want_xs), (ws.grad, want_ws)):
        assert (got.cpu().to(torch.float64) - want).abs().max() <= 1e-5 * want.abs().max()
