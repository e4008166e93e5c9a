"""PyTorch port: the arithmetic of the Hopper attention kernels, emulated on the CPU.

The GQA cache attention at S >= 16 and the flash attention run the tensor-core
tile loop of ``kernels/include/gqa_tile.cuh``: every f32 operand is split into
two TF32 values (hi = round(a) to a 10-bit mantissa, ties away from zero;
lo = the same rounding of a - hi), each product is hi.lo + lo.hi + hi.hi, QK^T
contracts each 8-dim group in the order (0, 2, 4, 6, 1, 3, 5, 7) and P.V each
8-key group in that order, with an online softmax over 32-key tiles in base 2.
Below 16 query rows the GQA attention splits the key tiles over several blocks
and merges their (max, sum, unnormalised output). Those kernels run only on
the card; here the same steps run in plain torch at olmo-1b's widths (16
heads, head dim 128) and at zamba2's head dim 112, whose geometry the
emulation follows (the 8-dim groups each P.V pass takes, the output dims each
lane of the split path owns), on small S and T, and must stay within the kernels'
TOLERANCE of the plain versions and of the JAX reference's own oracles, as
``test_torch_decode_attention.py`` and ``test_torch_flash_attention.py`` call
them. The kernels themselves are held against the plain versions on the card
in ``test_torch_kernels_gpu.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import gqa_decode_attention as jax_gqa  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import TOLERANCE, gqa_decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    SPLIT_KEYS,
    TC_MIN_S,
    TENSOR_CORES,
    gqa_plan,
    gqa_splits,
)
from repro_torch.kernels.flash_attention import TOLERANCE as FLASH_TOLERANCE  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402, F401

LOG2E = 1.4426950408889634
NEG_INF = -1e30
TILE = 32  # keys per tile of the tile loop and of the split-key path
# the MMA's k index c <-> element 2c, c + 4 <-> 2c + 1 of each group of 8
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def tf32(x):
    """Round f32 to TF32 (10-bit mantissa), to nearest, ties away from zero:
    half a TF32 ulp added to the magnitude bits, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma3(a, b, acc_hi, acc_x):
    """The 3xTF32 product a @ b (f32 operands, 8-long contraction) added to
    two accumulators as the kernel does: the cross terms apart, then hi.hi."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    acc_x = acc_x + ahi @ blo
    acc_hi = acc_hi + ahi @ bhi
    acc_x = acc_x + alo @ bhi
    return acc_hi, acc_x


def tile_loop(q, k, v, lims, scale):
    """One head of the tensor-core tile loop: q (R, D), k and v (T, D), lims
    (R,) the last visible key of each row (< 0: every key masked)."""
    r, d = q.shape
    t = k.shape[0]
    qp = q.reshape(r, d // 8, 8)[:, :, PERM]
    m = torch.full((r, 1), -math.inf)
    l = torch.zeros((r, 1))
    o = torch.zeros((r, d))
    scale2 = np.float32(scale) * np.float32(LOG2E)
    for k0 in range(0, t, TILE):
        kt, vt = k[k0:k0 + TILE], v[k0:k0 + TILE]
        n = kt.shape[0]
        pad = TILE - n
        kt = torch.cat([kt, torch.zeros((pad, d))]) if pad else kt
        vt = torch.cat([vt, torch.zeros((pad, d))]) if pad else vt
        kp = kt.reshape(TILE, d // 8, 8)[:, :, PERM]
        s, sx = torch.zeros((r, TILE)), torch.zeros((r, TILE))
        for kk in range(d // 8):
            s, sx = mma3(qp[:, kk], kp[:, kk].T, s, sx)
        s = (s + sx) * scale2
        keys = torch.arange(k0, k0 + TILE)
        s = torch.where(keys[None] > lims[:, None], torch.tensor(NEG_INF), s)
        s = torch.where(keys[None] >= t, torch.tensor(-math.inf), s)
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        o = o * alpha
        m = m_new
        cols = pv_columns(d)
        for j in range(TILE // 8):
            keys8 = PERM + 8 * j
            phi, plo = split(p[:, keys8])
            vhi, vlo = split(vt[keys8][:, cols])
            o[:, cols] = o[:, cols] + phi @ vlo
            o[:, cols] = o[:, cols] + plo @ vhi
            o[:, cols] = o[:, cols] + phi @ vhi
    return o * (1.0 / torch.where(l == 0, torch.ones_like(l), l))


def pv_group(nd):
    """``gqa_tile.cuh``'s ``pv_group``: the V fragments a P.V pass takes, the
    largest divisor of the head dim's 8-dim groups up to 8."""
    return next(g for g in range(8, 0, -1) if nd % g == 0)


def pv_columns(d):
    """The output columns the tile loop's P.V passes accumulate, in pass
    order: pass n0 (a step of ``pv_group``) takes 8-dim groups n0 .. n0 + NG - 1.
    A group past the head dim raises (an index past the accumulators); a
    group the passes miss stays 0."""
    nd = d // 8
    ng = pv_group(nd)
    groups = [n0 + u for n0 in range(0, nd, ng) for u in range(ng)]
    return torch.tensor([8 * g + e for g in groups for e in range(8)])


def split_lane_dims(hd):
    """The output dims the split-key kernel's lanes own: lane l holds dims
    l + 32 d for d < DPL = ceil(hd / 32), guarded below hd."""
    dpl = -(-hd // 32)
    return torch.tensor(sorted(lane + 32 * d for d in range(dpl) for lane in range(32)
                               if lane + 32 * d < hd))


def split_keys(q, k, v, lims, scale, splits, end=None):
    """One head of the split-key path: split i takes key tiles i, i +
    splits, ... up to the rows' last visible key, an online softmax in f32
    on the CUDA cores, merged as sum e^(m_i - M) acc_i times 1 / sum e^(m_i - M) l_i."""
    t = k.shape[0]
    if end is None:  # the block's rows are these rows
        end = t if (lims < 0).any() or lims.max() >= t else int(lims.max()) + 1
    n_tiles = -(-end // TILE)
    parts = []
    for sp in range(splits):
        m = torch.full((q.shape[0], 1), -math.inf)
        l = torch.zeros((q.shape[0], 1))
        acc = torch.zeros_like(q)
        for tile in range(sp, n_tiles, splits):
            keys = torch.arange(tile * TILE, min(t, tile * TILE + TILE))
            s = (q @ k[keys].T) * np.float32(scale)
            s = torch.where(keys[None] > lims[:, None], torch.tensor(NEG_INF), s)
            m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            acc = acc * alpha + p @ v[keys]
            m = m_new
        parts.append((m, l, acc))
    big = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    num, den = torch.zeros_like(q), torch.zeros_like(big)
    for m, l, acc in parts:
        e = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - big))
        num, den = num + e * acc, den + e * l
    # each lane writes the dims it owns; a dim no lane owns stays NaN
    out = torch.full_like(q, math.nan)
    dims = split_lane_dims(q.shape[1])
    out[:, dims] = (num * (1.0 / den))[:, dims]
    return out


def emulate_gqa(path, q, ck, cv, pos, scale, splits=1):
    b, s, h, hd = q.shape
    g = h // ck.shape[2]
    out = torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            args = (q[bi, :, hi], ck[bi, :, hi // g], cv[bi, :, hi // g], pos[bi], scale)
            if path == TENSOR_CORES:
                out[bi, :, hi] = tile_loop(*args)
            else:
                out[bi, :, hi] = split_keys(*args, splits)
    return out


def _xla_chain(q, ck, cv, pos, scale):
    """The reference's models/blocks.attention cache branch."""
    g = q.shape[2] // ck.shape[2]
    valid = jnp.arange(ck.shape[1])[None, None, :] <= pos[:, :, None]
    ckr = jnp.repeat(ck, g, axis=2) if g > 1 else ck
    cvr = jnp.repeat(cv, g, axis=2) if g > 1 else cv
    scores = jnp.einsum("bqhd,bshd->bhqs", q, ckr)
    scores = jnp.where(valid[:, None], scores * scale, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhqs,bshd->bqhd", probs.astype(cvr.dtype), cvr)


def _gqa_case(b, s, h, kv, hd, t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    ck = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    cv = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    return q, ck, cv


def _check_against_plain_and_reference(got, q, ck, cv, pos, scale):
    args = [torch.from_numpy(a) for a in (q, ck, cv, pos)]
    plain = gqa_decode_attention_ref(*args, scale=scale)
    assert (got - plain).abs().max().item() <= TOLERANCE
    jargs = [jnp.asarray(a) for a in (q, ck, cv, pos)]
    for want in (_xla_chain(*jargs, scale), jax_gqa(*jargs, scale=scale, interpret=True)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= TOLERANCE


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # a TF32 ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(a)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    # a - hi is exact in f32, and hi + lo keeps about 22 bits of a
    assert ((a - (hi + lo)).abs() <= a.abs() * 2.0**-21).all()


@pytest.mark.parametrize("s,t,start", [(16, 70, 0), (20, 53, 10), (33, 64, 0)])
def test_tensor_core_loop_matches_plain_version_and_reference(s, t, start):
    """The S >= 16 path (prefill buckets) at olmo-1b widths: a run of
    positions from `start`, T ragged or whole tiles, one row with pos < 0."""
    b, h, kv, hd = 1, 16, 16, 128
    q, ck, cv = _gqa_case(b, s, h, kv, hd, t, seed=s + t)
    pos = (start + np.arange(s, dtype=np.int32))[None]
    pos[0, 1] = -1
    scale = 1.0 / math.sqrt(hd)
    path, splits = gqa_plan(b, s, h, t, kv)
    assert (path, splits) == (TENSOR_CORES, 1)
    got = emulate_gqa(path, *(torch.from_numpy(a) for a in (q, ck, cv, pos)), scale)
    _check_against_plain_and_reference(got, q, ck, cv, pos, scale)


@pytest.mark.parametrize("s,kv,pos_max", [(1, 16, 511), (4, 16, 300), (8, 8, 40), (15, 4, 200)])
def test_split_key_merge_matches_plain_version_and_reference(s, kv, pos_max):
    """The S < 16 path (decode, bursts, buckets 4 and 8) at olmo-1b widths on
    the serving cache length: every split's partial softmax merged, splits
    past the rows' last key empty, one row with pos < 0 in a second slot."""
    b, h, hd, t = 2, 16, 128, 512
    q, ck, cv = _gqa_case(b, s, h, kv, hd, t, seed=s * kv)
    pos = np.stack([pos_max - s + 1 + np.arange(s), np.arange(s) - 1]).astype(np.int32)
    scale = 1.0 / math.sqrt(hd)
    path, splits = gqa_plan(b, s, h, t, kv)
    assert path == SPLIT_KEYS and splits > 1
    got = emulate_gqa(path, *(torch.from_numpy(a) for a in (q, ck, cv, pos)), scale,
                      splits=splits)
    _check_against_plain_and_reference(got, q, ck, cv, pos, scale)


def _flash_oracle(q, k, v, causal):
    """The reference's ``attention_ref`` behind its wrapper's GQA repeat."""
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    kb, vb = np.repeat(k, g, 2), np.repeat(v, g, 2)
    out = attention_ref(*(jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, -1, d))
                          for a in (q, kb, vb)), causal=causal)
    return np.asarray(out).reshape(b, h, sq, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("s,causal", [(40, True), (70, False)])
def test_flash_tile_loop_matches_plain_version_and_reference(s, causal):
    """The flash kernel's loop (the index as the mask) at olmo-1b widths."""
    h, d = 16, 128
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((1, s, h, d)).astype(np.float32) for _ in range(3))
    lims = torch.arange(s, dtype=torch.int32) if causal else torch.full((s,), 2**31 - 1)
    got = torch.empty((1, s, h, d))
    for hi in range(h):
        got[0, :, hi] = tile_loop(*(torch.from_numpy(a[0, :, hi]) for a in (q, k, v)), lims,
                                  1.0 / math.sqrt(d))
    plain = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert (got - plain).abs().max().item() <= FLASH_TOLERANCE
    assert np.abs(got.numpy() - _flash_oracle(q, k, v, causal)).max() <= FLASH_TOLERANCE


def test_kernel_geometry_covers_head_dim_112():
    """zamba2's head dim: 14 8-dim groups, which P.V passes of 8 would
    overrun (groups 14 and 15), and 3.5 lane groups of 32, which 3 dims a
    lane would leave 16 dims short; the kernels' rules cover every head dim
    they take exactly once."""
    from repro_torch.kernels.decode_attention.ops import HEAD_DIMS as GQA_HEAD_DIMS
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS as FLASH_HEAD_DIMS

    assert 112 in GQA_HEAD_DIMS and 112 in FLASH_HEAD_DIMS
    assert pv_group(14) == 7 and pv_group(16) == 8 and pv_group(2) == 2
    for d in sorted(set(GQA_HEAD_DIMS) | set(FLASH_HEAD_DIMS)):
        assert sorted(pv_columns(d).tolist()) == list(range(d))
    for hd in GQA_HEAD_DIMS:
        assert split_lane_dims(hd).tolist() == list(range(hd))


@pytest.mark.parametrize("s,t,start", [(16, 70, 0), (20, 53, 10)])
def test_tensor_core_loop_head_dim_112(s, t, start):
    """The S >= 16 path at zamba2's head dim (4 heads here; the loop runs per
    head): the P.V passes in groups of 7 of its 14 8-dim groups."""
    b, h, kv, hd = 1, 4, 4, 112
    q, ck, cv = _gqa_case(b, s, h, kv, hd, t, seed=s + t + hd)
    pos = (start + np.arange(s, dtype=np.int32))[None]
    pos[0, 1] = -1
    scale = 1.0 / math.sqrt(hd)
    assert gqa_plan(b, s, h, t, kv) == (TENSOR_CORES, 1)
    got = emulate_gqa(TENSOR_CORES, *(torch.from_numpy(a) for a in (q, ck, cv, pos)), scale)
    _check_against_plain_and_reference(got, q, ck, cv, pos, scale)


@pytest.mark.parametrize("s,pos_max", [(1, 511), (4, 300)])
def test_split_key_merge_head_dim_112(s, pos_max):
    """The S < 16 path at zamba2's head dim (decode and a burst of 4 on the
    serving cache length): 4 dims a lane, the last group of 32 half full."""
    b, h, kv, hd, t = 2, 4, 4, 112, 512
    q, ck, cv = _gqa_case(b, s, h, kv, hd, t, seed=s + hd)
    pos = np.stack([pos_max - s + 1 + np.arange(s), np.arange(s) - 1]).astype(np.int32)
    scale = 1.0 / math.sqrt(hd)
    path, splits = gqa_plan(b, s, h, t, kv)
    assert path == SPLIT_KEYS and splits > 1
    got = emulate_gqa(path, *(torch.from_numpy(a) for a in (q, ck, cv, pos)), scale,
                      splits=splits)
    assert not torch.isnan(got).any()
    _check_against_plain_and_reference(got, q, ck, cv, pos, scale)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_tile_loop_head_dim_112(causal):
    """The flash kernel's loop at zamba2's head dim, causal (its forward) and
    not (the same loop as seamless's encoder runs it)."""
    s, h, d = 45, 2, 112
    rng = np.random.default_rng(d + causal)
    q, k, v = (rng.standard_normal((1, s, h, d)).astype(np.float32) for _ in range(3))
    lims = torch.arange(s, dtype=torch.int32) if causal else torch.full((s,), 2**31 - 1)
    got = torch.empty((1, s, h, d))
    for hi in range(h):
        got[0, :, hi] = tile_loop(*(torch.from_numpy(a[0, :, hi]) for a in (q, k, v)), lims,
                                  1.0 / math.sqrt(d))
    plain = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert (got - plain).abs().max().item() <= FLASH_TOLERANCE
    assert np.abs(got.numpy() - _flash_oracle(q, k, v, causal)).max() <= FLASH_TOLERANCE


@pytest.mark.parametrize("start", [125, 253, 30])
def test_split_keys_give_a_row_the_bits_of_its_single_row_decode(start):
    """A speculative verify runs S = 5 query rows of a slot through the split
    path in one block, whose visible range ends at the last row's key; each
    row must get the bits the single-row decode of its position gets (greedy
    speculation is bit-identical to decoding token by token). Each row is
    emulated alone, once with its own visible range and once with the
    block's: dealing the tiles out to the splits in turn makes them equal.
    The verify windows cross 128 and 256 keys, where cutting the block's
    visible tiles into runs would regroup a row's keys."""
    b, h, kv, hd, t, s = 4, 16, 16, 128, 512, 5
    q, ck, cv = (torch.from_numpy(a[0, :, 0]) for a in _gqa_case(1, s, 1, 1, hd, t, seed=start))
    lims = torch.from_numpy(start + np.arange(s, dtype=np.int32))
    path, splits = gqa_plan(b, s, h, t, kv)
    assert path == SPLIT_KEYS and splits > 1 and gqa_plan(b, 1, h, t, kv) == (path, splits)
    scale = 1.0 / math.sqrt(hd)
    for j in range(s):
        row = (q[j:j + 1], ck, cv, lims[j:j + 1], scale, splits)
        assert torch.equal(split_keys(*row), split_keys(*row, end=start + s))


def test_gqa_plan_and_splits():
    assert TC_MIN_S == 16
    assert gqa_plan(1, 16, 16, 512, 16) == (TENSOR_CORES, 1)
    assert gqa_plan(1, 512, 16, 512, 16) == (TENSOR_CORES, 1)
    assert gqa_plan(4, 1, 16, 512, 16) == (SPLIT_KEYS, 4)  # 64 (slot, head) blocks, 16 tiles
    assert gqa_plan(4, 1, 16, 512, 8) == (SPLIT_KEYS, 8)  # groups of 2 heads share a block
    assert gqa_splits(1, 4, 16, 512, 16) == 16  # bucket 4: one tile a block
    assert gqa_splits(1, 15, 16, 40, 16) == 2  # never more splits than key tiles
    assert gqa_splits(64, 1, 16, 512, 16) == 1  # blocks enough to fill the card
    for b, s, h, kv, t in [(4, 1, 16, 16, 512), (3, 5, 8, 4, 100), (2, 1, 4, 2, 33),
                           (1, 8, 16, 16, 512), (2, 15, 32, 8, 1000), (1, 1, 1, 1, 1)]:
        splits = gqa_splits(b, s, h, t, kv)
        n_tiles = -(-t // TILE)
        assert 1 <= splits <= n_tiles  # every split gets a tile when all keys count
        assert splits == gqa_splits(b, 1, h, t, kv)  # whatever the query rows
