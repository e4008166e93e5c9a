"""PyTorch port: the arithmetic of the Hopper MLA attention loop, emulated on the CPU.

The MLA cache attention and the cache-free MLA flash attention run the
tensor-core tile loop of ``kernels/include/mla_attention.cuh``: the MMA rows
are the heads of one query; four warps split Q K^T's R + r dims (rounded up
to 32) into quarters, each contracting its quarter 8 dims at a time in the
order (0, 2, 4, 6, 1, 3, 5, 7) with every operand split into two TF32 values
(3xTF32: the cross terms hi.lo, lo.hi in one accumulator, hi.hi in another,
added at the end); the four partial score tiles are added in warp order;
the online softmax runs in base 2 over 32-key tiles, P . c_kv 8 keys at a
time in the same key order, small terms first, into an accumulator of its
own that joins the output once a tile. The cache attention splits
a query's key tiles over several blocks when blocks are few and merges their
(max, sum, unnormalised output). Those kernels run only on the card; here
the same steps run in plain torch, reusing the TF32 rounding of
``test_torch_attention_tc.py``, at deepseek-v3's widths (H 128, R 512, r 64)
on small S and T, at H = 7, at the reduced config (H 4, R 16, r 8) and at
widths that are not multiples of 8 (R 12, r 4 or 8). They must stay within
the kernels' TOLERANCE of the plain versions and of the JAX reference's
Pallas kernels in interpret mode. The kernels themselves are held against
the plain versions on the card in ``test_torch_kernels_gpu.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import mla_decode_attention as jax_mla_decode  # noqa: E402
from repro.kernels.mla_flash.ops import mla_flash_attention as jax_mla_flash  # noqa: E402
from repro_torch.kernels.decode_attention import TOLERANCE, mla_decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import mla_splits  # noqa: E402
from repro_torch.kernels.mla_flash import TOLERANCE as FLASH_TOLERANCE  # noqa: E402
from repro_torch.kernels.mla_flash import mla_flash_attention_ref  # noqa: E402
from test_torch_attention_tc import LOG2E, NEG_INF, PERM, split  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

TILE = 32  # keys per tile
WARPS = 4  # warps of a row group: each a quarter of the dims and of the columns
LN2 = 0.6931471805599453


def width(r, rd):
    """A tile row's floats: R + r rounded up to the four warps' 8-dim steps."""
    return -(-(r + rd) // 32) * 32


def tile_range(qpos, t, splits, part):
    """The key tiles [first, last) of split ``part`` of a query at qpos."""
    t_end = t if qpos < 0 else min(t, qpos + 1)
    n_tiles = -(-t_end // TILE)
    per = -(-n_tiles // splits)
    return part * per, min(n_tiles, part * per + per)


def mla_loop(q, k, r, qpos, scale, tiles):
    """The loop for one query's heads: q (H, W) = [q_lat | q_rope | 0], k (T, W)
    = [c_kv | k_rope | 0], keys t <= qpos visible, over the key tiles
    ``tiles``. Returns the unnormalised output (H, R), the running max in
    base-2 units and the sum, each (H, 1)."""
    h, w = q.shape
    t = k.shape[0]
    kq = w // 32  # k-steps per warp
    qw = q.reshape(h, WARPS, kq, 8)[..., PERM].permute(1, 2, 0, 3)  # (warp, step, H, 8)
    qhi, qlo = split(qw)
    m = torch.full((h, 1), -math.inf)
    l = torch.zeros((h, 1))
    o = torch.zeros((h, r))
    scale2 = np.float32(scale) * np.float32(LOG2E)
    for tile in range(*tiles):
        k0 = tile * TILE
        kt = k[k0:k0 + TILE]
        kt = torch.cat([kt, torch.zeros((TILE - kt.shape[0], w))])  # zero past T
        kw = kt.reshape(TILE, WARPS, kq, 8)[..., PERM].permute(1, 2, 3, 0)  # (warp, step, 8, keys)
        khi, klo = split(kw)
        sc, sx = torch.zeros((WARPS, h, TILE)), torch.zeros((WARPS, h, TILE))
        for kk in range(kq):  # every warp's k-step kk at once
            sx = sx + qhi[:, kk] @ klo[:, kk]
            sc = sc + qhi[:, kk] @ khi[:, kk]
            sx = sx + qlo[:, kk] @ khi[:, kk]
        part = sc + sx
        s = ((part[0] + part[1]) + part[2]) + part[3]
        s = s * scale2
        keys = torch.arange(k0, k0 + TILE)
        s = torch.where(keys[None] > qpos, torch.tensor(NEG_INF), s)
        s = torch.where(keys[None] >= t, torch.tensor(-math.inf), s)
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        m = m_new
        acc = torch.zeros((h, r))  # the tile's P . c_kv, apart from O
        for j in range(TILE // 8):
            keys8 = PERM + 8 * j
            phi, plo = split(p[:, keys8])
            vhi, vlo = split(kt[keys8, :r])
            acc = acc + phi @ vlo
            acc = acc + plo @ vhi
            acc = acc + phi @ vhi
        o = o * alpha + acc
    return o, m, l


def mla_query(q_lat, q_rope, c_kv, k_rope, qpos, scale, splits=1):
    """One (batch row, query)'s heads, as the kernel computes them: the
    splits' partial softmaxes merged as sum e^(m_i - M) acc_i times
    1 / sum e^(m_i - M) l_i (natural-log units, split order)."""
    r, rd = q_lat.shape[-1], q_rope.shape[-1]
    w = width(r, rd)
    pad_q = torch.zeros((q_lat.shape[0], w - r - rd))
    pad_k = torch.zeros((c_kv.shape[0], w - r - rd))
    q = torch.cat([q_lat, q_rope, pad_q], -1)
    k = torch.cat([c_kv, k_rope, pad_k], -1)
    t = c_kv.shape[0]
    if splits == 1:
        o, _, l = mla_loop(q, k, r, qpos, scale, tile_range(qpos, t, 1, 0))
        return o * (1.0 / l)
    parts = [mla_loop(q, k, r, qpos, scale, tile_range(qpos, t, splits, i))
             for i in range(splits)]
    m_nat = [m * np.float32(LN2) for _, m, _ in parts]
    big = torch.stack(m_nat).max(dim=0).values
    num, den = torch.zeros_like(parts[0][0]), torch.zeros_like(big)
    for (o, _, l), m in zip(parts, m_nat):
        e = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - big))
        num, den = num + e * o, den + e * l
    return num * (1.0 / den)


def emulate_cache(q_lat, q_rope, c_kv, k_rope, pos, scale):
    b, s, h, _ = q_lat.shape
    splits = mla_splits(b, s, h, c_kv.shape[1])
    out = torch.empty_like(q_lat)
    for bi in range(b):
        for si in range(s):
            out[bi, si] = mla_query(q_lat[bi, si], q_rope[bi, si], c_kv[bi], k_rope[bi],
                                    int(pos[bi, si]), scale, splits)
    return out, splits


def emulate_flash(q_lat, q_rope, c_kv, k_rope, scale, causal):
    b, s, _, _ = q_lat.shape
    t = c_kv.shape[1]
    out = torch.empty_like(q_lat)
    for bi in range(b):
        for si in range(s):
            out[bi, si] = mla_query(q_lat[bi, si], q_rope[bi, si], c_kv[bi], k_rope[bi],
                                    si if causal else t - 1, scale)
    return out


def _inputs(b, s, h, r, rd, t, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, r), (b, s, h, rd), (b, t, r), (b, t, rd))]


CACHE_CASES = [  # b, s, h, r, rd, t: deepseek-v3 widths, H = 7, reduced, R or R + r off 8
    (2, 3, 128, 512, 64, 40),
    (2, 4, 7, 512, 64, 70),
    (3, 2, 4, 16, 8, 33),
    (2, 3, 4, 12, 4, 45),
    (2, 2, 7, 12, 8, 37),
]


@pytest.mark.parametrize("b,s,h,r,rd,t", CACHE_CASES,
                         ids=["deepseek", "h7", "reduced", "r12_rope4", "r12_rope8"])
def test_cache_loop_matches_plain_version_and_reference(b, s, h, r, rd, t):
    """A run of positions from a random row, a drained slot (pos >= T) and a
    masked row (pos < 0); the keys split over blocks (few blocks here)."""
    ql, qr, ck, kr = _inputs(b, s, h, r, rd, t, seed=b * s * t + h)
    rng = np.random.default_rng(t)
    pos = (rng.integers(0, t - s + 1, (b, 1)) + np.arange(s)[None]).astype(np.int32)
    pos[0, -1] = t + 7
    pos[-1, 0] = -1
    scale = 1.0 / math.sqrt(r + rd)
    args = [torch.from_numpy(a) for a in (ql, qr, ck, kr, pos)]
    got, splits = emulate_cache(*args, scale)
    assert splits > 1
    plain = mla_decode_attention_ref(*args, scale=scale)
    assert (got - plain).abs().max().item() <= TOLERANCE
    want = np.asarray(jax_mla_decode(*(jnp.asarray(a) for a in (ql, qr, ck, kr, pos)),
                                     scale=scale, interpret=True))
    assert np.abs(got.numpy() - want).max() <= TOLERANCE
    # the masked row: every key weighs 1 / T
    assert (got[-1, 0] - args[2][-1].mean(0)).abs().max().item() <= TOLERANCE


@pytest.mark.parametrize("b,s,t", [(4, 1, 512), (1, 16, 512)], ids=["decode", "prefill16"])
def test_cache_loop_at_serving_shapes(b, s, t):
    """Deepseek-v3 widths at a decode step over the serving cache (each slot
    at its last row; the keys split over 8 blocks) and at the prefill bucket
    16 from row 0 (one tile, three key splits of which two have no tile)."""
    h, r, rd = 128, 512, 64
    ql, qr, ck, kr = _inputs(b, s, h, r, rd, t, seed=s)
    pos = (np.full((b, 1), t - 1) if s == 1 else np.arange(s)[None]).astype(np.int32)
    scale = 1.0 / math.sqrt(128 + rd)
    args = [torch.from_numpy(a) for a in (ql, qr, ck, kr, pos)]
    got, splits = emulate_cache(*args, scale)
    assert splits == (8 if s == 1 else 3)
    plain = mla_decode_attention_ref(*args, scale=scale)
    assert (got - plain).abs().max().item() <= TOLERANCE


FLASH_CASES = [  # b, s, h, r, rd, causal
    (1, 40, 128, 512, 64, True),
    (2, 37, 7, 512, 64, True),
    (2, 70, 4, 16, 8, True),
    (1, 45, 4, 12, 4, False),
    (2, 33, 7, 12, 8, True),
]


@pytest.mark.parametrize("b,s,h,r,rd,causal", FLASH_CASES,
                         ids=["deepseek", "h7", "reduced", "r12_rope4_full", "r12_rope8"])
def test_flash_loop_matches_plain_version_and_reference(b, s, h, r, rd, causal):
    """The cache-free form: the query index as the position (causal) or every
    key visible, ragged S."""
    ql, qr, ck, kr = _inputs(b, s, h, r, rd, s, seed=s + h)
    scale = 1.0 / math.sqrt(128 + 64) if r == 512 else 1.0 / math.sqrt(r + rd)
    args = [torch.from_numpy(a) for a in (ql, qr, ck, kr)]
    got = emulate_flash(*args, scale, causal)
    plain = mla_flash_attention_ref(*args, scale=scale, causal=causal)
    assert (got - plain).abs().max().item() <= FLASH_TOLERANCE
    want = np.asarray(jax_mla_flash(*(jnp.asarray(a) for a in (ql, qr, ck, kr)), scale=scale,
                                    causal=causal, interpret=True, bq=s, bk=s, bh=h))
    assert np.abs(got.numpy() - want).max() <= FLASH_TOLERANCE


def _swizzle(t):
    """The XOR the kernel applies to the column of tile row t (swz)."""
    return ((t & 3) ^ ((t >> 2) & 1)) << 3


def _conflicts(addresses, width_bytes):
    """Extra shared-memory wavefronts of one warp-wide load: lanes are served
    in phases of 128 bytes (8 lanes of 16 bytes, 16 of 8, 32 of 4); within a
    phase, distinct 4-byte words on one bank conflict."""
    per_phase = 128 // width_bytes
    extra = 0
    for p0 in range(0, 32, per_phase):
        banks = {}
        for a in addresses[p0:p0 + per_phase]:
            for word in range(a, a + width_bytes // 4):
                banks.setdefault(word % 32, set()).add(word)
        extra += max((len(w) for w in banks.values()), default=1) - 1
    return extra


@pytest.mark.parametrize("w", [32, 64, 576])
def test_tile_swizzle_keeps_fragment_loads_free_of_bank_conflicts(w):
    """The tile rows are not padded (one stride cannot serve both loads);
    their 8-float groups are XOR-swizzled. Every fragment load of the loop
    is then conflict-free: the 8-byte K loads (key 8n + g, dims 8kk + 2c),
    the 8-byte c_kv loads (keys 8j + 2c and + 1, columns 16m + 2g), and the
    16-byte cp.async writes of a row."""
    def at(row, col):
        return row * w + (col ^ _swizzle(row))

    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for kk in range(w // 8):
        for n in range(TILE // 8):
            assert _conflicts([at(8 * n + g, 8 * kk + 2 * c) for g, c in lanes], 8) == 0
    for j in range(TILE // 8):
        for m in range(w // 16):
            for k in range(2):
                assert _conflicts([at(8 * j + 2 * c + k, 16 * m + 2 * g) for g, c in lanes],
                                  8) == 0
    for row in range(TILE):
        for d0 in range(0, w, 128):
            cols = [d0 + 4 * lane for lane in range(32) if d0 + 4 * lane < w]
            assert _conflicts([at(row, d) for d in cols], 16) == 0
    # a padded stride of w + 8 (what a K-only layout would take) conflicts on c_kv
    padded = [(8 * 0 + 2 * c) * (w + 8) + 2 * g for g, c in lanes]
    assert _conflicts(padded, 8) > 0
