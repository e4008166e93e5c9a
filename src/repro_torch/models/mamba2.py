"""Mamba2 / SSD mixer (port of ``repro.models.mamba2``; arXiv:2405.21060).

The chunked SSD forward (train, prefill, the cache-free ``forward``): a
quadratic term within each chunk and a linear recurrence across chunks, the
reference's ``lax.scan`` over chunks as a loop. The single-step recurrent
form for decode. The recurrence has no Pallas kernel in the reference: it is
elementwise state decay, not a MAC-array workload, so it stays plain torch
here; ``in_proj`` and ``out_proj`` go through ``EngineContext.linear`` (the
fused dot kernel in kernel mode).

The einsum subscripts and the order of cumsum, exp and sums are the
reference's, so the two differ by reduction-order ulps. ``silu`` is the
float op ``x * sigmoid(x)`` and ``softplus`` JAX's ``logaddexp(x, 0)``
(``torch.nn.functional.softplus`` returns ``x`` itself above 20). The decode
step updates the ``conv`` and ``ssm`` state in place.

Under tensor parallelism (``ctx.mesh``) a rank runs the SSM on its heads.
The reference's placement cuts ``in_proj``'s concatenated ``(z, x, B, C,
dt)`` columns into contiguous blocks that do not line up with a rank's
heads, so the rank all-gathers ``in_proj``'s column-parallel output over the
model axis (each column exact), runs the depthwise conv on every channel
with the whole ``conv_w``/``conv_b`` (the port keeps them whole on every
rank: ``sharding.partition.serving_specs``), and takes its heads' ``x`` and
``dt`` and the whole ``B`` and ``C``; ``A_log``, ``D``, ``dt_bias`` and the
SSM state hold its heads. The gated RMSNorm runs over the whole ``d_inner``
(one block a row, the ``norm`` weight whole on every rank): ``y`` is
all-gathered over the model axis first, and the rank's K shard of the
normed row goes into ``out_proj``, a row-parallel product. The conv window
cache is whole on every rank. On CUDA a rank's recurrent readout pads its
heads to the whole count with zeros (:func:`_readout`), so a head's bits do
not depend on how many heads a rank holds. Under autograd the activations
that enter a rank's share (``x`` its ``in_proj`` columns, the conv output
and ``dt`` its heads, the normed ``y`` its ``out_proj`` rows) pass
``collectives.enter_model``, and the gathers' backward slices the rank's
part.
"""
from __future__ import annotations

import torch

from repro_torch._device import on_card
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineContext
from repro_torch.core.normalization import rmsnorm
from repro_torch.sharding.collectives import all_gather, enter_model

from .params import ParamSpec


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = s.num_heads or d_inner // s.head_dim
    return d_inner, n_heads


def _proj_width(cfg: ModelConfig) -> int:
    """``in_proj``'s output width: z, x, B, C, dt."""
    d_inner, n_heads = _dims(cfg)
    return 2 * d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.state_dim + n_heads


def mamba2_specs(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.state_dim
    proj_out = _proj_width(cfg)
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.conv_width, conv_dim), ("conv", "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros"),
        "A_log": ParamSpec((n_heads,), ("ssm_heads",), "zeros"),
        "D": ParamSpec((n_heads,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((n_heads,), ("ssm_heads",), "zeros"),
        "norm": ParamSpec((d_inner,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((d_inner, d), ("ssm_inner", "embed")),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _split_proj(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    gn = s.n_groups * s.state_dim
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner: 2 * d_inner]
    b_mat = zxbcdt[..., 2 * d_inner: 2 * d_inner + gn]
    c_mat = zxbcdt[..., 2 * d_inner + gn: 2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, x, b_mat, c_mat, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, L, C), w (W, C). Returns (B, L, C)."""
    width, length = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):  # Python's sum: 0 + term 0 + term 1 ...
        out = out + xp[:, i: i + length, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _segsum(dA):
    """Lower-triangular pairwise decay sums: out[..., i, j] = sum dA[j+1..i]."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum (j, i]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device), 0)
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int):
    """SSD scan. x: (B,L,H,P), dt: (B,L,H), a: (H,) (negative),
    b_mat/c_mat: (B,L,G,N) with H a multiple of G. Returns (y, final_state).
    Raises where the reference's assertion fails: L not a multiple of
    ``chunk``."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[-2:]
    if l % chunk:
        raise ValueError(f"ssd_chunked: sequence length {l} is not a multiple of the chunk "
                         f"size {chunk}")
    nc = l // chunk
    rep = h // g

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = torch.repeat_interleave(b_mat.reshape(bsz, nc, chunk, g, n), rep, dim=3)  # (B,NC,Q,H,N)
    cc = torch.repeat_interleave(c_mat.reshape(bsz, nc, chunk, g, n), rep, dim=3)

    dA = dtc * a[None, None, None, :]  # (B,NC,Q,H) negative decay increments
    dA_cs = torch.cumsum(dA, dim=2)
    dA_total = dA_cs[:, :, -1:, :]  # (B,NC,1,H)
    xdt = xc * dtc[..., None]

    # 1) intra-chunk (quadratic within the chunk)
    L = torch.exp(_segsum(torch.movedim(dA, 3, 2)))  # (B,NC,H,Q,Q) causal decay mask
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc) * L
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)

    # 2) per-chunk terminal states
    decay_states = torch.exp(dA_total - dA_cs)  # (B,NC,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchnp", bc * decay_states[..., None], xdt)

    # 3) inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_total[:, :, 0, :])  # (B,NC,H)
    carry = torch.zeros((bsz, h, n, p), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,NC,H,N,P)

    # 4) inter-chunk contribution
    state_decay = torch.exp(dA_cs)  # (B,NC,Q,H)
    y_off = torch.einsum("bcqhn,bchnp->bcqhp", cc * state_decay[..., None], prev_states)

    y = (y_diag + y_off).reshape(bsz, l, h, p)
    return y, carry


def _readout(cmh, ssm, n_heads: int):
    """The recurrent step's readout ``y = C h``: (B, H, N) by (B, H, N, P)
    -> (B, H, P). cuBLAS picks a batched product's kernel by its batch
    count, so on CUDA a rank that holds H of ``n_heads`` heads pads them to
    ``n_heads`` with zeros: the product has the unsharded shape and a head
    the unsharded bits."""
    h = cmh.shape[1]
    if not on_card(cmh) or h == n_heads:
        return torch.einsum("bhn,bhnp->bhp", cmh, ssm)
    pad = n_heads - h
    c = torch.cat([cmh, cmh.new_zeros((cmh.shape[0], pad, cmh.shape[2]))], dim=1)
    s = torch.cat([ssm, ssm.new_zeros((ssm.shape[0], pad) + tuple(ssm.shape[2:]))], dim=1)
    return torch.einsum("bhn,bhnp->bhp", c, s)[:, :h]


def mamba2_forward(p, x, cfg: ModelConfig, ctx: EngineContext, *, name, state=None):
    """Full-sequence (``state=None``) or single-step decode (``state`` carried).

    state = {"conv": (B, W-1, conv_dim), "ssm": (B, H, N, P)}, updated in place
    by the decode step. Returns (out, new_state): the full sequence returns a
    fresh state, the decode step ``state`` itself.
    """
    s = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    bsz, l, _ = x.shape
    h_loc = p["A_log"].shape[0]  # this rank's heads
    h0 = ctx.mesh.coord("model") * h_loc if h_loc < n_heads else 0

    cols_split = p["in_proj"].shape[-1] != _proj_width(cfg)
    if cols_split:  # the rank's in_proj columns
        x = enter_model(x, ctx.mesh)
    zxbcdt = ctx.linear(x, p["in_proj"], name=f"{name}.in_proj")
    if cols_split:
        zxbcdt = all_gather(zxbcdt, ctx.mesh, "model", dim=-1)  # the column shards, in order
    z, xs, b_mat, c_mat, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xs, b_mat, c_mat], dim=-1)

    if state is None:
        conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    else:
        window = torch.cat([state["conv"], conv_in.to(state["conv"].dtype)], dim=1)  # (B, W, C)
        conv_out = (torch.einsum("bwc,wc->bc", window, p["conv_w"])[:, None, :]
                    + p["conv_b"][None, None, :])
        state["conv"].copy_(window[:, 1:, :])  # window is a fresh tensor: no overlap

    conv_out = silu(conv_out)
    if h_loc < n_heads:  # the whole conv output and dt enter the rank's heads
        conv_out, dt = enter_model(conv_out, ctx.mesh), enter_model(dt, ctx.mesh)
    xs = conv_out[..., h0 * s.head_dim: (h0 + h_loc) * s.head_dim]  # the rank's heads
    b_mat = conv_out[..., d_inner: d_inner + s.n_groups * s.state_dim]
    c_mat = conv_out[..., d_inner + s.n_groups * s.state_dim:]
    dt = dt[..., h0: h0 + h_loc]

    a = -torch.exp(p["A_log"].to(torch.float32))  # (H,)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])  # (B,L,H)
    xh = xs.reshape(bsz, l, h_loc, s.head_dim)
    bm = b_mat.reshape(bsz, l, s.n_groups, s.state_dim).to(torch.float32)
    cm = c_mat.reshape(bsz, l, s.n_groups, s.state_dim).to(torch.float32)
    if h_loc < n_heads and s.n_groups > 1:  # the rank's heads' groups, one a head
        rep = n_heads // s.n_groups
        bm = torch.repeat_interleave(bm, rep, dim=2)[:, :, h0: h0 + h_loc]
        cm = torch.repeat_interleave(cm, rep, dim=2)[:, :, h0: h0 + h_loc]

    if state is None:
        chunk = min(s.chunk_size, l)
        y, final_state = ssd_chunked(xh.to(torch.float32), dt, a, bm, cm, chunk)
        # conv window for a subsequent decode step = last W-1 pre-conv inputs
        tail = conv_in[:, -(s.conv_width - 1):, :].to(x.dtype)
        new_state = {"conv": tail, "ssm": final_state}
    else:
        # recurrent step: h' = h * exp(dt A) + dt * B x ; y = C h' + D x
        rep = h_loc // bm.shape[2]
        bmh = torch.repeat_interleave(bm[:, 0], rep, dim=1)  # (B,H,N)
        cmh = torch.repeat_interleave(cm[:, 0], rep, dim=1)
        dt0 = dt[:, 0]  # (B,H)
        decay = torch.exp(dt0 * a[None, :])  # (B,H)
        xdt = xh[:, 0].to(torch.float32) * dt0[..., None]  # (B,H,P)
        upd = torch.einsum("bhn,bhp->bhnp", bmh, xdt)
        ssm = state["ssm"].to(torch.float32) * decay[..., None, None] + upd
        y = _readout(cmh, ssm, n_heads)[:, None]  # (B,1,H,P)
        state["ssm"].copy_(ssm)
        new_state = state

    y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, l, h_loc * s.head_dim).to(x.dtype)
    if h_loc < n_heads:
        y = all_gather(y, ctx.mesh, "model", dim=-1)  # the whole d_inner, for the norm
    y = rmsnorm(y * silu(z.to(torch.float32)).to(x.dtype), p["norm"])
    k_loc = p["out_proj"].shape[0]  # out_proj's K shard: row-parallel
    if k_loc < d_inner:
        k0 = ctx.mesh.coord("model") * k_loc
        y = enter_model(y, ctx.mesh)[..., k0: k0 + k_loc]
    return (ctx.linear(y, p["out_proj"], name=f"{name}.out_proj", k_sharded=k_loc < d_inner),
            new_state)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None,
                     mesh=None):
    """One layer's state; ``mesh``: a rank's (the SSM state holds its heads
    where the model axis divides them, the conv window every channel)."""
    s = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.state_dim
    m = mesh.size("model") if mesh is not None else 1
    heads = n_heads // m if m > 1 and n_heads % m == 0 else n_heads
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, heads, s.state_dim, s.head_dim), dtype=dtype,
                           device=device),
    }
