"""PyTorch port: replicated kv heads on a (data, model) mesh, on spawned
``gloo`` ranks, one torch thread each.

Where the model axis splits the q heads but not the kv heads, the
reference's rules keep ``wk``/``wv`` whole on every rank (the divisibility
fallback) and GSPMD runs the attention. The port computes K and V for every
kv head on each rank, and the rank's q heads read kv head (global q head) //
(H / KV) of them in place (``blocks.attention``; kernels 2 and 7 take the
rank's first q head and the global group count). Two geometries, each one
spawn running every job:

* reduced qwen3-8b with 4 q / 2 kv heads (``q_norm``/``k_norm``) on (1, 4):
  a rank holds one q head and both kv heads;
* reduced olmo-1b with 4 q / 1 kv head on (1, 2) (the geometry that mesh
  serving refused before).

For each: kernel-mode greedy streams and f32 top-2 margins are bitwise the
port's ``mesh=None`` ones and the streams equal the reference's; the
cache-free ``forward`` logits (kernel mode, ``flash`` and ``xla``) are
bitwise ``mesh=None``'s; the cache holds the whole kv heads on every rank;
an exact train step equals ``mesh=None``'s and the reference's step to
``test_torch_train``'s tolerances, and without K's and V's entry op
(``collectives.enter_model``) the forward is the same and ``wk``'s and
``wv``'s gradients are wrong. The plain twins of kernels 2 and 7 with a q-head
offset equal the slice of a whole call, and the wrappers cost the kv heads a
call reads.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels.decode_attention import (gqa_decode_attention,  # noqa: E402
                                                  gqa_decode_attention_ref)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.launch import cost_analysis  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

import _tp_ranks  # noqa: E402
from test_torch_mamba2 import numpy_params, one_torch_thread  # noqa: E402,F401
from test_torch_tp_serving import reference_streams  # noqa: E402
from test_torch_tp_train import _batches, _close, _names  # noqa: E402
from test_torch_train import GRAD_TOL, Arch, _ref_step  # noqa: E402

# (arch, kv heads, mesh): q heads split over model, kv heads whole
CASES = (("qwen3-8b", 2, (1, 4)), ("olmo-1b", 1, (1, 2)))
IDS = [f"{a}-kv{kv}-{m[0]}x{m[1]}" for a, kv, m in CASES]
ATTNS = ("flash", "xla")


class KvArch(Arch):
    """``test_torch_train.Arch`` with ``kv`` kv heads on both sides."""

    def __init__(self, arch, kv):
        self.rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), num_kv_heads=kv)
        self.cfg = dataclasses.replace(reduced(get_config(arch)), num_kv_heads=kv)
        self.ref_model = ref_get_model(self.rcfg)
        self.model = get_model(self.cfg)
        self.np_params = numpy_params(self.ref_model.specs())


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (2, 12)).astype(np.int32)


def _jobs(arch, name, kv):
    base = dict(arch=name, kv_heads=kv, params=arch.np_params)
    jobs = {"serve": dict(base, kind="serve", mode="kernel", record=True)}
    for attn in ATTNS:
        jobs[f"forward {attn}"] = dict(base, kind="forward", mode="kernel", attn=attn,
                                       tokens=_tokens(arch.cfg.vocab_size))
    train = dict(base, batches=_batches(arch), mode="exact", kind="step")
    jobs["step"] = train
    jobs["no kv entries"] = dict(train, drop_entries="kv")
    return jobs


@pytest.fixture(scope="module")
def cases():
    """Per case: the arch, its jobs, rank 0's meshed results and the port's
    ``mesh=None`` results."""
    out = {}
    for (name, kv, shape), cid in zip(CASES, IDS):
        arch = KvArch(name, kv)
        jobs = _jobs(arch, name, kv)
        meshed = [dict(j, mesh=shape) for j in jobs.values()]
        ranks = spawn(_tp_ranks.train_jobs, shape[0] * shape[1], args=(meshed,), timeout=600)
        base = {k: _tp_ranks.TRAIN_KINDS[j["kind"]](j) for k, j in jobs.items()
                if k != "no kv entries"}
        out[cid] = dict(arch=arch, shape=shape,
                        meshed={k: [r[i] for r in ranks] for i, k in enumerate(jobs)},
                        base=base)
    return out


@pytest.mark.parametrize("cid", IDS)
def test_streams_and_margins_bitwise_mesh_none(cases, cid):
    """Kernel-mode greedy serving: every rank's streams and f32 margins are
    ``mesh=None``'s, bitwise, and the streams the reference's."""
    c = cases[cid]
    want = c["base"]["serve"]
    for rep in c["meshed"]["serve"]:
        assert rep["streams"] == want["streams"]
        assert rep["margins"] == want["margins"]
    assert want["streams"] == reference_streams(c["arch"].ref_model, c["arch"].np_params,
                                                "kernel")


@pytest.mark.parametrize("cid", IDS)
def test_cache_holds_the_whole_kv_heads(cases, cid):
    """A rank's KV cache holds every kv head of its slots, and the placement
    report says so: no cache dim over ``model`` (the reference's rules put
    head_dim there; the port's choice, ``serve.engine._serving_shardings``)."""
    c = cases[cid]
    cfg = c["arch"].cfg
    rep = c["meshed"]["serve"][0]
    assert rep["cache_shapes"]["k"] == (cfg.num_layers, 4, 32, cfg.num_kv_heads, cfg.head_dim)
    assert all("model" not in spec for spec in rep["report"]["cache"].values())
    dropped = {(d["axis"], d["dim"]) for d in rep["report"]["dropped"]}
    assert ("kv_heads", cfg.num_kv_heads) in dropped


@pytest.mark.parametrize("attn", ATTNS)
@pytest.mark.parametrize("cid", IDS)
def test_forward_logits_bitwise_mesh_none(cases, cid, attn):
    c = cases[cid]
    want = c["base"][f"forward {attn}"]["logits"]
    for rep in c["meshed"][f"forward {attn}"]:
        assert np.array_equal(rep["logits"], want)


@pytest.mark.parametrize("cid", IDS)
def test_train_step_matches_mesh_none_and_reference(cases, cid):
    """One exact step (loss, grad norm, gradients, updated parameters and
    moments) against the port's ``mesh=None`` step and the reference's, to
    ``test_torch_tp_train``'s tolerances."""
    c = cases[cid]
    full, base = c["meshed"]["step"][0], c["base"]["step"]
    for rep in c["meshed"]["step"]:
        assert rep["loss"] == full["loss"] and rep["grad_norm"] == full["grad_norm"]
    tol = dict(loss=1e-5, grad=GRAD_TOL["exact"])
    jloss, jgrads, jnew, _, jmet = _ref_step(c["arch"], "exact")
    lr = float(jmet["lr"])
    _close(full, base, tol, lr, moments=base["state"])
    ref = dict(loss=jloss, grad_norm=jmet["grad_norm"],
               grads=[np.asarray(g) for g in jax.tree.leaves(jgrads)],
               params=[np.asarray(p) for p in jax.tree.leaves(jnew)])
    _close(full, ref, tol, lr)


@pytest.mark.parametrize("cid", IDS)
def test_kv_entry_op_carries_the_gradient(cases, cid):
    """Whole K and V enter the rank's q heads through ``enter_model``: with
    it the gradients of ``wk`` and ``wv`` (whole on every rank) are
    ``mesh=None``'s to 1e-5 of their largest; without it the forward is
    the same, bit for bit, and each rank's ``wk``/``wv`` gradient holds only
    its own q heads' part."""
    c = cases[cid]
    names = _names(c["arch"].params())
    good, bad = c["meshed"]["step"][0], c["meshed"]["no kv entries"][0]
    base = c["base"]["step"]
    assert np.array_equal(good["loss"], bad["loss"])
    for leaf in ("wk", "wv"):
        i = next(n for n, p in enumerate(names) if p.endswith(f"attn/{leaf}"))
        want = base["grads"][i]
        scale = np.abs(want).max()
        assert np.abs(good["grads"][i] - want).max() <= 1e-5 * scale, leaf
        assert np.abs(bad["grads"][i] - want).max() > 1e-2 * scale, leaf


# (H, KV, rank's q heads, first q head): qwen3-8b at 16, yi-9b at 8 (rank 5)
# and a share whose q heads span two kv heads unevenly
SHARES = ((32, 8, 2, 6), (32, 4, 4, 20), (12, 3, 6, 6), (4, 2, 1, 3))


@pytest.mark.parametrize("h,kv,h_loc,h0", SHARES)
def test_plain_twins_with_a_head_offset_equal_a_sliced_whole_call(h, kv, h_loc, h0):
    """Kernels 2 and 7's plain versions (the CPU path of their wrappers) on a
    rank's q heads against the whole K/V, given the first q head and the
    global group count, equal the whole call's rows for those heads,
    bitwise. On meta the wrappers cost the kv heads the rank's q heads read."""
    rng = np.random.default_rng(h0)
    b, s, t, hd = 2, 5, 24, 32
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((b, t, kv, hd)).astype(np.float32))
              for _ in range(2))
    pos = torch.from_numpy(rng.integers(-1, t, (b, s)).astype(np.int32))
    part = q[:, :, h0:h0 + h_loc].contiguous()
    share = dict(head_offset=h0, groups=h // kv)
    whole = gqa_decode_attention_ref(q, ck, cv, pos, scale=0.2)[:, :, h0:h0 + h_loc]
    assert torch.equal(gqa_decode_attention_ref(part, ck, cv, pos, scale=0.2, **share), whole)
    assert torch.equal(gqa_decode_attention(part, ck, cv, pos, scale=0.2, **share), whole)
    k, v = ck[:, :s + 3], cv[:, :s + 3]
    qf = torch.from_numpy(rng.standard_normal((b, s + 3, h, hd)).astype(np.float32))
    for causal in (True, False):
        whole = flash_attention_ref(qf, k, v, causal=causal)[:, :, h0:h0 + h_loc]
        got = flash_attention(qf[:, :, h0:h0 + h_loc].contiguous(), k, v, causal=causal, **share)
        assert torch.equal(got, whole)

    read = (h0 + h_loc - 1) // (h // kv) - h0 // (h // kv) + 1
    meta = [x.to("meta") for x in (part, ck, cv, pos)]
    an, _ = cost_analysis.analyze(gqa_decode_attention, *meta, scale=0.2, **share)
    want = costs.gqa_decode_attention(b, s, h_loc, t, read, hd)
    assert an.records[-1]["bytes"] == want.hbm_bytes
    an, _ = cost_analysis.analyze(flash_attention, qf[:, :, :h_loc].to("meta"), k.to("meta"),
                                  v.to("meta"), **share)
    assert an.records[-1]["bytes"] == costs.flash_attention(b, s + 3, h_loc, read, hd, 4,
                                                            True).hbm_bytes
    with pytest.raises(ValueError, match="read past"):
        gqa_decode_attention(meta[0], meta[1][:, :, :1], meta[2][:, :, :1], meta[3], scale=0.2,
                             head_offset=h, groups=h // kv)
    assert sum(kernels.launch_counts().values()) == 0
