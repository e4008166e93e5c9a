"""PyTorch port: tensor-parallel serving (``BatchedServer(mesh=...)``) on
spawned ``gloo`` ranks, one torch thread each, against the reference.

The reference's contract (``tests/test_sharded_serving.py``) is that greedy
streams are bit-identical between ``mesh=None`` and its meshes; its meshed
tests cannot run in this container (jax 0.9.0), so the port's meshed streams
are held against the reference's ``mesh=None`` streams, on the same numpy
weights and requests (slots 4, max_len 32, burst 4, max_new 6):

* exact mode, reduced olmo-1b, llama4-maverick (a dense/MoE pair, EP) and
  deepseek-v3 (MLA + MoE) at (1,1), (1,2) and (2,2), olmo-1b also at (4,2):
  the row-parallel products sum f32 partials, so logits move by
  reduction-order ulps and only the streams are held;
* kernel mode, olmo-1b at (1,2) and (2,2): the row-parallel products sum
  int32 partials before the epilogue, so streams and f32 top-2 margins are
  bitwise the port's ``mesh=None`` ones, and the streams equal the
  reference's kernel-mode streams.

Each mesh shape is one spawn whose ranks run every job of that shape; the
rank results are the module fixture ``meshed``. Also: the placement (slots
over data, kv heads over model, no S axis sharded), the JSON-able sharding
report, and the collective bytes of a greedy burst against a formula.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import EngineContext as JCtx, PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

import _tp_ranks  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

ARCHS = ("olmo-1b", "llama4-maverick-400b-a17b", "deepseek-v3-671b")
SHAPES = ((1, 1), (1, 2), (2, 2))


def numpy_params(arch, seed=0):
    """The reference's raw tree of ``arch`` (reduced), redrawn with numpy:
    matrices N(0, 0.1^2) so the layers, not the tied embedding, pick the
    tokens (as ``test_torch_serving``)."""
    model = ref_get_model(ref_reduced(ref_get_config(arch)))
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        scale = 0.02 if path[0].key == "embed" else 0.1
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)

    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return model, jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(make, shapes))


def reference_streams(model, params, mode, *, max_new=6, temperature=0.0):
    ctx = JCtx(mode=mode, policy=None if mode == "exact" else JPolicy.accurate(),
               compute_dtype=jnp.float32, attn_impl="decode_kernel")
    server = JServer(model, ctx, jax.tree.map(jnp.asarray, params), slots=4, max_len=32,
                     burst=4)
    rng = np.random.default_rng(0)
    reqs = [JRequest(i, rng.integers(0, model.cfg.vocab_size, 3 + i).astype(np.int32),
                     max_new, temperature=temperature, seed=10 + i) for i in range(4)]
    return server.run(reqs)


@pytest.fixture(scope="module")
def params():
    return {arch: numpy_params(arch) for arch in ARCHS}


def _jobs(params, shape):
    jobs = [dict(arch=a, mode="exact", params=params[a][1], record=a == "olmo-1b")
            for a in ARCHS]
    if shape != (1, 1):
        jobs.append(dict(arch="olmo-1b", mode="kernel", params=params["olmo-1b"][1],
                         record=True))
    return jobs


@pytest.fixture(scope="module")
def meshed(params):
    """Every shape's rank results: ``{shape: [rank 0's jobs, rank 1's, ...]}``."""
    out = {}
    for shape in SHAPES:
        out[shape] = spawn(_tp_ranks.run_jobs, shape[0] * shape[1],
                           args=(shape, _jobs(params, shape)), timeout=240)
    job = dict(arch="olmo-1b", mode="exact", params=params["olmo-1b"][1])
    out[(4, 2)] = spawn(_tp_ranks.run_jobs, 8, args=((4, 2), [job]), timeout=240)
    return out


@pytest.fixture(scope="module")
def references(params):
    out = {(a, "exact"): reference_streams(*params[a], "exact") for a in ARCHS}
    out[("olmo-1b", "kernel")] = reference_streams(*params["olmo-1b"], "kernel")
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_exact_meshed_streams_equal_the_reference(meshed, references, arch, shape):
    want = references[(arch, "exact")]
    i = ARCHS.index(arch)
    for rank, jobs in enumerate(meshed[shape]):
        assert jobs[i]["streams"] == want, (arch, shape, rank)
    assert len({tuple(v) for v in want.values()}) > 1  # varied streams


def test_exact_olmo_on_eight_ranks(meshed, references):
    """(4, 2): slots split over four data ranks (one each), heads over two."""
    for jobs in meshed[(4, 2)]:
        assert jobs[0]["streams"] == references[("olmo-1b", "exact")]


@pytest.mark.parametrize("shape", SHAPES[1:], ids=lambda s: "x".join(map(str, s)))
def test_kernel_mode_is_bitwise_mesh_none(params, meshed, references, shape):
    """Streams and f32 top-2 margins bitwise the port's mesh=None run, the
    streams the reference's kernel mode."""
    base = _tp_ranks.serve(dict(arch="olmo-1b", mode="kernel", params=params["olmo-1b"][1]))
    for jobs in meshed[shape]:
        assert jobs[3]["streams"] == base["streams"]
        assert jobs[3]["margins"] == base["margins"]
    assert base["streams"] == references[("olmo-1b", "kernel")]


def test_placement_slots_over_data_kv_heads_over_model(meshed):
    """(2, 2) on reduced olmo-1b (4 heads, 4 kv heads, head_dim 32, 4 slots):
    a rank's cache holds 2 slots and 2 kv heads of every row, and the
    report's specs say so: slots over data, kv heads over model, the S row
    axis never split; every weight is sharded (heads or MLP width over
    model, d_model over data)."""
    rec = meshed[(2, 2)][0][0]
    assert rec["local_slots"] == 2
    assert rec["cache_shapes"]["k"] == (2, 2, 32, 2, 32)
    assert rec["state_shapes"]["tok"] == (2, 1)
    rep = rec["report"]
    assert rep["mesh"] == {"data": 2, "model": 2} and rep["devices"] == 4
    assert rep["cache"]["seg0_dense/k"] == "P(None, 'data', None, 'model')"
    assert rep["cache"]["seg0_dense/index"] == "P()"
    assert rep["state"]["tok"] == "P('data')"
    assert rep["params"] == {"sharded": 8, "replicated": 0}  # embed and 7 dot banks
    for spec in rep["cache"].values():
        entries = spec[2:-1].split(", ")
        assert len(entries) < 3 or entries[2] == "None"


def _fsdp_bytes(cfg, mode: str, model: int, data: int, slots: int) -> int:
    """The bytes one decode step's FSDP gathers bring together: every weight
    whose partition spec has a ``data`` entry, whole except for its model
    shard, in its stored type (f32 raw weights; kernel mode's prepared dot
    weights int8, and its lm_head, the tied embedding transposed, too). In
    kernel mode the embedding itself is not gathered: its lookup gathers
    every slot's int32 token and the f32 rows' columns instead."""
    from repro_torch.models import get_model
    from repro_torch.models.params import ParamSpec, spec_leaves
    from repro_torch.sharding import partition

    if data == 1:
        return 0
    mesh = type("M", (), dict(shape={"data": data, "model": model},
                              axis_names=("data", "model")))()
    specs = dict(spec_leaves(get_model(cfg).specs()))
    if mode == "kernel":
        embed = specs[("embed",)]
        specs[("lm_head",)] = ParamSpec(embed.shape[::-1], embed.axes[::-1])
    total = 0
    if mode == "kernel":
        del specs[("embed",)]
        total += slots * 4 + slots * cfg.d_model * 4
    for path, spec in specs.items():
        entries = partition.param_pspec(spec, mesh)
        if "data" not in entries:
            continue
        split = model if "model" in entries else 1
        dot = mode == "kernel" and path[-1] in ("wq", "wk", "wv", "wo", "up", "gate", "down",
                                                "lm_head")
        total += int(np.prod(spec.shape)) // split * (1 if dot else 4)
    return total


def _burst_bytes(cfg, mode: str, slots: int, burst: int, model: int, data: int) -> dict:
    """The collective result bytes of one greedy burst of reduced olmo-1b on
    a (data, model) mesh, from the shapes: each step all-reduces the
    embedding rows (B, 1, D) f32 and every layer's two row-parallel int32 or
    f32 sums (B, 1, D), all-gathers the logits (B, 1, V) f32 over model and
    the FSDP shards over data; the burst's (3, B, burst) f32 output is
    all-gathered over data; B is the rank's slots."""
    b = slots // data
    d, v, layers = cfg.d_model, cfg.vocab_size, cfg.num_layers
    out = {}
    if model > 1:
        out["all-reduce"] = burst * (1 + 2 * layers) * b * d * 4
        out["all-gather"] = burst * b * v * 4
    if data > 1:
        out["all-gather"] = (out.get("all-gather", 0) + 3 * slots * burst * 4
                             + burst * _fsdp_bytes(cfg, mode, model, data, slots))
    return {k: float(n) for k, n in out.items()}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_collective_snapshot_matches_the_shapes(meshed, shape):
    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config("olmo-1b"))
    for jobs in meshed[shape]:
        for job, mode in ((jobs[0], "exact"), (jobs[-1], "kernel")):
            if mode == "kernel" and shape == (1, 1):
                continue
            want = _burst_bytes(cfg, mode, 4, 4, model=shape[1], data=shape[0])
            snap = job["collectives"]
            assert snap["collective_by_kind"] == want, mode
            assert snap["collective_bytes"] == sum(want.values())
            json.dumps(snap)
