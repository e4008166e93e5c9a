"""PyTorch port: the logical-axis sharding rules (``repro_torch.sharding.
partition``) against the reference's, and the port's mesh factoring.

Every leaf of all ten archs' stock ``specs()`` (shapes only, nothing
allocated) gets the reference's partition spec and fallback report on a
duck-typed mesh (as ``tests/test_partition_props.py`` drives the reference)
of each shape (1,1), (2,2), (4,2), (1,4), (16,16) and (2,16,16). The
reference's ``prepared_shardings``, ``slot_shardings`` and
``cache_shardings`` build ``NamedSharding``s, so they run on a
``jax.sharding.AbstractMesh`` of the same shape (no devices): the prepared
trees are the reduced archs' (prepared for real), the caches every batched
arch's stock cache by ``jax.eval_shape`` (the port's on the meta device).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.backends import prepare_params as jax_prepare  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import _init_slot_state as ref_slot_state  # noqa: E402
from repro.sharding import partition as ref  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.core import PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import PreparedWeight, prepare_params  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.params import spec_leaves  # noqa: E402
from repro_torch.serve.engine import _init_slot_state  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

SHAPES = [(1, 1), (2, 2), (4, 2), (1, 4), (16, 16), (2, 16, 16)]
ARCH_NAMES = sorted(ARCHS)


class FakeMesh:
    """Duck-typed mesh: axis_names + shape mapping, no devices needed."""

    def __init__(self, shape):
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _abstract(shape):
    fake = FakeMesh(shape)
    return AbstractMesh(tuple(fake.shape.values()), fake.axis_names)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(leaf.spec)
            for path, leaf in flat}


def _port_leaves(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, prefix + (str(k),)))
    else:
        out[prefix] = tree
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_and_report_equal_the_reference(arch, shape):
    mesh = FakeMesh(shape)
    ref_specs = dict(spec_leaves(ref_get_model(ref_get_config(arch)).specs()))
    port_specs = dict(spec_leaves(get_model(get_config(arch)).specs()))
    assert ref_specs.keys() == port_specs.keys()
    for path, spec in port_specs.items():
        rs = ref_specs[path]
        ref_report, port_report = [], []
        want = tuple(ref.param_pspec(rs, mesh, ref_report))
        assert partition.param_pspec(spec, mesh, port_report) == want, path
        assert port_report == ref_report, path
    assert (partition.sharding_report(get_model(get_config(arch)).specs(), mesh)
            == ref.sharding_report(ref_get_model(ref_get_config(arch)).specs(),
                                   _abstract(shape)))


def _prepared_pair(arch, mode):
    ref_model = ref_get_model(ref_reduced(ref_get_config(arch)))
    model = get_model(reduced(get_config(arch)))
    np_params = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    jtree = jax_prepare(jax.tree.map(jnp.asarray, np_params), JPolicy.accurate(), mode,
                        specs=ref_model.specs())
    ttree = prepare_params(model.load_numpy(np_params, "cpu"), PrecisionPolicy.accurate(),
                           mode, specs=model.specs())
    return ref_model, model, jtree, ttree


@pytest.fixture(scope="module")
def prepared_trees():
    out = {}
    for arch, mode in (("olmo-1b", "kernel"), ("deepseek-v3-671b", "kernel"),
                       ("llama4-maverick-400b-a17b", "int8")):
        out[arch] = _prepared_pair(arch, mode)
    return out


@pytest.mark.parametrize("shape", SHAPES[:4], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v3-671b", "llama4-maverick-400b-a17b"])
def test_prepared_shardings_equal_the_reference(prepared_trees, arch, shape):
    """Payload, point and (int8) scale entries of every prepared leaf, and the
    tied lm_head synthesized from the embedding spec reversed."""
    ref_model, model, jtree, ttree = prepared_trees[arch]
    want = ref.prepared_shardings(jtree, ref_model.specs(), _abstract(shape))
    got = partition.prepared_shardings(ttree, model.specs(), FakeMesh(shape))
    flat_want = _ref_leaves(want)
    flat_got = {}
    for path, leaf in _port_leaves(got).items():
        if isinstance(leaf, PreparedWeight):
            # the reference's PreparedWeight flattens (data, scale, point)
            for i, part in enumerate((leaf.data, leaf.scale, leaf.point)):
                if part is not None:
                    flat_got[path + (str(i),)] = part
        else:
            flat_got[path] = leaf
    assert flat_got == flat_want
    if "lm_head" in ttree:
        assert got["lm_head"].data == _ref_leaves({"x": want["lm_head"]})[("x", "0")]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v3-671b", "llama4-maverick-400b-a17b",
                                  "qwen2.5-14b", "mamba2-780m", "zamba2-7b"])
def test_slot_and_cache_shardings_equal_the_reference(arch, shape):
    """Stock caches of 8 slots at max_len 512: slots over the batch axes, the
    kv heads (or latent, or SSM width) over model, the S row axis never."""
    ref_model = ref_get_model(ref_get_config(arch))
    model = get_model(get_config(arch))
    jcache = jax.eval_shape(lambda: ref_model.make_cache(8, 512, dtype=jnp.float32))
    want = _ref_leaves(ref.cache_shardings(jcache, _abstract(shape), ref_model.cfg,
                                           row_axis_len=512))
    got = _port_leaves(partition.cache_shardings(model.make_cache(8, 512, device="meta"),
                                                 FakeMesh(shape), model.cfg, row_axis_len=512))
    assert got == want
    for key, spec in got.items():
        if key[-1] in ("k", "v", "c_kv", "k_rope"):
            assert len(spec) < 3 or spec[2] is None  # the S row axis
    jstate = jax.eval_shape(lambda: ref_slot_state(8))
    want = _ref_leaves(ref.slot_shardings(jstate, _abstract(shape)))
    got = _port_leaves(partition.slot_shardings(_init_slot_state(8, "meta"), FakeMesh(shape)))
    assert got == want
    for n in (1, 3, 8):
        assert partition.slot_pspec((n, 2), FakeMesh(shape)) == tuple(
            ref.slot_pspec((n, 2), FakeMesh(shape)))
    assert partition.batch_pspec(FakeMesh(shape), extra=(None, "model")) == tuple(
        ref.batch_pspec(FakeMesh(shape), extra=(None, "model")))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_use_2d_ep_takes_the_mesh(shape):
    mesh = FakeMesh(shape)
    sizes = mesh.shape
    for experts in (4, 8, 64, 256, 6):
        want = (sizes["data"] * sizes["model"] > 1
                and experts % (sizes["data"] * sizes["model"]) == 0)
        assert partition.use_2d_ep(experts, mesh) == want


def test_make_host_mesh_factors_like_the_reference():
    """Most square (data, model) split with model <= data: 1 -> 1x1, 4 ->
    2x2, 8 -> 4x2, 6 -> 3x2; a model that does not divide raises."""
    for n, want in ((1, (1, 1)), (2, (2, 1)), (4, (2, 2)), (6, (3, 2)), (8, (4, 2)),
                    (16, (4, 4))):
        assert tmesh.parse_mesh("auto", n) == want
    assert tmesh.parse_mesh("2,4") == (2, 4)
    with pytest.raises(ValueError):
        tmesh.parse_mesh("2x4")
    mesh = tmesh.make_host_mesh()  # no process group: one rank
    assert (mesh.shape, mesh.group("model")) == ({"data": 1, "model": 1}, None)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(model=3)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)


def test_mesh_coordinates_are_row_major():
    """Rank r of a (data, model) mesh sits at (r // model, r % model), as
    ``jax.make_mesh`` lays devices out."""
    for r in range(8):
        m = tmesh.Mesh({"data": 4, "model": 2}, rank=r)
        assert (m.coord("data"), m.coord("model")) == divmod(r, 2)
    m = tmesh.Mesh({"pod": 2, "data": 2, "model": 2}, rank=5)
    assert (m.coord("pod"), m.coord("data"), m.coord("model")) == (1, 0, 1)
