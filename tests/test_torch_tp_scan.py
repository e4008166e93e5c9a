"""PyTorch port: the scan families (mamba2, zamba2, seamless) served
tensor-parallel (``BatchedServer(mesh=...)``) on spawned ``gloo`` ranks,
one torch thread each, against the reference.

The reference serves the masked-scan families on a mesh and holds only its
own contract there (``tests/test_sharded_serving.py::
test_recurrent_family_serves_on_mesh``: serving completes, budgets are
exact, a fixed mesh is deterministic), since its GSPMD partial sums
reassociate the mixer's contraction. Its meshed tests cannot run in this
container (jax 0.9.0). The port holds, on the same numpy weights and
requests (slots 4, max_len 32, burst 4, max_new 6), reduced:

* kernel mode at (1,2) and (2,2): the mixer all-gathers ``in_proj``'s
  column shards, runs its heads, norms the whole ``d_inner`` and sums
  ``out_proj``'s int32 partials before the epilogue, so streams and f32
  top-2 margins are bitwise the port's ``mesh=None`` ones, and the streams
  equal the reference's ``mesh=None`` kernel-mode streams;
* exact mode at (1,2) and (2,2): the reference's contract;
* the placement: a rank's SSM state holds its heads and its slots, a conv
  window every channel, the attention caches (zamba2's shared block,
  seamless's self and cross caches) their kv heads; every data rank runs
  every prefill's single-token steps.

Each mesh shape is one spawn whose ranks run every job of that shape.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

import _tp_ranks  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_tp_serving import numpy_params, reference_streams  # noqa: E402

ARCHS = ("mamba2-780m", "zamba2-7b", "seamless-m4t-large-v2")
SHAPES = ((1, 2), (2, 2))
PROMPT_TOKENS = 3 + 4 + 5 + 6  # the request fixture's prompts


@pytest.fixture(scope="module")
def params():
    return {arch: numpy_params(arch) for arch in ARCHS}


def _jobs(params):
    jobs = [dict(arch=a, mode="kernel", params=params[a][1], record=True) for a in ARCHS]
    return jobs + [dict(arch=a, mode="exact", params=params[a][1], repeat=True) for a in ARCHS]


@pytest.fixture(scope="module")
def meshed(params):
    """Every shape's rank results: ``{shape: [rank 0's jobs, rank 1's, ...]}``."""
    return {shape: spawn(_tp_ranks.run_jobs, shape[0] * shape[1],
                         args=(shape, _jobs(params)), timeout=240) for shape in SHAPES}


@pytest.fixture(scope="module")
def bases(params):
    """The port's mesh=None kernel-mode runs."""
    return {a: _tp_ranks.serve(dict(arch=a, mode="kernel", params=params[a][1])) for a in ARCHS}


@pytest.fixture(scope="module")
def references(params):
    return {a: reference_streams(*params[a], "kernel") for a in ARCHS}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_mode_is_bitwise_mesh_none(meshed, bases, references, arch, shape):
    """Streams and f32 top-2 margins bitwise the port's mesh=None run on
    every rank; the streams the reference's kernel mode."""
    i = ARCHS.index(arch)
    base = bases[arch]
    for rank, jobs in enumerate(meshed[shape]):
        assert jobs[i]["streams"] == base["streams"], (arch, shape, rank)
        assert jobs[i]["margins"] == base["margins"], (arch, shape, rank)
    assert base["streams"] == references[arch]
    assert len({tuple(v) for v in base["streams"].values()}) > 1  # varied streams


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_exact_mode_meets_the_reference_contract(meshed, arch, shape):
    """Serving completes, every budget is exact, a fixed mesh is
    deterministic (a second server on the same mesh streams the same), and
    the ranks agree."""
    i = len(ARCHS) + ARCHS.index(arch)
    first = meshed[shape][0][i]["streams"]
    assert sorted(first) == [0, 1, 2, 3]
    assert all(len(v) == 6 for v in first.values())
    for jobs in meshed[shape]:
        assert jobs[i]["streams"] == first
        assert jobs[i]["again"] == first


def test_placement_holds_a_ranks_heads_and_slots(meshed, params):
    """(2, 2): 2 of the 4 slots a rank; an SSM state's heads halved, a conv
    window whole; zamba2's shared attention cache and seamless's self and
    cross caches hold half the kv heads; the report says so from the
    shapes. Every data rank runs every prefill: one single-token step a
    prompt token."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model

    for i, arch in enumerate(ARCHS):
        model = get_model(reduced(get_config(arch)))
        whole = _tp_ranks._leaf_shapes(model.make_cache(4, 32, device="meta"))
        for rank, jobs in enumerate(meshed[(2, 2)]):
            rec = jobs[i]
            assert rec["local_slots"] == 2
            assert rec["prefill_steps"] == PROMPT_TOKENS
            assert rec["state_shapes"]["tok"] == (2, 1)
            got, report = rec["cache_leaves"], rec["report"]["cache"]
            assert set(got) == set(whole)
            for path, shape in whole.items():
                name = path.split("/")[-1]
                slot = 2 if "/ssm/" in path else 1  # a hybrid's SSM stack is (G, per, B, ...)
                want = list(shape)
                spec = [None] * len(shape)
                want[slot] //= 2
                spec[slot] = "data"
                if name in ("k", "v"):
                    want[3] //= 2
                    spec[3] = "model"
                if name == "ssm":
                    want[slot + 1] //= 2
                    spec[slot + 1] = "model"
                assert got[path] == tuple(want), (arch, rank, path)
                while spec[-1] is None:
                    spec.pop()
                assert report[path] == "P(" + ", ".join(
                    repr(e) for e in spec) + ")", (arch, path)


def test_cli_mesh_serves_a_scan_arch(capfd):
    """The CLI's ``--mesh 1,2`` on mamba2 streams what it streams without."""
    argv = ["--arch", "mamba2-780m", "--reduced", "--device", "cpu", "--mode", "kernel",
            "--requests", "2", "--slots", "2", "--max-new", "4"]
    assert cli.main(argv + ["--mesh", "1,2", "--dist-backend", "gloo"]) == cli.main(argv)
    assert capfd.readouterr().out.count("served 2 requests") == 2  # rank 1 prints nothing
