"""PyTorch port: tensor-parallel serving beyond the plain greedy burst, on
spawned ``gloo`` ranks (one torch thread each) and on a 1x1 mesh.

* A pinned adaptive bank (carmen FxP16, pinned at ``accurate``) and greedy
  speculation (draft_len 3) at (2,2) equal the reference's static
  accurate-only streams (as ``tests/test_sharded_serving.py`` holds the
  reference's meshed servers to its own).
* Sampled streams (temperature 1.3) at (1,2) and (2,2) equal the port's
  ``mesh=None`` ones: the port's threefry already has the partitionable
  layout the reference switches to under a mesh; they differ from greedy.
* Placement keeps the bank's aliasing; fault isolation and the trace (its
  ``sharding`` meta and ``collectives`` header) work on a 1x1 mesh; the CLI's
  ``--mesh 1,2`` streams equal its streams without it.
* What the slice leaves out raises, naming its ROADMAP item, and a rank that
  fails never hangs the others: the spawn helper kills them.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import FXP16 as JFXP16, EngineContext as JCtx  # noqa: E402
from repro.core import PrecisionPolicy as JPolicy  # noqa: E402
from repro.runtime import build_bank as jbuild_bank, default_points as jdefault_points  # noqa: E402
from repro.serve.engine import BatchedServer as JServer, Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import FXP16, PrecisionPolicy  # noqa: E402
from repro_torch.core.backends import PreparedWeight  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.runtime import ExecutionPoint, build_bank, place_bank  # noqa: E402
from repro_torch.serve import BatchedServer  # noqa: E402
from repro_torch.serve.engine import _check_mesh  # noqa: E402

import _tp_ranks  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401
from test_torch_tp_serving import numpy_params  # noqa: E402

ONE = Mesh({"data": 1, "model": 1})


@pytest.fixture(scope="module")
def olmo():
    return numpy_params("olmo-1b")


def _reference_accurate(model, params, max_len):
    """The reference's static accurate-only carmen FxP16 streams."""
    ctx = JCtx(mode="carmen", policy=JPolicy.accurate(JFXP16), compute_dtype=jnp.float32)
    tree = jax.tree.map(jnp.asarray, params)
    bank = jbuild_bank(tree, "carmen", jdefault_points(JFXP16, hifi_fmt=None),
                       specs=model.specs())
    rng = np.random.default_rng(0)
    reqs = [JRequest(i, rng.integers(0, model.cfg.vocab_size, 3 + i).astype(np.int32), 6,
                     seed=10 + i) for i in range(4)]
    return JServer(model, ctx, bank.tree("accurate"), slots=4, max_len=max_len, burst=4,
                   prepare_weights=False).run(reqs)


@pytest.fixture(scope="module")
def meshed(olmo):
    _, params = olmo
    base = dict(arch="olmo-1b", params=params)
    sampled = dict(base, mode="exact", temperature=1.3, max_new=8)
    out = {(1, 2): spawn(_tp_ranks.run_jobs, 2, args=((1, 2), [sampled]), timeout=240)}
    jobs = [sampled, dict(base, mode="carmen", fxp16=True, bank="pinned"),
            dict(base, mode="carmen", fxp16=True, bank="spec", max_len=40)]
    out[(2, 2)] = spawn(_tp_ranks.run_jobs, 4, args=((2, 2), jobs), timeout=240)
    return out


@pytest.mark.parametrize("job,max_len", [(1, 32), (2, 40)], ids=["pinned", "speculative"])
def test_bank_servers_equal_the_reference_accurate_streams(olmo, meshed, job, max_len):
    want = _reference_accurate(*olmo, max_len)
    for jobs in meshed[(2, 2)]:
        assert jobs[job]["streams"] == want
        shared, host_shared = jobs[job]["shared_leaves"]
        assert shared == host_shared  # build_bank(mesh=) keeps the memo's aliasing
    assert meshed[(2, 2)][0][2]["rounds"] > 0


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sampled_streams_equal_mesh_none(olmo, meshed, shape):
    _, params = olmo
    job = dict(arch="olmo-1b", mode="exact", params=params, max_new=8)
    base = _tp_ranks.serve(dict(job, temperature=1.3))
    greedy = _tp_ranks.serve(job)
    for jobs in meshed[shape]:
        assert jobs[0]["streams"] == base["streams"]
    assert base["streams"] != greedy["streams"]


def test_place_bank_shards_each_shared_leaf_once(olmo):
    """Two points that differ only in the MLP group: every other prepared
    leaf is one object in both trees, before and after placement, and the
    placed leaves are the rank's shards."""
    model = get_model(reduced(get_config("olmo-1b")))
    params = model.load_numpy(olmo[1], "cpu")
    accurate = PrecisionPolicy.accurate(FXP16)
    points = (ExecutionPoint("deep", accurate),
              ExecutionPoint("shallow-mlp", PrecisionPolicy(
                  accurate.default, {"mlp": PrecisionPolicy.approximate(FXP16).default})))
    bank = build_bank(params, "kernel", points, specs=model.specs())

    def ids(tree):
        return set(_tp_ranks._flat_ids(tree))

    host = ids(bank.tree("deep")) & ids(bank.tree("shallow-mlp"))
    assert host
    mesh = Mesh({"data": 1, "model": 2}, rank=1)
    assert place_bank(bank, mesh, model.specs()) is bank
    placed = ids(bank.tree("deep")) & ids(bank.tree("shallow-mlp"))
    assert len(placed) == len(host) and not placed & host
    wq = bank.tree("deep")["seg0_dense"]["attn"]["wq"]
    assert isinstance(wq, PreparedWeight) and wq.shape[2] == model.cfg.num_heads // 2
    place_bank(bank, mesh, model.specs())  # idempotent on its own mesh
    assert ids(bank.tree("deep")) & ids(bank.tree("shallow-mlp")) == placed
    with pytest.raises(ValueError, match="another mesh"):
        place_bank(bank, Mesh({"data": 1, "model": 2}), model.specs())


def _server(params, mesh, mode="kernel", **kw):
    model = get_model(reduced(get_config("olmo-1b")))
    return BatchedServer(model, _tp_ranks.ctx_of(mode), model.load_numpy(params, "cpu"),
                         slots=4, max_len=64, burst=4, device="cpu", mesh=mesh, **kw)


def test_fault_isolation_on_a_one_by_one_mesh(olmo):
    """A NaN in one slot's cache (exact mode: the NaN reaches the logits): on
    a 1x1 mesh the outcomes and streams are the mesh=None server's, the slot
    quarantined."""
    from repro_torch.resilience import FaultInjector, NaNCacheFault, ResilienceConfig

    runs = []
    for mesh in (None, ONE):
        srv = _server(olmo[1], mesh, mode="exact", resilience=ResilienceConfig(),
                      injector=FaultInjector(NaNCacheFault(rid=1, at_round=1)))
        out = srv.run(_tp_ranks.requests(256, 3, max_new=12))
        runs.append((out, {r: o.to_dict()["status"] for r, o in srv.outcomes.items()}))
        assert srv.injector.fired
    assert runs[0] == runs[1]
    assert "faulted" in runs[0][1].values()


def test_trace_carries_sharding_and_collectives_on_a_mesh(olmo, tmp_path):
    """The observed server's trace meta holds the sharding report; the CLI's
    ``--mesh 1,1`` trace header the burst's collective bytes (none on one
    rank)."""
    from repro_torch.obs import ServingObserver

    srv = _server(olmo[1], ONE, observer=ServingObserver(trace=True))
    srv.run(_tp_ranks.requests(256, 2))
    snap = srv.collective_snapshot()
    assert snap == {"collective_bytes": 0.0, "collective_by_kind": {}}
    assert srv.observer.trace.header["run"]["sharding"]["mesh"] == {"data": 1, "model": 1}
    assert _server(olmo[1], None).collective_snapshot() is None
    path = tmp_path / "t.jsonl"
    cli.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--mode", "kernel",
              "--requests", "2", "--max-new", "4", "--mesh", "1,1", "--dist-backend", "gloo",
              "--trace-out", str(path)])
    header = json.loads(path.read_text().splitlines()[0])
    assert header["collectives"] == {"collective_bytes": 0.0, "collective_by_kind": {}}
    assert header["run"]["sharding"]["devices"] == 1


def test_cli_mesh_streams_equal_streams_without(capfd):
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--mode", "kernel",
            "--requests", "4", "--slots", "2", "--max-new", "6"]
    want = cli.main(argv)
    got = cli.main(argv + ["--mesh", "1,2", "--dist-backend", "gloo"])
    assert got == want
    out = capfd.readouterr().out  # the spawned ranks print to the same stdout
    assert out.count("served 4 requests") == 2  # rank 1 prints nothing
    for bad, msg in ((["--mesh", "1,2"], "--dist-backend"),
                     (["--mesh", "1,2", "--dist-backend", "gloo", "--frontend"], "frontend"),
                     (["--mesh", "1,2", "--dist-backend", "gloo", "--per-call"], "ROADMAP")):
        with pytest.raises((SystemExit, RuntimeError), match=msg):
            cli.main(argv + bad)


def test_refusals_name_their_roadmap_item(olmo):
    mamba = get_model(reduced(get_config("mamba2-780m")))
    mesh = Mesh({"data": 1, "model": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedServer(mamba, _tp_ranks.ctx_of("kernel"),
                      mamba.init(torch.Generator().manual_seed(0)), device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _server(olmo[1], mesh, prepare_weights=False)
    model = get_model(reduced(get_config("olmo-1b")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchedServer(model, _tp_ranks.ctx_of("int8"), model.load_numpy(olmo[1], "cpu"),
                      device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="capture"):
        _check_mesh(model.cfg, _tp_ranks.ctx_of("kernel"), mesh, torch.device("cuda"),
                    True, True)
    from repro_torch.serve.frontend import ContinuousScheduler

    srv = _server(olmo[1], ONE)
    with pytest.raises(ValueError, match="ROADMAP"):
        ContinuousScheduler(srv)
    with pytest.raises(ValueError, match="ROADMAP"):
        srv.chunk_fns()


def test_a_failing_rank_never_hangs_the_others():
    """Rank 1 raises while rank 0 waits in an all-reduce: the helper raises
    with the first rank's report (rank 1's error, or rank 0's broken
    connection) and kills the rest, long before the collective's timeout."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="spawn: rank [01] raised"):
        spawn(_tp_ranks.fail_one, 2, timeout=120, collective_timeout=100)
    assert time.perf_counter() - t0 < 60
    with pytest.raises(ValueError, match="backend"):
        spawn(_tp_ranks.fail_one, 2, backend="mpi")
