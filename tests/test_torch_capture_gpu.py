"""The server's captured CUDA-graph programs against the same programs run
eagerly, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card; the file
imports only torch, the port and ``chip_smoke`` (no JAX):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_capture_gpu.py

Reduced olmo-1b (prepared and per call) and reduced deepseek-v3 (4 layers,
MLA + MoE), greedy and sampled, at burst 1 and 8: the captured server's
streams and f32 top-2 margins must be bitwise equal to the uncaptured
yardstick's (``capture=False``: the same programs, every launch issued from
the host), every prefill and burst one replay and one transfer, and each
graph's launches by instantiation, counted at capture, times its replays,
exactly what the shapes imply (``chip_smoke.graph_accounting``). The graph
pool holds no live block after any capture, nothing lazily built changes
across a capture, and graphs captured in one order replay right in others.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.serve.capture import lazy_state, pool_live_bytes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = (5, 11, 40)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _requests(vocab, sampled):
    rng = np.random.default_rng(1)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32), 8,
                    temperature=1.3 if sampled else 0.0, seed=40 + i)
            for i, n in enumerate(PROMPTS)]


def _cfg(arch):
    return reduced(get_config(arch), **({"layers": 4} if arch.startswith("deepseek") else {}))


@pytest.mark.gpu
@pytest.mark.parametrize("burst", [1, 8])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch,per_call", [("olmo-1b", False), ("olmo-1b", True),
                                           ("deepseek-v3-671b", False)],
                         ids=["olmo", "olmo-per-call", "deepseek"])
def test_captured_serving_bitwise_equal_to_uncaptured(cuda, smoke, arch, per_call, sampled,
                                                      burst):
    cfg = _cfg(arch)
    model = get_model(cfg)
    params = smoke.scaled_init(model)
    make = lambda capture: BatchedServer(model, smoke.kernel_ctx(), params,  # noqa: E731
                                         slots=2, max_len=64, burst=burst, device=cuda,
                                         prepare_weights=not per_call, capture=capture)
    server = make(True)
    smoke.zero_launches()
    reqs = _requests(cfg.vocab_size, sampled)
    got = server.run(reqs)
    smoke.graph_accounting(arch, server, cfg, reqs, per_call)
    assert server.graph_replays == len(PROMPTS) + server.decode_steps // burst
    assert set(server.programs.graphs) >= {f"burst {'sampled' if sampled else 'greedy'}"}
    assert pool_live_bytes(server.programs.pool) == 0
    eager = make(False)
    smoke.zero_launches()
    eager_reqs = _requests(cfg.vocab_size, sampled)
    want = eager.run(eager_reqs)
    smoke.uncaptured_accounting(arch, eager, cfg, eager_reqs, per_call)
    assert got == want
    assert [r.margins for r in reqs] == [r.margins for r in eager_reqs]
    # the graphs replay as they ran: a second run on the captured server
    # issues no launch from the host
    captured = frozenset(server.programs.graphs)
    smoke.zero_launches()
    again_reqs = _requests(cfg.vocab_size, sampled)
    assert server.run(again_reqs) == got
    smoke.graph_accounting(arch, server, cfg, again_reqs, per_call, captured)
    assert [r.margins for r in again_reqs] == [r.margins for r in reqs]


@pytest.mark.gpu
def test_capture_builds_nothing_and_leaves_the_pool_scratch(cuda, smoke):
    cfg = _cfg("olmo-1b")
    model = get_model(cfg)
    server = BatchedServer(model, smoke.kernel_ctx(), smoke.scaled_init(model), slots=2,
                           max_len=64, burst=4, device=cuda)
    server.run(_requests(cfg.vocab_size, False)[:1])
    built = lazy_state()
    assert built[0]  # the AF tables exist
    server.run(_requests(cfg.vocab_size, True))  # captures more buckets and the sampled burst
    assert lazy_state() == built
    assert pool_live_bytes(server.programs.pool) == 0


@pytest.mark.gpu
def test_graphs_replay_right_in_any_order(cuda, smoke):
    report = smoke.replay_order(cuda)
    assert [o["identical"] for o in report["orders"]] == [True] * len(smoke.ORDERS)
