"""``chip_smoke.py``'s tp group rehearsed on the CPU: its serving helper
(``tp_serve``) on reduced configs, on spawned gloo ranks, with the kernel
wrappers' plain versions counting the launches the wrappers would make, so
that the phase's own exact launch check runs here."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_mamba2 import one_torch_thread  # noqa: E402, F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_tp_phase_rehearses_on_the_cpu(smoke):
    """``chip_smoke.tp_serve`` on reduced configs, the plain versions counting
    the launches their wrappers would make: on (1,2), (2,1) and, for the MoE
    archs, (1,2) of spawned gloo ranks, every rank's streams, f32 margins and
    forward logits equal the one-device run's, and each run's launches by
    instantiation pass the phase's own exact check (column dots fused, row
    dots partial-sum + epilogue)."""
    import _tp_ranks
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import spawn

    sizes = dict(MAX_LEN=64, BUCKET=32, PROMPT_LENS=(3, 17, 6, 13, 30, 9), TP_MAX_NEW=6)
    undo = _tp_ranks.count_plain_launches(smoke, sizes)
    try:
        runs = [(reduced(get_config("olmo-1b")), ((1, 2), (2, 1)), (1, 32)),
                (reduced(get_config("llama4-maverick-400b-a17b")), ((1, 2),), None),
                (reduced(get_config("deepseek-v3-671b"), layers=4), ((1, 2),), None)]
        for cfg, shapes, forward in runs:
            base = smoke.tp_serve(cfg, None, "cpu", forward)
            for shape in shapes:
                job = dict(cfg=cfg, mesh=shape, forward=forward)
                for rep in spawn(_tp_ranks.smoke_rank, shape[0] * shape[1],
                                 args=(str(ROOT), sizes, job), timeout=240):
                    assert rep["streams"] == base["streams"], (cfg.name, shape)
                    assert rep["margins"] == base["margins"], (cfg.name, shape)
                    if forward:
                        assert rep["forward"]["logits"] == base["forward"]["logits"]
                    if shape[1] > 1:
                        assert rep["launches"]["fused_dot_partial"] == rep["launches"][
                            "fused_epilogue"] > 0
    finally:
        undo()
