"""``chip_smoke.py``'s tp group rehearsed on the CPU: its serving helper
(``tp_serve``) on reduced configs, on spawned gloo ranks, with the kernel
wrappers' plain versions counting the launches the wrappers would make, so
that the phase's own exact launch check runs here."""
import sys
from pathlib import Path

import numpy as np
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


def test_tp_split_and_scan_phases_rehearse_on_the_cpu(smoke):
    """The tp group's kernel-6 and scan phases (``chip_smoke.tp_phases``'
    olmo-1b int8 and per call, mamba2, zamba2, seamless) on reduced configs
    at (1,2), cut as the smoke cuts them (``TP_NEW_PROMPTS``,
    ``TP_NEW_MAX_NEW``), the plain versions counting: every rank's streams
    and f32 margins equal the one-device run's, and each run's launches by
    instantiation pass the phase's own exact check (kernel 6's row dots
    partial-sum + epilogue; the scan prefill's single-row steps)."""
    import _tp_ranks
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import spawn

    sizes = dict(MAX_LEN=64, BUCKET=32)
    undo = _tp_ranks.count_plain_launches(smoke, sizes)
    try:
        cut = dict(lens=smoke.TP_NEW_PROMPTS, max_new=smoke.TP_NEW_MAX_NEW)
        olmo = reduced(get_config("olmo-1b"))
        mac = ("cordic_mac_partial", "cordic_mac_epilogue")
        runs = [(olmo, dict(mode="int8"), mac), (olmo, dict(per_call=True), mac)]
        runs += [(reduced(get_config(name)), {}, ("fused_dot_partial", "fused_epilogue"))
                 for name in smoke.TP_SCAN_LAYERS]
        for cfg, kw, split in runs:
            base = smoke.tp_serve(cfg, None, "cpu", None, cut["max_new"], lens=cut["lens"], **kw)
            job = dict(cfg=cfg, mesh=(1, 2), **cut, **kw)
            for rep in spawn(_tp_ranks.smoke_rank, 2, args=(str(ROOT), sizes, job), timeout=240):
                assert rep["streams"] == base["streams"], (cfg.name, kw)
                assert rep["margins"] == base["margins"], (cfg.name, kw)
                assert rep["launches"][split[0]] == rep["launches"][split[1]] > 0
    finally:
        undo()


def test_train_tp_phase_rehearses_on_the_cpu(smoke, tmp_path):
    """``chip_smoke.train_tp_rank`` on reduced olmo-1b (2 layers, batch 4 x
    16), spawned gloo ranks, the plain versions counting the launches their
    wrappers would make and standing in for the recorded launch functions:
    every run's steps pass the phase's own gates against mesh=None (one
    rank at a time), the int8 run's kernel-6 launches by instantiation pass
    its exact check, its recorded split-form calls equal the plain
    versions, and the exact (1, 2) run's checkpoint restores on mesh=None
    bitwise."""
    import _tp_ranks
    from repro_torch.launch.mesh import spawn

    sizes = dict(olmo=_tp_ranks.reduced_olmo, TRAIN_SEQ=16, TRAIN_BATCH=4,
                 TP_TRAIN_RECORD={"partial": "mac_matmul_partial_ref",
                                  "epilogue": "mac_epilogue_ref"})
    reps = spawn(_tp_ranks.smoke_train_rank, 2,
                 args=(str(ROOT), sizes, smoke.TP_TRAIN_RUNS, str(tmp_path / "ckpt")),
                 timeout=300)
    for label, shape, mode, _ in smoke.TP_TRAIN_RUNS:
        for rep in (ranks[label] for ranks in reps):
            assert len(rep["steps"]) == smoke.TP_TRAIN_STEPS
            assert all(np.isfinite(s["loss"]) for s in rep["steps"]), label
            if mode == "int8":
                assert set(rep["launches"]) == {"cordic_mac", "cordic_mac_partial",
                                                "cordic_mac_epilogue"}
                assert all(rep["bitwise_plain_calls"].values())
            else:
                assert rep["launches"] == {}
            assert rep.get("checkpoint_restores_bitwise", False) == (
                mode == "exact" and shape == (1, 2))
