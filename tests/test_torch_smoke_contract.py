"""``chip_smoke.py``'s failure contract and its replicated-kv and meshed
dry-run phases, on the CPU.

* Copied alone into an empty directory (no ``src/`` beside it), the script
  exits non-zero and its one stdout line is ``{"failed_phase": "setup",
  ...}`` naming the missing module; run from the repo on a machine without
  a card, the same line names the missing device.
* ``profile_names`` names a profile that came back empty.
* ``check_kv_replicated`` at its stock shapes, with the kernels' plain
  versions standing in (the CPU path of the wrappers) and the card timers
  patched out: its bitwise and tolerance gates pass, one row a shape.
* ``dryrun_mesh_cell`` runs its meshed dry-run cell in a subprocess and
  reads the record.
"""
import json
import os
import shutil
import subprocess
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


def _run(cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)


def test_smoke_alone_prints_its_failed_phase(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["failed_phase"] == "setup"
    assert line["error"].startswith("ModuleNotFoundError") and "repro_torch" in line["error"]


def test_smoke_without_a_card_prints_its_failed_phase():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert [json.loads(s) for s in proc.stdout.strip().splitlines()] == [
        {"failed_phase": "setup", "error": "RuntimeError: no CUDA device available"}]


def test_profile_names_names_an_empty_profile(smoke):
    with pytest.raises(AssertionError, match="decode profile: the profile came back empty"):
        smoke.profile_names("decode profile", [], {"fused_dot_af/narrow": 3,
                                                   "gqa_decode_attention/split": 0})
    assert smoke.profile_names("idle", [], {"fused_dot_af/narrow": 0}) == {}
    with pytest.raises(AssertionError, match="lacks"):
        smoke.profile_names("partial", [(5.0, "gqa_decode_split_kernel<128>", 1)],
                            {"fused_dot_af/narrow": 3, "gqa_decode_attention/split": 1})


def test_kv_replicated_phase_rehearsed_on_the_cpu(smoke, monkeypatch):
    """The phase's gates at its stock shapes on the CPU: each rank call's
    rows are the whole call's rows bitwise and within the tolerance of the
    plain version; every row has its bound and SDPA's time."""
    monkeypatch.setattr(smoke, "graph_ms", lambda fn, iters: (fn(), 0.0)[1])
    monkeypatch.setattr(smoke, "timed_ms", lambda fn, iters, warmup=3: (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rows = smoke.check_kv_replicated(torch.device("cpu"))
    assert len(rows) == len(smoke.KV_REPLICATED) * (len(smoke.KV_REPLICATED_GQA) + 1)
    assert all(r["bitwise_whole_rows"] and r["max_abs_err"] <= r["tolerance"] for r in rows)
    assert {(r["share"].split()[0], r["H"], r["kv_read"]) for r in rows} == {
        ("yi-9b", 4, 1), ("qwen3-8b", 2, 1)}
    assert [r["path"] for r in rows[:4]] == ["split keys"] + ["tensor cores"] * 3
    assert all(r["bound_ms"] > 0 and "sdpa_ms" in r for r in rows)


def test_dryrun_mesh_cell_rehearsed_on_the_cpu(smoke, monkeypatch, tmp_path):
    (tmp_path / "src").symlink_to(ROOT / "src")
    monkeypatch.setattr(smoke, "ROOT", tmp_path)
    rep = smoke.dryrun_mesh_cell()
    assert rep["status"] == "ok" and rep["mesh_shape"] == {"data": 16, "model": 16}
    assert set(rep["coll_by_kind"]) == {"all-reduce", "all-gather"}
    assert rep["fits_one_card"] is True
    assert (tmp_path / "chiprun_out" / "dryrun_mesh" / "ops").is_dir()
