"""The PyTorch port stands alone: it imports no JAX and nothing of ``repro``,
and its entry points never fall back to the CPU without being asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py")
    )


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods and len(mods) > 20
    assert {"repro_torch.configs.deepseek_v3_671b", "repro_torch.kernels.af_table",
            "repro_torch.kernels.cordic_af.ops", "repro_torch.kernels.cordic_af.ref",
            "repro_torch.models.mla", "repro_torch.core.mac", "repro_torch.kernels.int_dot",
            "repro_torch.kernels.cordic_mac", "repro_torch.kernels.cordic_mac.ops",
            "repro_torch.kernels.cordic_mac.ref", "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.mla_flash.ops", "repro_torch.runtime.calibrate",
            "repro_torch.serve.threefry", "repro_torch.serve.capture",
            "repro_torch.runtime.bank", "repro_torch.runtime.controller",
            "repro_torch.runtime.telemetry", "repro_torch.sim.calibrate",
            "repro_torch.spec.config", "repro_torch.spec.decoding", "repro_torch.spec.engine",
            "repro_torch.spec.rollback", "repro_torch.spec.telemetry",
            "repro_torch.resilience", "repro_torch.resilience.outcome",
            "repro_torch.resilience.degrade", "repro_torch.resilience.inject",
            "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
            "repro_torch.obs.observer", "repro_torch.core.backends.exact",
            "repro_torch.core.backends.carmen", "repro_torch.core.backends.int8",
            "repro_torch.serve.frontend", "repro_torch.sim.array", "repro_torch.sim.replay",
            "repro_torch.sim.analyze", "repro_torch.data.pipeline", "repro_torch.quant",
            "repro_torch.quant.qat", "repro_torch.train.optimizer",
            "repro_torch.train.checkpoint", "repro_torch.train.train_loop",
            "repro_torch.launch.train"} <= set(mods)
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) "
            "for k, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_statements(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {name}"


def test_server_without_device_raises_when_no_card(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import EngineContext
    from repro_torch.models import get_model
    from repro_torch.serve import BatchedServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model(reduced(get_config("olmo-1b")))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedServer(model, EngineContext(mode="kernel"), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedServer(model, EngineContext(mode="kernel"), params, device="cuda")


def test_trainer_and_calibration_default_to_the_card(monkeypatch):
    from repro_torch.launch import train
    from repro_torch.sim import calibrate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.measure(smoke=True)


def test_chip_smoke_refuses_to_run_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_library_check_spares_port_kernels():
    """The port's own kernels are never counted as library kernels, whatever
    their names hold ("flash", "attention_kernel"); library ones still are."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    port = [f"void (anonymous namespace)::{name}<float, 128>(float const*)"
            for name in chip_smoke.PORT_KERNELS]
    library = ["fmha_fwd_f32_aligned_64x128_sm80", "pytorch_flash::flash_fwd_kernel",
               "void at::native::sdpa_attention_kernel", "ampere_sgemm_128x64_nn",
               "cutlass_80_tensorop_s1688gemm"]
    rows = [(1.0, name, 2) for name in port + library]
    assert chip_smoke.library_kernels(rows, chip_smoke.ATTENTION_KERNELS) == [
        (name, 2) for name in library[:3]]
    assert chip_smoke.library_kernels(rows, chip_smoke.GEMM_KERNELS) == [
        (name, 2) for name in library[3:]]
