"""PyTorch port: the olmo-1b config equals the reference's, field for field."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402


@pytest.mark.parametrize("variant", ["stock", "reduced", "reduced_3x64"])
def test_olmo_config_matches_reference(variant):
    port, ref = get_config("olmo-1b"), ref_get_config("olmo-1b")
    if variant == "reduced":
        port, ref = reduced(port), ref_reduced(ref)
    elif variant == "reduced_3x64":
        port, ref = reduced(port, layers=3, d_model=64), ref_reduced(ref, layers=3, d_model=64)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.kv_groups == ref.kv_groups


def test_dtype_map():
    cfg = get_config("olmo-1b")
    assert cfg.compute_dtype == torch.bfloat16
    assert reduced(cfg).compute_dtype == torch.float32
    assert dataclasses.replace(cfg, dtype="float32").compute_dtype == torch.float32


def test_registry_holds_only_ported_archs():
    assert sorted(ARCHS) == ["olmo-1b"]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("qwen3-8b")
