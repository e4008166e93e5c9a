"""PyTorch port: the ported configs (all ten archs: the seven transformer
decoders, the recurrent mamba2 and zamba2, the encoder-decoder seamless)
equal the reference's, field for field, stock and reduced."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401


def _variant(port, ref, variant):
    if variant == "reduced":
        return reduced(port), ref_reduced(ref)
    if variant == "reduced_3x64":
        return reduced(port, layers=3, d_model=64), ref_reduced(ref, layers=3, d_model=64)
    if variant == "reduced_4_layers":
        return reduced(port, layers=4), ref_reduced(ref, layers=4)
    return port, ref


@pytest.mark.parametrize("variant", ["stock", "reduced", "reduced_3x64"])
def test_olmo_config_matches_reference(variant):
    port, ref = _variant(get_config("olmo-1b"), ref_get_config("olmo-1b"), variant)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.kv_groups == ref.kv_groups


@pytest.mark.parametrize("variant", ["stock", "reduced", "reduced_3x64", "reduced_4_layers"])
def test_deepseek_config_matches_reference(variant):
    port, ref = _variant(get_config("deepseek-v3-671b"), ref_get_config("deepseek-v3-671b"),
                         variant)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.kv_groups == ref.kv_groups
    assert port.family == "moe" and port.mla is not None


NEW_ARCHS = ["qwen2.5-14b", "qwen3-8b", "yi-9b", "internvl2-2b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("variant", ["stock", "reduced", "reduced_3x64"])
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_transformer_config_matches_reference(name, variant):
    port, ref = _variant(get_config(name), ref_get_config(name), variant)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.kv_groups == ref.kv_groups


def test_dtype_map():
    cfg = get_config("olmo-1b")
    assert cfg.compute_dtype == torch.bfloat16
    assert reduced(cfg).compute_dtype == torch.float32
    assert dataclasses.replace(cfg, dtype="float32").compute_dtype == torch.float32


RECURRENT_ENCDEC_ARCHS = ["mamba2-780m", "zamba2-7b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("variant", ["stock", "reduced", "reduced_3x64", "reduced_4_layers"])
@pytest.mark.parametrize("name", RECURRENT_ENCDEC_ARCHS)
def test_recurrent_and_encdec_config_matches_reference(name, variant):
    port, ref = _variant(get_config(name), ref_get_config(name), variant)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.kv_groups == ref.kv_groups


def test_registry_holds_only_ported_archs():
    """All ten archs of the reference's registry, in its order; an unknown
    name raises."""
    from repro.configs import ARCHS as REF_ARCHS

    assert list(ARCHS) == list(REF_ARCHS)
    assert sorted(ARCHS) == sorted(["olmo-1b", "deepseek-v3-671b", *NEW_ARCHS,
                                    *RECURRENT_ENCDEC_ARCHS])
    for name in ARCHS:
        assert get_config(name) is ARCHS[name]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba3-1b")


def test_paper_workloads_match_reference():
    """The paper's own workloads: the fig3 MLP and the fig4 VGG-16 schedule,
    its 16 layers with their MAC counts."""
    from repro.configs import carmen_mlp as ref_mlp, carmen_vgg16 as ref_vgg
    from repro_torch.configs import carmen_mlp, carmen_vgg16

    assert dataclasses.asdict(carmen_mlp.CONFIG) == dataclasses.asdict(ref_mlp.CONFIG)
    assert len(carmen_vgg16.VGG16_LAYERS) == len(ref_vgg.VGG16_LAYERS) == 16
    for port, ref in zip(carmen_vgg16.VGG16_LAYERS, ref_vgg.VGG16_LAYERS):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.macs == ref.macs
    assert carmen_vgg16.CONFIG is carmen_vgg16.VGG16_LAYERS
