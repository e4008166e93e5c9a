"""PyTorch port: llama4-maverick's interleaved dense/MoE ``pair`` segment
against the reference, kernel mode, on the CPU.

The reduced variant of ``test_torch_archs.py`` (H10/KV2, head_dim 32) at 2
layers is one pair: a dense layer (``d_ff_dense``) and an MoE layer of 4
experts, top-1, with a shared expert, stacked as one entry with a ``dense``
and a ``moe`` sublayer, its cache one per sublayer. It runs that file's
decode-step, serving and forward tests (imported below, so collected here
with this module's ``arch`` fixture), then the pair's names: the dot weights
``prepare_params`` formats and the calibration scan's groups.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.runtime.calibrate as jax_calibrate  # noqa: E402
from repro.core.backends import iter_dot_weights as jax_iter_dot_weights  # noqa: E402
import repro_torch.runtime.calibrate as calibrate  # noqa: E402
from repro_torch.core.backends import iter_dot_weights  # noqa: E402
from test_torch_archs import (  # noqa: E402, F401  (the shared tests, collected here)
    build,
    test_decode_step_logits_match_reference,
    test_forward_matches_reference,
    test_greedy_streams_identical_to_reference,
    test_variant_keeps_the_arch_head_groups,
)
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

SENS_RTOL = 1e-3
# the scan's groups held against the reference: a pair sublayer's, keyed by
# its parameter path, and the lm_head
SCAN_GROUPS = ("layer.moe.moe.shared.up", "lm_head")


@pytest.fixture(scope="module")
def arch():
    return build("llama4-maverick-400b-a17b")


def _entries(it):
    return [(tuple(keys), name, stacked, in_axes) for keys, name, _, stacked, in_axes in it]


def test_dot_weights_match_reference(arch):
    """``iter_dot_weights`` on the pair's raw and prepared trees yields the
    reference's leaves, names and order: both sublayers' projections under
    their parameter paths (``layer.dense.attn.q``, ...), the shared expert,
    and not the routed experts' stacked banks, which run as plain einsums."""
    ref_specs, specs = arch["ref_model"].specs(), arch["model"].specs()
    for jtree, tree in ((arch["jraw"], arch["raw"]), (arch["jprepared"], arch["prepared"])):
        want = _entries(jax_iter_dot_weights(jtree, specs=ref_specs))
        assert _entries(iter_dot_weights(tree, specs=specs)) == want
    names = [name for _, name, _, _ in want]
    assert "layer.dense.mlp.up" in names and "layer.moe.moe.shared.up" in names
    assert not any(keys[-2:] in (("moe", "up"), ("moe", "gate"), ("moe", "down"))
                   for keys, _, _, _ in want)


def _scan_groups(iterate):
    def groups(params, *, specs=None):
        return (entry for entry in iterate(params, specs=specs) if entry[1] in SCAN_GROUPS)
    return groups


def test_calibration_scan_matches_reference(arch, monkeypatch):
    """The startup scan per call on the pair, both packages' own
    ``calibration_scan`` over ``SCAN_GROUPS`` (one forward each: the
    reference's per-call forwards take seconds apiece on the CPU), against
    the reference's sensitivities. Inside a pair both sublayers run under the
    runtime name ``"layer"``, so a demotion keyed by a parameter path
    (``layer.moe.moe.shared.up``; the dot runs as ``layer.moe.shared.up``)
    matches no dot and its group's sensitivity is 0 in both packages; the
    lm_head's is not."""
    monkeypatch.setattr(jax_calibrate, "iter_dot_weights", _scan_groups(jax_iter_dot_weights))
    monkeypatch.setattr(calibrate, "iter_dot_weights", _scan_groups(iter_dot_weights))
    tokens = np.random.default_rng(5).integers(0, arch["model"].cfg.vocab_size, (1, 8))
    want = jax_calibrate.calibration_scan(arch["ref_model"], arch["jraw"],
                                          tokens.astype(np.int32), mode="kernel")
    got = calibrate.calibration_scan(arch["model"], arch["raw"], torch.from_numpy(tokens),
                                     mode="kernel")
    assert sorted(got) == sorted(want) == sorted(SCAN_GROUPS)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=SENS_RTOL, err_msg=name)
    assert {n for n, v in got.items() if v > 0} == {"lm_head"}
