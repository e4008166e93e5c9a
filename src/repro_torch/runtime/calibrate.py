"""The serving-side sensitivity scan: calibrate a policy at server startup
(port of ``repro.runtime.calibrate``).

Demote one engine-dot group (every stacked layer of, e.g., ``layer.mlp.up``
shares a policy name) to approximate depth, run the calibration batch
through the cache-free ``forward``, and record the normalized logit
perturbation: one forward per group and one at full depth. The result feeds
``assign_depths``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.backends import iter_dot_weights
from repro_torch.core.cordic import approx_depth, full_depth
from repro_torch.core.engine import EngineContext
from repro_torch.core.fxp import FXP8, FxPFormat
from repro_torch.core.precision_policy import LayerPrecision, PrecisionPolicy

__all__ = ["calibration_scan"]


def calibration_scan(model, params, tokens, *, fmt: FxPFormat = FXP8, mode: str = "kernel",
                     attn_impl: str = "xla") -> Dict[str, float]:
    """name -> normalized logit perturbation when that group runs approximate.

    ``tokens``: (B, S) calibration batch, on the device the forwards run on
    (a tensor; a numpy array runs on the CPU). ``params`` are raw weights:
    the per-call engine path (no prepare, the scan runs once at startup,
    before the bank is built). ``attn_impl`` names which of the reference's
    attention lowerings the forwards use; its default ``"xla"`` is the
    reference's behaviour, ``"flash"`` runs the flash kernels.
    """
    names = sorted({name for _, name, _, _, _ in iter_dot_weights(params, specs=model.specs())})
    if isinstance(params, dict) and "lm_head" not in params and "embed" in params:
        names.append("lm_head")
    batch = {"tokens": torch.as_tensor(tokens).to(torch.int64)}

    def logits_at(policy: PrecisionPolicy) -> np.ndarray:
        ctx = EngineContext(mode=mode, policy=policy, compute_dtype=torch.float32,
                            attn_impl=attn_impl)
        with torch.no_grad():
            out, _ = model.forward(params, batch, ctx)
        return out.to(torch.float32).cpu().numpy()

    accurate = LayerPrecision(fmt, full_depth(fmt))
    base = logits_at(PrecisionPolicy(accurate))
    base_norm = float(np.linalg.norm(base)) + 1e-9

    sens: Dict[str, float] = {}
    demoted = LayerPrecision(fmt, approx_depth(fmt))
    for name in names:
        perturbed = logits_at(PrecisionPolicy(accurate, {name: demoted}))
        sens[name] = float(np.linalg.norm(perturbed - base)) / base_norm
    return sens
