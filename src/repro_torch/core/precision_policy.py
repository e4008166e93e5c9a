"""Layer-wise precision / iteration-depth policy (port of ``repro.core.precision_policy``).

``PrecisionPolicy`` maps layer names to execution points and round-trips the
reference's JSON format, so a policy file loads in both packages.
``assign_depths`` turns per-layer sensitivities (``repro_torch.runtime``'s
calibration scan) into a policy that meets a cycle-reduction budget;
``pin_critical`` keeps the critical layers at full depth;
``sensitivity_scan`` is the reference's JVP estimate, through
``torch.func.jvp``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from . import cordic
from .fxp import FXP8, FxPFormat

__all__ = [
    "CRITICAL_KEYWORDS", "LayerPrecision", "PrecisionPolicy", "assign_depths", "pin_critical",
    "sensitivity_scan",
]

# layer-name fragments that always run at full depth
CRITICAL_KEYWORDS = ("router", "gate_logits", "norm", "embed")


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    """Per-layer execution point: FxP format + CORDIC iteration depth."""

    fmt: FxPFormat
    depth: int

    @property
    def mode(self) -> str:
        return "accurate" if self.depth >= cordic.full_depth(self.fmt) else "approximate"

    def to_json(self) -> Dict[str, int]:
        return {"bits": self.fmt.bits, "frac": self.fmt.frac, "depth": int(self.depth)}

    @staticmethod
    def from_json(d: Mapping[str, int]) -> "LayerPrecision":
        return LayerPrecision(FxPFormat(int(d["bits"]), int(d["frac"])), int(d["depth"]))


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Maps layer names to execution points; unlisted layers use ``default``."""

    default: LayerPrecision
    overrides: Mapping[str, LayerPrecision] = dataclasses.field(default_factory=dict)

    def for_layer(self, name: str) -> LayerPrecision:
        if name in self.overrides:
            return self.overrides[name]
        for key, lp in self.overrides.items():
            if key and key in name:
                return lp
        return self.default

    @staticmethod
    def uniform(fmt: FxPFormat = FXP8, depth: Optional[int] = None) -> "PrecisionPolicy":
        return PrecisionPolicy(LayerPrecision(fmt, depth or cordic.full_depth(fmt)))

    @staticmethod
    def accurate(fmt: FxPFormat = FXP8) -> "PrecisionPolicy":
        return PrecisionPolicy.uniform(fmt, cordic.full_depth(fmt))

    @staticmethod
    def approximate(fmt: FxPFormat = FXP8) -> "PrecisionPolicy":
        return PrecisionPolicy.uniform(fmt, cordic.approx_depth(fmt))

    def to_json(self) -> Dict:
        return {
            "default": self.default.to_json(),
            "overrides": {k: lp.to_json() for k, lp in self.overrides.items()},
        }

    @staticmethod
    def from_json(d: Mapping) -> "PrecisionPolicy":
        return PrecisionPolicy(
            LayerPrecision.from_json(d["default"]),
            {k: LayerPrecision.from_json(v) for k, v in d.get("overrides", {}).items()},
        )

    def save(self, path: str) -> None:
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")

    @staticmethod
    def load(path: str) -> "PrecisionPolicy":
        with open(path) as f:
            return PrecisionPolicy.from_json(json.load(f))


def pin_critical(policy: PrecisionPolicy, *,
                 critical: Sequence[str] = CRITICAL_KEYWORDS) -> PrecisionPolicy:
    """Hard accuracy floor: layers whose names hold a critical keyword run at
    full depth, however the rest of the policy demotes."""
    pinned = LayerPrecision(policy.default.fmt, cordic.full_depth(policy.default.fmt))
    # keyword floors first: for_layer's substring scan walks insertion order,
    # so a non-critical override key that substring-matches a critical layer
    # name cannot shadow the floor
    overrides: Dict[str, LayerPrecision] = {key: pinned for key in critical}
    for name, lp in policy.overrides.items():
        if any(k in name for k in critical):
            overrides[name] = LayerPrecision(lp.fmt, cordic.full_depth(lp.fmt))
        else:
            overrides[name] = lp
    return PrecisionPolicy(policy.default, overrides)


def sensitivity_scan(apply_fn: Callable, params, batch, layer_taps: Sequence[str], *,
                     fmt: FxPFormat = FXP8) -> Dict[str, float]:
    """Per-layer accuracy sensitivity on a calibration batch.

    ``apply_fn(params, batch, noise)`` must add ``noise[name] * eps`` at each
    tapped layer output (``noise`` maps names to scalar tensors). Returns
    name -> the norm of the output's derivative along a perturbation of one
    LSB of ``fmt`` at that tap, over the norm of the clean output. The
    reference's ``rng`` argument is unused there and not taken here."""
    base = apply_fn(params, batch, {})
    base_norm = torch.linalg.vector_norm(base.to(torch.float32)) + 1e-9
    zero = torch.zeros((), dtype=torch.float32)
    lsb = torch.full((), fmt.scale, dtype=torch.float32)
    out: Dict[str, float] = {}
    for name in layer_taps:
        _, jvp = torch.func.jvp(lambda eps, name=name: apply_fn(params, batch, {name: eps}),
                                (zero,), (lsb,))
        out[name] = float(torch.linalg.vector_norm(jvp.to(torch.float32)) / base_norm)
    return out


def assign_depths(sensitivities: Mapping[str, float], *, fmt: FxPFormat = FXP8,
                  cycle_reduction_target: float = 0.33,
                  critical: Sequence[str] = CRITICAL_KEYWORDS) -> PrecisionPolicy:
    """Greedy depth assignment meeting a cycle-reduction budget.

    Every layer moved to approximate depth saves ``1 - approx/full`` of its
    cycles; with uniform per-layer MAC counts, moving a fraction p of the
    layers saves p times that. Layers go approximate from the least
    sensitive up until the budget is met; critical-keyword layers never do.
    """
    full = cordic.full_depth(fmt)
    approx = cordic.approx_depth(fmt)
    per_layer_saving = 1.0 - approx / full
    names = sorted(sensitivities, key=lambda n: sensitivities[n])
    overrides: Dict[str, LayerPrecision] = {}
    saved = 0.0
    n = max(len(names), 1)
    for name in names:
        if any(k in name for k in critical):
            continue
        if saved >= cycle_reduction_target:
            break
        overrides[name] = LayerPrecision(fmt, approx)
        saved += per_layer_saving / n
    return PrecisionPolicy(LayerPrecision(fmt, full), overrides)
