"""Layer-wise precision / iteration-depth policy (port of ``repro.core.precision_policy``).

``PrecisionPolicy`` maps layer names to execution points and round-trips the
reference's JSON format, so a policy file loads in both packages. The
sensitivity scan waits for a later slice.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional

from . import cordic
from .fxp import FXP8, FxPFormat

__all__ = ["LayerPrecision", "PrecisionPolicy"]


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
