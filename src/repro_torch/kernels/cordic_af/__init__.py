"""The standalone multi-AF block: Hopper kernel and plain version."""
from repro_torch.core.activations import ELEMENTWISE_AFS

from .ops import multi_af
from .ref import multi_af_ref

__all__ = ["ELEMENTWISE_AFS", "multi_af", "multi_af_ref"]
