"""The standalone multi-AF block: Hopper kernels and plain versions."""
from repro_torch.core.activations import ELEMENTWISE_AFS

from .ops import af_index, af_softmax, multi_af
from .ref import af_softmax_ref, multi_af_ref

__all__ = ["ELEMENTWISE_AFS", "af_index", "af_softmax", "af_softmax_ref", "multi_af",
           "multi_af_ref"]
