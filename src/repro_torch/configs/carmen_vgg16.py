"""VGG-16 layer schedule (paper Fig. 4: layer-wise execution time / power;
port of ``repro.configs.carmen_vgg16``).

Captured as (name, kind, shape params) so that the fig4 benchmark can
compute per-layer MAC counts and run the precision-aware schedule over it.
Input 224x224x3, standard VGG-16 D configuration.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    in_ch: int
    out_ch: int
    spatial: int  # output H=W
    kind: str = "conv3x3"

    @property
    def macs(self) -> int:
        if self.kind == "conv3x3":
            return self.spatial * self.spatial * self.out_ch * self.in_ch * 9
        return self.in_ch * self.out_ch  # fc


VGG16_LAYERS: Tuple[ConvSpec, ...] = (
    ConvSpec("conv1_1", 3, 64, 224),
    ConvSpec("conv1_2", 64, 64, 224),
    ConvSpec("conv2_1", 64, 128, 112),
    ConvSpec("conv2_2", 128, 128, 112),
    ConvSpec("conv3_1", 128, 256, 56),
    ConvSpec("conv3_2", 256, 256, 56),
    ConvSpec("conv3_3", 256, 256, 56),
    ConvSpec("conv4_1", 256, 512, 28),
    ConvSpec("conv4_2", 512, 512, 28),
    ConvSpec("conv4_3", 512, 512, 28),
    ConvSpec("conv5_1", 512, 512, 14),
    ConvSpec("conv5_2", 512, 512, 14),
    ConvSpec("conv5_3", 512, 512, 14),
    ConvSpec("fc6", 25088, 4096, 1, "fc"),
    ConvSpec("fc7", 4096, 4096, 1, "fc"),
    ConvSpec("fc8", 4096, 1000, 1, "fc"),
)

CONFIG = VGG16_LAYERS
