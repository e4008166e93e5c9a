"""The paper's own MLP workload (Table V rows: "196-64-32-32-10"; port of
``repro.configs.carmen_mlp``).

This is the network the compared CORDIC accelerators (TCAS-I'22 [23],
ISCAS'25 [5], ICIIS'25 [1]) run: the fig3 accuracy sweep and the table5
scaling benchmark read it.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str = "carmen-mlp-196"
    layer_sizes: Tuple[int, ...] = (196, 64, 32, 32, 10)
    act: str = "sigmoid"  # the classic benchmark uses sigmoid hidden units


CONFIG = MLPConfig()
