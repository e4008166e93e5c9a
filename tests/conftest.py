import os

# Tests run on the single real CPU device. (The 512-device dry-run sets its own
# XLA_FLAGS before any jax import — see src/repro/launch/dryrun.py; it must NOT
# be set here.)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's kernels); skips without one"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
