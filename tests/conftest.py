# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device.  Multi-device tests spawn subprocesses that set
# --xla_force_host_platform_device_count themselves.
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); skips without one")
