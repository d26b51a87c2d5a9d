"""The ``cuda`` marker for the benchmark's tests, as the repository's
tests register it, so that ``pytest sortbench`` alone knows it too."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); skips without one")
