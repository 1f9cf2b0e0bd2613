"""Shared fixtures. Deliberately does NOT set xla_force_host_platform_device_count:
smoke tests and benchmarks must see the real single CPU device (the 512
placeholder devices exist only inside repro.launch.dryrun)."""

import jax
import pytest


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration tests")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is unavailable")
