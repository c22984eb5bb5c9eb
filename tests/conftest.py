"""Test configuration: force a virtual 8-device CPU platform.

Multi-chip sharding paths (mesh/pjit/collectives) are exercised without TPU
hardware by asking XLA for 8 host-platform devices, the same mechanism the
driver uses for the multi-chip dry run.
"""

import os

# Must be set before jax initializes its backends. The environment may pin
# JAX_PLATFORMS to a hardware plugin, so override via both the env var and
# jax.config (the config setting wins over site customizations).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (whisperx_tpu_torch's CUDA kernels); skips without one"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
