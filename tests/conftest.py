"""Test configuration.

Forces JAX onto the host CPU backend with 8 virtual devices so that
multi-device sharding (Mesh/shard_map) is exercised without a card.
Must run before jax initializes a backend, hence the env mutation at import
time of this conftest (pytest imports it first).

Tests marked ``gpu`` run their work in a child process on an NVIDIA card
through the ``gpu_env`` fixture, which skips them on a host without one.
"""

import os
import subprocess
import sys

import pytest

# The environment as the test run was started, before the CPU pin below:
# what a child process on the card inherits.
_STARTING_ENV = dict(os.environ)

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import jax  # noqa: E402

# Wins over any platform chosen before this conftest was imported, pinning
# tests to the 8-virtual-device CPU backend.
jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the NVIDIA card.

    Skips the test when ``nvidia-smi`` lists no GPU; asks no JAX backend,
    so the test process itself stays on the CPU.
    """
    try:
        listing = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no NVIDIA GPU on this host (nvidia-smi not found)")
    if listing.returncode != 0 or "GPU" not in listing.stdout:
        pytest.skip("no NVIDIA GPU on this host")
    env = dict(_STARTING_ENV)
    if env.get("JAX_PLATFORMS") == "cpu":
        del env["JAX_PLATFORMS"]
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_force_host_platform_device_count"))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p)
    return env
