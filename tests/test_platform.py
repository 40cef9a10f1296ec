"""Compile-cache placement and the device peak table."""

import glob
import os
import sys

import jax
import pytest

from rangeclip.utils import platform
from rangeclip.utils.profiling import DEVICE_PEAKS, device_peaks


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_env_is_left_to_jax(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compilation_cache() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_defaults_to_a_fixed_path_in_the_checkout(monkeypatch,
                                                        restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache") == platform.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_peak_table_has_the_h100_datasheet_row():
    flops, bw = device_peaks(_Dev("NVIDIA H100 80GB HBM3"))
    assert (flops, bw) == (989e12, 3.35e12)
    assert len(DEVICE_PEAKS) == 1


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(_Dev(kind))


def test_bench_refuses_cpu():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import bench

    with pytest.raises(SystemExit, match="no"):
        bench.main()


# the package's former import names: each a directory rangeclip_<x>/ that
# aliases the package
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMER = sorted(os.path.basename(os.path.dirname(p)) for p in glob.glob(
    os.path.join(REPO, "rangeclip_*", "__init__.py")))


@pytest.mark.parametrize("statement", [
    "import {old}.models.depth_unet as m; "
    "import rangeclip.models.depth_unet as n; assert m is n",
    "from {old}.models.depth_unet import DepthUNet; "
    "from rangeclip.models import depth_unet; "
    "assert DepthUNet is depth_unet.DepthUNet",
    "import {old}, rangeclip; assert {old} is rangeclip",
])
def test_former_package_name_is_an_alias(statement):
    import subprocess

    assert FORMER, "no former package name found"
    for old in FORMER:
        proc = subprocess.run(
            [sys.executable, "-W", "always::DeprecationWarning", "-c",
             statement.format(old=old)],
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "renamed rangeclip" in proc.stderr
