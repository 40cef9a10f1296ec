"""Numerical-health monitoring.

Reference: utils/src/log_utils.py:80-121 (``validate_tensor`` NaN/Inf/
extreme-value checker), train_util.py:35-36 (``contains_nan``).

Plus additions the reference lacks: a step timer and a
``jax.profiler`` trace context for capturing device profiles.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np


def contains_nan(x) -> bool:
    return bool(jnp.isnan(jnp.asarray(x)).any())


def validate_tensor(
    x,
    name: str = "tensor",
    extreme: float = 1e8,
    raise_on_error: bool = False,
) -> Dict[str, float]:
    """Check for NaN/Inf/extreme magnitudes; returns summary stats.

    (log_utils.py:80-121 semantics: report rather than silently continue.)
    """
    arr = np.asarray(x, dtype=np.float64)
    stats = {
        "nan": float(np.isnan(arr).sum()),
        "inf": float(np.isinf(arr).sum()),
        "extreme": float((np.abs(arr[np.isfinite(arr)]) > extreme).sum()),
        "min": float(np.nanmin(arr)) if arr.size else 0.0,
        "max": float(np.nanmax(arr)) if arr.size else 0.0,
        "mean": float(np.nanmean(arr)) if arr.size else 0.0,
    }
    bad = stats["nan"] or stats["inf"] or stats["extreme"]
    if bad:
        msg = (
            f"validate_tensor[{name}]: nan={stats['nan']:.0f} "
            f"inf={stats['inf']:.0f} extreme={stats['extreme']:.0f} "
            f"range=[{stats['min']:.3e}, {stats['max']:.3e}]"
        )
        if raise_on_error:
            raise FloatingPointError(msg)
        print(f"Warning: {msg}")
    return stats


class StepTimer:
    """Wall-clock step timing with warmup exclusion (for maps/sec)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace context (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


def log_device_usage(log_fn=print) -> dict:
    """Per-device memory stats (the reference's ``log_gpu_usage``,
    validate.py:19-22, for any backend).  Returns {device: stats} and
    logs a one-line summary; devices without memory_stats report {}."""
    out = {}
    for dev in jax.local_devices():
        try:
            stats = dev.memory_stats() or {}
        except Exception:
            stats = {}
        out[str(dev)] = stats
        used = stats.get("bytes_in_use")
        limit = stats.get("bytes_limit")
        if used is not None:
            pct = f" ({100 * used / limit:.1f}%)" if limit else ""
            log_fn(f"[{dev}] memory in use: {used / 2**20:.1f} MiB{pct}")
    return out
