"""Device-trace summarization and the device peak table.

``summarize_trace`` turns a ``jax.profiler.trace`` dump into a per-op
device-time table: it reads the newest ``*.xplane.pb`` under the trace
directory with ``jax.profiler.ProfileData`` (nothing beyond JAX), sums the
durations of the device's operations, and maps XLA instruction names back
to model ops via the compiled HLO's ``op_name`` metadata.  The reference
has no equivalent (torch.profiler was never wired up; SURVEY L6) — here it
is a library + ``cli/benchmark.py profile``.

Typical use::

    with jax.profiler.trace(dir):
        for _ in range(steps): jax.block_until_ready(fn(*args))
    rows = summarize_trace(dir, steps=steps,
                           hlo_text=jitted.lower(*args).compile().as_text())
    print(format_rows(rows))
"""

from __future__ import annotations

import collections
import glob
import os
import re
from typing import Dict, List, Optional, Tuple

# Published dense peaks per device kind, as ``jax.Device.device_kind``
# names it: (bf16 FLOP/s, memory bytes/s).  The denominator of every
# %-of-peak figure; a device kind not listed here is an error, never a
# default.
DEVICE_PEAKS: Dict[str, Tuple[float, float]] = {
    # NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def device_peaks(device) -> Tuple[float, float]:
    """(peak bf16 FLOP/s, peak memory bytes/s) of ``device``."""
    kind = getattr(device, "device_kind", str(device))
    if kind not in DEVICE_PEAKS:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add it to "
            f"rangeclip.utils.profiling.DEVICE_PEAKS with its source")
    return DEVICE_PEAKS[kind]


def latest_xplane(trace_dir: str) -> str:
    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                  recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return files[-1]


def op_names_from_hlo(hlo_text: str) -> Dict[str, str]:
    """Map instruction names (fusion.N, ...) to their ``op_name`` metadata
    (the JAX-level op path) from compiled-HLO text."""
    out: Dict[str, str] = {}
    for m in re.finditer(r"%([\w.\-]+) = [^\n]*?op_name=\"([^\"]+)\"",
                         hlo_text):
        out.setdefault(m.group(1), m.group(2))
    return out


# Plane-name prefix of each platform's device in an XSpace.
_DEVICE_PLANES = {"gpu": "/device:GPU:", "cpu": "/host:CPU"}


def device_op_events(profile, platform: str = "gpu"):
    """[(op, start_ns, duration_ns)] of the device's operations.

    ``profile`` is a ``jax.profiler.ProfileData``.  On the GPU an op is a
    kernel or copy on one of the device plane's stream lines, attributed
    to its HLO instruction through the event's ``hlo_op`` stat (a library
    call such as a cuDNN convolution may launch several kernels for one
    instruction); on the CPU, the XLA executor threads' events carry the
    same stat.  Raises when the trace holds no plane for ``platform``:
    a device that was expected and is missing must not be replaced by
    host threads.
    """
    prefix = _DEVICE_PLANES[platform]
    planes = [p for p in profile.planes if p.name.startswith(prefix)]
    if not planes:
        names = [p.name for p in profile.planes]
        raise ValueError(f"trace has no {platform} device plane "
                         f"({prefix}*); planes: {names}")
    out = []
    for plane in planes:
        for line in plane.lines:
            for e in line.events:
                stats = dict(e.stats)
                op = stats.get("hlo_op")
                if op and e.duration_ns > 0:
                    out.append((str(op), e.start_ns, e.duration_ns))
    return out


def busy_ns(events) -> float:
    """Length of the union of the events' [start, start + duration)."""
    total, end = 0.0, None
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if end is None or start >= end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def summarize_trace(
    trace_dir: str,
    steps: int = 1,
    hlo_text: Optional[str] = None,
    platform: str = "gpu",
    profile=None,
) -> List[Tuple[str, float, str]]:
    """Sum per-op device time from the newest trace in ``trace_dir`` (or
    from an already-loaded ``profile``).

    Returns [(instruction_name, ms_per_step, op_name)] sorted by cost.
    """
    if profile is None:
        from jax.profiler import ProfileData

        profile = ProfileData.from_file(latest_xplane(trace_dir))
    durs: collections.Counter = collections.Counter()
    for op, _, dur in device_op_events(profile, platform):
        durs[op] += dur
    name2op = op_names_from_hlo(hlo_text) if hlo_text else {}
    return [
        (name, dur / steps / 1e6, name2op.get(name, ""))
        for name, dur in durs.most_common()
    ]


def format_rows(
    rows: List[Tuple[str, float, str]], top: int = 20, op_width: int = 90
) -> str:
    total = sum(ms for _, ms, _ in rows)
    lines = [f"device total: {total:.2f} ms/step"]
    for name, ms, op in rows[:top]:
        tail = op[-op_width:] if op else ""
        lines.append(f"{ms:9.3f} ms  {name:28s} {tail}")
    return "\n".join(lines)
