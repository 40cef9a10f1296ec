"""Build the native preprocessing library with the system g++.

Usage: ``python -m rangeclip.native.build``
"""

from __future__ import annotations

import os
import subprocess


def build() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    srcs = [os.path.join(here, "preprocess.cpp"),
            os.path.join(here, "png_decode.cpp")]
    out = os.path.join(here, "libpreprocess.so")
    # Compile to a private temp path and rename into place: rename is
    # atomic, so concurrent builders (multiple loader worker processes on
    # a fresh checkout) can race without anyone dlopening a half-written
    # .so — the loser's rename just replaces the winner's identical file.
    tmp = f"{out}.tmp.{os.getpid()}"
    # No -march=native: a checkout may be copied to, and its library
    # loaded on, a host with another instruction set than the builder's.
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        *srcs, "-o", tmp, "-lz",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


if __name__ == "__main__":
    print(build())
