"""Build native sources into shared libraries at first use.

A library is named after a hash of its compile command and source bytes, so
a stale build is never loaded, and lands in `build/evplp_tpu_torch/` at the
repository root.  The compiler writes to a temporary name that is
`os.replace`d into place under an exclusive file lock, so concurrent
processes (test workers, a CLI beside a test) neither collide nor load a
half-written file.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "evplp_tpu_torch")


def build_library(name: str, sources: list[str], compile_cmd: list[str]) -> str:
    """Compile `sources` with `compile_cmd + ["-o", out] + sources` unless a
    library with the same hash exists; return its path.  Raises
    RuntimeError with the compiler's output when the build fails."""
    h = hashlib.sha256(" ".join(compile_cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                tmp = f"{path}.tmp{os.getpid()}"
                proc = subprocess.run(compile_cmd + ["-o", tmp] + sources,
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"building {name} failed ({' '.join(compile_cmd)}):\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path
