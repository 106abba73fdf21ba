"""Build native sources into shared libraries at first use, and check the
tensors handed to them.

A library is named after a hash of its compile command and source bytes, so
a stale build is never loaded, and lands in `build/evplp_tpu_torch/` at the
repository root, beside the compiler's output (`<library>.log`; for a CUDA
kernel, ptxas's report of its registers, spills and shared memory).  The
compiler writes to a temporary name that is `os.replace`d into place
under an exclusive file lock, so concurrent processes (test workers, a CLI
beside a test) neither collide nor load a half-written file.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

# -fmad=false: no fused multiply-add, so a kernel rounds op for op as its
# plain PyTorch version does; -Xptxas -v: ptxas reports each kernel's
# registers, spills and shared memory (kept in the library's log)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "evplp_tpu_torch")


def build_library(name: str, sources: list[str], compile_cmd: list[str],
                  headers: list[str] = ()) -> str:
    """Compile `sources` with `compile_cmd + ["-o", out] + sources` unless a
    library with the same hash (of the command, the sources and the headers
    they include) exists; return its path.  The compiler's output is kept
    in `<path>.log`.  Raises RuntimeError with it when the build fails."""
    h = hashlib.sha256(" ".join(compile_cmd).encode())
    for src in list(sources) + sorted(headers):
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
                with open(f"{tmp}.log", "w") as log:
                    log.write(proc.stdout + proc.stderr)
                os.replace(f"{tmp}.log", f"{path}.log")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def nvcc_command() -> list[str]:
    """nvcc and the flags every CUDA kernel of the port is built with."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return [cand] + NVCC_FLAGS
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def headers_beside(source: str) -> list[str]:
    """The CUDA headers (`*.cuh`) in the directory of `source`."""
    src_dir = os.path.dirname(source)
    return sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                  if f.endswith(".cuh"))


_libs: dict = {}
_lib_paths: dict = {}
_libs_lock = threading.Lock()


def load_cuda_library(name: str, source: str, signatures: dict) -> ctypes.CDLL:
    """Build `source` with nvcc at first use and load it once per process.
    The headers (`*.cuh`) beside the source are hashed with it, so an edit
    to one rebuilds every kernel.  signatures maps each exported function to
    its ctypes argtypes; every function returns the int of
    cudaGetLastError().  Callers on several threads may build different
    libraries at once."""
    with _libs_lock:
        lib = _libs.get(name)
    if lib is None:
        path = build_library(name, [source], nvcc_command(),
                             headers_beside(source))
        lib = ctypes.CDLL(path)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        with _libs_lock:
            lib = _libs.setdefault(name, lib)
            _lib_paths.setdefault(name, path)
    return lib


def _unmangled(name: str) -> str:
    """The innermost identifier of an Itanium-mangled name
    (`_ZN12_GLOBAL__N_16kernelEPKf` -> `kernel`), with the bool arguments
    of a template (`...6kernelILb1EEEv...` -> `kernel<true>`); other names
    as they are."""
    i = 3 if name.startswith("_ZN") else 2 if name.startswith("_Z") else 0
    last = name
    while i and i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        last, i = name[j:j + int(name[i:j])], j + int(name[i:j])
    args = re.match(r"I((?:Lb[01]E)+)E", name[i:]) if i else None
    if args:
        flags = re.findall(r"Lb([01])E", args.group(1))
        last += "<" + ", ".join("true" if f == "1" else "false"
                                for f in flags) + ">"
    return last


def ptxas_report(text: str) -> dict:
    """Each kernel (entry function) of ptxas's -v output `text`, by its
    unmangled name -> its registers, spill stores and loads, stack frame
    and static shared memory in bytes."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = dict(registers=0, spill_stores=0, spill_loads=0,
                              stack=0, smem=0)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[entry]["smem"] = int(s.group(1)) if s else 0
    return {_unmangled(k): v for k, v in out.items()}


def library_report(name: str) -> dict:
    """ptxas_report of the CUDA library loaded under `name` in this process
    ({} if its build kept no log)."""
    with _libs_lock:
        path = _lib_paths.get(name)
    if path is None or not os.path.exists(f"{path}.log"):
        return {}
    with open(f"{path}.log") as f:
        return ptxas_report(f.read())


def check_tensor(x: torch.Tensor, name: str, dtype, shape, device):
    """Raise unless x lies on device with this dtype and shape, contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
