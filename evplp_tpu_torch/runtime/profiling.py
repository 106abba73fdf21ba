"""Per-pass timing and device traces (counterpart of the JAX package's
`runtime/profiling.py`).

`PassTimer`, when enabled, waits for the device after each pass and adds
the pass's host-clock milliseconds to its name; disabled, it only calls
the pass.  `device_trace` records a `torch.profiler` trace of the CPU and
the card into a directory (a Chrome trace, `trace.json`) and keeps the
profiler for `key_averages()`.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import fields, is_dataclass

import torch


def _devices(values) -> set:
    """The CUDA devices of every tensor in values (tensors, dataclasses,
    tuples, lists and dicts of them)."""
    out = set()
    stack = list(values)
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                out.add(v.device)
        elif is_dataclass(v) and not isinstance(v, type):
            stack.extend(getattr(v, f.name) for f in fields(v))
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return out


def fence(*values) -> None:
    """Wait until the work behind values is done: synchronize each CUDA
    device their tensors live on (CPU tensors are ready when returned)."""
    for dev in _devices(values):
        torch.cuda.synchronize(dev)


class PassTimer:
    """Accumulates per-pass wall ms.  Disabled: a plain call.  enabled
    None reads EVPLP_PROFILE=1 from the environment."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("EVPLP_PROFILE", "0") == "1"
        self.enabled = enabled
        self.ms = defaultdict(float)
        self.calls = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, *sync_values):
        """Time the block; sync_values are the tensors it leaves to fence
        on."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        fence(*sync_values)
        self.ms[name] += (time.perf_counter() - t0) * 1000.0
        self.calls[name] += 1

    def time_call(self, name: str, fn, *args, **kwargs):
        if not self.enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        fence(out)
        self.ms[name] += (time.perf_counter() - t0) * 1000.0
        self.calls[name] += 1
        return out

    def report(self) -> dict:
        return {k: {"ms_total": round(v, 2), "calls": self.calls[k],
                    "ms_avg": round(v / max(self.calls[k], 1), 2)}
                for k, v in sorted(self.ms.items())}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record the CPU and (where there is one) the card under
    torch.profiler; on exit the Chrome trace is written to
    log_dir/trace.json.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
