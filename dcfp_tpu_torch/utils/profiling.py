"""Profiling / timing utilities (port of ``dcfp_tpu/utils/profiling.py``).

* ``sync(out)`` — wait for the card: kernels run in stream order, so
  synchronizing the devices of the outputs covers every launch before
  them.  Nothing to wait for on the CPU.
* ``timeit(fn, *args)`` — warmup-excluded wall-clock of a callable,
  each side of the timed block synchronized.
* ``trace(dir)`` — context manager around ``torch.profiler`` writing a
  Chrome trace, ``dir/trace.json``.
* ``flops_efficiency`` — achieved FLOP/s against an analytic FLOP count.
* ``card_name_and_power()`` — the first card's name and power limit, as
  ``nvidia-smi`` gives them; a time is written down beside it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Any, Callable, Dict

import torch


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def sync(out: Any) -> None:
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def timeit(fn: Callable, *args, warmup: int = 3, iters: int = 10,
           **kwargs) -> Dict[str, float]:
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    sync(out)
    dt = (time.perf_counter() - t0) / iters
    return {"ms": dt * 1000.0, "seconds": dt}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU ops, and the card's kernels where CUDA is
    available) and write ``log_dir/trace.json`` for chrome://tracing or
    Perfetto.  Yields the ``torch.profiler.profile``, whose
    ``key_averages()`` sums the time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def flops_efficiency(analytic_flops: float, seconds: float,
                     peak_tflops: float = 989.0) -> Dict[str, float]:
    """Achieved TFLOP/s and fraction of peak (defaults to the H100 SXM's
    dense bf16 tensor-core rate at its 700 W limit)."""
    achieved = analytic_flops / seconds / 1e12
    return {"tflops": achieved, "fraction_of_peak": achieved / peak_tflops}


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
