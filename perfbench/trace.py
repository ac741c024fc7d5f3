"""Reduction of a ``torch.profiler`` window to what the per-layer
readers take: device seconds by kernel name and by class, the device's
busy time (the union of its activity intervals), the window's wall
time, and the breakdown a traced result line carries (the longest
device operations, and the device's idle gaps by what the host was
doing meanwhile).

The kernel classes copy ``chip_smoke.py``'s ``_kernel_class`` (K1-K6 by
the hand kernels' names, convolutions by cuDNN's), with classes for
copies, batch norm, the optimizer's multi-tensor kernels and NCCL.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Tuple

import torch


def kernel_class(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy htod"):
        return "copy_h2d"
    if low.startswith("memcpy dtoh"):
        return "copy_d2h"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copy_other"
    if "nccl" in low:
        return "nccl"
    if "resize_argmax" in low:
        return "k1"
    if "stem_mma_kernel" in low or "stem_fma_kernel" in low:
        return "k2"
    if "bottleneck_kernel" in low:
        return "k3"
    if "::mm_kernel<" in low or "::transpose_kernel<" in low:
        return "k5"
    if "batch_norm" in low or "batchnorm" in low or "bn_fw" in low \
            or "bn_bw" in low:
        return "bn"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optim"
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "nchwtonhwc", "nhwctonchw", "xmma")):
        return "conv"
    if any(t in low for t in ("gemm", "gemv", "nvjet")):
        return "matmul"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


@dataclasses.dataclass
class Window:
    """A traced window: ``units`` requests or steps in ``window_s``."""
    units: int
    window_s: float
    busy_s: float
    kernels: Dict[str, float]        # device seconds by kernel name
    classes: Dict[str, float]        # device seconds by class
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def per_unit_ms(self, *classes: str):
        """Device ms a unit in ``classes``; ``None`` if none ran."""
        secs = [self.classes[c] for c in classes if c in self.classes]
        return sum(secs) / self.units * 1e3 if secs else None


def _union(intervals):
    busy, end = 0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        busy += e - s
    return busy, merged


MARK = "perfbench.window"


def reduce(prof, units: int, window_s: float) -> Window:
    """``prof``: a finished ``torch.profiler.profile`` holding one
    ``record_function(MARK)`` span, which bounds the window."""
    dev, host, mark = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s, d = ev.start_ns(), ev.duration_ns()
        name, on_card = ev.name(), (ev.device_type() ==
                                    torch.autograd.DeviceType.CUDA)
        if name == MARK:
            if not on_card:
                mark = (s, s + d)
        elif on_card:
            # annotations (this window's, a collective's) are spans of
            # host code mirrored on the card's timeline, not device work
            if not ev.is_user_annotation():
                dev.append((name, s, s + d))
        elif not name.startswith(("cuda", "Memcpy", "Memset")):
            host.append((name, s, s + d))
    t0, t1 = mark
    dev = [(n, max(s, t0), min(e, t1)) for n, s, e in dev
           if e > t0 and s < t1]
    kernels: Dict[str, float] = {}
    classes: Dict[str, float] = {}
    for name, s, e in dev:
        sec = (e - s) * 1e-9
        kernels[name] = kernels.get(name, 0.0) + sec
        c = kernel_class(name)
        classes[c] = classes.get(c, 0.0) + sec
    busy_ns, merged = _union([(s, e) for _, s, e in dev])
    gaps = []
    prev = t0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    # the longest gaps go to the outermost host op that covers their
    # midpoint; the rest are summed as one entry
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort(key=lambda h: h[1])
    idle: Dict[str, float] = {}
    for i, (gs, ge) in enumerate(gaps):
        label = "(shorter gaps)"
        if i < 64:
            mid, best, label = (gs + ge) // 2, -1, "host: no op"
            for name, s, e in host:
                if s > mid:
                    break
                if e >= mid and e - s > best:
                    best, label = e - s, name
        idle[label] = idle.get(label, 0.0) + (ge - gs) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Window(units, window_s, busy_ns * 1e-9, kernels, classes,
                  [[k[:120], v] for k, v in top],
                  [[k[:120], v] for k, v in top_idle])


class Tracer:
    """``with tracer.window(): ...`` profiles the calls inside, after
    the caller's warm-up, and marks the window's ends on the profiler's
    clock; ``tracer.result(units)`` reduces it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            _sync()
            dist = torch.distributed
            if dist.is_available() and dist.is_initialized():
                dist.barrier()  # every rank's profiler is up
                _sync()
            with torch.autograd.profiler.record_function(MARK):
                t0 = time.perf_counter()
                yield
                _sync()
                self.window_s = time.perf_counter() - t0
        self.prof = prof

    def result(self, units: int) -> Window:
        return reduce(self.prof, units, self.window_s)


def phase(name: str, t_start: float):
    """Print on standard error how far set-up has come at the end of
    each of its phases (seconds since the process started), so that a
    run whose set-up is slow shows where."""
    _sync()
    print(f"setup {name} {time.perf_counter() - t_start:.3f} s",
          file=sys.stderr, flush=True)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
