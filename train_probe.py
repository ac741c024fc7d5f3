"""Peak memory and time of one flagship train step, by remat segments.

    python3 train_probe.py

Needs one CUDA card.  One GSRL step of DeepLabV3-R50 (os 8, deepsup,
f32, cuDNN TF32 on as PyTorch's default) through ``make_train_step``,
with ``remat_segments`` 0, 2 and 4, at batch 2 x 129^2 and at the
recipe's batch 8 x 769^2.  Each configuration runs once to warm up, then
three times measured: ``max_memory_allocated`` after
``reset_peak_memory_stats`` and the host time of each step ending in
``torch.cuda.synchronize``.
Prints one JSON line per configuration.  Then ``torch.profiler`` over
two recipe steps without remat: the device's busy share of the wall
time, kernel time by class and the top kernels.
"""

import json
import re
import time

import numpy as np
import torch

import chip_smoke as cs
from dcfp_tpu_torch.engine.optim import build_optimizer
from dcfp_tpu_torch.engine.trainer import create_train_state, make_train_step
from dcfp_tpu_torch.graph.apply import init_graph
from dcfp_tpu_torch.losses.criteria import build_criterions
from dcfp_tpu_torch.models.registry import build_model


# kernel name -> class; batch norm first (cuDNN's BN kernels say cudnn)
CLASSES = [("batch norm", r"bn_|batch_?norm"),
           ("convolution", r"conv|fprop|dgrad|wgrad|implicit"),
           ("matmul", r"gemm|nvjet"),
           ("elementwise, reductions, copies", r".")]


def profile_step(step_fn, n=2):
    from torch.profiler import ProfilerActivity, profile
    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = {}
    for avg in prof.key_averages():
        if avg.device_type == torch.autograd.DeviceType.CUDA:
            kern[avg.key] = (kern.get(avg.key, 0.0)
                             + avg.self_device_time_total / 1e3 / n)
    by_class = {}
    for name, ms in kern.items():
        cls = next(c for c, pat in CLASSES if re.search(pat, name.lower()))
        by_class[cls] = by_class.get(cls, 0.0) + ms
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "profile": "recipe step", "steps": n, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy, "device_busy_share": busy / wall_ms,
        "ms_per_step_by_class": by_class,
        "top_kernels_ms_per_step": [[k[:90], v] for k, v in top]}),
        flush=True)


def main():
    cs.phase_device()
    torch.backends.cudnn.allow_tf32 = True
    model = build_model("deeplabv3", **cs.FLAGSHIP_CFG)
    params, state = init_graph(model.graph, torch.Generator().manual_seed(0),
                               device="cuda")
    crit = build_criterions("gsrl", ignore_label=255)
    for n, hw in ((2, 129), (8, 769)):
        batch = cs._train_batch(np.random.default_rng(4), n, hw,
                                compact=False)
        for segs in (0, 2, 4):
            opt = build_optimizer(optim="sgd", learning_rate=0.01,
                                  num_steps=100)
            st = create_train_state(model, params, state, opt, device="cuda")
            step = make_train_step(model, crit, opt, device="cuda",
                                   remat_segments=segs)
            step(st, batch, torch.Generator().manual_seed(5))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                step(st, batch, torch.Generator().manual_seed(5))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({"batch": [n, hw, hw], "remat_segments": segs,
                              "allocated_before_bytes": base,
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "step_ms": ms,
                              "median_ms": float(np.median(ms))}), flush=True)
            if (n, segs) == (8, 0):
                profile_step(lambda: step(st, batch,
                                          torch.Generator().manual_seed(5)))
            del st, step


if __name__ == "__main__":
    main()
