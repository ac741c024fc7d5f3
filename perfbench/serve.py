"""Serving cells: a closed loop of clients that each send a frame, wait
for its labels on the host, and send the next.

The system under test is the port's deploy path as ``deploy.sh`` and
``bench_torch.py`` run it: the graph at the configuration's widths
(``prune/pruner.apply_channel_cfg``), ``engine/deploy.
make_split_inference_fn`` (BN folded, bfloat16, NCHW, argmax labels
through K1) and ``aot_compile_split`` (body and tail replayed from CUDA
graphs).  A request copies its frame from pinned host memory into the
captured input, replays both graphs and copies the uint8 labels back to
pinned host memory; its latency spans all three.

What the window produced is judged after it closes: a sample of the
requests, drawn from the seed, keeps the labels it returned and the
body's low-resolution logits it computed; the plain reference
(:mod:`perfbench.reference.deeplab`, float32, TF32 off) recomputes each
sampled frame from the same weights, and :mod:`perfbench.checks` holds
the two against the cell's limits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import arith, checks, traffic as gen, weights
from perfbench.trace import Tracer, phase


def build(desc: dict, params, state, frame_shape, device):
    """The program's served function, captured at ``frame_shape``:
    (run(frame) -> device labels, the body's static logits, dev_params,
    graph)."""
    from dcfp_tpu_torch.engine.deploy import (aot_compile_split,
                                              make_split_inference_fn)
    from dcfp_tpu_torch.models.registry import build_model
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    model = build_model(desc["model"], backbone=desc["backbone"],
                        backbone_para=desc["backbone_para"],
                        num_classes=desc["num_classes"],
                        align_corner=desc["align_corner"],
                        deepsup=desc["deepsup"])
    graph = apply_channel_cfg(model.graph, desc["channel_cfg"])
    body_fn, tail_fn, dev_params = make_split_inference_fn(
        graph, params, state, dtype=torch.bfloat16, fold_bn=True,
        output="argmax", input_format="nchw", device=device)
    seen = {}

    def tail(logits, out_hw):
        seen["logits"] = logits  # the body's static output, read in place
        return tail_fn(logits, out_hw)

    compiled = aot_compile_split(body_fn, tail, dev_params,
                                 tuple(frame_shape), input_format="nchw",
                                 device=device)
    return (lambda frame: compiled(dev_params, frame)), seen, dev_params, \
        graph


def run(cell: str, desc: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device: torch.device, t_start: float,
        program=None, diagnose=None) -> dict:
    """One run of a serving cell; ``program`` replaces :func:`build` (the
    tests plant faults through it, and ``calibrate.py`` the control);
    ``diagnose`` sees each sampled frame's comparison."""
    from dcfp_tpu_torch.ops.kernels import LAUNCHES
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cudnn.benchmark = True  # deploy autotunes its convs
    phase("imports", t_start)
    params, state = weights.make(desc, seed, device)
    phase("weights", t_start)
    pool = gen.frames(traffic, seed, device)
    phase("pool", t_start)
    frame_shape = pool.shape[1:]
    served, seen, dev_params, graph = (program or build)(
        desc, params, state, frame_shape, device)
    phase("build", t_start)
    labels_host = torch.empty((frame_shape[0],) + tuple(frame_shape[2:]),
                              dtype=torch.uint8, pin_memory=cuda)

    def request(i):
        out = served(pool[i])
        labels_host.copy_(out)  # waits for the labels on the host
        return out

    def keep(slot, i):
        slot[0].copy_(labels_host)
        slot[1].copy_(seen["logits"])
        return (i, slot[0], slot[1])

    for i in range(traffic["warmup_requests"]):
        request(i % pool.shape[0])
    _sync(cuda)
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng([int(seed), 5])
    order = gen.request_order(traffic, seed, traffic["max_requests"])
    # the sample's copies, made before the window so that keeping one
    # allocates nothing inside it
    slots = [(torch.empty_like(labels_host), torch.empty_like(
        seen["logits"])) for _ in range(traffic["sample_max"] + 1)]
    kept = []
    lat = []
    k1_before = LAUNCHES["resize_argmax"]
    t0 = time.perf_counter()
    while len(lat) < len(order):
        i = order[len(lat)]
        a = time.perf_counter()
        request(i)
        b = time.perf_counter()
        lat.append(b - a)
        if rng.random() < traffic["sample_share"] and \
                len(kept) < traffic["sample_max"]:
            kept.append(keep(slots[len(kept)], i))
        if b - t0 >= seconds:
            break
    _sync(cuda)
    window_s = time.perf_counter() - t0
    n = len(lat)
    k1_launches = LAUNCHES["resize_argmax"] - k1_before
    kept.append(keep(slots[len(kept)], order[n - 1]))
    tracer = Tracer(trace)
    if trace:  # after the measured window, so that it costs it nothing
        with tracer.window():
            for j in range(traffic["trace_requests"]):
                request(order[(n + j) % len(order)])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    widths_off = checks.widths_off(desc, graph, dev_params)
    served = seen = dev_params = None
    if cuda:
        torch.cuda.empty_cache()
    hw = tuple(frame_shape[2:])
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference's f32
    torch.backends.cudnn.allow_tf32 = False
    found = checks.serve_outputs(desc, params, state, pool, kept, hw,
                                 device, diagnose)
    found["widths_off"] = float(widths_off)
    # K1 runs as the hand kernel on CUDA once a request (its plain
    # version on the CPU counts no launch)
    found["k1_launches_off"] = float(abs(k1_launches - (n if cuda else 0)))
    flops = 2 * arith.macs(desc, hw, frame_shape[0])
    out = {
        "attempted": n, "failed": 0, "setup_s": setup_s, "peak": peak,
        "e2e": {"serve_img_per_s": n * frame_shape[0] / window_s,
                "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "setup_s": setup_s},
        "found": found, "limits": limits,
        "ctx": {"flops_per_unit": flops, "peak_flops": arith.BF16_FLOPS,
                "unit_s": window_s / n,
                "k1_bound_s": arith.k1_bound_s(
                    frame_shape[0], desc["num_classes"],
                    *kept[0][2].shape[2:], *hw)},
    }
    if trace:
        out["window"] = tracer.result(traffic["trace_requests"])
    return out


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()
