"""On-card smoke test of the PyTorch/CUDA port (``dcfp_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100, ``sm_90a``) and ``nvcc``; it
exits non-zero without them.  Phases, each of which raises on failure:

1. device: name, power limit, torch/CUDA versions;
2. build: compile every kernel of the port from ``dcfp_tpu_torch/csrc/``
   with nvcc, one process per source, in parallel: resize-argmax (K1),
   the stem conv (K2), the fused bottleneck (K3), the fused ASPP
   branches (K4), the tiled matmul (K5), the int8 chain (K6) and the
   conv epilogue;
3. each kernel against its plain PyTorch version on the card: K1 over
   the deploy shape, the JAX package's kernel test cases and shapes off
   its tiles and channel chunks (``K1_ODD``), timed in a CUDA graph and
   through its wrapper; K2 over
   tests/test_stem.py's shapes, batch 2 and the deploy shape, against
   cuDNN's stem conv on the deploy image, and on shapes off its runs,
   chunks and routes (``K2_ODD``: odd Wp, cout 42, 128 and 2048, cin 1
   and 2, batch 2 at the deploy width, phases 2 bytes off 4), timed in a
   CUDA graph and with CUDA events; K3 over tests/test_bottleneck.py's
   cases, and, as its probe (tools/exp_bottleneck.py) does, at the pruned
   DeepLabV3-R101's layer3 and layer4 shapes beside the cuDNN chain;
   each kernel timed beside its bound, plain and library times;
4. the DeepLabV3-R50 forward on the card (f32, TF32 off) against the
   port's own CPU run on the same params, from NHWC and from phase planes;
5. serving: DeepLabV3-R101 (the bench configuration) pruned to 50% FLOPs,
   BN folded, bf16, batch 1, 1025x2049, argmax output through K1; answers
   4 requests from NCHW images and the same 4 from their phase planes
   (stem conv through K2), checks K1 (and K2) ran once per request, and
   times both paths and the unpruned model with the ``totrt.py`` protocol;
5b. the conv epilogue (``phase_epilogue``) on the serving cell's pruned
   R101 body: every launch shape against the plain version (bf16 within
   1 ulp) and the scalar path (19 channels, operands off 16 bytes, f16,
   f32); a frame's 115 launches timed beside their bound, the plain
   version and the aten passes they replace; 115 launches a captured
   request and no aten add or clamp kernel in its profile; the deploy
   artifact exported with the operator in it and reloaded;
6. the probes, after serving (every bf16 cuDNN yardstick autotuned):
   K3 at the pruned layer3/layer4 shapes; the int8 probe's stage A (K5 at
   1024^3, a ragged M and a skinny M, int8 exact and bf16 within
   1e-5 x (|a| @ |b|), beside ``torch._int_mm``, bf16-out ``matmul`` and
   f32-out ``torch.mm(..., out_dtype=torch.float32)``, K5's own function) and
   stage B (K6 bit-equal to its plain version at the probe's shape and
   the pruned layer3's, and over an 8-block chain with 8 launches, beside
   the bf16 cuDNN chain); the ASPP probe's stages N and B (K4 within 1
   bf16 ulp + 1e-5 x sum|x w| of the plain f32 result on 40x61x256 and on
   the served pruned R101's layer4 output with its own ASPP weights,
   beside the three cuDNN branches); K3, K5 (both B routes), K6 and K4
   also on shapes off every tile of theirs (K6 with Cm 80 and W below a
   tile; K4 with W below a tile and with tiles whose d = 36 branch keeps
   only its centre tap);
7. the int8 PTQ deploy (``phase_int8``) of the served pruned R101 at
   1025x2049, bf16 compute, calibrated on 4 seeded images: the int32
   accumulators of five convs (stem, 1x1, strided, dilation 36, the
   ASPP projection) through K5 equal to the float64 conv of the same
   int8 input; on 4 requests K5 once an int8 conv (115 a frame) and K1
   once a frame; labels against the bf16 deploy's (agreement >= 0.9);
   both timed with the ``totrt.py`` protocol, and a device profile of
   the int8 request;
8. the forward-traced prune topology (``phase_prune_trace``): the
   flagship train graph traced at 512x512 on fake tensors
   (``prune/fx_trace.py``), no mismatch against the IR trace; prune.sh's
   command with ``--trace verify`` and with ``--trace ir`` on one
   snapshot, byte-equal files;
9. the train step (``phase_train``), which launches none of K1-K6: one
   flagship (DeepLabV3-R50, deepsup) GSRL + EIC + SGD step on the card
   against the same step on the CPU (batch 2, 65x65, f32, TF32 off),
   held against the CPU step's own rounding noise; the finetune recipe
   (batch 8, 769x769, f32, compact batches, dropout on) through
   ``TrainLoop`` for 6 steps, with PyTorch's default TF32 setting: ms a
   step, img/s, peak memory, losses, grad norms, EIC; and one step with
   ``remat_segments=4`` against one without (batch 2, 129x129), equal;
10. the EIC horizon (``phase_horizon``, ``prune/horizon.py``), which
    launches none of K1-K6: the flagship R50 (deepsup, dropout 0)
    pretrained with CE + EIC for 200 steps of 2 x 257^2 long-tail crops
    in f32 (A), in f32 from the init x (1 + 1e-6) (B), and with TF32 on
    (C), deterministic; at steps 50, 100 and 200 every per-checkpoint
    gate of ``check_rows`` (within-layer EIC Pearson and Spearman
    against the floor, layer means, DCFP keep-masks) on
    ``horizon_rows(C, A, B)`` and on A against C next to A's own floor
    B, each run's loss falling, the gap's growth printed; one
    ``{"horizon": ...}`` line;
11. eval (``phase_eval``): the flagship DeepLabV3-R50 (random weights,
   seed 0) over four seeded 1024x2048 images fed in memory and taken in
   turn, through ``engine/evaluator.py``: (a) the deploy eval (bf16,
   whole, ss, padded to 1025x2049) in the protocol loop, the pipelined
   loop and the pipelined loop on compact uint8 items, 261 images each
   (256 timed), with identical confusion matrices, K1 and the body's
   conv epilogues launched once an image a loop and no synchronizing call in a pipelined loop but its
   flushes; their pinned host memory, and a host (cProfile) and device
   profile of each pipelined loop; (b) multi-scale 0.5-1.75 + flip,
   f32 (4 timed images); (c) sliding 769x769 tiles, f32 (16 timed);
   (d) boundary IoU (46 erosions);
   (e) each mode again at 125x250, f32, TF32 off, card against CPU,
   labels differing only at near-ties; one ``{"eval": ...}`` JSON line;
12. the recipe through files (``phase_data``), the flagship R50 at full
   width, random weights: a 1024x2048 Cityscapes fixture on disk (16
   train, 16 val images) and its label index; pretrain.sh's item path
   (CE + EIC, classic f32 items through the native augment tail, batch
   8 x 769^2 from decode processes, 6 ``TrainLoop`` steps, the native
   library's call count held > 0), its snapshot and EIC; prune.sh's
   search to 0.4 of the FLOPs, ``pruned`` and ``channel_cfg`` written
   and read back bit-equal, the pruned graph rebuilt; finetune.sh's item
   path (GSRL, balance 2, resample, compact batches, 6 steps, snapshots
   at 3 and 6), the step-3 snapshot reloaded bit-equal and one step from
   it giving the run's loss (rtol 1e-5); the deploy eval (bf16, K1) of
   the step-6 snapshot over a val manifest of 64 lines, pipelined, on
   f32 and compact items from the prefetch thread and from decode
   processes, each confusion identical to the protocol loop's over the
   images decoded once into memory, K1 and the conv epilogues once an
   image; the loaders' rates
   alone; one ``{"data": ...}`` JSON line;
13. the entry points (``phase_cli``): the Cityscapes scripts' commands
    through the CLIs' ``main`` on a 1024x2048 fixture of 8 train and 8
    val frames (label_index, pretrain, prune, finetune, evaluate,
    deploy in bf16 and f32, evaluate f32 and ``--use-aot`` on both
    artifacts, evaluate_test), every rc 0, K1 counted on each path (at
    a captured graph's replays), the f32 ``--use-aot`` confusion equal
    to the jit path's, the bf16 artifact's and both captured forms'
    labels against the jit path's; scripts/cs/deploy.sh's evaluate
    command (bf16, 1025x2049; on its pruned snapshot and on the unpruned
    one) timed a frame as the CLI runs it now (autotuned, under 50 ms)
    and, in a fresh process, with autotuning off as it ran before; then
    ``bench_torch.py`` in a child process,
    its JSON line parsed and held; one ``{"cli": ...}`` line;
14. data parallel across processes (``phase_dist``): 2 ranks of the
    flagship R50 (NCCL on two cards, else both over gloo on the one
    card), GSRL + EIC + SGD with dropout at a global batch of 4 x 769^2:
    step 1 (TF32 off) against one process's step on the global batch by
    PR 9's self-noise rule, the ranks' params bit-equal, 3 steps timed
    with TF32 on in the ranks and in one process; the bf16 deploy eval
    of 8 seeded 1024x2048 frames split over the ranks, its summed
    confusion equal to one process's, K1 once a frame on each rank; one
    ``{"dist": ...}`` line;
15. spatial sharding (``phase_spatial``): a 1 x 2 mesh (2 x 2 over NCCL
    on four cards or more; else both ranks over gloo on the one card),
    image height split over the spatial ranks, on the flagship R50:
    GSRL + EIC + SGD with dropout at a global batch of 2 x 769^2, step 1
    (TF32 off) against one process's by ``phase_dist``'s self-noise
    rule, the ranks' params bit-equal, a rank's peak memory at most 0.7 x one
    process's, 3 steps timed with TF32 on; whole-image eval of 4 seeded
    1024x2048 frames: the first frame's f32 logits against one
    process's, bf16 labels through K1 (once a frame on each rank)
    against one fresh process's, flipping at near-ties no more than
    twice as often as one process flips between two sets of cuDNN plans;
    one ``{"spatial": ...}`` line;
16. one JSON line with every ported kernel: launches on its path, its
    check, its time beside its bound, plain and library times;
17. last line: ``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch import native
from dcfp_tpu_torch.bridge import (eic_to_numpy, params_from_numpy,
                                   params_to_numpy)
from dcfp_tpu_torch.data.base import normalize_f32
from dcfp_tpu_torch.data.datasets import build_dataset
from dcfp_tpu_torch.data.label_index import build_label_index
from dcfp_tpu_torch.data.loader import (EvalLoader, TrainLoader, _fork_ctx,
                                        collate)
from dcfp_tpu_torch.data.synthetic import make_cityscapes_fixture
from dcfp_tpu_torch.engine.deploy import (aot_compile_split, benchmark,
                                          export_serialized_split,
                                          fold_batchnorm,
                                          fuse_conv_epilogues,
                                          load_serialized,
                                          make_inference_fn,
                                          make_split_inference_fn,
                                          split_pred_tail)
from dcfp_tpu_torch.engine.evaluator import Predictor, evaluate, pad_inf
from dcfp_tpu_torch.engine.optim import build_optimizer
from dcfp_tpu_torch.engine.trainer import (TrainLoop, create_train_state,
                                           make_train_step)
from dcfp_tpu_torch.graph.apply import graph_apply, init_graph
from dcfp_tpu_torch.graph.shapes import infer_shapes
from dcfp_tpu_torch.losses.criteria import build_criterions
from dcfp_tpu_torch.models.registry import build_model
from dcfp_tpu_torch.ops import aspp, bottleneck, int8, kernels
from dcfp_tpu_torch.ops.resize import resize_bilinear
from dcfp_tpu_torch.ops.stem import extract_stem_phases
from dcfp_tpu_torch.prune import horizon
from dcfp_tpu_torch.prune.eic import prunable_bn_names
from dcfp_tpu_torch.prune.pruner import apply_channel_cfg, slice_params_to_cfg
from dcfp_tpu_torch.prune.search import prune_to_flops
from dcfp_tpu_torch.utils import checkpoint as ckpt
from dcfp_tpu_torch.utils import edge, profiling
from dcfp_tpu_torch.utils.edge import mask_to_boundary_device
from dcfp_tpu_torch.utils.profiling import card_name_and_power

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the
# tensor cores (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, tensor cores
INT8_OPS_PER_S = 1979e12  # dense, tensor cores

MAIN_SHAPE = (1, 19, 129, 257)  # low-res logits of the deploy model
MAIN_OUT = (1025, 2049)
R101_CFG = dict(backbone="resnet101",
                backbone_para={"os": 8, "mg_unit": [1, 2, 4],
                               "inplanes": 128},
                num_classes=19, align_corner=True, deepsup=False)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=50, warmup=5):
    """Device time per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps=20, iters=10):
    """Device time per call of a short ``fn``: ``reps`` calls captured in
    a CUDA graph, replayed ``iters`` times between CUDA events, so the
    host's per-call overhead (Python, checks, launch) is not timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this test needs a CUDA card")
    log(card_name_and_power())
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    # f32 comparisons below need full f32 convolutions and matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    built = kernels.build_all()
    log(f"[build] {len(built)} libraries in "
        f"{time.perf_counter() - t0:.2f} s (nvcc runs in parallel)")
    for name, b in built.items():
        log(f"[build] {name}: nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():  # ptxas: registers, spills
            if "Compiling entry function" in line:
                log(f"[build]   {line.split(chr(39))[1]}")  # mangled name
            elif "Used" in line or "spill" in line:
                log(f"[build]     {line.strip()}")
        fences = b.log.count("(C7519)")
        if fences:  # ptxas fences around wgmma register operands
            log(f"[build]   {fences} ptxas C7519 lines (warpgroup.arrive "
                "injected)")


# ---------------------------------------------------------------------------
# 3. K1 against its plain version
# ---------------------------------------------------------------------------

def near_tie_check(labels, z_nhwc, out_hw, ac, tag):
    """Every pixel where K1's labels differ from the plain version's must
    be a near-tie: the plain version's top-2 resized values, in the
    logits dtype, within 2 ulp.  At most 0.1% of pixels may differ.
    Returns (mismatches, max_abs_err), where max_abs_err is the largest
    gap between the best resized value and the value of K1's label."""
    up = resize_bilinear(z_nhwc, out_hw, ac).float()
    top2 = up.topk(min(2, up.shape[-1]), dim=-1).values
    want = torch.argmax(up, dim=-1).to(torch.uint8)
    diff = labels != want
    n_diff = int(diff.sum())
    share = n_diff / labels.numel()
    if n_diff and up.shape[-1] == 1:
        raise AssertionError(f"{tag}: labels other than 0 with one class")
    picked = up.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    max_abs_err = float((top2[..., 0] - picked).max())
    if n_diff:
        best = top2[..., 0][diff]
        ulp = torch.finfo(z_nhwc.dtype).eps * torch.exp2(
            torch.floor(torch.log2(best.abs().clamp_min(1e-30))))
        gap = (best - top2[..., 1][diff])
        if bool((gap > 2 * ulp).any()):
            raise AssertionError(f"{tag}: {int((gap > 2 * ulp).sum())} "
                                 "mismatched pixels are not near-ties")
    log(f"[k1] {tag}: mismatches {n_diff} ({100 * share:.4f}%), "
        f"max_abs_err {max_abs_err:.3g}")
    if share > 1e-3:
        raise AssertionError(f"{tag}: {100 * share:.3f}% of labels differ")
    return n_diff, max_abs_err


# the JAX package's kernel test cases and the deploy shape
K1_CASES = [((1, 19, 129, 257), MAIN_OUT, True),       # deploy shape
            ((1, 19, 17, 33), (65, 129), True),         # test_pallas.py
            ((2, 7, 16, 16), (64, 64), False),
            ((1, 150, 9, 9), (33, 33), True),
            ((1, 171, 65, 129), (513, 1025), False)]    # COCO-stuff
# shapes off K1's tiles and chunks
K1_ODD = [((2, 19, 33, 61), (257, 481), True),    # N = 2; out_w odd, off TW
          ((1, 171, 17, 29), (131, 227), False),  # C = 171: six chunks
          ((1, 5, 40, 257), (20, 100), False),    # down-sampling
          ((1, 1, 9, 10), (37, 45), True),        # C = 1
          ((2, 256, 6, 7), (23, 27), True)]       # C = 256, uint8's most


def phase_k1():
    """K1 on every case of ``K1_CASES`` and ``K1_ODD``, f32 and bf16: the
    NHWC entry, ``_cm`` on NCHW and ``_cm`` on channels_last agree, and
    the labels pass the near-tie rule; then the tie case."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape, out_hw, ac in K1_CASES + K1_ODD:
        plan = kernels.resize_argmax_plan(*shape, *out_hw, ac)
        log(f"[k1] plan {tuple(shape)}->{out_hw}: tile {plan.tr}x{plan.tw}, "
            f"chunk {plan.c_chunk}, footprint <= {plan.span_r}x"
            f"{plan.span_c}, grid {plan.grid}, smem {plan.smem} B")
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            z_nhwc = z.permute(0, 2, 3, 1).contiguous()
            tag = f"{tuple(shape)}->{out_hw} ac={ac} {str(dtype)[6:]}"
            got_cm = kernels.resize_argmax_cm(z, out_hw, ac)
            got_cl = kernels.resize_argmax_cm(
                z.contiguous(memory_format=torch.channels_last), out_hw, ac)
            got = kernels.resize_argmax(z_nhwc, out_hw, ac)
            torch.cuda.synchronize()
            if got.shape != (shape[0],) + out_hw or got.dtype != torch.uint8:
                raise AssertionError(f"{tag}: bad output {got.shape}")
            if not (torch.equal(got, got_cm) and torch.equal(got_cl, got_cm)):
                raise AssertionError(f"{tag}: NHWC, _cm and channels_last "
                                     "_cm entries differ")
            results[tag] = near_tie_check(got_cm, z_nhwc, out_hw, ac, tag)
    tie = torch.zeros((1, 4, 4, 5), device="cuda")
    tie[..., 1] = 3.0
    tie[..., 3] = 3.0
    if not bool((kernels.resize_argmax(tie, (8, 8), False) == 1).all()):
        raise AssertionError("tie case: first maximal channel must win")
    log("[k1] tie case: all ones")
    return results


def time_k1():
    """K1 at the deploy shape (bf16) beside its plain version, the
    library call, and its bound.  The logits are channels_last, the
    layout the classifier conv hands K1 on the main path, and
    L2-resident, as they are when that conv has just run.  The kernel is
    timed in a CUDA graph (``ms``; it is shorter than the wrapper's
    Python issue time) and through the wrapper (``wrapper_ms``, CUDA
    events), on channels_last and on the contiguous (N, C, h, w)
    layout."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    z = torch.randn(MAIN_SHAPE, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    z_nchw = z.contiguous()
    z_nhwc = z.permute(0, 2, 3, 1)
    n, c, h, w = MAIN_SHAPE
    out_h, out_w = MAIN_OUT
    plan = kernels.resize_argmax_plan(n, c, h, w, out_h, out_w, True)
    ms = graph_ms(lambda: kernels.resize_argmax_cm(z, MAIN_OUT, True))
    nchw_ms = graph_ms(
        lambda: kernels.resize_argmax_cm(z_nchw, MAIN_OUT, True))
    wrapper_ms = cuda_ms(
        lambda: kernels.resize_argmax_cm(z, MAIN_OUT, True), 200)
    wrapper_nchw_ms = cuda_ms(
        lambda: kernels.resize_argmax_cm(z_nchw, MAIN_OUT, True), 200)
    plain_ms = cuda_ms(
        lambda: kernels.resize_argmax_plain(z_nhwc, MAIN_OUT, True), 20)
    library_ms = cuda_ms(lambda: F.interpolate(
        z, size=MAIN_OUT, mode="bilinear", align_corners=True).argmax(1),
        50)
    library_nchw_ms = cuda_ms(lambda: F.interpolate(
        z_nchw, size=MAIN_OUT, mode="bilinear", align_corners=True)
        .argmax(1), 50)
    # bytes: the logits read once and the labels written once; operations:
    # the separable interpolation (H pass on the (out_h, w) grid, W pass
    # on the output grid, 2 multiplies + 1 add each) and the compare
    n_bytes = z.numel() * z.element_size() + n * out_h * out_w
    n_ops = n * c * (out_h * w * 3 + out_h * out_w * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    # the f32 rate counts an FMA as two operations; K1's contract rounds
    # every product and sum on its own, one operation an instruction
    non_fma_floor_ms = 2 * t_ops
    log(f"[k1] deploy shape bf16: kernel {ms:.4f} ms in a CUDA graph "
        f"(channels_last; {nchw_ms:.4f} ms on contiguous NCHW), wrapper "
        f"{wrapper_ms:.4f} ms ({wrapper_nchw_ms:.4f} NCHW), plain "
        f"{plain_ms:.4f} ms, library {library_ms:.4f} ms "
        f"({library_nchw_ms:.4f} ms on NCHW), bound {bound_ms:.4f} ms "
        f"({n_bytes} B, {n_ops} f32 ops; {non_fma_floor_ms:.4f} ms "
        f"without FMA); plan {plan}")
    return {"ms": ms, "ms_nchw": nchw_ms, "wrapper_ms": wrapper_ms,
            "wrapper_ms_nchw": wrapper_nchw_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_ms_nchw": library_nchw_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "plan": {"tile": [plan.tr, plan.tw], "pixels_per_thread": plan.p,
                     "c_chunk": plan.c_chunk,
                     "footprint": [plan.span_r, plan.span_c],
                     "grid": list(plan.grid), "threads": plan.threads,
                     "smem": plan.smem}}


@contextlib.contextmanager
def autotuned():
    """cuDNN autotuning on, as the deploy path runs it: every bf16 cuDNN
    call of the yardsticks goes through here (see :func:`_cudnn_chain`)."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


def bound(n_bytes, n_ops, ops_per_s):
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate for their type, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def ulp_misses(got, ref, slack=None):
    """How many bf16 values of ``got`` lie more than 1 bf16 ulp + ``slack``
    from the f32 ``ref``.  ``slack`` (a number or a tensor like ``ref``)
    defaults to 1e-6 x max|ref|, for values near 0: there two f32 sums in
    different orders differ by more than a bf16 ulp of the tiny result."""
    g, ref = got.float(), ref.float()
    if slack is None:
        slack = 1e-6 * float(ref.abs().max())
    mag = torch.maximum(g.abs(), ref.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int(((g - ref).abs() > ulp + slack).sum())


def bf16_ulp_check(got, ref, tag):
    """Every bf16 value of ``got`` within 1 bf16 ulp (+1e-6 x max|ref|)
    of the f32 ``ref`` (:func:`ulp_misses`).  Returns max|got - ref|."""
    bad = ulp_misses(got, ref)
    if bad:
        raise AssertionError(f"{tag}: {bad} values more than 1 bf16 ulp off")
    return float((got.float() - ref.float()).abs().max())


def f32_rel_check(got, ref, tag, rel=1e-5):
    """max|got - ref| <= rel x max|ref|; returns max|got - ref|."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if err > rel * scale:
        raise AssertionError(f"{tag}: max|diff| {err:.3g} > {rel:g} x "
                             f"max|ref| {scale:.3g}")
    return err


# ---------------------------------------------------------------------------
# 3b. K2 (stem conv from phase planes) against its plain version
# ---------------------------------------------------------------------------

# (N, H, W, cin, cout): tests/test_stem.py's shapes, batch 2, the deploy
# shape (the pruned R101's stem conv, backbone.conv1.0: 3 -> 64)
K2_CASES = [(1, 65, 129, 3, 64), (1, 64, 64, 3, 16), (1, 33, 47, 4, 8),
            (2, 65, 129, 3, 64), (1,) + MAIN_OUT + (3, 64)]
# bf16 only, (N, H, W, cin, cout, element offset of the phases): off the
# runs, chunks and routes of K2's plan (``kernels.stem_conv_plan``)
K2_ODD = [(1, 130, 1024, 3, 64, 0),      # Wp = 513, odd: 2-byte loads
          (1, 65, 129, 3, 42, 0),        # cout 42: no 16-byte runs
          (1, 65, 129, 3, 128, 0),       # cout 128: two channel chunks
          (1, 65, 129, 1, 64, 0),        # cin 1: one k-step
          (1, 65, 129, 2, 24, 0),        # cin 2
          (1, 33, 47, 4, 2048, 0),       # cout 2048: channel groups
          (2,) + MAIN_OUT + (3, 64, 0),  # N = 2 at the deploy width
          (1, 65, 129, 3, 64, 1)]        # phases 2 bytes off 4 bytes


def _stem_inputs(n, h, w, cin, cout, gen):
    img = torch.randn((n, h, w, cin), device="cuda", generator=gen)
    k = torch.randn((cout, cin, 3, 3), device="cuda", generator=gen) * 0.1
    b = torch.randn(cout, device="cuda", generator=gen)
    ph = torch.stack([extract_stem_phases(img[i]) for i in range(n)])
    return img, ph, k, b


def offset_copy(t, off):
    """A contiguous copy of ``t`` that starts ``off`` elements into a fresh
    buffer, so its data_ptr() sits off the allocator's 512-byte grain."""
    if not off:
        return t
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    return buf[off:].view(t.shape).copy_(t)


def _k2_plan(ph, cout, out_hw):
    n, _, hp, wp = ph.shape
    return kernels.stem_conv_plan(n, ph.shape[1] // 4, cout, hp, wp,
                                  *out_hw, kernels._ptr_align(ph.data_ptr()))


def _k2_case(tag, ph, k, b, out_hw, relu):
    """One K2 launch on ``ph`` against the plain version (f32 within
    1e-5 x max|ref|, bf16 within 1 bf16 ulp); returns max|err|."""
    n, cout = ph.shape[0], k.shape[0]
    got = kernels.stem_conv3x3_s2(ph, k, b, out_hw, relu=relu)
    torch.cuda.synchronize()
    if (tuple(got.shape) != (n, cout) + tuple(out_hw)
            or got.dtype != ph.dtype or not got.is_contiguous(
                memory_format=torch.channels_last)):
        raise AssertionError(f"{tag}: bad output {got.shape} {got.dtype} "
                             f"{got.stride()}")
    ref = kernels.stem_conv3x3_s2_plain(
        ph.float(), k.to(ph.dtype).float(), b, out_hw, relu=relu)
    return (f32_rel_check(got, ref, tag) if ph.dtype == torch.float32
            else bf16_ulp_check(got, ref, tag))


def phase_k2():
    """K2 against its plain version: f32 (TF32 off) within 1e-5 x max|ref|,
    bf16 within 1 bf16 ulp of the plain version's f32 result, ReLU off and
    on, on ``K2_CASES`` (f32 and bf16) and ``K2_ODD`` (bf16); on the
    deploy image also against cuDNN's stem conv."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    cases = ([(c + (0,), (torch.float32, torch.bfloat16)) for c in K2_CASES]
             + [(c, (torch.bfloat16,)) for c in K2_ODD])
    for (n, h, w, cin, cout, off), dtypes in cases:
        img, ph, k, b = _stem_inputs(n, h, w, cin, cout, gen)
        out_hw = ((h + 1) // 2, (w + 1) // 2)
        for dtype in dtypes:
            phd = offset_copy(ph.to(dtype), off)
            if dtype == torch.bfloat16:
                log(f"[k2] plan ({n},{h},{w},{cin})->{cout} off={off}: "
                    f"{_k2_plan(phd, cout, out_hw)}")
            for relu in (False, True):
                tag = (f"({n},{h},{w},{cin})->{cout} off={off} "
                       f"relu={int(relu)} {str(dtype)[6:]}")
                results[tag] = _k2_case(tag, phd, k, b, out_hw, relu)
                log(f"[k2] {tag}: max_abs_err {results[tag]:.3g}")
        if (h, w) == MAIN_OUT and n == 1:
            lib = F.conv2d(img.permute(0, 3, 1, 2), k, b, stride=2, padding=1)
            got = kernels.stem_conv3x3_s2(ph, k, b, out_hw)
            err = f32_rel_check(got, lib, "K2 vs cuDNN stem conv")
            log(f"[k2] deploy image f32 vs cuDNN's stem conv of the image: "
                f"max|diff| {err:.3g}, max|ref| "
                f"{float(lib.abs().max()):.3g}")
    return results


def time_k2():
    """K2 at the deploy shape in bf16: the launch on weights prepared once
    (as the deploy body runs it), the wrapper (with its per-call weight
    prep), the plain version, cuDNN's stem conv of the bf16 channels_last
    image, and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, h, w, cin, cout = K2_CASES[-1]
    img, ph, k, b = _stem_inputs(n, h, w, cin, cout, gen)
    ph = ph.to(torch.bfloat16)
    k, b = k.to(torch.bfloat16), b.to(torch.bfloat16)  # as dev_params hold
    out_hw = ((h + 1) // 2, (w + 1) // 2)
    km, bf = kernels.stem_weights(k, b, ph.dtype, ph.device)
    plan = _k2_plan(ph, cout, out_hw)
    # a ~45 us kernel beside the wrapper's Python: the kernel's own time is
    # the CUDA graph's; CUDA events around the prepared entry time both
    ms = graph_ms(lambda: kernels.stem_conv3x3_s2_prepared(ph, km, bf, out_hw))
    prepared_ms = cuda_ms(
        lambda: kernels.stem_conv3x3_s2_prepared(ph, km, bf, out_hw), 200)
    wrapper_ms = cuda_ms(
        lambda: kernels.stem_conv3x3_s2(ph, k, b, out_hw), 200)
    plain_ms = cuda_ms(
        lambda: kernels.stem_conv3x3_s2_plain(ph, k, b, out_hw), 20)
    img_cl = img.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    k_cl = k.contiguous(memory_format=torch.channels_last)
    with autotuned():
        library_ms = cuda_ms(
            lambda: F.conv2d(img_cl, k_cl, b, stride=2, padding=1), 200)
    ho, wo = out_hw
    # the planes' rows < Ho+1 and columns < Wo+1, which is all K2 reads
    # (Hp also holds the TPU's row tile and carry rows), the weights, the
    # bias and the output
    n_bytes = (n * 4 * cin * (ho + 1) * min(ph.shape[3], wo + 1)
               * ph.element_size() + km.numel() * 4 + cout * 4
               + n * ho * wo * cout * 2)
    bd = bound(n_bytes, 2 * n * ho * wo * 9 * cin * cout, BF16_OPS_PER_S)
    log(f"[k2] deploy shape bf16 {tuple(ph.shape)} -> {(n, cout, ho, wo)}: "
        f"kernel {ms:.4f} ms in a CUDA graph ({prepared_ms:.4f} with CUDA "
        f"events on the prepared entry, wrapper with weight prep "
        f"{wrapper_ms:.4f}), plain {plain_ms:.4f} ms, library (cuDNN stem "
        f"conv) {library_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']} ({bd['bytes']} B, {bd['ops']} ops); plan {plan}")
    return {"ms": ms, "graph_ms": ms, "prepared_ms": prepared_ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "plan": dataclasses.asdict(plan)}


# ---------------------------------------------------------------------------
# 3c. K3 (fused bottleneck) against its plain version, and its probe
# ---------------------------------------------------------------------------

# (N, H, W, cin, cm, d): tests/test_bottleneck.py's f32 cases, batch 2,
# cm off the 32-channel staging step, and the pruned R101's dilations
K3_F32_CASES = [(1, 13, 17, 256, 128, 2), (1, 16, 33, 128, 128, 1),
                (1, 9, 21, 256, 128, 4), (2, 13, 17, 256, 128, 2),
                (1, 11, 13, 48, 24, 3), (1, 20, 37, 64, 32, 8),
                (1, 21, 40, 64, 32, 16)]
# bf16 (the tensor-core path): the test's case (no biases), batch 2, cm
# off the 16-channel mma step, and d 16
K3_BF16_CASES = [(1, 12, 19, 256, 128, 2), (2, 13, 17, 256, 128, 2),
                 (1, 11, 13, 48, 24, 3), (1, 21, 40, 64, 32, 16)]
# the pruned DeepLabV3-R101's trunk at 1025x2049 (os 8): layer3's identity
# blocks (1024 -> 128 -> 1024, d 2) and layer4's (2048 -> 256, d 16)
K3_DEPLOY = {"layer3": (1, 129, 257, 1024, 128, 2),
             "layer4": (1, 129, 257, 2048, 256, 16)}
# off every tile of the wgmma path (64-row m-tiles, 128-channel passes,
# 64-wide K boxes): cin and cm padded, a second conv3 pass with half its
# channels past cin, ragged residue classes; cin 52 (no 16-byte runs)
# and 200 (cp.async runs when channels_last)
K3_ODD = [(1, 23, 29, 52, 40, 5), (2, 23, 29, 200, 72, 5)]


def _bottleneck_inputs(n, h, w, cin, cm, gen, dtype, scales):
    """x and OIHW weights in ``dtype``, f32 biases; ``scales`` for x, w1,
    w2, w3 and the biases."""
    sx, s1, s2, s3, sb = scales

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    x = (rnd(n, cin, h, w) * sx).to(dtype)
    ws = [(rnd(*shape) * sc).to(dtype) for shape, sc in (
        ((cm, cin, 1, 1), s1), ((cm, cm, 3, 3), s2), ((cin, cm, 1, 1), s3))]
    bs = [rnd(k) * sb for k in (cm, cm, cin)]
    return x, (ws[0], bs[0], ws[1], bs[1], ws[2], bs[2])


def bf16_rule(got, ref, tag):
    """tests/test_bottleneck.py's bf16 rule: max|diff| <= 0.15 and under
    1% of values off by more than 0.05.  Returns (max, share > 0.05)."""
    diff = (got.float() - ref.float()).abs()
    mx, share = float(diff.max()), float((diff > 0.05).float().mean())
    if mx > 0.15 or share >= 0.01:
        raise AssertionError(f"{tag}: max|diff| {mx:.3g}, "
                             f"{100 * share:.3f}% > 0.05")
    return mx, share


def _k3_both_layouts(x, args, d, tag):
    """K3 on x as given and on its channels_last copy: equal outputs, each
    in its input's memory format."""
    got = bottleneck.fused_bottleneck(x, *args, dilation=d)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    got_cl = bottleneck.fused_bottleneck(x_cl, *args, dilation=d)
    torch.cuda.synchronize()
    if not got_cl.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError(f"{tag}: channels_last input, output not")
    if not torch.equal(got, got_cl):
        raise AssertionError(f"{tag}: contiguous and channels_last inputs "
                             "give different outputs")
    return got


def phase_k3():
    """K3 against its plain version on tests/test_bottleneck.py's cases
    and a few more: f32 at its rtol = atol = 2e-5, bf16 by its rule;
    contiguous and channels_last input must give equal outputs."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    results = {}
    cases = ([(c, torch.float32) for c in K3_F32_CASES]
             + [(c, torch.bfloat16) for c in K3_BF16_CASES])
    for case, dtype in cases:
        n, h, w, cin, cm, d = case
        tag = f"({n},{cin},{h},{w}) cm {cm} d {d} {str(dtype)[6:]}"
        x, args = _bottleneck_inputs(n, h, w, cin, cm, gen, dtype,
                                     (1.0, 0.05, 0.05, 0.05, 1.0))
        if case is K3_BF16_CASES[0]:  # the test's bf16 case has no biases
            args = (args[0], None, args[2], None, args[4], None)
        got = _k3_both_layouts(x, args, d, tag)
        ref = bottleneck.fused_bottleneck_plain(x, *args, dilation=d)
        if dtype == torch.float32:
            err = float((got - ref).abs().max())
            if not torch.allclose(got, ref, rtol=2e-5, atol=2e-5):
                raise AssertionError(f"{tag}: max|diff| {err:.3g} beyond "
                                     "rtol = atol = 2e-5")
            results[tag] = err
            log(f"[k3] {tag}: max_abs_err {err:.3g}")
        else:
            mx, share = bf16_rule(got, ref, tag)
            results[tag] = mx
            log(f"[k3] {tag}: max_abs_err {mx:.3g}, "
                f"{100 * share:.4f}% > 0.05")
    # a bf16 channels_last x off a 16-byte boundary is refused, not
    # launched (the kernel reads it in 16-byte runs)
    x, args = _bottleneck_inputs(1, 13, 17, 256, 128, gen, torch.bfloat16,
                                 (1.0, 0.05, 0.05, 0.05, 1.0))
    buf = torch.empty(1 + x.numel(), dtype=x.dtype, device="cuda")
    x_off = buf[1:].view(1, 13, 17, 256).permute(0, 3, 1, 2)
    x_off.copy_(x)
    before = kernels.LAUNCHES["fused_bottleneck"]
    try:
        bottleneck.fused_bottleneck(x_off, *args, dilation=2)
    except ValueError as e:
        if "16-byte" not in str(e):
            raise
        log(f"[k3] misaligned bf16 x refused: {e}")
    else:
        raise AssertionError("K3 launched on a misaligned bf16 x")
    if kernels.LAUNCHES["fused_bottleneck"] != before:
        raise AssertionError("K3 counted a launch for a refused x")
    return results


def _cudnn_chain(x, w1, b1, w2, b2, w3, b3, d):
    """The chain the port's graph runs for a bottleneck: three cuDNN convs
    with bias, two ReLUs, the residual add and the last ReLU, on
    channels_last weights as the deploy path holds them.  Call it under
    :func:`autotuned`: PyTorch keeps the first cuDNN plan made for a conv
    configuration whatever ``cudnn.benchmark`` says later, and cuDNN's
    untuned pick for the dilated 3x3 at layer4 runs 100x slower."""
    t = torch.relu(F.conv2d(x, w1, b1))
    t = torch.relu(F.conv2d(t, w2, b2, padding=d, dilation=d))
    return torch.relu(F.conv2d(t, w3, b3) + x)


def phase_k3_probe():
    """K3's path: its probe (tools/exp_bottleneck.py) at the pruned R101's
    layer3 and layer4 shapes, bf16 channels_last, with the probe's
    scales.  Counts set to 0 before the two calls and read after; then
    each output against the plain version (the bf16 rule) and the cuDNN
    chain (printed, as the probe prints it), and timings."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    inputs = {}
    for name, (n, h, w, cin, cm, d) in K3_DEPLOY.items():
        x, args = _bottleneck_inputs(n, h, w, cin, cm, gen, torch.bfloat16,
                                     (0.5, 0.04, 0.08, 0.08, 0.1))
        inputs[name] = (x.contiguous(memory_format=torch.channels_last),
                        args, d)
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    outs = {name: bottleneck.fused_bottleneck(x, *args, dilation=d)
            for name, (x, args, d) in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["fused_bottleneck"] != len(K3_DEPLOY):
        raise AssertionError(f"K3 probe: {launches} launches, want one per "
                             "shape")
    check, times = {}, {}
    for n, h, w, cin, cm, d in K3_ODD:  # after the counted path
        tag = f"odd ({n},{cin},{h},{w}) cm {cm} d {d} bf16"
        x, args = _bottleneck_inputs(n, h, w, cin, cm, gen, torch.bfloat16,
                                     (1.0, 0.05, 0.05, 0.05, 1.0))
        got = _k3_both_layouts(x, args, d, tag)
        mx, share = bf16_rule(
            got, bottleneck.fused_bottleneck_plain(x, *args, dilation=d), tag)
        check[tag] = {"max_abs_err": mx, "share_over_0.05": share,
                      "tile": list(bottleneck._tile(h, w, d, cin, cm, 2))}
        log(f"[k3] {tag}, tile {check[tag]['tile']}: max_abs_err {mx:.3g}, "
            f"{100 * share:.4f}% > 0.05, contiguous == channels_last")
    for name, (x, args, d) in inputs.items():
        got = outs[name]
        if (got.shape != x.shape or got.dtype != x.dtype
                or not got.is_contiguous(memory_format=torch.channels_last)
                or not bool(torch.isfinite(got).all())):
            raise AssertionError(f"K3 {name}: bad output")
        ref = bottleneck.fused_bottleneck_plain(x, *args, dilation=d)
        mx, share = bf16_rule(got, ref, f"K3 {name} vs plain")
        with autotuned():
            chain = _cudnn_chain(x, *(
                a.to(x.dtype).contiguous(memory_format=torch.channels_last)
                if a.dim() == 4 else a.to(x.dtype) for a in args), d)
        cdiff = (got.float() - chain.float()).abs()
        check[name] = {"max_abs_err": mx, "share_over_0.05": share,
                       "cudnn_chain_max_diff": float(cdiff.max()),
                       "cudnn_chain_share_over_0.05":
                           float((cdiff > 0.05).float().mean())}
        log(f"[k3] probe {name} {tuple(x.shape)} d {d} bf16: vs plain "
            f"max|diff| {mx:.3g}, {100 * share:.4f}% > 0.05; vs cuDNN chain "
            f"max|diff| {check[name]['cudnn_chain_max_diff']:.3g}, "
            f"{100 * check[name]['cudnn_chain_share_over_0.05']:.4f}% > 0.05")
        check[name]["tile"] = list(bottleneck._tile(
            x.shape[2], x.shape[3], d, x.shape[1], args[0].shape[0], 2))
        del ref, chain, cdiff
        times[name] = time_k3(name, x, args, d)
    return launches, check, times


def time_k3(name, x, args, d):
    n, cin, h, w = x.shape
    cm = args[0].shape[0]
    prepped = bottleneck.bottleneck_weights(*args, x.dtype, x.device)
    # 30 launches after 5 (the card's clocks settle in the first few)
    ms = cuda_ms(lambda: bottleneck.fused_bottleneck_launch(
        x, prepped, dilation=d), 30, warmup=5)
    wrapper_ms = cuda_ms(lambda: bottleneck.fused_bottleneck(
        x, *args, dilation=d), 30, warmup=5)
    plain_ms = cuda_ms(lambda: bottleneck.fused_bottleneck_plain(
        x, *args, dilation=d), 10, warmup=2)
    lib_args = [a.to(x.dtype).contiguous(memory_format=torch.channels_last)
                if a.dim() == 4 else a.to(x.dtype) for a in args]
    with autotuned():
        library_ms = cuda_ms(lambda: _cudnn_chain(x, *lib_args, d), 50)
    n_bytes = (2 * x.numel() * x.element_size()
               + sum(a.numel() * a.element_size() for a in prepped))
    n_ops = 2 * n * h * w * (2 * cin * cm + 9 * cm * cm)
    bd = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    log(f"[k3] {name} {tuple(x.shape)} cm {cm} d {d} bf16: kernel "
        f"{ms:.4f} ms (wrapper with weight prep {wrapper_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, library (cuDNN chain) {library_ms:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
        f"({bd['bytes']} B, {bd['ops']} ops; kernel at "
        f"{n_ops / ms / 1e9:.1f} TFLOP/s)")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"]}


# ---------------------------------------------------------------------------
# 3d. the int8 probe (tools/exp_int8.py): K5 (stage A) and K6 (stage B)
# ---------------------------------------------------------------------------

# (M, K, N): the probe's 1024^3, M off the TPU's 512-row tile with N and
# K off the kernel's 128 x 64 tiles, and a skinny M
K5_CASES = [(1024, 1024, 1024), (1000, 1008, 200), (64, 4096, 1024)]
# off every tile of the wgmma kernel (128 x 64 blocks, 128 bytes of K a
# stage) and through both B routes: (M, K, N, dtype, b's byte offset from
# a 16-byte boundary); bf16 b in place needs N % 8 == 0 and offset 0
K5_ODD = [(130, 48, 76, torch.int8, 4), (70, 40, 6, torch.bfloat16, 0),
          (200, 136, 72, torch.bfloat16, 4), (129, 72, 64, torch.bfloat16, 0)]


def _k5_inputs(m, k, n, dtype, gen):
    if dtype == torch.int8:
        return (torch.randint(-128, 128, (m, k), device="cuda", generator=gen,
                              dtype=torch.int8),
                torch.randint(-128, 128, (k, n), device="cuda", generator=gen,
                              dtype=torch.int8))
    return (torch.randn((m, k), device="cuda", generator=gen).to(dtype),
            torch.randn((k, n), device="cuda", generator=gen).to(dtype))


def phase_k5():
    """K5's path, the probe's stage A: every case in int8 and bf16 through
    ``int8.tiled_mm`` (counts set to 0 before, read after); then int8
    equal to the plain version (exact), bf16 within 1e-5 x (|a| @ |b|)
    of the plain f32 product; and the 1024^3 timings."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [(c, dt) for c in K5_CASES for dt in (torch.int8, torch.bfloat16)]
    inputs = [_k5_inputs(*c, dt, gen) for c, dt in cases]
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    outs = [int8.tiled_mm(a, b) for a, b in inputs]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["tiled_mm"] != len(cases):
        raise AssertionError(f"K5 path: {launches}, want one launch a case")
    check = {}
    for ((m, k, n), dt), (a, b), got in zip(cases, inputs, outs):
        tag = f"{m}x{k}x{n} {str(dt)[6:]}"
        err = _k5_held(got, a, b, tag)
        check[tag] = err
        log(f"[k5] {tag}: max_abs_err {err:.3g}")
    check.update(_k5_odd_checks(gen))
    times = {}
    for m, k, n in K5_CASES:  # the 1024^3 timings are the kernel's row
        for dt in (torch.int8, torch.bfloat16):
            key = str(dt)[6:] if (m, k, n) == K5_CASES[0] else \
                f"{m}x{k}x{n} {str(dt)[6:]}"
            times[key] = time_k5(*_k5_inputs(m, k, n, dt, gen))
    return launches, check, times


def _k5_held(got, a, b, tag):
    """int8 equal to the plain product, bf16 within 1e-5 x (|a| @ |b|);
    returns max|got - plain|."""
    ref = int8.tiled_mm_plain(a, b)
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"K5 {tag}: bad output {got.shape}")
    if a.dtype == torch.int8:
        if not torch.equal(got, ref):
            raise AssertionError(f"K5 {tag}: int8 product not exact")
        return 0.0
    diff = (got - ref).abs()
    bad = int((diff > 1e-5 * (a.float().abs() @ b.float().abs())).sum())
    if bad:
        raise AssertionError(f"K5 {tag}: {bad} values beyond "
                             "1e-5 x (|a| @ |b|)")
    return float(diff.max())


def _k5_odd_checks(gen):
    """K5 on K5_ODD, after the counted path: ragged M, N and K, both B
    routes (the transpose for int8, for N % 8 != 0 and for a b off a
    16-byte boundary)."""
    check = {}
    for m, k, n, dt, offset in K5_ODD:
        a, b0 = _k5_inputs(m, k, n, dt, gen)
        buf = torch.empty(k * n + 16, dtype=dt, device="cuda")
        start = (-buf.data_ptr() % 16 + offset) // buf.element_size()
        b = buf[start:start + k * n].view(k, n)
        b.copy_(b0)
        plan = int8.mm_launch_plan(a, b)
        tag = (f"odd {m}x{k}x{n} {str(dt)[6:]} b at +{offset} B "
               f"({'transposed' if plan['transpose_b'] else 'in place'})")
        check[tag] = _k5_held(int8.tiled_mm(a, b), a, b, tag)
        log(f"[k5] {tag}: max_abs_err {check[tag]:.3g}")
    return check


def time_k5(a, b):
    """K5 beside its plain version, the one-call library product and its
    bound: ``torch._int_mm`` (cuBLASLt, int32 out) for int8, bf16
    ``torch.matmul`` (whose output is bf16, not K5's f32) for bf16."""
    (m, k), n = a.shape, b.shape[1]
    # a call is shorter than the host's time to issue it, so each is
    # timed inside a CUDA graph (graph_ms); cuda_ms would time the host
    ms = graph_ms(lambda: int8.tiled_mm(a, b))
    host_ms = cuda_ms(lambda: int8.tiled_mm(a, b), 200)
    plain_ms = graph_ms(lambda: int8.tiled_mm_plain(a, b))
    library_f32_ms = None
    if a.dtype == torch.int8:
        library_ms = graph_ms(lambda: torch._int_mm(a, b))
        rate, out_bytes, lib = INT8_OPS_PER_S, 4, "torch._int_mm"
    else:
        library_ms = graph_ms(lambda: torch.matmul(a, b))
        rate, out_bytes, lib = BF16_OPS_PER_S, 4, "torch.matmul, bf16 out"
        # K5's own function, f32 out (aten::mm.dtype), where torch has it
        try:
            f32 = torch.mm(a, b, out_dtype=torch.float32)
        except (TypeError, RuntimeError) as e:
            log(f"[k5] torch.mm(..., out_dtype=torch.float32) is missing "
                f"here ({type(e).__name__}: {e}); bf16-out yardstick only")
        else:
            if f32.dtype != torch.float32:
                raise AssertionError("torch.mm out_dtype gave "
                                     f"{f32.dtype}")
            library_f32_ms = graph_ms(
                lambda: torch.mm(a, b, out_dtype=torch.float32))
            lib += (f" / {library_f32_ms:.4f} ms (torch.mm, f32 out, "
                    f"K5's function)")
    es = a.element_size()
    bd = bound((m * k + k * n) * es + m * n * out_bytes, 2 * m * n * k, rate)
    log(f"[k5] {m}x{k}x{n} {str(a.dtype)[6:]}: kernel {ms:.4f} ms "
        f"({2 * m * n * k / ms / 1e9:.1f} T{'OP' if es == 1 else 'FLOP'}/s; "
        f"{host_ms:.4f} ms a call issued from Python), "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms ({lib}), "
        f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
        f"({bd['bytes']} B, {bd['ops']} ops)")
    return {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_f32_out_ms": library_f32_ms,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"]}


# the probe's stage-B shape (exp_int8.py:221-229: H0 128, W 256,
# 1024 -> 256 -> 1024, scales 2e-4) and the pruned R101's layer3 blocks
# (129 x 257, 1024 -> 128 -> 1024); 129 is no multiple of the TPU's row tile
K6_SHAPES = {"probe": (128, 256, 1024, 256, 1024),
             "layer3": (129, 257, 1024, 128, 1024)}
K6_SCALES = (2e-4, 2e-4, 2e-4)
# At those shapes the probe's scales leave y2, and so the output, all
# zeros (|s2 * acc2| < 0.5), which any kernel would match; these scales
# put every requant to work (y1 and y2 spread over 0..127, the block
# chain's carry over -64..63 through all 8 blocks).
K6_CHECK_SCALES = (4e-3, 2e-3, 1e-3)
K6_BLOCKS = 8
# off every tile of the kernel: H0 and W ragged, Cin, Cm and Cout not
# multiples of its 128-byte stages or 128-channel passes
K6_ODD = (7, 45, 48, 48, 40)
# Cm 80 (a multiple of the entry's 16, off the 128-byte row), W below one
# tile's width (the planner's 6 x 6 tile spans 12 columns), Cout off the
# 16-byte output runs
K6_EDGE = (9, 11, 64, 80, 42)


def _k6_inputs(h0, w, cin, cm, cout, seed):
    """The probe's draws (exp_int8.py:223-228), numpy from ``seed``:
    x8 with its D random halo rows on each side, int8 weights."""
    rng = np.random.default_rng(seed)
    hp = h0 + 2 * int8.D
    arrs = (rng.integers(-64, 64, (hp, w, cin)),
            rng.integers(-16, 16, (cin, cm)),
            rng.integers(-16, 16, (9, cm, cm)),
            rng.integers(-16, 16, (cm, cout)))
    return [torch.from_numpy(a.astype(np.int8)).cuda() for a in arrs]


def _bit_equal(got, ref, tag):
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{tag}: {got.shape} {got.dtype}, want "
                             f"{ref.shape} {ref.dtype}")
    view = torch.int16 if got.dtype == torch.bfloat16 else got.dtype
    if not torch.equal(got.view(view), ref.view(view)):
        n = int((got.view(view) != ref.view(view)).sum())
        raise AssertionError(f"{tag}: {n} values differ from the plain "
                             "version")


def phase_k6():
    """K6's path, the probe's stage B: ``int8.chain_int8`` at the probe's
    shape with its scales, then at the probe's and the pruned layer3's
    shapes with scales that exercise every requant, then
    ``chain_int8_blocks`` with 8 blocks on the probe's inputs (counts set
    to 0 before, read after); each output bit-equal to its plain version,
    the block chain with exactly 8 launches; then timings per block
    beside the bf16 cuDNN chain."""
    inputs = {name: _k6_inputs(*shape, seed)
              for seed, (name, shape) in enumerate(K6_SHAPES.items(), 1)}
    runs = [("probe", "probe scales", K6_SCALES),
            ("probe", "check scales", K6_CHECK_SCALES),
            ("layer3", "check scales", K6_CHECK_SCALES)]
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    outs = [int8.chain_int8(*inputs[name], sc) for name, _, sc in runs]
    before = kernels.LAUNCHES["chain_int8"]
    carry = int8.chain_int8_blocks(*inputs["probe"], K6_CHECK_SCALES,
                                   K6_BLOCKS)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["chain_int8"] - before != K6_BLOCKS:
        raise AssertionError(f"K6 block chain: "
                             f"{launches['chain_int8'] - before} launches, "
                             f"want {K6_BLOCKS}")
    check = {}
    for (name, what, sc), got in zip(runs, outs):
        args = inputs[name]
        ref = int8.chain_int8_plain(*args, sc)
        _bit_equal(got, ref, f"K6 {name} {what}")
        nz = float((ref != 0).float().mean())
        if sc is K6_CHECK_SCALES and nz < 0.5:
            raise AssertionError(f"K6 {name}: the check data leave "
                                 f"{1 - nz:.2f} of the output zero")
        check[f"{name}, {what}"] = {"bit_equal": True, "nonzero_share": nz}
        log(f"[k6] {name} {tuple(args[0].shape)} -> {tuple(ref.shape)}, "
            f"{what} {sc}: bit-equal to the plain version; max|out| "
            f"{float(ref.float().abs().max()):.4g}, nonzero {nz:.4f}")
    ref = int8.chain_int8_blocks_plain(*inputs["probe"], K6_CHECK_SCALES,
                                       K6_BLOCKS)
    _bit_equal(carry, ref, f"K6 {K6_BLOCKS}-block chain")
    check["blocks"] = {"blocks": K6_BLOCKS, "bit_equal": True,
                       "distinct_values": int(torch.unique(ref).numel())}
    log(f"[k6] {K6_BLOCKS}-block chain on the probe's inputs, check scales:"
        f" the int8 carry bit-equal to the plain loop "
        f"({check['blocks']['distinct_values']} distinct values)")
    for seed, (what, shape) in enumerate((("odd shape", K6_ODD),
                                          ("edge shape", K6_EDGE)), 3):
        odd = _k6_inputs(*shape, seed)
        ref = int8.chain_int8_plain(*odd, K6_CHECK_SCALES)
        _bit_equal(int8.chain_int8(*odd, K6_CHECK_SCALES), ref, f"K6 {what}")
        check[what] = {"shape": list(shape), "bit_equal": True,
                       "tile": list(int8.chain_tile(*shape)),
                       "nonzero_share": float((ref != 0).float().mean())}
        log(f"[k6] {what} {shape} (H0, W, Cin, Cm, Cout), tile "
            f"{check[what]['tile']}: bit-equal, nonzero "
            f"{check[what]['nonzero_share']:.4f}")
    times = {name: time_k6(name, args) for name, args in inputs.items()}
    return launches, check, times


def time_k6(name, args):
    """One block: K6 on weights prepared once (as the block chain runs
    it), the wrapper (with the weight prep), the plain version and the
    bf16 cuDNN chain (``int8.chain_bf16``, autotuned) at the same shape
    with the probe's bf16 magnitudes; and the bound."""
    x8, w1, w2, w3 = args
    hp, w, cin = x8.shape
    cm, cout = w1.shape[1], w3.shape[1]
    h0, d = hp - 2 * int8.D, int8.D
    prepped = int8.chain_int8_weights(w1, w2, w3)
    ms = cuda_ms(lambda: int8.chain_int8_launch(x8, prepped, K6_SCALES), 30,
                 5)
    # the same launches in a CUDA graph: at ~0.1 ms a launch, the wrapper's
    # host time can show in the events' time
    graph = graph_ms(lambda: int8.chain_int8_launch(x8, prepped, K6_SCALES),
                     10, 3)
    wrapper_ms = cuda_ms(lambda: int8.chain_int8(x8, w1, w2, w3, K6_SCALES),
                         30, 5)
    plain_ms = cuda_ms(
        lambda: int8.chain_int8_plain(x8, w1, w2, w3, K6_SCALES), 5, 1)
    xb = (x8.float() * 0.01).to(torch.bfloat16)
    ks = [(t.float() * 2e-2).to(torch.bfloat16) for t in (w1, w2, w3)]
    k1 = ks[0].t().reshape(cm, cin, 1, 1)
    k2 = ks[1].reshape(3, 3, cm, cm).permute(3, 2, 0, 1)
    k3 = ks[2].t().reshape(cout, cm, 1, 1)
    k1, k2, k3 = (k.contiguous(memory_format=torch.channels_last)
                  for k in (k1, k2, k3))
    with autotuned():
        library_ms = cuda_ms(lambda: int8.chain_bf16(xb, k1, k2, k3), 50)
    # bytes: x, the weights and the output once; operations: conv1 on every
    # input row (the halo rows feed the 3x3), the 3x3's taps that fall
    # inside the image's columns, and conv3
    taps = sum(w - abs(kx - 1) * d for kx in range(3)) * 3 * h0
    n_ops = 2 * (hp * w * cin * cm + taps * cm * cm + h0 * w * cm * cout)
    n_bytes = x8.numel() + w1.numel() + w2.numel() + w3.numel() \
        + h0 * w * cout * 2
    bd = bound(n_bytes, n_ops, INT8_OPS_PER_S)
    log(f"[k6] {name} {tuple(x8.shape)} {cin}->{cm}->{cout}, tile "
        f"{list(int8.chain_tile(h0, w, cin, cm, cout))}: kernel "
        f"{ms:.4f} ms (in a CUDA graph {graph:.4f}; "
        f"{n_ops / ms / 1e9:.1f} TOP/s; wrapper with weight "
        f"prep {wrapper_ms:.4f}), plain {plain_ms:.4f} ms, library (bf16 "
        f"cuDNN chain) {library_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by"
        f" {bd['bound_by']} ({bd['bytes']} B, {bd['ops']} ops)")
    return {"ms": ms, "graph_ms": graph, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"]}


# ---------------------------------------------------------------------------
# 3e. the ASPP probe (tools/exp_aspp.py): K4, stages N and B
# ---------------------------------------------------------------------------

K4_STAGE_N = (40, 61, 256, 128)  # exp_aspp.py stage_n: H, W, Cin, Cout
K4_ODD = (23, 37, 200, 72)  # Cin off the 64-channel box, Cout off 128
# W below one tile's width, Cin 72 off the 64-channel box
K4_NARROW = (20, 9, 72, 64)
# some tiles of the d = 36 branch keep only their centre tap, others up to
# 4; two 128-channel blocks, the second partial
K4_SPARSE = (40, 50, 136, 192)


def aspp_case(graph, pparams, pstate, dev_params, image):
    """The served pruned R101's ASPP input and weights: the layer4 output
    of one request (the interpreter run on the folded graph's prefix that
    ends at the ASPP's input, with the served params), and the folded
    bf16 kernels of ``aspp.aspp{2,3,4}.atrous_conv``."""
    names = [f"aspp.aspp{i}.atrous_conv" for i in (2, 3, 4)]
    dil = tuple(graph.node(n).attrs["dilation"] for n in names)
    if dil != aspp.DILATIONS:
        raise AssertionError(f"ASPP dilations {dil}, want {aspp.DILATIONS}")
    src = graph.node(names[0]).inputs[0]
    fgraph, _, fstate = fold_batchnorm(graph, pparams, pstate)
    keep, todo = set(), [src]
    while todo:
        n = todo.pop()
        if n not in keep:
            keep.add(n)
            todo.extend(fgraph.node(n).inputs)
    fgraph.nodes = {k: v for k, v in fgraph.nodes.items() if k in keep}
    fgraph.outputs = [src]
    state = {k: {kk: v.cuda() for kk, v in d.items()}
             for k, d in fstate.items() if k in keep}
    x = image.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        outs, _ = graph_apply(fgraph, dev_params, state,
                              {fgraph.inputs[0]: x}, channels_first=True)
    act = outs[src]
    kern = [dev_params[n]["kernel"] for n in names]
    log(f"[serve] ASPP input of request 0: {src} {tuple(act.shape)} "
        f"{act.dtype}, channels_last "
        f"{act.is_contiguous(memory_format=torch.channels_last)}; "
        f"branches {[tuple(k.shape) for k in kern]} at dilations {dil}")
    return {"source": src, "act": act, "kernels": kern}


def _aspp_ref_check(got, x, wts, tag):
    """K4 within 1 bf16 ulp of the plain version's f32 result plus
    1e-5 x the sum of the magnitudes of the products (the plain version
    on |x| and |w|), K5's bf16 rule: with 9 x Cin products per output the
    f32 sums of the kernel (tensor cores) and of the reference (cuDNN,
    another order) each drift by more than 1 bf16 ulp of a result near
    0.  Returns (max|got - ref|, values beyond the 1-ulp rule alone)."""
    ref = aspp.aspp_fused_plain(x.float(), wts.float())
    if got.shape != ref.shape or got.dtype != torch.bfloat16:
        raise AssertionError(f"{tag}: bad output {got.shape} {got.dtype}")
    mag = aspp.aspp_fused_plain(x.float().abs(), wts.float().abs())
    bad = ulp_misses(got, ref, 1e-5 * mag)
    if bad:
        raise AssertionError(f"{tag}: {bad} values beyond 1 bf16 ulp + "
                             "1e-5 x sum|x w|")
    return float((got.float() - ref).abs().max()), ulp_misses(got, ref)


def phase_k4(case):
    """K4's path, the probe's stages N and B: ``aspp.aspp_fused`` on stage
    N's seeded 40x61x256 -> 3x128 and on the served pruned R101's ASPP
    input with its own folded weights (counts set to 0 before, read
    after); each within 1 bf16 ulp of the plain f32 result; stage B also
    beside the cuDNN branches (printed) and timed."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    h, w, cin, cout = K4_STAGE_N
    xn = (torch.randn((h, w, cin), device="cuda", generator=gen) * 0.5).to(
        torch.bfloat16)
    wn = (torch.randn((27, cin, cout), device="cuda", generator=gen)
          * 0.02).to(torch.bfloat16)
    xb = case["act"][0].permute(1, 2, 0)  # (H, W, C) without a copy
    if not xb.is_contiguous():
        raise AssertionError("layer4 activation is not channels_last")
    wb = aspp.aspp_weights(*case["kernels"])
    log(f"[k4] stage B shape, read from the served graph: "
        f"{tuple(xb.shape)} -> 3x{wb.shape[2]} (input {case['source']} of "
        f"request 0; weights aspp.aspp2-4.atrous_conv)")
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    got_n = aspp.aspp_fused(xn, wn)
    got_b = aspp.aspp_fused(xb, wb)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["aspp_fused"] != 2:
        raise AssertionError(f"K4 path: {launches}, want 2 launches")
    err_n, miss_n = _aspp_ref_check(got_n, xn, wn, "K4 stage N")
    err_b, miss_b = _aspp_ref_check(got_b, xb, wb, "K4 stage B")
    kern_cl = [k.contiguous(memory_format=torch.channels_last)
               for k in case["kernels"]]
    with autotuned():
        lib = aspp.aspp_convs(xb, kern_cl)
    ldiff = float((got_b.float() - lib.float()).abs().max())
    lib_miss = ulp_misses(lib, aspp.aspp_fused_plain(xb.float(), wb.float()))
    log(f"[k4] stage N {tuple(xn.shape)}: max_abs_err {err_n:.3g}, "
        f"{miss_n} values beyond 1 bf16 ulp alone; stage B "
        f"{tuple(xb.shape)}: max_abs_err {err_b:.3g} (max|out| "
        f"{float(got_b.float().abs().max()):.4g}), {miss_b} of "
        f"{got_b.numel()} values beyond 1 bf16 ulp alone (the cuDNN "
        f"branches: {lib_miss}); vs the cuDNN branches max|diff| {ldiff:.3g}")
    odd = {}
    for what, shape in (("odd", K4_ODD), ("narrow", K4_NARROW),
                        ("sparse", K4_SPARSE)):
        h, w, cin, cout = shape
        r, s, _ = aspp.aspp_tile(h, w, cin, cout)
        live = [len(aspp.live_taps(y0, x0, r, s, h, w, d))
                for y0 in range(0, h, r) for x0 in range(0, w, s)
                for d in aspp.DILATIONS]
        if what == "narrow" and not w < s:
            raise AssertionError(f"K4 {shape}: tile {r}x{s} is narrower "
                                 "than the image")
        if what == "sparse" and min(live) != 1:
            raise AssertionError(f"K4 {shape}: every tile keeps an "
                                 "off-centre tap")
        xo = (torch.randn((h, w, cin), device="cuda", generator=gen)
              * 0.5).to(torch.bfloat16)
        wo = (torch.randn((27, cin, cout), device="cuda", generator=gen)
              * 0.02).to(torch.bfloat16)
        err, miss = _aspp_ref_check(aspp.aspp_fused(xo, wo), xo, wo,
                                    f"K4 {what} shape")
        odd[f"{what}_shape_max_abs_err"] = err
        log(f"[k4] {what} shape {shape} (H, W, Cin, Cout), tile {r}x{s}, "
            f"live taps per (tile, branch) {min(live)}..{max(live)}: "
            f"max_abs_err {err:.3g}, {miss} values beyond 1 bf16 ulp alone")
    check = {"stage_n_max_abs_err": err_n, "stage_b_max_abs_err": err_b,
             **odd,
             "stage_n_beyond_1_ulp": miss_n, "stage_b_beyond_1_ulp": miss_b,
             "cudnn_branches_beyond_1_ulp": lib_miss,
             "stage_b_shape": list(xb.shape) + [int(wb.shape[2])],
             "stage_b_input": f"layer4 output of served request 0 "
                              f"({case['source']})",
             "cudnn_branches_max_diff": ldiff}
    del lib
    return launches, check, time_k4(xb, wb, kern_cl)


def time_k4(x, wts, kern_cl):
    """Stage B: K4 on weights prepared once, the wrapper (with the weight
    transpose), the plain version and the three autotuned cuDNN branches
    with ReLU and the concat; and the bound."""
    h, w, cin = x.shape
    cout = wts.shape[2]
    wt = aspp.aspp_kernel_weights(wts)
    ms = cuda_ms(lambda: aspp.aspp_fused_launch(x, wt), 30, 5)
    wrapper_ms = cuda_ms(lambda: aspp.aspp_fused(x, wts), 30, 5)
    plain_ms = cuda_ms(lambda: aspp.aspp_fused_plain(x, wts), 3, 1)
    with autotuned():
        library_ms = cuda_ms(lambda: aspp.aspp_convs(x, kern_cl), 20)
    # operations: the taps that fall inside the image (the others add
    # zeros); all 27 taps would be `full`
    inside = sum(max(h - abs(ky - 1) * d, 0) * max(w - abs(kx - 1) * d, 0)
                 for d in aspp.DILATIONS for ky in range(3) for kx in range(3))
    n_ops = 2 * inside * cin * cout
    full = 2 * h * w * 27 * cin * cout
    n_bytes = (x.numel() + wts.numel() + h * w * 3 * cout) * 2
    bd = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    log(f"[k4] stage B {tuple(x.shape)} -> 3x{cout} bf16, tile "
        f"{list(aspp.aspp_tile(h, w, cin, cout))}: kernel {ms:.4f} ms "
        f"({full / ms / 1e9:.1f} TFLOP/s counting all taps; wrapper with "
        f"weight prep {wrapper_ms:.4f}), plain {plain_ms:.4f} ms, library "
        f"(3 cuDNN convs, ReLU, cat) {library_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bytes']} B, "
        f"{bd['ops']} ops in the image of {full})")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"]}


# ---------------------------------------------------------------------------
# 4. forward on the card against the CPU
# ---------------------------------------------------------------------------

def phase_forward():
    """DeepLabV3-R50 at 65x65, f32: the card against the port's CPU run on
    the same params, from NHWC and from phase planes (stem conv through
    K2 on the card), and the card's phases logits against its NHWC ones;
    each within 1e-3 x max|logit|."""
    cfg = dict(R101_CFG, backbone="resnet50")
    graph = build_model("deeplabv3", **cfg).graph
    params, state = init_graph(graph, torch.Generator().manual_seed(0),
                               device="cpu")
    image = np.random.default_rng(0).standard_normal(
        (1, 65, 65, 3)).astype(np.float32)
    phases = np.stack([extract_stem_phases(image[0])])
    inputs = {"nhwc": torch.from_numpy(image),
              "phases": torch.from_numpy(phases)}
    outs = {}
    for fmt, x in inputs.items():
        for dev in ("cpu", "cuda"):
            fn, p = make_inference_fn(graph, params, state,
                                      dtype=torch.float32, output="logits",
                                      input_format=fmt, input_hw=(65, 65),
                                      device=dev)
            outs[fmt, dev] = fn(p, x).cpu()

    def compare(got, ref, what):
        if got.shape != (1, 65, 65, 19) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"R50 forward: bad logits {got.shape}")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"[forward] DeepLabV3-R50 1x65x65 f32 {what}: max|diff| "
            f"{err:.3g}, max|logit| {scale:.3g}, ratio {err / scale:.3g}")
        if err > 1e-3 * scale:
            raise AssertionError(f"R50 forward: {what} differ")

    compare(outs["nhwc", "cuda"], outs["nhwc", "cpu"], "card vs CPU")
    compare(outs["phases", "cuda"], outs["phases", "cpu"],
            "phases card vs CPU")
    compare(outs["phases", "cuda"], outs["nhwc", "cuda"],
            "phases vs nhwc on the card")


# ---------------------------------------------------------------------------
# 5. serving the main path
# ---------------------------------------------------------------------------

def _kernel_class(name):
    low = name.lower()
    if "resize_argmax" in low:
        return "K1 resize_argmax"
    if "stem_mma_kernel" in low or "stem_fma_kernel" in low:
        return "K2 stem_conv3x3_s2"
    if "bottleneck_kernel" in low:
        return "K3 fused_bottleneck"
    if "::mm_kernel<" in low or "::transpose_kernel<" in low:
        return "K5 tiled_mm"  # csrc/int8_mm.cu: the product, b's transpose
    if any(t in low for t in ("conv", "fprop", "cudnn")):
        return "convolution"
    if any(t in low for t in ("gemm", "gemv", "nvjet")):
        return "matmul"
    return "other (elementwise, copies, pools)"


def profile_requests(request, n=5, tag=""):
    """Where one request's device time goes: torch.profiler over ``n``
    requests after a warm one; kernel time by class, the top kernels, and
    the device's busy share of the window's wall time (logged and
    returned)."""
    from torch.profiler import ProfilerActivity, profile
    request()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            request()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_us, ops_us = {}, {}
    for avg in prof.key_averages():
        if avg.device_type == torch.autograd.DeviceType.CUDA:
            kernels_us[avg.key] = (kernels_us.get(avg.key, 0.0)
                                   + avg.self_device_time_total)
        elif avg.key.startswith("aten::"):
            ops_us[avg.key] = avg.device_time_total  # includes nested ops
    busy_us = sum(kernels_us.values())
    by_class = {}
    for name, us in kernels_us.items():
        by_class[_kernel_class(name)] = by_class.get(_kernel_class(name),
                                                     0.0) + us
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    top_ops = sorted(ops_us.items(), key=lambda kv: -kv[1])[:10]
    summary = {
        "requests": n, "wall_ms_per_request": wall_us / n / 1e3,
        "device_busy_ms_per_request": busy_us / n / 1e3,
        "device_busy_share": busy_us / wall_us if wall_us else None,
        "ms_per_request_by_class": {k: v / n / 1e3
                                    for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_request": [[k[:80], v / n / 1e3]
                                       for k, v in top],
        "top_ops_device_ms_per_request": [[k, v / n / 1e3]
                                          for k, v in top_ops]}
    log(f"[profile{tag}] " + json.dumps(summary))
    return summary


def phase_serve():
    torch.backends.cudnn.benchmark = True  # deploy: autotune conv algos
    model = build_model("deeplabv3", **R101_CFG)
    graph = model.graph
    params, state = init_graph(graph, torch.Generator().manual_seed(0),
                               device="cuda")
    # With random weights the deep features are small beside the
    # classifier's bias, and every pixel would get the same class; without
    # the bias the labels follow the image and K1 has real work to check.
    params["last_conv.6"]["bias"].zero_()
    # bench.py's synthetic EIC: only the surviving channel counts matter
    rng = np.random.default_rng(0)
    eic = {bn: np.abs(rng.standard_normal(
        graph.node(bn).attrs["channels"])).astype(np.float32)
        for bn in prunable_bn_names(graph)}
    t0 = time.perf_counter()
    np_params, np_state = params_to_numpy(params, state)
    result, gp, report = prune_to_flops(
        graph, graph, np_params, np_state, eic, prune_ratio=0.5,
        layer_keep=0.02, except_start_keys=(), channel_align=128)
    pparams, pstate = params_from_numpy(result.params, result.state,
                                        device="cuda")
    log(f"[serve] prune: global_percent {gp}, flops_ratio "
        f"{report['flops_ratio']:.4f}, params "
        f"{report['pruned_params'] / 1e6:.2f}M of "
        f"{report['base_params'] / 1e6:.2f}M, "
        f"{time.perf_counter() - t0:.1f} s")
    if gp != 0.58 or round(report["flops_ratio"], 4) != 0.4694:
        raise AssertionError("prune search left the bench configuration")

    kw = dict(dtype=torch.bfloat16, fold_bn=True, output="argmax",
              input_format="nchw")
    fn, dev_params = make_inference_fn(result.graph, pparams, pstate, **kw)
    images = [rng.uniform(-1, 1, (1, 3) + MAIN_OUT).astype(np.float32)
              for _ in range(4)]
    requests = [torch.from_numpy(im).cuda() for im in images]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts from 0, 4 requests, counts read after
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    answers = []
    for i, image in enumerate(requests):
        before = kernels.LAUNCHES["resize_argmax"]
        labels = fn(dev_params, image)
        if kernels.LAUNCHES["resize_argmax"] != before + 1:
            raise AssertionError(f"request {i}: K1 did not run exactly once")
        answers.append(labels)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for i, labels in enumerate(answers):
        if (labels.shape != (1,) + MAIN_OUT or labels.dtype != torch.uint8
                or int(labels.max()) >= 19):
            raise AssertionError(f"request {i}: bad labels {labels.shape}")
    hist = [torch.bincount(a.flatten().long(), minlength=19).tolist()
            for a in answers]
    log(f"[serve] 4 requests answered; K1 launches {launches}; "
        f"classes present per request {[sum(h > 0 for h in x) for x in hist]}")
    peak = torch.cuda.max_memory_allocated()

    # K1 on one request's low-res logits against the plain tail
    body, tail, p = make_split_inference_fn(result.graph, pparams, pstate,
                                            **kw)
    z = body(p, requests[0])
    k1_labels = tail(z, MAIN_OUT)
    if not torch.equal(k1_labels, answers[0]):
        raise AssertionError("split body+tail differs from make_inference_fn")
    layout = ("channels_last" if z.is_contiguous(
        memory_format=torch.channels_last) else "NCHW" if z.is_contiguous()
        else "strided")
    log(f"[serve] request 0 low-res logits {tuple(z.shape)} {z.dtype} "
        f"{layout}, std {float(z.float().std()):.3g}, "
        f"max|z| {float(z.abs().max()):.3g}")
    serve_check = near_tie_check(k1_labels, z.permute(0, 2, 3, 1), MAIN_OUT,
                                 True, "serving request 0 logits")

    pruned = benchmark(lambda img: fn(dev_params, img), requests[0],
                       warmup=10, iters=50, blocks=3)
    profile_requests(lambda: fn(dev_params, requests[1]))
    del body, p, z
    phases = phase_serve_phases(result.graph, pparams, pstate, images,
                                answers)
    # the two paths in turns: nchw, phases, phases (above), nchw
    pruned_again = benchmark(lambda img: fn(dev_params, img), requests[0],
                             warmup=10, iters=50, blocks=3)
    k4_case = aspp_case(result.graph, pparams, pstate, dev_params,
                        requests[0])
    del fn, dev_params
    ufn, udev = make_inference_fn(graph, params, state, **kw)
    unpruned = benchmark(lambda img: ufn(udev, img), requests[0],
                         warmup=10, iters=50, blocks=3)
    summary = {
        "pruned_ms_per_img": pruned["ms_per_batch"],
        "pruned_img_per_s": pruned["images_per_sec"],
        "pruned_ms_blocks": pruned["ms_blocks"],
        "unpruned_ms_per_img": unpruned["ms_per_batch"],
        "unpruned_img_per_s": unpruned["images_per_sec"],
        "unpruned_ms_blocks": unpruned["ms_blocks"],
        "pruned_again_ms_per_img": pruned_again["ms_per_batch"],
        "pruned_again_ms_blocks": pruned_again["ms_blocks"],
        "phases_ms_per_img": phases["timing"][0]["ms_per_batch"],
        "phases_img_per_s": phases["timing"][0]["images_per_sec"],
        "phases_ms_blocks": phases["timing"][0]["ms_blocks"],
        "phases_again_ms_per_img": phases["timing"][1]["ms_per_batch"],
        "phases_again_ms_blocks": phases["timing"][1]["ms_blocks"],
        "phases_vs_nchw_label_agreement": phases["agreement"],
        "speedup_pruned_vs_unpruned": (unpruned["ms_per_batch"]
                                       / pruned["ms_per_batch"]),
        "global_percent": gp, "flops_ratio": report["flops_ratio"],
        "pruned_params": report["pruned_params"],
        "max_memory_allocated_bytes": peak,
    }
    log("[serve] " + json.dumps(summary))
    return (launches, serve_check, phases, k4_case,
            (result.graph, pparams, pstate))


def phase_serve_phases(graph, pparams, pstate, images, nchw_answers):
    """The pruned R101 served from stride-2 phase planes: the planes of
    the 4 request images built on the host with ``extract_stem_phases``,
    answered by ``make_inference_fn(input_format="phases")`` with K2 and
    K1 each launched once per request (counts set to 0 before, read
    after); K2 on request 0's planes against its plain version; label
    agreement with the NCHW path (printed, not asserted: with random
    weights the logits' margins lie below bf16 resolution); the path
    timed twice and profiled."""
    requests = [torch.from_numpy(np.stack([extract_stem_phases(
        np.ascontiguousarray(im[0].transpose(1, 2, 0)))])).cuda()
        for im in images]
    fn, dev_params = make_inference_fn(
        graph, pparams, pstate, dtype=torch.bfloat16, fold_bn=True,
        output="argmax", input_format="phases", input_hw=MAIN_OUT)
    torch.cuda.synchronize()

    # -- the phases path: counts from 0, 4 requests, counts read after
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    answers = []
    for i, ph in enumerate(requests):
        before = dict(kernels.LAUNCHES)
        answers.append(fn(dev_params, ph))
        for k in ("stem_conv3x3_s2", "resize_argmax"):
            if kernels.LAUNCHES[k] != before[k] + 1:
                raise AssertionError(f"phases request {i}: {k} did not run "
                                     "exactly once")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    agreement = []
    for i, labels in enumerate(answers):
        if (labels.shape != (1,) + MAIN_OUT or labels.dtype != torch.uint8
                or int(labels.max()) >= 19):
            raise AssertionError(f"phases request {i}: bad labels "
                                 f"{labels.shape}")
        agreement.append(float((labels == nchw_answers[i]).float().mean()))
    log(f"[serve] phases: {len(requests)} requests {tuple(requests[0].shape)}"
        f" f32 answered; launches {launches}; label agreement with the "
        f"nchw path per request {agreement}")

    # K2 on request 0's planes against its plain version (bf16 rule)
    from dcfp_tpu_torch.ops.stem import stem_plan
    stem = stem_plan(graph)[1]
    sp = dev_params[stem]
    ph0 = requests[0].to(torch.bfloat16)
    out_hw = ((MAIN_OUT[0] + 1) // 2, (MAIN_OUT[1] + 1) // 2)
    # K2 on the weights the path prepared once, the plain version from
    # the folded conv's own kernel and bias
    got = kernels.stem_conv3x3_s2_prepared(ph0, sp["k2_taps"], sp["k2_bias"],
                                           out_hw)
    ref = kernels.stem_conv3x3_s2_plain(
        ph0.float(), sp["kernel"].float(), sp["bias"].float(), out_hw)
    err = bf16_ulp_check(got, ref, "serving request 0 stem conv")
    log(f"[serve] phases: K2 ({stem}, {tuple(sp['kernel'].shape)}) on "
        f"request 0 vs plain: max_abs_err {err:.3g}")

    timing = [benchmark(lambda x: fn(dev_params, x), requests[0], warmup=10,
                        iters=50, blocks=3) for _ in range(2)]
    profile_requests(lambda: fn(dev_params, requests[1]), tag=" phases")
    return {"launches": launches, "agreement": agreement,
            "k2_max_abs_err": err, "timing": timing}


# ---------------------------------------------------------------------------
# 5b. the conv epilogue (bias, residual add, ReLU) of the served body
# ---------------------------------------------------------------------------

# the serving cell's configuration: its pruned widths are in the file
EPI_CONFIG = "perfbench/configs/deeplabv3_r101_p50.json"
EPI_FRAMES = 4


def _cl_copy(t, off=0):
    """A channels_last copy of (N, C, H, W) ``t`` that starts ``off``
    elements into a fresh buffer, so an odd ``off`` puts its data_ptr()
    off the 16-byte grain."""
    n, c, h, w = t.shape
    buf = torch.empty(n * h * w * c + off, dtype=t.dtype, device=t.device)
    return buf[off:].view(n, h, w, c).permute(0, 3, 1, 2).copy_(t)


def epilogue_model(seed=0, device="cuda"):
    """The serving cell's pruned DeepLabV3-R101 (widths from
    ``EPI_CONFIG``) with seeded weights on the card: He-normal kernels,
    random BN statistics (so that the fold makes real biases), the
    classifier's bias zero.  Returns (graph, params, state)."""
    with open(EPI_CONFIG) as f:
        desc = json.load(f)
    graph = apply_channel_cfg(build_model(
        desc["model"], backbone=desc["backbone"],
        backbone_para=desc["backbone_para"],
        num_classes=desc["num_classes"], align_corner=desc["align_corner"],
        deepsup=desc["deepsup"]).graph, desc["channel_cfg"])
    params, state = init_graph(graph, torch.Generator().manual_seed(seed),
                               device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for node in graph.toposorted():
        if node.op == "conv":
            k = params[node.name]["kernel"]
            fan_in = k.shape[1] * k.shape[2] * k.shape[3]
            k.copy_(torch.randn(k.shape, generator=gen, device=device)
                    * (2.0 / fan_in) ** 0.5)
        elif node.op == "bn":
            u = torch.rand((4, node.attrs["channels"]), generator=gen,
                           device=device)
            params[node.name] = {"scale": u[0] + 0.5,
                                 "bias": (u[1] - 0.5) * 0.2}
            state[node.name] = {"mean": (u[2] - 0.5) * 0.2, "var": u[3] + 0.5}
    for node in graph.conv_nodes():
        if node.attrs["bias"]:
            params[node.name]["bias"].zero_()  # the classifier
    return graph, params, state


def epilogue_sites(graph, params, state, hw=MAIN_OUT):
    """(conv, (N, C, H, W), residual?, relu?) of every conv epilogue of
    the served body (``fuse_conv_epilogues`` on the folded graph without
    its K1 tail) at input ``hw``, batch 1."""
    folded, _, _ = fold_batchnorm(graph, params, state)
    body = fuse_conv_epilogues(split_pred_tail(folded)[0])
    shapes = infer_shapes(body, hw)
    return [(n.name, (1, n.attrs["out_ch"]) + tuple(shapes[n.name]),
             len(n.inputs) == 2, n.attrs["epilogue"] == "relu")
            for n in body.conv_nodes() if "epilogue" in n.attrs]


def deploy_eval_launches(graph, params, state, images):
    """The launches that ``images`` images of batch 1 make on the card on
    the Predictor's label path (the deploy body, not spatially sharded,
    and K1): the body's conv epilogues (:func:`epilogue_sites`) and K1,
    each once an image, and nothing else."""
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want["resize_argmax"] = images
    want["conv_epilogue"] = images * len(epilogue_sites(graph, params,
                                                        state))
    return want


def _epilogue_case(tag, x, b, r, relu):
    """One epilogue launch against its plain version on the card: every
    value within 1 ulp of its type (bf16, f16) or equal (f32).  Returns
    (values not bit-equal, max|diff|)."""
    before = kernels.LAUNCHES["conv_epilogue"]
    got = kernels.conv_epilogue(x, b, r, relu=relu)
    if kernels.LAUNCHES["conv_epilogue"] != before + x.is_cuda:
        raise AssertionError(f"{tag}: the epilogue did not launch once")
    if not got.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError(f"{tag}: the output is not channels_last")
    ref = kernels.conv_epilogue_plain(x, b, r, relu)
    g, f = got.float(), ref.float()
    diff = (g - f).abs()
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}
    mag = torch.maximum(g.abs(), f.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant[x.dtype])
    bad = int((diff > ulp).sum()) if x.dtype != torch.float32 else \
        int((diff > 0).sum())
    if bad or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{tag}: {bad} values off the plain version")
    return int((diff > 0).sum()), float(diff.max())


def _epilogue_operands(shape, residual, dtype, gen, off=0):
    """Seeded x, bias and residual (or None), channels_last, ``off``
    elements into their buffers."""
    dev = gen.device
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    b = torch.randn(shape[1], generator=gen, device=dev).to(dtype)
    r = (torch.randn(shape, generator=gen, device=dev).to(dtype)
         if residual else None)
    return _cl_copy(x, off), b, None if r is None else _cl_copy(r, off)


def _epilogue_frame_ms(sites, gen):
    """Device ms of one frame's epilogues, all ``sites`` on seeded bf16
    operands, each way timed in a CUDA graph: the kernel, its plain
    version, and the aten passes the unrewritten body ran (the conv's
    in-place bias add, the residual add, ReLU).  With the bytes the
    kernel must move (x and the residual read once, y written once, the
    bias) and their bound at the HBM rate."""
    ops = [(_epilogue_operands(shape, res, torch.bfloat16, gen), relu)
           for _, shape, res, relu in sites]
    n_bytes = sum(x.numel() * 2 * (3 if r is not None else 2) + b.numel() * 2
                  for (x, b, r), _ in ops)

    def kernel():
        for (x, b, r), relu in ops:
            kernels.conv_epilogue(x, b, r, relu=relu)

    def plain():
        for (x, b, r), relu in ops:
            kernels.conv_epilogue_plain(x, b, r, relu)

    def library():
        for (x, b, r), relu in ops:
            y = x.add_(b[:, None, None])
            if r is not None:
                y = y + r
            if relu:
                y = torch.relu(y)

    before = kernels.LAUNCHES["conv_epilogue"]
    times = {"kernel_ms": graph_ms(kernel, reps=2, iters=5),
             "plain_ms": graph_ms(plain, reps=2, iters=5),
             "library_ms": graph_ms(library, reps=2, iters=5)}
    kernels.LAUNCHES["conv_epilogue"] = before  # warm-up and capture
    times.update(bound(n_bytes, 0, BF16_OPS_PER_S))
    times["achieved_tb_per_s"] = n_bytes / times["kernel_ms"] / 1e9
    return times


def _epilogue_not_channels_last(body, params, image):
    """Shapes of the epilogues of one eager run of ``body`` whose x or
    residual is not channels_last, which the CUDA op would copy first."""
    from dcfp_tpu_torch.graph import apply as apply_mod
    real, misses = apply_mod.conv_epilogue, []

    def spy(x, bias, residual=None, relu=False):
        if not all(t.is_contiguous(memory_format=torch.channels_last)
                   for t in (x,) + (() if residual is None else (residual,))):
            misses.append(tuple(x.shape))
        return real(x, bias, residual, relu=relu)

    apply_mod.conv_epilogue = spy
    try:
        body(params, image)
    finally:
        apply_mod.conv_epilogue = real
    return misses


def _aten_elementwise(kernel_names):
    """The aten kernels among ``kernel_names`` that add or clamp: the
    bias add, residual add and ReLU that the epilogue takes over."""
    return sorted(k for k in kernel_names if "at::native" in k and any(
        t in k.lower() for t in ("functor_add", "add_kernel", "clamp",
                                 "relu", "threshold")))


def phase_epilogue(device="cuda", hw=MAIN_OUT):
    """The conv epilogue (``csrc/epilogue.cu``) on the serving cell's
    body: (a) each launch of a frame's body (its distinct shapes, bf16)
    against the plain version, within 1 ulp, and the scalar path (the
    classifier's 19 channels, operands 2 bytes off 16, f16 and f32);
    (b) one frame's 115 epilogues timed beside their bound, plain and
    aten times; (c) the captured body + K1 serving 4 requests: 115
    epilogue launches a request, no aten add or clamp kernel in a
    profiled request, and the logits' distance from the f32 body beside
    the unrewritten bf16 body's, every epilogue operand of the eager
    body channels_last; (d) the deploy artifact exported with
    the operator in it, reloaded, its labels against the captured
    ones.  One ``{"epilogue": ...}`` line.  ``device="cpu"`` (with a
    small ``hw``) rehearses it on the plain versions, untimed."""
    torch.backends.cudnn.benchmark = True  # deploy: autotune conv algos
    cuda = device == "cuda"
    graph, params, state = epilogue_model(device=device)
    sites = epilogue_sites(graph, params, state, hw)
    gen = torch.Generator(device=device).manual_seed(1)
    out = {"sites": len(sites), "relu": sum(s[3] for s in sites),
           "residual": sum(s[2] for s in sites)}

    # (a) every distinct launch of the body, then the scalar path
    cases = {}
    for shape, res, relu in sorted(set(s[1:] for s in sites)):
        x, b, r = _epilogue_operands(shape, res, torch.bfloat16, gen)
        tag = f"{shape} bf16 residual={res} relu={relu}"
        cases[tag] = _epilogue_case(tag, x, b, r, relu)
    big = max((s for s in sites if s[2]), key=lambda s: s[1][1] * s[1][2])
    # (shape, residual, dtype, element offset): the scalar path (offset
    # 1, 19 channels), f16 and f32, a batch of 2
    odd = [(big[1], True, torch.bfloat16, 1),
           (big[1], False, torch.bfloat16, 1),
           (big[1], True, torch.float16, 0),
           (big[1], True, torch.float32, 0),
           ((1, 19, 129, 257), True, torch.float32, 0),
           ((2, 24, 33, 65), True, torch.bfloat16, 0)]
    for shape, res, dtype, off in odd:
        x, b, r = _epilogue_operands(shape, res, dtype, gen, off)
        tag = f"{shape} {dtype} residual={res} offset={off}"
        cases[tag] = _epilogue_case(tag, x, b, r, True)
    out["cases"] = len(cases)
    out["values_not_bit_equal"] = sum(v[0] for v in cases.values())
    out["max_abs_err"] = max(v[1] for v in cases.values())
    log(f"[epilogue] {len(cases)} cases within 1 ulp of the plain version; "
        f"values not bit-equal {out['values_not_bit_equal']}")

    # (b) one frame's epilogues, timed
    if cuda:
        out["frame"] = _epilogue_frame_ms(sites, gen)
        torch.cuda.empty_cache()
        log(f"[epilogue] a frame's {len(sites)} launches: " +
            json.dumps(out["frame"]))

    # (c) the captured serving path
    kw = dict(dtype=torch.bfloat16, fold_bn=True, output="argmax",
              input_format="nchw")
    body, tail, dev = make_split_inference_fn(graph, params, state,
                                              device=device, **kw)
    shape = (1, 3) + tuple(hw)
    frames = [torch.randn(shape, generator=gen, device=device)
              for _ in range(EPI_FRAMES)]
    if cuda:  # the body's layout: the op copies no operand
        misses = _epilogue_not_channels_last(body, dev, frames[0])
        if misses:
            raise AssertionError(f"epilogue operands not channels_last: "
                                 f"{misses}")
    served = aot_compile_split(body, tail, dev, shape, input_format="nchw",
                               device=device)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    answers = [served(dev, f).clone() for f in frames]
    launches = dict(kernels.LAUNCHES)
    if launches["conv_epilogue"] != cuda * EPI_FRAMES * len(sites) or \
            launches["resize_argmax"] != cuda * EPI_FRAMES:
        raise AssertionError(f"serving launches {launches}")
    out["launches"] = launches
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            served(dev, frames[0])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        log("[epilogue] a captured request's kernels: " + json.dumps(
            sorted(((e.key[:90], e.count) for e in events),
                   key=lambda kv: -kv[1])))
        aten = _aten_elementwise(e.key for e in events)
        if aten:
            raise AssertionError(f"aten add/clamp kernels in the body: "
                                 f"{aten}")
        # cuDNN's layout transposes: none once every conv of the body
        # reads channels_last
        out["request_layout_transposes"] = sum(
            e.count for e in events
            if "nchwToNhwc" in e.key or "nhwcToNchw" in e.key)
        out["request_epilogue_ms"] = sum(
            e.self_device_time_total for e in events
            if "epilogue_elementwise_kernel" in e.key) / 1e3
    z = body(dev, frames[0]).float()
    folded, fparams, fstate = fold_batchnorm(graph, params, state)
    plain_body, pred = split_pred_tail(folded)
    fdev = {n: {k: v.to(torch.bfloat16) for k, v in d.items()}
            for n, d in fparams.items()}
    with torch.inference_mode():
        feed = {graph.inputs[0]: frames[0].to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)}
        old = graph_apply(plain_body, fdev, fstate, feed,
                          channels_first=True)[0][pred.inputs[0]].float()
        body32, _, dev32 = make_split_inference_fn(
            graph, params, state, device=device,
            **dict(kw, dtype=torch.float32))
        ref = body32(dev32, frames[0]).float()
    norm = torch.linalg.vector_norm
    out["logit_rel_l2_vs_f32"] = float(norm(z - ref) / norm(ref))
    out["unrewritten_logit_rel_l2_vs_f32"] = float(norm(old - ref) /
                                                   norm(ref))
    del body32, dev32, old, ref

    # (d) the deploy artifact
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.pt2")
        export_serialized_split(body, tail, dev, shape, path,
                                input_format="nchw")
        with open(path, "rb") as f:
            program = torch.export.load(f)
        n_ops = sum(n.op == "call_function" and "conv_epilogue" in
                    str(n.target) for n in program.graph.nodes)
        if n_ops != len(sites):
            raise AssertionError(f"exported body holds {n_ops} epilogues")
        run = load_serialized(path)
        agree = [float((run(dev, f) == a).float().mean())
                 for f, a in zip(frames, answers)]
    if min(agree) < 0.999:
        raise AssertionError(f"exported labels agree {agree}")
    out["exported_epilogues"] = n_ops
    out["exported_label_agreement"] = agree
    log(json.dumps({"epilogue": out}))
    return out


# ---------------------------------------------------------------------------
# the int8 deploy (K5 on every conv, K1 tail) and the forward-traced prune
# ---------------------------------------------------------------------------

INT8_CALIB = 4  # seeded calibration images
INT8_FRAMES = 4  # requests of the main path


def _int8_checked_convs(graph):
    """Convs whose accumulators ``phase_int8`` holds exactly against the
    plain float64 conv: the stem's first (K = 27 -> 32 columns), the
    first 1x1, the most dilated 3x3, a strided one after the stem and
    the projection over a concat."""
    convs = list(graph.conv_nodes())
    picked = {convs[0].name}
    picked.add(next(c.name for c in convs if c.attrs["kernel"] == 1))
    picked.add(max(convs, key=lambda c: c.attrs["dilation"]).name)
    picked.add(next(c.name for c in convs[1:] if c.attrs["stride"] > 1))
    cat = [c.name for c in convs if graph.node(c.inputs[0]).op == "concat"]
    picked.update(cat[:1])
    return [c for c in convs if c.name in picked]


def _k5_frame_bound(qparams, rows):
    """K5's bound on one int8 frame: each quantized conv is one product of
    its (M, K) shifted-slice matrix and its (K, N) GEMM matrix
    (``engine/quantize.py``: K padded to 16, N to 4; M the conv's output
    pixels), which must read both once and write the (M, N) int32
    accumulators once.  Each product's bound is the longer of its bytes
    over the HBM rate and its 2 M K N operations over the dense int8
    peak; the frame's is their sum, the products running one after the
    other."""
    total = 0.0
    by = {"bytes": 0, "operations": 0}
    n_bytes = n_ops = 0
    for name, m in rows.items():
        k, n = (int(v) for v in qparams[name]["w_mat"].shape)
        b = bound(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS_PER_S)
        total += b["bound_ms"]
        by[b["bound_by"]] += 1
        n_bytes += b["bytes"]
        n_ops += b["ops"]
    return {"products": len(rows), "bound_ms": total,
            "products_bound_by": by, "bytes": n_bytes, "ops": n_ops}


def phase_int8(served=None, device="cuda", hw=MAIN_OUT, frames=INT8_FRAMES,
               calib=INT8_CALIB, iters=50):
    """The int8 PTQ deploy (``engine/quantize.py``) of the served pruned
    R101 (``phase_serve``'s model; built here when ``served`` is None) at
    1025x2049, batch 1, bf16 compute: BN folded, calibrated on ``calib``
    seeded images (absmax), weights per output channel.  Checks, on one
    frame, the int32 accumulators of ``_int8_checked_convs`` through K5
    equal to the plain float64 conv of the same int8 input; then the
    main path, ``frames`` requests with the counts set to 0 before: K5
    once per quantized conv of each frame (> 0), K1 once a frame, labels
    of 19 classes at most that vary; the int8 labels' agreement with the
    bf16 deploy's (``make_inference_fn``, autotuned) on the same frames
    (>= 0.9), and both timed with the totrt.py protocol (10 warmup + 50
    timed, median of 3 blocks); a device profile of 3 int8 requests.
    Prints one ``{"int8": ...}`` line.
    ``device="cpu"`` with a small ``hw`` dry-runs it on the CPU."""
    from dcfp_tpu_torch.engine import quantize as q
    t_phase = time.perf_counter()
    cuda = device == "cuda"
    card = card_name_and_power() if cuda else "cpu"
    if served is None:
        model = build_model("deeplabv3", **R101_CFG)
        params, state = init_graph(model.graph,
                                   torch.Generator().manual_seed(0),
                                   device=device)
        params["last_conv.6"]["bias"].zero_()
        rng = np.random.default_rng(0)
        eic = {bn: np.abs(rng.standard_normal(
            model.graph.node(bn).attrs["channels"])).astype(np.float32)
            for bn in prunable_bn_names(model.graph)}
        res, _, _ = prune_to_flops(
            model.graph, model.graph, *params_to_numpy(params, state), eic,
            prune_ratio=0.5, layer_keep=0.02, except_start_keys=(),
            channel_align=128)
        served = (res.graph, *params_from_numpy(res.params, res.state,
                                                device=device))
    graph, pparams, pstate = served
    rng = np.random.default_rng(8)

    def image():
        x = rng.uniform(-1, 1, (1,) + tuple(hw) + (3,)).astype(np.float32)
        return torch.from_numpy(x).to(device)

    calib_images = [image().cpu().numpy() for _ in range(calib)]
    t0 = time.perf_counter()
    fn, bundle = q.make_int8_inference_fn(
        graph, pparams, pstate, calib_batches=calib_images,
        output="argmax", compute_dtype=torch.bfloat16, device=device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_q = len(bundle["q"])
    n_conv = len(list(graph.conv_nodes()))
    requests = [image() for _ in range(frames)]

    # -- the accumulators of a few convs, K5 against the float64 conv
    fg, _, fs = fold_batchnorm(graph, pparams, pstate)
    body, _ = split_pred_tail(fg)
    checked = _int8_checked_convs(fg)
    want_inputs = {c.inputs[0] for c in checked}
    seen, k5_rows = {}, {}

    def observe(name, value):
        if name in want_inputs:
            seen[name] = value
        if name in bundle["q"]:  # a K5 product's M: the output pixels
            v = value.q if isinstance(value, q._QT) else value
            k5_rows[name] = int(v.shape[0] * v.shape[2] * v.shape[3])

    scales = bundle["scales"]
    q.quant_graph_apply(body, bundle["f"], fs, bundle["q"],
                        {body.inputs[0]: requests[0]},
                        compute_dtype=torch.bfloat16, tensor_scales=scales,
                        observe=observe)
    acc_check = {}
    for c in checked:
        x_q = q._to_q(seen[c.inputs[0]], scales[c.inputs[0]])
        got = q.qconv_acc(x_q, bundle["q"][c.name], c.attrs)
        ref = q._qconv_plain(x_q, bundle["q"][c.name]["w_q"], c.attrs)
        if got.dtype != torch.int32 or not torch.equal(got, ref):
            raise AssertionError(f"int8: conv {c.name} accumulators differ "
                                 "from the plain float64 conv")
        a = c.attrs
        acc_check[c.name] = {
            "k": a["kernel"], "s": a["stride"], "d": a["dilation"],
            "cin": a["in_ch"], "cout": a["out_ch"],
            "rows": int(got.shape[0] * got.shape[2] * got.shape[3]),
            "max_abs_acc": int(got.abs().max())}
    del seen
    k5_bound = _k5_frame_bound(bundle["q"], k5_rows) if cuda else None
    log(f"[int8] {n_q} of {n_conv} convs int8, setup (fold, calibrate on "
        f"{calib}, quantize) {setup_s:.2f} s; accumulators equal to the "
        f"float64 conv: {json.dumps(acc_check)}")

    # -- the main path: counts from 0, the requests, counts read after
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    answers = []
    for i, x in enumerate(requests):
        before = dict(kernels.LAUNCHES)
        labels = fn(bundle, x)
        d = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        if cuda and (d["tiled_mm"] != n_q or d["resize_argmax"] != 1
                     or any(v for k, v in d.items()
                            if k not in ("tiled_mm", "resize_argmax"))):
            raise AssertionError(f"int8 request {i}: launches {d}, want "
                                 f"{n_q} of K5 and 1 of K1")
        answers.append(labels)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if cuda and launches["tiled_mm"] <= 0:
        raise AssertionError("int8: K5 never launched")
    classes = set()
    for i, labels in enumerate(answers):
        if (tuple(labels.shape) != (1,) + tuple(hw)
                or labels.dtype != torch.uint8 or int(labels.max()) >= 19):
            raise AssertionError(f"int8 request {i}: bad labels")
        classes |= set(torch.unique(labels).tolist())
    if len(classes) < 2:
        raise AssertionError("int8: the labels do not vary")

    # -- the bf16 deploy on the same frames, then both timed in turns
    bfn, bdev = make_inference_fn(graph, pparams, pstate,
                                  dtype=torch.bfloat16, output="argmax",
                                  device=device)
    with autotuned() if cuda else contextlib.nullcontext():
        bf16 = [bfn(bdev, x) for x in requests]
        agree = float(np.mean([float((a == b).float().mean())
                               for a, b in zip(answers, bf16)]))
        blocks = 3 if cuda else 1
        warm = 10 if cuda else 1
        t_int8 = benchmark(lambda x: fn(bundle, x), requests[0], warmup=warm,
                           iters=iters, blocks=blocks)
        t_bf16 = benchmark(lambda x: bfn(bdev, x), requests[0], warmup=warm,
                           iters=iters, blocks=blocks)
    profile = (profile_requests(lambda: fn(bundle, requests[1]), n=3,
                                tag=" int8") if cuda else None)
    out = {"card": card, "convs_int8": n_q, "convs": n_conv,
           "calib_images": calib, "setup_s": setup_s,
           "k5_launches_per_frame": launches["tiled_mm"] / frames,
           "k1_launches_per_frame": launches["resize_argmax"] / frames,
           "launches": launches, "accumulators_checked": acc_check,
           "classes": len(classes), "int8_vs_bf16_agreement": agree,
           "int8_ms_per_img": t_int8["ms_per_batch"],
           "int8_ms_blocks": t_int8["ms_blocks"],
           "bf16_ms_per_img": t_bf16["ms_per_batch"],
           "bf16_ms_blocks": t_bf16["ms_blocks"],
           "int8_profile_ms_by_class": (
               profile["ms_per_request_by_class"] if profile else None),
           "k5_frame_bound": k5_bound,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"int8": out}))
    if agree < 0.9:
        raise AssertionError(f"int8: labels agree with bf16's on {agree}")
    return out


def phase_prune_trace(device="cuda"):
    """The forward-traced topology (``prune/fx_trace.py``) of the flagship
    train graph (DeepLabV3-R50, os 8, mg [1, 2, 4], inplanes 128,
    deepsup) at 512x512 on fake tensors, against the IR trace: no
    mismatch.  Then prune.sh's command (``--prune-ratio 0.6``) on one
    snapshot of that model (random weights, seed 0, a seeded EIC) with
    ``--trace verify`` and with ``--trace ir``: both return 0 and write
    the same ``pruned.msgpack`` and ``channel_cfg.msgpack``, byte for
    byte.  Prints one ``{"prune_trace": ...}`` line."""
    from dcfp_tpu_torch.prune.fx_trace import (topology_mismatches,
                                               trace_topology_fx)
    from dcfp_tpu_torch.prune.trace import trace_topology
    t_phase = time.perf_counter()
    card = card_name_and_power() if device == "cuda" else "cpu"
    graph = build_model("deeplabv3", **FLAGSHIP_CFG).graph
    p, s = init_graph(graph, torch.Generator().manual_seed(0), device="cpu")
    t0 = time.perf_counter()
    topo_fx = trace_topology_fx(graph, p, s, (1, 512, 512, 3))
    fx_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    topo_ir = trace_topology(graph)
    ir_s = time.perf_counter() - t0
    bad = topology_mismatches(topo_ir, topo_fx)
    if bad:
        raise AssertionError("prune_trace: the forward-traced topology "
                             f"differs from the IR's: {bad}")
    rng = np.random.default_rng(5)
    eic = {bn: np.abs(rng.standard_normal(
        graph.node(bn).attrs["channels"])).astype(np.float32)
        for bn in prunable_bn_names(graph)}
    times, launches, files = {}, {}, {}
    saved = os.environ.get("DCFP_PLATFORM")
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "snapshot.msgpack")
        score = os.path.join(tmp, "score.msgpack")
        ckpt.save_pruned(snap, p, s)
        ckpt.save_eic(score, eic)
        if device == "cpu":
            os.environ["DCFP_PLATFORM"] = "cpu"
        try:
            for trace in ("verify", "ir"):
                out = os.path.join(tmp, trace)
                _run_cli(f"prune:{trace}", CLI_MODEL + [
                    "--model-path", snap, "--score-path", score,
                    "--prune-ratio", CLI_PRUNE_RATIO, "--trace", trace,
                    "--save-path", out], times, launches)
                files[trace] = {
                    name: open(os.path.join(out, name), "rb").read()
                    for name in ("pruned.msgpack", "channel_cfg.msgpack")}
        finally:
            if saved is None:
                os.environ.pop("DCFP_PLATFORM", None)
            else:
                os.environ["DCFP_PLATFORM"] = saved
    if files["verify"] != files["ir"]:
        raise AssertionError("prune_trace: --trace verify and --trace ir "
                             "wrote different files")
    out = {"card": card, "fx_trace_512_s": fx_s, "ir_trace_s": ir_s,
           "coupling_groups": len(topo_fx.spaces),
           "bn_links": len(topo_fx.norm_conv), "mismatches": 0,
           "cli_s": times, "pruned_bytes": len(
               files["ir"]["pruned.msgpack"]),
           "artifacts_byte_equal": True,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"prune_trace": out}))
    return out


# ---------------------------------------------------------------------------
# 7. the train step
# ---------------------------------------------------------------------------

# the flagship train model (__graft_entry__._flagship with deepsup)
FLAGSHIP_CFG = dict(R101_CFG, backbone="resnet50", deepsup=True)
NORMALIZE = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _train_batch(rng, n, hw, compact):
    """GSRL labels with ~5% ignored pixels.  Compact: uint8 image, the
    ``pad`` triple set on half the images (every other one flipped),
    uint8 labels and a (n, 20) ``weight_class``; else an f32 image and
    an f32 per-pixel weight map."""
    ori = rng.integers(0, 19, (n, hw, hw))
    ori[rng.random((n, hw, hw)) < 0.05] = 255
    if not compact:
        return {"img": rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
                "label": {"ori": ori, "weight": rng.uniform(
                    0.5, 2.0, (n, hw, hw)).astype(np.float32)}}
    wc = rng.uniform(0.05, 1.0, (n, 20)).astype(np.float32)
    wc[:, -1] = 0.0
    pad = np.array([[hw, hw, 0] if i % 2 == 0 else
                    [hw - 57, hw - 101, (i // 2) % 2] for i in range(n)],
                   np.int32)
    return {"img": rng.integers(0, 256, (n, hw, hw, 3)).astype(np.uint8),
            "label": {"ori": ori.astype(np.uint8), "weight_class": wc},
            "pad": pad}


def _update_agreement(new, ref, old):
    """The relative L2 error of the whole update ``new - old`` against
    ``ref - old``, each tensor's cosine and norm ratio, and the largest
    per-tensor max|diff| / max|ref update|."""
    num = den = worst = 0.0
    cos, ratio = [], []
    for n in old:
        for k in old[n]:
            a = (new[n][k] - old[n][k]).ravel().astype(np.float64)
            b = (ref[n][k] - old[n][k]).ravel().astype(np.float64)
            num += ((a - b) ** 2).sum()
            den += (b ** 2).sum()
            cos.append(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            ratio.append(np.linalg.norm(a) / np.linalg.norm(b))
            worst = max(worst, np.abs(a - b).max() / np.abs(b).max())
    return (float(np.sqrt(num / den)), float(min(cos)), float(min(ratio)),
            float(max(ratio)), float(worst))


def _vec_rel_l2(a, b):
    a = np.concatenate([a[n] for n in b]).astype(np.float64)
    b = np.concatenate([b[n] for n in b]).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def train_card_vs_cpu(n=2, hw=65, device="cuda"):
    """One flagship GSRL + EIC + SGD step (lr 0.01, momentum 0.9, wd 5e-4,
    warmup -1) on the card and on the CPU from the same numpy params and
    batch, dropout off, TF32 off.  The f32 train-mode step at this size is
    ill-conditioned (batch-2 BN moments), so the update is held against
    the CPU step's own noise: the same step with the image scaled by
    1 + 2^-22.  Holds: loss rtol 1e-4; BN running statistics within
    1e-3 x max|value|; the whole update's relative L2 error within 2x
    that noise (and 0.1), each tensor's cosine >= 0.99 and norm ratio
    within 5%; EIC within 2x the noise, a flipped channel only where
    |g w| <= 0.05 x max|g w|."""
    lr, wd = 0.01, 5e-4
    model = build_model("deeplabv3", **FLAGSHIP_CFG)
    params, state = init_graph(model.graph, torch.Generator().manual_seed(0),
                               device="cpu")
    np_p, np_s = params_to_numpy(params, state)
    crit = build_criterions("gsrl", ignore_label=255)
    batch = _train_batch(np.random.default_rng(1), n, hw, compact=False)
    nudged = dict(batch, img=batch["img"] * np.float32(1 + 2.0 ** -22))

    def one(dev, b):
        opt = build_optimizer(optim="sgd", learning_rate=lr, momentum=0.9,
                              weight_decay=wd, num_steps=100, warmup=-1)
        p, s = params_from_numpy(np_p, np_s, device=dev)
        st = create_train_state(model, p, s, opt, prune_type="dcfp",
                                device=dev)
        new, m = make_train_step(model, crit, opt, device=dev)(st, b)
        newp, news = params_to_numpy(new.params, new.bn_state)
        return (newp, news, eic_to_numpy(new.eic), float(m["loss"]),
                float(m["grad_norm"]))

    t0 = time.perf_counter()
    card = one(device, batch)
    cpu = one("cpu", batch)
    noise = one("cpu", nudged)
    secs = time.perf_counter() - t0
    loss_rel = abs(card[3] - cpu[3]) / abs(cpu[3])
    bn_worst = max(float(np.abs(card[1][b][k] - cpu[1][b][k]).max()
                         / np.abs(cpu[1][b][k]).max())
                   for b in cpu[1] for k in cpu[1][b])
    err, cos, rmin, rmax, worst = _update_agreement(card[0], cpu[0], np_p)
    noise_err = _update_agreement(noise[0], cpu[0], np_p)[0]
    eic_err = _vec_rel_l2(card[2], cpu[2])
    eic_noise = _vec_rel_l2(noise[2], cpu[2])
    gw = {b: np.abs(((cpu[0][b]["scale"] - np_p[b]["scale"]) / -lr
                     - wd * np_p[b]["scale"]) * np_p[b]["scale"])
          for b in cpu[2]}
    gw_max = max(v.max() for v in gw.values())
    flips = bad_flips = 0
    for b in cpu[2]:
        flipped = (card[2][b] > 0) != (cpu[2][b] > 0)
        flips += int(flipped.sum())
        bad_flips += int((gw[b][flipped] > 0.05 * gw_max).sum())
    summary = {
        "batch": [n, hw, hw], "loss_card": card[3], "loss_cpu": cpu[3],
        "loss_rel_err": loss_rel, "grad_norm_card": card[4],
        "grad_norm_cpu": cpu[4], "bn_stats_max_err_rel_to_max": bn_worst,
        "update_rel_l2": err, "cpu_self_noise_update_rel_l2": noise_err,
        "update_min_cos": cos, "update_norm_ratio": [rmin, rmax],
        "update_max_err_rel_to_max_update": worst,
        "eic_rel_l2": eic_err, "cpu_self_noise_eic_rel_l2": eic_noise,
        "eic_flipped_channels": flips, "eic_flips_above_5pct_gw": bad_flips,
        "seconds": secs}
    log("[train] card vs CPU, one flagship GSRL+EIC+SGD step, f32, TF32 "
        "off: " + json.dumps(summary))
    if not (loss_rel <= 1e-4 and bn_worst <= 1e-3
            and err <= min(2 * noise_err, 0.1) and cos >= 0.99
            and 0.95 <= rmin and rmax <= 1.05
            and eic_err <= 2 * eic_noise and bad_flips == 0):
        raise AssertionError("train step: the card and the CPU differ")
    return summary


def train_recipe(n=8, hw=769, steps=6, device="cuda"):
    """The finetune.sh GSRL recipe on the flagship with EIC: batch 8,
    769x769, f32, deepsup (ds_weight 0.4), SGD lr 0.01, momentum 0.9,
    wd 0.001, warmup 1000, 36000 steps, spatial dropout from a seeded
    generator; ``TrainLoop`` for ``steps`` steps on compact batches with
    PyTorch's default TF32 setting.  If the batch does not fit, it runs
    again with ``remat_segments=2``."""
    model = build_model("deeplabv3", **FLAGSHIP_CFG)
    params, state = init_graph(model.graph, torch.Generator().manual_seed(0),
                               device=device)
    rng = np.random.default_rng(2)
    batches = [_train_batch(rng, n, hw, compact=True) for _ in range(2)]
    opt = build_optimizer(optim="sgd", learning_rate=0.01, momentum=0.9,
                          weight_decay=0.001, num_steps=36000, warmup=1000)
    crit = build_criterions("gsrl", ignore_label=255,
                            loss_para={"ds_weight": 0.4})
    tf32 = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.benchmark": torch.backends.cudnn.benchmark}
    tries = []
    for remat in (0, 2):
        times, seen = [], []

        def hook(st, step):
            torch.cuda.synchronize()
            times.append(time.perf_counter())
            seen.append(step)

        state0 = create_train_state(model, params, state, opt,
                                    prune_type="dcfp", device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "metrics.jsonl")
            loop = TrainLoop(model=model, criterion=crit, optimizer=opt,
                             num_steps=steps, lr_schedule=opt.schedule,
                             save_pred_every=1, snapshot_hook=hook,
                             log_every=1, prune_type="dcfp",
                             normalize=NORMALIZE, metrics_file=path,
                             remat_segments=remat)
            t0 = time.perf_counter()
            try:
                final = loop.run(state0, itertools.cycle(batches),
                                 generator=torch.Generator().manual_seed(3),
                                 device=device)
            except torch.cuda.OutOfMemoryError as exc:
                tries.append({"remat_segments": remat, "fit": False,
                              "peak_bytes": torch.cuda.max_memory_allocated(),
                              "error": str(exc).splitlines()[0][:200]})
                log(f"[train] recipe step at remat_segments={remat} ran out "
                    f"of memory: {tries[-1]}")
                del state0, loop
                torch.cuda.empty_cache()
                continue
            with open(path) as f:
                lines = [json.loads(ln) for ln in f]
        peak = torch.cuda.max_memory_allocated()
        tries.append({"remat_segments": remat, "fit": True,
                      "peak_bytes": peak})
        break
    else:
        raise AssertionError(f"train recipe: no try fit the card: {tries}")
    step_ms = np.diff([t0] + times) * 1e3
    med = float(np.median(step_ms[2:6]))
    nonzero = sum(int((v > 0).sum()) for v in final.eic.values())
    total = sum(v.numel() for v in final.eic.values())
    moved = any(not torch.equal(final.bn_state[b][k], state[b][k])
                for b in state for k in state[b])
    result = {
        "batch": [n, hw, hw], "dtype": "float32", "steps": steps,
        "tf32": tf32, "tries": tries, "step_ms": step_ms.tolist(),
        "median_ms_steps_3_to_6": med, "img_per_s": n * 1e3 / med,
        "max_memory_allocated_bytes": peak,
        "loss": [ln["loss"] for ln in lines],
        "grad_norm": [ln["grad_norm"] for ln in lines],
        "lr": [ln["lr"] for ln in lines],
        "eic_nonzero_channels": [nonzero, total],
        "bn_running_stats_moved": moved, "snapshot_steps": seen}
    log("[train] recipe: " + json.dumps(result))
    if not all(np.isfinite(result["loss"] + result["grad_norm"])):
        raise AssertionError("train recipe: a loss or grad norm is not finite")
    if nonzero == 0:
        raise AssertionError("train recipe: the EIC is all zero")
    if not seen or seen[-1] != steps:
        raise AssertionError(f"train recipe: no snapshot at step {steps}")
    if len(lines) != steps:
        raise AssertionError(f"train recipe: {len(lines)} metrics lines")
    if not moved:
        raise AssertionError("train recipe: BN running stats did not move")
    return result


def train_remat_replay(n=2, hw=129, device="cuda"):
    """One flagship GSRL step with remat_segments=4 against the same step
    without remat, same generator seed (the deepsup dropout is live),
    TF32 off and deterministic cuDNN: each tensor's update within 1e-5 x
    its max |update|, the loss and BN statistics equal."""
    model = build_model("deeplabv3", **FLAGSHIP_CFG)
    params, state = init_graph(model.graph, torch.Generator().manual_seed(0),
                               device=device)
    batch = _train_batch(np.random.default_rng(4), n, hw, compact=False)
    crit = build_criterions("gsrl", ignore_label=255)
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        runs = []
        for segs in (0, 4):
            opt = build_optimizer(optim="sgd", learning_rate=0.01,
                                  num_steps=100)
            st = create_train_state(model, params, state, opt, device=device)
            step = make_train_step(model, crit, opt, device=device,
                                   remat_segments=segs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            new, m = step(st, batch, torch.Generator().manual_seed(5))
            torch.cuda.synchronize()
            runs.append((new, float(m["loss"]),
                         torch.cuda.max_memory_allocated()))
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    (plain, l0, peak0), (remat, l1, peak1) = runs
    worst = 0.0
    for b in params:
        for k in params[b]:
            du0 = plain.params[b][k] - params[b][k]
            du1 = remat.params[b][k] - params[b][k]
            worst = max(worst, float((du1 - du0).abs().max()
                                     / du0.abs().max()))
    bn_equal = all(torch.equal(plain.bn_state[b][k], remat.bn_state[b][k])
                   for b in state for k in state[b])
    result = {"batch": [n, hw, hw], "loss_plain": l0, "loss_remat4": l1,
              "update_max_err_rel_to_max_update": worst,
              "bn_stats_equal": bn_equal, "peak_bytes_plain": peak0,
              "peak_bytes_remat4": peak1}
    log("[train] remat replay: " + json.dumps(result))
    if not (worst <= 1e-5 and l0 == l1 and bn_equal):
        raise AssertionError("train step: remat_segments=4 differs")
    return result


def phase_train():
    """The train step on the card: against the CPU, the recipe at full
    width, and the remat replay.  The train path launches none of K1-K6:
    the counts are set to 0 before and read after."""
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    vs_cpu = train_card_vs_cpu()
    # PyTorch's defaults for the recipe's step: cuDNN TF32 on, matmul
    # TF32 off, no cuDNN autotuning (serving turned it on; on an H100 its
    # search took 69 s and an 80.9 GB peak of trial workspaces in the
    # first train step, which the peak-memory reading would report)
    cudnn = torch.backends.cudnn
    serving_benchmark = cudnn.benchmark
    cudnn.allow_tf32, cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        recipe = train_recipe()
    finally:
        cudnn.allow_tf32, cudnn.benchmark = False, serving_benchmark
    torch.cuda.empty_cache()
    remat = train_remat_replay()
    launches = dict(kernels.LAUNCHES)
    log(f"[train] kernel launches during the train phase (K1-K6 are not on "
        f"the train path): {launches}")
    if any(launches.values()):
        raise AssertionError("the train path launched a kernel")
    torch.cuda.empty_cache()
    return {"vs_cpu": vs_cpu, "recipe": recipe, "remat": remat}


# ---------------------------------------------------------------------------
# 7b. the EIC horizon: TF32 against f32 over the steps the EMA integrates
# ---------------------------------------------------------------------------

HORIZON_STEPS = 200
HORIZON_CHECKPOINTS = [50, 100, 200]
HORIZON_HW = 257
HORIZON_BATCH = 2


def phase_horizon():
    """``prune/horizon.card_horizon`` on the flagship R50 (deepsup,
    dropout 0): CE + EIC pretraining for 200 steps of 2 x 257^2 crops of
    the long-tail stream, three times from one init: f32 (A), f32 from
    the init x (1 + 1e-6) (B, the floor) and TF32 (C), with cuDNN's
    deterministic algorithms.  Holds ``check_row`` (every per-checkpoint
    gate of ``check_rows``) at steps 50, 100 and 200 on
    ``horizon_rows(C, A, B)`` and on A against C next to A's own floor
    B, and every run's loss falling; prints the Pearson gap's growth
    from 50 to 200 without gating it: over 200 steps the gap is near or
    below 0 and moves by a few hundredths with the draw (PERF.md),
    where the rule was set for a positive gap shrinking over thousands
    of steps.  K1-K6 are not on this path (counts set to 0
    before, read after)."""
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    cudnn = torch.backends.cudnn
    serving_benchmark = cudnn.benchmark
    cudnn.benchmark = False
    t0 = time.perf_counter()
    try:
        result = horizon.card_horizon(HORIZON_STEPS, HORIZON_HW,
                                      HORIZON_BATCH, HORIZON_CHECKPOINTS)
    finally:
        cudnn.benchmark = serving_benchmark
    result["launches"] = dict(kernels.LAUNCHES)
    result["phase_s"] = time.perf_counter() - t0
    result["pearson_gap_first_last"] = {
        key: [horizon.pearson_gap(result[key][0]),
              horizon.pearson_gap(result[key][-1])]
        for key in ("rows", "rows_f32_own_floor")}
    log(json.dumps({"horizon": result}))
    for row in result["rows"] + result["rows_f32_own_floor"]:
        horizon.check_row(row)
    horizon.check_losses_fall(result)
    if any(result["launches"].values()):
        raise AssertionError("the horizon path launched a kernel")
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# 8. eval
# ---------------------------------------------------------------------------

# the recipe's model (__graft_entry__._flagship, no deepsup) and its eval
# modes: scripts/cs/deploy.sh:28-34 (whole, ss, bf16, 1025x2049) and
# scripts/cs/finetune.sh:46-63 (whole, ms 0.5-1.75 + flip, f32)
EVAL_CFG = dict(FLAGSHIP_CFG, deepsup=False)
EVAL_HW = (1024, 2048)
EVAL_MS = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
EVAL_TILE = (769, 769)
# card against CPU: 125x250 pads to 129x257 (pad_inf)
SMALL_HW = (125, 250)
SMALL_MODES = {"ss": dict(whole=True),
               "ms_flip": dict(whole=True, scales=(0.75, 1.0, 1.25),
                               flip=True),
               "sliding": dict(whole=False, tile_size=(97, 97)),
               "boundary": dict(whole=True, iou_type="boundary")}


def _eval_items(n, hw, seed):
    """``n`` seeded batches of one, as classic items (the image
    host-normalized to f32, int64 labels) and as compact items (the same
    pixels as raw uint8, uint8 labels); ~5% of the labels are 255."""
    rng = np.random.default_rng(seed)
    mean, std = (np.asarray(v, np.float32) for v in NORMALIZE)
    classic, compact = [], []
    for i in range(n):
        raw = rng.integers(0, 256, (1, *hw, 3), dtype=np.uint8)
        label = rng.integers(0, 19, (1, *hw), dtype=np.uint8)
        label[rng.random(label.shape) < 0.05] = 255
        meta = [{"name": f"eval{i}"}]
        classic.append({"img": normalize_f32(raw.astype(np.float32), mean,
                                             std),
                        "label": label.astype(np.int64), "img_meta": meta})
        compact.append({"img": raw, "label": label, "img_meta": meta})
    return classic, compact


def _valid_pixels(items):
    return int(sum((it["label"] != 255).sum() for it in items))


class _Cycle:
    """``n`` batches taken in turn from ``items``: a val pass of ``n``
    images fed from a few held in memory."""

    def __init__(self, items, n):
        self.items, self.n = items, n

    def __len__(self):
        return self.n

    def __iter__(self):
        return (self.items[i % len(self.items)] for i in range(self.n))


# the deploy eval's loops: 5 untimed images (evaluate's default warmup),
# then two flush periods of the pipelined loop (evaluate_pipelined's
# flush_every is 128)
EVAL_WARMUP, EVAL_TIMED, EVAL_FLUSH = 5, 256, 128


def _rss_bytes():
    """This process's resident bytes (Linux), or None."""
    with open("/proc/self/status") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key == "VmRSS":
                return int(val.split()[0]) * 1024
    return None


def host_profile(run, images, names):
    """cProfile of ``run()`` (a loop over ``images`` images): host ms an
    image spent inside each function of ``names`` (cumulative;
    ``"file.py:func"`` for a Python function, a bare name for a method
    written in C), the rest of the wall time (``names`` must not nest),
    and the top functions by own time.  Under Python 3.12 cProfile keeps
    no record of a frame that enters ``torch.inference_mode``, nor of its
    callers, so ``names`` holds none of those."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    cum = {n: 0.0 for n in names}
    for (path, _, func), (_, _, _, ct, _) in stats.items():
        where = f"{os.path.basename(path)}:{func}"
        for n in names:
            if n == where or func.startswith(f"<method '{n}' "):
                cum[n] += ct
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    return {"images": images, "wall_ms_per_image": wall * 1e3 / images,
            "cum_ms_per_image": {n: v * 1e3 / images
                                 for n, v in cum.items()},
            "rest_ms_per_image": (wall - sum(cum.values())) * 1e3 / images,
            "top_own_ms_per_image": [
                [f"{os.path.basename(k[0])}:{k[1]}:{k[2]}"[:90],
                 v[2] * 1e3 / images] for k, v in top]}


# the pipelined loop's host work an image besides the forward, as
# cProfile names it: padding, the pinned copy and its H2D issue, the
# label cast, compact items' normalize, the confusion update, the flushes
# (the rest is the forward's issue and the loop itself)
PIPELINE_HOST_FUNCS = (
    "evaluator.py:_pad_hw", "evaluator.py:_to_device_async", "astype",
    "evaluator.py:prep_raw", "evaluator.py:confusion_update_device",
    "evaluator.py:flush")


def pipeline_profile(pred, items, kw):
    """Where a pipelined loop's time goes, over 64 images after its
    warmup: the host side by cProfile, then the device's busy share of
    the loop's wall time by torch.profiler (each run alone)."""
    n = EVAL_WARMUP + 64
    host = host_profile(
        lambda: evaluate(pred, _Cycle(items, n), pipeline=True, **kw), n,
        PIPELINE_HOST_FUNCS)
    dev = profile_requests(
        lambda: evaluate(pred, _Cycle(items, 16), pipeline=True, **kw), n=1,
        tag=" pipelined loop, 16 images")
    return {"host": host,
            "device_busy_share": dev["device_busy_share"],
            "device_busy_ms_per_image": dev["device_busy_ms_per_request"] / 16,
            "profiled_wall_ms_per_image": dev["wall_ms_per_request"] / 16}


@contextlib.contextmanager
def sync_calls(record):
    """Append to ``record`` the place of every synchronizing CUDA call
    made in the block (``torch.cuda.set_sync_debug_mode("warn")``)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (setting the mode warns too, that the mode is a prototype)
    record.extend(f"{os.path.basename(w.filename)}:{w.lineno}"
                  for w in caught
                  if "called a synchronizing CUDA operation"
                  in str(w.message))


def eval_deploy(graph, params, state, classic, compact):
    """(a) the deploy eval: bf16, whole image, single scale, padded to
    1025x2049; the protocol loop, the pipelined loop and the pipelined
    loop on compact items, each over ``EVAL_WARMUP + EVAL_TIMED`` images
    taken in turn from the four, with the launch counts set to 0 before
    and read after.  The three confusion matrices must be identical, K1
    and the body's conv epilogues launched once an image a loop
    (:func:`deploy_eval_launches`) and nothing else, and each pipelined loop must make no
    synchronizing call but its flushes (at its warmup, every
    ``EVAL_FLUSH`` images and at its end).  Each pipelined loop's pinned
    host memory and resident set are read around it; then both pipelined
    loops are profiled, host and device."""
    pred = Predictor(graph, params, state, dtype=torch.bfloat16,
                     align_corner=True, normalize=NORMALIZE)
    kw = dict(num_classes=19, whole=True, align_corner=True,
              fps_warmup=EVAL_WARMUP)
    n = EVAL_WARMUP + EVAL_TIMED
    flushes = 2 + EVAL_TIMED // EVAL_FLUSH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    loops = {"protocol": evaluate(pred, _Cycle(classic, n), **kw)}
    walls = {"protocol": time.perf_counter() - t0}
    syncs, host_mem = {}, {}
    for name, items in (("pipelined", classic),
                        ("compact_pipelined", compact)):
        syncs[name] = []
        if hasattr(torch.cuda, "reset_peak_host_memory_stats"):
            torch.cuda.reset_peak_host_memory_stats()
        rss0 = _rss_bytes()
        t0 = time.perf_counter()
        with sync_calls(syncs[name]):
            loops[name] = evaluate(pred, _Cycle(items, n), pipeline=True,
                                   **kw)
        walls[name] = time.perf_counter() - t0
        pinned = (torch.cuda.host_memory_stats()
                  if hasattr(torch.cuda, "host_memory_stats") else {})
        rss1 = _rss_bytes()
        host_mem[name] = {
            "pinned_peak_bytes": pinned.get("allocated_bytes.peak"),
            "pinned_active_peak_bytes": pinned.get("active_bytes.peak"),
            "pinned_blocks_made": pinned.get("num_host_alloc"),
            "rss_before_bytes": rss0, "rss_after_bytes": rss1}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = deploy_eval_launches(graph, params, state, n * len(loops))
    if launches != want:
        raise AssertionError(f"deploy eval: launches {launches}, expected "
                             f"{want}")
    cm = loops["protocol"]["confusion"]
    if cm.sum() != _valid_pixels(list(_Cycle(classic, n))):
        raise AssertionError("deploy eval: confusion does not count every "
                             "labelled pixel")
    for name in syncs:
        if not np.array_equal(loops[name]["confusion"], cm):
            diff = np.abs(loops[name]["confusion"] - cm).sum()
            raise AssertionError(f"deploy eval: the {name} loop's confusion "
                                 f"differs from the protocol loop's by {diff}")
        if len(syncs[name]) > flushes:
            raise AssertionError(f"deploy eval: the {name} loop made "
                                 f"{len(syncs[name])} synchronizing calls "
                                 f"({flushes} flushes expected): "
                                 f"{syncs[name][:8]}")
    profiles = {name: pipeline_profile(pred, items, kw)
                for name, items in (("pipelined", classic),
                                    ("compact_pipelined", compact))}
    image = np.pad(classic[0]["img"], ((0, 0), (0, 1), (0, 1), (0, 0)))
    dev_img = pred.device_put(image)
    prof = profile_requests(lambda: pred.predict_whole_labels(dev_img),
                            tag=" eval")
    labels0 = pred.predict_whole_labels(dev_img)[:, :EVAL_HW[0],
                                                 :EVAL_HW[1]].cpu().numpy()
    summary = {
        "images_held": len(classic), "images_a_loop": n,
        "timed_a_loop": EVAL_TIMED, "dtype": "bfloat16",
        "input_hw": list(dev_img.shape[1:3]),
        "fps": {k: v["fps"] for k, v in loops.items()},
        "loop_img_per_s": {k: n / v for k, v in walls.items()},
        "meanIU": loops["protocol"]["meanIU"],
        "confusion_identical": True,
        "k1_launches": launches["resize_argmax"],
        "k1_launches_expected": want["resize_argmax"],
        "epilogue_launches": launches["conv_epilogue"],
        "epilogue_launches_expected": want["conv_epilogue"],
        "sync_calls": syncs,
        "flushes_a_pipelined_loop": flushes,
        "host_memory": host_mem,
        "pipelined_profile": profiles,
        "peak_bytes": peak,
        "profile_wall_ms_per_image": prof["wall_ms_per_request"],
        "profile_device_busy_share": prof["device_busy_share"],
        "k1_ms_per_image": prof["ms_per_request_by_class"].get(
            "K1 resize_argmax"),
        "classes_in_image0": int((np.bincount(labels0.ravel(),
                                              minlength=19) > 0).sum())}
    log("[eval] deploy: " + json.dumps(summary))
    return summary, labels0


def eval_boundary(graph, params, state, classic, labels0):
    """(d) boundary IoU: the device erosion on image 0's deploy labels
    stacked with its labels (dilation_ratio 0.02: 46 erosions at
    1024x2048), timed from host arrays and on the device alone; then the
    protocol loop with ``iou_type="boundary"`` on two images."""
    stack = np.concatenate([labels0.astype(np.int64), classic[0]["label"]])
    dilation = max(int(round(0.02 * np.hypot(*EVAL_HW))), 1)
    host = profiling.timeit(lambda: mask_to_boundary_device(stack, 19),
                            warmup=1, iters=3)
    dev_stack = torch.from_numpy(stack.astype(np.int32)).to("cuda")
    device = profiling.timeit(lambda: edge._boundary(dev_stack, dilation, 19,
                                                     255), warmup=1, iters=3)
    bnd = mask_to_boundary_device(stack, 19)
    kept = bnd != 255
    if bnd.shape != stack.shape or not bool(
            (bnd[kept] == stack[kept]).all()):
        raise AssertionError("boundary: a kept pixel changed its class")
    pred = Predictor(graph, params, state, dtype=torch.bfloat16,
                     align_corner=True)
    res = evaluate(pred, classic[:2], num_classes=19, whole=True,
                   align_corner=True, fps_warmup=1, iou_type="boundary")
    summary = {"dilation": dilation, "stack": list(stack.shape),
               "ms": host["ms"], "device_ms": device["ms"],
               "boundary_share": float(kept.mean()),
               "eval_meanIU": res["meanIU"],
               "eval_counted_pixels": float(res["confusion"].sum())}
    log("[eval] boundary: " + json.dumps(summary))
    return summary


# (b) and (c): images timed after one untimed, each mode's count chosen
# to keep its loop near 3 s on the card
EVAL_F32_TIMED = {"multiscale_flip": 4, "sliding": 16}


def eval_f32_modes(graph, params, state, classic):
    """(b) the finetune eval, f32 whole image, ms 0.5-1.75 + flip, and (c)
    sliding 769x769 tiles (8 in one forward at 1024x2048), each in the
    protocol loop over one untimed image and ``EVAL_F32_TIMED`` timed
    ones taken in turn from the four: ms an image (the loop's bracket,
    and its whole wall time), and the peak memory."""
    pred = Predictor(graph, params, state, dtype=torch.float32,
                     align_corner=True)
    n_tiles = len(Predictor._tile_boxes(*EVAL_HW, *EVAL_TILE, 1 / 3))
    out = {}
    for name, kw in (("multiscale_flip", dict(whole=True, scales=EVAL_MS,
                                              flip=True)),
                     ("sliding", dict(whole=False, tile_size=EVAL_TILE))):
        items = list(_Cycle(classic, 1 + EVAL_F32_TIMED[name]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = evaluate(pred, items, num_classes=19, align_corner=True,
                       fps_warmup=1, **kw)
        wall = time.perf_counter() - t0
        if res["confusion"].sum() != _valid_pixels(items):
            raise AssertionError(f"{name}: confusion does not count every "
                                 "labelled pixel")
        out[name] = {"timed_images": EVAL_F32_TIMED[name],
                     "ms_per_image": 1000.0 / res["fps"],
                     "loop_ms_per_image": wall * 1e3 / len(items),
                     "meanIU": res["meanIU"],
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    out["sliding"]["tiles"] = n_tiles
    out["multiscale_flip"]["scales"] = list(EVAL_MS)
    log("[eval] f32 modes: " + json.dumps(out))
    return out


def _small_labels(pred, image, kw):
    """One small image through a mode's prediction path, as ``evaluate``
    runs it: (labels, the raw graph's logits it decides on)."""
    h, w = image.shape[1:3]
    if kw["whole"]:
        ph, pw = pad_inf((h, w))
        image = np.pad(image, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)))
    if kw["whole"] and "scales" not in kw:
        labels = pred.predict_whole_labels(image)[:, :h, :w]
        logits = pred.predict_whole(image)[:, :h, :w]
    else:
        logits = pred.predict_multiscale(
            image, kw.get("tile_size", EVAL_TILE), kw.get("scales", (1.0,)),
            19, kw.get("flip", False), True, kw["whole"],
            return_probs=True)[:, :h, :w]
        labels = torch.argmax(logits, -1)
    return labels.cpu().numpy().astype(np.uint8), logits.cpu().numpy()


def eval_card_vs_cpu(graph, params, state):
    """(e) every mode once more at 125x250 (padded to 129x257), f32, TF32
    off, on the CPU and on the card: labels may differ only at near-ties
    (top-2 margin of the CPU's logits <= 1e-4 x max|logit|), and the
    confusion by at most 2 counts a differing pixel (boundary mode: a
    pixel within the erosion's reach of one).  The card's pipelined ss
    loop equals its protocol loop, and the device erosion of a stack is
    identical on both."""
    classic, _ = _eval_items(2, SMALL_HW, seed=1)
    preds = {dev: Predictor(graph, params, state, dtype=torch.float32,
                            align_corner=True, device=dev)
             for dev in ("cpu", "cuda")}
    reach = max(int(round(0.02 * np.hypot(*SMALL_HW))), 1)
    out = {}
    for mode, mkw in SMALL_MODES.items():
        kw = dict(num_classes=19, align_corner=True, fps_warmup=0, **mkw)
        cms = {dev: evaluate(p, classic, **kw)["confusion"]
               for dev, p in preds.items()}
        n_diff = n_tie = n_reach = 0
        for item in classic:
            (lc, ref), (lg, _) = (_small_labels(preds[d], item["img"], mkw)
                                  for d in ("cpu", "cuda"))
            top2 = np.sort(ref, -1)[..., -2:]
            tie = (top2[..., 1] - top2[..., 0]) <= 1e-4 * np.abs(ref).max()
            diff = lc != lg
            if (diff & ~tie).any():
                raise AssertionError(f"card vs CPU {mode}: "
                                     f"{int((diff & ~tie).sum())} labels "
                                     "differ away from near-ties")
            n_diff += int(diff.sum())
            n_tie += int(tie.sum())
            n_reach += int(F.max_pool2d(
                torch.from_numpy(diff).float(), 2 * reach + 1, stride=1,
                padding=reach).sum())
        moved = float(np.abs(cms["cpu"] - cms["cuda"]).sum())
        allowed = 2 * (n_reach if mode == "boundary" else n_diff)
        if moved > allowed:
            raise AssertionError(f"card vs CPU {mode}: confusion moved by "
                                 f"{moved} (allowed {allowed})")
        out[mode] = {"differing_pixels": n_diff, "near_tie_pixels": n_tie,
                     "confusion_moved": moved,
                     "counted_pixels": float(cms["cuda"].sum())}
    kw = dict(num_classes=19, whole=True, align_corner=True, fps_warmup=0)
    pipe = evaluate(preds["cuda"], classic, pipeline=True, **kw)
    if not np.array_equal(pipe["confusion"],
                          evaluate(preds["cuda"], classic, **kw)["confusion"]):
        raise AssertionError("card: pipelined ss differs from protocol")
    stack = np.concatenate([it["label"] for it in classic])
    if not np.array_equal(mask_to_boundary_device(stack, 19),
                          mask_to_boundary_device(stack, 19, device="cpu")):
        raise AssertionError("boundary erosion: card differs from CPU")
    out["pixels_per_mode"] = int(np.prod(SMALL_HW)) * len(classic)
    log("[eval] card vs CPU: " + json.dumps(out))
    return out


def phase_eval():
    """The port's eval on the recipe's model (DeepLabV3-R50, random
    weights from seed 0, classifier bias zeroed as in serving) over four
    seeded 1024x2048 images fed in memory: (a) deploy eval, (b) finetune
    multi-scale + flip, (c) sliding, (d) boundary IoU, (e) card against
    CPU.  Prints one ``{"eval": ...}`` line."""
    graph = build_model("deeplabv3", **EVAL_CFG).graph
    params, state = init_graph(graph, torch.Generator().manual_seed(0),
                               device="cpu")
    params["last_conv.6"]["bias"].zero_()
    classic, compact = _eval_items(4, EVAL_HW, seed=0)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    try:
        # the deploy path autotuned, as served
        cudnn.benchmark = True
        deploy, labels0 = eval_deploy(graph, params, state, classic, compact)
        boundary = eval_boundary(graph, params, state, classic, labels0)
        torch.cuda.empty_cache()
        # f32 with PyTorch's defaults: cuDNN TF32 on, no autotuning (it
        # would search again at every scale's shapes)
        cudnn.benchmark, cudnn.allow_tf32 = False, True
        f32 = eval_f32_modes(graph, params, state, classic)
        torch.cuda.empty_cache()
        cudnn.allow_tf32 = matmul.allow_tf32 = False
        vs_cpu = eval_card_vs_cpu(graph, params, state)
    finally:
        cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = saved
    torch.cuda.empty_cache()
    result = {"model": "deeplabv3-resnet50 os8 mg[1,2,4] stem128 19 classes",
              "image_hw": list(EVAL_HW), "deploy": deploy,
              "boundary": boundary, **f32, "card_vs_cpu": vs_cpu}
    print(json.dumps({"eval": result}), flush=True)
    return result


# ---------------------------------------------------------------------------
# 9. the recipe through files
# ---------------------------------------------------------------------------

# scripts/cs/{pretrain,prune,finetune}.sh on the flagship R50 at full
# width, every stage handing its result to the next through files: 16
# train and 16 val frames at 1024x2048 on disk, 6 steps a training stage
DATA_HW = (1024, 2048)
DATA_IMAGES = 16
DATA_VAL_REPEAT = 4  # the val manifest lists each image 4 times: 5 + 59
DATA_BATCH, DATA_CROP, DATA_STEPS = 8, (769, 769), 6
DATA_SEED = 42  # the scripts' --random-seed
DATA_STALL_S = "120"  # a wedged decode pool fails the phase, not the call
DATA_ALONE_EVAL = 32  # val lines each eval loader is timed alone over
DATA_PROFILED_ITEMS = 4  # train items profiled in this process


def _dir_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def data_fixture(root, hw=DATA_HW, n=DATA_IMAGES):
    """The Cityscapes fixture (``make_cityscapes_fixture``, train seed 0,
    val seed 1), the val manifest that lists each image
    ``DATA_VAL_REPEAT`` times, and the label index of the train split.
    Its images are uniform noise, which PNG cannot compress: larger files
    and slower decodes than real frames."""
    import cv2
    t0 = time.perf_counter()
    train = make_cityscapes_fixture(root, n_images=n, hw=hw, seed=0,
                                    split="train")
    val = make_cityscapes_fixture(root, n_images=n, hw=hw, seed=1,
                                  split="val")
    write_s = time.perf_counter() - t0
    nbytes = _dir_bytes(root)
    with open(val) as f:
        lines = [ln for ln in f if ln.strip()]
    val_rep = os.path.join(root, "val_repeated.lst")
    with open(val_rep, "w") as f:
        f.write("".join(lines * DATA_VAL_REPEAT))
    index = os.path.join(root, "label_index_CS.pkl")
    t0 = time.perf_counter()
    build_label_index(build_dataset("CS", root, train, split="train"), index)
    index_s = time.perf_counter() - t0
    pairs = [ln.split() for ln in lines]
    t0 = time.perf_counter()
    for img, _ in pairs:
        cv2.imread(os.path.join(root, img), cv2.IMREAD_COLOR)
    img_ms = (time.perf_counter() - t0) * 1e3 / len(pairs)
    t0 = time.perf_counter()
    for _, lab in pairs:
        cv2.imread(os.path.join(root, lab), cv2.IMREAD_GRAYSCALE)
    lab_ms = (time.perf_counter() - t0) * 1e3 / len(pairs)
    summary = {"images": [n, n], "hw": list(hw), "write_s": write_s,
               "bytes": nbytes,
               "image_png_bytes_mean": float(np.mean([os.path.getsize(
                   os.path.join(root, img)) for img, _ in pairs])),
               "label_index_s": index_s,
               "decode_ms_per_image_png": img_ms,
               "decode_ms_per_label_png": lab_ms,
               "note": "uniform-noise images: PNG cannot compress them, so "
                       "files and decodes are larger than real frames'"}
    log("[data] fixture: " + json.dumps(summary))
    return {"root": root, "train": train, "val": val_rep,
            "val_distinct": val, "label_index": index}, summary


class _Tap:
    """``next`` of ``it``, keeping the seconds each call waited (and the
    batches, with ``keep``)."""

    def __init__(self, it, keep=False):
        self.it, self.keep = it, keep
        self.waits, self.kept = [], []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.it)
        self.waits.append(time.perf_counter() - t0)
        if self.keep:
            self.kept.append(batch)
        return batch


def data_loop(model, ds, crit, opt, params, state, snap_dir, *, workers,
              prune_type, save_every, generator=None, keep=False,
              batch=DATA_BATCH, steps=DATA_STEPS, device="cuda"):
    """``TrainLoop`` over ``steps`` batches of a ``TrainLoader`` on ``ds``
    (``workers`` decode processes) whose snapshot hook writes
    ``CS_scenes_<step>.msgpack`` every ``save_every`` steps and at the
    end, as the train CLI does, keeping the state it was given and the
    dropout generator's state.  ms a step from the metrics lines (one a
    step), less the hook's writes, and the loader's wait a step."""
    saved = {}

    def hook(st, step):
        path = os.path.join(snap_dir, f"CS_scenes_{step}.msgpack")
        t0 = time.perf_counter()
        ckpt.save_train_state(path, st, opt)
        saved[step] = {"path": path, "state": st, "bytes":
                       os.path.getsize(path),
                       "seconds": time.perf_counter() - t0,
                       "generator": (None if generator is None
                                     else generator.get_state())}

    metrics = os.path.join(snap_dir, "metrics.jsonl")
    loop = TrainLoop(model=model, criterion=crit, optimizer=opt,
                     num_steps=steps, lr_schedule=opt.schedule,
                     save_pred_every=save_every, snapshot_hook=hook,
                     log_every=1, prune_type=prune_type,
                     normalize=(ds.mean, ds.std), metrics_file=metrics)
    st0 = create_train_state(model, params, state, opt,
                             prune_type=prune_type, device=device)
    loader = TrainLoader(ds, batch, seed=DATA_SEED, num_workers=workers)
    it = iter(loader)
    tap = _Tap(it, keep=keep)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        final = loop.run(st0, tap, generator=generator, device=device)
    finally:
        it.close()
        loader.stop()
    with open(metrics) as f:
        lines = [json.loads(ln) for ln in f]
    ends = [t0] + [ln["time"] for ln in lines]
    step_ms = [(ends[i + 1] - ends[i]
                - saved.get(i, {}).get("seconds", 0.0)) * 1e3
               for i in range(len(lines))]
    run = {"workers": workers,
           "uses_processes": loader.use_processes,
           "step_ms": step_ms,
           "median_ms_steps_3_to_6": float(np.median(step_ms[2:6])),
           "loader_wait_ms": [w * 1e3 for w in tap.waits],
           "loss": [ln["loss"] for ln in lines],
           "grad_norm": [ln["grad_norm"] for ln in lines],
           "snapshots": {k: {"bytes": v["bytes"], "write_s": v["seconds"]}
                         for k, v in saved.items()},
           "peak_bytes": (torch.cuda.max_memory_allocated()
                          if device != "cpu" else None)}
    if len(lines) != steps or not all(np.isfinite(run["loss"])):
        raise AssertionError(f"data loop: {len(lines)} steps, losses "
                             f"{run['loss']}")
    return final, run, saved, tap.kept


def loader_alone(make_loader, n):
    """The first ``n`` batches of a fresh loader, timed alone: seconds to
    the first batch and batches a second over the rest."""
    loader = make_loader()
    it = iter(loader)
    stamps = [time.perf_counter()]
    try:
        for _ in range(n):
            next(it)
            stamps.append(time.perf_counter())
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
        stop = getattr(loader, "stop", None)
        if stop is not None:
            stop()
    rest = stamps[-1] - stamps[1]
    return {"batches": n, "first_batch_s": stamps[1] - stamps[0],
            "batches_per_s_after_first": (n - 1) / rest if rest else None,
            "batches_per_s": n / (stamps[-1] - stamps[0])}


def item_profile(ds, n=DATA_PROFILED_ITEMS):
    """``n`` items of ``ds`` made in this process under cProfile: ms an
    item on one core, no pool, and where it goes (own time)."""
    ds.pre_processing(0)
    ds.rng = np.random.default_rng(DATA_SEED)
    prof = host_profile(lambda: [ds[i] for i in range(n)], n, ())
    return {"items": n, "ms_per_item": prof["wall_ms_per_image"],
            "top_own_ms_per_item": prof["top_own_ms_per_image"]}


def data_pretrain(fx, snap_dir, workers, *, batch=DATA_BATCH,
                  crop=DATA_CROP, steps=DATA_STEPS, device="cuda"):
    """pretrain.sh's item path: CE (ds_weight 0.4) + EIC, SGD (lr 0.01,
    wd 5e-4, no warmup, 4000 steps), balance 0, random scale, mirror and
    brightness, classic f32 items through the native tail, from
    ``workers`` decode processes; the last snapshot and ``score.msgpack``
    on disk."""
    ds = build_dataset("CS", fx["root"], fx["train"], split="train",
                       crop_size=crop, scale=True, mirror=True,
                       brightness=True, balance=0, seed=DATA_SEED,
                       compact=False, native=True)
    if not native.built():
        raise AssertionError("pretrain: the native augment library did not "
                             "build")
    model = build_model("deeplabv3", **FLAGSHIP_CFG)
    params, state = init_graph(model.graph,
                               torch.Generator().manual_seed(DATA_SEED),
                               device=device)
    crit = build_criterions("ce", ignore_label=255,
                            class_weights=ds.class_weights,
                            loss_para={"ds_weight": 0.4})
    opt = build_optimizer(optim="sgd", learning_rate=0.01, momentum=0.9,
                          weight_decay=0.0005, num_steps=4000, warmup=-1,
                          params=params)
    native.reset_calls()
    final, run, saved, _ = data_loop(
        model, ds, crit, opt, params, state, snap_dir, workers=workers,
        prune_type="dcfp", save_every=steps, batch=batch, steps=steps,
        device=device)
    calls = native.calls()
    score = os.path.join(snap_dir, "score.msgpack")
    ckpt.save_eic(score, final.eic)
    del final, saved
    alone = loader_alone(lambda: TrainLoader(ds, batch, seed=DATA_SEED,
                                             num_workers=workers), steps)
    run.update(native_built=native.built(), native_calls=calls,
               loader_alone=alone, item_profile=item_profile(ds))
    # every item of every batch went through the fused tail, in the
    # workers (the counts are shared with forked processes)
    if calls["fused_crop_normalize"] < batch * steps or \
            calls["fused_crop_label"] < batch * steps:
        raise AssertionError(f"pretrain: native calls {calls}, expected at "
                             f"least {batch * steps} each")
    log("[data] pretrain: " + json.dumps(run))
    return {"snapshot": os.path.join(snap_dir, f"CS_scenes_{steps}.msgpack"),
            "score": score}, run


def _same_tree(a, b, where):
    """Bit-equal trees of numpy or tensor leaves; raises otherwise."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise AssertionError(f"{where}: keys differ")
        for k in a:
            _same_tree(a[k], b[k], f"{where}/{k}")
        return
    if a is None or b is None:
        if a is not b:
            raise AssertionError(f"{where}: None against a value")
        return
    if type(a) is int or type(b) is int:
        if type(a) is not type(b) or a != b:
            raise AssertionError(f"{where}: {a!r} != {b!r}")
        return
    x, y = (np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                       else v) for v in (a, b))
    if x.dtype != y.dtype or x.shape != y.shape or \
            x.tobytes() != y.tobytes():
        raise AssertionError(f"{where}: differs")


def data_prune(art, out_dir, *, device="cuda"):
    """prune.sh: the pretrained snapshot and EIC from disk, the FLOPs
    search to ``--prune-ratio 0.6`` (what ``dcfp_tpu/cli/prune.py:79-101``
    calls: conv_deepsup kept, layer_keep 0.02, channel_align 128 at
    512x512), ``pruned.msgpack`` and ``channel_cfg.msgpack`` written,
    read back bit-equal, and the pruned graph rebuilt from them."""
    train_model = build_model("deeplabv3", **FLAGSHIP_CFG)
    deploy_graph = build_model("deeplabv3", **EVAL_CFG).graph
    p, s = init_graph(train_model.graph, torch.Generator().manual_seed(0),
                      device="cpu")
    p, s = ckpt.load_params_non_strict(art["snapshot"], p, s, device="cpu")
    eic = ckpt.load_eic(art["score"])
    t0 = time.perf_counter()
    np_p, np_s = params_to_numpy(p, s)
    result, gp, report = prune_to_flops(
        train_model.graph, deploy_graph, np_p, np_s, eic, prune_ratio=0.6,
        layer_keep=0.02, except_start_keys=("conv_deepsup",),
        channel_align=128)
    search_s = time.perf_counter() - t0
    pruned = os.path.join(out_dir, "pruned.msgpack")
    cfg_path = os.path.join(out_dir, "channel_cfg.msgpack")
    ckpt.save_pruned(pruned, result.params, result.state)
    ckpt.save_channel_cfg(cfg_path, result.channel_cfg)
    cfg = ckpt.load_channel_cfg(cfg_path)
    lp, ls = ckpt.load_pruned(pruned, device=device)
    _same_tree(cfg, result.channel_cfg, "channel_cfg")
    back_p, back_s = params_to_numpy(lp, ls)
    _same_tree(back_p, result.params, "pruned params")
    _same_tree(back_s, result.state, "pruned state")
    graph = apply_channel_cfg(train_model.graph, cfg)
    gp_, gs_ = init_graph(graph, torch.Generator().manual_seed(0),
                          device="cpu")
    sp, ss = slice_params_to_cfg(np_p, np_s, cfg)
    shapes = [{n: {k: tuple(np.shape(v)) for k, v in d.items()}
               for n, d in t.items()}
              for t in (params_to_numpy(gp_, gs_)[0], sp, back_p)]
    if not shapes[0] == shapes[1] == shapes[2]:
        raise AssertionError("prune: the graph rebuilt from channel_cfg, "
                             "the sliced and the loaded params differ in "
                             "shape")
    summary = {"global_percent": gp, "flops_ratio": report["flops_ratio"],
               "params": [report["pruned_params"], report["base_params"]],
               "search_s": search_s, "pruned_bytes": os.path.getsize(pruned),
               "channel_cfg_bytes": os.path.getsize(cfg_path),
               "reloaded_bit_equal": True}
    if report["flops_ratio"] > 0.4:
        raise AssertionError(f"prune: flops ratio {report['flops_ratio']}")
    log("[data] prune: " + json.dumps(summary))
    return {"pruned": pruned, "channel_cfg": cfg_path}, summary


def data_finetune(fx, art, snap_dir, workers, *, batch=DATA_BATCH,
                  crop=DATA_CROP, steps=DATA_STEPS, device="cuda"):
    """finetune.sh's item path at the pruned widths: GSRL (ds_weight 0.4),
    SGD (lr 0.01, wd 1e-3, warmup 1000, 36000 steps), balance 2,
    resample, compact uint8 batches from ``workers`` decode processes,
    seeded dropout; snapshots at step 3 and 6.  The step-3 snapshot is
    reloaded into a fresh state (every leaf bit-equal to the state the
    hook was given, step 3) and one step from it on the batch the run
    took at step 4, with the run's dropout generator state, must give the
    run's loss (rtol 1e-5)."""
    cfg = ckpt.load_channel_cfg(art["channel_cfg"])
    ds = build_dataset("CS", fx["root"], fx["train"], split="train",
                       crop_size=crop, scale=True, mirror=True,
                       brightness=True, balance=2, resample=True,
                       compact=True, seed=DATA_SEED,
                       label_index_path=fx["label_index"])
    model = build_model("deeplabv3", **FLAGSHIP_CFG)
    model.graph = apply_channel_cfg(model.graph, cfg)
    p, s = init_graph(model.graph, torch.Generator().manual_seed(DATA_SEED),
                      device=device)
    p, s = ckpt.load_params_non_strict(art["pruned"], p, s, device=device)
    crit = build_criterions("gsrl", ignore_label=255,
                            class_weights=ds.class_weights,
                            loss_para={"ds_weight": 0.4})
    opt = build_optimizer(optim="sgd", learning_rate=0.01, momentum=0.9,
                          weight_decay=0.001, num_steps=36000, warmup=1000,
                          params=p)
    gen = torch.Generator().manual_seed(3)
    final, run, saved, kept = data_loop(
        model, ds, crit, opt, p, s, snap_dir, workers=workers,
        prune_type=None, save_every=3, generator=gen, keep=True,
        batch=batch, steps=steps, device=device)
    if sorted(saved) != [3, steps]:
        raise AssertionError(f"finetune: snapshots at {sorted(saved)}")
    fresh = create_train_state(model, p, s, opt, device=device)
    back = ckpt.load_train_state(saved[3]["path"], fresh, device=device)
    if back.step != 3:
        raise AssertionError(f"finetune: reloaded step {back.step}")
    _same_tree(ckpt.train_state_dict(back),
               ckpt.train_state_dict(saved[3]["state"]), "step-3 state")
    replay = torch.Generator()
    replay.set_state(saved[3]["generator"])
    step = make_train_step(model, crit, opt, normalize=(ds.mean, ds.std),
                           device=device)
    _, m = step(back, kept[3], replay)
    resumed, uninterrupted = float(m["loss"]), run["loss"][3]
    rel = abs(resumed - uninterrupted) / abs(uninterrupted)
    run.update(reloaded_step=back.step, reloaded_bit_equal=True,
               step4_loss_uninterrupted=uninterrupted,
               step4_loss_resumed=resumed, step4_loss_rel_err=rel,
               resample_len=len(ds))
    del final, back, fresh, saved
    alone = loader_alone(lambda: TrainLoader(ds, batch, seed=DATA_SEED,
                                             num_workers=workers), steps)
    run.update(loader_alone=alone, item_profile=item_profile(ds))
    log("[data] finetune: " + json.dumps(run))
    if rel > 1e-5:
        raise AssertionError(f"finetune: resumed step loss {resumed} against "
                             f"{uninterrupted}")
    return {"snapshot": os.path.join(snap_dir,
                                     f"CS_scenes_{steps}.msgpack")}, run


def data_eval(fx, art, snap, workers, *, device="cuda"):
    """deploy.sh's eval from disk: the step-6 snapshot on the pruned graph
    (``load_params_non_strict``), bf16, whole, ss, pad_inf to 1025x2049,
    labels through K1, ``evaluate_pipelined`` over the val manifest (16
    images listed 4 times: 5 untimed + 59 timed) on f32 and on compact
    items, each from the prefetch thread (0 workers) and from ``workers``
    decode processes; then the protocol loop over the same images decoded
    once into memory.  Every confusion must be identical, and K1 and the
    body's conv epilogues launched once an image and nothing else."""
    cfg = ckpt.load_channel_cfg(art["channel_cfg"])
    graph = apply_channel_cfg(build_model("deeplabv3", **EVAL_CFG).graph,
                              cfg)
    p, s = init_graph(graph, torch.Generator().manual_seed(0), device="cpu")
    p, s = ckpt.load_params_non_strict(snap, p, s, device="cpu")
    pred = Predictor(graph, p, s, dtype=torch.bfloat16, align_corner=True,
                     normalize=NORMALIZE, device=device)
    kw = dict(num_classes=19, whole=True, align_corner=True,
              fps_warmup=EVAL_WARMUP)
    sets = {name: build_dataset("CS", fx["root"], fx["val"], split="val",
                                compact=name == "compact")
            for name in ("f32", "compact")}
    n = len(sets["f32"])
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    loops, cms = {}, {}
    for name, ds in sets.items():
        for w in (0, workers):
            tag = f"{name}_{w}_workers"
            loader = EvalLoader(ds, batch_size=1, num_workers=w)
            t0 = time.perf_counter()
            res = evaluate(pred, loader, pipeline=True, **kw)
            wall = time.perf_counter() - t0
            cms[tag] = res["confusion"]
            loops[tag] = {"img_per_s": n / wall, "fps_timed": res["fps"],
                          "uses_processes": loader.use_processes}
    distinct = [collate([sets["f32"][i]])
                for i in range(n // DATA_VAL_REPEAT)]
    t0 = time.perf_counter()
    mem = evaluate(pred, _Cycle(distinct, n), **kw)
    loops["in_memory_protocol"] = {"img_per_s": n / (time.perf_counter()
                                                     - t0),
                                   "fps_timed": mem["fps"]}
    if device != "cpu":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = n * (len(cms) + 1)
    for tag, cm in cms.items():
        if not np.array_equal(cm, mem["confusion"]):
            raise AssertionError(f"eval from disk: the {tag} loop's "
                                 "confusion differs from the in-memory run")
    if cms["f32_0_workers"].sum() != _valid_pixels(list(_Cycle(distinct,
                                                                n))):
        raise AssertionError("eval from disk: confusion does not count "
                             "every labelled pixel")
    if device != "cpu" and launches != deploy_eval_launches(graph, p, s,
                                                            want):
        raise AssertionError(f"eval from disk: launches {launches}, "
                             f"expected K1 and the conv epilogues once an "
                             f"image, {want} images, and nothing else")
    alone = {}
    for name, ds in sets.items():
        for w in (0, workers):
            a = loader_alone(lambda: EvalLoader(ds, batch_size=1,
                                                num_workers=w),
                             min(DATA_ALONE_EVAL, n))
            alone[f"{name}_{w}_workers"] = {
                "img_per_s": a["batches_per_s"],
                "img_per_s_after_first": a["batches_per_s_after_first"],
                "first_image_s": a["first_batch_s"]}
    summary = {"images_a_loop": n, "distinct_images": len(distinct),
               "warmup": EVAL_WARMUP, "loops": loops, "loader_alone": alone,
               "meanIU": mem["meanIU"], "confusion_identical": True,
               "k1_launches": launches["resize_argmax"],
               "k1_launches_expected": want,
               "epilogue_launches": launches["conv_epilogue"]}
    log("[data] eval: " + json.dumps(summary))
    return summary


def loader_scaling(counts=(1, 2, 4, 8), waves=3):
    """A probe for the loaders' worker counts, not a phase of ``main``:
    the data cell's pretrain items (classic f32, native tail) and
    finetune items (compact, resample) at batch 1 from N decode workers
    (1: the prefetch thread; more: fork processes), each timed alone
    over ``waves`` x N items after the first, with OpenCV's default
    thread count and with one thread a process (set before the pool
    forks).  Decode processes are always forked with OpenCV's threads at
    0 (``data/loader._start_all``), so the two settings differ only for
    the prefetch thread (N = 1).  Prints one ``{"loader_scaling": ...}``
    line."""
    import cv2
    default = cv2.getNumThreads()
    out = {"cpu_count": os.cpu_count(), "cv2_default_threads": default}
    with tempfile.TemporaryDirectory() as tmp:
        fx, _ = data_fixture(tmp)
        common = dict(split="train", crop_size=DATA_CROP, scale=True,
                      mirror=True, brightness=True, seed=DATA_SEED)
        sets = {"pretrain_f32": build_dataset(
                    "CS", fx["root"], fx["train"], balance=0, **common),
                "finetune_compact": build_dataset(
                    "CS", fx["root"], fx["train"], balance=2,
                    resample=True, compact=True,
                    label_index_path=fx["label_index"], **common)}
        try:
            for threads in (default, 1):
                cv2.setNumThreads(threads)
                for name, ds in sets.items():
                    for n in counts:
                        a = loader_alone(lambda: TrainLoader(
                            ds, 1, seed=DATA_SEED, num_workers=n),
                            1 + waves * n)
                        out[f"{name}_cv2threads{threads}_workers{n}"] = {
                            "first_item_s": a["first_batch_s"],
                            "items_per_s_after_first":
                                a["batches_per_s_after_first"]}
        finally:
            cv2.setNumThreads(default)
    print(json.dumps({"loader_scaling": out}), flush=True)
    return out


def phase_data():
    """The recipe through files (pretrain -> prune -> finetune -> eval) at
    full width on the flagship R50, random weights: the fixture, the
    native augment tail, the loaders' decode processes, every artifact
    written and read back, and the deploy eval's K1.  The launch counts
    are set to 0 before the phase and read after: the training stages
    launch none of K1-K6 and no conv epilogue, the eval K1 and the conv
    epilogues once an image.  Prints one
    ``{"data": ...}`` line."""
    t_phase = time.perf_counter()
    smi = card_name_and_power()
    workers = min(8, os.cpu_count() or 1)
    stall = os.environ.get("DCFP_DECODE_STALL_TIMEOUT")
    os.environ["DCFP_DECODE_STALL_TIMEOUT"] = DATA_STALL_S
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = (cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dirs = {k: os.path.join(tmp, k) for k in
                    ("data", "pretrain", "prune", "finetune")}
            for d in dirs.values():
                os.makedirs(d)
            fx, fixture = data_fixture(dirs["data"])
            # the train stages with PyTorch's defaults, as phase_train
            cudnn.benchmark, cudnn.allow_tf32 = False, True
            matmul.allow_tf32 = False
            art, pretrain = data_pretrain(fx, dirs["pretrain"], workers)
            torch.cuda.empty_cache()
            pruned, prune = data_prune(art, dirs["prune"])
            fine, finetune = data_finetune(fx, pruned, dirs["finetune"],
                                           workers)
            torch.cuda.empty_cache()
            if any(kernels.LAUNCHES.values()):
                raise AssertionError(f"the data path's training launched "
                                     f"a kernel: {kernels.LAUNCHES}")
            # the deploy eval autotuned, as served
            cudnn.benchmark, cudnn.allow_tf32 = True, False
            evals = data_eval(fx, pruned, fine["snapshot"], workers)
    finally:
        cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = flags
        if stall is None:
            os.environ.pop("DCFP_DECODE_STALL_TIMEOUT", None)
        else:
            os.environ["DCFP_DECODE_STALL_TIMEOUT"] = stall
    torch.cuda.empty_cache()
    result = {"card": smi, "workers": workers,
              "start_method": _fork_ctx().get_start_method(),
              "cpu_count": os.cpu_count(),
              "model": "deeplabv3-resnet50 os8 mg[1,2,4] stem128 19 classes",
              "fixture": fixture, "pretrain": pretrain, "prune": prune,
              "finetune": finetune, "eval": evals,
              "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"data": result}), flush=True)
    return result


# ---------------------------------------------------------------------------
# 10. the entry points: the Cityscapes scripts' commands through the CLIs
# ---------------------------------------------------------------------------

CLI_IMAGES = 8  # train and val frames of the fixture
CLI_HW = DATA_HW  # the fixture's frames
CLI_DEPLOY = "1025,2049"  # deploy.sh's --input-size: pad_inf of CLI_HW
CLI_STEPS = "3"
CLI_TEST_FRAMES = 2
CLI_PRUNE_RATIO = "0.6"  # prune.sh's
CLI_MODEL = ["--dataset", "CS", "--model", "deeplabv3",
             "--backbone", "resnet50",
             "--backbone-para", '{"os":8,"mg_unit":[1,2,4],"inplanes":128}',
             "--align-corner", "true"]
CLI_TRAIN = ["--input-size", "769,769", "--batch-size", "8",
             "--random-seed", "42", "--optim", "sgd",
             "--learning-rate", "0.01", "--random-mirror",
             "--random-brightness", "--random-scale",
             "--loss-para", '{"ds_weight":0.4}', "--num-steps", CLI_STEPS,
             "--save-pred-every", CLI_STEPS, "--log-every", "1",
             "--xla-options", "xla_tpu_scoped_vmem_limit_kib=49152"]
BENCH_BLOCKS = "2"


@contextlib.contextmanager
def _recorded_evaluations(record):
    """``engine.evaluator.evaluate`` appends each result (its confusion
    included) to ``record`` while the block runs: the evaluate CLIs
    import it when they run."""
    from dcfp_tpu_torch.engine import evaluator
    orig = evaluator.evaluate

    def recorded(*args, **kwargs):
        res = orig(*args, **kwargs)
        record.append(res)
        return res

    evaluator.evaluate = recorded
    try:
        yield
    finally:
        evaluator.evaluate = orig


def _run_cli(name, argv, times, launches):
    """``dcfp_tpu_torch.cli.<name>.main(argv)``, which must return 0; its
    wall time and its kernel launches are kept under ``name``.  Returns
    what it printed, which is logged."""
    import importlib
    import io
    mod = importlib.import_module(f"dcfp_tpu_torch.cli.{name.split(':')[0]}")
    before = dict(kernels.LAUNCHES)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = mod.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    times[name] = time.perf_counter() - t0
    launches[name] = {k: kernels.LAUNCHES[k] - before[k]
                      for k in kernels.LAUNCHES}
    for line in printed.getvalue().splitlines():
        log(f"[cli] {name} printed: {line}")
    log(f"[cli] {name}: rc {rc}, {times[name]:.2f} s, K1 "
        f"{launches[name]['resize_argmax']}")
    if rc != 0:
        raise AssertionError(f"cli {name} returned {rc}")
    return printed.getvalue()


def cli_served_snapshot(snap, cfg_path, fx_root, val_list, out,
                        device="cuda"):
    """The snapshot the serving commands restore, written to ``out``:
    ``snap`` with the classifier's bias set to minus each class's mean
    logit over the first val frame (the f32 body run with the bias at
    0).  A few steps from random weights leave the classifier's learnt
    offsets far above the features' spread, and every pixel one class;
    labels that do not vary cannot tell a right capture or export from
    one that ignores its input.  Centred, the labels follow the image."""
    from dcfp_tpu_torch.engine.deploy import make_split_inference_fn
    graph = apply_channel_cfg(build_model("deeplabv3", **EVAL_CFG).graph,
                              ckpt.load_channel_cfg(cfg_path))
    p, s = init_graph(graph, torch.Generator().manual_seed(0), device="cpu")
    p, s = ckpt.load_params_non_strict(snap, p, s, device="cpu")
    p["last_conv.6"]["bias"].zero_()
    body, _, dparams = make_split_inference_fn(
        graph, p, s, dtype=torch.float32, output="argmax", device=device)
    img = collate([build_dataset("CS", fx_root, val_list, split="val")[0]])
    with torch.inference_mode():
        z = body(dparams, torch.from_numpy(img["img"]).to(device))
    tree = ckpt.load_pytree(snap)
    head = tree["params"]["last_conv.6"]
    head["bias"] = (-z.float().mean((0, 2, 3))).cpu().numpy().astype(
        head["bias"].dtype)
    ckpt.save_pytree(out, tree)
    return out


CLI_MIN_CLASSES = 10  # distinct labels the served snapshot must predict
CLI_MAX_SHARE = 0.5  # of the pixels, for its most frequent label


def cli_bf16_agreement(fx_root, val_list, snap, cfg_path, art_dir,
                       device="cuda"):
    """The bf16 artifact's labels against the jit path's (the body and
    K1 tail of ``make_split_inference_fn``, bf16, as ``Predictor`` runs
    them, on the same snapshot) on the val frames, padded to 1025x2049 as
    the evaluator pads them: agreement >= 0.999, and every differing
    pixel a near-tie of the jit body's resized logits (top-2 within 8
    bf16 ulp of the best).  On the card, the same body and tail captured
    in CUDA graphs, as the split form and as one graph, must give the
    jit labels exactly, frame after frame: a capture replays the same
    launches on the image it is given.  The jit labels must vary, or
    none of this could fail: at least ``CLI_MIN_CLASSES`` distinct
    labels, none on more than ``CLI_MAX_SHARE`` of the pixels, and two
    frames in a row never labelled alike."""
    from dcfp_tpu_torch.engine.deploy import (aot_compile, aot_compile_split,
                                              load_deploy_params,
                                              load_serialized,
                                              make_split_inference_fn)
    graph = apply_channel_cfg(build_model("deeplabv3", **EVAL_CFG).graph,
                              ckpt.load_channel_cfg(cfg_path))
    p, s = init_graph(graph, torch.Generator().manual_seed(0), device="cpu")
    p, s = ckpt.load_params_non_strict(snap, p, s, device="cpu")
    body, tail, dparams = make_split_inference_fn(
        graph, p, s, dtype=torch.bfloat16, fold_bn=True, output="argmax",
        device=device)
    run = load_serialized(os.path.join(art_dir, "model.pt2"))
    aot_params = load_deploy_params(os.path.join(
        art_dir, "deploy_params.msgpack"), device)
    ds = build_dataset("CS", fx_root, val_list, split="val")
    h, w = ds[0]["img"].shape[:2]
    shape = (1,) + pad_inf((h, w)) + (3,)
    captured = {}
    if device != "cpu":
        captured["split"] = aot_compile_split(body, tail, dparams, shape)
        captured["single"] = aot_compile(
            lambda p_, x_: tail(body(p_, x_), shape[1:3]), dparams, shape)
    n_diff = n_pix = n_captured_diff = n_alike = 0
    worst_ulps = 0.0
    hist = torch.zeros(256, dtype=torch.int64, device=device)
    prev = None
    for i in range(len(ds)):
        img = collate([ds[i]])["img"]
        h, w = img.shape[1:3]
        ph, pw = pad_inf((h, w))
        x = torch.from_numpy(np.pad(img, ((0, 0), (0, ph - h), (0, pw - w),
                                          (0, 0)))).to(device)
        with torch.inference_mode():
            z = body(dparams, x)
            jit = tail(z, (ph, pw))
            aot = run(aot_params, x.permute(0, 3, 1, 2))
            for form in captured.values():
                # a replay overwrites the last one's output: read it now
                n_captured_diff += int((form(dparams, x) != jit).sum())
        hist += torch.bincount(jit.flatten().long(), minlength=256)
        if prev is not None and torch.equal(prev, jit):
            n_alike += 1
        prev = jit
        diff = jit != aot
        n_diff += int(diff.sum())
        n_pix += diff.numel()
        if bool(diff.any()):
            up = resize_bilinear(z.permute(0, 2, 3, 1), (ph, pw),
                                 True).float()
            top2 = up.topk(2, dim=-1).values[diff]
            ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
                torch.log2(top2[:, 0].abs().clamp_min(1e-30))))
            worst_ulps = max(worst_ulps, float(
                ((top2[:, 0] - top2[:, 1]) / ulp).max()))
    hist = hist.cpu().numpy()
    agreement = 1.0 - n_diff / n_pix
    out = {"pixels": n_pix, "differing": n_diff, "agreement": agreement,
           "worst_top2_gap_bf16_ulps": worst_ulps,
           "jit_classes": int((hist > 0).sum()),
           "jit_top_class_share": float(hist.max() / hist.sum()),
           "frames_labelled_alike": n_alike,
           "captured_forms": sorted(captured),
           "captured_differing": n_captured_diff}
    log("[cli] bf16 artifact vs jit: " + json.dumps(out))
    if (out["jit_classes"] < CLI_MIN_CLASSES
            or out["jit_top_class_share"] > CLI_MAX_SHARE or n_alike):
        raise AssertionError(f"the served snapshot's labels do not vary "
                             f"enough to hold anything: {out}")
    if n_captured_diff:
        raise AssertionError(f"captured forms vs jit labels: {out}")
    if agreement < 0.999 or worst_ulps > 8:
        raise AssertionError(f"bf16 artifact vs jit labels: {out}")
    return out


def cli_bench():
    """``python3 bench_torch.py`` in a child process, as a user runs it,
    with ``DCFP_BENCH_BLOCKS=2``: its one JSON line, parsed and held."""
    env = dict(os.environ, DCFP_BENCH_BLOCKS=BENCH_BLOCKS)
    env.pop("DCFP_PLATFORM", None)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "bench_torch.py"], env=env,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    log("[cli] bench_torch.py: " + json.dumps(line))
    if not (line["value"] > 0 and line["vs_baseline"] > 1
            and line["detail"]["backend"] == "cuda"):
        raise AssertionError(f"bench_torch.py: {line}")
    return line, seconds


def phase_cli(device="cuda"):
    """The Cityscapes scripts' commands (scripts/cs/*.sh, the module
    renamed to ``dcfp_tpu_torch.cli``) in this process through each CLI's
    ``main(argv)``, on a 1024x2048 fixture of 8 train and 8 val frames,
    the flagship flags (DeepLabV3-R50, os 8, mg [1, 2, 4], stem 128, 769^2
    crops, batch 8, the JAX defaults' decode workers): label_index,
    pretrain (CE + EIC, 3 steps), prune to 0.6, finetune (GSRL, balance
    2, resample, 3 steps), then, on the finetuned snapshot with its
    classifier bias centred (``cli_served_snapshot``, so the labels
    vary), evaluate (bf16, pipelined, compact), deploy (1025x2049 NCHW
    argmax) in bf16 and f32, evaluate f32 and ``--use-aot`` on both
    artifacts, evaluate_test on 2 frames; then ``bench_torch.py`` as a
    child process.  Holds every CLI's rc 0, K1 launched on the evaluate,
    deploy and ``--use-aot`` paths (counted at the captured graphs'
    replays), nothing else launched but the deploy bodies' conv
    epilogues, the f32 ``--use-aot`` confusion equal to the jit path's,
    and the bf16 artifact's and the captured forms' labels against the
    jit path's (``cli_bf16_agreement``, which also holds that the labels
    vary).  Prints one ``{"cli": ...}`` line.  ``device="cpu"``, with
    smaller ``CLI_*`` sizes, dry-runs it on the CPU, without the
    bench."""
    t_phase = time.perf_counter()
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
             matmul.allow_tf32)
    env_keys = ("DCFP_CS_ROOT", "DCFP_CS_TRAIN_LIST", "DCFP_CS_VAL_LIST",
                "DCFP_CS_TEST_LIST", "DCFP_PLATFORM")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    times, launches, evals = {}, {}, []
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                _recorded_evaluations(evals):
            fx, _ = data_fixture(os.path.join(tmp, "data"), hw=CLI_HW,
                                 n=CLI_IMAGES)
            root = fx["root"]
            test_list = os.path.join(root, "test_frames.lst")
            with open(fx["val_distinct"]) as f:
                frames = [ln.split()[0] for ln in f if ln.strip()]
            with open(test_list, "w") as f:
                f.write("".join(fr + "\n"
                                for fr in frames[:CLI_TEST_FRAMES]))
            os.environ.pop("DCFP_PLATFORM", None)
            if device == "cpu":
                os.environ["DCFP_PLATFORM"] = "cpu"
            os.environ.update(DCFP_CS_ROOT=root,
                              DCFP_CS_TRAIN_LIST=fx["train"],
                              DCFP_CS_VAL_LIST=fx["val_distinct"],
                              DCFP_CS_TEST_LIST=test_list)
            d = {k: os.path.join(tmp, k) for k in
                 ("pretrain", "prune", "finetune", "deploy_bf16",
                  "deploy_f32", "submission")}
            # the train stages with PyTorch's defaults, as phase_data
            cudnn.benchmark, cudnn.allow_tf32 = False, True
            matmul.allow_tf32 = False
            _run_cli("label_index", ["--dataset", "CS", "--save-dir", root],
                     times, launches)
            _run_cli("train:pretrain", CLI_MODEL + CLI_TRAIN + [
                "--balance", "0", "--loss-type", "ce",
                "--weight-decay", "0.0005", "--warmup", "-1",
                "--prune-type", "dcfp", "--pretrained", "auto",
                "--snapshot-dir", d["pretrain"]], times, launches)
            _run_cli("prune", CLI_MODEL + [
                "--prune-ratio", CLI_PRUNE_RATIO, "--save-path", d["prune"],
                "--model-path", os.path.join(
                    d["pretrain"], f"CS_scenes_{CLI_STEPS}.msgpack"),
                "--score-path", os.path.join(d["pretrain"],
                                             "score.msgpack")],
                times, launches)
            cfg = os.path.join(d["prune"], "channel_cfg.msgpack")
            _run_cli("train:finetune", CLI_MODEL + CLI_TRAIN + [
                "--balance", "2", "--resample", "true", "--loss-type",
                "gsrl", "--weight-decay", "0.001", "--warmup", "1",
                "--resume", os.path.join(d["prune"], "pruned.msgpack"),
                "--channel-cfg", cfg, "--snapshot-dir", d["finetune"]],
                times, launches)
            torch.cuda.empty_cache()
            snap = cli_served_snapshot(
                os.path.join(d["finetune"], f"CS_scenes_{CLI_STEPS}.msgpack"),
                cfg, root, fx["val_distinct"],
                os.path.join(d["finetune"], "CS_scenes_served.msgpack"),
                device)
            eval_args = CLI_MODEL + [
                "--data-dir", "val", "--batch-size", "1", "--whole", "true",
                "--flip", "false", "--input-size", "769,769", "--ms", "1",
                "--restore-from", snap, "--channel-cfg", cfg,
                "--result-file", os.path.join(tmp, "result.txt")]
            # the eval and serving stages in f32 without TF32, one cuDNN
            # algorithm a shape, so the two f32 paths can be held equal
            cudnn.deterministic, cudnn.allow_tf32 = True, False
            _run_cli("evaluate:bf16_pipelined", eval_args + [
                "--dtype", "bfloat16", "--pipeline", "true",
                "--compact", "true"], times, launches)
            deploys = {}
            for dt in ("bf16", "f32"):
                deploys[dt] = json.loads(_run_cli(f"deploy:{dt}", CLI_MODEL + [
                    "--input-size", CLI_DEPLOY, "--input-format", "nchw",
                    "--output", "argmax", "--restore-from", snap,
                    "--channel-cfg", cfg, "--save-dir", d[f"deploy_{dt}"],
                    "--dtype", {"bf16": "bfloat16", "f32": "float32"}[dt]],
                    times, launches).splitlines()[-1])
            _run_cli("evaluate:f32", eval_args + ["--dtype", "float32"],
                     times, launches)
            for dt in ("f32", "bf16"):
                _run_cli(f"evaluate:aot_{dt}", eval_args + [
                    "--dtype", {"bf16": "bfloat16", "f32": "float32"}[dt],
                    "--use-aot", "true", "--aot-path",
                    os.path.join(d[f"deploy_{dt}"], "model.pt2")],
                    times, launches)
            _run_cli("evaluate_test", CLI_MODEL + [
                "--data-dir", "test", "--whole", "true", "--ms", "1",
                "--restore-from", snap, "--channel-cfg", cfg,
                "--output-dir", d["submission"]], times, launches)
            # scripts/cs/deploy.sh's evaluate command, on the pruned
            # snapshot it names and on the unpruned pretrain snapshot (the
            # eval cell's model, whose untuned plans are slow): here,
            # autotuned as the CLI now runs one process; then in a fresh
            # process with autotuning off, as it ran before
            deploy_sh_ms = {}
            for name, model in (
                    ("pruned", ["--restore-from", snap, "--channel-cfg",
                                cfg]),
                    ("unpruned", ["--restore-from", os.path.join(
                        d["pretrain"], f"CS_scenes_{CLI_STEPS}.msgpack")])):
                deploy_sh = CLI_MODEL + model + [
                    "--data-dir", "val", "--batch-size", "1", "--whole",
                    "true", "--flip", "false", "--input-size", CLI_DEPLOY,
                    "--ms", "1", "--dtype", "bfloat16", "--result-file",
                    os.path.join(tmp, f"result_deploy_sh_{name}.txt")]
                _run_cli(f"evaluate:deploy_sh_{name}", deploy_sh, times,
                         launches)
                deploy_sh_ms[name] = {"autotuned": 1e3 / evals[-1]["fps"],
                                      "autotuned_frames_timed":
                                          CLI_IMAGES - 5}
                if device != "cpu":
                    deploy_sh_ms[name].update(_untuned_eval_ms(
                        deploy_sh, fx["val_distinct"], tmp))
            pngs = sorted(os.listdir(os.path.join(d["submission"], "raw")))
            path_launches = dict(kernels.LAUNCHES)
            cms = {name: res["confusion"] for name, res in zip(
                ("bf16_pipelined", "f32", "aot_f32", "aot_bf16"), evals)}
            agreement = cli_bf16_agreement(root, fx["val_distinct"], snap,
                                           cfg,
                                           d["deploy_bf16"], device)
            with open(os.path.join(d["deploy_bf16"], "meta.json")) as f:
                meta = json.load(f)
            artifact_bytes = {n: os.path.getsize(os.path.join(
                d["deploy_bf16"], n)) for n in sorted(os.listdir(
                    d["deploy_bf16"]))}
    finally:
        (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
         matmul.allow_tf32) = flags
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if len(pngs) != CLI_TEST_FRAMES:
        raise AssertionError(f"evaluate_test wrote {pngs}")
    if not np.array_equal(cms["aot_f32"], cms["f32"]):
        raise AssertionError("evaluate --use-aot f32: the confusion differs "
                             "from the jit path's")
    k1 = {name: n["resize_argmax"] for name, n in launches.items()}
    for name in ([] if device == "cpu" else ("evaluate:bf16_pipelined", "deploy:bf16", "deploy:f32",
                 "evaluate:aot_f32", "evaluate:aot_bf16")):
        if k1[name] <= 0:
            raise AssertionError(f"cli {name} launched no K1: {launches}")
    for name in ([] if device == "cpu" else
                 ("evaluate:aot_f32", "evaluate:aot_bf16")):
        if k1[name] != CLI_IMAGES:
            raise AssertionError(f"cli {name}: K1 {k1[name]} times for "
                                 f"{CLI_IMAGES} images")
    others = {k: v for k, v in path_launches.items()
              if k not in ("resize_argmax", "conv_epilogue")}
    if any(others.values()) or (device != "cpu" and
                                path_launches["conv_epilogue"] <= 0):
        raise AssertionError(f"the CLI path launched {path_launches}: "
                             f"expected K1 and the conv epilogue alone")
    bench, bench_s = cli_bench() if device != "cpu" else (None, None)
    result = {"model": "deeplabv3-resnet50 os8 mg[1,2,4] stem128 19 classes",
              "frames": {"train": CLI_IMAGES, "val": CLI_IMAGES,
                         "test": CLI_TEST_FRAMES, "hw": list(CLI_HW)},
              "seconds": times, "k1_launches": k1,
              "k1_launches_on_cli_path": path_launches["resize_argmax"],
              "epilogue_launches_on_cli_path":
                  path_launches["conv_epilogue"],
              "deploy": deploys, "deploy_meta": meta,
              "artifact_bytes": artifact_bytes,
              "aot_f32_confusion_equal": True,
              "meanIU": {k: evals[i]["meanIU"] for i, k in enumerate(
                  ("bf16_pipelined", "f32", "aot_f32", "aot_bf16"))},
              "bf16_artifact_vs_jit": agreement,
              "deploy_sh_eval_ms_per_frame": deploy_sh_ms,
              "bench": bench, "bench_s": bench_s,
              "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"cli": result}), flush=True)
    for name, ms in deploy_sh_ms.items():
        if device != "cpu" and ms["autotuned"] >= 50:
            raise AssertionError(f"deploy.sh's evaluate ({name}): "
                                 f"{ms['autotuned']:.1f} ms a frame")
    return result


UNTUNED_FRAMES = 3  # the untuned run's frames: 2 untimed, 1 timed


def _untuned_eval_child(argv):
    """The evaluate CLI's work (``cli.evaluate._evaluate``) with cuDNN's
    autotuning off, as one process ran it before the CLI turned it on;
    prints the result's FPS as one JSON line."""
    from dcfp_tpu_torch.cli import evaluate as cli_evaluate
    from dcfp_tpu_torch.cli import platform_device
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    record = []
    with _recorded_evaluations(record), contextlib.redirect_stdout(
            sys.stderr):
        rc = cli_evaluate._evaluate(cli_evaluate.get_parser().parse_args(
            argv), platform_device())
    print(json.dumps({"rc": rc, "fps": record[-1]["fps"]}), flush=True)


def _untuned_eval_ms(argv, val_list, tmp):
    """ms a frame of ``argv``'s evaluate in a fresh process with cuDNN's
    autotuning off (``_untuned_eval_child``), over the first
    ``UNTUNED_FRAMES`` frames of ``val_list``."""
    short = os.path.join(tmp, "val_untuned.lst")
    with open(val_list) as f, open(short, "w") as g:
        g.writelines(f.readlines()[:UNTUNED_FRAMES])
    run = subprocess.run(
        [sys.executable, "-c", "import sys, json, chip_smoke as cs; "
         "cs._untuned_eval_child(json.loads(sys.argv[1]))",
         json.dumps(argv)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, DCFP_CS_VAL_LIST=short))
    if run.returncode != 0:
        raise AssertionError(f"untuned evaluate: {run.stderr[-3000:]}")
    out = json.loads(run.stdout.strip().splitlines()[-1])
    return {"untuned": 1e3 / out["fps"],
            "untuned_frames_timed": UNTUNED_FRAMES - 2}


# ---------------------------------------------------------------------------
# 11. data parallel across processes
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_BATCH = 4  # global: 2 images a rank
DIST_HW = 769
DIST_STEPS = 3  # timed, TF32 on, after the compared step (TF32 off)
DIST_FRAMES = 8  # the deploy eval's frames, split over the ranks
DIST_TIMEOUT_S = 300  # a collective's wait, and the ranks' whole run


def _dist_setup(cfg):
    """The flagship, its seeded params (on the CPU), the GSRL criterion
    and the global batch of phase_dist, the same in every process."""
    model = build_model("deeplabv3", **FLAGSHIP_CFG)
    params, state = init_graph(model.graph, torch.Generator().manual_seed(0),
                               device="cpu")
    crit = build_criterions("gsrl", ignore_label=255,
                            loss_para={"ds_weight": 0.4})
    batch = _train_batch(np.random.default_rng(11), cfg["batch"], cfg["hw"],
                         compact=False)
    return model, params, state, crit, batch


def _dist_optimizer():
    return build_optimizer(optim="sgd", learning_rate=0.01, momentum=0.9,
                           weight_decay=5e-4, num_steps=100, warmup=-1)


def _dist_steps(model, crit, state0, batches, device, keep_first=True,
                mesh=None):
    """``len(batches)`` train steps from ``state0`` with dropout from a
    generator seeded 3 on ``device`` (over ``mesh``'s spatial axis when
    it has one): (state after step 1 as numpy trees, final state,
    losses, grad norms, step ms)."""
    step = make_train_step(model, crit, _dist_optimizer(), device=device,
                           mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(3)
    st, first, losses, norms, ms = state0, None, [], [], []
    for b in batches:
        profiling.sync(st.params)
        t0 = time.perf_counter()
        st, m = step(st, b, gen)
        profiling.sync(st.params)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if first is None and keep_first:
            p, s = params_to_numpy(st.params, st.bn_state)
            first = (p, s, eic_to_numpy(st.eic))
    return first, st, losses, norms, ms


def _tree_digest(*trees):
    """sha256 of the tensors of ``{name: {key: tensor}}`` or ``{name:
    tensor}`` trees, in sorted order."""
    import hashlib
    h = hashlib.sha256()
    for tree in trees:
        for n in sorted(tree):
            leaves = tree[n] if isinstance(tree[n], dict) else {"": tree[n]}
            for k in sorted(leaves):
                h.update(leaves[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dist_eval_setup(cfg):
    graph = build_model("deeplabv3", **EVAL_CFG).graph
    params, state = init_graph(graph, torch.Generator().manual_seed(0),
                               device="cpu")
    params["last_conv.6"]["bias"].zero_()
    classic, _ = _eval_items(cfg["frames"], cfg["eval_hw"], seed=7)
    return graph, params, state, classic


_DIST_EVAL_KW = dict(num_classes=19, whole=True, align_corner=True,
                     fps_warmup=1, pipeline=True)


def _dist_rank(rank, port, backend, out_dir, cfg):
    """One rank of phase_dist (a spawned process): join the group, one
    train step on this rank's half of the global batch with TF32 off
    (compared), ``steps`` more with cuDNN's TF32 on (PyTorch's default,
    timed), then this rank's stride of the deploy eval.  Writes
    ``rank<r>.json`` (and rank 0 its step-1 trees to ``step1.pt``)."""
    import datetime

    from dcfp_tpu_torch.parallel import distributed
    from dcfp_tpu_torch.parallel.mesh import create_mesh, replicate_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", DIST_WORLD, rank,
                           backend=backend, device=cfg["device"],
                           timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    mesh = create_mesh(device=cfg["device"])
    dev = mesh.device
    model, params, state, crit, batch = _dist_setup(cfg)
    n = cfg["batch"] // DIST_WORLD
    mine = {"img": batch["img"][rank * n:(rank + 1) * n],
            "label": {k: v[rank * n:(rank + 1) * n]
                      for k, v in batch["label"].items()}}
    st = replicate_tree(mesh, create_train_state(
        model, params, state, _dist_optimizer(), prune_type="dcfp",
        device=dev))
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    first, st, losses, norms, ms_off = _dist_steps(
        model, crit, st, [mine], dev, keep_first=rank == 0)
    torch.backends.cudnn.allow_tf32 = True
    _, st, losses_on, _, ms = _dist_steps(
        model, crit, st, [mine] * cfg["steps"], dev, keep_first=False)
    torch.backends.cudnn.allow_tf32 = False
    train_launches = dict(kernels.LAUNCHES)
    if rank == 0:
        torch.save(first, os.path.join(out_dir, "step1.pt"))
    digest = _tree_digest(st.params, st.bn_state, st.eic)
    del st
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    graph, eparams, estate, classic = _dist_eval_setup(cfg)
    pred = Predictor(graph, eparams, estate, dtype=torch.bfloat16,
                     align_corner=True, mesh=mesh, shard="data")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = evaluate(pred, classic[rank::DIST_WORLD], **_DIST_EVAL_KW)
    eval_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "device": str(dev),
                   "losses": losses, "grad_norms": norms,
                   "step_ms_tf32_off": ms_off, "losses_tf32": losses_on,
                   "step_ms": ms, "eval_fps": res["fps"],
                   "train_launches": train_launches,
                   "params_sha256": digest,
                   "eval_frames": len(classic[rank::DIST_WORLD]),
                   "eval_s": eval_s,
                   "eval_k1_launches": kernels.LAUNCHES["resize_argmax"],
                   "eval_other_launches": {
                       k: v for k, v in kernels.LAUNCHES.items()
                       if k != "resize_argmax"},
                   "eval_epilogues_expected": (deploy_eval_launches(
                       graph, eparams, estate, len(
                           classic[rank::DIST_WORLD]))["conv_epilogue"]
                       if dev.type == "cuda" else 0),
                   "confusion": res["confusion"].astype(np.int64).tolist()},
                  f)


def _dist_eval_one(_, out_dir, cfg):
    """phase_dist's one-process eval, in a fresh process (no group) like
    the ranks: the parent may hold autotuned cuDNN plans for these convs
    (``phase_eval`` makes them), and PyTorch keeps a conv's first plan,
    so its algorithms, and bf16 near-ties, could differ from the ranks'.
    Writes ``one.json``."""
    graph, params, state, classic = _dist_eval_setup(cfg)
    pred = Predictor(graph, params, state, dtype=torch.bfloat16,
                     align_corner=True, device=cfg["device"])
    res = evaluate(pred, classic, **_DIST_EVAL_KW)
    with open(os.path.join(out_dir, "one.json"), "w") as f:
        json.dump({"fps": res["fps"], "k1": kernels.LAUNCHES["resize_argmax"],
                   "confusion": res["confusion"].astype(np.int64).tolist()},
                  f)


def _spawn(fn, nprocs, args):
    """``fn(i, *args)`` in ``nprocs`` spawned processes, all joined; a
    failure raises here, and so does outliving ``DIST_TIMEOUT_S``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"dist: {fn.__name__} outlived "
                                 f"{DIST_TIMEOUT_S} s")


def phase_dist(device="cuda", hw=DIST_HW, frames=DIST_FRAMES,
               eval_hw=EVAL_HW):
    """Data parallel across processes on the flagship R50 at full width:
    2 ranks (NCCL, one card each, where the machine has 2 or more cards;
    else both over gloo on the one card, since NCCL refuses two ranks on
    one device), GSRL + EIC + SGD with dropout, a global batch of 4 x
    769^2 (2 a rank): one step in f32 with TF32 off, compared, then 3
    timed with cuDNN's TF32 on (PyTorch's default; the first pays
    cuDNN's plans), in the ranks and in one process.  Held: step 1's
    loss, params, BN statistics and EIC against one process's step on
    the global batch, by PR 9's self-noise rule (the one-process step on
    the image x (1 + 2^-22) gives the noise); both ranks' params, BN
    statistics and EIC bit-equal after the last step; then the bf16
    deploy eval of 8 seeded 1024x2048 frames split over the ranks
    (pipelined, K1 on each rank's label path): the summed confusion
    equal to one fresh process's over all 8, K1 and the body's conv
    epilogues launched once a frame on each rank, nothing else launched
    on either path.  Prints one ``{"dist":
    ...}`` line.  ``device="cpu"`` with smaller sizes dry-runs it on the
    CPU (gloo)."""
    t_phase = time.perf_counter()
    cfg = dict(device=device, hw=hw, batch=DIST_BATCH, steps=DIST_STEPS,
               frames=frames, eval_hw=eval_hw)
    cuda = device == "cuda"
    card = card_name_and_power() if cuda else "cpu"
    cards = torch.cuda.device_count() if cuda else 0
    backend = "nccl" if cards >= DIST_WORLD else "gloo"
    log(f"[dist] {cards} card(s) visible: {DIST_WORLD} ranks over {backend}"
        + ("" if backend == "nccl" or not cuda else
           ", both on the one card (NCCL refuses two ranks on one device; "
           "collectives go through host copies)") + f"; {card}")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = (cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if cuda:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _spawn(_dist_rank, DIST_WORLD, (port, backend, tmp, cfg))
        ranks_s = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(DIST_WORLD)]
        got_p, got_s, got_e = torch.load(os.path.join(tmp, "step1.pt"),
                                         weights_only=False)
        try:
            cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = \
                (False,) * 3
            model, params, state, crit, batch = _dist_setup(cfg)
            np_p, _ = params_to_numpy(params, state)
            nudged = dict(batch,
                          img=batch["img"] * np.float32(1 + 2.0 ** -22))

            def one(b, steps):
                st = create_train_state(model, params, state,
                                        _dist_optimizer(), prune_type="dcfp",
                                        device=device)
                return _dist_steps(model, crit, st, [b] * steps, device)

            (ref_p, ref_s, ref_e), ref_st, ref_losses, _, ref_ms_off = one(
                batch, 1)
            (noise_p, _, noise_e), _, _, _, _ = one(nudged, 1)
            cudnn.allow_tf32 = True
            _, _, ref_losses_on, _, ref_ms = _dist_steps(
                model, crit, ref_st, [batch] * cfg["steps"], device,
                keep_first=False)
            del ref_st
        finally:
            cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = flags
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _spawn(_dist_eval_one, 1, (tmp, cfg))
        one_s = time.perf_counter() - t0
        one_res = json.load(open(os.path.join(tmp, "one.json")))
    one_cm = np.asarray(one_res["confusion"])
    loss_rel = abs(ranks[0]["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
    bn_worst = max(float(np.abs(got_s[b][k] - ref_s[b][k]).max()
                         / np.abs(ref_s[b][k]).max())
                   for b in ref_s for k in ref_s[b])
    err, cos, rmin, rmax, worst = _update_agreement(got_p, ref_p, np_p)
    noise_err = _update_agreement(noise_p, ref_p, np_p)[0]
    eic_err = _vec_rel_l2(got_e, ref_e)
    eic_noise = _vec_rel_l2(noise_e, ref_e)
    bit_equal = len({r["params_sha256"] for r in ranks}) == 1
    cms = [np.asarray(r["confusion"]) for r in ranks]
    cm_equal = all(np.array_equal(c, one_cm) for c in cms)
    k1 = [r["eval_k1_launches"] for r in ranks]
    result = {
        "card": card, "cards_visible": cards, "backend": backend,
        "world": DIST_WORLD,
        "model": "deeplabv3-resnet50 os8 mg[1,2,4] stem128 19 classes, "
                 "deepsup, GSRL+EIC+SGD, dropout on",
        "global_batch": [DIST_BATCH, hw, hw],
        "eval_frames_hw": [frames, *eval_hw],
        "rank_step_ms_tf32": [r["step_ms"] for r in ranks],
        "one_process_step_ms_tf32": ref_ms,
        "rank_step_ms_median_tf32": float(np.median(
            [v for r in ranks for v in r["step_ms"][1:]])),
        "one_process_step_ms_median_tf32": float(np.median(ref_ms[1:])),
        "rank_step1_ms_tf32_off": [r["step_ms_tf32_off"] for r in ranks],
        "one_process_step1_ms_tf32_off": ref_ms_off,
        "losses_2_ranks_tf32": ranks[0]["losses_tf32"],
        "losses_1_process_tf32": ref_losses_on,
        "step1_loss_2_ranks": ranks[0]["losses"][0],
        "step1_loss_1_process": ref_losses[0],
        "step1_loss_rel_err": loss_rel,
        "step1_bn_stats_max_err_rel_to_max": bn_worst,
        "step1_update_rel_l2": err,
        "one_process_self_noise_update_rel_l2": noise_err,
        "step1_update_min_cos": cos,
        "step1_update_norm_ratio": [rmin, rmax],
        "step1_update_max_err_rel_to_max_update": worst,
        "step1_eic_rel_l2": eic_err,
        "one_process_self_noise_eic_rel_l2": eic_noise,
        "ranks_params_bit_equal": bit_equal,
        "params_sha256": [r["params_sha256"][:16] for r in ranks],
        "train_launches": [r["train_launches"] for r in ranks],
        "eval_frames": [r["eval_frames"] for r in ranks],
        "eval_s": [r["eval_s"] for r in ranks],
        "eval_img_per_s_after_1": [r["eval_fps"] for r in ranks],
        "one_process_eval_img_per_s_after_1": one_res["fps"],
        "one_process_eval_k1_launches": one_res["k1"],
        "one_process_eval_s": one_s,
        "eval_k1_launches_per_rank": k1,
        "eval_confusion_equal_one_process": cm_equal,
        "eval_valid_pixels": int(one_cm.sum()),
        "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"dist": result}), flush=True)
    if not (loss_rel <= 1e-4 and bn_worst <= 1e-3
            and err <= min(2 * noise_err, 0.1) and cos >= 0.99
            and 0.95 <= rmin and rmax <= 1.05 and eic_err <= 2 * eic_noise):
        raise AssertionError("dist: 2 ranks differ from one process")
    if not bit_equal:
        raise AssertionError("dist: the ranks' params differ")
    if not cm_equal:
        raise AssertionError("dist: the sharded eval's confusion differs")
    if cuda and any(v != f for v, f in zip(k1, result["eval_frames"])):
        raise AssertionError(f"dist: K1 launches {k1}")  # CPU: plain tail
    for r in ranks:
        others = dict(r["eval_other_launches"])
        if any(r["train_launches"].values()) or others.pop(
                "conv_epilogue") != r["eval_epilogues_expected"] or \
                any(others.values()):
            raise AssertionError(f"dist: rank {r['rank']} launched "
                                 f"{r['train_launches']} training and "
                                 f"{r['eval_other_launches']} besides K1 "
                                 f"in the eval, expected the conv epilogue "
                                 f"{r['eval_epilogues_expected']} times")
    return result


def dist_cli(device="cuda", hw=(256, 512), crop="257,257", cards=None,
             spatial=1):
    """The scripts' train and evaluate commands unchanged over every
    visible card, through the CLIs' ``main`` in this process: pretrain
    with OHEM + EIC (``--num-devices -1``: the CLI starts one worker per
    card), 3 steps at 2 images a card, then the bf16 pipelined eval of
    its snapshot with ``--eval-shard data`` (one worker a card) and in
    one process.  ``spatial`` > 1 adds ``--spatial-shards spatial`` to
    both (2 images a data rank) and evaluates with ``--eval-shard
    both``.  Holds every rc 0, the snapshot and the EIC scores
    written once, and the two result files equal but for the FPS.
    Prints one ``{"dist_cli": ...}`` line.  Not part of ``main`` (it
    needs 2 or more cards to mean anything):
    ``python3 -c 'import chip_smoke as cs; cs.phase_device();
    cs.phase_build(); cs.dist_cli()'``; ``device="cpu"`` with
    ``cards=4`` and small sizes runs it over 4 gloo processes."""
    t0 = time.perf_counter()
    cuda = device == "cuda"
    cards = cards or torch.cuda.device_count()
    card = card_name_and_power() if cuda else "cpu"
    log(f"[dist_cli] {cards} card(s); {card}")
    env_keys = ("DCFP_CS_ROOT", "DCFP_CS_TRAIN_LIST", "DCFP_CS_VAL_LIST",
                "DCFP_PLATFORM")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    times, launches = {}, {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fx, _ = data_fixture(os.path.join(tmp, "cs"), hw=hw, n=8)
            os.environ.update(DCFP_CS_ROOT=fx["root"],
                              DCFP_CS_TRAIN_LIST=fx["train"],
                              DCFP_CS_VAL_LIST=fx["val_distinct"])
            os.environ.pop("DCFP_PLATFORM", None)
            if not cuda:
                os.environ["DCFP_PLATFORM"] = "cpu"
            snap = os.path.join(tmp, "pretrain")
            shards = ["--spatial-shards", str(spatial)]
            _run_cli("train", CLI_MODEL + shards + [
                "--input-size", crop,
                "--batch-size", str(2 * cards // spatial),
                "--random-seed", "42", "--random-mirror", "--loss-type",
                "ohem", "--loss-para", '{"ds_weight":0.4}', "--prune-type",
                "dcfp", "--num-steps", "3", "--save-pred-every", "3",
                "--log-every", "1", "--num-workers", "2", "--num-devices",
                "-1" if cuda else str(cards), "--snapshot-dir", snap],
                times, launches)
            written = sorted(os.listdir(snap))
            if written != ["CS_scenes_3.msgpack", "score.msgpack"]:
                raise AssertionError(f"dist_cli: the snapshot dir holds "
                                     f"{written}")
            results = {}
            for shard in ("data" if spatial == 1 else "both", "none"):
                results[shard] = os.path.join(tmp, f"result_{shard}.txt")
                _run_cli(f"evaluate:{shard}", CLI_MODEL + (
                    shards if shard != "none" else []) + [
                    "--data-dir", "val", "--restore-from",
                    os.path.join(snap, "CS_scenes_3.msgpack"),
                    "--whole", "true", "--dtype", "bfloat16", "--pipeline",
                    "true", "--num-workers", "2", "--eval-shard", shard,
                    "--num-devices", "0" if cuda else str(cards),
                    "--result-file", results[shard]], times, launches)
            texts = {}
            for shard, path in results.items():
                with open(path) as f:
                    text = f.read()
                if text.count("test with") != 1:
                    raise AssertionError(f"dist_cli: {path} holds "
                                         f"{text.count('test with')} results")
                texts[shard] = text[:text.rindex(" FPS:")]
            equal = len(set(texts.values())) == 1
            mean_iu = json.loads(texts["none"].splitlines()[1])["meanIU"]
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    result = {"card": card, "cards": cards, "spatial_shards": spatial,
              "seconds": times,
              "snapshot_files": written, "eval_results_equal": equal,
              "meanIU": mean_iu, "phase_s": time.perf_counter() - t0}
    print(json.dumps({"dist_cli": result}), flush=True)
    if not equal:
        raise AssertionError("dist_cli: the sharded eval's result differs")
    return result


def _eval_plan_child(autotune, device="cuda", hw=EVAL_HW):
    """One process of ``eval_plan_probe``: the bf16 deploy forward of the
    eval cell's model (labels through K1) on 1 + 4 seeded 1024x2048
    frames, with cuDNN's autotuning on or off from the process's first
    conv; each frame's ms, the busiest kernels of one frame; one JSON
    line."""
    torch.backends.cudnn.benchmark = autotune
    graph, params, state, classic = _dist_eval_setup(
        dict(frames=5, eval_hw=hw))
    pred = Predictor(graph, params, state, dtype=torch.bfloat16,
                     align_corner=True, device=device)
    ph, pw = pad_inf(hw)
    pad = ((0, 0), (0, ph - hw[0]), (0, pw - hw[1]), (0, 0))
    ms = []
    for item in classic:
        img = pred.device_put(np.pad(item["img"], pad))
        t0 = time.perf_counter()
        profiling.sync(pred.predict_whole_labels(img))
        ms.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiling.sync(pred.predict_whole_labels(img))
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    print(json.dumps({"autotune": autotune, "frame_ms": ms, "top_kernels": [
        {"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
         "calls": e.count} for e in top[:6]]}), flush=True)


def eval_plan_probe():
    """The eval cell's bf16 deploy forward in two fresh processes, one
    with cuDNN's autotuning off (PyTorch's default, as the evaluate CLI
    runs) and one with it on (as serving and ``phase_eval`` run): frame
    ms and the busiest kernels of each.  PyTorch keeps the first plan of
    a conv configuration, hence a process each.  Not part of ``main``:
    ``python3 -c 'import chip_smoke as cs; cs.phase_device();
    cs.phase_build(); cs.eval_plan_probe()'``."""
    out = {"card": card_name_and_power()}
    for autotune in (False, True):
        run = subprocess.run(
            [sys.executable, "-c", "import chip_smoke as cs; "
             f"cs._eval_plan_child({autotune})"], capture_output=True,
            text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"eval_plan_probe: {run.stderr[-3000:]}")
        out[f"autotune_{autotune}"] = json.loads(
            run.stdout.strip().splitlines()[-1])
    print(json.dumps({"eval_plans": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# 12. spatial sharding: image height over the ranks of a spatial group
# ---------------------------------------------------------------------------

SPATIAL_S = 2  # spatial ranks of a data rank
SPATIAL_BATCH = 2  # global
SPATIAL_HW = 769
SPATIAL_STEPS = 3  # timed, TF32 on, after the compared step (TF32 off)
SPATIAL_FRAMES = 4


def _peak_since(base):
    """Bytes allocated at the peak since the last reset, above ``base``
    (0 off CUDA)."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.max_memory_allocated() - base


def _memory_base():
    if not torch.cuda.is_available():
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _spatial_eval_setup(cfg, out_dir):
    """The eval cell's model and frames (``_dist_eval_setup``), with the
    classifier bias that the parent centred (``bias.pt``), so that the
    labels follow the image."""
    graph, params, state, classic = _dist_eval_setup(cfg)
    params["last_conv.6"]["bias"].copy_(torch.load(
        os.path.join(out_dir, "bias.pt")))
    return graph, params, state, classic


def _padded(item):
    img = item["img"]
    ph, pw = pad_inf(img.shape[1:3])
    return np.pad(img, ((0, 0), (0, ph - img.shape[1]),
                        (0, pw - img.shape[2]), (0, 0)))


def _spatial_rank(rank, port, backend, out_dir, cfg):
    """One rank of phase_spatial (a spawned process) on an ``n_data`` x 2
    mesh: one train step on its band of its data rank's images with TF32
    off (compared; its peak memory), ``steps`` more with cuDNN's TF32 on
    (timed); then the eval: f32 whole-image logits of the first frame
    over the spatial group against this process's own one-process
    Predictor, and the bf16 labels of every frame through K1 (written for
    the parent; K1 held against its plain version on the first frame's
    gathered low-res logits).  Writes ``rank<r>.json``
    (rank 0 its step-1 trees to ``step1.pt``, each data rank's first
    spatial rank its labels)."""
    import datetime

    from dcfp_tpu_torch.parallel import distributed
    from dcfp_tpu_torch.parallel.mesh import create_mesh, replicate_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_data = cfg["n_data"]
    distributed.initialize(f"localhost:{port}", n_data * SPATIAL_S, rank,
                           backend=backend, device=cfg["device"],
                           timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    mesh = create_mesh(n_data, SPATIAL_S, device=cfg["device"])
    dev = mesh.device
    model, params, state, crit, batch = _dist_setup(cfg)
    n, d = cfg["batch"] // n_data, mesh.data_rank

    def mine(tree):
        return {k: mine(v) if isinstance(v, dict) else v[d * n:(d + 1) * n]
                for k, v in tree.items()}

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    base = _memory_base()
    st = replicate_tree(mesh, create_train_state(
        model, params, state, _dist_optimizer(), prune_type="dcfp",
        device=dev))
    first, st, losses, norms, ms_off = _dist_steps(
        model, crit, st, [mine(batch)], dev, keep_first=rank == 0,
        mesh=mesh)
    peak = _peak_since(base)
    torch.backends.cudnn.allow_tf32 = True
    _, st, losses_on, _, ms = _dist_steps(
        model, crit, st, [mine(batch)] * cfg["steps"], dev,
        keep_first=False, mesh=mesh)
    torch.backends.cudnn.allow_tf32 = False
    train_launches = dict(kernels.LAUNCHES)
    if rank == 0:
        torch.save(first, os.path.join(out_dir, "step1.pt"))
    digest = _tree_digest(st.params, st.bn_state, st.eic)
    del st
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    graph, eparams, estate, classic = _spatial_eval_setup(cfg, out_dir)
    frames = [_padded(it) for it in classic[d::n_data]]
    shard = "spatial" if n_data == 1 else "both"
    # f32 on the first frame (cuDNN's f32 plans at 1025x2049 cost seconds
    # a forward untuned and minutes to tune), against this process's own
    # whole-image forward
    banded = Predictor(graph, eparams, estate, align_corner=True, mesh=mesh,
                       shard=shard)
    whole = Predictor(graph, eparams, estate, align_corner=True, device=dev)
    got, want = banded.predict_whole(frames[0]), whole.predict_whole(frames[0])
    f32_err = float((got - want).abs().max() / want.abs().max())
    f32_label_diff = int((got.argmax(-1) != want.argmax(-1)).sum())
    del banded, whole, got, want
    # bf16 autotuned: labels flip at near-ties between any two sets of
    # plans (held against one process's own flips in the parent)
    torch.backends.cudnn.benchmark = True
    pred = Predictor(graph, eparams, estate, dtype=torch.bfloat16,
                     align_corner=True, mesh=mesh, shard=shard)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    labels = []
    t0 = time.perf_counter()
    for img in frames:
        labels.append(pred.predict_whole_labels(img))
    profiling.sync(labels[-1])
    labels_s = time.perf_counter() - t0
    k1 = kernels.LAUNCHES["resize_argmax"]
    others = {k: v for k, v in kernels.LAUNCHES.items()
              if k != "resize_argmax"}
    # K1 against its plain version on the first frame's gathered logits
    body, _, dparams = make_split_inference_fn(
        graph, eparams, estate, dtype=torch.bfloat16, output="argmax",
        device=dev, spatial_axis=mesh.spatial)
    with torch.inference_mode():
        z = body(dparams, torch.from_numpy(frames[0]).to(dev))
    k1_mismatch = near_tie_check(labels[0], z.permute(0, 2, 3, 1),
                                 frames[0].shape[1:3], True,
                                 f"spatial rank {rank} K1")[0]
    if mesh.spatial_rank == 0:
        torch.save(torch.stack(labels).cpu(),
                   os.path.join(out_dir, f"labels{d}.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "device": str(dev),
                   "data_rank": d, "spatial_rank": mesh.spatial_rank,
                   "losses": losses, "grad_norms": norms,
                   "step_ms_tf32_off": ms_off, "losses_tf32": losses_on,
                   "step_ms": ms, "peak_bytes": peak,
                   "train_launches": train_launches,
                   "params_sha256": digest, "frames": len(frames),
                   "f32_logits_max_err_rel_to_max": f32_err,
                   "f32_labels_differing": f32_label_diff,
                   "bf16_labels_s": labels_s, "k1_launches": k1,
                   "k1_vs_plain_mismatches": k1_mismatch,
                   "eval_other_launches": others}, f)


SPATIAL_FLOOR_FRAMES = 2  # frames of one process's own flips


def _spatial_one(autotune, out_dir, cfg):
    """phase_spatial's one-process bf16 labels, in a fresh process (no
    group): cuDNN autotuned as the ranks (``autotune`` 1; each frame's
    labels through K1 and its low-res logits), or on its heuristic plans
    (0: other algorithms for the same shapes; the first
    ``SPATIAL_FLOOR_FRAMES`` frames' labels).  Writes
    ``one<autotune>.pt``."""
    torch.backends.cudnn.benchmark = bool(autotune)
    graph, params, state, classic = _spatial_eval_setup(cfg, out_dir)
    dev = torch.device(cfg["device"])
    pred = Predictor(graph, params, state, dtype=torch.bfloat16,
                     align_corner=True, device=dev)
    body, _, dparams = make_split_inference_fn(
        graph, params, state, dtype=torch.bfloat16, output="argmax",
        device=dev)
    labels, zs = [], []
    for item in (classic if autotune else classic[:SPATIAL_FLOOR_FRAMES]):
        img = _padded(item)
        labels.append(pred.predict_whole_labels(img).cpu())
        if autotune:
            with torch.inference_mode():
                zs.append(body(dparams, torch.from_numpy(img).to(dev)).cpu())
    torch.save({"labels": torch.stack(labels),
                "z": torch.stack(zs) if zs else None},
               os.path.join(out_dir, f"one{autotune}.pt"))


def _centred_bias(cfg, out_dir):
    """The eval model's classifier bias minus each class's mean logit over
    the first frame (f32, bias 0), written to ``bias.pt``: random
    weights otherwise label every pixel one class."""
    graph, params, state, classic = _dist_eval_setup(cfg)
    body, _, dparams = make_split_inference_fn(
        graph, params, state, dtype=torch.float32, output="argmax",
        device=cfg["device"])
    with torch.inference_mode():
        z = body(dparams, torch.from_numpy(_padded(classic[0])).to(
            cfg["device"]))
    torch.save((-z.float().mean((0, 2, 3))).cpu(),
               os.path.join(out_dir, "bias.pt"))


def _labels_vs_one(got, one):
    """bf16 labels against one process's: the differing pixels and the
    widest top-2 gap of one process's resized logits among them, in bf16
    ulp of the best; how far the labels vary."""
    n_diff = n_pix = 0
    worst = 0.0
    hist = torch.zeros(256, dtype=torch.int64)
    for i in range(len(got)):
        lab, want = got[i], one["labels"][i]
        diff = lab != want
        n_diff += int(diff.sum())
        n_pix += diff.numel()
        hist += torch.bincount(want.flatten().long(), minlength=256)
        if bool(diff.any()):
            up = resize_bilinear(one["z"][i].permute(0, 2, 3, 1),
                                 want.shape[-2:], True).float()
            top2 = up.topk(2, dim=-1).values[diff]
            ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
                torch.log2(top2[:, 0].abs().clamp_min(1e-30))))
            worst = max(worst, float(((top2[:, 0] - top2[:, 1]) / ulp).max()))
    hist = hist.numpy()
    return {"pixels": n_pix, "differing": n_diff,
            "agreement": 1.0 - n_diff / n_pix,
            "worst_top2_gap_bf16_ulps": worst,
            "classes": int((hist > 0).sum()),
            "top_class_share": float(hist.max() / hist.sum())}


def phase_spatial(device="cuda", hw=SPATIAL_HW, frames=SPATIAL_FRAMES,
                  eval_hw=EVAL_HW, n_data=None):
    """Spatial sharding on the flagship R50 at full width: an ``n_data``
    x 2 mesh (2 x 2 over NCCL, a card a rank, where the machine has 4 or
    more cards; else 1 x 2 with both ranks over gloo on one card).
    Train: GSRL + EIC + SGD with dropout, a global batch of 2 x 769^2
    (f32), each rank its band of its data rank's images: step 1 with
    TF32 off against one process's step on the global batch by
    ``phase_dist``'s self-noise rule, the ranks' params bit-equal after 3
    more steps with TF32 on (timed), a rank's peak memory in step 1 at most
    0.7 x one process's.  Eval (the eval cell's model, classifier bias
    centred): 4 seeded 1024x2048 frames padded to 1025x2049, whole image
    over the spatial group (``shard="spatial"``, "both" on 2 x 2): the
    first frame's f32 logits against one process's within 1e-4 x
    max|logit| (labels differing on at most 1e-4 of the pixels); bf16
    labels through K1 (once a frame on each rank, nothing else launched)
    against one fresh autotuned process's, flipping at most twice as
    often as that process's labels flip against its heuristic plans
    (``_labels_vs_one``); K1 against its plain version on the first
    frame's gathered logits by ``near_tie_check``.  Prints one
    ``{"spatial": ...}`` line.  ``device="cpu"`` with smaller sizes
    dry-runs it on the CPU (gloo)."""
    t_phase = time.perf_counter()
    cuda = device == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    if n_data is None:
        n_data = 2 if cards >= 2 * SPATIAL_S else 1
    world = n_data * SPATIAL_S
    backend = "nccl" if cuda and cards >= world else "gloo"
    cfg = dict(device=device, hw=hw, batch=SPATIAL_BATCH, steps=SPATIAL_STEPS,
               frames=frames, eval_hw=eval_hw, n_data=n_data)
    card = card_name_and_power() if cuda else "cpu"
    log(f"[spatial] {cards} card(s) visible: {n_data} x {SPATIAL_S} mesh "
        f"over {backend}; {card}")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = (cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        try:
            cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = \
                (False,) * 3
            _centred_bias(cfg, tmp)
            if cuda:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            _spawn(_spatial_rank, world, (port, backend, tmp, cfg))
            ranks_s = time.perf_counter() - t0
            ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                     for r in range(world)]
            got_p, got_s, got_e = torch.load(os.path.join(tmp, "step1.pt"),
                                             weights_only=False)
            model, params, state, crit, batch = _dist_setup(cfg)
            np_p, _ = params_to_numpy(params, state)
            nudged = dict(batch,
                          img=batch["img"] * np.float32(1 + 2.0 ** -22))

            def one(b, steps):
                st = create_train_state(model, params, state,
                                        _dist_optimizer(), prune_type="dcfp",
                                        device=device)
                return _dist_steps(model, crit, st, [b] * steps, device)

            base = _memory_base()
            (ref_p, ref_s, ref_e), ref_st, ref_losses, _, ref_ms_off = one(
                batch, 1)
            one_peak = _peak_since(base)
            (noise_p, _, noise_e), _, _, _, _ = one(nudged, 1)
            cudnn.allow_tf32 = True
            _, _, ref_losses_on, _, ref_ms = _dist_steps(
                model, crit, ref_st, [batch] * cfg["steps"], device,
                keep_first=False)
            del ref_st
        finally:
            cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = flags
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _spawn(_spatial_one, 2, (tmp, cfg))
        one_s = time.perf_counter() - t0
        one_eval = torch.load(os.path.join(tmp, "one1.pt"))
        heuristic = torch.load(os.path.join(tmp, "one0.pt"))
        sharded = [torch.load(os.path.join(tmp, f"labels{d}.pt"))
                   for d in range(n_data)]
    got_labels = [sharded[i % n_data][i // n_data] for i in range(frames)]
    agreement = _labels_vs_one(got_labels, one_eval)
    floor = _labels_vs_one(list(heuristic["labels"]), one_eval)
    loss_rel = abs(ranks[0]["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
    bn_worst = max(float(np.abs(got_s[b][k] - ref_s[b][k]).max()
                         / np.abs(ref_s[b][k]).max())
                   for b in ref_s for k in ref_s[b])
    err, cos, rmin, rmax, worst = _update_agreement(got_p, ref_p, np_p)
    noise_err = _update_agreement(noise_p, ref_p, np_p)[0]
    eic_err = _vec_rel_l2(got_e, ref_e)
    eic_noise = _vec_rel_l2(noise_e, ref_e)
    bit_equal = len({r["params_sha256"] for r in ranks}) == 1
    peak_ratio = (max(r["peak_bytes"] for r in ranks) / one_peak
                  if one_peak else None)
    k1 = [r["k1_launches"] for r in ranks]
    result = {
        "card": card, "cards_visible": cards, "backend": backend,
        "mesh": [n_data, SPATIAL_S],
        "model": "deeplabv3-resnet50 os8 mg[1,2,4] stem128 19 classes, "
                 "deepsup, GSRL+EIC+SGD, dropout on",
        "global_batch": [SPATIAL_BATCH, hw, hw],
        "eval_frames_hw": [frames, *eval_hw],
        "rank_step_ms_tf32": [r["step_ms"] for r in ranks],
        "one_process_step_ms_tf32": ref_ms,
        "rank_step_ms_median_tf32": float(np.median(
            [v for r in ranks for v in r["step_ms"][1:]])),
        "one_process_step_ms_median_tf32": float(np.median(ref_ms[1:])),
        "rank_step1_ms_tf32_off": [r["step_ms_tf32_off"] for r in ranks],
        "one_process_step1_ms_tf32_off": ref_ms_off,
        "rank_peak_bytes": [r["peak_bytes"] for r in ranks],
        "one_process_peak_bytes": one_peak,
        "rank_peak_over_one_process": peak_ratio,
        "losses_ranks_tf32": ranks[0]["losses_tf32"],
        "losses_1_process_tf32": ref_losses_on,
        "step1_loss_ranks": ranks[0]["losses"][0],
        "step1_loss_1_process": ref_losses[0],
        "step1_loss_rel_err": loss_rel,
        "step1_bn_stats_max_err_rel_to_max": bn_worst,
        "step1_update_rel_l2": err,
        "one_process_self_noise_update_rel_l2": noise_err,
        "step1_update_min_cos": cos,
        "step1_update_norm_ratio": [rmin, rmax],
        "step1_update_max_err_rel_to_max_update": worst,
        "step1_eic_rel_l2": eic_err,
        "one_process_self_noise_eic_rel_l2": eic_noise,
        "ranks_params_bit_equal": bit_equal,
        "params_sha256": [r["params_sha256"][:16] for r in ranks],
        "train_launches": [r["train_launches"] for r in ranks],
        "eval_frames": [r["frames"] for r in ranks],
        "f32_logits_max_err_rel_to_max": [
            r["f32_logits_max_err_rel_to_max"] for r in ranks],
        "bf16_labels_s": [r["bf16_labels_s"] for r in ranks],
        "k1_launches_per_rank": k1,
        "k1_vs_plain_mismatches": [r["k1_vs_plain_mismatches"]
                                   for r in ranks],
        "f32_labels_differing": [r["f32_labels_differing"] for r in ranks],
        "bf16_labels_vs_one_process": agreement,
        "one_process_heuristic_plans_vs_autotuned": floor,
        "one_process_eval_s": one_s,
        "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"spatial": result}), flush=True)
    if not (loss_rel <= 1e-4 and bn_worst <= 1e-3
            and err <= min(2 * noise_err, 0.1) and cos >= 0.99
            and 0.95 <= rmin and rmax <= 1.05 and eic_err <= 2 * eic_noise):
        raise AssertionError("spatial: the ranks' step differs from one "
                             "process's")
    if not bit_equal:
        raise AssertionError("spatial: the ranks' params differ")
    if max(result["f32_logits_max_err_rel_to_max"]) > 1e-4 or max(
            result["f32_labels_differing"]) > 1e-4 * (agreement["pixels"]
                                                      // frames):
        raise AssertionError("spatial: f32 logits differ from one process's")
    if agreement["classes"] < CLI_MIN_CLASSES or \
            agreement["top_class_share"] > CLI_MAX_SHARE:
        raise AssertionError("spatial: the labels do not vary")
    # bf16 labels flip between any two sets of conv algorithms at the
    # logits' near-ties: held within twice one process's own flips
    # between its heuristic and its autotuned plans
    if (1 - agreement["agreement"] > max(2 * (1 - floor["agreement"]), 1e-3)
            or agreement["worst_top2_gap_bf16_ulps"]
            > max(2 * floor["worst_top2_gap_bf16_ulps"], 8)):
        raise AssertionError("spatial: bf16 labels against one process")
    if cuda and peak_ratio > 0.7:
        raise AssertionError(f"spatial: a rank's peak is {peak_ratio:.3f} "
                             "of one process's")
    if cuda and any(v != r["frames"] for v, r in zip(k1, ranks)):
        raise AssertionError(f"spatial: K1 launches {k1}")
    if any(any(r["train_launches"].values())
           or any(r["eval_other_launches"].values()) for r in ranks):
        raise AssertionError("spatial: a kernel other than K1 was launched")
    return result


def main():
    phase_device()
    phase_build()
    k1_cases = phase_k1()
    k1_time = time_k1()
    k2_cases = phase_k2()
    k3_cases = phase_k3()
    phase_forward()
    launches, serve_check, phases, k4_case, served = phase_serve()
    epi = phase_epilogue()
    # the bf16 cuDNN yardsticks after serving: they make their plans
    # autotuned, as serving does, but the serving run comes first
    k2_time = time_k2()
    k3_launches, k3_check, k3_time = phase_k3_probe()
    k5_launches, k5_check, k5_time = phase_k5()
    k6_launches, k6_check, k6_time = phase_k6()
    k4_launches, k4_check, k4_time = phase_k4(k4_case)
    del k4_case
    int8_result = phase_int8(served)
    del served
    phase_prune_trace()
    phase_train()
    phase_horizon()
    eval_result = phase_eval()
    data_result = phase_data()
    cli_result = phase_cli()
    dist_result = phase_dist()
    spatial_result = phase_spatial()
    main_case = next(v for k, v in k1_cases.items()
                     if k.startswith(str(MAIN_SHAPE)) and "bfloat16" in k)
    k2_main = max(v for k, v in k2_cases.items()
                  if k.startswith(f"(1,{MAIN_OUT[0]},{MAIN_OUT[1]},"))
    k3_main = k3_time["layer3"]
    kernel_line = {"kernels": [
        dict(name="resize_argmax", route="cuda",
             source="dcfp_tpu_torch/csrc/resize_argmax.cu",
             replaces="dcfp_tpu/ops/pallas_kernels.py:83",
             launches=launches["resize_argmax"],
             max_abs_err=max(main_case[1], serve_check[1]),
             check={"cases": len(k1_cases),
                    "mismatched_pixels": sum(v[0] for v in k1_cases.values()),
                    "serving_mismatched_pixels": serve_check[0],
                    "launches_on_phases_path":
                        phases["launches"]["resize_argmax"]},
             launches_on_eval_path=eval_result["deploy"]["k1_launches"],
             launches_on_data_path=data_result["eval"]["k1_launches"],
             launches_on_cli_path=cli_result["k1_launches_on_cli_path"],
             launches_on_dist_path=sum(
                 dist_result["eval_k1_launches_per_rank"]),
             launches_on_spatial_path=sum(
                 spatial_result["k1_launches_per_rank"]),
             launches_on_int8_path=int8_result["launches"]["resize_argmax"],
             **k1_time),
        dict(name="stem_conv3x3_s2", route="cuda",
             source="dcfp_tpu_torch/csrc/stem_conv.cu",
             replaces="dcfp_tpu/ops/pallas_kernels.py:196",
             launches=phases["launches"]["stem_conv3x3_s2"],
             max_abs_err=max(k2_main, phases["k2_max_abs_err"]),
             check={"cases": len(k2_cases),
                    "max_abs_err_all_cases": max(k2_cases.values()),
                    "serving_max_abs_err": phases["k2_max_abs_err"],
                    "rule": "f32 <= 1e-5 x max|ref|; bf16 within 1 bf16 ulp"
                            " (+1e-6 x max|ref|) of the plain f32 result"},
             **k2_time),
        dict(name="fused_bottleneck", route="cuda",
             source="dcfp_tpu_torch/csrc/bottleneck.cu",
             replaces="dcfp_tpu/ops/bottleneck.py:189",
             launches=k3_launches["fused_bottleneck"],
             max_abs_err=max(v["max_abs_err"] for v in k3_check.values()),
             check={"cases": len(k3_cases),
                    "max_abs_err_small_cases": max(k3_cases.values()),
                    "probe": k3_check,
                    "rule": "f32 rtol = atol = 2e-5; bf16 max <= 0.15 and "
                            "< 1% off by > 0.05",
                    "path": "probe at the pruned R101 layer3 and layer4 "
                            "shapes"},
             **k3_main, layer4=k3_time["layer4"]),
        dict(name="tiled_mm", route="cuda",
             source="dcfp_tpu_torch/csrc/int8_mm.cu",
             replaces="tools/exp_int8.py:59",
             launches=k5_launches["tiled_mm"],
             launches_on_int8_path=int8_result["launches"]["tiled_mm"],
             int8_path_frame_bound=int8_result["k5_frame_bound"],
             max_abs_err=max(k5_check.values()),
             check={"cases": k5_check,
                    "rule": "int8 equal to the exact plain product; bf16 "
                            "within 1e-5 x (|a| @ |b|) of the plain f32 "
                            "product",
                    "path": "the probe's stage A, 1024^3, 1000x1008x200 and "
                            "64x4096x1024, int8 and bf16"},
             **k5_time["int8"], bf16=k5_time["bfloat16"],
             other_shapes={k: v for k, v in k5_time.items()
                           if k not in ("int8", "bfloat16")}),
        dict(name="chain_int8", route="cuda",
             source="dcfp_tpu_torch/csrc/int8_chain.cu",
             replaces="tools/exp_int8.py:176",
             launches=k6_launches["chain_int8"], max_abs_err=0.0,
             check={**k6_check, "rule": "bit-equal to the plain version",
                    "path": "the probe's stage B: the probe's and the pruned "
                            "layer3's shapes, then an 8-block chain"},
             **k6_time["probe"], layer3=k6_time["layer3"]),
        dict(name="aspp_fused", route="cuda",
             source="dcfp_tpu_torch/csrc/aspp.cu",
             replaces="tools/exp_aspp.py:167",
             launches=k4_launches["aspp_fused"],
             max_abs_err=max(k4_check["stage_n_max_abs_err"],
                             k4_check["stage_b_max_abs_err"]),
             check={**k4_check,
                    "rule": "within 1 bf16 ulp + 1e-5 x sum|x w| of the "
                            "plain f32 result"},
             **k4_time),
        dict(name="conv_epilogue", route="cuda",
             source="dcfp_tpu_torch/csrc/epilogue.cu",
             replaces="none: XLA's fusion of the conv epilogue on the TPU",
             launches=epi["launches"]["conv_epilogue"],
             max_abs_err=epi["max_abs_err"],
             check={"cases": epi["cases"],
                    "values_not_bit_equal": epi["values_not_bit_equal"],
                    "rule": "within 1 ulp of the plain version (f32 equal)",
                    "path": "every launch shape of the served body, the "
                            "scalar path, a captured request, the export"},
             **epi["frame"]),
    ]}
    log(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
