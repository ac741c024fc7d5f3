"""On-card smoke test of the PyTorch/CUDA port (``dcfp_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100, ``sm_90a``) and ``nvcc``; it
exits non-zero without them.  Phases, each of which raises on failure:

1. device: name, power limit, torch/CUDA versions;
2. build: compile the resize-argmax kernel (K1) from
   ``dcfp_tpu_torch/csrc/`` with nvcc;
3. K1 against its plain PyTorch version on the card, over the deploy
   shape and the JAX package's kernel test cases;
4. the DeepLabV3-R50 forward on the card (f32, TF32 off) against the
   port's own CPU run on the same params;
5. serving: DeepLabV3-R101 (the bench configuration) pruned to 50% FLOPs,
   BN folded, bf16, batch 1, 1025x2049, NCHW input, argmax output through
   K1; answers 4 requests, checks K1 ran once per request, and times the
   pruned and unpruned models with the ``totrt.py`` protocol;
6. one JSON line with every ported kernel: launches on the serving run,
   its check, its time beside its bound, plain and library times;
7. last line: ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch.bridge import params_from_numpy, params_to_numpy
from dcfp_tpu_torch.engine.deploy import (benchmark, make_inference_fn,
                                          make_split_inference_fn)
from dcfp_tpu_torch.graph.apply import init_graph
from dcfp_tpu_torch.models.registry import build_model
from dcfp_tpu_torch.ops import kernels
from dcfp_tpu_torch.ops.resize import resize_bilinear
from dcfp_tpu_torch.prune.eic import prunable_bn_names
from dcfp_tpu_torch.prune.search import prune_to_flops

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the
# tensor cores (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)  # name, power limit
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
    built = kernels.build()
    log(f"[build] resize_argmax: nvcc {built.seconds:.2f} s, "
        f"load {time.perf_counter() - t0:.2f} s")
    for line in built.log.splitlines():  # ptxas: registers, spills
        if "Used" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


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
    top2 = up.topk(2, dim=-1).values
    want = torch.argmax(up, dim=-1).to(torch.uint8)
    diff = labels != want
    n_diff = int(diff.sum())
    share = n_diff / labels.numel()
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


def phase_k1():
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((1, 19, 129, 257), MAIN_OUT, True),       # deploy shape
             ((1, 19, 17, 33), (65, 129), True),         # test_pallas.py
             ((2, 7, 16, 16), (64, 64), False),
             ((1, 150, 9, 9), (33, 33), True),
             ((1, 171, 65, 129), (513, 1025), False)]    # COCO-stuff
    results = {}
    for shape, out_hw, ac in cases:
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
    L2-resident, as they are when that conv has just run.  K1 on the
    contiguous (N, C, h, w) layout is timed too."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    z = torch.randn(MAIN_SHAPE, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    z_nchw = z.contiguous()
    z_nhwc = z.permute(0, 2, 3, 1)
    n, c, h, w = MAIN_SHAPE
    out_h, out_w = MAIN_OUT
    ms = cuda_ms(lambda: kernels.resize_argmax_cm(z, MAIN_OUT, True), 200)
    nchw_ms = cuda_ms(
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
    log(f"[k1] deploy shape bf16: kernel {ms:.4f} ms (channels_last; "
        f"{nchw_ms:.4f} ms on contiguous NCHW), plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms ({library_nchw_ms:.4f} ms on NCHW), "
        f"bound {bound_ms:.4f} ms "
        f"({n_bytes} B, {n_ops} f32 ops)")
    return {"ms": ms, "ms_nchw": nchw_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_ms_nchw": library_nchw_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# 4. forward on the card against the CPU
# ---------------------------------------------------------------------------

def phase_forward():
    cfg = dict(R101_CFG, backbone="resnet50")
    graph = build_model("deeplabv3", **cfg).graph
    params, state = init_graph(graph, torch.Generator().manual_seed(0),
                               device="cpu")
    image = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 65, 65, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        fn, p = make_inference_fn(graph, params, state, dtype=torch.float32,
                                  output="logits", device=dev)
        outs[dev] = fn(p, image).cpu()
    ref, got = outs["cpu"], outs["cuda"]
    if got.shape != (1, 65, 65, 19) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"R50 forward: bad logits {got.shape}")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"[forward] DeepLabV3-R50 1x65x65 f32 card vs CPU: max|diff| "
        f"{err:.3g}, max|logit| {scale:.3g}, ratio {err / scale:.3g}")
    if err > 1e-3 * scale:
        raise AssertionError("R50 forward differs from the CPU run")


# ---------------------------------------------------------------------------
# 5. serving the main path
# ---------------------------------------------------------------------------

def _kernel_class(name):
    low = name.lower()
    if "resize_argmax" in low:
        return "K1 resize_argmax"
    if any(t in low for t in ("conv", "fprop", "cudnn")):
        return "convolution"
    if any(t in low for t in ("gemm", "gemv", "nvjet")):
        return "matmul"
    return "other (elementwise, copies, pools)"


def profile_requests(request, n=5):
    """Where one request's device time goes: torch.profiler over ``n``
    requests after a warm one; kernel time by class, the top kernels, and
    the device's busy share of the window's wall time."""
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
    log("[profile] " + json.dumps({
        "requests": n, "wall_ms_per_request": wall_us / n / 1e3,
        "device_busy_ms_per_request": busy_us / n / 1e3,
        "device_busy_share": busy_us / wall_us if wall_us else None,
        "ms_per_request_by_class": {k: v / n / 1e3
                                    for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_request": [[k[:80], v / n / 1e3]
                                       for k, v in top],
        "top_ops_device_ms_per_request": [[k, v / n / 1e3]
                                          for k, v in top_ops]}))


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
    requests = [torch.from_numpy(rng.uniform(-1, 1, (1, 3) + MAIN_OUT)
                                 .astype(np.float32)).cuda()
                for _ in range(4)]
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
    del fn, dev_params, body, p, z
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
        "speedup_pruned_vs_unpruned": (unpruned["ms_per_batch"]
                                       / pruned["ms_per_batch"]),
        "global_percent": gp, "flops_ratio": report["flops_ratio"],
        "pruned_params": report["pruned_params"],
        "max_memory_allocated_bytes": peak,
    }
    log("[serve] " + json.dumps(summary))
    return launches, serve_check


def main():
    phase_device()
    phase_build()
    k1_cases = phase_k1()
    k1_time = time_k1()
    phase_forward()
    launches, serve_check = phase_serve()
    main_case = next(v for k, v in k1_cases.items()
                     if k.startswith(str(MAIN_SHAPE)) and "bfloat16" in k)
    kernel_line = {"kernels": [dict(
        name="resize_argmax", route="cuda",
        source="dcfp_tpu_torch/csrc/resize_argmax.cu",
        replaces="dcfp_tpu/ops/pallas_kernels.py:83",
        launches=launches["resize_argmax"],
        max_abs_err=max(main_case[1], serve_check[1]),
        check={"cases": len(k1_cases),
               "mismatched_pixels": sum(v[0] for v in k1_cases.values()),
               "serving_mismatched_pixels": serve_check[0]},
        **k1_time)]}
    log(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
