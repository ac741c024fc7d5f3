"""Headline benchmark of the PyTorch/CUDA port: pruned-model throughput
at deploy resolution on one CUDA card (the counterpart of ``bench.py``,
which stays the JAX bench).

    python3 bench_torch.py

Mirrors the reference deploy benchmark (totrt.py:70-89: TensorRT fp16,
batch 1, 1025x2049, 10 warmup + 50 timed) with ``bench.py``'s
configuration: DeepLabV3-ResNet101 (os 8, multi-grid [1, 2, 4], 128-wide
stem, 19 classes, align_corner) pruned to 50% FLOPs from the synthetic
EIC scores of ``default_rng(0)`` (``channel_align=128``), BatchNorm
folded, bfloat16, NCHW input, argmax labels through the K1 kernel.  Each
model is served by ``engine.deploy.aot_compile_split`` (the body and the
K1 tail captured in CUDA graphs) and timed by ``engine.deploy.benchmark``:
unpruned, pruned, and pruned at batch 4.

``vs_baseline`` is the pruned model's throughput relative to the
unpruned model through the identical deploy path on the same card.

Variance protocol: each configuration is timed as ``DCFP_BENCH_BLOCKS``
(default 5) blocks of 50 after 10 warmup; the headline is the median
block, and ``detail.spread`` carries each configuration's blocks.
``DCFP_BENCH_SMALL=1`` runs bench.py's small shapes (257x513, 2 + 5
iterations, 2 blocks).  Without CUDA it raises; ``DCFP_PLATFORM=cpu``
runs it on the CPU, at the small shapes.

Prints ONE JSON line with ``bench.py``'s keys; ``detail.backend`` is
``"cuda"`` and ``detail.card`` holds the card's name and power limit as
``nvidia-smi`` reports them.  It writes no file.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

METRIC = "deeplabv3_r101_50pct_flops_1025x2049_bf16_img_per_s"


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    from dcfp_tpu_torch.bridge import params_from_numpy, params_to_numpy
    from dcfp_tpu_torch.cli import platform_device
    from dcfp_tpu_torch.engine.deploy import (aot_compile_split, benchmark,
                                              make_split_inference_fn)
    from dcfp_tpu_torch.graph.apply import init_graph
    from dcfp_tpu_torch.models.registry import build_model
    from dcfp_tpu_torch.prune.eic import prunable_bn_names
    from dcfp_tpu_torch.prune.search import prune_to_flops

    device = platform_device()
    small = (os.environ.get("DCFP_BENCH_SMALL") == "1"
             or device.type == "cpu")
    if small:
        shape, warmup, iters, blocks = (1, 257, 513, 3), 2, 5, 2
    else:
        shape, warmup, iters = (1, 1025, 2049, 3), 10, 50
        blocks = int(os.environ.get("DCFP_BENCH_BLOCKS", "5"))
    card = card_name_and_power() if device.type == "cuda" else None
    # cuDNN autotunes its conv algorithms at each fixed shape, as the TRT
    # builder (and XLA's compile in bench.py) does
    torch.backends.cudnn.benchmark = True

    model = build_model(
        "deeplabv3", backbone="resnet101",
        backbone_para={"os": 8, "mg_unit": [1, 2, 4], "inplanes": 128},
        num_classes=19, align_corner=True, deepsup=False)
    params, state = init_graph(model.graph, torch.Generator().manual_seed(0),
                               device="cpu")

    # Synthetic EIC scores stand in for the 4k-step pretrain accumulation:
    # throughput depends only on which channel *counts* survive, not on
    # which channels the real scores would pick.
    rng = np.random.default_rng(0)
    eic = {bn: np.abs(rng.standard_normal(
        model.graph.node(bn).attrs["channels"])).astype(np.float32)
        for bn in prunable_bn_names(model.graph)}

    np_params, np_state = params_to_numpy(params, state)
    result, gp, report = prune_to_flops(
        model.graph, model.graph, np_params, np_state, eic, prune_ratio=0.5,
        layer_keep=0.02, except_start_keys=(), channel_align=128)
    pruned_params, pruned_state = params_from_numpy(
        result.params, result.state, "cpu")

    # NCHW input — the reference deploy engine's own format (totrt.py:113
    # feeds (1,3,H,W)); it goes straight into the NCHW graph
    nchw = (shape[0], shape[3], shape[1], shape[2])
    image = torch.from_numpy(rng.uniform(-1, 1, nchw).astype(np.float32))

    modes = {}
    spread = {}

    def deploy_ips(graph, p, s, batch=1, tag=""):
        b_nchw = (batch,) + nchw[1:]
        b_image = image.repeat(batch, 1, 1, 1).to(device)
        body_fn, tail_fn, dev_params = make_split_inference_fn(
            graph, p, s, dtype=torch.bfloat16, fold_bn=True,
            output="argmax", input_format="nchw", device=device)
        compiled = aot_compile_split(body_fn, tail_fn, dev_params, b_nchw,
                                     input_format="nchw", device=device)
        # bench.py's autotune key; both forms replay the same kernels here
        modes[tag] = "split"
        stats = benchmark(lambda img: compiled(dev_params, img),
                          b_image, warmup=warmup, iters=iters,
                          blocks=blocks)
        spread[tag] = {"median_ms": round(stats["ms_per_batch"], 3),
                       "min_ms": stats["ms_min"],
                       "max_ms": stats["ms_max"],
                       "blocks_ms": stats["ms_blocks"]}
        return stats["images_per_sec"]

    base_ips = deploy_ips(model.graph, params, state, tag="unpruned")
    pruned_ips = deploy_ips(result.graph, pruned_params, pruned_state,
                            tag="pruned")
    # batch 1 stays the headline (protocol parity with totrt.py:113);
    # batch 4 measures whether img/s gains from batching
    pruned_ips_b4 = deploy_ips(result.graph, pruned_params, pruned_state,
                               batch=4, tag="pruned_b4")

    pr = spread["pruned"]
    noise_pct = 100.0 * (pr["max_ms"] - pr["min_ms"]) / pr["median_ms"]
    print(json.dumps({
        "metric": METRIC,
        "value": round(pruned_ips, 3),
        "unit": "img/s",
        "vs_baseline": round(pruned_ips / base_ips, 3),
        "detail": {
            "backend": device.type,
            "card": card,
            "unpruned_img_per_s": round(base_ips, 3),
            "pruned_img_per_s_batch4": round(pruned_ips_b4, 3),
            "global_percent": gp,
            "flops_ratio": round(report["flops_ratio"], 4),
            "deploy_modes": modes,
            "small_mode": small,
            "timing_blocks": blocks,
            "spread": spread,
            "noise_band_pct": round(noise_pct, 2),
        },
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
