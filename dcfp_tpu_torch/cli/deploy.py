"""Deployment export entry point (port of ``dcfp_tpu/cli/deploy.py``;
reference totrt.py).

Builds the (optionally pruned) model, folds BatchNorm into convs,
compiles a bfloat16 forward at the fixed deploy resolution (CUDA-graph
capture, ``engine.deploy.aot_compile*``), saves the serialized program
(``model.pt2``, and ``model.pt2.tail`` for the K1 tail of a split export:
the TRT-engine-file analog, totrt.py:122, where the JAX package writes
``model.stablehlo``) with ``deploy_params.msgpack`` and ``meta.json``
beside it, and benchmarks latency with the reference protocol (10 warmup
+ 50 timed, totrt.py:70-89).  ``deploy_params.msgpack`` is the JAX
package's file, byte for byte, in f32 and in bf16.  ``--xla-options`` is
accepted and logged as having no counterpart.

Example (scripts/cs/trt.sh with the module renamed):
  python -m dcfp_tpu_torch.cli.deploy --dataset CS --model deeplabv3 \\
      --backbone resnet50 --backbone-para '{"os":8,"mg_unit":[1,2,4]}' \\
      --input-size 1024,2048 \\
      --restore-from snapshots/.../CS_scenes_36000.msgpack \\
      --channel-cfg snapshots/cs_prune/channel_cfg.msgpack \\
      --save-dir deploy/cs
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from dcfp_tpu_torch.cli import platform_device
from dcfp_tpu_torch.cli.common import (DTYPES, add_model_args,
                                       build_model_from_args, init_params,
                                       maybe_load_channel_cfg, parse_hw)
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()

NUM_CLASSES = {"CS": 19, "CTX": 59, "ADE": 150, "COCO": 171}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dcfp_tpu_torch deploy")
    add_model_args(p)
    p.add_argument("--dataset", type=str, default="CS")
    p.add_argument("--input-size", type=str, default="1025,2049",
                   help="deploy H,W (reference scripts/cs/trt.sh uses "
                        "1025,2049 for align-corner models)")
    p.add_argument("--restore-from", type=str, default=None)
    p.add_argument("--save-dir", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--output", type=str, default="argmax",
                   help="argmax (uint8 labels) | logits")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--deploy-form", type=str, default="auto",
                   choices=["auto", "split", "single"],
                   help="auto: the split form (captured in CUDA graphs "
                        "both forms replay the same kernels, so there is "
                        "no faster one to probe for, as the JAX CLI "
                        "does); split: the K1 tail in its own graph; "
                        "single: one graph")
    p.add_argument("--input-format", type=str, default="nhwc",
                   choices=["nhwc", "nchw"],
                   help="program input layout. nchw is the reference "
                        "engine's own format (totrt.py:113); evaluate "
                        "--use-aot feeds either")
    p.add_argument("--ms", type=str, default=None,
                   help="comma-joined eval scales (e.g. '0.75,1,1.25'): "
                        "export one logits program per scale shape so "
                        "evaluate --use-aot can serve multi-scale(+flip) "
                        "whole-image eval (reference evaluate.py:273-276, "
                        ":198-227).  Requires --output logits and "
                        "--input-format nhwc; --input-size must be the "
                        "PADDED eval resolution (e.g. 1025,2049 for "
                        "align-corner CS)")
    p.add_argument("--xla-options", type=str, default=None,
                   help="XLA compiler options of the JAX package's deploy "
                        "compile; no counterpart here (logged, ignored)")
    return p


def _validate_ms(args) -> None:
    """Static ``--ms`` flag validation, up front, before the model build
    (the JAX CLI's messages)."""
    toks = [t for t in args.ms.split(",") if t.strip()]
    if not toks:
        raise SystemExit(f"--ms {args.ms!r} parses to zero scales — "
                         "pass comma-joined floats, e.g. "
                         "--ms '0.75,1'")
    seen = set()
    for tok in toks:
        try:
            val = float(tok)
        except ValueError:
            raise SystemExit(f"--ms {args.ms!r}: {tok.strip()!r} is "
                             "not a float — pass comma-joined "
                             "floats, e.g. --ms '0.75,1'") from None
        if val <= 0:
            raise SystemExit(f"--ms {args.ms!r}: scale {tok.strip()!r}"
                             " must be > 0 (it multiplies the export "
                             "resolution)")
        if str(val) in seen:
            raise SystemExit(f"--ms {args.ms!r}: duplicate scale "
                             f"{tok.strip()!r} (scales normalize via "
                             "float(); '1' and '1.0' collide)")
        seen.add(str(val))
    if args.output != "logits":
        raise SystemExit("--ms exports probability executables for "
                         "scale averaging: use --output logits")
    if args.input_format != "nhwc":
        raise SystemExit("--ms exports feed the evaluator's per-scale "
                         "resize, which is NHWC: use "
                         "--input-format nhwc")
    if not args.save_dir:
        raise SystemExit("--ms needs --save-dir (it exists to write "
                         "the serialized per-scale artifact set)")


def _image(shape, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, shape).astype(np.float32)).to(device)


def _export_multiscale(args, graph, params, bn_state, hw, dtype,
                       device) -> int:
    """Export one serialized logits program per eval scale so ``evaluate
    --use-aot`` can serve multi-scale(+flip) whole-image eval.  Scale
    shapes follow the evaluator's own formula: ``int(H*s), int(W*s)`` of
    the padded eval resolution."""
    from dcfp_tpu_torch.engine.deploy import (aot_compile, benchmark,
                                              export_serialized,
                                              make_split_inference_fn,
                                              save_deploy_params)

    h, w = hw
    body_fn, tail_fn, dev_params = make_split_inference_fn(
        graph, params, bn_state, dtype=dtype, fold_bn=True,
        output="logits", input_format="nhwc", device=device)
    assert tail_fn is None  # logits output has no K1 tail
    os.makedirs(args.save_dir, exist_ok=True)
    ms_meta = {}
    for tok in [t for t in args.ms.split(",") if t.strip()]:
        key = str(float(tok))  # evaluate normalizes scales via float()
        hs, ws = int(h * float(tok)), int(w * float(tok))
        shape = (args.batch_size, hs, ws, 3)
        fname = f"model_s{key}.pt2"
        export_serialized(body_fn, dev_params, shape,
                          os.path.join(args.save_dir, fname))
        ms_meta[key] = {"file": fname, "input": list(shape)}
    save_deploy_params(os.path.join(args.save_dir, "deploy_params.msgpack"),
                       dev_params)
    with open(os.path.join(args.save_dir, "meta.json"), "w") as f:
        json.dump({"input": [args.batch_size, h, w, 3],
                   "dtype": args.dtype, "output": "logits",
                   "form": "split", "input_format": "nhwc",
                   "split_tail": False, "ms": ms_meta}, f)

    # serving latency of the full protocol: every scale, summed, and
    # doubled for the flip variant (reference evaluate.py:198-227)
    per_scale = {}
    for key, m in sorted(ms_meta.items(),
                         key=lambda kv: -(kv[1]["input"][1]
                                          * kv[1]["input"][2])):
        shape = tuple(m["input"])
        compiled = aot_compile(body_fn, dev_params, shape, device=device)
        image = _image(shape, device)
        stats = benchmark(lambda img: compiled(dev_params, img), image,
                          warmup=args.warmup, iters=args.iters)
        per_scale[key] = round(stats["ms_per_batch"] / args.batch_size, 3)
    ms_sum = round(sum(per_scale.values()), 3)
    print(json.dumps({"input": [args.batch_size, h, w, 3],
                      "dtype": args.dtype,
                      "form": "ms", "scales": sorted(ms_meta),
                      "ms_per_image_per_scale": per_scale,
                      "ms_per_image": ms_sum,
                      "ms_per_image_flip": round(2 * ms_sum, 3),
                      "images_per_sec": round(1000.0 / ms_sum, 3)}))
    return 0


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    if args.ms is not None:
        _validate_ms(args)
    device = platform_device()
    if args.xla_options:
        log.info("--xla-options %s: XLA compiler options have no "
                 "counterpart in the PyTorch port; ignored",
                 args.xla_options)
    # cuDNN autotunes its conv algorithms at the fixed deploy shape, as
    # the TRT builder (and XLA's compile) does; restored on the way out
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        return _deploy(args, device)
    finally:
        torch.backends.cudnn.benchmark = autotune


def _deploy(args, device) -> int:
    from dcfp_tpu_torch.data.paths import dataset_key
    from dcfp_tpu_torch.engine.deploy import (aot_compile,
                                              aot_compile_split, benchmark,
                                              export_serialized,
                                              export_serialized_split,
                                              infer_out_hw,
                                              make_split_inference_fn,
                                              save_deploy_params)
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    from dcfp_tpu_torch.utils import checkpoint as ckpt

    num_classes = NUM_CLASSES[dataset_key(args.dataset)]
    model = build_model_from_args(args, num_classes, deepsup=False)
    graph = model.graph
    cfg = maybe_load_channel_cfg(args)
    if cfg is not None:
        graph = apply_channel_cfg(graph, cfg)
    params, bn_state = init_params(graph)
    if args.restore_from:
        params, bn_state = ckpt.load_params_non_strict(
            args.restore_from, params, bn_state, device="cpu")

    h, w = parse_hw(args.input_size)
    fmt = args.input_format
    shape = ((args.batch_size, 3, h, w) if fmt == "nchw"
             else (args.batch_size, h, w, 3))
    dtype = DTYPES[args.dtype]

    if args.ms is not None:
        # flags validated up front, before the model build above
        return _export_multiscale(args, graph, params, bn_state,
                                  (h, w), dtype, device)

    # body and tail are captured as separate graphs unless --deploy-form
    # single; auto is split: the two forms replay the same kernels
    body_fn, tail_fn, dev_params = make_split_inference_fn(
        graph, params, bn_state, dtype=dtype, fold_bn=True,
        output=args.output, input_format=fmt, device=device)
    image = _image(shape, device)
    out_hw = infer_out_hw(shape, fmt)

    def single_fn(p, img):
        return tail_fn(body_fn(p, img), out_hw)

    if tail_fn is not None and args.deploy_form == "single":
        compiled, form = aot_compile(single_fn, dev_params, shape,
                                     device=device), "single"
    else:
        compiled, form = (aot_compile_split(body_fn, tail_fn, dev_params,
                                            shape, input_format=fmt,
                                            device=device), "split")
    log.info("deploy form: %s", form)

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        path = os.path.join(args.save_dir, "model.pt2")
        if form == "single" and tail_fn is not None:
            # export_serialized removes any stale .tail itself
            export_serialized(single_fn, dev_params, shape, path)
        else:
            export_serialized_split(body_fn, tail_fn, dev_params, shape,
                                    path, input_format=fmt)
        save_deploy_params(os.path.join(args.save_dir,
                                        "deploy_params.msgpack"), dev_params)
        with open(os.path.join(args.save_dir, "meta.json"), "w") as f:
            json.dump({"input": list(shape), "dtype": args.dtype,
                       "output": args.output, "form": form,
                       "input_format": fmt,
                       "split_tail": (form == "split"
                                      and tail_fn is not None)}, f)

    stats = benchmark(lambda img: compiled(dev_params, img), image,
                      warmup=args.warmup, iters=args.iters)
    print(json.dumps({"input": list(shape), "dtype": args.dtype,
                      "form": form,
                      "ms_per_batch": round(stats["ms_per_batch"], 3),
                      "images_per_sec": round(stats["images_per_sec"], 3)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
