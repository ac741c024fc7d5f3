"""Validation entry point (port of ``dcfp_tpu/cli/evaluate.py``): mIoU /
per-class IU / precision / recall + FPS on the val split; whole-image,
sliding-window, multi-scale + flip; boundary IoU; optional prediction
PNGs; results appended to ``result.txt``.

``--use-aot`` serves the artifact of ``cli.deploy`` (``model.pt2``, its
``.tail`` and ``deploy_params.msgpack``) through
``engine.deploy.load_serialized``.

Across processes (``torchrun``, ``--distributed true``, or ``--eval-shard
data|spatial|both``, for which the CLI starts one process per card
itself, ``--num-devices`` of them, 0 = every visible card) the processes
form a ``(W / S) x S`` mesh (``S = --spatial-shards``): each data rank
evaluates its stride of the split, with ``spatial`` or ``both`` its S
ranks splitting each image's height, the confusion counts are summed at
the end, and rank 0 writes the result file.  One process autotunes
cuDNN's conv algorithms (as ``cli.deploy`` does); a sharded eval does
not, so that every rank takes the algorithms one process would without
autotuning and the summed confusion equals one process's.

Example (Cityscapes single-scale whole-image, scripts/cs/finetune.sh:35,
module renamed):
  python -m dcfp_tpu_torch.cli.evaluate --dataset CS --data-dir val \\
      --model deeplabv3 --backbone resnet50 \\
      --backbone-para '{"os":8,"mg_unit":[1,2,4]}' \\
      --whole true --ms 1 --restore-from snapshots/.../CS_scenes_36000.msgpack \\
      --channel-cfg snapshots/cs_prune/channel_cfg.msgpack
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from dcfp_tpu_torch.cli import platform_device
from dcfp_tpu_torch.cli.common import (DTYPES, add_data_args,
                                       add_distributed_args, add_model_args,
                                       build_dataset_from_args,
                                       build_model_from_args, init_params,
                                       job_world, launch_workers, make_mesh,
                                       maybe_initialize_distributed,
                                       maybe_load_channel_cfg, mesh_axes,
                                       parse_hw, str2bool)
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dcfp_tpu_torch evaluate")
    add_data_args(p, split="val")
    add_model_args(p)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--restore-from", type=str, required=True)
    p.add_argument("--whole", type=str2bool, default=False,
                   help="whole-image (vs sliding-window tiles)")
    p.add_argument("--flip", type=str2bool, default=False)
    p.add_argument("--ms", type=str, default="1",
                   help="comma-joined scales, e.g. '0.75,1,1.25'")
    p.add_argument("--iou-type", type=str, default="segm",
                   help="segm|boundary")
    p.add_argument("--dilation-ratio", type=float, default=0.02)
    p.add_argument("--save-predict", type=str2bool, default=False)
    p.add_argument("--predict-dir", type=str, default=None)
    p.add_argument("--result-file", type=str, default=None,
                   help="defaults to <ckpt dir>/result.txt")
    p.add_argument("--dtype", type=str, default="float32",
                   help="float32|bfloat16 inference")
    p.add_argument("--use-aot", type=str2bool, default=False,
                   help="serve the serialized artifact of cli.deploy (the "
                        "--use-trt analog).  Modes: whole-image ss (argmax "
                        "export), sliding-window with any ms/flip "
                        "(tile-shaped --output logits export), whole-image "
                        "ms/flip (per-scale logits set from deploy --ms)")
    p.add_argument("--aot-path", type=str, default=None)
    p.add_argument("--pipeline", type=str2bool, default=False,
                   help="throughput mode for whole-image ss eval: keep "
                        "the H2D copy, forward, argmax and confusion "
                        "update on device with NO per-image host sync.  "
                        "mIoU is identical; FPS becomes the pipelined "
                        "loop's wall-clock")
    p.add_argument("--compact", type=str2bool, default=False,
                   help="raw uint8 val items, normalized on device "
                        "(bitwise-equal metrics): 4x less host->device "
                        "traffic per image")
    p.add_argument("--bucket-quantum", type=int, default=0,
                   help="pad inputs up to multiples of this so variable-"
                        "resolution val sets run a bounded set of shapes "
                        "(0 = one per distinct shape)")
    p.add_argument("--eval-shard", type=str, default="none",
                   help="none|data|spatial|both: one process per card, "
                        "each data rank on its stride of the split; with "
                        "spatial|both the --spatial-shards ranks of each "
                        "split the image height")
    p.add_argument("--num-devices", type=int, default=0,
                   help="devices for --eval-shard (0 = all)")
    p.add_argument("--spatial-shards", type=int, default=1)
    add_distributed_args(p)
    return p


def _load_aot(args, graph, params, bn_state, dtype, normalize, device,
              aot_whole, aot_sliding, aot_ms, scales_chk):
    """A Predictor that serves the artifact at ``--aot-path``."""
    from dcfp_tpu_torch.engine.deploy import (load_deploy_params,
                                              load_serialized)
    from dcfp_tpu_torch.engine.evaluator import Predictor
    if not args.aot_path:
        raise SystemExit("--use-aot requires --aot-path "
                         "(the serialized program from cli.deploy)")
    if not os.path.isfile(args.aot_path):
        raise SystemExit(f"--aot-path not found: {args.aot_path}")
    # the artifact was exported with BN-folded deploy params saved next
    # to it by the deploy CLI
    aot_dir = os.path.dirname(os.path.abspath(args.aot_path))
    params_path = os.path.join(aot_dir, "deploy_params.msgpack")
    if not os.path.isfile(params_path):
        raise SystemExit(
            f"missing {params_path} (written by cli.deploy next to "
            "the serialized program)")
    meta_path = os.path.join(aot_dir, "meta.json")
    meta = None
    aot_fmt = "nhwc"
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        want_out = "argmax" if aot_whole else "logits"
        if meta.get("output") != want_out:
            raise SystemExit(
                f"this eval mode needs a deploy --output {want_out} "
                f"export; {args.aot_path} was exported with "
                f"--output {meta.get('output')}")
        aot_fmt = meta.get("input_format", "nhwc")
        if aot_sliding and aot_fmt != "nhwc":
            raise SystemExit(
                "tile executables must be exported with "
                "--input-format nhwc (the tile extractor feeds NHWC)")
        if aot_sliding and (tuple(meta["input"][1:3])
                            != parse_hw(args.input_size)):
            raise SystemExit(
                f"tile executable shape {meta['input'][1:3]} != "
                f"--input-size {args.input_size}")
    aot_params = load_deploy_params(params_path, device)
    predictor = Predictor(graph, params, bn_state, dtype=dtype,
                          normalize=normalize, device=device)
    if aot_ms:
        # whole-image multi-scale/flip: per-scale logits programs
        # (cli.deploy --ms), dispatched by the scaled input shape — the
        # reference serves its TRT engine inside predict_multiscale the
        # same way (evaluate.py:273-276)
        if meta is None or "ms" not in meta:
            raise SystemExit(
                "whole-image ms/flip serving needs a per-scale "
                "artifact set: export with cli.deploy --ms "
                f"'{args.ms}' --output logits")
        missing = [s for s in scales_chk if str(s) not in meta["ms"]]
        if missing:
            raise SystemExit(
                f"scales {missing} not in the exported set "
                f"{sorted(meta['ms'])} — re-export with "
                f"cli.deploy --ms '{args.ms}'")
        runs_by_hw = {}
        for s in scales_chk:
            ent = meta["ms"][str(s)]
            # the (h, w) dispatch below never re-checks batch
            if ent["input"][0] != args.batch_size:
                raise SystemExit(
                    f"per-scale executables were exported at "
                    f"batch {ent['input'][0]} but --batch-size is "
                    f"{args.batch_size} — re-export with "
                    f"cli.deploy --ms --batch-size "
                    f"{args.batch_size}")
            runs_by_hw[tuple(ent["input"][1:3])] = load_serialized(
                os.path.join(aot_dir, ent["file"]))
        predictor.use_aot_scales(runs_by_hw, aot_params)
        return predictor
    run = load_serialized(args.aot_path)
    if aot_fmt == "nchw":
        # the evaluator feeds NHWC: a permuted view, which is the
        # channels_last NCHW tensor the body takes
        body = run
        run = (lambda p, img: body(p, img.permute(0, 3, 1, 2)))
    if aot_sliding:
        predictor.use_aot_tiles(run, aot_params)
    else:
        predictor.use_aot_whole(run, aot_params)
    return predictor


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    if args.eval_shard not in ("none", "data", "spatial", "both"):
        raise ValueError(f"--eval-shard {args.eval_shard!r}: none, data, "
                         "spatial or both")
    if args.use_aot and args.eval_shard in ("spatial", "both"):
        raise SystemExit("--use-aot serves whole images; it has no "
                         f"--eval-shard {args.eval_shard}")
    device = platform_device()
    maybe_initialize_distributed(args, device)
    # one process unless launched, or asked for a sharded eval
    world, start = job_world(
        args, device, args.num_devices if args.eval_shard != "none"
        else None)
    mesh_axes(args, world)
    if start:
        return launch_workers("dcfp_tpu_torch.cli.evaluate", argv, world)
    # cuDNN autotunes the convs of a one-process eval, as cli.deploy does;
    # ranks that time their own choices could take different algorithms
    # and flip bf16 near-ties between them, so a sharded eval does not
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = world == 1
    try:
        return _evaluate(args, device)
    finally:
        torch.backends.cudnn.benchmark = autotune


def _evaluate(args, device) -> int:
    mesh = make_mesh(args, device)
    device = mesh.device
    from dcfp_tpu_torch.data.loader import EvalLoader
    from dcfp_tpu_torch.engine.evaluator import Predictor, evaluate
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    from dcfp_tpu_torch.utils import checkpoint as ckpt

    dataset = build_dataset_from_args(args, args.data_dir,
                                      compact=args.compact)
    normalize = ((dataset.mean, dataset.std) if args.compact else None)
    # each data rank evaluates its stride of the split (the ranks of a
    # spatial group the same images); the confusion counts sum across
    # processes at the end (reference DistributedSampler +
    # dist.all_reduce, evaluate.py:370-372)
    loader = EvalLoader(dataset, batch_size=args.batch_size,
                        rank=mesh.data_rank, world=mesh.n_data,
                        num_workers=args.num_workers)

    model = build_model_from_args(args, dataset.num_classes, deepsup=False)
    graph = model.graph
    cfg = maybe_load_channel_cfg(args)
    if cfg is not None:
        graph = apply_channel_cfg(graph, cfg)
    params, bn_state = init_params(graph)
    params, bn_state = ckpt.load_params_non_strict(
        args.restore_from, params, bn_state, device="cpu")

    dtype = DTYPES[args.dtype]
    scales_chk = [float(s) for s in args.ms.split(",") if s]
    # serving modes (the reference feeds its TRT engine to every eval
    # mode, evaluate.py:273-276):
    # * whole-image ss        -> one argmax program (deploy default)
    # * sliding (any ms/flip) -> one tile-shaped logits program; every
    #   tile runs at the canonical tile shape regardless of scale
    # * whole-image ms/flip   -> per-scale logits programs
    #   (deploy --ms), dispatched by the scaled input shape
    aot_whole = args.whole and scales_chk == [1.0] and not args.flip
    aot_sliding = not args.whole
    aot_ms = args.whole and not aot_whole
    if args.use_aot and (aot_whole or aot_ms) and (args.longsize > 0
                                                   or args.shortsize > 0):
        # whole-ss: the resize protocol argmaxes AFTER resizing logits
        # back to the original resolution (reference evaluate.py:340-343);
        # an argmax program emits labels, which cannot be bilinear-
        # resized.  whole-ms: per-scale programs are exported at fixed
        # shapes derived from --input-size, but the resize protocol gives
        # each image its own resized+padded shape
        raise SystemExit(
            "--use-aot whole-image serving cannot run the longsize/"
            "shortsize resize protocol (ss exports emit argmax labels, "
            "which cannot be logits-resized; ms exports are fixed-shape "
            "per scale, but the resize protocol produces per-image "
            "shapes) — drop --longsize/--shortsize or use the jit path")
    if args.use_aot:
        predictor = _load_aot(args, graph, params, bn_state, dtype,
                              normalize, device, aot_whole, aot_sliding,
                              aot_ms, scales_chk)
    else:
        if args.eval_shard != "none":
            log.info("eval mesh: %s, %d data x %d spatial", args.eval_shard,
                     mesh.n_data, mesh.n_spatial)
        predictor = Predictor(graph, params, bn_state, dtype=dtype,
                              bucket_quantum=args.bucket_quantum,
                              align_corner=args.align_corner, mesh=mesh,
                              shard="data" if args.eval_shard == "none"
                              else args.eval_shard, normalize=normalize)

    scales = [float(s) for s in args.ms.split(",") if s]
    result_file = args.result_file or os.path.join(
        os.path.dirname(os.path.abspath(args.restore_from)), "result.txt")
    predict_dir = args.predict_dir or (
        os.path.join(os.path.dirname(os.path.abspath(args.restore_from)),
                     "predict") if args.save_predict else None)

    tag = (f"{args.restore_from} whole={args.whole} ms={args.ms} "
           f"flip={args.flip} iou={args.iou_type}")
    result = evaluate(
        predictor, loader, num_classes=dataset.num_classes,
        ignore_label=dataset.ignore_label, whole=args.whole,
        scales=scales, flip=args.flip, align_corner=args.align_corner,
        tile_size=parse_hw(args.input_size), longsize=args.longsize,
        shortsize=args.shortsize,
        iou_type="boundary" if args.iou_type == "boundary" else "mask",
        dilation_ratio=args.dilation_ratio,
        save_predict_dir=predict_dir,
        cmap=getattr(dataset, "CMAP", None),
        result_file=result_file, result_tag=tag,
        pipeline=args.pipeline)
    print(f"meanIU {result['meanIU']:.4f}  meanP {result['meanP']:.4f}  "
          f"meanR {result['meanR']:.4f}  FPS {result['fps']:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
