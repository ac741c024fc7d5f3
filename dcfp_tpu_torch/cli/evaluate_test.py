"""Test-split inference for benchmark submission (port of
``dcfp_tpu/cli/evaluate_test.py``): no labels — saves raw-id PNGs
(reverse trainId remap, reference evaluate_test.py:133-150) plus palette
PNGs for visualization (:151-164).  Across processes (``torchrun`` or
``--distributed true``) each rank writes the PNGs of its stride of the
split.

Example (module renamed):
  python -m dcfp_tpu_torch.cli.evaluate_test --dataset CS --data-dir test \\
      --model deeplabv3 --backbone resnet50 --whole true \\
      --restore-from snapshots/.../CS_scenes_36000.msgpack \\
      --output-dir submission/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dcfp_tpu_torch.cli import platform_device
from dcfp_tpu_torch.cli.common import (DTYPES, add_data_args,
                                       add_distributed_args, add_model_args,
                                       build_dataset_from_args,
                                       build_model_from_args, init_params,
                                       job_world, make_mesh,
                                       maybe_initialize_distributed,
                                       maybe_load_channel_cfg, parse_hw,
                                       str2bool)
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dcfp_tpu_torch evaluate_test")
    add_data_args(p, split="test")
    add_model_args(p)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--restore-from", type=str, required=True)
    p.add_argument("--whole", type=str2bool, default=False)
    p.add_argument("--flip", type=str2bool, default=False)
    p.add_argument("--ms", type=str, default="1")
    p.add_argument("--output-dir", type=str, default="outputs")
    p.add_argument("--dtype", type=str, default="float32")
    add_distributed_args(p)
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    device = platform_device()
    maybe_initialize_distributed(args, device)
    world, _ = job_world(args, device, None)
    mesh = make_mesh(args, device)
    device = mesh.device
    from PIL import Image as PILImage

    from dcfp_tpu_torch.data.loader import EvalLoader
    from dcfp_tpu_torch.engine.evaluator import Predictor, pad_inf
    from dcfp_tpu_torch.ops.resize import resize_bilinear
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    from dcfp_tpu_torch.utils import checkpoint as ckpt

    def resize(x: np.ndarray, hw) -> np.ndarray:
        return resize_bilinear(torch.from_numpy(x).to(device),
                               hw).cpu().numpy()

    dataset = build_dataset_from_args(args, args.data_dir)
    # each rank writes the PNGs of its stride of the split
    loader = EvalLoader(dataset, batch_size=args.batch_size,
                        rank=mesh.rank, world=world,
                        num_workers=args.num_workers)

    model = build_model_from_args(args, dataset.num_classes, deepsup=False)
    graph = model.graph
    cfg = maybe_load_channel_cfg(args)
    if cfg is not None:
        graph = apply_channel_cfg(graph, cfg)
    params, bn_state = init_params(graph)
    params, bn_state = ckpt.load_params_non_strict(
        args.restore_from, params, bn_state, device="cpu")
    predictor = Predictor(graph, params, bn_state, dtype=DTYPES[args.dtype],
                          device=device)

    raw_dir = os.path.join(args.output_dir, "raw")
    color_dir = os.path.join(args.output_dir, "color")
    os.makedirs(raw_dir, exist_ok=True)
    os.makedirs(color_dir, exist_ok=True)
    cmap = getattr(dataset, "CMAP", None)
    palette = (list(np.asarray(cmap, np.uint8).reshape(-1))
               if cmap is not None else None)
    scales = [float(s) for s in args.ms.split(",") if s]
    tile = parse_hw(args.input_size)

    for idx, batch in enumerate(loader):
        image = batch["img"]
        metas = batch.get("img_meta", [{}] * image.shape[0])
        orig_hw = image.shape[1:3]
        if args.longsize > 0 or args.shortsize > 0:
            size, mode = ((args.longsize, "long") if args.longsize > 0
                          else (args.shortsize, "short"))
            f = (size / max(orig_hw) if mode == "long"
                 else size / min(orig_hw))
            new_hw = (int(orig_hw[0] * f + 0.5), int(orig_hw[1] * f + 0.5))
            image = resize(image, new_hw)
        hw = image.shape[1:3]
        if args.whole and args.align_corner:
            ph, pw = pad_inf(hw)
            if (ph, pw) != hw:
                image = np.pad(image, ((0, 0), (0, ph - hw[0]),
                                       (0, pw - hw[1]), (0, 0)))
        # resized runs go through the logits path so the resize back to
        # the original resolution happens on logits before the argmax
        # (reference evaluate.py:340-343 / evaluate_test.py protocol)
        need_resize = tuple(hw) != tuple(orig_hw)
        if (args.whole and tuple(scales) == (1.0,) and not args.flip
                and not need_resize):
            out = predictor.predict_whole_labels(image).cpu().numpy()
        else:
            out = predictor.predict_multiscale(
                image, tile, scales, dataset.num_classes, args.flip,
                args.align_corner, args.whole,
                return_probs=need_resize).cpu().numpy()
        out = out[:, :hw[0], :hw[1]]
        if out.ndim == 3:  # device paths emit uint8 label maps
            pred = out.astype(np.uint8)
        else:
            if out.shape[1:3] != tuple(orig_hw):
                out = resize(np.ascontiguousarray(out), orig_hw)
            pred = np.argmax(out, axis=-1).astype(np.uint8)
        for i in range(pred.shape[0]):
            name = metas[i].get("name", f"{idx}_{i}")
            raw = dataset.id2trainId(pred[i], reverse=True).astype(np.uint8)
            PILImage.fromarray(raw).save(
                os.path.join(raw_dir, f"{name}.png"))
            im = PILImage.fromarray(pred[i])
            if palette:
                im.putpalette(palette)
            im.save(os.path.join(color_dir, f"{name}_color.png"))
        if (idx + 1) % 25 == 0:
            log.info("processed %d batches", idx + 1)
    log.info("submission PNGs in %s, palette PNGs in %s", raw_dir,
             color_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
