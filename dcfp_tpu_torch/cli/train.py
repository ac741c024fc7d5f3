"""Training entry point (port of ``dcfp_tpu/cli/train.py``).

Pretrain:  accumulate DCFP EIC scores while training full-width
           (``--prune-type dcfp``), export ``score.msgpack`` at the end
           (reference train.py:215-216, 284-288).
Finetune:  rebuild at pruned widths from ``--channel-cfg`` and resume the
           pruned weights (reference train.py:200-210), typically with
           ``--loss-type gsrl --balance 2 --resample`` for long-tail.

Data parallel over processes, one per card: ``--num-devices`` cards
(-1: every visible one) run as that many processes, which the CLI starts
itself unless a launcher did (``torchrun``, ``--distributed true``).
``--batch-size`` is the GLOBAL batch; each rank loads its stride of the
epoch permutation, and the step reduces BN moments, losses and gradients
over the ranks (``engine/trainer.py``).  Rank 0 writes the snapshots,
the EIC scores and the metrics file.  ``--spatial-shards S`` makes the
W processes a ``(W / S) x S`` mesh: the global batch splits over the
W / S data ranks, and the S ranks of each take the same images and
split their height (``parallel/spatial.py``); S must divide W and W / S
the global batch, checked before any file is written.
``--xla-options`` is accepted, as the scripts pass it, and logged as
having no counterpart.

Example (Cityscapes pretrain, scripts/cs/pretrain.sh with the module
renamed):
  python -m dcfp_tpu_torch.cli.train --dataset CS --model deeplabv3 \\
      --backbone resnet50 --backbone-para '{"os":8,"mg_unit":[1,2,4]}' \\
      --input-size 769,769 --batch-size 8 --num-steps 4000 \\
      --random-mirror --random-scale --random-brightness \\
      --loss-type ce --deepsup true --prune-type dcfp \\
      --snapshot-dir snapshots/cs_pretrain
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from dcfp_tpu_torch.cli import platform_device
from dcfp_tpu_torch.cli.common import (add_data_args, add_model_args,
                                       add_optim_args, add_runtime_args,
                                       add_train_data_args,
                                       build_dataset_from_args,
                                       build_model_from_args, compute_dtype,
                                       init_params, job_world,
                                       launch_workers, make_mesh,
                                       maybe_initialize_distributed,
                                       maybe_load_channel_cfg, mesh_axes,
                                       setup_dirs_and_logging, str2bool)
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dcfp_tpu_torch train")
    add_data_args(p, split="train")
    add_train_data_args(p)
    add_model_args(p)
    add_optim_args(p)
    add_runtime_args(p)
    p.add_argument("--num-steps", type=int, default=40000)
    p.add_argument("--start-iters", type=int, default=0)
    p.add_argument("--resume", type=str, default=None,
                   help="snapshot/pruned .msgpack to load")
    p.add_argument("--resume-full-state", type=str2bool, default=False,
                   help="restore optimizer/EIC state too (exact resume)")
    p.add_argument("--save-pred-every", type=int, default=10000)
    p.add_argument("--save-steps", type=int, default=0,
                   help="snapshots only at/after this step")
    p.add_argument("--deepsup", type=str2bool, default=True)
    p.add_argument("--loss-type", type=str, default="ce",
                   help="ce|ohem|gsrl or comma-joined")
    p.add_argument("--loss-para", type=lambda s: json.loads(s)
                   if s else {}, default={})
    p.add_argument("--prune-type", type=str, default=None,
                   help="'dcfp' accumulates EIC during training")
    p.add_argument("--resample", type=str2bool, default=False,
                   help="class-uniform long-tail resampling")
    p.add_argument("--pretrained", type=str, default=None,
                   help="torch backbone checkpoint (.pth) to convert; "
                        "'auto' resolves via the path registry")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--remat", type=int, default=0,
                   help="split the forward into N checkpointed segments: "
                        "backward activation memory drops ~Nx for ~1/3 "
                        "extra FLOPs (0/1 = off)")
    p.add_argument("--metrics-file", type=str, default=None,
                   help="append JSONL training metrics (one line per log "
                        "window) for external dashboards")
    p.add_argument("--xla-options", type=str, default=None,
                   help="XLA compiler options of the JAX package's "
                        "train-step compile; no counterpart here (logged, "
                        "ignored)")
    p.add_argument("--compact-batches", type=str2bool, default=True,
                   help="ship uint8 batches and normalize / expand "
                        "weight maps on device (~6x less host->device "
                        "traffic); false = classic f32 host batches")
    return p


def _resolve_pretrained(args, graph, params, bn_state):
    """Convert + merge an ImageNet torch backbone checkpoint
    (reference networks/backbone/resnet.py:172-187 build_resnet)."""
    from dcfp_tpu_torch.data import paths
    from dcfp_tpu_torch.models.convert import merge_pretrained_backbone
    path = args.pretrained
    if path == "auto":
        path = paths.pretrained_dir(args.backbone)
    if not path or not os.path.exists(path):
        if path:
            log.warning("pretrained checkpoint %s not found; random init",
                        path)
        return params, bn_state
    from dcfp_tpu_torch.utils.checkpoint import _torch_load
    sd = _torch_load(path)
    params, bn_state = merge_pretrained_backbone(graph, sd, params,
                                                 bn_state, device="cpu")
    log.info("merged pretrained backbone from %s", path)
    return params, bn_state


def device_batches(loader, mesh):
    """This rank's host batches -> its device (drops img_meta).  Compact
    batches (uint8 img + weight_class vectors, the default) ship as they
    are — normalization and weight expansion happen inside the train step
    (``engine/trainer.expand_batch``); classic f32 batches are widened
    here first."""
    from dcfp_tpu_torch.parallel.mesh import shard_batch
    for batch in loader:
        out = {"img": batch["img"]}
        if batch["img"].dtype != np.uint8:
            out["img"] = batch["img"].astype(np.float32)
        label = batch["label"]
        if isinstance(label, dict) and "weight_class" not in label:
            label = {"ori": label["ori"].astype(np.int32),
                     "weight": label["weight"].astype(np.float32)}
        elif not isinstance(label, dict) and label.dtype != np.uint8:
            label = label.astype(np.int32)
        out["label"] = label
        if "pad" in batch:
            out["pad"] = batch["pad"]
        yield shard_batch(mesh, out)


def main(argv=None) -> int:
    parser = get_parser()
    args = parser.parse_args(argv)
    # the reference spells resampling --data-para '{"resample":true}'
    # (datasets pass-through); honor both spellings — without this the
    # build_dataset extra kwarg would silently override data_para
    args.resample = bool(args.resample
                         or args.data_para.get("resample", False))
    if args.balance == 2 and not args.resample:
        parser.error("--balance 2 (effective-number weights) needs the "
                     "sampled class id, which only --resample true "
                     "provides (reference datasets/Base.py:82)")
    device = platform_device()
    maybe_initialize_distributed(args, device)
    world, start = job_world(args, device, args.num_devices)
    try:
        n_data, _ = mesh_axes(args, world)
    except ValueError as e:
        parser.error(str(e))
    # --batch-size is GLOBAL (reference engine.py:81: batch //= world),
    # split over the data axis
    if args.batch_size % n_data:
        parser.error(f"--batch-size {args.batch_size} not divisible by "
                     f"{n_data} data rank(s)")
    if start:
        return launch_workers("dcfp_tpu_torch.cli.train", argv, world)
    mesh = make_mesh(args, device)
    device = mesh.device
    if args.xla_options:
        log.info("--xla-options %s: XLA compiler options have no "
                 "counterpart in the PyTorch port; ignored",
                 args.xla_options)
    setup_dirs_and_logging(args)
    np.random.seed(args.random_seed)

    from dcfp_tpu_torch.data.loader import TrainLoader
    from dcfp_tpu_torch.engine.optim import (build_optimizer,
                                             poly_warmup_schedule)
    from dcfp_tpu_torch.engine.trainer import TrainLoop, create_train_state
    from dcfp_tpu_torch.losses.criteria import build_criterions
    from dcfp_tpu_torch.parallel.mesh import replicate_tree
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    from dcfp_tpu_torch.utils import checkpoint as ckpt

    dataset = build_dataset_from_args(args, "train", resample=args.resample,
                                      compact=args.compact_batches)
    # each process loads its data rank's stride of the epoch permutation
    # (the ranks of a spatial group the same images) and decodes with
    # --num-workers processes
    loader = TrainLoader(dataset, args.batch_size // mesh.n_data,
                         seed=args.random_seed,
                         num_workers=args.num_workers,
                         rank=mesh.data_rank, world=mesh.n_data)

    criterion = build_criterions(
        args.loss_type, ignore_label=dataset.ignore_label,
        class_weights=dataset.class_weights, loss_para=dict(args.loss_para))

    model = build_model_from_args(args, dataset.num_classes, args.deepsup)
    graph = model.graph
    channel_cfg = maybe_load_channel_cfg(args)
    if channel_cfg is not None:  # finetune at pruned widths
        graph = apply_channel_cfg(graph, channel_cfg)
        model.graph = graph

    params, bn_state = init_params(graph, args.random_seed)
    if args.pretrained and channel_cfg is None:
        params, bn_state = _resolve_pretrained(args, graph, params,
                                               bn_state)

    tx = build_optimizer(
        optim=args.optim, learning_rate=args.learning_rate,
        momentum=args.momentum, weight_decay=args.weight_decay,
        num_steps=args.num_steps, power=args.power, warmup=args.warmup,
        betas=args.betas, no_decay=args.no_decay, params=params)
    schedule = poly_warmup_schedule(args.learning_rate, args.num_steps,
                                    args.power, warmup=args.warmup)

    state = create_train_state(model, params, bn_state, tx,
                               prune_type=args.prune_type, device=device)
    start_step = args.start_iters
    if args.resume:
        if args.resume_full_state:
            state = ckpt.load_train_state(args.resume, state, device=device)
            start_step = int(state.step)
            log.info("resumed full state from %s at step %d", args.resume,
                     start_step)
        else:
            p, b = ckpt.load_params_non_strict(args.resume, state.params,
                                               state.bn_state, device=device)
            state = dataclasses.replace(state, params=p, bn_state=b,
                                        step=start_step)
            log.info("loaded weights from %s", args.resume)
    state = replicate_tree(mesh, state)  # every rank starts from rank 0's
    log.info("mesh: %d data x %d spatial on %d %s device(s) across %d "
             "process(es); global batch %d", mesh.n_data, mesh.n_spatial,
             mesh.size, device.type, world, args.batch_size)

    def snapshot_hook(st, step):  # TrainLoop calls it on rank 0 only
        path = os.path.join(args.snapshot_dir,
                            f"{args.dataset}_scenes_{step}.msgpack")
        ckpt.save_train_state(path, st, tx)

    loop = TrainLoop(model=model, criterion=criterion, optimizer=tx,
                     num_steps=args.num_steps, lr_schedule=schedule,
                     save_pred_every=args.save_pred_every,
                     save_steps=args.save_steps,
                     snapshot_hook=snapshot_hook,
                     log_every=args.log_every,
                     prune_type=args.prune_type,
                     compute_dtype=compute_dtype(args),
                     normalize=(dataset.mean, dataset.std),
                     ignore_label=dataset.ignore_label,
                     # preemption grace: snapshot + clean stop; across
                     # processes the stop is a consensus at log
                     # boundaries, so no rank leaves mid-collective
                     handle_signals=True,
                     metrics_file=args.metrics_file,
                     remat_segments=args.remat, mesh=mesh)

    host = iter(loader)
    try:
        state = loop.run(state, device_batches(host, mesh),
                         torch.Generator().manual_seed(args.random_seed),
                         start_step=start_step, device=device)
    finally:
        host.close()
        loader.stop()

    if args.prune_type == "dcfp" and state.eic is not None \
            and mesh.rank == 0:
        score_path = os.path.join(args.snapshot_dir, "score.msgpack")
        ckpt.save_eic(score_path, state.eic)
        log.info("exported EIC scores to %s", score_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
