"""Training engine: the train step and the outer loop.

Port of ``dcfp_tpu/engine/trainer.py`` (reference train.py:239-288):
forward + loss + backward + EIC + optimizer step, in eager PyTorch with
autograd.  The lr is a pure function of the step counter, the EIC EMA
(pruners/dcfp_pruner.py:15-20) is carried state, and the NaN guard
(train.py:260) checks the losses once per log window, so the loop syncs
with the card once a window, not once a step.

Across the ranks of a data-parallel group (``parallel/mesh.py``, one
process per card) a step computes what one process computes on the
global batch: each rank's loss is its share of the global loss, the
gradients are summed over ranks in one flat buffer (a sum, not DDP's
mean, since the shares already add up to the loss), and the EIC, the
gradient norm and the optimizer read the summed gradients, so params and
optimizer state stay identical on every rank.  ``TrainLoop`` stops all
ranks at the same step (a consensus at log boundaries) and snapshots on
rank 0.

Over a mesh with a spatial axis (``make_train_step(..., mesh=mesh)``)
the ranks of one spatial group take the same images, and each keeps its
band of rows of the image, the labels and the weights
(``expand_batch(..., rows=...)``); the graph, the loss tail and the
criterion run on the bands (``graph/apply.py``, ``losses/
criteria.py``), so each rank's loss is still its share of the global
loss and the same flat gradient sum over the world gives every rank the
global gradient.

The JAX package's ``compiler_options`` / ``DCFP_XLA_OPTIONS`` pass XLA
flags to its compiled step; they have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.engine.optim import (Optimizer, apply_updates,
                                          tree_keys, tree_leaves, tree_of)
from dcfp_tpu_torch.graph.apply import graph_apply
from dcfp_tpu_torch.graph.shapes import infer_shapes
from dcfp_tpu_torch.losses.criteria import Criterion
from dcfp_tpu_torch.models.heads import SegModel
from dcfp_tpu_torch.ops.resize import resize_bilinear_cf
from dcfp_tpu_torch.parallel import mesh as pmesh
from dcfp_tpu_torch.parallel import spatial
from dcfp_tpu_torch.prune.eic import EicState, eic_update, init_eic
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


@dataclasses.dataclass
class TrainState:
    """What one step carries to the next.  ``step`` is a host int; the
    tensors live on the train device.  A step returns a new state and
    leaves its input unchanged."""
    step: int
    params: Any
    bn_state: Any
    opt_state: Any
    eic: Optional[EicState]


def _on(device: torch.device, tree):
    return {n: {k: v.to(device) for k, v in d.items()}
            for n, d in tree.items()}


def create_train_state(model: SegModel, params, bn_state,
                       optimizer: Optimizer,
                       prune_type: Optional[str] = None,
                       device: DeviceLike = None) -> TrainState:
    """The first state: params and BN statistics moved to ``device``
    (``None`` means CUDA), a fresh optimizer state and, for
    ``prune_type="dcfp"``, a zero EIC."""
    dev = resolve_device(device)
    params = _on(dev, params)
    eic = init_eic(model.graph, dev) if prune_type == "dcfp" else None
    return TrainState(step=0, params=params, bn_state=_on(dev, bn_state),
                      opt_state=optimizer.init(params), eic=eic)


def expand_batch(batch, normalize, num_classes: int, ignore_label: int,
                 compute_dtype, device: torch.device,
                 rows: Optional[spatial.Rows] = None):
    """Expand a compact batch (``compact=True`` in the data loaders) on
    ``device``: uint8 RGB images normalize to the classic f32 values (with
    the reference's post-normalize zero padding reproduced from the
    ``pad`` validity triple: valid rows, valid columns, flipped), uint8
    labels widen to int64, and per-image class weight vectors gather
    into the per-pixel GSRL weight map.  Classic f32 batches pass
    through.  Returns (NHWC image in ``compute_dtype``, labels).

    ``rows``: keep only rows ``[rows.lo, rows.hi)`` of the image, the
    labels and the weights (cut before the copy to ``device``); the
    ``pad`` triples stay global row counts."""
    band = slice(None) if rows is None else slice(rows.lo, rows.hi)

    def put(x, cut=False):
        x = x[:, band] if cut else x
        return torch.as_tensor(x).to(device, non_blocking=True)

    img = put(batch["img"], True)
    if img.dtype == torch.uint8:
        if normalize is None:
            raise ValueError("uint8 (compact) batches need "
                             "make_train_step(..., normalize=(mean, std))")
        mean, std = normalize
        x = img.float() / 255.0
        x = (x - torch.as_tensor(mean, dtype=torch.float32, device=device)) \
            / torch.as_tensor(std, dtype=torch.float32, device=device)
        pad = batch.get("pad")
        if pad is not None:
            pad = put(pad)
            n, h, w = img.shape[:3]
            r0 = 0 if rows is None else rows.lo
            ys = torch.arange(r0, r0 + h, device=device)[None, :, None]
            cols = torch.arange(w, device=device)[None, None, :]
            hv = pad[:, 0][:, None, None]
            wv = pad[:, 1][:, None, None]
            fl = pad[:, 2][:, None, None]
            valid = (ys < hv) & torch.where(fl > 0, cols >= w - wv,
                                            cols < wv)
            x = torch.where(valid[..., None], x, 0.0)
        img = x
    img = img.to(compute_dtype)
    lab = batch["label"]
    if isinstance(lab, dict) and "weight_class" in lab:
        ori = put(lab["ori"], True).long()
        idx = torch.where(ori == ignore_label, num_classes, ori)
        wc = put(lab["weight_class"])
        weight = torch.gather(wc, 1, idx.flatten(1)).view(idx.shape)
        lab = {"ori": ori, "weight": weight}
    elif isinstance(lab, dict):
        lab = {"ori": put(lab["ori"], True).long(),
               "weight": put(lab["weight"], True)}
    else:
        lab = put(lab, True).long()
    return img, lab


def make_train_step(model: SegModel, criterion: Criterion,
                    optimizer: Optimizer, *, eic_r: float = 0.999,
                    compute_dtype=torch.float32, fuse_loss_tail: bool = True,
                    normalize=None, ignore_label: int = 255,
                    remat_segments: int = 0, device: DeviceLike = None,
                    mesh: Optional[pmesh.Mesh] = None) -> Callable:
    """Build the train step: ``(state, batch, generator) -> (state,
    {"loss", "grad_norm"})``, both metrics 0-d tensors on the device.

    ``batch``: {'img': NHWC float or uint8, 'label': (N,H,W) int or
    {'ori','weight'} or {'ori','weight_class'}, optional 'pad'}, numpy
    or tensors; it moves to ``device`` (``None`` means CUDA).
    ``generator`` draws the dropout masks; ``None`` means no dropout.
    ``grad_norm`` is the global norm of the raw gradients, which are
    also what the EIC update reads.

    ``fuse_loss_tail``: run each head's final bilinear upsample outside
    the graph on NCHW logits and evaluate the criterion channels-first;
    the same interpolation matrices and reductions as the in-graph NHWC
    path.  ``remat_segments`` > 1: recompute the forward's activations
    in that many segments in the backward (see ``graph_apply``), for a
    batch x resolution whose activations would not fit the card.
    ``mesh`` with a spatial axis: this rank keeps its band of the batch's
    rows and the step runs on bands (see the module docstring).
    """
    dev = resolve_device(device)
    graph = model.graph
    axis = mesh.spatial if mesh is not None else None

    tails = {}
    run_graph = graph
    if fuse_loss_tail and all(
            graph.node(o).op == "resize" and
            graph.node(o).attrs.get("to_input") for o in graph.outputs):
        tails = {o: graph.node(o) for o in graph.outputs}
        run_graph = graph.copy()
        run_graph.outputs = [graph.node(o).inputs[0] for o in graph.outputs]

    def loss_fn(params, bn_state, img, labels, generator, rows):
        if rows is not None:  # bands, channels-first throughout
            hw = (rows.h, img.shape[2])
            outs, new_bn = graph_apply(
                run_graph, params, bn_state,
                {"image": img.permute(0, 3, 1, 2)}, train=True,
                generator=generator, remat_segments=remat_segments,
                channels_first=True, input_hw=hw, spatial_axis=axis)
            if tails:
                heights = infer_shapes(run_graph, hw)
                outs = {alias: spatial.resize_band(
                    outs[node.inputs[0]],
                    spatial.Rows(axis, heights[node.inputs[0]][0]), hw,
                    node.attrs["align_corners"], axis)
                    for alias, node in tails.items()}
            loss = criterion(outs, labels, channels_first=True,
                             rows=rows)["loss"]
        elif tails:
            outs, new_bn = graph_apply(
                run_graph, params, bn_state,
                {"image": img.permute(0, 3, 1, 2)}, train=True,
                generator=generator, remat_segments=remat_segments,
                channels_first=True)
            hw = img.shape[1:3]
            preds = {alias: resize_bilinear_cf(outs[node.inputs[0]], hw,
                                               node.attrs["align_corners"])
                     for alias, node in tails.items()}
            loss = criterion(preds, labels, channels_first=True)["loss"]
        else:
            outs, new_bn = graph_apply(
                run_graph, params, bn_state, {"image": img}, train=True,
                generator=generator, remat_segments=remat_segments)
            loss = criterion(outs, labels)["loss"]
        return loss, new_bn

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None):
        rows = (spatial.Rows(axis, batch["img"].shape[1])
                if axis is not None and axis.size > 1 else None)
        img, labels = expand_batch(batch, normalize, model.num_classes,
                                   ignore_label, compute_dtype, dev, rows)
        keys = tree_keys(state.params)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(state.params, keys)]
        loss, new_bn = loss_fn(tree_of(keys, leaves), state.bn_state, img,
                               labels, generator, rows)
        flat = torch.autograd.grad(loss, leaves, materialize_grads=True)
        loss = loss.detach()
        if pmesh.world() > 1:
            flat, loss = _sum_over_ranks(list(flat), loss)
        grads = tree_of(keys, flat)
        eic = state.eic
        if eic is not None:
            eic = eic_update(eic, state.params, grads, eic_r)
        updates, new_opt = optimizer.update(grads, state.opt_state,
                                            state.params)
        new_state = TrainState(
            step=state.step + 1, params=apply_updates(state.params, updates),
            bn_state={n: {k: v.detach() for k, v in d.items()}
                      for n, d in new_bn.items()},
            opt_state=new_opt, eic=eic)
        gnorm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(list(flat))))
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _sum_over_ranks(grads, loss):
    """The gradients and the loss shares summed over ranks, in ONE
    collective over a flat f32 buffer: the global batch's gradient and
    loss, bit-identical on every rank."""
    buf = torch.cat([g.reshape(-1).float() for g in grads]
                    + [loss.reshape(1).float()])
    pmesh.all_reduce_(buf)
    out, off = [], 0
    for g in grads:
        out.append(buf[off:off + g.numel()].view(g.shape).to(g.dtype))
        off += g.numel()
    return out, buf[off].to(loss.dtype)


@dataclasses.dataclass
class TrainLoop:
    """Outer loop: step scheduling, NaN guard, snapshots.

    Mirrors reference train.py:227-288 (steps-based, with a save window)
    without the epoch/DataLoader machinery: the data source is any
    iterator of host batches.  Beyond the reference: a SIGTERM/SIGINT
    handler that finishes the in-flight step, writes a snapshot and
    returns (preemption grace), and an optional JSONL ``metrics_file``
    with one line per log window.  Across ranks, only rank 0 calls
    ``snapshot_hook`` and writes ``metrics_file``.
    """
    model: SegModel
    criterion: Criterion
    optimizer: Optimizer
    num_steps: int
    lr_schedule: Callable[[int], float]
    save_pred_every: int = 10000
    save_steps: int = 0
    snapshot_hook: Optional[Callable] = None  # (state, step) -> None
    log_every: int = 50
    prune_type: Optional[str] = None
    eic_r: float = 0.999
    compute_dtype: Any = torch.float32
    normalize: Optional[tuple] = None  # (mean, std) for compact batches
    ignore_label: int = 255
    handle_signals: bool = False  # SIGTERM/SIGINT -> snapshot + return
    metrics_file: Optional[str] = None  # JSONL, one line per log window
    remat_segments: int = 0  # >1: checkpointed segments in the forward
    mesh: Optional[pmesh.Mesh] = None  # a spatial axis: steps on bands

    def run(self, state: TrainState, batches: Iterator[Dict],
            generator: Optional[torch.Generator] = None,
            start_step: int = 0, device: DeviceLike = None) -> TrainState:
        """Steps ``start_step`` .. ``num_steps - 1`` on ``device``
        (``None`` means CUDA); ``generator`` draws the dropout masks."""
        train_step = make_train_step(
            self.model, self.criterion, self.optimizer, eic_r=self.eic_r,
            compute_dtype=self.compute_dtype, normalize=self.normalize,
            ignore_label=self.ignore_label,
            remat_segments=self.remat_segments, device=device,
            mesh=self.mesh)
        interrupted = {"sig": None}
        restore = {}
        # Across ranks a signal to ONE rank must not make it leave while
        # its peers wait in the next collective: the ranks agree on the
        # stop at log boundaries (a MAX over their flags; every rank
        # reaches the same boundaries), so the stop waits up to
        # log_every steps.
        multiproc = pmesh.world() > 1
        lead = pmesh.rank() == 0
        if self.handle_signals:
            def _on_signal(signum, frame):
                interrupted["sig"] = signum
                log.warning("signal %d: will snapshot and stop %s", signum,
                            "at the next log boundary (multi-process "
                            "consensus)" if multiproc
                            else "after the current step")

            for s in (signal.SIGTERM, signal.SIGINT):
                try:
                    restore[s] = signal.signal(s, _on_signal)
                except ValueError:  # non-main thread
                    break

        t0, last = time.time(), start_step
        # device-resident metrics, fetched once per log window
        pending: list = []
        metrics_f = open(self.metrics_file, "a") \
            if self.metrics_file and lead else None
        try:
            for step in range(start_step, self.num_steps):
                batch = next(batches)
                state, metrics = train_step(state, batch, generator)
                pending.append(torch.stack([metrics["loss"].float(),
                                            metrics["grad_norm"].float()]))
                boundary = ((step + 1) % self.log_every == 0
                            or step + 1 == self.num_steps
                            or (not multiproc
                                and interrupted["sig"] is not None))
                if boundary:
                    fetched = torch.stack(pending).cpu().numpy()  # ONE sync
                    losses = fetched[:, 0]
                    if not np.isfinite(losses).all():  # NaN guard
                        bad = step + 1 - len(losses) + int(
                            np.argmin(np.isfinite(losses)))
                        raise FloatingPointError(
                            f"non-finite loss at step {bad}")
                    dt = time.time() - t0
                    sps = (step + 1 - last) / max(dt, 1e-9)
                    lr = self.lr_schedule(step)
                    log.info("step %d/%d loss=%.4f (avg %.4f) lr=%.3e "
                             "%.2f it/s", step + 1, self.num_steps,
                             float(losses[-1]), float(losses.mean()), lr,
                             sps)
                    if metrics_f is not None:
                        metrics_f.write(json.dumps({
                            "step": step + 1,
                            "loss": float(losses[-1]),
                            "loss_avg": float(losses.mean()),
                            "grad_norm": float(fetched[-1, 1]),
                            "lr": lr,
                            "it_per_s": round(sps, 4),
                            "time": time.time(),
                        }) + "\n")
                        metrics_f.flush()
                    t0, last = time.time(), step + 1
                    pending = []
                stop = interrupted["sig"] is not None
                if multiproc:
                    # every rank runs the consensus at the same
                    # boundaries, and no collective elsewhere
                    if boundary and self.handle_signals:
                        flag = torch.tensor([float(stop)],
                                            device=pmesh.collective_device())
                        stop = pmesh.all_reduce_(flag, "max").item() > 0
                    else:
                        stop = False
                in_window = (step + 1) >= self.save_steps
                saved_this_step = False
                if lead and self.snapshot_hook and (
                        (in_window
                         and (step + 1) % self.save_pred_every == 0)
                        or step + 1 == self.num_steps):
                    self.snapshot_hook(state, step + 1)
                    saved_this_step = True
                if stop:
                    # don't serialize the same step twice when the signal
                    # lands on a step the save window already snapshotted
                    if lead and self.snapshot_hook \
                            and not saved_this_step:
                        self.snapshot_hook(state, step + 1)
                    log.warning("stopped at step %d on signal %s; resume "
                                "with --resume <snapshot> "
                                "--resume-full-state true", step + 1,
                                interrupted["sig"] or "of another rank")
                    break
        finally:
            if metrics_f is not None:
                metrics_f.close()
            for s, h in restore.items():
                signal.signal(s, h)
        return state
