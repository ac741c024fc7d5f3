"""Evaluation harness: whole-image / sliding-window / multi-scale + flip
inference, confusion-matrix metrics, boundary IoU, FPS (port of
``dcfp_tpu/engine/evaluator.py``).

* whole-image single-scale labels take the deploy path: BN folded into
  the convs, then the fused resize-argmax kernel (K1) on the low-res
  logits, so the full-resolution logits are never written;
* multi-scale, flip and sliding-window run the raw eval-mode graph and
  the interpolation matrices of ``ops/resize.py``; sliding-window tiles
  go through ONE batched forward and the overlap average is a scatter-add
  on the device (reference evaluate.py:145-227);
* inputs pad to the stride+1 rule (pad_inf, evaluate.py:119-130) and
  optionally up to a bucket lattice, bounding the distinct shapes a
  variable-resolution val set runs at;
* FPS follows the reference protocol (evaluate.py:326-337): the H2D copy
  happens before the timed bracket, which closes with
  ``torch.cuda.synchronize()``, and the first 5 images are not timed;
* ``evaluate_pipelined`` keeps the confusion matrix on the device and
  syncs with the host only every 128 images.

Arrays come in as NHWC numpy, as in the JAX package.  Across the ranks
of a data-parallel group (``parallel/mesh.py``) each rank evaluates its
stride of the split on its own card and the confusion counts are summed
once, at the end; ``Predictor(mesh=..., shard="data")`` is the rank's own
Predictor on its device (the data axis is the process axis).  With
``shard="spatial"`` or ``"both"`` over a mesh with a spatial axis, the
ranks of one spatial group take the same images (their data rank's
stride) and each runs its band of rows of every forward
(``graph/apply.py``); the low-res logits come back whole to every rank
of the group, and the label path runs K1 on them; each image is counted
in the confusion once, by the group's first rank.  The ``use_aot_*``
hooks take any callable ``run(params, image)``.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch.data.base import normalize_f32
from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.engine.deploy import (_to_device, make_split_inference_fn,
                                          split_pred_tail)
from dcfp_tpu_torch.graph.apply import graph_apply
from dcfp_tpu_torch.graph.shapes import infer_shapes
from dcfp_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_cf
from dcfp_tpu_torch.parallel import mesh as pmesh
from dcfp_tpu_torch.parallel import spatial
from dcfp_tpu_torch.utils.edge import mask_to_boundary_device
from dcfp_tpu_torch.utils.logger import get_logger
from dcfp_tpu_torch.utils.profiling import sync

log = get_logger()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def confusion_matrix(gt: np.ndarray, pred: np.ndarray, num_classes: int,
                     ignore_label: int = 255) -> np.ndarray:
    """Bincount confusion matrix (reference evaluate.py:229-247).

    Matches the reference's get_confusion_matrix EXACTLY, including its
    handling of out-of-range predictions: in boundary-IoU mode pred
    contains ignore_label (non-boundary) at pixels where gt IS a
    boundary (evaluate.py:352-357 transforms pred and gt independently,
    then filters on gt only at :359-361), so ``idx = gt*C + pred`` can
    exceed C*C.  The reference bincounts all idx values and copies only
    the first C*C entries into the matrix — entries beyond C*C are
    dropped, and out-of-range idx that happen to land BELOW C*C alias
    into unrelated (gt', pred') cells (e.g. gt=0, pred=255, C=19 ->
    cell (13, 8)).  We reproduce that verbatim: published boundary-IoU
    numbers are only comparable under identical binning."""
    valid = gt != ignore_label
    gt = gt[valid].astype(np.int64)
    pred = pred[valid].astype(np.int64)
    idx = gt * num_classes + pred
    n = num_classes * num_classes
    return np.bincount(idx, minlength=n)[:n].reshape(
        num_classes, num_classes).astype(np.float64)


def metrics_from_confusion(cm: np.ndarray) -> Dict:
    """meanIU / per-class IU / precision / recall
    (reference evaluate.py:373-381)."""
    pos = cm.sum(1)
    res = cm.sum(0)
    tp = np.diag(cm)
    iu_array = tp / np.maximum(1.0, pos + res - tp)
    return {
        "meanIU": float(iu_array.mean()),
        "IU_array": iu_array,
        "meanP": float((tp / (res + 1e-5)).mean()),
        "precision": tp / (res + 1e-5),
        "meanR": float((tp / (pos + 1e-5)).mean()),
        "recall": tp / (pos + 1e-5),
    }


def pad_inf(image_hw: Tuple[int, int], stride: int = 8
            ) -> Tuple[int, int]:
    """Padded (H, W): to stride+1 modulo stride (evaluate.py:119-130)."""
    h, w = image_hw
    pad_h = (stride + 1 - h % stride) % stride
    pad_w = (stride + 1 - w % stride) % stride
    return h + pad_h, w + pad_w


def bucket_hw(image_hw: Tuple[int, int], quantum: int,
              align_corner: bool = False) -> Tuple[int, int]:
    """Smallest (H', W') >= (H, W) on the bucket lattice.

    align_corner buckets sit at k*quantum + 1 (so they satisfy the
    stride+1 rule of :func:`pad_inf` for any stride dividing quantum);
    otherwise at k*quantum.  Zero-pad + slice-back is the reference's own
    approximation (pad_inf zero-pads and evaluate.py crops the logits),
    just quantized so a whole variable-size val set runs at O(few)
    shapes instead of one per resolution.
    """
    h, w = image_hw
    if quantum <= 1:
        return h, w
    off = 1 if align_corner else 0
    bh = max(math.ceil((h - off) / quantum), 1) * quantum + off
    bw = max(math.ceil((w - off) / quantum), 1) * quantum + off
    return bh, bw


def confusion_update_device(cm: torch.Tensor, pred: torch.Tensor,
                            gt: torch.Tensor, *, num_classes: int,
                            ignore_label: int = 255) -> torch.Tensor:
    """Device-resident confusion accumulation: the bincount of
    :func:`confusion_matrix` into an int32 (C, C) counts matrix on the
    matrix's device, so throughput-mode eval never fetches per-image
    predictions to the host.

    The bins are a fixed C*C + 1 (the last one is trash) and the counts
    go in by ``index_add_``: ``torch.bincount`` on CUDA reads its
    input's max on the host, a sync per image.  Every index outside
    [0, C*C] goes to the trash bin before the scatter, where an index
    past the end would trip a device-side assert (the JAX package's
    scatter drops such an index, e.g. a non-ignore gt >= C, and clips a
    negative one to bin 0)."""
    n = num_classes * num_classes
    gt = gt.to(torch.int32)
    idx = torch.where(gt != ignore_label,
                      gt * num_classes + pred.to(torch.int32), n)
    idx = torch.where((idx < 0) | (idx > n), n, idx).reshape(-1)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return cm + counts[:n].view(num_classes, num_classes)


def allreduce_confusion(cm: np.ndarray) -> np.ndarray:
    """The reference's dist.all_reduce of the confusion matrix
    (evaluate.py:370-372): the counts summed over ranks, exactly (int64),
    as f64; the identity in a single process."""
    if pmesh.world() == 1:
        return cm
    t = torch.from_numpy(np.asarray(cm).astype(np.int64)).to(
        pmesh.collective_device())
    return pmesh.all_reduce_(t).cpu().numpy().astype(np.float64)


def _pad_hw(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """Zero-pad an NHWC array at the bottom and right to (h, w)."""
    ih, iw = image.shape[1], image.shape[2]
    return np.pad(np.asarray(image), ((0, 0), (0, h - ih), (0, w - iw),
                                      (0, 0)))


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------

class _CountCompiles:
    """Counter of the distinct input signatures of one entry point.

    Records the (shape, dtype) of its *image* argument (the last tensor
    positional arg) plus any hashable non-tensor positional args (the
    split tail's ``out_hw``).  PyTorch runs eagerly and compiles nothing;
    this is the port's analog of the JAX package's compiled-program
    count, which the bucketing discipline bounds: the same calls give the
    same count in both packages.
    """

    def __init__(self, fn):
        self._fn = fn
        self._seen = set()

    def __call__(self, *args):
        img = next(a for a in reversed(args) if hasattr(a, "shape"))
        key = [tuple(img.shape), str(img.dtype)]
        for a in args:
            if hasattr(a, "shape") or isinstance(a, (dict, list)):
                continue  # tensors keyed above; param trees are fixed
            try:
                hash(a)
            except TypeError:
                continue
            key.append(a)
        self._seen.add(tuple(key))
        return self._fn(*args)

    @property
    def count(self) -> int:
        return len(self._seen)


class Predictor:
    """Forward of a (graph, params, state) triple on one device.

    Options:
    * ``bucket_quantum`` — pad every input up to the bucket lattice (see
      :func:`bucket_hw`) and slice logits back: bounds the distinct
      shapes on variable-resolution datasets.
    * ``normalize=(mean, std)`` — needed for raw uint8 (compact) items,
      normalized on the device by :meth:`prep_raw`.
    * ``device`` — None means CUDA (raises without it); ``"cpu"`` runs
      on the CPU.
    * ``mesh`` + ``shard`` — the JAX package's sharded forward.  The
      data axis is the process axis: this is the rank's own Predictor on
      ``mesh.device``, fed its data rank's stride of the split.  With
      ``shard="spatial"`` or ``"both"`` and a mesh with a spatial axis,
      every forward runs over the rank's spatial group, image height
      split in bands, each rank called with the same whole images and
      getting the whole result (logits or labels).  ``counts`` is
      whether this rank adds its images to the confusion (the spatial
      group's first rank does).
    """

    def __init__(self, graph, params, state, dtype=torch.float32, *,
                 bucket_quantum: int = 0, align_corner: bool = False,
                 mesh=None, shard: str = "data", normalize=None,
                 device: DeviceLike = None):
        if shard not in ("data", "spatial", "both"):
            raise ValueError(f"Predictor(shard={shard!r}): data, spatial "
                             "or both")
        self.spatial = None
        self.counts = True
        if mesh is not None:
            if device is None:
                device = mesh.device
            if shard != "data":
                self.spatial = mesh.spatial
            self.counts = mesh.spatial_rank == 0
        dev = resolve_device(device)
        self.device = dev
        self.graph = graph
        self.dtype = dtype
        self.bucket_quantum = int(bucket_quantum)
        self.align_corner = bool(align_corner)
        self.normalize = normalize
        self.params = _to_device(params, dev, torch.float32)
        self.state = _to_device(state, dev, torch.float32)
        if normalize is not None:
            # made here, once: a tensor built from host values is a
            # synchronous copy, which the pipelined loop must not make
            self._norm = tuple(torch.tensor(v, dtype=torch.float32,
                                            device=dev) for v in normalize)
        self._fwd = _CountCompiles(self._graph_logits)
        if self.spatial is not None:
            self._band_body = split_pred_tail(graph)
        # label path = the DEPLOY forward: BN folded into convs, then the
        # fused resize-argmax tail (K1) on the low-res logits; the logits
        # path keeps the raw graph the probability-averaging modes need
        abody, atail, adev = make_split_inference_fn(
            graph, params, state, dtype=dtype, fold_bn=True,
            output="argmax", device=dev, spatial_axis=self.spatial)
        self._afn = _CountCompiles(abody)
        self._atail = _CountCompiles(atail) if atail is not None else None
        self._argmax_params = adev
        self._fwd_argmax = self._split_argmax
        self._aot_tile = None
        self._sliding_keys = set()

    @torch.inference_mode()
    def _graph_logits(self, image: torch.Tensor) -> torch.Tensor:
        """The raw eval-mode graph: NHWC image -> f32 NHWC logits."""
        if self.spatial is not None:
            return self._banded_logits(image)
        outs, _ = graph_apply(self.graph, self.params, self.state,
                              {"image": image.to(self.device, self.dtype)})
        return outs["pred"].float()

    def _banded_logits(self, image: torch.Tensor) -> torch.Tensor:
        """:meth:`_graph_logits` over the spatial group: the graph up to
        the to-input resize of 'pred' on this rank's band of rows, the
        bands of its low-res logits gathered, and that resize on the
        whole map (the one-process resize of the same logits)."""
        graph, tail = self._band_body
        name = tail.inputs[0] if tail is not None else "pred"
        x = image.to(self.device, self.dtype).permute(0, 3, 1, 2)
        hw = (int(x.shape[2]), int(x.shape[3]))
        outs, _ = graph_apply(graph, self.params, self.state,
                              {"image": spatial.shard_rows(x, self.spatial)},
                              input_hw=hw, channels_first=True,
                              spatial_axis=self.spatial)
        z = spatial.gather_rows(outs[name], infer_shapes(graph, hw)[name][0],
                                self.spatial)
        if tail is not None:
            z = resize_bilinear_cf(z, hw, tail.attrs["align_corners"])
        return z.permute(0, 2, 3, 1).float()

    def _split_argmax(self, image):
        z = self._afn(self._argmax_params, image)
        if self._atail is None:
            return z
        return self._atail(z, (int(image.shape[1]), int(image.shape[2])))

    def num_compiles(self) -> int:
        """Distinct (entry point, input shape) pairs across the entry
        points: the raw forward, the deploy body and tail, and each
        sliding (image, tile) shape.  The port's analog of the JAX
        package's compiled-program count (the bucketing discipline
        metric); the same calls count the same in both."""
        total = 0
        for fn in (self._fwd, self._afn, self._atail):
            if isinstance(fn, _CountCompiles):
                total += fn.count
        return total + len(self._sliding_keys)

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        return self._fwd(image)

    # -- serialized-executable serving (the --use-trt analog) ---------------
    def _no_spatial(self, what: str) -> None:
        if self.spatial is not None:
            raise ValueError(f"{what}: a served artifact runs whole "
                             "images; it has no spatial sharding")

    def use_aot_whole(self, run, aot_params) -> None:
        """Route whole-image forwards through a served deploy callable
        ``run(aot_params, image)`` (argmax output, reference
        evaluate.py:273-276)."""
        self._no_spatial("use_aot_whole")
        self._fwd = lambda image: run(aot_params, image)
        self._fwd_argmax = self._fwd

    def use_aot_tiles(self, run, aot_params) -> None:
        """Route sliding-window tiles through a tile-shaped served
        callable (logits output), one call per tile at the canonical
        (batch, tile_h, tile_w, 3) shape with f32 input; the overlap
        scatter-add still runs on the device.  Works under multi-scale +
        flip too: undersized border tiles zero-pad (reference
        evaluate.py:166-171)."""
        self._no_spatial("use_aot_tiles")
        self._aot_tile = (run, aot_params)

    def use_aot_scales(self, runs_by_hw: Dict[Tuple[int, int], object],
                       aot_params) -> None:
        """Route whole-image forwards through per-scale served logits
        callables, dispatched by the input's spatial shape (one per
        scale shape, as ``cli.deploy --ms`` exports them; flip runs at
        the same shape)."""
        self._no_spatial("use_aot_scales")

        def fwd(image):
            hw = (int(image.shape[1]), int(image.shape[2]))
            run = runs_by_hw.get(hw)
            if run is None:
                raise ValueError(
                    f"no serialized executable for input {hw}; this "
                    f"artifact covers {sorted(runs_by_hw)} — re-export "
                    "with cli.deploy --ms matching the eval scales and "
                    "--input-size matching the (padded) eval resolution")
            return run(aot_params, image.to(torch.float32))

        self._fwd = fwd
        self._fwd_argmax = lambda image: torch.argmax(
            fwd(image), -1).to(torch.uint8)

    # -- raw uint8 input (compact eval items) -------------------------------
    def prep_raw(self, image: torch.Tensor, valid_hw) -> torch.Tensor:
        """Normalize a raw uint8 RGB image on the device: f32 ``/255 -
        mean / std``, the identical IEEE f32 ops the host path runs
        (``data/base.normalize_f32``), so results are bitwise-equal; then
        zero pixels beyond ``valid_hw``, reproducing the protocol's
        pad-with-zeros-AFTER-normalize semantics.  Keeping the wire
        format uint8 cuts H2D traffic 4x."""
        if self.normalize is None:
            raise ValueError("Predictor(normalize=(mean, std)) is "
                             "required for uint8 (compact) eval items")
        mean, std = self._norm
        x = normalize_f32(image.to(self.device, torch.float32), mean, std)
        rows = torch.arange(x.shape[1], device=x.device)[None, :, None, None]
        cols = torch.arange(x.shape[2], device=x.device)[None, None, :, None]
        return torch.where((rows < valid_hw[0]) & (cols < valid_hw[1]), x,
                           0.0)

    # -- input staging -------------------------------------------------------
    def stage(self, image) -> torch.Tensor:
        """An NHWC host array to the device; tensors go to the device
        (a no-op for one already there).  The single staging path every
        eval mode funnels through."""
        if isinstance(image, torch.Tensor):
            return image.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

    def device_put(self, image: np.ndarray) -> torch.Tensor:
        """Bucket-pad and transfer an NHWC host image to the device,
        synchronously (so a following timed region excludes the H2D
        copy, matching the reference protocol evaluate.py:326)."""
        if self.bucket_quantum:
            h, w = image.shape[1:3]
            bh, bw = bucket_hw((h, w), self.bucket_quantum,
                               self.align_corner)
            if (bh, bw) != (h, w):
                image = _pad_hw(image, bh, bw)
        dev = self.stage(image)
        sync(dev)
        return dev

    # -- whole image -------------------------------------------------------
    def predict_whole(self, image) -> torch.Tensor:
        """Forward on a host or device image; f32 NHWC logits on the
        device, sliced back to the input's (unbucketed) spatial size."""
        h, w = image.shape[1:3]
        if not isinstance(image, torch.Tensor):
            image = self.device_put(image)
        out = self(image)
        if tuple(out.shape[1:3]) != (h, w):
            out = out[:, :h, :w]
        return out

    def predict_whole_labels(self, image) -> torch.Tensor:
        """Deploy forward + fused resize-argmax (K1 on the card) ->
        (N, H, W) uint8 label maps on the device.  The fast path for
        single-scale whole-image eval (no probability averaging
        needed)."""
        h, w = image.shape[1:3]
        if not isinstance(image, torch.Tensor):
            image = self.device_put(image)
        out = self._fwd_argmax(image)
        if tuple(out.shape[1:3]) != (h, w):
            out = out[:, :h, :w]
        return out

    # -- sliding window (evaluate.py:145-184), batched tiles ----------------
    @staticmethod
    def _tile_boxes(h, w, th, tw, overlap):
        stride = int(math.ceil(th * (1 - overlap)))
        rows = int(math.ceil(max(h - th, 0) / stride) + 1)
        cols = int(math.ceil(max(w - tw, 0) / stride) + 1)
        boxes = []
        for r in range(rows):
            for c in range(cols):
                x2 = min(c * stride + tw, w)
                y2 = min(r * stride + th, h)
                boxes.append((max(y2 - th, 0), max(x2 - tw, 0), y2, x2))
        return boxes

    @staticmethod
    def _overlap_average(parts, boxes, n, h, w, num_classes, device):
        """Scatter-add each box's logits into the image and divide by the
        count of boxes over each pixel, in box order."""
        full = torch.zeros((n, h, w, num_classes), dtype=torch.float32,
                           device=device)
        count = torch.zeros((1, h, w, 1), dtype=torch.float32, device=device)
        for part, (y1, x1, y2, x2) in zip(parts, boxes):
            full[:, y1:y2, x1:x2] += part.float()[:, :y2 - y1, :x2 - x1]
            count[:, y1:y2, x1:x2] += 1.0
        return full / count

    def predict_sliding(self, image, tile_size: Tuple[int, int],
                        num_classes: int, overlap: float = 1 / 3
                        ) -> torch.Tensor:
        """Overlap-averaged logits over tiles, (N, H, W, C) f32 on the
        device.  Every tile runs in ONE batched forward, undersized border
        tiles zero-padded to (th, tw) and their logits cropped back (the
        reference pads then crops, evaluate.py:166-171); the overlap
        scatter-add and its count map stay on the device."""
        n, h, w, _ = image.shape
        th, tw = tile_size
        boxes = tuple(self._tile_boxes(h, w, th, tw, overlap))
        if self._aot_tile is not None:
            return self._predict_sliding_aot(image, (th, tw), num_classes,
                                             boxes)
        self._sliding_keys.add((n, h, w, th, tw, num_classes, boxes))
        x = self.stage(image)
        tiles = torch.cat([
            F.pad(x[:, y1:y2, x1:x2],
                  (0, 0, 0, tw - (x2 - x1), 0, th - (y2 - y1)))
            for y1, x1, y2, x2 in boxes])
        logits = self._graph_logits(tiles)
        return self._overlap_average(
            [logits[i * n:(i + 1) * n] for i in range(len(boxes))], boxes,
            n, h, w, num_classes, x.device)

    def _predict_sliding_aot(self, image, tile_size, num_classes, boxes):
        """Sliding eval through a tile-shaped served callable: one call per
        box (the reference's per-tile TRT forwards, evaluate.py:173-177),
        f32 tiles in, logits merged on the device."""
        run, aot_params = self._aot_tile
        n, h, w, _ = image.shape
        th, tw = tile_size
        x = self.stage(image)
        parts = [run(aot_params,
                     F.pad(x[:, y1:y2, x1:x2].to(torch.float32),
                           (0, 0, 0, tw - (x2 - x1), 0, th - (y2 - y1))))
                 for y1, x1, y2, x2 in boxes]
        self._sliding_keys.add(("aot", n, h, w, th, tw, num_classes, boxes))
        return self._overlap_average(parts, boxes, n, h, w, num_classes,
                                     x.device)

    # -- multi-scale + flip (evaluate.py:198-227) ---------------------------
    def predict_multiscale(self, image, tile_size: Tuple[int, int],
                           scales: Sequence[float], num_classes: int,
                           flip: bool, align_corner: bool, whole: bool,
                           return_probs: bool = False) -> torch.Tensor:
        """Scale/flip-averaged prediction as (N, H, W) uint8 label maps,
        computed entirely on the device: the image uploads once; per-scale
        resizes, tile scatter-adds, flips, the prob accumulation and the
        final argmax never leave it.

        ``return_probs`` returns the accumulated (N, H, W, C) f32 logits
        instead — needed when the caller must resize logits back to the
        original resolution before the argmax (reference
        evaluate.py:340-343 longsize/shortsize protocol).  Flip is
        ``torch.flip`` on the width axis (a copy: PyTorch has no
        negative-stride view).
        """
        n, h, w, _ = image.shape
        dev = self.stage(image)
        acc = torch.zeros((n, h, w, num_classes), dtype=torch.float32,
                          device=dev.device)
        for scale in scales:
            hs, ws = int(h * float(scale)), int(w * float(scale))
            scaled = resize_bilinear(dev, (hs, ws),
                                     align_corners=align_corner)
            if whole:
                probs = self.predict_whole(scaled)
                if probs.ndim == 3:
                    # a label-emitting (argmax) forward — e.g. a served
                    # whole-image deploy callable — cannot feed the
                    # probability-averaging path
                    raise RuntimeError(
                        "predict_multiscale needs a logits forward; the "
                        "served executable emits argmax label maps")
                if flip:
                    fp = self.predict_whole(torch.flip(scaled, dims=[2]))
                    probs = 0.5 * (probs + torch.flip(fp, dims=[2]))
            else:
                probs = self.predict_sliding(scaled, tile_size, num_classes)
                if flip:
                    fp = self.predict_sliding(torch.flip(scaled, dims=[2]),
                                              tile_size, num_classes)
                    probs = 0.5 * (probs + torch.flip(fp, dims=[2]))
            acc = acc + resize_bilinear(probs, (h, w),
                                        align_corners=align_corner)
        if return_probs:
            return acc
        return torch.argmax(acc, -1).to(torch.uint8)


# ---------------------------------------------------------------------------
# evaluation loop
# ---------------------------------------------------------------------------

def evaluate(predictor: Predictor, loader: Iterable, *, num_classes: int,
             ignore_label: int = 255, whole: bool = True,
             scales: Sequence[float] = (1.0,), flip: bool = False,
             align_corner: bool = False,
             tile_size: Tuple[int, int] = (769, 769),
             longsize: int = -1, shortsize: int = -1,
             iou_type: str = "mask", dilation_ratio: float = 0.02,
             fps_warmup: int = 5,
             save_predict_dir: Optional[str] = None,
             cmap: Optional[np.ndarray] = None,
             result_file: Optional[str] = None,
             result_tag: str = "", pipeline: bool = False) -> Dict:
    """The reference's eval protocol over ``loader``'s batches of
    ``{"img": NHWC f32 (or raw uint8), "label", "img_meta"}`` numpy
    arrays.  Returns the metrics, ``fps`` and the f64 ``confusion``."""
    if pipeline:
        if (longsize <= 0 and shortsize <= 0 and iou_type == "mask"
                and save_predict_dir is None):
            return evaluate_pipelined(
                predictor, loader, num_classes=num_classes,
                ignore_label=ignore_label, whole=whole, scales=scales,
                flip=flip, tile_size=tile_size,
                align_corner=align_corner,
                fps_warmup=fps_warmup, result_file=result_file,
                result_tag=result_tag)
        log.warning("pipeline mode needs mask eval without prediction "
                    "saving or longsize/shortsize logits-resize; using "
                    "the protocol loop")
    cm = np.zeros((num_classes, num_classes), np.float64)
    pure_inf_time, fps = 0.0, 0.0
    n_imgs = 0
    if hasattr(loader, "__len__"):
        # tiny sets: still report an FPS instead of warming up everything
        fps_warmup = min(fps_warmup, max(len(loader) - 1, 0))
    for idx, batch in enumerate(loader):
        image = batch["img"]  # NHWC float32 (or raw uint8 compact items)
        if image.dtype == np.uint8:
            if predictor.normalize is None:
                raise ValueError("uint8 (compact) eval items need "
                                 "Predictor(normalize=(mean, std))")
            mean, std = predictor.normalize
            image = normalize_f32(np.asarray(image, np.float32),
                                  np.asarray(mean, np.float32),
                                  np.asarray(std, np.float32))
        label = batch.get("label")
        metas = batch.get("img_meta", [{}] * image.shape[0])
        orig_hw = image.shape[1:3]
        if longsize > 0 or shortsize > 0:
            size, mode = ((longsize, "long") if longsize > 0
                          else (shortsize, "short"))
            f = (size / max(orig_hw) if mode == "long"
                 else size / min(orig_hw))
            new_hw = (int(orig_hw[0] * f + 0.5), int(orig_hw[1] * f + 0.5))
            image = resize_bilinear(predictor.stage(image),
                                    new_hw).cpu().numpy()
        size_scale = image.shape[1:3]
        if whole and align_corner:
            ph, pw = pad_inf(size_scale)
            if (ph, pw) != size_scale:
                image = _pad_hw(image, ph, pw)

        # longsize/shortsize runs must resize *logits* back to the
        # original resolution before the argmax (reference
        # evaluate.py:340-343 F.interpolate of the output) — route those
        # through the probability path instead of the uint8 label path
        need_resize = ((longsize > 0 or shortsize > 0)
                       and tuple(size_scale) != tuple(orig_hw))
        if (whole and tuple(scales) == (1.0,) and not flip
                and not need_resize):
            # reference protocol (evaluate.py:326-337): H2D before the
            # timed region; the bracket closes on a device synchronize
            dev_img = predictor.device_put(image)
            t0 = time.perf_counter()
            out = predictor.predict_whole_labels(dev_img)
            sync(out)
            elapsed = time.perf_counter() - t0
        else:
            image = predictor.stage(image)
            sync(image)
            t0 = time.perf_counter()
            out = predictor.predict_multiscale(
                image, tile_size, scales, num_classes, flip, align_corner,
                whole, return_probs=need_resize)
            sync(out)
            elapsed = time.perf_counter() - t0

        out = out[:, :size_scale[0], :size_scale[1]]
        if out.ndim == 4:
            if longsize > 0 or shortsize > 0:
                out = resize_bilinear(out, orig_hw)
            out = torch.argmax(out, dim=-1)
        seg_pred = out.cpu().numpy().astype(np.uint8)

        if save_predict_dir and predictor.counts:
            os.makedirs(save_predict_dir, exist_ok=True)
            from PIL import Image as PILImage
            palette = (list(np.asarray(cmap, np.uint8).reshape(-1))
                       if cmap is not None else None)
            for i in range(seg_pred.shape[0]):
                im = PILImage.fromarray(seg_pred[i])
                if palette:
                    im.putpalette(palette)
                name = metas[i].get("name", f"{idx}_{i}")
                im.save(os.path.join(save_predict_dir, f"{name}.png"))

        if label is not None:
            seg_gt = np.asarray(label, np.int64)
            sp = seg_pred.astype(np.int64)
            if iou_type == "boundary":
                # one batched device erosion over pred AND gt
                stacked = mask_to_boundary_device(
                    np.concatenate([sp, seg_gt]), num_classes,
                    dilation_ratio, ignore_label,
                    device=predictor.device).astype(np.int64)
                sp, seg_gt = stacked[:sp.shape[0]], stacked[sp.shape[0]:]
            cm += confusion_matrix(seg_gt, sp, num_classes, ignore_label)

        if idx >= fps_warmup:
            pure_inf_time += elapsed
            n_imgs += image.shape[0]
            fps = n_imgs / pure_inf_time
        if (idx + 1) % 25 == 0:
            log.info("eval %d: FPS %.2f img/s", idx + 1, fps)

    return _finalize_eval(cm, fps, result_file, result_tag, predictor.counts)


def _finalize_eval(cm: np.ndarray, fps: float,
                   result_file: Optional[str], result_tag: str,
                   counts: bool = True) -> Dict:
    """The metrics of the confusion summed over ranks; a rank that does
    not count its images (``counts=False``, a spatial group's other
    ranks) adds zeros."""
    if not counts:
        cm = np.zeros_like(cm)
    cm = allreduce_confusion(cm)  # multi-process eval (evaluate.py:370-372)
    result = metrics_from_confusion(cm)
    result["fps"] = fps
    result["confusion"] = cm
    log.info("meanIU=%.4f meanP=%.4f meanR=%.4f FPS=%.2f",
             result["meanIU"], result["meanP"], result["meanR"], fps)
    if result_file and pmesh.rank() == 0:  # rank-0 result.txt
        with open(result_file, "a") as f:
            f.write(f"test with {result_tag}\n")
            f.write(json.dumps({"meanIU": result["meanIU"],
                                "IU_array": result["IU_array"].tolist()}))
            f.write("\n")
            f.write(json.dumps({"meanP": result["meanP"],
                                "p": result["precision"].tolist()}))
            f.write("\n")
            f.write(json.dumps({"meanR": result["meanR"],
                                "r": result["recall"].tolist()}))
            f.write(f" FPS: {fps:.2f} img / s\n--------\n")
    return result


def _to_device_async(array: np.ndarray, device: torch.device
                     ) -> torch.Tensor:
    """A host array to ``device`` without waiting: on CUDA a non_blocking
    copy from a pinned copy of the array.  The pinned copy may be dropped
    at once: PyTorch's caching host allocator records an event on the
    copy's stream and hands the block out again only after the copy."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def evaluate_pipelined(predictor: Predictor, loader: Iterable, *,
                       num_classes: int, ignore_label: int = 255,
                       whole: bool = True,
                       scales: Sequence[float] = (1.0,),
                       flip: bool = False,
                       tile_size: Tuple[int, int] = (769, 769),
                       align_corner: bool = False, fps_warmup: int = 5,
                       flush_every: int = 128,
                       result_file: Optional[str] = None,
                       result_tag: str = "") -> Dict:
    """Throughput-mode eval: no per-image host sync.

    The protocol loop (:func:`evaluate`) brackets every image with a
    synchronize (reference evaluate.py:327-337).  Here the H2D copies
    (non_blocking, from pinned host copies), forwards, argmax and
    confusion update all queue on the device; only the (C, C) int32
    counts matrix is fetched every ``flush_every`` images (bounding int32
    overflow), and that fetch is the only wait.

    Covers every probability-averaging mode: whole-image ss takes the
    deploy label path; multi-scale / flip / sliding-window run the same
    device-resident :meth:`Predictor.predict_multiscale` the protocol
    loop uses.  The confusion is bit-identical to the protocol loop's;
    FPS is the wall-clock of the pipelined loop after ``fps_warmup``
    images."""
    ss_whole = whole and tuple(scales) == (1.0,) and not flip
    device = predictor.device
    cm_host = np.zeros((num_classes, num_classes), np.float64)
    cm_dev = torch.zeros((num_classes, num_classes), dtype=torch.int32,
                         device=device)
    t0 = None
    n_timed, since_flush, fps = 0, 0, 0.0
    if hasattr(loader, "__len__"):
        fps_warmup = min(fps_warmup, max(len(loader) - 1, 0))

    def flush():
        nonlocal cm_host, cm_dev, since_flush
        cm_host += cm_dev.cpu().numpy().astype(np.float64)  # waits for all
        cm_dev = torch.zeros((num_classes, num_classes), dtype=torch.int32,
                             device=device)
        since_flush = 0

    for idx, batch in enumerate(loader):
        if idx == fps_warmup and t0 is None:
            flush()
            t0 = time.perf_counter()
        image = batch["img"]
        if "label" not in batch:
            raise ValueError(
                "--pipeline accumulates a confusion matrix on device and "
                "needs labeled batches; this split has no labels — use "
                "the protocol loop (or evaluate_test for submissions)")
        label = batch["label"]
        size_scale = image.shape[1:3]
        if whole and align_corner:
            ph, pw = pad_inf(size_scale)
            if (ph, pw) != size_scale:
                image = _pad_hw(image, ph, pw)
        if ss_whole and predictor.bucket_quantum:
            # ms/sliding never bucket: per-scale shapes derive from the
            # true (h, w) in the protocol loop too (predict_multiscale)
            h, w = image.shape[1:3]
            bh, bw = bucket_hw((h, w), predictor.bucket_quantum,
                               align_corner)
            if (bh, bw) != (h, w):
                image = _pad_hw(image, bh, bw)
        dev = _to_device_async(image, device)
        if dev.dtype == torch.uint8:
            # compact item: raw uint8 over the wire (4x less H2D),
            # normalized + pad-masked on device, bitwise-equal logits
            dev = predictor.prep_raw(dev, size_scale)
        if ss_whole:
            out = predictor.predict_whole_labels(dev)
        else:
            out = predictor.predict_multiscale(
                dev, tile_size, scales, num_classes, flip, align_corner,
                whole)
        out = out[:, :size_scale[0], :size_scale[1]]
        lab = np.asarray(label)
        gt = _to_device_async(lab if lab.dtype == np.uint8
                              else lab.astype(np.int32), device)
        cm_dev = confusion_update_device(cm_dev, out, gt,
                                         num_classes=num_classes,
                                         ignore_label=ignore_label)
        since_flush += image.shape[0]  # images, not batches: the int32
        # overflow bound is per-image pixel counts (a 1024x2048 image is
        # ~2.1M counts; 128 images stay ~8x under 2^31 even if one
        # confusion cell takes every pixel)
        if t0 is not None:
            n_timed += image.shape[0]
        if since_flush >= flush_every:
            flush()
        if (idx + 1) % 25 == 0 and t0 is not None:
            log.info("eval %d (pipelined): dispatched", idx + 1)
    flush()  # final fetch synchronizes the whole pipeline
    if t0 is not None and n_timed:
        fps = n_timed / (time.perf_counter() - t0)
    return _finalize_eval(cm_host, fps, result_file, result_tag,
                          predictor.counts)
