"""Loss functions: CE + deep supervision, OHEM, GSRL.

Port of ``dcfp_tpu/losses/criteria.py``: the same functions on tensors,
with logits NHWC or, with ``channels_first=True``, NCHW, and integer label
maps (N, H, W).  Everything stays on the logits' device, so the loss adds
no host sync to the train step.

* :func:`ce_dsn`   — CE + deep supervision (reference criterion.py:48-74)
* :func:`ohem_dsn` — OHEM main head + CE deepsup (reference ohem.py:95-119);
  the threshold search is one k-th value over the downsampled true-class
  probabilities, with the reference's scipy-zoom index math
* :func:`gsrl_dsn` — the distribution-calibrated long-tail loss
  (reference criterion.py:77-101)

Every loss returns a dict with key ``'loss'`` (reference convention).

Across the ranks of a data-parallel group (``parallel/mesh.py``) each
rank's loss is its share of the loss of the global batch, so the shares
add up to the one-process loss on it: CE divides its local weighted sum
by the global weight sum, GSRL its local sum of per-image terms by the
global image count, and OHEM's threshold is the k-th value over every
rank's probabilities.  In a world of 1 each is the plain loss.

Under a spatial axis (``rows=spatial.Rows(axis, H)``: the logits, labels
and weights are this rank's band of rows of images of global height H)
the same sums count each pixel once, on the rank that holds it.  What
reads across rows swaps rows with the group (GSRL's 9x9 max pool of the
weights, OHEM's down-sampled copy), and GSRL's per-image sums are summed
over the group first; the group's first rank then adds each image's
term, the others add zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_cf
from dcfp_tpu_torch.parallel import mesh, spatial


def _take_class(x: torch.Tensor, safe_labels: torch.Tensor,
                channels_first: bool) -> torch.Tensor:
    """x[..., label] over the class axis -> (N, H, W)."""
    ax = 1 if channels_first else -1
    return torch.gather(x, ax, safe_labels.unsqueeze(ax)).squeeze(ax)


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_label: int, channels_first: bool = False):
    """(nll, valid_mask); nll is zero-filled at ignored pixels."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=1 if channels_first else -1)
    nll = -_take_class(logp, safe, channels_first)
    return torch.where(valid, nll, 0.0), valid


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  ignore_label: int = 255, class_weights=None,
                  channels_first: bool = False) -> torch.Tensor:
    """Mean CE over valid pixels; torch CrossEntropyLoss semantics (a
    weighted mean normalizes by the sum of the applied class weights)."""
    nll, valid = _per_pixel_ce(logits, labels, ignore_label, channels_first)
    if class_weights is not None:
        safe = torch.where(valid, labels, 0).long()
        cw = torch.as_tensor(class_weights, dtype=torch.float32,
                             device=logits.device)
        w = cw[safe] * valid
    else:
        w = valid.float()
    den = mesh.all_reduce_(torch.sum(w))  # the global batch's weight sum
    return torch.sum(nll * w) / torch.clamp(den, min=1e-8)


# ---------------------------------------------------------------------------
# OHEM
# ---------------------------------------------------------------------------

def _zoom0_indices(n: int, m: int) -> np.ndarray:
    """Source indices of scipy.ndimage.zoom(..., order=0) for n -> m:
    endpoint-aligned coordinates x_i = i*(n-1)/(m-1), order-0 spline
    (nearest, halves round up)."""
    if m <= 1 or n <= 1:
        return np.zeros(max(m, 1), np.int64)
    x = np.arange(m, dtype=np.float64) * (n - 1) / (m - 1)
    return np.minimum(np.floor(x + 0.5), n - 1).astype(np.int64)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_label: int = 255, thresh: float = 0.7,
                       min_kept: int = 100000, factor: int = 8,
                       class_weights=None, channels_first: bool = False,
                       rows: Optional[spatial.Rows] = None) -> torch.Tensor:
    """Online hard example mining CE (reference loss/ohem.py:9-93): CE
    over the pixels that :func:`ohem_threshold_and_mined` keeps."""
    _, mined = ohem_threshold_and_mined(
        logits, labels, ignore_label=ignore_label, thresh=thresh,
        min_kept=min_kept, factor=factor, channels_first=channels_first,
        rows=rows)
    return cross_entropy(logits, mined, ignore_label=ignore_label,
                         class_weights=class_weights,
                         channels_first=channels_first)


def ohem_threshold_and_mined(logits, labels, *, ignore_label: int = 255,
                             thresh: float = 0.7, min_kept: int = 100000,
                             factor: int = 8, channels_first: bool = False,
                             rows: Optional[spatial.Rows] = None):
    """(threshold, mined_labels), the mining half of OHEM.

    The threshold is the k-th smallest true-class probability among the
    valid pixels of a 1/``factor`` copy (k = min_kept / factor^2),
    floored at ``thresh``; the copy reproduces the reference's
    ``scipy.ndimage.zoom`` (sizes round(dim/factor), endpoint-aligned,
    order 1 for the probabilities, order 0 for the labels).  Pixels whose
    true-class probability is above it become ``ignore_label``.  Across
    ranks (each with the same batch shape) the k-th value is taken over
    every rank's copy, gathered, so the threshold is the global batch's.
    Under ``rows`` (channels-first only) each rank builds its band of the
    copy, from the probability and label rows that band reads, and pads
    its share of the gathered values with +inf to the longest band's.
    """
    probs = F.softmax(logits.float(), dim=1 if channels_first else -1)
    probs = probs.detach()

    n, h, w = labels.shape
    if rows is not None:
        if not channels_first:
            raise ValueError("a banded OHEM takes channels-first logits")
        h = rows.h
    out_h = max(int(round(h / factor)), 1)  # scipy: int(round(dim*zoom))
    out_w = max(int(round(w / factor)), 1)
    ridx = _zoom0_indices(h, out_h)
    cols = torch.from_numpy(_zoom0_indices(w, out_w)).to(labels.device)
    if rows is None:
        small_probs = (resize_bilinear_cf if channels_first
                       else resize_bilinear)(probs, (out_h, out_w),
                                             align_corners=True)
        small_labels = labels[:, torch.from_numpy(ridx).to(labels.device)]
        flat_len = n * out_h * out_w
    else:
        axis = rows.axis
        if out_h < axis.size:
            raise ValueError(f"OHEM's {out_h}-row copy cannot be split "
                             f"over {axis.size} spatial ranks")
        small_probs = spatial.resize_band(probs, rows, (out_h, out_w), True,
                                          axis)
        ranges = [(int(ridx[a]), int(ridx[b - 1]) + 1)
                  for a, b in axis.bands(out_h)]
        a, b = axis.band(out_h)
        got = spatial.fetch_rows(labels, ranges, h, axis)
        lo = ranges[axis.index][0]
        small_labels = got[:, torch.from_numpy(ridx[a:b] - lo).to(
            labels.device)]
        flat_len = n * -(-out_h // axis.size) * out_w  # the longest band
    small_labels = small_labels[:, :, cols]
    valid_s = small_labels != ignore_label
    safe_s = torch.where(valid_s, small_labels, 0).long()
    p_true_s = _take_class(small_probs, safe_s, channels_first)
    mine = torch.where(valid_s, p_true_s, torch.inf).flatten()
    if mine.numel() < flat_len:
        mine = torch.cat([mine, mine.new_full((flat_len - mine.numel(),),
                                              torch.inf)])
    flat = mesh.all_gather(mine)
    n_data = mesh.world() // (rows.axis.size if rows is not None else 1)
    k = max(min(min_kept // (factor * factor), n_data * n * out_h * out_w),
            1)
    kth = torch.kthvalue(flat, k).values
    num_valid = mesh.all_reduce_(valid_s.sum())
    one = torch.ones((), device=kth.device)
    threshold = torch.where(
        num_valid <= k, one,
        torch.where(torch.isfinite(kth), torch.clamp(kth, min=thresh), one))

    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    p_true = _take_class(probs, safe, channels_first)
    kept = valid & (p_true <= threshold)
    return threshold, torch.where(kept, labels, ignore_label)


# ---------------------------------------------------------------------------
# GSRL (distribution-calibrated long-tail loss)
# ---------------------------------------------------------------------------

def gsrl_loss_terms(logits: torch.Tensor, labels_ori: torch.Tensor,
                    pixel_weight: torch.Tensor, *, ignore_label: int,
                    k: int = 9, gamma: float = 9.0,
                    channels_first: bool = False,
                    rows: Optional[spatial.Rows] = None) -> torch.Tensor:
    """Shared GSRL weight map (criterion.py:86-93): the kxk max-pool
    dilation of the per-pixel class weight (padded with -inf) times a
    softmax-margin calibration factor, zero at ignored pixels, without
    gradient.  Under ``rows`` the pool reads k // 2 rows past the band
    from the ranks that hold them."""
    pw = pixel_weight.float().unsqueeze(1)
    if rows is None:
        w = F.max_pool2d(pw, k, stride=1, padding=k // 2).squeeze(1)
    else:
        w = spatial.halo_max_pool2d(pw, rows, rows.h, k, 1,
                                    k // 2).squeeze(1)
    score = F.softmax(logits.float(), dim=1 if channels_first else -1)
    top2 = torch.topk(score, 2, dim=1 if channels_first else -1).values
    margin = top2.select(1 if channels_first else -1, 0) - \
        top2.select(1 if channels_first else -1, 1)
    w = (1.0 + gamma * (1.0 - margin)) * w
    w = torch.where(labels_ori == ignore_label, 0.0, w)
    return w.detach()


def _gsrl_weighted_ce(logits, labels_ori, weight, ignore_label,
                      channels_first=False, rows=None):
    nll, _ = _per_pixel_ce(logits, labels_ori, ignore_label, channels_first)
    num = torch.sum(nll * weight, dim=(1, 2))
    den = torch.sum(weight, dim=(1, 2))
    if rows is not None:  # an image's sums over its bands
        num = spatial.spatial_sum(num, rows.axis)
        den = spatial.spatial_sum(den, rows.axis)
    den = den + 1e-8
    if mesh.world() == 1:
        return torch.mean(num / den)
    terms = torch.sum(num / den)
    n = mesh.all_reduce_(num.new_full((), num.shape[0]))
    if rows is not None:
        # each image once, by the group's first rank; the zeros keep the
        # others' backward through the group sum
        terms = terms * (1.0 if rows.axis.index == 0 else 0.0)
        n = n / rows.axis.size
    return terms / n  # the global batch's mean


# ---------------------------------------------------------------------------
# DSN (deep supervision) wrappers — the public criterion API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Criterion:
    """Callable criterion: (preds, labels) -> {'loss': scalar}.

    ``preds``: dict with 'pred' and optionally 'deepsup' (NHWC logits, or
    NCHW with ``channels_first=True``).  ``labels``: int map (N,H,W), or
    dict {'ori','weight'} when the dataset attaches balance weights
    (reference datasets/Base.py:73-89).
    """
    fn: Callable
    name: str

    def __call__(self, preds, labels, *, channels_first: bool = False,
                 rows: Optional[spatial.Rows] = None
                 ) -> Dict[str, torch.Tensor]:
        return self.fn(preds, labels, channels_first=channels_first,
                       rows=rows)


def _labels_ori(labels):
    return labels["ori"] if isinstance(labels, dict) else labels


def ce_dsn(ignore_label: int = 255, ds_weight: float = 0.4,
           class_weights=None) -> Criterion:
    """CE + auxiliary deep-supervision CE (criterion.py:48-74)."""

    def fn(preds, labels, channels_first=False, rows=None):
        y = _labels_ori(labels)
        loss = cross_entropy(preds["pred"], y, ignore_label=ignore_label,
                             class_weights=class_weights,
                             channels_first=channels_first)
        if "deepsup" in preds:
            loss = loss + ds_weight * cross_entropy(
                preds["deepsup"], y, ignore_label=ignore_label,
                class_weights=class_weights, channels_first=channels_first)
        return {"loss": loss}

    return Criterion(fn, "ce")


def ohem_dsn(ignore_label: int = 255, ds_weight: float = 0.4,
             ohem_thres: float = 0.7, ohem_keep: int = 100000,
             class_weights=None) -> Criterion:
    """OHEM main head + plain CE deepsup (ohem.py:95-119)."""

    def fn(preds, labels, channels_first=False, rows=None):
        y = _labels_ori(labels)
        loss = ohem_cross_entropy(preds["pred"], y,
                                  ignore_label=ignore_label,
                                  thresh=ohem_thres, min_kept=ohem_keep,
                                  class_weights=class_weights,
                                  channels_first=channels_first, rows=rows)
        if "deepsup" in preds:
            loss = loss + ds_weight * cross_entropy(
                preds["deepsup"], y, ignore_label=ignore_label,
                class_weights=class_weights, channels_first=channels_first)
        return {"loss": loss}

    return Criterion(fn, "ohem")


def gsrl_dsn(ignore_label: int = 255, ds_weight: float = 0.4, k: int = 9,
             gamma: float = 9.0) -> Criterion:
    """Distribution-calibrated loss (criterion.py:77-101).  Requires dict
    labels {'ori','weight'} from a balance-enabled dataset."""

    def fn(preds, labels, channels_first=False, rows=None):
        y, pw = labels["ori"], labels["weight"]
        w = gsrl_loss_terms(preds["pred"], y, pw, ignore_label=ignore_label,
                            k=k, gamma=gamma, channels_first=channels_first,
                            rows=rows)
        loss = _gsrl_weighted_ce(preds["pred"], y, w, ignore_label,
                                 channels_first, rows)
        if "deepsup" in preds:
            loss = loss + ds_weight * _gsrl_weighted_ce(
                preds["deepsup"], y, w, ignore_label, channels_first, rows)
        return {"loss": loss}

    return Criterion(fn, "gsrl")


def combined(criterions) -> Criterion:
    """Sum of criteria for comma-joined loss types (criterion.py:30-45)."""

    def fn(preds, labels, channels_first=False, rows=None):
        total = 0.0
        for c in criterions:
            total = total + c(preds, labels, channels_first=channels_first,
                              rows=rows)["loss"]
        return {"loss": total}

    return Criterion(fn, "+".join(c.name for c in criterions))


def build_criterions(loss_type: str, *, ignore_label: int = 255,
                     class_weights=None, loss_para: Optional[dict] = None
                     ) -> Criterion:
    """Registry dispatch (criterion.py:11-27), comma-joined combos allowed."""
    loss_para = dict(loss_para or {})
    balance_weight = loss_para.pop("balance_weight", False)
    cw = class_weights if balance_weight else None

    def one(lt: str) -> Criterion:
        if lt == "ce":
            return ce_dsn(ignore_label=ignore_label, class_weights=cw,
                          **{k: v for k, v in loss_para.items()
                             if k in ("ds_weight",)})
        if lt == "ohem":
            kw = {k: v for k, v in loss_para.items()
                  if k in ("ds_weight", "ohem_thres", "ohem_keep")}
            return ohem_dsn(ignore_label=ignore_label, class_weights=cw,
                            **kw)
        if lt == "gsrl":
            kw = {k: v for k, v in loss_para.items()
                  if k in ("ds_weight", "k", "gamma")}
            return gsrl_dsn(ignore_label=ignore_label, **kw)
        raise NotImplementedError(lt)

    parts = [one(lt.strip()) for lt in loss_type.split(",")]
    return parts[0] if len(parts) == 1 else combined(parts)
