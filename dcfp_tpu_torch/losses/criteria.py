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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_cf
from dcfp_tpu_torch.parallel import mesh


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
                       class_weights=None,
                       channels_first: bool = False) -> torch.Tensor:
    """Online hard example mining CE (reference loss/ohem.py:9-93): CE
    over the pixels that :func:`ohem_threshold_and_mined` keeps."""
    _, mined = ohem_threshold_and_mined(
        logits, labels, ignore_label=ignore_label, thresh=thresh,
        min_kept=min_kept, factor=factor, channels_first=channels_first)
    return cross_entropy(logits, mined, ignore_label=ignore_label,
                         class_weights=class_weights,
                         channels_first=channels_first)


def ohem_threshold_and_mined(logits, labels, *, ignore_label: int = 255,
                             thresh: float = 0.7, min_kept: int = 100000,
                             factor: int = 8, channels_first: bool = False):
    """(threshold, mined_labels), the mining half of OHEM.

    The threshold is the k-th smallest true-class probability among the
    valid pixels of a 1/``factor`` copy (k = min_kept / factor^2),
    floored at ``thresh``; the copy reproduces the reference's
    ``scipy.ndimage.zoom`` (sizes round(dim/factor), endpoint-aligned,
    order 1 for the probabilities, order 0 for the labels).  Pixels whose
    true-class probability is above it become ``ignore_label``.  Across
    ranks (each with the same batch shape) the k-th value is taken over
    every rank's copy, gathered, so the threshold is the global batch's.
    """
    probs = F.softmax(logits.float(), dim=1 if channels_first else -1)
    probs = probs.detach()

    h, w = labels.shape[1], labels.shape[2]
    out_h = max(int(round(h / factor)), 1)  # scipy: int(round(dim*zoom))
    out_w = max(int(round(w / factor)), 1)
    small_probs = (resize_bilinear_cf if channels_first else resize_bilinear)(
        probs, (out_h, out_w), align_corners=True)
    rows = torch.from_numpy(_zoom0_indices(h, out_h)).to(labels.device)
    cols = torch.from_numpy(_zoom0_indices(w, out_w)).to(labels.device)
    small_labels = labels[:, rows][:, :, cols]
    valid_s = small_labels != ignore_label
    safe_s = torch.where(valid_s, small_labels, 0).long()
    p_true_s = _take_class(small_probs, safe_s, channels_first)
    flat = mesh.all_gather(torch.where(valid_s, p_true_s, torch.inf).flatten())
    k = max(min(min_kept // (factor * factor), flat.numel()), 1)
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
                    channels_first: bool = False) -> torch.Tensor:
    """Shared GSRL weight map (criterion.py:86-93): the kxk max-pool
    dilation of the per-pixel class weight (padded with -inf) times a
    softmax-margin calibration factor, zero at ignored pixels, without
    gradient."""
    w = F.max_pool2d(pixel_weight.float().unsqueeze(1), k, stride=1,
                     padding=k // 2).squeeze(1)
    score = F.softmax(logits.float(), dim=1 if channels_first else -1)
    top2 = torch.topk(score, 2, dim=1 if channels_first else -1).values
    margin = top2.select(1 if channels_first else -1, 0) - \
        top2.select(1 if channels_first else -1, 1)
    w = (1.0 + gamma * (1.0 - margin)) * w
    w = torch.where(labels_ori == ignore_label, 0.0, w)
    return w.detach()


def _gsrl_weighted_ce(logits, labels_ori, weight, ignore_label,
                      channels_first=False):
    nll, _ = _per_pixel_ce(logits, labels_ori, ignore_label, channels_first)
    num = torch.sum(nll * weight, dim=(1, 2))
    den = torch.sum(weight, dim=(1, 2)) + 1e-8
    if mesh.world() == 1:
        return torch.mean(num / den)
    n = mesh.all_reduce_(num.new_full((), num.shape[0]))
    return torch.sum(num / den) / n  # the global batch's mean


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

    def __call__(self, preds, labels, *,
                 channels_first: bool = False) -> Dict[str, torch.Tensor]:
        return self.fn(preds, labels, channels_first=channels_first)


def _labels_ori(labels):
    return labels["ori"] if isinstance(labels, dict) else labels


def ce_dsn(ignore_label: int = 255, ds_weight: float = 0.4,
           class_weights=None) -> Criterion:
    """CE + auxiliary deep-supervision CE (criterion.py:48-74)."""

    def fn(preds, labels, channels_first=False):
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

    def fn(preds, labels, channels_first=False):
        y = _labels_ori(labels)
        loss = ohem_cross_entropy(preds["pred"], y,
                                  ignore_label=ignore_label,
                                  thresh=ohem_thres, min_kept=ohem_keep,
                                  class_weights=class_weights,
                                  channels_first=channels_first)
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

    def fn(preds, labels, channels_first=False):
        y, pw = labels["ori"], labels["weight"]
        w = gsrl_loss_terms(preds["pred"], y, pw, ignore_label=ignore_label,
                            k=k, gamma=gamma, channels_first=channels_first)
        loss = _gsrl_weighted_ce(preds["pred"], y, w, ignore_label,
                                 channels_first)
        if "deepsup" in preds:
            loss = loss + ds_weight * _gsrl_weighted_ce(
                preds["deepsup"], y, w, ignore_label, channels_first)
        return {"loss": loss}

    return Criterion(fn, "gsrl")


def combined(criterions) -> Criterion:
    """Sum of criteria for comma-joined loss types (criterion.py:30-45)."""

    def fn(preds, labels, channels_first=False):
        total = 0.0
        for c in criterions:
            total = total + c(preds, labels,
                              channels_first=channels_first)["loss"]
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
