"""Boundary utilities (port of ``dcfp_tpu/utils/edge.py``): the mask <->
one-hot helpers, the host erosion-based boundary extraction of boundary
IoU (reference utils/edge_utils.py:90-127) and its batched on-device
form, and the distance-transform edge maps (:29-74) the reference
dataset layer imports (datasets/Base.py:10) — unused by its entry points
but part of the public surface.  The host half imports ``cv2`` and
``scipy.ndimage`` where it uses them, never at module level.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch.device import DeviceLike, resolve_device


def mask_to_onehot(mask: np.ndarray, num_classes: int) -> np.ndarray:
    """(H,W) int mask -> (num_classes,H,W) one-hot (ignore pixels all-zero)."""
    return np.stack([(mask == i) for i in range(num_classes)]).astype(
        np.uint8)


def onehot_to_mask(onehot: np.ndarray, background: int = 255) -> np.ndarray:
    """(C,H,W) one-hot -> (H,W) mask; all-zero pixels -> background."""
    mask = onehot.argmax(axis=0)
    mask = np.where(onehot.sum(axis=0) > 0, mask, background)
    return mask.astype(np.int64)


def _inner_distance(binary: np.ndarray) -> np.ndarray:
    """Euclidean distance of each in-class pixel to the region border
    (image edges count as border via 1-px zero padding)."""
    from scipy.ndimage import distance_transform_edt
    padded = np.pad(binary, 1)
    return distance_transform_edt(padded)[1:-1, 1:-1]


def _band(dist: np.ndarray, radius_max: float, radius_min: float
          ) -> np.ndarray:
    """Pixels whose border distance lies in (radius_min, radius_max]."""
    keep = dist <= radius_max
    if radius_min >= 0:
        keep &= dist > radius_min
    return (keep & (dist > 0)).astype(np.uint8)


def onehot_to_multiclass_edges(onehot: np.ndarray, radius_max: float,
                               num_classes: int, radius_min: float = -1
                               ) -> np.ndarray:
    """(C,H,W) one-hot -> per-class edge bands of width (radius_min,
    radius_max] measured inward from each region border
    (reference edge_utils.py:29-51)."""
    if radius_max < 0:
        return onehot
    edges = np.zeros(onehot.shape, np.uint8)
    for i in np.where(onehot.sum(axis=(1, 2)) > 0)[0]:
        edges[i] = _band(_inner_distance(onehot[i]), radius_max,
                         radius_min)
    return edges


def onehot_to_binary_edges(onehot: np.ndarray, radius_max: float,
                           num_classes: int, radius_min: float = -1
                           ) -> np.ndarray:
    """(C,H,W) one-hot -> (1,H,W) union of all class edge bands
    (reference edge_utils.py:53-74)."""
    if radius_max < 0:
        return onehot
    edges = onehot_to_multiclass_edges(onehot, radius_max, num_classes,
                                       radius_min)
    return (edges.sum(axis=0, keepdims=True) > 0).astype(np.uint8)


def binary_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02
                       ) -> np.ndarray:
    """Binary mask -> boundary strip of width dilation_ratio * diagonal
    (reference edge_utils.py:98-116)."""
    import cv2
    h, w = mask.shape
    img_diag = np.sqrt(h ** 2 + w ** 2)
    dilation = max(int(round(dilation_ratio * img_diag)), 1)
    new_mask = cv2.copyMakeBorder(mask, 1, 1, 1, 1, cv2.BORDER_CONSTANT,
                                  value=0)
    kernel = np.ones((3, 3), np.uint8)
    eroded = cv2.erode(new_mask, kernel, iterations=dilation)
    return mask - eroded[1:h + 1, 1:w + 1]


def mask_to_boundary(mask: np.ndarray, num_classes: int,
                     dilation_ratio: float = 0.02,
                     background: int = 255) -> np.ndarray:
    """Class mask -> boundary-only class mask; interiors become
    ``background`` so the confusion matrix scores boundaries only
    (reference edge_utils.py:118-127)."""
    onehot = mask_to_onehot(mask, num_classes)
    boundary = np.zeros_like(onehot)
    for i in np.where(onehot.sum(axis=(1, 2)) > 0)[0]:
        boundary[i] = binary_to_boundary(onehot[i],
                                         dilation_ratio=dilation_ratio)
    return onehot_to_mask(boundary.astype(int), background=background)


@torch.inference_mode()
def _boundary(masks: torch.Tensor, dilation: int, num_classes: int,
              background: int) -> torch.Tensor:
    """(N, H, W) int32 masks -> (N, H, W) int32 boundary-only masks.

    The erosion is run on the complement ``1 - onehot``: eroding the
    one-hot by a 3x3 min is dilating its complement by a 3x3 max, so
    each iteration is one ``F.max_pool2d`` (a 3x3 max is the 3x1 max of
    the 1x3 max, the JAX package's separable min-pool, exactly).  The
    1-px zero border of the one-hot (the reference's copyMakeBorder
    value=0) is a border of ones here, and max_pool's implicit -inf
    padding is the +inf window padding of the JAX min: beyond the border
    nothing erodes."""
    h, w = masks.shape[1], masks.shape[2]
    classes = torch.arange(num_classes, dtype=torch.int32,
                           device=masks.device)
    onehot = masks[:, None] == classes[None, :, None, None]
    outside = F.pad((~onehot).to(torch.float32), (1, 1, 1, 1), value=1.0)
    for _ in range(dilation):
        outside = F.max_pool2d(outside, 3, stride=1, padding=1)
    boundary = onehot & (outside[:, :, 1:h + 1, 1:w + 1] > 0.5)
    any_b = boundary.any(dim=1)
    idx = boundary.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(any_b, idx, background)


def mask_to_boundary_device(masks, num_classes: int,
                            dilation_ratio: float = 0.02,
                            background: int = 255, *,
                            device: DeviceLike = None) -> np.ndarray:
    """Batched boundary transform on ``device``: (N, H, W) int masks ->
    (N, H, W) int32 boundary-only masks, identical to the JAX package's
    ``mask_to_boundary_device`` and to the host :func:`mask_to_boundary`.

    ``dilation = max(round(dilation_ratio * diag), 1)`` iterations of a
    3x3 erosion over the whole (N, C, H, W) one-hot stack (see
    :func:`_boundary`); a pixel keeps its class where that erosion
    removed it, the first such class, else becomes ``background``."""
    dev = resolve_device(device)
    masks = np.asarray(masks)
    h, w = masks.shape[1], masks.shape[2]
    dilation = max(int(round(dilation_ratio * np.sqrt(h ** 2 + w ** 2))),
                   1)
    # The JAX package buckets the shape (multiples of 128) to bound its
    # compiled programs; the pad value one-hots to all-zero, which is the
    # zero border the erosion assumes beyond the image, so the valid
    # region's result is unchanged.  Kept so the two stay identical.
    hb = -(-h // 128) * 128
    wb = -(-w // 128) * 128
    if (hb, wb) != (h, w):
        masks = np.pad(masks, ((0, 0), (0, hb - h), (0, wb - w)),
                       constant_values=num_classes)
    x = torch.from_numpy(np.ascontiguousarray(masks.astype(np.int32)))
    out = _boundary(x.to(dev), dilation, num_classes, background)
    return out[:, :h, :w].cpu().numpy()
