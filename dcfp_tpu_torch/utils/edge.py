"""Boundary utilities (port of ``dcfp_tpu/utils/edge.py``): the mask <->
one-hot helpers and the batched on-device boundary transform of
boundary-IoU eval (reference utils/edge_utils.py:90-127).

The host ``cv2`` erosion (``binary_to_boundary``, ``mask_to_boundary``)
and the distance-transform edge maps wait for the data slice: the port
does not take ``cv2``.
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
    ``mask_to_boundary_device`` and its host cv2 path.

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
