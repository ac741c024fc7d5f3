"""Bilinear resize as two small matmuls with explicit interpolation matrices.

Port of ``dcfp_tpu/ops/resize.py``.  Separable bilinear interpolation:
out = W_h @ x @ W_w^T per channel, in float32, cast back to the input
dtype.  It deliberately does not use ``F.interpolate``: the fused
resize-argmax tail (``dcfp_tpu_torch.ops.kernels``) is defined on these
exact matrices, so the unfused path must use them too.

Supports both align_corners conventions of torch:
  * align_corners=False — half-pixel centers, clamped
  * align_corners=True  — endpoints pinned, src = dst * (in-1)/(out-1)
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool,
                   dtype: str = "float32") -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear interpolation matrix."""
    if in_size == out_size:
        return np.eye(out_size, dtype=dtype)
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    elif align_corners:  # out_size == 1
        src = np.zeros((1,), dtype=np.float64)
    else:
        # half-pixel centers, clamped (torch align_corners=False semantics)
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat.astype(dtype)


def _interp_tensor(in_size: int, out_size: int, align_corners: bool,
                   device: torch.device) -> torch.Tensor:
    """:func:`_interp_matrix` as a float32 tensor on ``device`` (cached;
    callers must not write to it).  While ``torch.export`` or another
    fake-tensor trace runs, the matrix is made anew and not cached: the
    trace would otherwise leave a fake tensor in the cache for every
    later caller."""
    if torch._guards.detect_fake_mode() is not None:
        return _make_interp_tensor(in_size, out_size, align_corners, device)
    return _cached_interp_tensor(in_size, out_size, align_corners, device)


def _make_interp_tensor(in_size, out_size, align_corners, device):
    """Made outside inference mode, so a matrix first cached by the
    deploy path can still be saved by autograd in a train step."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            _interp_matrix(in_size, out_size, align_corners)).to(device)


_cached_interp_tensor = functools.lru_cache(maxsize=256)(_make_interp_tensor)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of channels-last (..., H, W, C) tensors.

    Returns (..., out_h, out_w, C) in x.dtype.
    """
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    dtype = x.dtype
    xf = x.to(torch.promote_types(dtype, torch.float32))
    if h != out_h:
        wh = _interp_tensor(h, out_h, align_corners, x.device).to(xf.dtype)
        xf = torch.einsum("oh,...hwc->...owc", wh, xf)
    if w != out_w:
        ww = _interp_tensor(w, out_w, align_corners, x.device).to(xf.dtype)
        xf = torch.einsum("ow,...hwc->...hoc", ww, xf)
    return xf.to(dtype)


def resize_bilinear_cf(x: torch.Tensor, out_hw, align_corners: bool = False
                       ) -> torch.Tensor:
    """Channels-first bilinear resize: x is (..., C, H, W).

    Same interpolation matrices and numerics as :func:`resize_bilinear`;
    the graph interpreter runs NCHW and uses this one.
    """
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    dtype = x.dtype
    xf = x.to(torch.promote_types(dtype, torch.float32))
    if h != out_h:
        wh = _interp_tensor(h, out_h, align_corners, x.device).to(xf.dtype)
        xf = torch.einsum("oh,...hw->...ow", wh, xf)
    if w != out_w:
        ww = _interp_tensor(w, out_w, align_corners, x.device).to(xf.dtype)
        xf = torch.einsum("ow,...hw->...ho", ww, xf)
    return xf.to(dtype)
