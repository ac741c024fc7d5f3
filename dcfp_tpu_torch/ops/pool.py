"""Pooling primitives, matching torch semantics used by the models.

Port of ``dcfp_tpu/ops/pool.py``.  These take NCHW tensors, the
interpreter's layout (the JAX package's take NHWC).

* max_pool: kernel/stride/symmetric padding with -inf fill
  (reference: networks/backbone/resnet.py:100 `MaxPool2d(3, 2, 1)`).
* adaptive_avg_pool: torch AdaptiveAvgPool2d bin edges as averaging
  matrices (reference: networks/tools/ppm.py:29, networks/tools/aspp.py:56).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int
             ) -> torch.Tensor:
    """NCHW max pooling; the implicit padding of ``F.max_pool2d`` is -inf."""
    return F.max_pool2d(x, kernel, stride, padding)


@functools.lru_cache(maxsize=128)
def _adaptive_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) averaging matrix with torch adaptive bin edges:
    bin i covers [floor(i*in/out), ceil((i+1)*in/out))."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -(-((i + 1) * in_size) // out_size)  # ceil
        mat[i, lo:hi] = 1.0 / (hi - lo)
    return mat


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NCHW adaptive average pool to (out_size, out_size), as two small
    float32 matmuls with the bin matrices of the JAX package."""
    h, w = x.shape[-2], x.shape[-1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mh = torch.from_numpy(_adaptive_matrix(h, out_size)).to(xf.device,
                                                             xf.dtype)
    mw = torch.from_numpy(_adaptive_matrix(w, out_size)).to(xf.device,
                                                             xf.dtype)
    xf = torch.einsum("oh,...hw->...ow", mh, xf)
    xf = torch.einsum("ow,...hw->...ho", mw, xf)
    return xf.to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW global average pool, keepdims -> (N, C, 1, 1)."""
    return torch.mean(x, dim=(-2, -1), keepdim=True)
