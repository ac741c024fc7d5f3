"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

K1 ``resize_argmax``: fused bilinear upsample + channel argmax, the
deploy tail (port of ``dcfp_tpu/ops/pallas_kernels.py`` ``_kernel`` /
``_resize_argmax_cm``; source ``dcfp_tpu_torch/csrc/resize_argmax.cu``)::

    out[n, y, x] = argmax_c  sum_ij  Wh[y, i] * Ww[x, j] * z[n, c, i, j]

The upsampled logits are never written to device memory; only the uint8
label map is.

Each wrapper takes its plain PyTorch version for a tensor on the CPU
(the tests run there) and launches the kernel for a CUDA tensor, or
raises; it never falls back.  ``LAUNCHES`` counts kernel launches, one
per launch, so a run can show which path it went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from dcfp_tpu_torch.ops.resize import _interp_matrix, resize_bilinear

LAUNCHES = {"resize_argmax": 0}

MAX_CLASSES = 256  # labels are uint8


def resize_argmax_plain(logits: torch.Tensor, out_hw,
                        align_corners: bool = False) -> torch.Tensor:
    """``argmax(resize_bilinear(logits), -1)`` on the dense f32 matrices —
    the JAX package's definition.  logits (N, h, w, C) -> (N, H, W) uint8.
    First maximal channel wins on ties, as ``torch.argmax`` documents."""
    up = resize_bilinear(logits, out_hw, align_corners)
    return torch.argmax(up, dim=-1).to(torch.uint8)


def _check(z: torch.Tensor, c: int) -> None:
    if z.dim() != 4:
        raise ValueError(f"resize_argmax: expected a rank-4 tensor, got "
                         f"shape {tuple(z.shape)}")
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resize_argmax: logits must be float32 or bfloat16,"
                        f" got {z.dtype}")
    if c > MAX_CLASSES:
        raise ValueError(f"resize_argmax: {c} classes do not fit uint8 "
                         f"labels (max {MAX_CLASSES})")


def resize_argmax(logits: torch.Tensor, out_hw,
                  align_corners: bool = False) -> torch.Tensor:
    """argmax_c(bilinear_resize(logits, out_hw)) without materializing the
    upsampled logits.  logits: (N, h, w, C) f32/bf16 -> (N, H, W) uint8.

    On CUDA it runs the kernel through :func:`resize_argmax_cm` on the
    channel-major view of ``logits``, which is channels_last in memory, so
    nothing is copied."""
    _check(logits, logits.shape[-1])
    if logits.device.type == "cpu":
        return resize_argmax_plain(logits, out_hw, align_corners)
    return resize_argmax_cm(logits.permute(0, 3, 1, 2), out_hw,
                            align_corners)


def resize_argmax_cm(logits_cm: torch.Tensor, out_hw,
                     align_corners: bool = False) -> torch.Tensor:
    """Channel-major variant: logits_cm (N, C, h, w) -> (N, H, W) uint8,
    with the numerics of :func:`resize_argmax`.  On CUDA the tensor must
    be contiguous, in the default or the channels_last memory format; the
    kernel reads either in place."""
    _check(logits_cm, logits_cm.shape[1])
    if logits_cm.device.type == "cpu":
        return resize_argmax_plain(logits_cm.permute(0, 2, 3, 1), out_hw,
                                   align_corners)
    if logits_cm.device.type != "cuda":
        raise ValueError(f"resize_argmax: no kernel for device "
                         f"{logits_cm.device}")
    if not (logits_cm.is_contiguous() or logits_cm.is_contiguous(
            memory_format=torch.channels_last)):
        raise ValueError("resize_argmax_cm: logits must be contiguous "
                         "(N, C, h, w), or channels_last")
    return _launch(logits_cm, (int(out_hw[0]), int(out_hw[1])),
                   bool(align_corners))


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int, align_corners: bool,
          device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-row tap table of ``_interp_matrix``: (out, 2) int32
    source indices and (out, 2) f32 weights, read from the matrix so the
    weights are bit-identical.  A row with one non-zero (identity or
    clamped) repeats its index with weight 0."""
    mat = _interp_matrix(in_size, out_size, align_corners)
    idx = np.zeros((out_size, 2), np.int32)
    wts = np.zeros((out_size, 2), np.float32)
    for r in range(out_size):
        nz = np.flatnonzero(mat[r])
        if not 1 <= nz.size <= 2:
            raise AssertionError(f"interp row {r} has {nz.size} taps")
        idx[r] = (nz[0], nz[-1])
        wts[r, :nz.size] = mat[r, nz]
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wts).to(device))


def build():
    """Build (nvcc, at first use) and load K1; returns the
    ``cuda_build.Built`` record (library, nvcc seconds and log)."""
    from dcfp_tpu_torch.ops.cuda_build import load
    return load("resize_argmax")


def _library():
    fn = build().lib.dcfp_resize_argmax_cm
    if fn.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would pass a
        # bare Python int as a 32-bit C int and cut the address
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, ci, ci, ci, cl, cl, cl, cl, ci, ci, vp, vp, vp,
                       vp, vp, vp]
        fn.restype = ci
    return fn


def _launch(z: torch.Tensor, out_hw: Tuple[int, int],
            align_corners: bool) -> torch.Tensor:
    n, c, h, w = z.shape
    out_h, out_w = out_hw
    out = torch.empty((n, out_h, out_w), dtype=torch.uint8, device=z.device)
    if out.numel() == 0:
        return out
    ytap, ywt = _taps(h, out_h, align_corners, z.device)
    xtap, xwt = _taps(w, out_w, align_corners, z.device)
    fn = _library()
    # the launch goes to the current device, so make it z's for the call
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(z.data_ptr(), int(z.dtype == torch.bfloat16), n, c,
                 *z.stride(), out_h, out_w, ytap.data_ptr(), ywt.data_ptr(),
                 xtap.data_ptr(), xwt.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"resize_argmax kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["resize_argmax"] += 1
    return out
