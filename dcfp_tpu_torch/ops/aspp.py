"""The ASPP probe's kernel (the port's copy of what ``tools/exp_aspp.py``
defines).

K4 ``aspp_fused`` (port of ``_aspp_kernel`` / ``_aspp_kernel_kconcat``,
two TPU schedules of one function behind ``aspp_fused``; source
``dcfp_tpu_torch/csrc/aspp.cu``): the three dilated 3x3 branches of a
DeepLabV3 ASPP at output stride 8, with ReLU, concatenated on channels.
:func:`aspp_convs` is the same function as three cuDNN convolutions, the
probe's yardstick (its ``aspp_xla``).

The wrapper takes its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors, or raises; it never falls back.  Launches
are counted in ``dcfp_tpu_torch.ops.kernels.LAUNCHES``.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from dcfp_tpu_torch.ops.kernels import _CI, _VP, c_entry, run_c_entry

DILATIONS = (12, 24, 36)  # output stride 8 (reference aspp.py:40-46)

# csrc/aspp.cu: 128 output channels and 64 input channels (one 128-byte
# TMA box row) a stage; pixel rectangles of 128 or 256 (one or two 64-row
# m-tiles per consumer warpgroup), each side at most 256 (a TMA box's
# limit); a ring of 2-4 stages in the 227 KB a block may use
_NC, _KC = 128, 64
_PIXELS = (128, 256)
_SMEM_LIMIT = 232448
_SMS = 132  # the H100's SMs: one block each (384 threads, up to ~194 KB)


def aspp_weights(k2: torch.Tensor, k3: torch.Tensor,
                 k4: torch.Tensor) -> torch.Tensor:
    """The (27, Cin, Cout) stack that :func:`aspp_fused` takes, tap
    ``branch * 9 + ky * 3 + kx``, from the three branches' OIHW
    (Cout, Cin, 3, 3) conv kernels, e.g. the served graph's
    ``aspp.aspp{2,3,4}.atrous_conv``."""
    ks = (k2, k3, k4)
    for k in ks:
        if k.dim() != 4 or tuple(k.shape[2:]) != (3, 3) or \
                k.shape != k2.shape:
            raise ValueError(f"aspp_weights: need three (Cout, Cin, 3, 3) "
                             f"kernels, got {[tuple(t.shape) for t in ks]}")
    cout, cin = int(k2.shape[0]), int(k2.shape[1])
    return torch.cat([k.permute(2, 3, 1, 0).reshape(9, cin, cout)
                      for k in ks]).contiguous()


def _check(x: torch.Tensor, weights: torch.Tensor, dtypes) -> int:
    """Validate shapes and dtypes; returns Cout."""
    if x.dim() != 3:
        raise ValueError(f"aspp_fused: x must be (H, W, Cin), got shape "
                         f"{tuple(x.shape)}")
    if weights.dim() != 3 or tuple(weights.shape[:2]) != (27, x.shape[2]):
        raise ValueError(f"aspp_fused: weights must be (27, Cin={x.shape[2]}"
                         f", Cout), got {tuple(weights.shape)}")
    if x.dtype not in dtypes or weights.dtype != x.dtype:
        raise TypeError(f"aspp_fused: x and weights must both be one of "
                        f"{[str(d) for d in dtypes]}, got {x.dtype} and "
                        f"{weights.dtype}")
    if weights.device != x.device:
        raise ValueError(f"aspp_fused: weights on {weights.device}, x on "
                         f"{x.device}")
    return int(weights.shape[2])


def aspp_fused_plain(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """:func:`aspp_fused` in plain PyTorch: one f32 ``F.conv2d`` per
    branch on the f32 values (with TF32 off on the card), ReLU, concat,
    one rounding to x's dtype.  Takes f32 too, which gives the f32
    result before the rounding."""
    cout = _check(x, weights, (torch.bfloat16, torch.float32))
    cin = int(x.shape[2])
    xc = x.float().permute(2, 0, 1).unsqueeze(0)
    outs = []
    for b, d in enumerate(DILATIONS):
        k = weights[b * 9:(b + 1) * 9].float().reshape(3, 3, cin, cout)
        y = F.conv2d(xc, k.permute(3, 2, 0, 1), padding=d, dilation=d)
        outs.append(torch.relu(y))
    return torch.cat(outs, dim=1)[0].permute(1, 2, 0).to(x.dtype)


def _cinp(cin: int) -> int:
    """Cin rounded up to whole 64-channel TMA boxes."""
    return -(-cin // _KC) * _KC


def aspp_kernel_weights(weights: torch.Tensor) -> torch.Tensor:
    """K4's weights as its C entry reads them: (27, Cout, Cinp),
    [output][input] per tap, Cin zero-padded to Cinp, a multiple of 64
    (whole TMA boxes), contiguous."""
    taps, cin, cout = (int(s) for s in weights.shape)
    if cin == _cinp(cin):
        return weights.transpose(1, 2).contiguous()
    wt = torch.zeros((taps, cout, _cinp(cin)), dtype=weights.dtype,
                     device=weights.device)
    wt[:, :, :cin] = weights.transpose(1, 2)
    return wt


def live_taps(y0: int, x0: int, r: int, s: int, h: int, w: int,
              d: int) -> List[int]:
    """The taps (ky * 3 + kx) that csrc/aspp.cu runs for the block whose
    pixel rectangle starts at (y0, x0), r x s, at dilation d: those whose
    shifted rectangle of the block's outputs inside the image, rows
    y0 .. min(y0 + r, h) - 1 and columns x0 .. min(x0 + s, w) - 1, meets
    the image.  Any other tap reads only zero padding for those outputs
    and adds exactly zero."""
    y1, x1 = min(y0 + r, h) - 1, min(x0 + s, w) - 1
    out = []
    for tap in range(9):
        dy, dx = (tap // 3 - 1) * d, (tap % 3 - 1) * d
        if y0 + dy < h and y1 + dy >= 0 and x0 + dx < w and x1 + dx >= 0:
            out.append(tap)
    return out


def aspp_smem_bytes(r: int, s: int, stages: int) -> int:
    """Dynamic shared memory of csrc/aspp.cu: 1024 bytes of alignment
    slack, ``stages`` A boxes (r * s rows of 128 bytes) and B boxes
    (128 x 128 bytes), and the ring's barriers."""
    return 1024 + stages * (r * s * 128 + _NC * 128) + 16 * stages


@functools.lru_cache(maxsize=64)
def aspp_tile(h: int, w: int, cin: int, cout: int
              ) -> Tuple[int, int, int]:
    """(R, S, stages): the pixel rectangle of csrc/aspp.cu's blocks and
    the depth of its ring at this shape.

    The time model: a block runs one stage per live tap and 64 input
    channels, and a stage costs the larger of its tensor-core work
    (R*S x 128 x 64 multiply-adds) and its L2 bytes (the A and B boxes) at
    90 multiply-adds a byte (an SM's share of the bf16 tensor-core rate
    over its share of ~5.5 TB/s of L2), plus one stage a block for its
    fill and epilogue; the blocks share the SMs, so the time is the larger
    of the total over 132 and the longest block.  Edge waste (pixels
    outside the image still cost) and dead taps (skipped) both enter
    through that count.  Ties go to fewer modelled multiply-adds, then
    to the larger rectangle."""
    nk, nco = -(-cin // _KC), -(-cout // _NC)
    best, best_key = None, None
    for npix in _PIXELS:
        r = 1
        while r <= min(npix, 256):
            s = npix // r
            if s <= 256:
                stage = max(npix * _NC * _KC, 90 * (npix * 128 + _NC * 128))
                total, longest, work = 0, 0, 0
                for y0 in range(0, h, r):
                    for x0 in range(0, w, s):
                        for d in DILATIONS:
                            n = len(live_taps(y0, x0, r, s, h, w, d))
                            cost = (nk * n + 1) * stage
                            total += cost * nco
                            longest = max(longest, cost)
                            work += nk * n * npix * _NC * _KC * nco
                key = (max(total / _SMS, longest), work, -npix)
                if best_key is None or key < best_key:
                    best, best_key = (r, s), key
            r *= 2
    stages = max(n for n in (2, 3, 4)
                 if aspp_smem_bytes(*best, n) <= _SMEM_LIMIT)
    return best + (stages,)


def aspp_fused_launch(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """One launch of K4 on a CUDA ``x`` with the weights of
    :func:`aspp_kernel_weights`, on the tile of :func:`aspp_tile`."""
    h, w, cin = (int(s) for s in x.shape)
    cout = int(wt.shape[1])
    if not x.is_contiguous():
        raise ValueError("aspp_fused: x must be contiguous (H, W, Cin)")
    if cin % 8 or cout % 2:
        raise ValueError(f"aspp_fused: the kernel needs Cin % 8 == 0 and "
                         f"Cout even; got Cin={cin}, Cout={cout}")
    if (x.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16
            or wt.device != x.device or wt.dim() != 3
            or tuple(wt.shape) != (27, cout, _cinp(cin))
            or not wt.is_contiguous()):
        raise ValueError("aspp_fused: x must be bf16 and the weights "
                         "contiguous bf16 (27, Cout, Cin padded to 64) on "
                         "x's device, as aspp_kernel_weights makes them")
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("aspp_fused: x and the weights must start on a "
                         "16-byte boundary")
    out = torch.empty((h, w, 3 * cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = c_entry("aspp", "dcfp_aspp_fused",
                 [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, _CI, _CI,
                  _CI, _CI, _VP])
    run_c_entry(fn, x.device, "aspp_fused", x.data_ptr(), wt.data_ptr(),
                out.data_ptr(), h, w, cin, cout, *DILATIONS,
                *aspp_tile(h, w, cin, cout))
    return out


def aspp_fused(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The three dilated 3x3 ASPP branches (d = 12, 24, 36), each with
    SAME zero padding, f32 sums, ReLU and one bf16 rounding, concatenated
    on channels: x (H, W, Cin) bf16 and weights (27, Cin, Cout) bf16
    (:func:`aspp_weights`) -> (H, W, 3 * Cout) bf16, branch b in channels
    [b * Cout, (b + 1) * Cout).  No bias.

    Every channel is used for any Cin (the TPU kernel drops the last
    Cin % 128).  On CUDA x is read in place (a tap outside the image
    reads zeros; the TPU wrapper pads a copy of x), so x must be
    contiguous; the kernel needs Cin % 8 == 0, Cout even and 16-byte
    aligned x and weights, and raises ValueError otherwise before a
    launch.  ``x[0].permute(1, 2, 0)`` of a channels_last (1, C, H, W)
    tensor is such an x, without a copy."""
    _check(x, weights, (torch.bfloat16,))
    if x.device.type == "cpu":
        return aspp_fused_plain(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"aspp_fused: no kernel for device {x.device}")
    return aspp_fused_launch(x, aspp_kernel_weights(weights))


def aspp_convs(x: torch.Tensor, kernels: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """The probe's ``aspp_xla``: three separate dilated ``F.conv2d``
    calls in x's dtype (cuDNN on the card), ReLU, concatenated.  x
    (H, W, Cin); kernels three OIHW (Cout, Cin, 3, 3).  Returns
    (H, W, 3 * Cout).  The library yardstick of K4."""
    xc = x.permute(2, 0, 1).unsqueeze(0)  # channels_last when x is contiguous
    outs = [torch.relu(F.conv2d(xc, k, padding=d, dilation=d))
            for d, k in zip(DILATIONS, kernels)]
    return torch.cat(outs, dim=1)[0].permute(1, 2, 0)
