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

from typing import Sequence

import torch
import torch.nn.functional as F

from dcfp_tpu_torch.ops.kernels import _CI, _VP, c_entry, run_c_entry

DILATIONS = (12, 24, 36)  # output stride 8 (reference aspp.py:40-46)


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


def aspp_kernel_weights(weights: torch.Tensor) -> torch.Tensor:
    """K4's weights as its C entry reads them: (27, Cout, Cin),
    [output][input] per tap, contiguous."""
    return weights.transpose(1, 2).contiguous()


def aspp_fused_launch(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """One launch of K4 on a CUDA ``x`` with the weights of
    :func:`aspp_kernel_weights`."""
    h, w, cin = (int(s) for s in x.shape)
    cout = int(wt.shape[1])
    if not x.is_contiguous():
        raise ValueError("aspp_fused: x must be contiguous (H, W, Cin)")
    if (x.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16
            or wt.device != x.device or wt.dim() != 3
            or tuple(wt.shape) != (27, cout, cin) or not wt.is_contiguous()):
        raise ValueError("aspp_fused: x must be bf16 and the weights "
                         "contiguous bf16 (27, Cout, Cin) on x's device, as "
                         "aspp_kernel_weights makes them")
    if cin % 8 or cout % 2:
        raise ValueError(f"aspp_fused: the kernel needs Cin % 8 == 0 and "
                         f"Cout even; got Cin={cin}, Cout={cout}")
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("aspp_fused: x and the weights must start on a "
                         "16-byte boundary")
    out = torch.empty((h, w, 3 * cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = c_entry("aspp", "dcfp_aspp_fused",
                 [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, _CI, _VP])
    run_c_entry(fn, x.device, "aspp_fused", x.data_ptr(), wt.data_ptr(),
                out.data_ptr(), h, w, cin, cout, *DILATIONS)
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
