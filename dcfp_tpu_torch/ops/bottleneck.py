"""The fused residual bottleneck (K3; port of ``dcfp_tpu/ops/bottleneck.py``
``fused_bottleneck``, whose TPU kernel is ``_kernel`` driven by
``flat_bottleneck``; source ``dcfp_tpu_torch/csrc/bottleneck.cu``).

One kernel computes a whole BN-folded ResNet bottleneck with an identity
residual::

    t1 = relu(conv1x1(x, W1) + b1)            rounded to x's dtype
    t2 = relu(conv3x3_d(t1, W2) + b2)         rounded to x's dtype
    y  = relu(conv1x1(t2, W3) + b3 + x)       rounded once

every product accumulated in f32 and the weights rounded to x's dtype
first.  The 3x3 conv zero-pads t1 (not x): a tap outside the image
contributes 0, not relu(b1).  Neither intermediate is written to device
memory.

The JAX package's flat layout (``to_flat``, ``from_flat``, ``flat_wp``,
``row_tile``, ``flat_bottleneck``) is not ported: it exists for the TPU's
sublane tiling, and the CUDA kernel reads the activation in place through
its strides.  No serving graph calls this op, in either package; it is a
public op with its own tests and probe.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dcfp_tpu_torch.ops.kernels import _CI, _CL, _VP, c_entry, run_c_entry

# Limits of csrc/bottleneck.cu: a tile of R x S output pixels (R*S <= 64)
# needs t1 on its (R+2) x (S+2) grid (<= 128 pixels); the pixel tables
# take 1.5 KB of the 227 KB a block may use.
_MAX_OUT, _MAX_GRID = 64, 128
_SMEM_LIMIT = 232448 - 2048


def _check(x: torch.Tensor, w1, b1, w2, b2, w3, b3, dilation: int
           ) -> Tuple[int, int]:
    """Validate shapes and types; returns (cin, cm)."""
    if x.dim() != 4:
        raise ValueError(f"fused_bottleneck: expected (N, cin, H, W), got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_bottleneck: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    cin = int(x.shape[1])
    cm = int(w1.shape[0]) if w1.dim() == 4 else -1
    want = {"w1": (cm, cin, 1, 1), "w2": (cm, cm, 3, 3),
            "w3": (cin, cm, 1, 1)}
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        if tuple(w.shape) != want[name]:
            raise ValueError(f"fused_bottleneck: {name} shape "
                             f"{tuple(w.shape)}, want {want[name]} (OIHW)")
    for name, b, n in (("b1", b1, cm), ("b2", b2, cm), ("b3", b3, cin)):
        if b is not None and tuple(b.shape) != (n,):
            raise ValueError(f"fused_bottleneck: {name} shape "
                             f"{tuple(b.shape)}, want ({n},)")
    if int(dilation) < 1:
        raise ValueError(f"fused_bottleneck: dilation {dilation} < 1")
    return cin, cm


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last
            if x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


def fused_bottleneck_plain(x: torch.Tensor, w1, b1, w2, b2, w3, b3, *,
                           dilation: int = 2) -> torch.Tensor:
    """:func:`fused_bottleneck` in plain PyTorch: f32 einsums for the 1x1
    convs, an f32 ``F.conv2d`` for the dilated 3x3 on t1 rounded to x's
    dtype, and K3's roundings."""
    cin, cm = _check(x, w1, b1, w2, b2, w3, b3, dilation)
    dt, d = x.dtype, int(dilation)

    def bias(b, n):
        return (torch.zeros(n, dtype=torch.float32, device=x.device)
                if b is None else b.float())[:, None, None]

    xf = x.float()
    t1 = torch.einsum("nchw,oc->nohw", xf,
                      w1.to(dt).float().reshape(cm, cin))
    t1 = torch.relu(t1 + bias(b1, cm)).to(dt)
    t2 = F.conv2d(t1.float(), w2.to(dt).float(), dilation=d, padding=d)
    t2 = torch.relu(t2 + bias(b2, cm)).to(dt)
    y = torch.einsum("nchw,oc->nohw", t2.float(),
                     w3.to(dt).float().reshape(cin, cm))
    y = torch.relu(y + bias(b3, cin) + xf).to(dt)
    return y.contiguous(memory_format=_memory_format(x))


def fused_bottleneck(x: torch.Tensor, w1, b1, w2, b2, w3, b3, *,
                     dilation: int = 2) -> torch.Tensor:
    """y = relu(x + conv1x1(relu(conv3x3_d(relu(conv1x1(x))))) ) for a
    batch of images, BN already folded.

    x: (N, cin, H, W) f32/bf16, contiguous or channels_last; w1
    (cm, cin, 1, 1), w2 (cm, cm, 3, 3), w3 (cin, cm, 1, 1), OIHW; biases
    (n,) or None, read in f32.  Returns x's shape, dtype and memory
    format.  Any dilation >= 1."""
    _check(x, w1, b1, w2, b2, w3, b3, dilation)
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3,
                                      dilation=dilation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck: no kernel for device "
                         f"{x.device}")
    return fused_bottleneck_launch(
        x, bottleneck_weights(w1, b1, w2, b2, w3, b3, x.dtype, x.device),
        dilation=dilation)


def bottleneck_weights(w1, b1, w2, b2, w3, b3, dtype: torch.dtype,
                       device: torch.device) -> Tuple[torch.Tensor, ...]:
    """K3's weights as its C entry reads them, contiguous on ``device`` in
    ``dtype`` (x's), with the biases in f32 (zeros for None).  bf16 (the
    tensor-core path) takes them [output][input]: W1 (cm, cin),
    W2 (9, cm_out, cm_in), W3 (cin, cm); f32 takes them [input][output]:
    W1 (cin, cm), W2 (9, cm_in, cm_out), W3 (cm, cin)."""
    cm, cin = int(w1.shape[0]), int(w1.shape[1])
    w1k = w1.to(device, dtype).reshape(cm, cin)
    w3k = w3.to(device, dtype).reshape(cin, cm)
    w2k = w2.to(device, dtype)
    if dtype == torch.bfloat16:
        w2k = w2k.permute(2, 3, 0, 1)
    else:
        w1k, w3k, w2k = w1k.t(), w3k.t(), w2k.permute(2, 3, 1, 0)

    def bias(b, k):
        return (torch.zeros(k, dtype=torch.float32, device=device)
                if b is None else b.to(device, torch.float32).contiguous())

    return (w1k.contiguous(), bias(b1, cm),
            w2k.reshape(9, cm, cm).contiguous(), bias(b2, cm),
            w3k.contiguous(), bias(b3, cin))


def fused_bottleneck_launch(x: torch.Tensor, weights, *,
                            dilation: int) -> torch.Tensor:
    """One launch of K3 on a CUDA ``x`` (contiguous or channels_last)
    with the weights of :func:`bottleneck_weights`."""
    w1k, b1k, w2k, b2k, w3k, b3k = weights
    fmt = _memory_format(x)
    if not x.is_contiguous(memory_format=fmt):
        raise ValueError("fused_bottleneck: x must be contiguous, in the "
                         "default or the channels_last memory format")
    if x.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (x, w1k, w2k, w3k)):
        # the bf16 path reads x and the weights in 16-byte runs; a
        # misaligned one would fault and end the CUDA context
        raise ValueError("fused_bottleneck: bf16 x and weights must start "
                         "on a 16-byte boundary")
    n, cin, h, w = (int(s) for s in x.shape)
    cm, d = int(b1k.shape[0]), int(dilation)
    tile = _tile(h, w, d, cin, cm, x.element_size())
    if tile is None:
        raise ValueError(f"fused_bottleneck: cm={cm} does not fit the "
                         f"kernel's shared memory in {x.dtype}")
    out = torch.empty_like(x, memory_format=fmt)
    if out.numel() == 0:
        return out
    fn = c_entry("bottleneck", "dcfp_fused_bottleneck",
                 [_VP, _CI, _CI, _CI, _CI, _CI, _CL, _CL, _CL, _CL, _CI,
                  _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _VP])
    run_c_entry(fn, x.device, "fused_bottleneck", x.data_ptr(),
                int(x.dtype == torch.bfloat16), n, cin, h, w, *x.stride(),
                cm, d, w1k.data_ptr(), b1k.data_ptr(), w2k.data_ptr(),
                b2k.data_ptr(), w3k.data_ptr(), b3k.data_ptr(),
                out.data_ptr(), tile[0], tile[1])
    return out


def smem_bytes(r: int, s: int, cm: int, itemsize: int) -> int:
    """Dynamic shared memory of csrc/bottleneck.cu for an r x s tile:
    staging buffers, then t1 on the (r+2) x (s+2) grid and t2 on the
    tile.  bf16 (tensor cores): two 128 x 72 bf16 staging buffers, rows
    padded to 16 and of ``cm`` rounded up to 16, plus 8.  f32: 32 x 128
    and 32 x 129 floats, rows of ``cm`` rounded up to 32, plus 1."""
    grid, out = (r + 2) * (s + 2), r * s
    if itemsize == 2:
        ldt = _round(cm, 16) + 8
        return 2 * (2 * 128 * 72 + (_round(grid, 16) + _round(out, 16))
                    * ldt)
    ldt = _round(cm, 32) + 1
    return 4 * (32 * 128 + 32 * 129 + (grid + out) * ldt)


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=256)
def _tile(h: int, w: int, d: int, cin: int, cm: int, itemsize: int
          ) -> Optional[Tuple[int, int]]:
    """The (R, S) output tile of csrc/bottleneck.cu with the least work.

    A tile holds R x S output pixels spaced by the dilation d (rows
    y0, y0+d, ..., columns likewise), so its dilated 3x3 taps fall on an
    (R+2) x (S+2) grid of t1 that is computed once per tile.  The work
    counted is what the kernel does: it runs conv1 on the grid's pixels
    and the 3x3 and the last 1x1 on the tile's, each rounded up to whole
    mma tiles of 16 rows (bf16) or rows of 32 lanes (f32), on every tile,
    ragged ones included.  None if no tile fits in shared memory."""
    best, best_key = None, None
    for r in range(1, 17):
        for s in range(1, 17):
            if (r * s > _MAX_OUT or (r + 2) * (s + 2) > _MAX_GRID
                    or smem_bytes(r, s, cm, itemsize) > _SMEM_LIMIT):
                continue
            tiles = (d * math.ceil(math.ceil(h / d) / r)
                     * d * math.ceil(math.ceil(w / d) / s))
            step = 16 if itemsize == 2 else 32
            grid_rows = _round((r + 2) * (s + 2), step)
            out_rows = _round(r * s, step)
            work = tiles * (grid_rows * cin * cm
                            + out_rows * (9 * cm * cm + cm * cin))
            key = (work, -r * s)
            if best_key is None or key < best_key:
                best, best_key = (r, s), key
    return best
