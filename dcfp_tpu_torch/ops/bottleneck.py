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

# Limits of csrc/bottleneck.cu.  f32 (FMAs): a tile of R x S output
# pixels (R*S <= 64) needs t1 on its (R+2) x (S+2) grid (<= 128 pixels),
# and the pixel tables take 1.5 KB of the 227 KB a block may use.  bf16
# (wgmma): R*S <= 128 and a grid of <= 192 pixels, everything in dynamic
# shared memory (``smem_bytes``).
_MAX_OUT, _MAX_GRID = 64, 128
_MAX_OUT_BF16, _MAX_GRID_BF16 = 128, 192
_SMEM_LIMIT = 232448 - 2048
_SMS = 132  # the H100's SMs: one bf16 block each (384 threads, ~227 KB)
_SLOT = 128 * 64 * 2  # one weight slot of the bf16 ring: 128 rows x 64


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
    wgmma path) takes them [output][input] and zero-padded, cin and cm
    rounded up to cinp and cmp, multiples of 64: W1 (cmp, cinp),
    W2 (9, cmp_out, cmp_in), W3 (cinp, cmp); f32 takes them
    [input][output]: W1 (cin, cm), W2 (9, cm_in, cm_out), W3 (cm, cin)."""
    cm, cin = int(w1.shape[0]), int(w1.shape[1])
    w1k = w1.to(device, dtype).reshape(cm, cin)
    w3k = w3.to(device, dtype).reshape(cin, cm)
    w2k = w2.to(device, dtype)

    def bias(b, k):
        return (torch.zeros(k, dtype=torch.float32, device=device)
                if b is None else b.to(device, torch.float32).contiguous())

    biases = bias(b1, cm), bias(b2, cm), bias(b3, cin)
    if dtype != torch.bfloat16:
        return (w1k.t().contiguous(), biases[0],
                w2k.permute(2, 3, 1, 0).reshape(9, cm, cm).contiguous(),
                biases[1], w3k.t().contiguous(), biases[2])
    # bf16: [output][input], zero-padded to whole 64-wide TMA boxes (the
    # padding multiplies zeros only)
    cmp, cinp = _round(cm, 64), _round(cin, 64)
    p1 = torch.zeros((cmp, cinp), dtype=dtype, device=device)
    p1[:cm, :cin] = w1k
    p2 = torch.zeros((9, cmp, cmp), dtype=dtype, device=device)
    p2[:, :cm, :cm] = w2k.permute(2, 3, 0, 1).reshape(9, cm, cm)
    p3 = torch.zeros((cinp, cmp), dtype=dtype, device=device)
    p3[:cin, :cm] = w3k
    return p1, biases[0], p2, biases[1], p3, biases[2]


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
    if x.dtype == torch.bfloat16:
        want = ((_round(cm, 64), _round(cin, 64)),
                (9, _round(cm, 64), _round(cm, 64)),
                (_round(cin, 64), _round(cm, 64)))
        if any(tuple(t.shape) != sh or not t.is_contiguous()
               for t, sh in zip((w1k, w2k, w3k), want)):
            raise ValueError("fused_bottleneck: bf16 weights must be "
                             "contiguous and padded as bottleneck_weights "
                             "makes them")
    tile = _tile(h, w, d, cin, cm, x.element_size())
    if tile is None:
        raise ValueError(f"fused_bottleneck: cm={cm} does not fit the "
                         f"kernel's shared memory in {x.dtype}")
    out = torch.empty_like(x, memory_format=fmt)
    if out.numel() == 0:
        return out
    fn = c_entry("bottleneck", "dcfp_fused_bottleneck",
                 [_VP, _CI, _CI, _CI, _CI, _CI, _CL, _CL, _CL, _CL, _CI,
                  _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI,
                  _VP])
    run_c_entry(fn, x.device, "fused_bottleneck", x.data_ptr(),
                int(x.dtype == torch.bfloat16), n, cin, h, w, *x.stride(),
                cm, d, w1k.data_ptr(), b1k.data_ptr(), w2k.data_ptr(),
                b2k.data_ptr(), w3k.data_ptr(), b3k.data_ptr(),
                out.data_ptr(), *tile)
    return out


def smem_bytes(r: int, s: int, cm: int, itemsize: int,
               stages: int = 2) -> int:
    """Dynamic shared memory of csrc/bottleneck.cu for an r x s tile.

    bf16 (wgmma; ``mma_geom`` in the source): 1024 bytes of alignment
    slack, ``stages`` 16 KB weight slots, t1 on the grid (Qp rows of
    cmp + 8 bf16; Qp and Pp are the grid's and the tile's pixels rounded
    up to 64, cmp is cm rounded up to 64), whose room conv3's epilogue
    reuses (Pp x 256 bytes, if more), then t2 on the tile (Pp rows
    of cmp bf16, in 64-channel blocks) or, while conv1 runs, the x ring
    (``stages`` x Qp rows of 128 bytes), whichever is larger, then the
    barriers and the pixel tables.
    f32: 32 x 128 and 32 x 129 floats of staging, then t1 on the grid and
    t2 on the tile, rows of cm rounded up to 32, plus 1."""
    grid, out = (r + 2) * (s + 2), r * s
    if itemsize == 2:
        qp, pp, cmp = _round(grid, 64), _round(out, 64), _round(cm, 64)
        return (1024 + stages * _SLOT + max(qp * (cmp + 8) * 2, pp * 256)
                + max(pp * cmp * 2, stages * qp * 128)
                + 16 * stages + 8 * (qp + pp))
    ldt = _round(cm, 32) + 1
    return 4 * (32 * 128 + 32 * 129 + (grid + out) * ldt)


def _ceil(n: int, m: int) -> int:
    return -(-n // m)


def _round(n: int, m: int) -> int:
    return _ceil(n, m) * m


def tiles_per_axis(size: int, d: int, t: int) -> int:
    """Tiles of ``t`` outputs spaced by ``d`` that cover an axis of
    ``size`` pixels: each of the d residue classes, holding
    ceil((size - res) / d) pixels, takes whole tiles of its own."""
    return sum(_ceil(_ceil(size - res, d), t) for res in range(min(d, size)))


def _bf16_tile_cost(h, w, d, cin, cm, r, s):
    """The bf16 kernel's time model for an r x s tile, in multiply-adds.

    Each stage of the ring costs the larger of its tensor-core work and
    its bytes from L2 (90 multiply-adds a byte: an SM's share of the
    tensor-core rate over its share of ~5.5 TB/s of L2), on whole 64-row
    m-tiles and 128-channel passes; every block runs its tile's stages in
    turn, one block an SM, so the time is the waves of blocks times one
    block's cost.  Returns (time, total work)."""
    qp, pp = _round((r + 2) * (s + 2), 64), _round(r * s, 64)
    cmp, cinp = _round(cm, 64), _round(cin, 64)
    p1, p3 = _ceil(cmp, 128), _ceil(cinp, 128)

    def stages(n, macs, nbytes):
        return n * max(macs, 90 * nbytes)

    block = (stages(p1 * cinp // 64, qp * 128 * 64, _SLOT + qp * 128)
             + stages(p1 * 9 * cmp // 64, pp * 128 * 64, _SLOT)
             + stages(p3 * cmp // 64, pp * 128 * 64, _SLOT))
    tiles = tiles_per_axis(h, d, r) * tiles_per_axis(w, d, s)
    return _ceil(tiles, _SMS) * block, tiles * block


@functools.lru_cache(maxsize=256)
def _tile(h: int, w: int, d: int, cin: int, cm: int, itemsize: int
          ) -> Optional[Tuple[int, int, int]]:
    """(R, S, stages): the output tile of csrc/bottleneck.cu and, for
    bf16, the slots of its ring (0 for f32); None if no tile fits.

    A tile holds R x S output pixels spaced by the dilation d (rows
    y0, y0+d, ..., columns likewise), so its dilated 3x3 taps fall on an
    (R+2) x (S+2) grid of t1 that is computed once per tile.  bf16 takes
    the tile with the least modelled time (``_bf16_tile_cost``), then the
    least work, then the most outputs, and as many ring slots (up to 4)
    as shared memory holds.  f32 takes the least work as the kernel does
    it: conv1 on the grid's pixels and the 3x3 and the last 1x1 on the
    tile's, each rounded up to rows of 32 lanes, on every tile."""
    best, best_key = None, None
    bf16 = itemsize == 2
    max_out, max_grid = ((_MAX_OUT_BF16, _MAX_GRID_BF16) if bf16
                         else (_MAX_OUT, _MAX_GRID))
    side = max_out if bf16 else 16
    for r in range(1, side + 1):
        for s in range(1, min(side, max_out // r) + 1):
            if ((r + 2) * (s + 2) > max_grid
                    or smem_bytes(r, s, cm, itemsize) > _SMEM_LIMIT):
                continue
            if bf16:
                t, work = _bf16_tile_cost(h, w, d, cin, cm, r, s)
                key = (t, work, -r * s)
            else:
                tiles = (d * math.ceil(math.ceil(h / d) / r)
                         * d * math.ceil(math.ceil(w / d) / s))
                work = tiles * (_round((r + 2) * (s + 2), 32) * cin * cm
                                + _round(r * s, 32) * (9 * cm * cm + cm * cin))
                key = (work, -r * s)
            if best_key is None or key < best_key:
                best, best_key = (r, s), key
    if best is None:
        return None
    if not bf16:
        return best + (0,)
    stages = max(n for n in (2, 3, 4)
                 if smem_bytes(*best, cm, itemsize, n) <= _SMEM_LIMIT)
    return best + (stages,)
