"""The int8 probe's kernels (the port's copy of what ``tools/exp_int8.py``
defines).

K5 ``tiled_mm`` (port of ``_mm_kernel`` / ``pallas_mm``; source
``dcfp_tpu_torch/csrc/int8_mm.cu``): ``a @ b``, int8 x int8 -> int32 or
bf16 x bf16 -> f32.  The probe's stage A.

K6 ``chain_int8`` (port of ``_chain_kernel`` / ``chain_int8``; source
``dcfp_tpu_torch/csrc/int8_chain.cu``): one int8 ResNet bottleneck
chain without its residual, conv1x1 -> requant -> 3x3 (dilation D) ->
requant -> conv1x1 -> dequant to bf16, with the int32 sums kept on the
chip.  The probe's stage B chains it block after block
(:func:`chain_int8_blocks`) beside the bf16 chain :func:`chain_bf16`.

Each wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors, or raises; it never falls back.
Launches are counted in ``dcfp_tpu_torch.ops.kernels.LAUNCHES``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch.ops.bottleneck import tiles_per_axis
from dcfp_tpu_torch.ops.kernels import _CF, _CI, _VP, c_entry, run_c_entry

D = 2  # the chain's dilation (layer3 at output stride 8)

# shared memory a block may use on the card (227 KB)
_SMEM_LIMIT = 232448

Scales = Sequence[float]  # three values, or a (1, 3) array as JAX takes


# ---------------------------------------------------------------------------
# K5: tiled matmul
# ---------------------------------------------------------------------------

def _mm_check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_mm: need (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in (torch.int8, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"tiled_mm: a and b must both be int8 or both "
                        f"bfloat16, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"tiled_mm: a on {a.device}, b on {b.device}")


def tiled_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`tiled_mm` in plain PyTorch.  int8 runs in float64 and is
    exact: every product and partial sum is an integer of magnitude at
    most K * 128**2 < 2**53 for any K below 5e11, so float64 holds it
    exactly (PyTorch has no integer matmul on CUDA).  bf16 runs as an f32
    matmul of the f32 values (with TF32 off on the card)."""
    _mm_check(a, b)
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def tiled_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a (M, K) and b (K, N): int8 -> int32 (exact, int32
    sums) or bf16 -> f32 (f32 sums).  Any other dtype raises TypeError.
    Every row is computed for any M (the TPU kernel writes only
    M // 512 row tiles).

    On CUDA the kernel needs contiguous a and b, K a multiple of 16
    (int8) or 8 (bf16), N a multiple of 4 (int8) or 2 (bf16), a on a
    16-byte and b on a 4-byte boundary; anything else raises ValueError
    before a launch."""
    _mm_check(a, b)
    if a.device.type == "cpu":
        return tiled_mm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_mm: no kernel for device {a.device}")
    return tiled_mm_launch(a, b)


# csrc/int8_mm.cu's block tile: 128 rows x 64 columns of out
MM_TILE = (128, 64)


def mm_launch_plan(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The checks of :func:`tiled_mm_launch`, raising ValueError on what
    the kernel cannot take, and how csrc/int8_mm.cu runs ``a @ b``: its
    grid of 128 x 64 output tiles, and whether b is first transposed to
    bt (N, K).  s8 wgmma takes B only K-major, so int8 b always is; bf16
    b is read in place (MN-major) when TMA can read it, i.e. its rows are
    a multiple of 16 bytes (N % 8 == 0) and it starts on a 16-byte
    boundary."""
    _mm_check(a, b)
    m, k = (int(s) for s in a.shape)
    n = int(b.shape[1])
    es = a.element_size()
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tiled_mm: a and b must be contiguous")
    if (k * es) % 16:
        raise ValueError(f"tiled_mm: K={k}, the kernel needs a multiple of "
                         f"{16 // es}")
    if n % (4 // es):
        raise ValueError(f"tiled_mm: N={n}, the kernel needs a multiple of "
                         f"{4 // es}")
    if a.data_ptr() % 16 or b.data_ptr() % 4:
        raise ValueError("tiled_mm: a must start on a 16-byte and b on a "
                         "4-byte boundary")
    bm, bn = MM_TILE
    return {"grid": (-(-n // bn), -(-m // bm)),
            "transpose_b": (a.dtype == torch.int8 or n % 8 != 0
                            or b.data_ptr() % 16 != 0)}


def tiled_mm_launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of K5 on CUDA ``a`` and ``b``, after the kernel's
    alignment checks.  int8 b, and bf16 b that TMA cannot read, go through
    a scratch bt (N, K) that the C entry fills before the product."""
    plan = mm_launch_plan(a, b)
    m, k = (int(s) for s in a.shape)
    n = int(b.shape[1])
    out_dtype = torch.int32 if a.dtype == torch.int8 else torch.float32
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    bt = (torch.empty((n, k), dtype=a.dtype, device=a.device)
          if plan["transpose_b"] else None)
    fn = c_entry("int8_mm", "dcfp_tiled_mm",
                 [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP])
    run_c_entry(fn, a.device, "tiled_mm", a.data_ptr(), b.data_ptr(),
                None if bt is None else bt.data_ptr(), out.data_ptr(),
                int(a.dtype == torch.bfloat16), m, n, k)
    return out


# ---------------------------------------------------------------------------
# K6: fused int8 bottleneck chain
# ---------------------------------------------------------------------------

def _f32_scales(scales: Scales) -> Tuple[float, float, float]:
    """The three scales as the f32 values the kernels use (the JAX
    wrapper's (1, 3) f32 array), returned as Python floats."""
    s = np.asarray(scales, np.float32).reshape(-1)
    if s.size != 3:
        raise ValueError(f"chain_int8: need 3 scales, got {s.size}")
    return tuple(float(v) for v in s)


def requant(acc: torch.Tensor, scale, relu: bool = True) -> torch.Tensor:
    """``int8(clip(round(float32(acc) * scale), lo, 127))`` with lo = 0
    (ReLU) or -127: one f32 conversion, one f32 multiply by the f32
    ``scale``, round half to even.  ``acc`` holds integers (int32, or
    float64 from the exact plain matmuls)."""
    s = torch.tensor(np.float32(scale), dtype=torch.float32,
                     device=acc.device)
    y = torch.round(acc.float() * s)
    return torch.clamp(y, 0.0 if relu else -127.0, 127.0).to(torch.int8)


def _chain_check(x8, w1, w2, w3) -> Tuple[int, int, int]:
    """Validate shapes and dtypes; returns (cin, cm, cout)."""
    if x8.dim() != 3:
        raise ValueError(f"chain_int8: x must be (H0 + 2D, W, Cin), got "
                         f"shape {tuple(x8.shape)}")
    for name, t in (("x", x8), ("w1", w1), ("w2", w2), ("w3", w3)):
        if t.dtype != torch.int8:
            raise TypeError(f"chain_int8: {name} must be int8, got {t.dtype}")
        if t.device != x8.device:
            raise ValueError(f"chain_int8: {name} on {t.device}, x on "
                             f"{x8.device}")
    if x8.shape[0] <= 2 * D:
        raise ValueError(f"chain_int8: {x8.shape[0]} rows hold no output "
                         f"row besides the {D} halo rows on each side")
    cin = int(x8.shape[2])
    cm = int(w1.shape[1]) if w1.dim() == 2 else -1
    cout = int(w3.shape[1]) if w3.dim() == 2 else -1
    want = {"w1": (cin, cm), "w2": (9, cm, cm), "w3": (cm, cout)}
    for name, t in (("w1", w1), ("w2", w2), ("w3", w3)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"chain_int8: {name} shape {tuple(t.shape)}, "
                             f"want {want[name]}")
    return cin, cm, cout


def chain_int8_plain(x8: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     w3: torch.Tensor, scales: Scales) -> torch.Tensor:
    """:func:`chain_int8` in plain PyTorch: the probe's ``_chain_numpy``
    with the kernel's roundings.  The products run in float64, which is
    exact for integers below 2**53; each requant converts its integer sum
    to f32 and multiplies by the f32 scale; the output is the f32 product
    ``float32(a3) * s3`` rounded once to bf16."""
    cin, cm, cout = _chain_check(x8, w1, w2, w3)
    s1, s2, s3 = _f32_scales(scales)
    hp, w, _ = x8.shape
    h0 = hp - 2 * D
    a1 = x8.double().reshape(-1, cin) @ w1.double()
    y1 = requant(a1, s1).reshape(hp, w, cm)
    y1p = torch.zeros((hp, w + 2 * D, cm), dtype=torch.float64,
                      device=x8.device)
    y1p[:, D:D + w] = y1.double()  # columns zero-padded after the requant
    acc = torch.zeros((h0 * w, cm), dtype=torch.float64, device=x8.device)
    for i, dh in enumerate((0, D, 2 * D)):
        for j, dw in enumerate((0, D, 2 * D)):
            acc += y1p[dh:dh + h0, dw:dw + w].reshape(-1, cm) @ \
                w2[i * 3 + j].double()
    y2 = requant(acc, s2)
    a3 = y2.double() @ w3.double()
    s3t = torch.tensor(np.float32(s3), device=x8.device)
    return (a3.float() * s3t).to(torch.bfloat16).reshape(h0, w, cout)


def _r128(n: int) -> int:
    """n rounded up to whole 128-byte TMA box rows of int8."""
    return -(-n // 128) * 128


class ChainWeights(NamedTuple):
    """K6's weights as its C entry reads them (:func:`chain_int8_weights`)
    with the widths the padding hides."""
    w1: torch.Tensor  # (Cmp, Cinp)
    w2: torch.Tensor  # (9, Cmp_out, Cmp_in)
    w3: torch.Tensor  # (Coutp, Cmp)
    cm: int
    cout: int


def chain_int8_weights(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor
                       ) -> ChainWeights:
    """K6's weights as its C entry reads them: [output][input] (K-major,
    the only B that s8 wgmma takes), zero-padded to whole 128-byte TMA
    boxes, contiguous: W1 (Cmp, Cinp), W2 (9, Cmp_out, Cmp_in),
    W3 (Coutp, Cmp), with Cin, Cm and Cout rounded up to multiples of
    128.  The padding multiplies zeros only: y1 and y2 are 0 past Cm."""
    cm, cout = int(w1.shape[1]), int(w3.shape[1])
    return ChainWeights(_padded(w1.t()), _padded(w2.transpose(1, 2)),
                        _padded(w3.t()), cm, cout)


def _padded(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, its last two dims zero-padded to multiples of
    128 (a copy either way)."""
    shape = (*t.shape[:-2], _r128(t.shape[-2]), _r128(t.shape[-1]))
    if tuple(t.shape) == shape:
        return t.contiguous()
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out[..., :t.shape[-2], :t.shape[-1]] = t
    return out


# csrc/int8_chain.cu's limits: an R x S tile of outputs (R*S <= 128) on its
# (R+2) x (S+2) grid of y1 pixels (<= 192); 128 channels a pass and 128
# bytes of K (one 16 KB weight slot) a stage
_MAX_OUT, _MAX_GRID = 128, 192
_SLOT = 128 * 128
_SMS = 132  # the H100's SMs: one block each (384 threads, ~227 KB)


def chain_smem_bytes(r: int, s: int, cm: int, stages: int = 2) -> int:
    """Dynamic shared memory of csrc/int8_chain.cu (``geom`` there) for an
    r x s tile: 1024 bytes of alignment slack, ``stages`` 16 KB weight
    slots, y1 on the grid (Qp rows of Cmp + 16 bytes; Qp and Pp are the
    grid's and the tile's pixels rounded up to 64, Cmp is Cm rounded up
    to 128), whose room conv3's output buffers reuse (Pp x 256 bytes, if
    more), then y2 on the tile (Pp rows of Cmp bytes) or, while conv1
    runs, the x ring (``stages`` x Qp rows of 128 bytes), whichever is
    larger, then the barriers and the pixel tables."""
    qp = -(-(r + 2) * (s + 2) // 64) * 64
    pp = -(-r * s // 64) * 64
    cmp = _r128(cm)
    return (1024 + stages * _SLOT + max(qp * (cmp + 16), pp * 256)
            + max(pp * cmp, stages * qp * 128) + 16 * stages
            + 8 * (qp + pp))


def _chain_tile_cost(h0, w, cin, cm, cout, r, s):
    """K6's time model for an r x s tile, in multiply-adds: each stage of
    the ring costs the larger of its tensor-core work and its bytes from
    L2 at 180 multiply-adds a byte (an SM's share of the int8 tensor-core
    rate over its share of ~5.5 TB/s of L2), on whole 64-row m-tiles and
    128-channel passes; one block an SM, so the time is the waves of
    blocks times one block's cost.  Returns (time, total work)."""
    qp = -(-(r + 2) * (s + 2) // 64) * 64
    pp = -(-r * s // 64) * 64
    cmp, cinp, coutp = _r128(cm), _r128(cin), _r128(cout)
    p1, p3 = cmp // 128, coutp // 128

    def stages(n, macs, nbytes):
        return n * max(macs, 180 * nbytes)

    block = (stages(p1 * cinp // 128, qp * 128 * 128, _SLOT + qp * 128)
             + stages(p1 * 9 * cmp // 128, pp * 128 * 128, _SLOT)
             + stages(p3 * cmp // 128, pp * 128 * 128, _SLOT))
    tiles = tiles_per_axis(h0, D, r) * tiles_per_axis(w, D, s)
    return -(-tiles // _SMS) * block, tiles * block


@functools.lru_cache(maxsize=64)
def chain_tile(h0: int, w: int, cin: int, cm: int, cout: int
               ) -> Optional[Tuple[int, int, int]]:
    """(R, S, stages): the output tile of csrc/int8_chain.cu and the
    slots of its ring, or None if no tile fits the shared memory.  A tile
    holds R x S outputs spaced by D, so the 3x3's taps fall on an
    (R+2) x (S+2) grid of y1 computed once a tile.  Takes the tile with
    the least modelled time (:func:`_chain_tile_cost`), then the most
    outputs (8 x 16 ran 1.5-2.5% faster than 11 x 11 at the pruned
    layer3 on an H100, where the model ties them), then the least work,
    and as many ring slots (up to 4) as shared memory holds."""
    best, best_key = None, None
    for r in range(1, _MAX_OUT + 1):
        for s in range(1, _MAX_OUT // r + 1):
            if ((r + 2) * (s + 2) > _MAX_GRID
                    or chain_smem_bytes(r, s, cm) > _SMEM_LIMIT):
                continue
            t, work = _chain_tile_cost(h0, w, cin, cm, cout, r, s)
            key = (t, -r * s, work)
            if best_key is None or key < best_key:
                best, best_key = (r, s), key
    if best is None:
        return None
    stages = max(n for n in (2, 3, 4)
                 if chain_smem_bytes(*best, cm, n) <= _SMEM_LIMIT)
    return best + (stages,)


def chain_int8_launch(x8: torch.Tensor, weights: ChainWeights,
                      scales: Scales) -> torch.Tensor:
    """One launch of K6 on a CUDA ``x8`` with the weights of
    :func:`chain_int8_weights`, on the tile of :func:`chain_tile`."""
    hp, w, cin = (int(s) for s in x8.shape)
    if x8.dtype != torch.int8 or not x8.is_contiguous():
        raise ValueError("chain_int8: x must be contiguous int8")
    if not isinstance(weights, ChainWeights):
        raise ValueError("chain_int8: the weights must be made by "
                         "chain_int8_weights")
    w1t, w2t, w3t, cm, cout = weights
    cmp, coutp = _r128(cm), _r128(cout)
    shapes = ((cmp, _r128(cin)), (9, cmp, cmp), (coutp, cmp))
    if any(t.dtype != torch.int8 or t.device != x8.device
           or tuple(t.shape) != shape or not t.is_contiguous()
           for t, shape in zip((w1t, w2t, w3t), shapes)):
        raise ValueError("chain_int8: the weights must be contiguous "
                         "int8 (Cm, Cin), (9, Cm, Cm) and (Cout, Cm), padded "
                         "to multiples of 128, on x's device, as "
                         "chain_int8_weights makes them")
    if cin % 16 or cm % 16 or cout % 2:
        raise ValueError(f"chain_int8: the kernel needs Cin and Cm multiples"
                         f" of 16 and Cout even; got {cin}, {cm}, {cout}")
    if any(t.data_ptr() % 16 for t in (x8, w1t, w2t, w3t)):
        raise ValueError("chain_int8: x and the weights must start on a "
                         "16-byte boundary")
    tile = chain_tile(hp - 2 * D, w, cin, cm, cout)
    if tile is None:
        raise ValueError(f"chain_int8: Cm={cm} does not fit the kernel's "
                         f"shared memory")
    s1, s2, s3 = _f32_scales(scales)
    out = torch.empty((hp - 2 * D, w, cout), dtype=torch.bfloat16,
                      device=x8.device)
    fn = c_entry("int8_chain", "dcfp_chain_int8",
                 [_VP, _VP, _VP, _VP, _CF, _CF, _CF, _VP, _CI, _CI, _CI, _CI,
                  _CI, _CI, _CI, _CI, _CI, _VP])
    run_c_entry(fn, x8.device, "chain_int8", x8.data_ptr(), w1t.data_ptr(),
                w2t.data_ptr(), w3t.data_ptr(), s1, s2, s3, out.data_ptr(),
                hp, w, cin, cm, cout, D, *tile)
    return out


def chain_int8(x8: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               w3: torch.Tensor, scales: Scales) -> torch.Tensor:
    """The fused int8 chain.  x8 (H0 + 2D, W, Cin) int8, whose first and
    last D rows are real input rows (the halo that the 3x3 reads); w1
    (Cin, Cm), w2 (9, Cm, Cm) with taps ky * 3 + kx, w3 (Cm, Cout), int8;
    three f32 scales.  Returns (H0, W, Cout) bf16::

        y1  = requant(x W1, s1)                  over all H0 + 2D rows
        y2  = requant(3x3 dilation-D conv of y1, s2)   y1's columns
                                                 zero-padded by D
        out = bf16(float32(y2 W3) * s3)

    Bit-exact.  Any H0 >= 1 (the TPU kernel needs H0 a multiple of its
    row tile).  On CUDA the kernel needs Cin and Cm multiples of 16 and
    Cout even; anything else raises ValueError before a launch."""
    _chain_check(x8, w1, w2, w3)
    if x8.device.type == "cpu":
        return chain_int8_plain(x8, w1, w2, w3, scales)
    if x8.device.type != "cuda":
        raise ValueError(f"chain_int8: no kernel for device {x8.device}")
    return chain_int8_launch(x8, chain_int8_weights(w1, w2, w3), scales)


def _next_block_input(out: torch.Tensor) -> torch.Tensor:
    """The probe's hand-over between blocks: the bf16 output requantized
    (x 50, round half to even, clip to -64..63) and padded with D zero
    rows above and below."""
    nxt = torch.clamp(torch.round(out.float() * 50.0), -64, 63)
    return F.pad(nxt.to(torch.int8), (0, 0, 0, 0, D, D))


def chain_int8_blocks_plain(x8, w1, w2, w3, scales: Scales,
                            blocks: int) -> torch.Tensor:
    """:func:`chain_int8_blocks` with :func:`chain_int8_plain`."""
    x = x8
    for _ in range(blocks):
        x = _next_block_input(chain_int8_plain(x, w1, w2, w3, scales))
    return x


def chain_int8_blocks(x8: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                      w3: torch.Tensor, scales: Scales,
                      blocks: int) -> torch.Tensor:
    """The probe's stage B: ``blocks`` chains back to back, like the
    layer3 trunk (Cin == Cout).  Each block's output is requantized and
    padded by D rows to feed the next; returns the last block's
    requantized, padded output, (H0 + 2D, W, Cin) int8, as the probe's
    loop carries it.  On CUDA the weights are prepared once and K6 runs
    once per block."""
    cin, _, cout = _chain_check(x8, w1, w2, w3)
    if cin != cout:
        raise ValueError(f"chain_int8_blocks: block outputs feed the next "
                         f"block, so Cout ({cout}) must equal Cin ({cin})")
    if x8.device.type == "cpu":
        return chain_int8_blocks_plain(x8, w1, w2, w3, scales, blocks)
    if x8.device.type != "cuda":
        raise ValueError(f"chain_int8: no kernel for device {x8.device}")
    weights = chain_int8_weights(w1, w2, w3)
    x = x8
    for _ in range(blocks):
        x = _next_block_input(chain_int8_launch(x, weights, scales))
    return x


def chain_bf16(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
               k3: torch.Tensor) -> torch.Tensor:
    """The same chain in bf16 convolutions (cuDNN on the card), the
    probe's yardstick: x (H0 + 2D, W, Cin); k1 (Cm, Cin, 1, 1), k2
    (Cm, Cm, 3, 3), k3 (Cout, Cm, 1, 1), OIHW, in x's dtype.  1x1, ReLU,
    3x3 at dilation D with SAME padding, ReLU, 1x1; each conv's f32 sums
    rounded once to x's dtype.  Returns the H0 rows (the halo rows
    dropped), (H0, W, Cout)."""
    xc = x.permute(2, 0, 1).unsqueeze(0)  # channels_last when x is contiguous
    y = torch.relu(F.conv2d(xc, k1))
    y = torch.relu(F.conv2d(y, k2, padding=D, dilation=D))
    y = F.conv2d(y, k3)
    return y[0, :, D:-D].permute(1, 2, 0)
