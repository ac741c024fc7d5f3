"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

K1 ``resize_argmax``: fused bilinear upsample + channel argmax, the
deploy tail (port of ``dcfp_tpu/ops/pallas_kernels.py`` ``_kernel`` /
``_resize_argmax_cm``; source ``dcfp_tpu_torch/csrc/resize_argmax.cu``)::

    out[n, y, x] = argmax_c  sum_ij  Wh[y, i] * Ww[x, j] * z[n, c, i, j]

The upsampled logits are never written to device memory; only the uint8
label map is.  The kernel's tiling (output tile, channel chunk, source
footprint, shared memory) is planned on the host by
:func:`resize_argmax_plan`, cached per shape.

K2 ``stem_conv3x3_s2``: the 3x3 / stride-2 / pad-1 stem conv from
stride-2 phase planes (port of ``dcfp_tpu/ops/pallas_kernels.py``
``_stem_kernel`` / ``_stem_conv_planes``; source
``dcfp_tpu_torch/csrc/stem_conv.cu``); the first op of the ``phases``
deploy body.  Its bf16 launch (runs of output pixels, the staged
footprint, the channel groups, the load and store routes) is planned on
the host by :func:`stem_conv_plan`, cached per shape.

The conv epilogue ``conv_epilogue``: a conv's bias, the residual add
and the ReLU that follow it, in one pass over the conv's output (source
``dcfp_tpu_torch/csrc/epilogue.cu``; no Pallas kernel: XLA fuses the
same work into the conv on the TPU)::

    y[n, c, h, w] = act(x[n, c, h, w] + bias[c] (+ residual[n, c, h, w]))

in f32 with one rounding; the deploy body runs it after every conv with
a bias (``engine/deploy.py`` ``fuse_conv_epilogues``).

K3 ``fused_bottleneck`` lives in ``dcfp_tpu_torch.ops.bottleneck``, the
int8 probe's K5 ``tiled_mm`` and K6 ``chain_int8`` in
``dcfp_tpu_torch.ops.int8``, and the ASPP probe's K4 ``aspp_fused`` in
``dcfp_tpu_torch.ops.aspp``; they count their launches here too.

Each wrapper takes its plain PyTorch version for a tensor on the CPU
(the tests run there) and launches the kernel for a CUDA tensor, or
raises; it never falls back.  ``LAUNCHES`` counts kernel launches, one
per launch, so a run can show which path it went through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dcfp_tpu_torch.ops.resize import _interp_matrix, resize_bilinear

LAUNCHES = {"resize_argmax": 0, "stem_conv3x3_s2": 0, "fused_bottleneck": 0,
            "tiled_mm": 0, "chain_int8": 0, "aspp_fused": 0,
            "conv_epilogue": 0}

# csrc/<name>.cu of every kernel of the port
SOURCES = ("resize_argmax", "stem_conv", "bottleneck", "int8_mm",
           "int8_chain", "aspp", "epilogue")

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
    kernel reads either in place.  The kernel stages each output tile's
    source footprint in shared memory, so a shape where even a 1 x 8
    tile's footprint passes 227 KB (a strong down-sampling of a wide row,
    such as 19 channels of 20000 columns to 8) raises ValueError from
    :func:`resize_argmax_plan`."""
    _check(logits_cm, logits_cm.shape[1])
    if logits_cm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"resize_argmax: no kernel for device "
                         f"{logits_cm.device}")
    return torch.ops.dcfp_tpu_torch.resize_argmax_cm(
        logits_cm, int(out_hw[0]), int(out_hw[1]), bool(align_corners))


# K1 as a registered operator, so that ``torch.export`` records it in the
# deploy tail as one node: the CPU kernel is the plain version, the CUDA
# kernel the hand-written one, and the fake kernel gives the label shape.
@torch.library.custom_op("dcfp_tpu_torch::resize_argmax_cm", mutates_args=(),
                         device_types=("cpu",))
def _resize_argmax_op(logits_cm: torch.Tensor, out_h: int, out_w: int,
                      align_corners: bool) -> torch.Tensor:
    return resize_argmax_plain(logits_cm.permute(0, 2, 3, 1),
                               (out_h, out_w), align_corners)


@_resize_argmax_op.register_kernel("cuda")
def _resize_argmax_cuda(logits_cm, out_h, out_w, align_corners):
    if not (logits_cm.is_contiguous() or logits_cm.is_contiguous(
            memory_format=torch.channels_last)):
        raise ValueError("resize_argmax_cm: logits must be contiguous "
                         "(N, C, h, w), or channels_last")
    return _launch(logits_cm, (out_h, out_w), align_corners)


@_resize_argmax_op.register_fake
def _resize_argmax_fake(logits_cm, out_h, out_w, align_corners):
    return logits_cm.new_empty((logits_cm.shape[0], out_h, out_w),
                               dtype=torch.uint8)


@functools.lru_cache(maxsize=64)
def _tap_table(in_size: int, out_size: int,
               align_corners: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-row tap table of ``_interp_matrix``: (out, 2) int32
    source indices and (out, 2) f32 weights, read from the matrix so the
    weights are bit-identical.  A row with one non-zero (identity or
    clamped) repeats its index with weight 0.  Both columns of indices
    are non-decreasing down the rows."""
    mat = _interp_matrix(in_size, out_size, align_corners)
    idx = np.zeros((out_size, 2), np.int32)
    wts = np.zeros((out_size, 2), np.float32)
    for r in range(out_size):
        nz = np.flatnonzero(mat[r])
        if not 1 <= nz.size <= 2:
            raise AssertionError(f"interp row {r} has {nz.size} taps")
        idx[r] = (nz[0], nz[-1])
        wts[r, :nz.size] = mat[r, nz]
    idx.setflags(write=False)
    wts.setflags(write=False)
    return idx, wts


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int, align_corners: bool,
          device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_tap_table` as tensors on ``device`` (cached; the kernel
    reads them, callers must not write to them)."""
    idx, wts = _tap_table(in_size, out_size, align_corners)
    return (torch.from_numpy(idx.copy()).to(device),
            torch.from_numpy(wts.copy()).to(device))


K1_PIXELS = 8                # output pixels a thread owns along a row (P)
K1_CHUNK = 32                # channels a block walks at a time (kChunk)
# (TR, TW) output tiles in order of preference; TR * TW / P <= 256 threads
K1_TILES = ((8, 256), (8, 128), (4, 128), (4, 64), (2, 64), (2, 32),
            (1, 32), (1, 16), (1, 8))
K1_SMEM_SOFT = 96 * 1024     # leaves room for two blocks an SM
K1_SMEM_MAX = 227 * 1024     # what one block may have on sm_90
K1_WAVE_BLOCKS = 2 * 132     # two blocks for each of the H100's SMs


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """The launch of K1 for one shape (see :func:`resize_argmax_plan`)."""
    tr: int          # output rows of a tile
    tw: int          # output columns of a tile
    p: int           # pixels a thread owns along a row
    c_chunk: int     # channels a block walks at a time, in ascending order
    span_r: int      # source rows of the tallest tile footprint
    span_c: int      # source columns of the widest tile footprint
    grid: Tuple[int, int, int]  # (column tiles, row tiles, N)
    threads: int
    smem: int        # dynamic shared memory bytes of a block


def _k1_smem(tr: int, tw: int, span_r: int, span_c: int, c: int,
             c_chunk: int) -> int:
    """K1's shared memory, the formula of ``csrc/resize_argmax.cu``
    ``smem_bytes``: a row of labels (TW + 15 bytes, rounded up to 16) and
    a row's taps (16 bytes) per tile row, and the staged footprint and the
    H pass in f32, CS floats a column: the chunk's channels in float4
    groups, an odd number of them (``col_stride``)."""
    cs = 4 * (((min(c, c_chunk) + 3) // 4) | 1)
    label_stride = (tw + 30) // 16 * 16
    return tr * label_stride + tr * 16 + (span_r + tr) * span_c * cs * 4


def _max_span(idx: np.ndarray, tile: int) -> int:
    """The most source indices one tile of ``tile`` outputs reaches, over
    the tiles of a tap table (taps are non-decreasing)."""
    starts = np.arange(0, idx.shape[0], tile)
    ends = np.minimum(starts + tile, idx.shape[0]) - 1
    return int((idx[ends, 1] - idx[starts, 0]).max()) + 1


@functools.lru_cache(maxsize=64)
def resize_argmax_plan(n: int, c: int, h: int, w: int, out_h: int,
                       out_w: int, align_corners: bool) -> K1Plan:
    """K1's tiling for logits (n, c, h, w) resized to (out_h, out_w): the
    tile, the channel chunk and the footprint spans the launch needs,
    from the cached tap tables (no device work; cached, so a request
    costs a lookup).

    The channels go in chunks of ``K1_CHUNK``.  Among the tiles of
    ``K1_TILES`` whose shared memory fits ``K1_SMEM_SOFT`` (else
    ``K1_SMEM_MAX``), and of those with a full warp or more where there
    are any, it takes the first whose grid fills two waves of the card,
    else the one with the most blocks.  Raises ValueError if nothing fits
    in 227 KB: a tile's whole source footprint is staged, so a strong
    down-sampling of a wide row (19 channels of 20000 columns to 8, say)
    has no plan."""
    if min(n, c, h, w, out_h, out_w) < 1:
        raise ValueError(f"resize_argmax_plan: empty shape "
                         f"{(n, c, h, w)} -> {(out_h, out_w)}")
    ytab = _tap_table(h, out_h, align_corners)[0]
    xtab = _tap_table(w, out_w, align_corners)[0]
    p = K1_PIXELS
    tiles = [(tr, tw) for tr, tw in K1_TILES
             if (tr <= out_h or tr == 1)
             and (tw <= -(-out_w // p) * p or tw == p)]
    for limit in (K1_SMEM_SOFT, K1_SMEM_MAX):
        fits = []
        for tr, tw in tiles:
            sr, sc = _max_span(ytab, tr), _max_span(xtab, tw)
            smem = _k1_smem(tr, tw, sr, sc, c, K1_CHUNK)
            if smem <= limit:
                grid = (-(-out_w // tw), -(-out_h // tr), n)
                fits.append(K1Plan(tr, tw, p, K1_CHUNK, sr, sc, grid,
                                   tr * tw // p, smem))
        # blocks of a full warp or more, where any fits
        fits = [f for f in fits if f.threads >= 32] or fits
        if fits:
            blocks = [f.grid[0] * f.grid[1] * f.grid[2] for f in fits]
            return next((f for f, b in zip(fits, blocks)
                         if b >= K1_WAVE_BLOCKS),
                        fits[blocks.index(max(blocks))])
    raise ValueError(f"resize_argmax: no tile of {(h, w)} -> "
                     f"{(out_h, out_w)} fits in {K1_SMEM_MAX} bytes of "
                     f"shared memory")


def build_all():
    """Build (nvcc, at first use, all sources in parallel) and load every
    kernel of the port; returns ``{source: cuda_build.Built}`` (library,
    nvcc seconds and log)."""
    from dcfp_tpu_torch.ops.cuda_build import load_all
    return load_all(SOURCES)


def c_entry(source: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<source>.cu``, built at first use,
    with its ``argtypes`` set.  Every pointer and the stream must be
    ``c_void_p``: ctypes would pass a bare Python int as a 32-bit C int
    and cut the address."""
    from dcfp_tpu_torch.ops.cuda_build import load
    fn = getattr(load(source).lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def run_c_entry(fn, device: torch.device, name: str, *args) -> None:
    """Launch through C entry ``fn`` on ``device``'s current stream (the
    stream is the last argument), raise if the launch failed, and count
    it in ``LAUNCHES[name]``."""
    # the launch goes to the current device, so make it the tensors' one
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


_VP, _CI, _CL, _CF = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
# csrc/resize_argmax.cu dcfp_resize_argmax_cm
K1_ARGTYPES = [_VP, _CI, _CI, _CI, _CL, _CL, _CL, _CL, _CI, _CI, _VP, _VP,
               _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, _CL, _VP]


def _launch(z: torch.Tensor, out_hw: Tuple[int, int],
            align_corners: bool) -> torch.Tensor:
    n, c, h, w = z.shape
    out_h, out_w = out_hw
    out = torch.empty((n, out_h, out_w), dtype=torch.uint8, device=z.device)
    if out.numel() == 0:
        return out
    plan = resize_argmax_plan(n, c, h, w, out_h, out_w, align_corners)
    ytap, ywt = _taps(h, out_h, align_corners, z.device)
    xtap, xwt = _taps(w, out_w, align_corners, z.device)
    fn = c_entry("resize_argmax", "dcfp_resize_argmax_cm", K1_ARGTYPES)
    run_c_entry(fn, z.device, "resize_argmax", z.data_ptr(),
                int(z.dtype == torch.bfloat16), n, c, *z.stride(), out_h,
                out_w, ytap.data_ptr(), ywt.data_ptr(), xtap.data_ptr(),
                xwt.data_ptr(), out.data_ptr(), plan.tr, plan.tw, plan.p,
                plan.c_chunk, plan.span_r, plan.span_c, plan.smem)
    return out


# ---------------------------------------------------------------------------
# K2: stem conv from phase planes
# ---------------------------------------------------------------------------

def _stem_check(phases: torch.Tensor, cin: int, cout: int, bias,
                out_hw) -> Tuple[int, int]:
    if phases.dim() != 4:
        raise ValueError(f"stem_conv3x3_s2: expected (N, 4*cin, Hp, Wp) "
                         f"phases, got shape {tuple(phases.shape)}")
    if phases.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem_conv3x3_s2: phases must be float32 or "
                        f"bfloat16, got {phases.dtype}")
    if not 1 <= cin <= 4 or phases.shape[1] != 4 * cin:
        raise ValueError(f"stem_conv3x3_s2: {phases.shape[1]} phase planes "
                         f"for a kernel with cin={cin} (need 4*cin, cin<=4)")
    ho, wo = int(out_hw[0]), int(out_hw[1])
    if phases.shape[2] < ho + 1 or phases.shape[3] < wo + 1:
        raise ValueError(f"stem_conv3x3_s2: planes {tuple(phases.shape[2:])}"
                         f" too small for output {(ho, wo)}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"stem_conv3x3_s2: bias shape {tuple(bias.shape)}, "
                         f"want ({cout},)")
    return ho, wo


def _kernel_check(kernel: torch.Tensor) -> Tuple[int, int]:
    if kernel.dim() != 4 or tuple(kernel.shape[2:]) != (3, 3):
        raise ValueError(f"stem_conv3x3_s2: kernel must be OIHW "
                         f"(cout, cin, 3, 3), got {tuple(kernel.shape)}")
    return int(kernel.shape[1]), int(kernel.shape[0])


K2_TILES = (256, 128, 64, 32, 16)  # pixels of a run, in order of preference
K2_THREADS = 256             # kThreads in the kernel
K2_STAGES = 2                # footprint stages (double-buffered)
K2_CHUNK = 64                # channels of an mma chunk (kNt * 8)
K2_BLOCKS_PER_SM = 2         # kMinBlocks: the registers allow two an SM
K2_SMS = 132                 # the H100's SMs
# two blocks an SM: 228 KB an SM, 1 KB of it reserved for each block
K2_SMEM_SOFT = (228 * 1024) // K2_BLOCKS_PER_SM - 1024
K2_SMEM_MAX = 227 * 1024     # what one block may have on sm_90


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """The bf16 launch of K2 for one shape (see :func:`stem_conv_plan`)."""
    m: int           # output pixels of a run (a tile), flattened (oy, ox)
    ksteps: int      # 16-deep k-steps over the 9*cin taps
    chunks: int      # 64-channel chunks of cout
    cg: int          # chunks of a tile (all of them unless cout is wide)
    groups: int      # channel groups: tiles of one run
    threads: int
    stages: int      # footprint stages in shared memory
    rows: int        # output rows the longest run touches
    line: int        # staged elements of a (plane, row offset) line
    tiles: int       # runs x groups over the batch
    grid: int        # persistent blocks (<= two an SM)
    smem: int        # dynamic shared memory bytes of a block
    load: str        # "4-byte" cp.async, or "2-byte" loads
    store: str       # "bulk" (one copy a run) or "threads"


def _k2_smem(cin: int, cout: int, m: int, line: int, cg: int, groups: int,
             bulk: bool) -> int:
    """K2's shared memory, the formula of ``csrc/stem_conv.cu``
    ``smem_bytes``: the output buffers (two for the bulk route; a run of
    m pixels, each row the tile's channels, + 16 bytes to place it at its
    output address mod 16), two footprint stages (8*cin lines of ``line``
    bf16), the B fragments (8 bytes a lane, 32 lanes, 8 n-tiles, each
    k-step of each chunk) and the f32 bias of a group, then for each stage
    an int slot a pixel and the run's 16-byte ``Meta`` (first pixel,
    pixels)."""
    ks = -(-9 * cin // 16)
    ostride = cout if groups == 1 else K2_CHUNK * cg
    return ((2 if bulk else 1) * (m * ostride * 2 + 16)
            + K2_STAGES * 16 * cin * line + cg * ks * 8 * 32 * 8
            + cg * K2_CHUNK * 4 + K2_STAGES * (m * 4 + 16))


@functools.lru_cache(maxsize=256)
def k2_runs(m: int, ho: int, wo: int) -> dict:
    """The runs of m pixels of one image, as the kernel's ``run_of`` sees
    them (numpy arrays, one entry a run): first pixel ``p0``, pixels
    ``len``, first output row ``oy0``, output rows touched ``segs``,
    segment 0's first staged column ``a0`` (even) and width ``w0``, the
    last pixel's column ``bl`` and the staged ``width`` of a line.  Each
    segment is staged from an even column with an even width, so 4-byte
    words never straddle it: segment k is output row oy0 + k, columns
    ``a0`` (k = 0) or 0 up to its last pixel's column + 1, rounded up to
    even; ``wfull = (wo + 2) & ~1`` is a whole row's."""
    total = ho * wo
    p0 = np.arange(0, total, m, dtype=np.int64)
    n = np.minimum(m, total - p0)
    last = p0 + n - 1
    oy0, oy1 = p0 // wo, last // wo
    segs = oy1 - oy0 + 1
    bl = last - oy1 * wo
    a0 = (p0 - oy0 * wo) & ~1
    w0 = (np.where(segs == 1, bl, wo - 1) + 3 - a0) & ~1
    wfull = (wo + 2) & ~1
    width = np.where(segs == 1, w0, w0 + (segs - 2) * wfull + ((bl + 3) & ~1))
    runs = dict(p0=p0, len=n, oy0=oy0, segs=segs, a0=a0, w0=w0, bl=bl,
                width=width, wfull=wfull)
    for v in runs.values():
        if isinstance(v, np.ndarray):
            v.setflags(write=False)
    return runs


def _ptr_align(ptr: int) -> int:
    """The largest power of two, up to 16, that divides ``ptr``."""
    return 16 if ptr % 16 == 0 else ptr & -ptr


@functools.lru_cache(maxsize=64)
def stem_conv_plan(n: int, cin: int, cout: int, hp: int, wp: int, ho: int,
                   wo: int, base_align: int) -> K2Plan:
    """K2's bf16 launch for phases (n, 4*cin, hp, wp) whose first byte is
    ``base_align``-aligned (a power of two up to 16), to (n, cout, ho, wo):
    pure Python, cached, so a request costs a lookup.

    A tile is a run of ``m`` consecutive output pixels of one image (its
    output is one contiguous run, channels_last) and a group of 64-channel
    chunks.  Among ``K2_TILES``, and the chunks of a tile from all of
    them down, it takes the first whose shared memory fits two blocks an
    SM (``K2_SMEM_SOFT``), else one (``K2_SMEM_MAX``); m = 16 with one
    chunk a tile always fits.  Loads are 4-byte cp.async where Wp is even
    and the base 4-byte aligned (every staged word is then aligned), else
    2-byte; the run leaves in one bulk copy where cout % 8 == 0 and one
    group holds every channel (the run's address and length are then
    multiples of 16), else the threads store it."""
    if min(n, cin, cout, ho, wo) < 1 or cin > 4:
        raise ValueError(f"stem_conv_plan: bad shape n={n} cin={cin} "
                         f"cout={cout} out={(ho, wo)}")
    if hp < ho + 1 or wp < wo + 1:
        raise ValueError(f"stem_conv_plan: planes {(hp, wp)} too small for "
                         f"output {(ho, wo)}")
    if ho * wo > 1 << 30:
        raise ValueError(f"stem_conv_plan: {ho * wo} output pixels an image "
                         f"(at most 2^30)")
    ks = -(-9 * cin // 16)
    chunks = -(-cout // K2_CHUNK)
    load = "4-byte" if wp % 2 == 0 and base_align % 4 == 0 else "2-byte"
    cgs = [chunks] + [c for c in (32, 16, 8, 4, 2, 1) if c < chunks]
    for limit in (K2_SMEM_SOFT, K2_SMEM_MAX):
        for cg in cgs:
            groups = -(-chunks // cg)
            bulk = groups == 1 and cout % 8 == 0
            for m in K2_TILES:
                runs = k2_runs(m, ho, wo)
                line = int(runs["width"].max())
                smem = _k2_smem(cin, cout, m, line, cg, groups, bulk)
                if smem > limit:
                    continue
                blocks = K2_BLOCKS_PER_SM if smem <= K2_SMEM_SOFT else 1
                tiles = n * len(runs["p0"]) * groups
                if tiles > 1 << 30:  # the kernel's tile index is 32-bit
                    raise ValueError(f"stem_conv_plan: {tiles} tiles "
                                     f"(at most 2^30)")
                return K2Plan(m, ks, chunks, cg, groups, K2_THREADS,
                              K2_STAGES, int(runs["segs"].max()), line,
                              tiles, min(tiles, blocks * K2_SMS), smem,
                              load, "bulk" if bulk else "threads")
    raise AssertionError("stem_conv_plan: 16 pixels and one chunk a tile "
                         "(a few KB) must fit")


def _k2_launch_args(plan: K2Plan) -> Tuple[int, ...]:
    """The plan as the C entry takes it: m, line, cg, groups, grid, smem,
    load4, bulk."""
    return (plan.m, plan.line, plan.cg, plan.groups, plan.grid, plan.smem,
            int(plan.load == "4-byte"), int(plan.store == "bulk"))


# csrc/stem_conv.cu dcfp_stem_conv3x3_s2
K2_ARGTYPES = [_VP, _CI, _CI, _CI, _CI, _CI, _CI, _CI, _CI, _VP, _VP, _CI,
               _VP] + [_CI] * 8 + [_VP]


def stem_weights(kernel: torch.Tensor, bias, dtype: torch.dtype,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's weights as its C entry reads them: the (9*cin, cout) f32
    taps-major matrix, rows in (i, j, c) order, values rounded to
    ``dtype`` first (the TPU kernel's ``km.astype(phases.dtype)``), and the
    f32 bias (zeros for None), contiguous on ``device``."""
    cin, cout = _kernel_check(kernel)
    km = (kernel.to(device, dtype).float().permute(2, 3, 1, 0)
          .reshape(9 * cin, cout).contiguous())
    b = (torch.zeros(cout, dtype=torch.float32, device=device)
         if bias is None else bias.to(device, torch.float32).contiguous())
    return km, b


def _stem_plain(phases: torch.Tensor, km: torch.Tensor, b: torch.Tensor,
                out_hw, relu: bool) -> torch.Tensor:
    """The (N, 9*cin, Ho, Wo) tap stack from unit-stride slices of the
    planes, one f32 einsum with ``km``; + f32 bias, optional ReLU, one
    rounding to the phases dtype."""
    cin, (ho, wo) = km.shape[0] // 9, out_hw
    pf = phases.float()
    taps = torch.stack([
        pf[:, ((i & 1) * 2 + (j & 1)) * cin + c,
           i // 2:i // 2 + ho, j // 2:j // 2 + wo]
        for i in range(3) for j in range(3) for c in range(cin)], dim=1)
    y = torch.einsum("nkhw,ko->nohw", taps, km) + b[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(phases.dtype)


def stem_conv3x3_s2_plain(phases: torch.Tensor, kernel: torch.Tensor,
                          bias, out_hw, *, relu: bool = False
                          ) -> torch.Tensor:
    """:func:`stem_conv3x3_s2` in plain PyTorch: the (N, 9*cin, Ho, Wo)
    tap stack from unit-stride slices of the planes, then one f32 einsum
    with the (9*cin, cout) weight matrix; + f32 bias, optional ReLU, one
    rounding to the phases dtype."""
    cin, cout = _kernel_check(kernel)
    out_hw = _stem_check(phases, cin, cout, bias, out_hw)
    km, b = stem_weights(kernel, bias, phases.dtype, phases.device)
    return _stem_plain(phases, km, b, out_hw, relu)


def stem_conv3x3_s2(phases: torch.Tensor, kernel: torch.Tensor, bias,
                    out_hw, *, relu: bool = False) -> torch.Tensor:
    """3x3 / stride-2 / pad-1 conv of an image given as its stride-2 phase
    planes (``dcfp_tpu_torch.ops.stem.extract_stem_phases``, stacked over
    the batch).

    phases: (N, 4*cin, Hp, Wp) f32/bf16, cin <= 4; kernel: OIHW
    (cout, cin, 3, 3); bias: (cout,) or None, read in f32; out_hw:
    ((H+1)//2, (W+1)//2).  Returns (N, cout, Ho, Wo) in the phases dtype;
    on CUDA it is channels_last in memory.  One launch for the batch."""
    cin, cout = _kernel_check(kernel)
    _stem_check(phases, cin, cout, bias, out_hw)
    km, b = stem_weights(kernel, bias, phases.dtype, phases.device)
    return stem_conv3x3_s2_prepared(phases, km, b, out_hw, relu=relu)


def stem_conv3x3_s2_prepared(phases: torch.Tensor, km: torch.Tensor,
                             b: torch.Tensor, out_hw, *,
                             relu: bool = False) -> torch.Tensor:
    """:func:`stem_conv3x3_s2` on the weights of :func:`stem_weights`,
    made once for many calls (the ``phases`` deploy body does so).  The
    plain version for CPU phases, one launch of K2 for CUDA phases: in
    bf16 the launch of :func:`stem_conv_plan` for their shape and the
    alignment of their ``data_ptr()`` (phases off 4 bytes, or an odd Wp,
    take the 2-byte loads)."""
    cin, cout = int(km.shape[0]) // 9, int(km.shape[1])
    if (km.shape[0] != 9 * cin or b.shape != (cout,)
            or km.dtype != torch.float32 or b.dtype != torch.float32
            or km.device != phases.device or b.device != phases.device
            or not (km.is_contiguous() and b.is_contiguous())):
        raise ValueError(f"stem_conv3x3_s2: prepared weights must be "
                         f"contiguous f32 (9*cin, cout) and (cout,) on "
                         f"{phases.device}, got {tuple(km.shape)} "
                         f"{km.dtype} and {tuple(b.shape)} {b.dtype}")
    ho, wo = _stem_check(phases, cin, cout, b, out_hw)
    if phases.device.type == "cpu":
        return _stem_plain(phases, km, b, (ho, wo), relu)
    if phases.device.type != "cuda":
        raise ValueError(f"stem_conv3x3_s2: no kernel for device "
                         f"{phases.device}")
    if not phases.is_contiguous():
        raise ValueError("stem_conv3x3_s2: phases must be contiguous")
    out = torch.empty((phases.shape[0], cout, ho, wo), dtype=phases.dtype,
                      device=phases.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    n, _, hp, wp = (int(d) for d in phases.shape)
    bf16 = phases.dtype == torch.bfloat16
    plan = (_k2_launch_args(stem_conv_plan(
        n, cin, cout, hp, wp, ho, wo, _ptr_align(phases.data_ptr())))
        if bf16 else (0,) * 8)  # f32 runs its FMA kernel, no plan
    fn = c_entry("stem_conv", "dcfp_stem_conv3x3_s2", K2_ARGTYPES)
    run_c_entry(fn, phases.device, "stem_conv3x3_s2", phases.data_ptr(),
                int(bf16), n, cin, cout, hp, wp, ho, wo, km.data_ptr(),
                b.data_ptr(), int(bool(relu)), out.data_ptr(), *plan)
    return out


# ---------------------------------------------------------------------------
# the conv epilogue: bias, residual add and ReLU in one pass
# ---------------------------------------------------------------------------

# the C entry's type codes
EPILOGUE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def conv_epilogue_plain(x: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """:func:`conv_epilogue` in plain PyTorch: ``x + bias[c]``, then
    ``+ residual``, then ReLU, in f32, with one rounding to x's dtype."""
    y = x.float() + bias.float()[:, None, None]
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def conv_epilogue(x: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """``act(x + bias[c] (+ residual))`` over a conv's output x (N, C, H,
    W), in f32 with one rounding to x's dtype (f32, bf16 or f16); bias
    (C,) and the residual (x's shape) in x's dtype.  The plain version
    for CPU tensors, which returns x's memory format; for CUDA tensors
    one launch of ``csrc/epilogue.cu``, which reads and writes
    channels_last: the deploy body's convs leave their outputs so, and an
    operand in another layout is first copied to it."""
    if x.dim() != 4:
        raise ValueError(f"conv_epilogue: expected (N, C, H, W), got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in EPILOGUE_DTYPES:
        raise TypeError(f"conv_epilogue: no kernel for {x.dtype}")
    if tuple(bias.shape) != (x.shape[1],) or bias.dtype != x.dtype:
        raise ValueError(f"conv_epilogue: bias {tuple(bias.shape)} "
                         f"{bias.dtype} for x {tuple(x.shape)} {x.dtype}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"conv_epilogue: residual "
                         f"{tuple(residual.shape)} {residual.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue: no kernel for device {x.device}")
    return torch.ops.dcfp_tpu_torch.conv_epilogue(x, bias, residual,
                                                  bool(relu))


# a registered operator, as K1 is, so that ``torch.export`` records it in
# the deploy body: the CPU kernel is the plain version, the CUDA kernel
# the hand-written one
@torch.library.custom_op("dcfp_tpu_torch::conv_epilogue", mutates_args=(),
                         device_types=("cpu",))
def _conv_epilogue_op(x: torch.Tensor, bias: torch.Tensor,
                      residual: Optional[torch.Tensor],
                      relu: bool) -> torch.Tensor:
    return conv_epilogue_plain(x, bias, residual, relu)


# csrc/epilogue.cu dcfp_conv_epilogue
EPILOGUE_ARGTYPES = [_VP, _VP, _VP, _VP, _CL, _CI, _CI, _CI, _VP]


@_conv_epilogue_op.register_kernel("cuda")
def _conv_epilogue_cuda(x, bias, residual, relu):
    # a copy where the body lost the layout: torch.export (torch 2.11, on
    # the card) traced the ASPP concat as contiguous, so its program runs
    # the projection conv, and this epilogue, on NCHW tensors
    x = x.contiguous(memory_format=torch.channels_last)
    if residual is not None:
        residual = residual.contiguous(memory_format=torch.channels_last)
    if not bias.is_contiguous():
        raise ValueError("conv_epilogue: the bias must be contiguous")
    if bias.device != x.device or (residual is not None
                                   and residual.device != x.device):
        raise ValueError("conv_epilogue: x, bias and residual must share "
                         "a device")
    y = torch.empty_like(x)  # x's strides: the same layout
    if y.numel() == 0:
        return y
    fn = c_entry("epilogue", "dcfp_conv_epilogue", EPILOGUE_ARGTYPES)
    run_c_entry(fn, x.device, "conv_epilogue", x.data_ptr(),
                bias.data_ptr(),
                None if residual is None else residual.data_ptr(),
                y.data_ptr(), y.numel(), int(x.shape[1]),
                EPILOGUE_DTYPES[x.dtype], int(relu))
    return y


@_conv_epilogue_op.register_fake
def _conv_epilogue_fake(x, bias, residual, relu):
    return torch.empty_like(x)
