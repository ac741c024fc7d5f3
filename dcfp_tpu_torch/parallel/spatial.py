"""Image height over the ranks of a spatial group: the band rule and the
row exchanges that every op reading across rows needs.

The JAX package has no counterpart: its ``spatial`` mesh axis shards the
H dimension of one SPMD program and XLA's partitioner writes the halo
exchanges (``dcfp_tpu/parallel/mesh.py``).  The port runs one process per
card, so the exchanges are written here, on ``torch.distributed``
point-to-point sends between the ranks of one spatial group:

* **the band rule** (:func:`band`): of a tensor of global height ``h``
  over ``s`` ranks, rank ``i`` holds rows ``[lo, hi)``, the first
  ``h % s`` bands one row longer than the rest (769 rows over 2 ranks:
  385 + 384).  Every band of a tensor follows from its global height,
  which ``graph/shapes.py`` gives for every node of a graph;
* :func:`fetch_rows`: the global rows ``[lo, hi)`` that an op's band
  reads, from whichever ranks hold them (a halo may be wider than a
  band: the ASPP's dilation 36 on a 97-row map over 4 ranks), with a
  fill outside ``[0, h)``.  Every rank knows every rank's range, so each
  works out without asking what it sends to whom.  Its backward is the
  reverse exchange, a row read by two ranks summing both gradients;
* :func:`halo_conv2d`: a conv (or max pool) of a band whose backward
  keeps only the band and the fetched halo rows, not a second copy of
  the band with its halo;
* :func:`resize_rows`: a bilinear resize's band, from the input rows its
  interpolation rows touch;
* :func:`spatial_sum`, :func:`shard_rows`, :func:`gather_rows`: the sum
  over the group (pools, per-image loss sums), a whole tensor cut to this
  rank's band, and the bands put back together.

Ranks of one spatial group run the same ops in the same order, and each
exchange is a ``batch_isend_irecv`` of the pairs that have rows to swap;
a pair that has none skips, on both sides, so no rank waits for a send
that never comes.  Two ranks that share one card run gloo, whose sends
take host copies of CUDA tensors, as ``mesh._reduce`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dcfp_tpu_torch.ops.resize import _interp_matrix, _interp_tensor
from dcfp_tpu_torch.parallel.mesh import Axis, _reduce, _SumAcross, band

Range = Tuple[int, int]


def window_rows(a: int, b: int, kernel: int, stride: int, padding: int,
                dilation: int = 1) -> Range:
    """Input rows ``[lo, hi)`` that output rows ``[a, b)`` of a window op
    (conv, pool) read; ``lo`` < 0 and ``hi`` > the input's height are the
    op's padding."""
    return (a * stride - padding,
            (b - 1) * stride - padding + (kernel - 1) * dilation + 1)


@dataclasses.dataclass(frozen=True)
class Rows:
    """The layout of a banded tensor: its global height ``h`` over
    ``axis``, this rank holding ``axis.band(h)``."""
    axis: Axis
    h: int

    @property
    def lo(self) -> int:
        return self.axis.band(self.h)[0]

    @property
    def hi(self) -> int:
        return self.axis.band(self.h)[1]


# ---------------------------------------------------------------------------
# point-to-point exchange
# ---------------------------------------------------------------------------

def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _exchange(axis: Axis, sends: Dict[int, torch.Tensor],
              recvs: Dict[int, Tuple[tuple, torch.dtype, torch.device]]
              ) -> Dict[int, torch.Tensor]:
    """Send ``sends[j]`` to spatial rank ``j`` and receive, from each
    ``j`` of ``recvs``, a tensor of the given shape; returns the received
    tensors on their devices.  One ``batch_isend_irecv`` (nothing when
    this rank has nothing to swap)."""
    if not sends and not recvs:
        return {}
    ops, out, back = [], {}, []
    for j, t in sends.items():
        t = t.contiguous()
        if _through_host(t, axis.group):
            t = t.cpu()
        ops.append(dist.P2POp(dist.isend, t, axis.ranks[j], axis.group))
    for j, (shape, dtype, device) in recvs.items():
        host = device.type == "cuda" and dist.get_backend(axis.group) == "gloo"
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if host else device)
        out[j] = buf
        if host:
            back.append(j)
        ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[j], axis.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for j in back:
        out[j] = out[j].to(recvs[j][2])
    return out


def _overlap(a: Range, b: Range) -> Optional[Range]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


class _Plan:
    """Who sends which rows to whom for one fetch: ``ranges[j]`` are the
    global rows spatial rank ``j`` reads of a height-``h`` tensor."""

    def __init__(self, axis: Axis, ranges: Sequence[Range], h: int):
        me = axis.index
        self.axis, self.h = axis, h
        self.mine = axis.band(h)
        self.want = tuple(ranges[me])
        self.local = _overlap(self.want, self.mine)
        # rows of my band that rank j reads / rows of rank j's band I read
        self.sends = {j: r for j in range(axis.size) if j != me
                      for r in [_overlap(tuple(ranges[j]), self.mine)] if r}
        self.recvs = {j: r for j in range(axis.size) if j != me
                      for r in [_overlap(self.want, axis.band(h, j))] if r}

    @property
    def trivial(self) -> bool:
        """This rank reads exactly its band and nobody reads from it."""
        return self.want == self.mine and not self.sends

    def forward(self, x: torch.Tensor, fill: float) -> torch.Tensor:
        lo, hi = self.want
        b0 = self.mine[0]
        out = _empty_like_rows(x, hi - lo)
        if fill is not None:
            out.fill_(fill)
        if self.local:
            a, b = self.local
            out[..., a - lo:b - lo, :] = x[..., a - b0:b - b0, :]
        got = _exchange(self.axis,
                        {j: x[..., a - b0:b - b0, :]
                         for j, (a, b) in self.sends.items()},
                        {j: (_rows_shape(x, b - a), x.dtype, x.device)
                         for j, (a, b) in self.recvs.items()})
        for j, (a, b) in self.recvs.items():
            out[..., a - lo:b - lo, :] = got[j]
        return out

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        lo = self.want[0]
        b0, b1 = self.mine
        gx = g.new_zeros(_rows_shape(g, b1 - b0))
        if self.local:
            a, b = self.local
            gx[..., a - b0:b - b0, :] += g[..., a - lo:b - lo, :]
        got = _exchange(self.axis,
                        {j: g[..., a - lo:b - lo, :]
                         for j, (a, b) in self.recvs.items()},
                        {j: (_rows_shape(g, b - a), g.dtype, g.device)
                         for j, (a, b) in self.sends.items()})
        for j in sorted(got):
            a, b = self.sends[j]
            gx[..., a - b0:b - b0, :] += got[j]
        return gx


def _rows_shape(x: torch.Tensor, rows: int) -> tuple:
    return tuple(x.shape[:-2]) + (rows, x.shape[-1])


def _empty_like_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """An empty tensor of ``x``'s shape with ``rows`` rows, in x's memory
    format (a channels_last activation stays channels_last)."""
    shape = _rows_shape(x, rows)
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return torch.empty(shape, dtype=x.dtype, device=x.device,
                           memory_format=torch.channels_last)
    return x.new_empty(shape)


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, fill):
        ctx.plan = plan
        return plan.forward(x, fill)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.backward(g), None, None


def fetch_rows(x: torch.Tensor, ranges: Sequence[Range], h: int,
               axis: Axis, fill: Optional[float] = 0.0) -> torch.Tensor:
    """Global rows ``ranges[axis.index]`` of a tensor of global height
    ``h`` whose rows (dim -2) are banded over ``axis``, ``x`` being this
    rank's band; rows outside ``[0, h)`` hold ``fill``.  ``ranges[j]`` is
    what spatial rank ``j`` reads: every rank of the group calls this with
    the same ``ranges``.  Differentiable for floating ``x``."""
    plan = _Plan(axis, ranges, h)
    if plan.trivial:
        return x
    if x.requires_grad:
        return _Fetch.apply(x, plan, fill)
    return plan.forward(x, fill)


class _HaloConv(torch.autograd.Function):
    """conv2d of the fetched rows, keeping for the backward the band (which
    the op before already keeps) and the halo rows, not the fetched copy
    that holds both."""

    @staticmethod
    def forward(ctx, x, weight, bias, plan, conv):
        xf = plan.forward(x, 0.0)
        lo = plan.want[0]
        a, b = plan.local or (lo, lo)
        top, bot = xf[..., :a - lo, :].clone(), xf[..., b - lo:, :].clone()
        ctx.plan, ctx.conv, ctx.has_bias = plan, conv, bias is not None
        ctx.cut = (a - plan.mine[0], b - plan.mine[0])
        ctx.save_for_backward(x, weight, top, bot)
        return F.conv2d(xf, weight, bias, **conv)

    @staticmethod
    def backward(ctx, g):
        x, weight, top, bot = ctx.saved_tensors
        c0, c1 = ctx.cut
        xf = torch.cat([top, x[..., c0:c1, :], bot], dim=-2)
        if x.is_contiguous(memory_format=torch.channels_last) \
                and not x.is_contiguous():
            xf = xf.contiguous(memory_format=torch.channels_last)
        cv = ctx.conv
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g, xf, weight, [weight.shape[0]] if ctx.has_bias else None,
            list(cv["stride"]), list(cv["padding"]), list(cv["dilation"]),
            False, [0, 0], cv["groups"],
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
             ctx.has_bias and ctx.needs_input_grad[2]])
        if gx is not None:
            gx = ctx.plan.backward(gx)
        return gx, gw, gb, None, None


def halo_conv2d(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], rows: Rows, h_out: int,
                stride: int = 1, padding: int = 0, dilation: int = 1,
                groups: int = 1) -> torch.Tensor:
    """This rank's band of ``F.conv2d(x_whole, ...)`` (square kernel,
    symmetric padding) from its band ``x`` of an input laid out as
    ``rows``; ``h_out`` is the output's global height.  A 1x1 stride-1
    conv reads its own band and swaps nothing."""
    axis, k = rows.axis, weight.shape[-1]
    ranges = [window_rows(a, b, k, stride, padding, dilation)
              for a, b in axis.bands(h_out)]
    plan = _Plan(axis, ranges, rows.h)
    conv = dict(stride=(stride, stride), padding=(0, padding),
                dilation=(dilation, dilation), groups=groups)
    if plan.trivial:
        return F.conv2d(x, weight, bias, **conv)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or (bias is not None
                                        and bias.requires_grad)):
        return _HaloConv.apply(x, weight, bias, plan, conv)
    return F.conv2d(plan.forward(x, 0.0), weight, bias, **conv)


def halo_max_pool2d(x: torch.Tensor, rows: Rows, h_out: int, kernel: int,
                    stride: int, padding: int) -> torch.Tensor:
    """This rank's band of ``F.max_pool2d(x_whole, ...)``: the fetched
    rows, -inf outside the image."""
    ranges = [window_rows(a, b, kernel, stride, padding)
              for a, b in rows.axis.bands(h_out)]
    xf = fetch_rows(x, ranges, rows.h, rows.axis, fill=float("-inf"))
    return F.max_pool2d(xf, kernel, stride, (0, padding))


def resize_rows(x: torch.Tensor, rows: Optional[Rows], out_h: int,
                align_corners: bool, axis: Axis) -> torch.Tensor:
    """This rank's band of the H pass of ``ops.resize`` from ``x``: its
    band of an input laid out as ``rows``, or the whole input when
    ``rows`` is None (a replicated map, e.g. a global pool's 1x1).  The
    band's rows of the interpolation matrix, times the input rows they
    touch (fetched), in float32; returns f32."""
    h_in = rows.h if rows is not None else x.shape[-2]
    a, b = band(out_h, axis.size, axis.index)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if h_in == out_h:
        return xf if rows is not None else xf[..., a:b, :]
    mat = _interp_matrix(h_in, out_h, align_corners)
    if rows is None:
        lo, hi = 0, h_in
    else:
        ranges = [_touched(mat, a_j, b_j)
                  for a_j, b_j in axis.bands(out_h)]
        xf = fetch_rows(xf, ranges, h_in, axis)
        lo, hi = ranges[axis.index]
    wh = _interp_tensor(h_in, out_h, align_corners, x.device)
    return torch.einsum("oh,...hw->...ow", wh[a:b, lo:hi].to(xf.dtype), xf)


def _touched(mat: np.ndarray, a: int, b: int) -> Range:
    """Columns ``[lo, hi)`` holding every non-zero of ``mat[a:b]``."""
    cols = np.nonzero(mat[a:b].any(axis=0))[0]
    return int(cols[0]), int(cols[-1]) + 1


def resize_band(x: torch.Tensor, rows: Optional[Rows], out_hw,
                align_corners: bool, axis: Axis) -> torch.Tensor:
    """This rank's band of ``ops.resize.resize_bilinear_cf(x_whole,
    out_hw)``: the H pass by :func:`resize_rows`, the W pass local; in
    x's dtype."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    y = resize_rows(x, rows, out_h, align_corners, axis)
    w = x.shape[-1]
    if w != out_w:
        ww = _interp_tensor(w, out_w, align_corners, x.device).to(y.dtype)
        y = torch.einsum("ow,...hw->...ho", ww, y)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# sums, cutting and gathering
# ---------------------------------------------------------------------------

def spatial_sum(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of ``t`` over the spatial group, differentiable (every
    rank of the group reads it, so the backward sums their gradients);
    ``t`` itself without a spatial axis."""
    if axis is None or axis.size == 1:
        return t
    if t.requires_grad:
        return _SumAcross.apply(t, axis.group)
    out = t.clone(memory_format=torch.contiguous_format)
    _reduce(out, group=axis.group)
    return out


class _Shard(torch.autograd.Function):
    """Cut a whole tensor, which every rank of the group holds, to the
    band; the backward gathers the bands' gradients, so each rank gets
    the whole input's."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.h = axis, dim, x.shape[dim]
        lo, hi = axis.band(x.shape[dim])
        return x.narrow(dim, lo, hi - lo).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.h, ctx.axis, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """The bands put together; the backward keeps this rank's band of the
    gradient (the loss that reads the whole tensor is one, not a share
    on each rank)."""

    @staticmethod
    def forward(ctx, x, h, axis, dim):
        ctx.axis, ctx.dim, ctx.h = axis, dim, h
        return _gather(x, h, axis, dim)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.axis.band(ctx.h)
        return g.narrow(ctx.dim, lo, hi - lo), None, None, None


def shard_rows(x, axis: Optional[Axis], dim: int = -2):
    """This rank's band of a whole array or tensor along ``dim`` (numpy
    arrays and tensors without gradient are sliced, no copy)."""
    if axis is None or axis.size == 1:
        return x
    if isinstance(x, torch.Tensor) and x.requires_grad:
        return _Shard.apply(x, axis, dim)
    lo, hi = axis.band(x.shape[dim])
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(lo, hi)
    return x[tuple(idx)]


def _gather(x: torch.Tensor, h: int, axis: Axis, dim: int) -> torch.Tensor:
    dim = dim % x.dim()
    longest = -(-h // axis.size)
    pad = list(x.shape)
    pad[dim] = longest - x.shape[dim]
    src = torch.cat([x, x.new_zeros(pad)], dim=dim) if pad[dim] else x
    src = src.contiguous()
    host = _through_host(src, axis.group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat([p.narrow(dim, 0, hi - lo)
                     for p, (lo, hi) in zip(parts, axis.bands(h))], dim=dim)
    return out.to(x.device) if host else out


def gather_rows(x: torch.Tensor, h: int, axis: Optional[Axis],
                dim: int = -2) -> torch.Tensor:
    """The whole tensor of global height ``h`` along ``dim`` from every
    rank's band ``x`` (bands may differ in length by one row); every
    rank of the group gets it.  Differentiable (see ``_Gather``)."""
    if axis is None or axis.size == 1:
        return x
    if x.requires_grad:
        return _Gather.apply(x, h, axis, dim)
    return _gather(x, h, axis, dim)
