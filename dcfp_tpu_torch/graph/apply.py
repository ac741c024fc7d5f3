"""Interpreter + initializer for the layer-graph IR (eager PyTorch).

Port of ``dcfp_tpu/graph/apply.py``.  ``graph_apply`` walks the DAG once
per call.  Inside, tensors are NCHW and conv kernels OIHW (PyTorch's own
layouts; on the GPU the deploy path hands it ``channels_last`` tensors so
cuDNN runs NHWC underneath).  At the boundary it takes and returns NHWC
like the JAX package, unless ``channels_first=True``.

Eval mode uses BN's running statistics and no dropout.  Train mode
(``train=True``) uses the batch's moments, returns the new running
statistics, draws dropout from an explicit ``torch.Generator`` and can
recompute its activations in the backward (``remat_segments``).  Across
the ranks of a data-parallel group (``parallel/mesh.py``) its BN moments
and dropout masks are those of the global batch.

With a spatial axis (``graph_apply(..., spatial_axis=axis)``) every rank of
the group holds a band of rows of each activation (``parallel/
spatial.py``'s band rule over the node's global height, which
``graph/shapes.py`` gives), and each op computes its band of what one
process computes on the whole image: convs and the max pool read their
halo rows from the ranks that hold them, a resize reads the input rows
its band's interpolation rows touch, and the pools sum their bands over
the group.  A pool's fixed-size output (the ASPP's 1x1, PSP's bins), and
whatever is computed from such outputs alone, is held whole by every
rank of the group ("replicated"); its BN counts it once, on the group's
first rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Set, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.graph.ir import Graph, Node
from dcfp_tpu_torch.graph.shapes import infer_shapes
from dcfp_tpu_torch.ops.kernels import conv_epilogue
from dcfp_tpu_torch.ops.pool import (_adaptive_matrix, adaptive_avg_pool,
                                     global_avg_pool, max_pool)
from dcfp_tpu_torch.ops.resize import resize_bilinear_cf
from dcfp_tpu_torch.parallel import mesh, spatial

Params = Dict[str, Dict[str, torch.Tensor]]
State = Dict[str, Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_graph(graph: Graph, generator: torch.Generator,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Tuple[Params, State]:
    """Initialize params/state for every parametric node.

    Convs follow torch's default kaiming-uniform(a=sqrt(5)) —
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — as the JAX package does; BN
    starts at scale=1, bias=0, mean=0, var=1.  Values are drawn on the
    CPU from ``generator`` (a CPU ``torch.Generator``), kernel then bias
    for each conv in graph order, and moved to ``device``; so a seed
    gives the same params on every device.  They are not the JAX
    package's numbers for the same seed: tests that compare the two load
    one set of params into both (``dcfp_tpu_torch.bridge``).
    """
    dev = resolve_device(device)
    params: Params = {}
    state: State = {}

    def uniform(shape, bound):
        t = torch.empty(shape, dtype=torch.float32)
        t.uniform_(-bound, bound, generator=generator)
        return t.to(device=dev, dtype=dtype)

    for node in graph.toposorted():
        if node.op == "conv":
            a = node.attrs
            fan_in = a["kernel"] * a["kernel"] * (a["in_ch"] // a["groups"])
            bound = 1.0 / math.sqrt(fan_in)
            shape = (a["out_ch"], a["in_ch"] // a["groups"], a["kernel"],
                     a["kernel"])
            p = {"kernel": uniform(shape, bound)}
            if a["bias"]:
                p["bias"] = uniform((a["out_ch"],), bound)
            params[node.name] = p
        elif node.op == "bn":
            ch = node.attrs["channels"]
            params[node.name] = {
                "scale": torch.ones((ch,), dtype=dtype, device=dev),
                "bias": torch.zeros((ch,), dtype=dtype, device=dev),
            }
            state[node.name] = {
                "mean": torch.zeros((ch,), dtype=torch.float32, device=dev),
                "var": torch.ones((ch,), dtype=torch.float32, device=dev),
            }
    return params, state


# ---------------------------------------------------------------------------
# bands
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Bands:
    """One run's spatial layout: the axis, every node's global (H, W) and
    the nodes held whole by every rank of the group."""
    axis: spatial.Axis
    hw: Dict[str, Tuple[int, int]]
    whole: Set[str]

    def rows(self, name: str) -> Optional[spatial.Rows]:
        """The band layout of node ``name``'s value; None if held whole."""
        if name in self.whole:
            return None
        return spatial.Rows(self.axis, self.hw[name][0])


def _bands(graph: Graph, input_hw: Tuple[int, int],
           axis: spatial.Axis) -> _Bands:
    """The layout of a run from a banded graph input of global size
    ``input_hw``.  Raises ValueError, before anything runs, for a banded
    node with fewer rows than the group has ranks."""
    hw = infer_shapes(graph, input_hw)
    whole: Set[str] = set()
    for node in graph.toposorted():
        op, a = node.op, node.attrs
        if op == "input":
            pass
        elif op in ("avgpool", "globalpool"):
            whole.add(node.name)
        elif op == "resize":
            src = (a["like"] if "like" in a else None if a.get("to_input")
                   else node.inputs[0])
            if src is not None and src in whole:
                whole.add(node.name)
        elif all(i in whole for i in node.inputs):
            whole.add(node.name)
        if node.name not in whole and hw[node.name][0] < axis.size:
            raise ValueError(
                f"node {node.name!r}: {hw[node.name][0]} rows cannot be "
                f"split over {axis.size} spatial ranks (input "
                f"{tuple(input_hw)})")
    return _Bands(axis, hw, whole)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _conv(x, node: Node, p, bands: Optional[_Bands] = None,
          residual: Optional[torch.Tensor] = None):
    # A plain dilated conv at every rate: the JAX package rewrites rates
    # >= 18 as nine shifted matmuls only because the TPU's native dilated
    # conv is slow there; the two are equal up to summation order.
    # A conv with an epilogue (``engine.deploy.fuse_conv_epilogues``) runs
    # without its bias, then adds it, the residual and the ReLU in one
    # pass (``ops.kernels.conv_epilogue``).
    a = node.attrs
    epilogue = a.get("epilogue")
    bias = p["bias"].to(x.dtype) if a["bias"] else None
    conv_bias = None if epilogue is not None else bias
    rows = bands.rows(node.inputs[0]) if bands is not None else None
    if rows is not None:
        y = spatial.halo_conv2d(
            x, p["kernel"].to(x.dtype), conv_bias, rows,
            bands.hw[node.name][0], stride=a["stride"], padding=a["padding"],
            dilation=a["dilation"], groups=a["groups"])
    else:
        y = F.conv2d(x, p["kernel"].to(x.dtype), conv_bias,
                     stride=a["stride"], padding=a["padding"],
                     dilation=a["dilation"], groups=a["groups"])
    if epilogue is None:
        return y
    return conv_epilogue(y, bias, residual, relu=epilogue == "relu")


def _avgpool_band(x, rows: spatial.Rows, w: int, out_size: int):
    """``adaptive_avg_pool`` from a band: the band's columns of the H bin
    matrix, summed over the group, then the W bins; whole on every
    rank."""
    mh = torch.from_numpy(_adaptive_matrix(rows.h, out_size)[
        :, rows.lo:rows.hi].copy())
    mw = torch.from_numpy(_adaptive_matrix(w, out_size))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    xf = torch.einsum("oh,...hw->...ow", mh.to(xf.device, xf.dtype), xf)
    xf = spatial.spatial_sum(xf, rows.axis)
    xf = torch.einsum("ow,...hw->...ho", mw.to(xf.device, xf.dtype), xf)
    return xf.to(x.dtype)


def _globalpool_band(x, rows: spatial.Rows):
    """``global_avg_pool`` from a band: the band sums over the group,
    over the global H x W; whole on every rank."""
    total = spatial.spatial_sum(x.float().sum(dim=(-2, -1), keepdim=True),
                                rows.axis)
    return (total / (rows.h * x.shape[-1])).to(x.dtype)


def _bn(x, node: Node, p, s, train: bool, counted: bool = True):
    """BN in float32.  Returns (y, new running stats or None).

    Train mode normalizes with the batch's biased variance over (N, H, W)
    and moves the running statistics by ``(1 - momentum) * s + momentum *
    batch``, with the unbiased variance: ``F.batch_norm``'s semantics.
    It updates the buffers it is given in place, so it gets copies and
    the caller's ``s`` stays as it was.  Like ``nn.BatchNorm2d``, it
    raises on one value per channel (batch 1 through a global pool).

    Across ranks (``parallel.mesh.world() > 1``) the moments are the
    global batch's, as under the JAX package's data-sharded ``jnp.mean``:
    see :func:`_bn_synced`; ``counted=False`` on a rank that holds a copy
    of a value another rank of its spatial group counts.
    """
    a = node.attrs
    if train and mesh.world() > 1:
        return _bn_synced(x, a, p, s, counted)
    if train:
        new_s = {"mean": s["mean"].float().clone(),
                 "var": s["var"].float().clone()}
        y = F.batch_norm(x.float(), new_s["mean"], new_s["var"],
                         p["scale"].float(), p["bias"].float(),
                         training=True, momentum=a["momentum"],
                         eps=a["eps"])
        return y.to(x.dtype), new_s
    inv = torch.rsqrt(s["var"].float() + a["eps"]) * p["scale"].float()
    shift = p["bias"].float() - s["mean"].float() * inv
    y = x.float() * inv[:, None, None] + shift[:, None, None]
    return y.to(x.dtype), None


def _bn_synced(x, a, p, s, counted: bool = True):
    """Train-mode BN on the global batch's moments (SyncBN): the mean from
    the summed per-channel sums and the summed count, then the biased
    variance from a second sum, of (x - mean)^2 (E[x^2] - E[x]^2 would
    lose f32 digits the one-process path keeps).  Both sums are
    differentiable, so the backward is SyncBN's; the running variance
    takes the unbiased correction over the global N*H*W.  A rank that
    does not count its ``x`` (``counted=False``) adds zeros, times its
    values so that the backward still runs every reduce."""
    xf = x.float()
    ch = xf.shape[1]
    own = 1.0 if counted else 0.0
    local = torch.cat([xf.sum(dim=(0, 2, 3)),
                       xf.new_full((1,), xf.numel() // ch)]) * own
    total = mesh.sum_across(local)
    count = total[ch].detach()
    mean = total[:ch] / count
    d = xf - mean[None, :, None, None]
    var = mesh.sum_across((d * d).sum(dim=(0, 2, 3)) * own) / count
    scale = torch.rsqrt(var + a["eps"]) * p["scale"].float()
    y = d * scale[None, :, None, None] + p["bias"].float()[None, :, None, None]
    m = a["momentum"]
    with torch.no_grad():
        unbiased = var * count / torch.clamp(count - 1, min=1)
        new_s = {"mean": (1 - m) * s["mean"].float() + m * mean,
                 "var": (1 - m) * s["var"].float() + m * unbiased}
    return y.to(x.dtype), new_s


def _dropout(x, node: Node, seed: Optional[int],
             bands: Optional[_Bands] = None):
    """Dropout from a mask drawn with ``seed`` on x's device; spatial
    dropout draws one value per (n, c).  The same seed gives the same
    mask, so a recomputed segment replays it.  Across ranks each rank
    draws the mask of the global batch (every rank holds the same number
    of images) and keeps its data rank's images and, under a spatial
    axis, its band's rows, so the ranks drop what one process drops on
    the global batch."""
    rate = node.attrs["rate"]
    if seed is None or rate == 0.0:
        return x
    w, r = mesh.world(), mesh.rank()
    shape = list(x.shape[1:2] + (1, 1) if node.attrs["spatial"]
                 else x.shape[1:])
    rows = None
    if bands is not None:
        s = bands.axis.size
        w, r = w // s, r // s
        rows = bands.rows(node.inputs[0])
        if rows is not None and not node.attrs["spatial"]:
            shape[1] = rows.h
        else:
            rows = None
    n = x.shape[0]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand([n * w] + shape, generator=gen,
                      device=x.device)[r * n:(r + 1) * n]
    if rows is not None:
        keep = keep[:, :, rows.lo:rows.hi]
    keep = keep < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _exec_node(node: Node, vals: Dict[str, torch.Tensor], params: Params,
               state: State, input_hw: Tuple[int, int], train: bool,
               drop_seeds: Dict[str, int], bn_updates: State,
               bands: Optional[_Bands] = None) -> torch.Tensor:
    """Execute one non-input node (NCHW); a train-mode BN puts its new
    running statistics in ``bn_updates``.  With ``bands``, on this rank's
    band (see the module docstring)."""
    op = node.op
    rows = (bands.rows(node.inputs[0]) if bands is not None and node.inputs
            else None)
    if op == "conv":
        # a second input is an epilogue's residual
        residual = vals[node.inputs[1]] if len(node.inputs) > 1 else None
        return _conv(vals[node.inputs[0]], node, params[node.name], bands,
                     residual)
    if op == "bn":
        counted = (bands is None or rows is not None
                   or bands.axis.index == 0)
        y, ns = _bn(vals[node.inputs[0]], node, params[node.name],
                    state[node.name], train, counted)
        if ns is not None:
            bn_updates[node.name] = ns
        return y
    if op == "relu":
        return torch.relu(vals[node.inputs[0]])
    if op == "sigmoid":
        return torch.sigmoid(vals[node.inputs[0]])
    if op == "mul":
        y = vals[node.inputs[0]]
        for other in node.inputs[1:]:
            y = y * vals[other]
        return y
    if op == "add":
        y = vals[node.inputs[0]]
        for other in node.inputs[1:]:
            y = y + vals[other]
        return y
    if op == "concat":
        return torch.cat([vals[i] for i in node.inputs], dim=1)
    if op == "maxpool":
        a = node.attrs
        if rows is not None:
            return spatial.halo_max_pool2d(
                vals[node.inputs[0]], rows, bands.hw[node.name][0],
                a["kernel"], a["stride"], a["padding"])
        return max_pool(vals[node.inputs[0]], a["kernel"], a["stride"],
                        a["padding"])
    if op == "avgpool":
        if rows is not None:
            return _avgpool_band(vals[node.inputs[0]], rows,
                                 bands.hw[node.inputs[0]][1],
                                 node.attrs["out_size"])
        return adaptive_avg_pool(vals[node.inputs[0]],
                                 node.attrs["out_size"])
    if op == "globalpool":
        if rows is not None:
            return _globalpool_band(vals[node.inputs[0]], rows)
        return global_avg_pool(vals[node.inputs[0]])
    if op == "resize":
        x = vals[node.inputs[0]]
        a = node.attrs
        if bands is not None and node.name not in bands.whole:
            return spatial.resize_band(x, rows, bands.hw[node.name],
                                       a["align_corners"], bands.axis)
        if "like" in a:
            like = vals[a["like"]]
            y = resize_bilinear_cf(x, like.shape[-2:], a["align_corners"])
            # in the layout of the tensor it is sized to, so that a concat
            # of the two stays channels_last on the deploy body
            if (like.is_contiguous(memory_format=torch.channels_last)
                    and not like.is_contiguous()):
                y = y.contiguous(memory_format=torch.channels_last)
            return y
        if a.get("to_input"):
            target = input_hw
        else:
            target = (int(round(x.shape[-2] * a["scale"])),
                      int(round(x.shape[-1] * a["scale"])))
        return resize_bilinear_cf(x, target, a["align_corners"])
    if op == "dropout":
        return _dropout(vals[node.inputs[0]], node,
                        drop_seeds.get(node.name) if train else None, bands)
    if op in ("identity", "barrier"):
        # a barrier only steers XLA fusion
        return vals[node.inputs[0]]
    raise NotImplementedError(f"op {op!r} ({node.name})")


def graph_apply(graph: Graph, params: Params, state: State,
                inputs: Dict[str, torch.Tensor], *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                input_hw: Optional[Tuple[int, int]] = None,
                remat_segments: int = 0, channels_first: bool = False,
                spatial_axis: Optional[spatial.Axis] = None
                ) -> Tuple[Dict[str, torch.Tensor], State]:
    """Run the graph.  Returns ({output_name: tensor}, new_state).

    Inputs and outputs are NHWC, or NCHW with ``channels_first=True``.
    ``new_state`` holds the new BN running statistics of train mode
    (other entries pass through); ``state`` itself is not changed.
    ``input_hw`` overrides the spatial size that ``resize(to_input=True)``
    nodes target (graphs re-rooted at an interior node).

    Dropout runs only with ``train=True`` and a ``generator`` (the JAX
    package's ``rng=None`` rule): one seed per dropout node is drawn
    from it, in graph order, before any node runs.

    ``remat_segments`` > 1 runs that many contiguous segments under
    ``torch.utils.checkpoint``: only the tensors live at the segment
    boundaries are kept for the backward, the rest is recomputed.  The
    recompute replays each dropout node's mask from its seed, so the
    result and the gradients are those of the plain run.

    ``spatial_axis`` (a spatial group of more than one rank): the inputs
    are this rank's bands of rows (``spatial.band`` of their global
    height) and so are the outputs, except outputs held whole (see the
    module docstring); ``input_hw``, the global (H, W) of the graph's
    input, is then required.  Every rank of the group runs the same call.
    """
    drop_seeds: Dict[str, int] = {}
    drop_nodes = [n.name for n in graph.toposorted() if n.op == "dropout"]
    if train and generator is not None and drop_nodes:
        seeds = torch.randint(0, 2 ** 62, (len(drop_nodes),),
                              generator=generator, device=generator.device)
        drop_seeds = dict(zip(drop_nodes, seeds.tolist()))

    vals = {k: v if channels_first else v.permute(0, 3, 1, 2)
            for k, v in inputs.items()}
    bands = None
    if spatial_axis is not None and spatial_axis.size > 1:
        if input_hw is None:
            raise ValueError("graph_apply(spatial_axis=...) needs input_hw, "
                             "the global (H, W) of the graph input")
        bands = _bands(graph, tuple(input_hw), spatial_axis)
    if input_hw is None:
        input_hw = tuple(vals[graph.inputs[0]].shape[-2:])
    nodes = [n for n in graph.toposorted() if n.op != "input"]

    # liveness: last index at which each tensor is consumed; a tensor is
    # freed once its last consumer has run
    last_use = {name: -1 for name in graph.inputs}
    for i, node in enumerate(nodes):
        for parent in node.inputs:
            last_use[parent] = i
        last_use[node.name] = last_use.get(node.name, -1)
    for out in graph.outputs:
        last_use[out] = len(nodes)

    def live_after(i: int):
        """Tensors that must cross the boundary after nodes[i]."""
        produced = set(graph.inputs) | {n.name for n in nodes[:i + 1]}
        return sorted(t for t in produced if last_use[t] > i)

    def run(carry, first, last, keep):
        """nodes[first:last] on ``carry``; returns ({t: tensor for t in
        keep}, that range's BN updates)."""
        v = dict(carry)
        bn_updates: State = {}
        for i in range(first, last):
            node = nodes[i]
            v[node.name] = _exec_node(node, v, params, state, input_hw,
                                      train, drop_seeds, bn_updates, bands)
            for parent in node.inputs:
                if last_use[parent] == i:
                    v.pop(parent, None)
        return {t: v[t] for t in keep}, bn_updates

    new_state: State = dict(state)
    if remat_segments > 1:
        bounds = _segment_bounds(len(nodes), remat_segments, live_after)
        for first, last in zip(bounds, bounds[1:]):
            # The recompute's BN updates go to fresh copies and are
            # dropped; no op draws from the global RNG, so it need not be
            # restored.
            vals, bn_updates = checkpoint(
                run, vals, first, last, live_after(last - 1),
                use_reentrant=False, preserve_rng_state=False)
            new_state.update(bn_updates)
    else:
        vals, bn_updates = run(vals, 0, len(nodes), graph.outputs)
        new_state.update(bn_updates)
    outputs = {name: vals[name] if channels_first
               else vals[name].permute(0, 2, 3, 1) for name in graph.outputs}
    return outputs, new_state


def _segment_bounds(n_nodes: int, n_segments: int, live_after):
    """Node indices that cut ``n_nodes`` into ``n_segments`` remat
    segments: near equal node counts, each cut nudged to the position with
    the fewest live tensors in a window (stage boundaries of a ResNet
    carry a single tensor; cutting mid-ASPP would carry five).  The JAX
    package's search, copied."""
    n_segments = min(n_segments, n_nodes)
    cuts = []
    window = max(n_nodes // (4 * n_segments), 1)
    for k in range(1, n_segments):
        target = k * n_nodes // n_segments
        lo = max(target - window, (cuts[-1] + 1) if cuts else 0)
        hi = min(target + window, n_nodes - 2)
        if lo > hi:
            continue
        best = min(range(lo, hi + 1), key=lambda i: len(live_after(i)))
        cuts.append(best)
    return [0] + [c + 1 for c in cuts] + [n_nodes]
