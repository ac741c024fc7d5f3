"""Interpreter + initializer for the layer-graph IR (eager PyTorch).

Port of ``dcfp_tpu/graph/apply.py``.  ``graph_apply`` walks the DAG once
per call.  Inside, tensors are NCHW and conv kernels OIHW (PyTorch's own
layouts; on the GPU the deploy path hands it ``channels_last`` tensors so
cuDNN runs NHWC underneath).  At the boundary it takes and returns NHWC
like the JAX package, unless ``channels_first=True``.

Only eval mode is ported: BN uses running statistics and dropout is the
identity.  Train mode (batch moments, dropout, remat) arrives with the
train step.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.graph.ir import Graph, Node
from dcfp_tpu_torch.ops.pool import (adaptive_avg_pool, global_avg_pool,
                                     max_pool)
from dcfp_tpu_torch.ops.resize import resize_bilinear_cf

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
# apply
# ---------------------------------------------------------------------------

def _conv(x, node: Node, p):
    # A plain dilated conv at every rate: the JAX package rewrites rates
    # >= 18 as nine shifted matmuls only because the TPU's native dilated
    # conv is slow there; the two are equal up to summation order.
    a = node.attrs
    bias = p["bias"].to(x.dtype) if a["bias"] else None
    return F.conv2d(x, p["kernel"].to(x.dtype), bias, stride=a["stride"],
                    padding=a["padding"], dilation=a["dilation"],
                    groups=a["groups"])


def _bn(x, node: Node, p, s):
    """Eval-mode BN from running statistics, computed in float32."""
    inv = torch.rsqrt(s["var"].float() + node.attrs["eps"]) * \
        p["scale"].float()
    shift = p["bias"].float() - s["mean"].float() * inv
    y = x.float() * inv[:, None, None] + shift[:, None, None]
    return y.to(x.dtype)


def _exec_node(node: Node, vals: Dict[str, torch.Tensor], params: Params,
               state: State, input_hw: Tuple[int, int]) -> torch.Tensor:
    """Execute one non-input node (eval mode, NCHW)."""
    op = node.op
    if op == "conv":
        return _conv(vals[node.inputs[0]], node, params[node.name])
    if op == "bn":
        return _bn(vals[node.inputs[0]], node, params[node.name],
                   state[node.name])
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
        return max_pool(vals[node.inputs[0]], a["kernel"], a["stride"],
                        a["padding"])
    if op == "avgpool":
        return adaptive_avg_pool(vals[node.inputs[0]],
                                 node.attrs["out_size"])
    if op == "globalpool":
        return global_avg_pool(vals[node.inputs[0]])
    if op == "resize":
        x = vals[node.inputs[0]]
        a = node.attrs
        if "like" in a:
            target = tuple(vals[a["like"]].shape[-2:])
        elif a.get("to_input"):
            target = input_hw
        else:
            target = (int(round(x.shape[-2] * a["scale"])),
                      int(round(x.shape[-1] * a["scale"])))
        return resize_bilinear_cf(x, target, a["align_corners"])
    if op in ("dropout", "identity", "barrier"):
        # eval dropout is the identity; a barrier only steers XLA fusion
        return vals[node.inputs[0]]
    raise NotImplementedError(f"op {op!r} ({node.name})")


def graph_apply(graph: Graph, params: Params, state: State,
                inputs: Dict[str, torch.Tensor], *, train: bool = False,
                input_hw: Optional[Tuple[int, int]] = None,
                remat_segments: int = 0, channels_first: bool = False
                ) -> Tuple[Dict[str, torch.Tensor], State]:
    """Run the graph.  Returns ({output_name: tensor}, state).

    Inputs and outputs are NHWC, or NCHW with ``channels_first=True``.
    ``input_hw`` overrides the spatial size that ``resize(to_input=True)``
    nodes target (graphs re-rooted at an interior node).  Activations are
    freed as soon as their last consumer has run.
    """
    if train:
        raise NotImplementedError("graph_apply(train=True) is not ported yet")
    if remat_segments > 1:
        raise NotImplementedError("remat is not ported yet")

    vals: Dict[str, torch.Tensor] = {}
    refs: Dict[str, int] = {}
    for node in graph.toposorted():
        for parent in node.inputs:
            refs[parent] = refs.get(parent, 0) + 1
    for out in set(graph.outputs) | set(graph.inputs):
        refs[out] = refs.get(out, 0) + 1

    for node in graph.toposorted():
        if node.op == "input":
            y = inputs[node.name]
            if not channels_first:
                y = y.permute(0, 3, 1, 2)
            if input_hw is None:
                input_hw = (y.shape[-2], y.shape[-1])
        else:
            y = _exec_node(node, vals, params, state, input_hw)
        vals[node.name] = y
        for parent in node.inputs:
            refs[parent] -= 1
            if refs[parent] == 0:
                del vals[parent]

    outputs = {name: vals[name] if channels_first
               else vals[name].permute(0, 2, 3, 1) for name in graph.outputs}
    return outputs, dict(state)
