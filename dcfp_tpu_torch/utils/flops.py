"""Analytic FLOPs / params accounting over the layer-graph IR.

Formula-compatible with the reference's forward-hook counter
(utils/flops_counter.py:376-471): conv = k*k*(Cin/groups)*Cout*Hout*Wout
(+ bias adds), BN = 2x elements, ReLU modules = elements, pools = input
elements; functional interpolate/add/concat contribute zero there and zero
here, so pruned/baseline FLOPs *ratios* — which drive the prune search
(prune.py:112-116) — match the reference exactly.
"""

from __future__ import annotations

from typing import Dict, Tuple

from dcfp_tpu_torch.graph.ir import Graph
from dcfp_tpu_torch.graph.shapes import infer_shapes


def count_flops_params(graph: Graph, input_hw: Tuple[int, int],
                       batch: int = 1) -> Tuple[int, int]:
    """(MAC-flops, params) at the given input size, reference conventions."""
    hw = infer_shapes(graph, input_hw)
    flops = 0
    params = 0
    for node in graph.toposorted():
        op = node.op
        if op == "conv":
            a = node.attrs
            oh, ow = hw[node.name]
            per_pos = (a["kernel"] * a["kernel"] *
                       (a["in_ch"] // a["groups"]) * a["out_ch"])
            active = batch * oh * ow
            flops += per_pos * active
            params += (a["kernel"] * a["kernel"] *
                       (a["in_ch"] // a["groups"]) * a["out_ch"])
            if a["bias"]:
                flops += a["out_ch"] * active
                params += a["out_ch"]
        elif op == "bn":
            ih, iw = hw[node.inputs[0]]
            ch = node.attrs["channels"]
            flops += 2 * batch * ch * ih * iw  # affine norm: 2x elements
            params += 2 * ch
        elif op == "relu":
            ih, iw = hw[node.name]
            # channel count: walk to the producing node's channel attr
            flops += batch * ih * iw * _channels(graph, node.name)
        elif op in ("maxpool", "avgpool", "globalpool"):
            ih, iw = hw[node.inputs[0]]
            flops += batch * ih * iw * _channels(graph, node.inputs[0])
        # add/concat/resize/dropout/identity: 0 (functional in reference)
    return flops, params


def _channels(graph: Graph, name: str) -> int:
    """Channel count of a node's output, derived by walking producers."""
    seen = set()
    while True:
        node = graph.node(name)
        if node.op == "input":
            return node.attrs["channels"]
        if node.op == "conv":
            return node.attrs["out_ch"]
        if node.op == "bn":
            return node.attrs["channels"]
        if node.op == "concat":
            return sum(_channels(graph, i) for i in node.inputs)
        if name in seen:
            raise RuntimeError(f"cycle at {name}")
        seen.add(name)
        name = node.inputs[0]


def flops_to_string(flops: int) -> str:
    if flops >= 1e9:
        return f"{flops / 1e9:.2f} GFLOPs"
    if flops >= 1e6:
        return f"{flops / 1e6:.2f} MFLOPs"
    return f"{flops} FLOPs"



def cost_analysis(fn, *example_args) -> Dict[str, float]:
    """The floating-point operations of ``fn(*example_args)``, counted by
    PyTorch (``torch.utils.flop_counter.FlopCounterMode``; the port's
    counterpart of the JAX package's ``xla_cost_analysis``).  These are
    PyTorch's counts, not XLA's: 2 per multiply-accumulate of the convs,
    matmuls and attention it has formulas for, nothing for elementwise
    ops, and no bytes accessed.  Returns ``{"flops": total}`` and one
    ``"flops:<op>"`` entry an aten op; ``fn`` runs once, on whatever
    device its arguments are."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*example_args)
    out = {"flops": float(counter.get_total_flops())}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        out[f"flops:{op}"] = float(n)
    return out
