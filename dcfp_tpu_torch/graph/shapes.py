"""Static shape inference over the layer-graph IR (spatial dims only)."""

from __future__ import annotations

from typing import Dict, Tuple

from dcfp_tpu_torch.graph.ir import Graph


def infer_shapes(graph: Graph, input_hw: Tuple[int, int]
                 ) -> Dict[str, Tuple[int, int]]:
    """Per-node (H, W) given the graph-input spatial size."""
    hw: Dict[str, Tuple[int, int]] = {}
    for node in graph.toposorted():
        op = node.op
        if op == "input":
            hw[node.name] = tuple(input_hw)
        elif op in ("conv", "maxpool"):
            h, w = hw[node.inputs[0]]
            a = node.attrs
            k, s, p = a["kernel"], a["stride"], a["padding"]
            d = a.get("dilation", 1)
            eff = d * (k - 1) + 1
            hw[node.name] = ((h + 2 * p - eff) // s + 1,
                             (w + 2 * p - eff) // s + 1)
        elif op == "avgpool":
            o = node.attrs["out_size"]
            hw[node.name] = (o, o)
        elif op == "globalpool":
            hw[node.name] = (1, 1)
        elif op == "resize":
            a = node.attrs
            if "like" in a:
                hw[node.name] = hw[a["like"]]
            elif a.get("to_input"):
                hw[node.name] = tuple(input_hw)
            else:
                h, w = hw[node.inputs[0]]
                hw[node.name] = (int(round(h * a["scale"])),
                                 int(round(w * a["scale"])))
        else:  # channel-preserving elementwise / concat / add / mul
            hw[node.name] = hw[node.inputs[0]]
    return hw
