"""Channel-coupling topology from the layer-graph IR.

The reference discovers which convs must share a pruning mask by walking
PyTorch's private autograd graph (channel_pruner.py:501-737, pinned to
torch 1.10 grad_fn class names).  Here the same facts are read directly
off the model DAG:

* every tensor's *channel sources* are computed by propagating a segment
  descriptor through the graph (conv introduces a fresh source; concat
  concatenates; elementwise add/mul unifies via union-find — the
  residual-coupling rule of channel_pruner.py:349-373);
* BN <-> conv pairing is the direct edge (channel_pruner.py:522-614);
* each conv's input segmentation (for concat-aware in-masks and bias
  compensation, channel_pruner.py:810-819/:861-905) is the descriptor of
  its input node.

The result is exact, static, and model-agnostic: any graph built from the
IR — including HRNet's dense fusion lattice — is prunable without
model-specific metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from dcfp_tpu_torch.graph.ir import CHANNEL_PASSTHROUGH_OPS, Graph


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous channel range sourced from one prune-space (or the
    graph input / any unprunable source)."""
    space: Optional[str]  # union-find root conv name, or None (unprunable)
    size: int


@dataclasses.dataclass
class Topology:
    # space id -> member conv names (couple via residual adds)
    spaces: Dict[str, List[str]]
    # conv name -> its space id (only convs that own channels)
    conv_space: Dict[str, str]
    # bn name -> conv it normalizes / inverse
    norm_conv: Dict[str, str]
    conv_norm: Dict[str, str]
    # conv name -> input segmentation (post-grouping)
    in_segments: Dict[str, List[Segment]]
    # protected spaces: channels feed a graph output through no conv, or
    # are joined elementwise with unprunable channels (their width is
    # pinned from outside, so the pruner must keep them whole)
    output_spaces: List[str]


class _UnionFind:
    def __init__(self):
        self.parent: Dict[str, str] = {}

    def find(self, x: str) -> str:
        self.parent.setdefault(x, x)
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: str, b: str):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def trace_topology(graph: Graph) -> Topology:
    uf = _UnionFind()
    # descriptor: list of (source, size); source is conv name or None
    desc: Dict[str, List[Tuple[Optional[str], int]]] = {}
    # spaces joined elementwise with unprunable channels: their width is
    # pinned by the other operand, so they must not shrink
    pinned: List[str] = []

    def unify(a, b, where):
        if len(a) != len(b) or any(sa != sb for (_, sa), (_, sb)
                                   in zip(a, b)):
            raise ValueError(
                f"{where}: elementwise op joins incongruent channel "
                f"segmentations {a} vs {b}")
        out = []
        for (ca, sa), (cb, _) in zip(a, b):
            if ca is None or cb is None:
                keep = cb if ca is None else ca
                if keep is not None:
                    pinned.append(keep)
                out.append((None, sa))  # unprunable wins
            else:
                uf.union(ca, cb)
                out.append((ca, sa))
        return out

    for node in graph.toposorted():
        op = node.op
        if op == "input":
            desc[node.name] = [(None, node.attrs["channels"])]
        elif op == "conv":
            groups = node.attrs.get("groups", 1)
            if groups == 1:
                desc[node.name] = [(node.name, node.attrs["out_ch"])]
            elif (groups == node.attrs["in_ch"]
                  and node.attrs["out_ch"] == node.attrs["in_ch"]):
                # depthwise: channels map 1:1, so the conv joins its
                # parent's coupling group (the reference's depthwise
                # parser, channel_pruner.py:324-329) and shares its mask
                d = desc[node.inputs[0]]
                if len(d) != 1 or d[0][0] is None:
                    raise NotImplementedError(
                        f"trace: depthwise conv {node.name!r} over a "
                        "concat or unprunable input")
                uf.union(d[0][0], node.name)
                desc[node.name] = [(node.name, node.attrs["out_ch"])]
            else:
                raise NotImplementedError(
                    f"trace: grouped conv {node.name!r} with "
                    f"1 < groups < in_ch (the reference's pruner does "
                    "not support these either, channel_pruner.py:934)")
        elif op == "concat":
            d: List[Tuple[Optional[str], int]] = []
            for i in node.inputs:
                d.extend(desc[i])
            desc[node.name] = d
        elif op in ("add", "mul"):
            d = desc[node.inputs[0]]
            for other in node.inputs[1:]:
                d = unify(d, desc[other], node.name)
            desc[node.name] = d
        elif op in CHANNEL_PASSTHROUGH_OPS:
            desc[node.name] = desc[node.inputs[0]]
        else:
            raise NotImplementedError(f"trace: op {node.op!r}")

    # resolve union-find roots
    def resolved(d):
        return [Segment(None if c is None else uf.find(c), s) for c, s in d]

    conv_space = {c.name: uf.find(c.name) for c in graph.conv_nodes()}
    spaces: Dict[str, List[str]] = {}
    for conv, sp in conv_space.items():
        spaces.setdefault(sp, []).append(conv)

    in_segments = {c.name: resolved(desc[c.inputs[0]])
                   for c in graph.conv_nodes()}

    # BN <-> conv: the BN's input descriptor must be a single conv segment
    norm_conv: Dict[str, str] = {}
    for bn in graph.bn_nodes():
        # walk straight up through passthrough ops to the producing conv
        cur = bn.inputs[0]
        while graph.node(cur).op in CHANNEL_PASSTHROUGH_OPS:
            cur = graph.node(cur).inputs[0]
        if graph.node(cur).op == "conv":
            norm_conv[bn.name] = cur
    conv_norm = {v: k for k, v in norm_conv.items()}

    # spaces reaching a graph output without an intervening conv are
    # protected (their channel count is externally visible, e.g. logits),
    # as are spaces pinned by an elementwise join with unprunable channels
    output_spaces = [uf.find(c) for c in pinned]
    for out in graph.outputs:
        for sp, size in {(c, s) for c, s in
                         [(seg.space, seg.size) for seg in resolved(
                             desc[out])]}:
            if sp is not None:
                output_spaces.append(sp)

    return Topology(spaces=spaces, conv_space=conv_space,
                    norm_conv=norm_conv, conv_norm=conv_norm,
                    in_segments=in_segments,
                    output_spaces=sorted(set(output_spaces)))
