"""Layer-graph IR: the core model representation of dcfp_tpu_torch.

A copy of ``dcfp_tpu/graph/ir.py`` (the port keeps its own copies of the
framework-free modules and imports nothing of the JAX package).

Models are explicit DAGs of typed nodes (conv / bn / relu / add / concat /
pool / resize / ...).  This single structure serves four masters at once:

  * the forward pass  — an eager interpreter over the DAG
    (`dcfp_tpu_torch.graph.apply`);
  * the pruning engine — channel-coupling groups (residual adds, concats)
    are derived statically from edges (`dcfp_tpu_torch.prune.trace`),
    replacing the reference's fragile autograd-graph walk
    (reference: pruners/channel_pruner.py:501-737);
  * analytic FLOPs/params accounting (`dcfp_tpu_torch.utils.flops`),
    replacing the forward-hook counter (reference: utils/flops_counter.py);
  * physical channel surgery — slicing params and rewriting channel attrs
    yields a *smaller model* for deployment.

The IR is intentionally tiny: a node is (name, op, inputs, attrs).  It
carries no layout: the interpreter runs NCHW with OIHW conv kernels, and
the pruner works on HWIO numpy copies (``dcfp_tpu_torch.bridge``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Ops that preserve channel identity 1:1 from their (single) input.  Channel
# masks propagate through these untouched when tracing prune topology.
CHANNEL_PASSTHROUGH_OPS = frozenset({
    "relu", "sigmoid", "identity", "dropout", "maxpool", "avgpool",
    "globalpool", "resize", "bn",
})

# Ops that own channel dimensions (have per-channel parameters).
PARAM_OPS = frozenset({"conv", "bn"})


@dataclasses.dataclass
class Node:
    name: str
    op: str
    inputs: Tuple[str, ...]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "Node":
        n = Node(self.name, self.op, tuple(self.inputs), dict(self.attrs))
        for k, v in kw.items():
            setattr(n, k, v)
        return n


class Graph:
    """An ordered DAG.  Node insertion order must be topological."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        # Layers excluded from pruning by the model definition
        # (reference: networks/deeplabv3.py:18-19 `ignore_prune_layer`).
        self.ignore_prune: List[str] = []

    # -- construction -------------------------------------------------------
    def add(self, node: Node) -> str:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node name: {node.name}")
        for parent in node.inputs:
            if parent not in self.nodes:
                raise ValueError(
                    f"node {node.name!r} references unknown input {parent!r}"
                    " (insertion order must be topological)")
        self.nodes[node.name] = node
        return node.name

    # -- queries ------------------------------------------------------------
    def node(self, name: str) -> Node:
        return self.nodes[name]

    def consumers(self, name: str) -> List[Node]:
        return [n for n in self.nodes.values() if name in n.inputs]

    def toposorted(self) -> Iterable[Node]:
        return self.nodes.values()

    def param_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.op in PARAM_OPS]

    def conv_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.op == "conv"]

    def bn_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.op == "bn"]

    def copy(self) -> "Graph":
        g = Graph(self.name)
        g.inputs = list(self.inputs)
        g.outputs = list(self.outputs)
        g.ignore_prune = list(self.ignore_prune)
        for n in self.nodes.values():
            g.nodes[n.name] = n.replace()
        return g

    def __repr__(self):
        return (f"Graph({self.name!r}, {len(self.nodes)} nodes, "
                f"inputs={self.inputs}, outputs={self.outputs})")


class GraphBuilder:
    """Convenience builder used by model definitions.

    Methods return the name of the node they created, so model code reads
    like straight-line tensor programs::

        b = GraphBuilder("fcn")
        x = b.input("image")
        x = b.conv(x, "stem.conv", out_ch=64, kernel=3, stride=2)
        x = b.bn(x, "stem.bn")
        x = b.relu(x, "stem.relu")
    """

    def __init__(self, name: str = "graph"):
        self.g = Graph(name)
        self._channels: Dict[str, int] = {}
        self._auto = 0

    # -- plumbing -----------------------------------------------------------
    def _name(self, name: Optional[str], op: str) -> str:
        if name is None:
            self._auto += 1
            name = f"_{op}{self._auto}"
        return name

    def channels(self, node: str) -> int:
        return self._channels[node]

    def input(self, name: str = "image", channels: int = 3) -> str:
        self.g.add(Node(name, "input", (), {"channels": channels}))
        self.g.inputs.append(name)
        self._channels[name] = channels
        return name

    def output(self, node: str, alias: Optional[str] = None) -> str:
        self.g.outputs.append(node)
        return node

    # -- layers -------------------------------------------------------------
    def conv(self, x: str, name: Optional[str] = None, *, out_ch: int,
             kernel: int = 3, stride: int = 1, dilation: int = 1,
             padding: Optional[int] = None, groups: int = 1,
             bias: bool = False) -> str:
        """2-D conv, torch-style symmetric integer padding.

        Default padding keeps 'same' spatial size at stride 1 for odd
        kernels: pad = dilation * (kernel - 1) // 2.
        """
        name = self._name(name, "conv")
        if padding is None:
            padding = dilation * (kernel - 1) // 2
        in_ch = self._channels[x]
        self.g.add(Node(name, "conv", (x,), {
            "in_ch": in_ch, "out_ch": out_ch, "kernel": int(kernel),
            "stride": int(stride), "dilation": int(dilation),
            "padding": int(padding), "groups": int(groups),
            "bias": bool(bias),
        }))
        self._channels[name] = out_ch
        return name

    def bn(self, x: str, name: Optional[str] = None, *, eps: float = 1e-5,
           momentum: float = 0.1) -> str:
        name = self._name(name, "bn")
        ch = self._channels[x]
        self.g.add(Node(name, "bn", (x,), {
            "channels": ch, "eps": eps, "momentum": momentum}))
        self._channels[name] = ch
        return name

    def relu(self, x: str, name: Optional[str] = None) -> str:
        name = self._name(name, "relu")
        self.g.add(Node(name, "relu", (x,), {}))
        self._channels[name] = self._channels[x]
        return name

    def conv_bn_relu(self, x: str, prefix: str, **conv_kw) -> str:
        x = self.conv(x, f"{prefix}.conv", **conv_kw)
        x = self.bn(x, f"{prefix}.bn")
        return self.relu(x, f"{prefix}.relu")

    def add_(self, xs: Sequence[str], name: Optional[str] = None) -> str:
        name = self._name(name, "add")
        chs = {self._channels[x] for x in xs}
        if len(chs) != 1:
            raise ValueError(f"add {name}: mismatched channels {chs}")
        self.g.add(Node(name, "add", tuple(xs), {}))
        self._channels[name] = chs.pop()
        return name

    def concat(self, xs: Sequence[str], name: Optional[str] = None) -> str:
        name = self._name(name, "concat")
        self.g.add(Node(name, "concat", tuple(xs), {}))
        self._channels[name] = sum(self._channels[x] for x in xs)
        return name

    def maxpool(self, x: str, name: Optional[str] = None, *, kernel: int = 3,
                stride: int = 2, padding: int = 1) -> str:
        name = self._name(name, "maxpool")
        self.g.add(Node(name, "maxpool", (x,), {
            "kernel": kernel, "stride": stride, "padding": padding}))
        self._channels[name] = self._channels[x]
        return name

    def adaptive_avgpool(self, x: str, name: Optional[str] = None, *,
                         out_size: int = 1) -> str:
        """AdaptiveAvgPool2d to (out_size, out_size)."""
        name = self._name(name, "avgpool")
        self.g.add(Node(name, "avgpool", (x,), {"out_size": int(out_size)}))
        self._channels[name] = self._channels[x]
        return name

    def globalpool(self, x: str, name: Optional[str] = None) -> str:
        name = self._name(name, "globalpool")
        self.g.add(Node(name, "globalpool", (x,), {}))
        self._channels[name] = self._channels[x]
        return name

    def resize(self, x: str, name: Optional[str] = None, *,
               like: Optional[str] = None, to_input: bool = False,
               scale: Optional[float] = None,
               align_corners: bool = False) -> str:
        """Bilinear resize.  Target is another node's spatial size (`like`),
        the graph input's size (`to_input`), or a fixed scale factor."""
        name = self._name(name, "resize")
        attrs = {"align_corners": bool(align_corners)}
        if like is not None:
            attrs["like"] = like
            inputs = (x, like)
        elif to_input:
            attrs["to_input"] = True
            inputs = (x,)
        else:
            attrs["scale"] = float(scale)
            inputs = (x,)
        self.g.add(Node(name, "resize", inputs, attrs))
        self._channels[name] = self._channels[x]
        return name

    def dropout(self, x: str, name: Optional[str] = None, *,
                rate: float = 0.1, spatial: bool = True) -> str:
        """Dropout; `spatial=True` drops whole channels (torch Dropout2d)."""
        name = self._name(name, "dropout")
        self.g.add(Node(name, "dropout", (x,),
                        {"rate": float(rate), "spatial": bool(spatial)}))
        self._channels[name] = self._channels[x]
        return name

    def sigmoid(self, x: str, name: Optional[str] = None) -> str:
        name = self._name(name, "sigmoid")
        self.g.add(Node(name, "sigmoid", (x,), {}))
        self._channels[name] = self._channels[x]
        return name

    def mul(self, xs: Sequence[str], name: Optional[str] = None) -> str:
        """Elementwise (broadcasting) multiply; channels follow the first
        operand (used for SE-style channel gating)."""
        name = self._name(name, "mul")
        self.g.add(Node(name, "mul", tuple(xs), {}))
        self._channels[name] = self._channels[xs[0]]
        return name

    def identity(self, x: str, name: Optional[str] = None) -> str:
        name = self._name(name, "identity")
        self.g.add(Node(name, "identity", (x,), {}))
        self._channels[name] = self._channels[x]
        return name

    def finish(self, outputs: Sequence[str]) -> Graph:
        self.g.outputs = list(outputs)
        return self.g
