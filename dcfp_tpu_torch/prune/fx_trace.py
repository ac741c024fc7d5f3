"""Channel-topology discovery from the traced forward (port of
``dcfp_tpu/prune/jaxpr_trace.py``).

The reference discovers conv coupling by walking torch's autograd graph
(channel_pruner.py:501-737, pinned to torch-1.10 grad_fn class names).
The JAX package walks the jaxpr of its forward; the port walks the aten
graph of its own eval forward: ``trace_topology_fx`` captures
``graph_apply(..., train=False)`` with
``torch.fx.experimental.proxy_tensor.make_fx`` on fake tensors (no
value is computed, so a trace at 512x512 costs only the trace) and
propagates a channel descriptor through every aten op:
``aten.convolution`` opens a fresh channel space, elementwise joins of
two activations union their spaces (residual adds, SE gates), ``cat``
on the channel axis splices segments, and pools, resizes, means, views
and permutes carry the channels through.  It emits the same
:class:`~dcfp_tpu_torch.prune.trace.Topology` the declared-IR tracer
produces, and never reads the IR's declared topology: the graph only
supplies the forward and the names of its BN nodes.

A view may merge the channel axis with its neighbours (the resize's and
the adaptive pool's einsums become permute / view / bmm / view): an
activation's channels are located by their axis and ``inner``, the
product of the sizes merged after them in that axis, so a view that
merges them and the view that splits them again both map exactly.

BN pairing falls out of the arithmetic: the port's eval-mode BatchNorm is
``x * inv + shift`` with ``inv = rsqrt(var + eps) * scale``
(``graph/apply._bn``), a broadcast multiply whose (C,) operand derives
from a BN scale parameter; the multiply links that BN to the conv space
flowing through ``x`` (the reference's trace_norm_conv_links,
channel_pruner.py:522-614).

The prune CLI's and ``prune_to_flops``'s ``trace="jaxpr"`` names this
derivation: the flag keeps the JAX package's spelling so that the
scripts' commands run unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Dict, List, Optional, Tuple

import torch

from dcfp_tpu_torch.prune.trace import Segment, Topology, _UnionFind

Seg = Tuple[Optional[str], int]  # (source conv name | None, size)

aten = torch.ops.aten


@dataclasses.dataclass(frozen=True)
class _Act:
    """Activation descriptor: the axis that holds the channels, the
    product of the sizes merged after them in that axis (``inner``, 1
    unless a view merged them), and the channel segmentation (source
    conv per contiguous range)."""
    axis: int
    segs: Tuple[Seg, ...]
    inner: int = 1

    @property
    def channels(self) -> int:
        return sum(s for _, s in self.segs)


@dataclasses.dataclass(frozen=True)
class _Vec:
    """Per-channel vector derived from params/state (BN scale chains,
    conv biases): the contributing (node, key) paths, and where its
    channels lie (as in :class:`_Act`)."""
    paths: frozenset
    axis: int
    size: int
    inner: int = 1


@dataclasses.dataclass(frozen=True)
class _Kernel:
    name: str  # conv node whose kernel this value is


# the aten ops the port's eval forward traces to (``graph_apply``,
# ``train=False``, float32); any other op that a traced value reaches
# raises, naming it
_UNARY = {aten.relu.default, aten.sigmoid.default, aten.rsqrt.default,
          aten.clone.default, aten._to_copy.default,
          aten.lift_fresh_copy.default}
_BINARY = {aten.add.Tensor, aten.sub.Tensor, aten.mul.Tensor,
           aten.div.Tensor}
_VIEWS = {aten.view.default, aten._unsafe_view.default}


def _shape(node) -> Tuple[int, ...]:
    val = node.meta.get("val")
    return tuple(int(d) for d in val.shape)


def _remap_view(axis: int, size: int, inner: int, old: Tuple[int, ...],
                new: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    """Where ``size`` channels at ``axis`` (``inner`` merged after them)
    of a row-major ``old`` shape lie after a view to ``new``: (axis,
    inner), or None when the view splits them over several axes."""
    stride = inner * math.prod(old[axis + 1:])
    span = stride * size
    for a in range(len(new)):
        below = math.prod(new[a + 1:])
        block = below * new[a]
        if (new[a] > 1 or size == 1) and stride % below == 0 \
                and block % span == 0:
            return a, stride // below
    return None


class _FxTracer:
    def __init__(self, bn_names):
        self.uf = _UnionFind()
        self.bn_names = bn_names  # node names that are BNs
        self.conv_in: Dict[str, Tuple[Seg, ...]] = {}
        self.norm_conv: Dict[str, str] = {}
        self.env: Dict[Any, Any] = {}
        # spaces joined elementwise with unprunable channels (width pinned
        # by the other operand) — resolved into output_spaces at assembly
        self.pinned: List[str] = []

    def read(self, arg):
        if isinstance(arg, torch.fx.Node):
            return self.env.get(arg)
        return None

    # -- union semantics (trace.py:77-90) --------------------------------
    def _unify(self, a: Tuple[Seg, ...], b: Tuple[Seg, ...], where: str
               ) -> Tuple[Seg, ...]:
        if len(a) != len(b) or any(sa != sb for (_, sa), (_, sb)
                                   in zip(a, b)):
            raise ValueError(
                f"{where}: elementwise op joins incongruent channel "
                f"segmentations {a} vs {b}")
        out: List[Seg] = []
        for (ca, sa), (cb, _) in zip(a, b):
            if ca is None or cb is None:
                keep = cb if ca is None else ca
                if keep is not None:
                    self.pinned.append(keep)
                out.append((None, sa))
            else:
                self.uf.union(ca, cb)
                out.append((ca, sa))
        return tuple(out)

    # -- per-op rules ----------------------------------------------------
    def eval_node(self, node):
        self.env[node] = self._rule(node)

    def _rule(self, node):
        fn, args = node.target, node.args
        invals = [self.read(a) for a in args]
        if fn is operator.getitem:
            v = invals[0]
            return v[args[1]] if isinstance(v, tuple) else None
        if not any(self.read(a) is not None for a in
                   torch.utils._pytree.tree_leaves((args, node.kwargs))):
            return None  # constants: interpolation and pooling matrices
        if fn in _UNARY:
            return invals[0]
        if fn in _BINARY:
            return self._binary(node, invals)
        if fn is aten.convolution.default:
            return self._conv(node, invals)
        if fn in _VIEWS:
            return self._view(node, invals[0])
        if fn is aten.permute.default:
            v = invals[0]
            perm = [d % len(args[1]) for d in args[1]]
            return dataclasses.replace(v, axis=perm.index(v.axis))
        if fn is aten.unsqueeze.default:
            v = invals[0]
            d = args[1] % len(_shape(node))
            return dataclasses.replace(v, axis=v.axis + (d <= v.axis))
        if fn is aten.bmm.default:
            return self._bmm(node, invals)
        if fn is aten.cat.default:
            return self._cat(node, [self.read(a) for a in args[0]])
        if fn is aten.max_pool2d_with_indices.default:
            v = invals[0]
            if isinstance(v, _Act) and v.axis < len(_shape(args[0])) - 2:
                return (v, None)
            return (None, None)
        if fn is aten.mean.dim:
            return self._reduce(node, invals[0])
        raise NotImplementedError(
            f"fx tracer: no rule for {fn} ({node.name})")

    def _binary(self, node, invals):
        rank = len(_shape(node))

        def aligned(v, arg):
            return dataclasses.replace(
                v, axis=v.axis + rank - len(_shape(arg)))

        acts = [aligned(v, a) for v, a in zip(invals, node.args)
                if isinstance(v, _Act)]
        vecs = [aligned(v, a) for v, a in zip(invals, node.args)
                if isinstance(v, _Vec)]
        if len(acts) >= 2:
            segs = acts[0].segs
            for other in acts[1:]:
                if (other.axis, other.inner) != (acts[0].axis,
                                                 acts[0].inner):
                    raise ValueError(
                        f"{node.name}: elementwise op joins channels on "
                        "different axes")
                segs = self._unify(segs, other.segs, node.name)
            return dataclasses.replace(acts[0], segs=segs)
        if acts:
            act = acts[0]
            if node.target in (aten.add.Tensor, aten.mul.Tensor):
                for v in vecs:
                    if (v.axis, v.inner, v.size) == (act.axis, act.inner,
                                                     act.channels):
                        self._maybe_norm_link(v, act)
            return act
        if vecs:
            paths = frozenset().union(*(v.paths for v in vecs))
            return dataclasses.replace(vecs[0], paths=paths)
        return None

    def _conv(self, node, invals):
        lhs, rhs = invals[0], invals[1]
        groups = node.args[8]
        if not isinstance(rhs, _Kernel):
            raise NotImplementedError(
                f"{node.name}: conv kernel is not a traced parameter leaf")
        name = rhs.name
        in_ch = _shape(node.args[0])[1]
        out_ch = _shape(node)[1]
        if isinstance(lhs, _Act) and (lhs.axis, lhs.inner,
                                      lhs.channels) != (1, 1, in_ch):
            raise NotImplementedError(
                f"{node.name}: conv input channels are not its axis 1")
        if groups != 1:
            if not (groups == in_ch == out_ch):
                raise NotImplementedError(
                    "grouped conv with 1 < groups < in_ch (the "
                    "reference's pruner does not support these "
                    "either, channel_pruner.py:934)")
            # depthwise: joins its parent's coupling group (the
            # reference's depthwise parser, channel_pruner.py:324-329)
            if (not isinstance(lhs, _Act) or len(lhs.segs) != 1
                    or lhs.segs[0][0] is None):
                raise NotImplementedError(
                    "depthwise conv over a concat or unprunable input")
            self.uf.union(lhs.segs[0][0], name)
        self.conv_in[name] = (lhs.segs if isinstance(lhs, _Act)
                              else ((None, in_ch),))
        return _Act(1, ((name, out_ch),))

    def _view(self, node, v):
        if not isinstance(v, (_Act, _Vec)):
            return None
        size = v.channels if isinstance(v, _Act) else v.size
        where = _remap_view(v.axis, size, v.inner, _shape(node.args[0]),
                            _shape(node))
        if where is None:
            return None
        return dataclasses.replace(v, axis=where[0], inner=where[1])

    def _bmm(self, node, invals):
        """(B, N, K) @ (B, K, M): channels on a kept axis carry over (every
        kept axis keeps its index in the result); contracted channels
        make the result opaque."""
        if all(isinstance(v, _Act) for v in invals[:2]):
            raise NotImplementedError(
                f"{node.name}: product of two traced activations")
        for side, v in enumerate(invals[:2]):
            if isinstance(v, (_Act, _Vec)):
                return None if v.axis == (2 if side == 0 else 1) else v
        return None

    def _cat(self, node, parts):
        dim = node.args[1] if len(node.args) > 1 else 0
        dim %= len(_shape(node))
        if not all(isinstance(a, _Act) for a in parts):
            return None
        if all((a.axis, a.inner, a.channels) == (dim, 1, _shape(n)[dim])
               for a, n in zip(parts, node.args[0])):
            segs: List[Seg] = []
            for a in parts:
                segs.extend(a.segs)
            return _Act(dim, tuple(segs))
        # concat along another axis: all parts must share one
        # segmentation
        segs = parts[0].segs
        for a in parts[1:]:
            segs = self._unify(segs, a.segs, node.name)
        return dataclasses.replace(parts[0], segs=segs)

    def _reduce(self, node, v):
        if not isinstance(v, (_Act, _Vec)):
            return None
        rank = len(_shape(node.args[0]))
        dims = [d % rank for d in node.args[1]]
        if v.axis in dims:
            return None
        keep = len(node.args) > 2 and node.args[2]
        shift = 0 if keep else sum(1 for d in dims if d < v.axis)
        return dataclasses.replace(v, axis=v.axis - shift)

    # -- BN pairing ------------------------------------------------------
    def _maybe_norm_link(self, vec: _Vec, act: _Act):
        bn_names = {name for name, key in vec.paths
                    if key == "scale" and name in self.bn_names}
        if len(bn_names) != 1:
            return
        bn = next(iter(bn_names))
        if len(act.segs) == 1 and act.segs[0][0] is not None:
            self.norm_conv.setdefault(bn, act.segs[0][0])


def _fake_tree(tree, mode):
    """Fake tensors of the port's shapes for a params/state tree of the
    port's tensors or of the JAX package's numpy arrays (HWIO kernels)."""
    out = {}
    with mode:
        for n, d in tree.items():
            out[n] = {}
            for k, v in d.items():
                shape = tuple(v.shape)
                if (not isinstance(v, torch.Tensor) and k == "kernel"
                        and len(shape) == 4):
                    shape = (shape[3], shape[2], shape[0], shape[1])
                out[n][k] = torch.empty(shape, dtype=torch.float32)
    return out


def _trace_fx(graph, params, state, input_shape):
    """The aten graph (a ``torch.fx.GraphModule``) of ``graph``'s eval
    forward on an NHWC image of ``input_shape``, traced on fake tensors,
    and the (node, key) path of each param/state placeholder."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from dcfp_tpu_torch.graph.apply import graph_apply

    mode = FakeTensorMode()
    fp, fs = _fake_tree(params, mode), _fake_tree(state, mode)
    with mode:
        image = torch.empty(tuple(input_shape), dtype=torch.float32)

    def fwd(params, state, image):
        outs, _ = graph_apply(graph, params, state, {"image": image},
                              train=False)
        return outs

    gm = make_fx(fwd, tracing_mode="fake")(fp, fs, image)
    leaves, _ = torch.utils._pytree.tree_flatten_with_path((fp, fs))
    paths = [(p[-2].key, p[-1].key) for p, _ in leaves]
    return gm, paths


def trace_topology_fx(graph, params, state,
                      input_shape=(1, 65, 65, 3)) -> Topology:
    """Derive the channel topology of ``graph`` by walking the aten graph
    of its eval forward — no use of the declared IR topology.

    ``params``/``state`` are the port's tensors or the JAX package's
    numpy arrays (only their shapes are read); ``input_shape`` is NHWC.
    """
    gm, paths = _trace_fx(graph, params, state, input_shape)
    tracer = _FxTracer({n.name for n in graph.bn_nodes()})
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    assert len(placeholders) == len(paths) + 1, (len(placeholders),
                                                 len(paths))
    for node, (name, key) in zip(placeholders, paths):
        if key == "kernel":
            tracer.env[node] = _Kernel(name)
        else:
            shape = _shape(node)
            tracer.env[node] = _Vec(frozenset({(name, key)}), 0,
                                    shape[0] if shape else 1)
    tracer.env[placeholders[-1]] = _Act(len(input_shape) - 1,
                                        ((None, int(input_shape[-1])),))
    outputs = []
    for node in gm.graph.nodes:
        if node.op == "call_function":
            tracer.eval_node(node)
        elif node.op == "output":
            outputs = torch.utils._pytree.tree_leaves(node.args[0])

    # -- assemble the Topology (same resolution as trace.py:113-149) -----
    uf = tracer.uf

    def resolved(segs):
        return [Segment(None if c is None else uf.find(c), s)
                for c, s in segs]

    conv_space = {name: uf.find(name) for name in tracer.conv_in}
    spaces: Dict[str, List[str]] = {}
    for conv, sp in conv_space.items():
        spaces.setdefault(sp, []).append(conv)
    in_segments = {name: resolved(segs)
                   for name, segs in tracer.conv_in.items()}
    norm_conv = dict(tracer.norm_conv)
    conv_norm = {v: k for k, v in norm_conv.items()}

    output_spaces = {uf.find(c) for c in tracer.pinned}
    for out in outputs:
        v = tracer.read(out)
        if isinstance(v, _Act):
            for seg in resolved(v.segs):
                if seg.space is not None:
                    output_spaces.add(seg.space)

    return Topology(spaces=spaces, conv_space=conv_space,
                    norm_conv=norm_conv, conv_norm=conv_norm,
                    in_segments=in_segments,
                    output_spaces=sorted(output_spaces))


def topology_mismatches(t_a: Topology, t_b: Topology) -> List[str]:
    """Compare two topologies up to space-id renaming; return a list of
    human-readable mismatch descriptions (empty = exact agreement).

    Space ids are representative-elect (union-find roots), so identity is
    the frozen set of member convs, as in tests/test_jaxpr_trace.py."""
    def space_key(topo, space):
        return frozenset(topo.spaces[space])

    out: List[str] = []
    if set(t_a.conv_space) != set(t_b.conv_space):
        out.append("conv inventory differs: %s" % sorted(
            set(t_a.conv_space) ^ set(t_b.conv_space)))
        return out
    groups_a = {frozenset(v) for v in t_a.spaces.values()}
    groups_b = {frozenset(v) for v in t_b.spaces.values()}
    if groups_a != groups_b:
        out.append("coupling groups differ: %s" % [
            sorted(g) for g in groups_a ^ groups_b])
    if t_a.norm_conv != t_b.norm_conv:
        diff = {k for k in set(t_a.norm_conv) | set(t_b.norm_conv)
                if t_a.norm_conv.get(k) != t_b.norm_conv.get(k)}
        out.append("BN pairing differs at: %s" % sorted(diff))
    for conv in sorted(t_a.conv_space):
        segs_a = [(None if s.space is None else space_key(t_a, s.space),
                   s.size) for s in t_a.in_segments[conv]]
        segs_b = [(None if s.space is None else space_key(t_b, s.space),
                   s.size) for s in t_b.in_segments[conv]]
        if segs_a != segs_b:
            out.append("input segmentation differs at conv %s" % conv)
    outs_a = {space_key(t_a, s) for s in t_a.output_spaces}
    outs_b = {space_key(t_b, s) for s in t_b.output_spaces}
    if outs_a != outs_b:
        out.append("protected output spaces differ")
    return out
