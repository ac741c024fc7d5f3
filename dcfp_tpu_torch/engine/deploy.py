"""Deployment: BN-folded, reduced-precision inference with an on-device
argmax (port of ``dcfp_tpu/engine/deploy.py``, main path).

* fold BatchNorm into the preceding conv (what TensorRT's builder does);
* run in bfloat16 (the reference's fp16_mode analog); cuDNN convs on
  ``channels_last`` tensors;
* emit uint8 labels through the fused resize-argmax kernel (K1,
  ``dcfp_tpu_torch.ops.kernels``), so the full-resolution logits are
  never written to device memory;
* run each conv's bias, and the residual add and ReLU after it, as one
  pass over the conv's output (``fuse_conv_epilogues``, the conv
  epilogue kernel), where the body is not spatially sharded;
* optionally take the image as its stride-2 phase planes
  (``input_format="phases"``), whose stem conv runs as the stem conv
  kernel (K2) and the rest of the graph re-rooted after it;
* optionally rewrite the folded graph as the JAX package does
  (``split_concat_projection``, ``pad_conv_out_channels``;
  ``insert_barriers`` is kept and changes nothing at run time).

``make_split_inference_fn`` keeps the JAX package's body/tail split,
which is where the kernel sits.  The fixed-shape compile and the
serialized artifact (the TRT engine file's analog) are PyTorch's:

* ``aot_compile*`` capture the forward at one shape in CUDA graphs after
  a warm-up, so a request replays recorded launches with no Python in
  between (on an explicit CPU device the function is returned as is);
* ``export_serialized*`` write ``torch.export`` programs (body to
  ``path``, K1 tail to ``path + ".tail"``, K1 recorded as the operator
  ``dcfp_tpu_torch::resize_argmax_cm``), which ``load_serialized`` runs
  eagerly; the weights travel beside them in ``deploy_params.msgpack``
  (``save_deploy_params``), in the JAX package's layout.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch import bridge
from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.graph.apply import graph_apply
from dcfp_tpu_torch.graph.ir import Graph, Node
from dcfp_tpu_torch.graph.shapes import infer_shapes
from dcfp_tpu_torch.parallel import spatial
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------

def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float64).numpy()


def fold_batchnorm(graph: Graph, params: Dict, state: Dict
                   ) -> Tuple[Graph, Dict, Dict]:
    """Fold every conv->bn pair into the conv (inference only):
        W'[o,...] = W[o,...] * g[o]         g = scale / sqrt(var + eps)
        b'[o]     = (b[o] - mean[o]) * g[o] + shift[o]
    BNs become identity nodes; convs acquire a bias.  The arithmetic is
    the JAX package's, in float64 numpy on the host, so the folded params
    are bit-equal to its; they come back float32 on the conv's device."""
    new_graph = graph.copy()
    new_params = {k: dict(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in state.items()}
    folded = 0
    for bn in graph.bn_nodes():
        parent = bn.inputs[0]
        pnode = graph.node(parent)
        if pnode.op != "conv":
            continue
        if len(graph.consumers(parent)) != 1:
            continue  # conv feeds others too; cannot fold safely
        eps = bn.attrs["eps"]
        scale = _f64(params[bn.name]["scale"])
        shift = _f64(params[bn.name]["bias"])
        mean = _f64(state[bn.name]["mean"])
        var = _f64(state[bn.name]["var"])
        g = scale / np.sqrt(var + eps)
        k = new_params[parent]["kernel"]
        kernel = _f64(k)  # OIHW
        bias = (_f64(new_params[parent]["bias"])
                if "bias" in new_params[parent]
                else np.zeros(kernel.shape[0]))
        new_params[parent]["kernel"] = torch.from_numpy(
            (kernel * g[:, None, None, None]).astype(np.float32)).to(k.device)
        new_params[parent]["bias"] = torch.from_numpy(
            ((bias - mean) * g + shift).astype(np.float32)).to(k.device)
        new_graph.node(parent).attrs["bias"] = True
        # bn becomes a passthrough
        nb = new_graph.node(bn.name)
        nb.op = "identity"
        nb.attrs = {}
        del new_params[bn.name]
        del new_state[bn.name]
        folded += 1
    log.info("folded %d BN layers into convs", folded)
    return new_graph, new_params, new_state


# ---------------------------------------------------------------------------
# graph rewrites (the JAX package's, on the port's tensors)
# ---------------------------------------------------------------------------

_ONE_BY_ONE_PRESERVING = {"relu", "bn", "identity", "dropout", "sigmoid"}


def _is_broadcast_resize(graph: Graph, resize_name: str) -> bool:
    """True when the resize's input is spatially 1x1 (a globalpool chain):
    bilinear resize of a constant field is a broadcast, so a following
    1x1 conv commutes through it EXACTLY (same float values)."""
    cur = graph.node(resize_name).inputs[0]
    while True:
        node = graph.node(cur)
        if node.op == "globalpool":
            return True
        if node.op in _ONE_BY_ONE_PRESERVING:
            cur = node.inputs[0]
            continue
        if (node.op == "conv" and node.attrs["kernel"] == 1
                and node.attrs["stride"] == 1
                and node.attrs["padding"] == 0):
            cur = node.inputs[0]
            continue
        return False


def split_concat_projection(graph: Graph, params: Dict
                            ) -> Tuple[Graph, Dict]:
    """Rewrite ``conv1x1(concat(b_1..b_k))`` as ``sum_i conv1x1_i(b_i)``.

    The concatenated tensor (e.g. ASPP's 5-branch stack,
    reference networks/tools/aspp.py:63-65) is never made: each branch
    projects straight out of its producer and the partial products sum.
    A branch that is a *broadcast* resize (ASPP's global-pool branch
    upsampled back, aspp.py:56-61) commutes its projection through the
    resize: the 1x1 conv runs on the 1x1 pooled vector and only the
    projected result broadcasts.

    Exact up to float reassociation (one product -> k partial products);
    the broadcast commute is value-exact.  Deploy-time only: run after
    :func:`fold_batchnorm` (concat inputs then feed convs directly).  The
    graph and the params (OIHW kernels sliced on I) are the JAX
    package's rewrite; it is off by default there and here."""
    g = graph.copy()
    new_params = {k: dict(v) for k, v in params.items()}
    rewrites = []
    for conv in graph.conv_nodes():
        a = conv.attrs
        if not (a["kernel"] == 1 and a["stride"] == 1
                and a["padding"] == 0 and a.get("groups", 1) == 1):
            continue
        src = graph.node(conv.inputs[0])
        if src.op != "concat":
            continue
        rewrites.append((conv, src,
                         len(graph.consumers(src.name)) == 1))
    if not rewrites:
        return g, new_params

    drop = {src.name for _, src, sole in rewrites if sole}
    split_of = {conv.name: (conv, src) for conv, src, _ in rewrites}
    new_nodes: Dict[str, Node] = {}
    for n in g.nodes.values():
        if n.name in drop:
            continue
        if n.name not in split_of:
            new_nodes[n.name] = n
            continue
        conv, src = split_of[n.name]
        kernel = new_params[conv.name]["kernel"]  # OIHW
        bias = new_params[conv.name]["bias"] if conv.attrs["bias"] else None
        del new_params[conv.name]
        off = 0
        part_names = []
        for i, branch in enumerate(src.inputs):
            bch = _branch_channels(graph, branch)
            pname = f"{conv.name}.s{i}"
            p = {"kernel": kernel[:, off:off + bch].clone()}
            has_bias = bias is not None and i == 0
            if has_bias:
                p["bias"] = bias.clone()
            attrs = dict(conv.attrs)
            attrs.update(in_ch=bch, bias=has_bias)
            bnode = graph.node(branch)
            if bnode.op == "resize" and _is_broadcast_resize(g, branch):
                # commute: conv on the pre-resize (1x1) tensor, then the
                # (broadcast) resize runs on out_ch channels
                new_nodes[pname] = Node(pname, "conv",
                                        (bnode.inputs[0],), attrs)
                rname = pname + ".r"
                rattrs = dict(bnode.attrs)
                rinputs = ((pname, rattrs["like"]) if "like" in rattrs
                           else (pname,))
                new_nodes[rname] = Node(rname, "resize", rinputs, rattrs)
                part_names.append(rname)
            else:
                new_nodes[pname] = Node(pname, "conv", (branch,), attrs)
                part_names.append(pname)
            new_params[pname] = p
            off += bch
        new_nodes[conv.name] = Node(conv.name, "add", tuple(part_names))
    g.nodes = new_nodes
    # drop nodes orphaned by the rewrite (e.g. the pre-commute resize,
    # whose only consumer was the dropped concat)
    used = set(g.outputs) | set(g.inputs)
    for n in reversed(list(g.nodes.values())):
        if n.name in used:
            used.update(n.inputs)
            if n.op == "resize" and "like" in n.attrs:
                used.add(n.attrs["like"])
    g.nodes = {k: v for k, v in g.nodes.items() if k in used}
    return g, new_params


def _branch_channels(graph: Graph, name: str) -> int:
    from dcfp_tpu_torch.utils.flops import _channels
    return _channels(graph, name)


_ZERO_PRESERVING = {"relu", "identity", "maxpool", "dropout"}


def insert_barriers(graph: Graph, after: Sequence[str]) -> Graph:
    """Splice a ``barrier`` node after each named node (the JAX package's
    rewrite, whose barrier stops XLA from fusing the producer chain into
    every consumer).  The port's interpreter runs ``barrier`` as the
    identity (``graph/apply.py``), so at run time this rewrite is a
    no-op: the graph gains nodes and computes the same values."""
    g = graph.copy()
    new_nodes: Dict[str, Node] = {}
    barred = {name: f"{name}.barrier" for name in after}
    for n in g.nodes.values():
        # rewire EVERY consumer of a barred node — including nodes that
        # are barrier targets themselves (two adjacent barred nodes)
        if any(i in barred for i in n.inputs):
            n = n.replace(inputs=tuple(barred.get(i, i)
                                       for i in n.inputs))
        new_nodes[n.name] = n
        if n.name in barred:
            bname = barred[n.name]
            new_nodes[bname] = Node(bname, "barrier", (n.name,))
    g.nodes = new_nodes
    g.outputs = [barred.get(o, o) for o in g.outputs]
    return g


def pad_conv_out_channels(graph: Graph, params: Dict,
                          targets: Dict[str, int]
                          ) -> Tuple[Graph, Dict]:
    """Zero-pad conv output channels to wider widths — EXACT.

    For each ``conv_name -> width``: the conv's kernel/bias gain zero
    output channels (so the padded outputs are exactly 0), every consumer
    conv reached through zero-preserving ops (relu/maxpool/identity)
    gains zero input channels, and the graph attrs update.  Numerically
    identical output.  Run AFTER fold_batchnorm."""
    new_graph = graph.copy()
    new_params = {k: dict(v) for k, v in params.items()}
    for name, width in targets.items():
        node = new_graph.node(name)
        assert node.op == "conv", name
        cur = node.attrs["out_ch"]
        if width <= cur:
            continue
        pad = width - cur
        k = new_params[name]["kernel"]  # OIHW
        new_params[name]["kernel"] = F.pad(k, (0, 0, 0, 0, 0, 0, 0, pad))
        if node.attrs["bias"]:
            new_params[name]["bias"] = F.pad(new_params[name]["bias"],
                                             (0, pad))
        node.attrs["out_ch"] = width

        # propagate through zero-preserving ops to the consumer convs
        frontier = [name]
        seen = set()
        while frontier:
            cur_name = frontier.pop()
            for cons in new_graph.consumers(cur_name):
                if cons.name in seen:
                    continue
                seen.add(cons.name)
                if cons.op == "conv":
                    assert cons.attrs["groups"] == 1, cons.name
                    new_params[cons.name]["kernel"] = F.pad(
                        new_params[cons.name]["kernel"],
                        (0, 0, 0, 0, 0, pad))
                    cons.attrs["in_ch"] = width
                elif cons.op in _ZERO_PRESERVING:
                    frontier.append(cons.name)
                else:
                    raise ValueError(
                        f"cannot pad through {cons.op!r} ({cons.name})")
    return new_graph, new_params


def stem_pad_targets(graph: Graph, width: int = 128) -> Dict[str, int]:
    """The deep-stem convs narrower than ``width`` (reference stem:
    networks/backbone/resnet.py:88-98), for
    :func:`pad_conv_out_channels`."""
    targets = {}
    for node in graph.toposorted():
        if node.op != "conv":
            continue
        if node.name.startswith("backbone.conv1.") and \
                node.attrs["out_ch"] < width:
            targets[node.name] = width
    return targets


def fuse_conv_epilogues(graph: Graph) -> Graph:
    """Give every conv with a bias its epilogue: the bias, and the
    residual add and ReLU that follow the conv, run in one pass over its
    output (``ops.kernels.conv_epilogue``), as XLA fuses them into the
    conv on the TPU.

    The conv keeps its name and params and gains ``attrs["epilogue"]``,
    ``"relu"`` or ``"none"``; a merged add's other operand becomes its
    second input, the residual.  The merged nodes (the fold's identities,
    the add, the ReLU) leave the graph and their consumers read the conv.
    A value is merged into the node that follows only where that node is
    its one consumer and neither is a graph output.  Of an add's two
    operands, the conv latest in graph order takes it (the other operand
    is then computed before it, and a conv it came from keeps its bias
    alone); an add of more operands is left as it is.

    Exact up to rounding: the epilogue sums in f32 and rounds once, where
    the unrewritten graph rounds after each op.  Deploy-time only: run
    after :func:`fold_batchnorm` on a graph that runs without a spatial
    axis.  Params are unchanged."""
    order = {name: i for i, name in enumerate(graph.nodes)}
    outputs = set(graph.outputs)
    users: Dict[str, list] = {name: [] for name in graph.nodes}
    for n in graph.nodes.values():
        for parent in dict.fromkeys(n.inputs):
            users[parent].append(n.name)

    def sole(name: str, op: str):
        """The one consumer of ``name`` if it has op ``op`` and neither
        is a graph output; else None."""
        u = users[name]
        if name in outputs or len(u) != 1 or u[0] in outputs:
            return None
        node = graph.node(u[0])
        return node if node.op == op else None

    def through_identities(name: str, merged: list) -> str:
        while (nxt := sole(name, "identity")) is not None:
            merged.append(nxt.name)
            name = nxt.name
        return name

    merged: Dict[str, list] = {}   # conv -> the nodes it takes, in order
    end: Dict[str, str] = {}       # a conv's last identity -> the conv
    for conv in graph.conv_nodes():
        if conv.attrs["bias"]:
            names = merged[conv.name] = []
            end[through_identities(conv.name, names)] = conv.name
    residual: Dict[str, str] = {}
    for add in graph.nodes.values():
        if add.op != "add" or len(set(add.inputs)) != 2:
            continue
        convs = [end[i] for i in add.inputs
                 if i in end and sole(i, "add") is add]
        if not convs:
            continue
        conv = max(convs, key=order.get)
        other = next(i for i in add.inputs if end.get(i) != conv)
        if order[other] > order[conv]:
            continue
        residual[conv] = other
        merged[conv].append(add.name)
    act: Dict[str, str] = {}
    for conv, names in merged.items():
        last = through_identities(names[-1] if names else conv, names)
        relu = sole(last, "relu")
        if relu is not None:
            names.append(relu.name)
        act[conv] = "relu" if relu is not None else "none"

    alias = {m: conv for conv, names in merged.items() for m in names}
    g = graph.copy()
    new_nodes: Dict[str, Node] = {}
    for n in g.nodes.values():
        if n.name in alias:
            continue
        if n.name in act:
            n.attrs["epilogue"] = act[n.name]
            if n.name in residual:
                n.inputs = n.inputs + (residual[n.name],)
        n.inputs = tuple(alias.get(i, i) for i in n.inputs)
        if "like" in n.attrs:
            n.attrs["like"] = alias.get(n.attrs["like"], n.attrs["like"])
        new_nodes[n.name] = n
    g.nodes = new_nodes
    return g


# ---------------------------------------------------------------------------
# inference function
# ---------------------------------------------------------------------------

def _reroot_at(graph: Graph, seed: str, old_input: str) -> Graph:
    """Copy of ``graph`` with node ``seed`` turned into an input node and
    the original input removed (the phases path computes ``seed``, the
    stem conv, outside the graph interpreter)."""
    g = graph.copy()
    node = g.node(seed)
    node.op = "input"
    node.inputs = ()
    node.attrs = {}
    del g.nodes[old_input]
    g.inputs = [seed]
    return g


def _to_device(tree: Dict, dev: torch.device, dtype: torch.dtype) -> Dict:
    """Floating tensors to ``dev``/``dtype``; conv kernels channels_last
    on CUDA, the memory format cuDNN's NHWC convolutions take."""
    out = {}
    for name, d in tree.items():
        out[name] = {}
        for k, v in d.items():
            v = v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
            if dev.type == "cuda" and v.dim() == 4:
                v = v.contiguous(memory_format=torch.channels_last)
            out[name][k] = v
    return out


def split_pred_tail(graph: Graph):
    """(body, tail): when 'pred' is a to-input bilinear resize, the graph
    whose output is that resize's input, and the resize node; else
    (graph, None).  The interpreter runs every node, so the body drops
    the full-resolution resize that a tail takes the place of."""
    node = graph.node("pred")
    if node.op != "resize" or not node.attrs.get("to_input"):
        return graph, None
    body = graph.copy()
    body.outputs = [node.inputs[0] if o == "pred" else o
                    for o in graph.outputs]
    if not body.consumers("pred"):
        del body.nodes["pred"]
    return body, node


def make_split_inference_fn(graph: Graph, params: Dict, state: Dict, *,
                            dtype: torch.dtype = torch.bfloat16,
                            fold_bn: bool = True, output: str = "logits",
                            input_format: str = "nhwc", input_hw=None,
                            device: DeviceLike = None, spatial_axis=None,
                            pad_stem: int = 0, split_concat: bool = False):
    """Returns (body_fn, tail_fn, dev_params).

    ``body_fn(params, image)`` runs the conv graph on ``image``: NHWC;
    NCHW with ``input_format="nchw"``, which goes straight into the NCHW
    graph; or, with ``input_format="phases"`` and the image size
    ``input_hw``, the (N, 4*C, Hp, Wp) stride-2 phase planes of each image
    (``ops.stem.extract_stem_phases``), whose stem conv runs as K2 on the
    planes cast to ``dtype``, the rest of the graph re-rooted after it.
    When ``output='argmax'`` and the graph ends in a to-input
    bilinear-resize 'pred' node, ``body_fn`` returns the LOW-RES logits,
    shape (N, C, h, w) in the model dtype (channels_last in memory on
    CUDA, as the classifier conv leaves them), and
    ``tail_fn(logits, out_hw)`` runs the fused resize-argmax kernel on
    them in place; otherwise ``tail_fn`` is None and ``body_fn`` returns
    the final output: float32 NHWC logits, or uint8 (N, H, W) labels from
    an argmax over the graph's own output.

    Params and state are the port's tensors (``init_graph`` or
    ``bridge.params_from_numpy``); ``dev_params`` is their folded copy on
    ``device`` in ``dtype``.  Under ``input_format="phases"`` the stem
    conv's entry also holds K2's weights, ``k2_taps`` and ``k2_bias``
    (``ops.kernels.stem_weights``), which ``body_fn`` reads.

    ``spatial_axis`` (``parallel.spatial.Axis`` of more than one rank):
    every rank of the group calls ``body_fn`` with the whole image, runs
    the graph on its band of rows and returns the whole output, its
    bands gathered (the low-res logits before the tail, at most 1.3 MB a
    bf16 1025x2049 frame); NHWC or NCHW input only.

    ``split_concat`` applies :func:`split_concat_projection` and
    ``pad_stem`` (a width, e.g. 128) :func:`pad_conv_out_channels` to the
    deep-stem convs (:func:`stem_pad_targets`), after the fold, as the
    JAX package does; both leave the output as it was up to float
    reassociation and are off by default.  Without a spatial axis the
    body then runs through :func:`fuse_conv_epilogues`.
    """
    if input_format not in ("nhwc", "nchw", "phases"):
        raise ValueError(f"unknown input_format {input_format!r}")
    if spatial_axis is not None and spatial_axis.size == 1:
        spatial_axis = None
    if spatial_axis is not None and input_format == "phases":
        raise ValueError("input_format='phases' has no spatial sharding")
    dev = resolve_device(device)
    if fold_bn:
        graph, params, state = fold_batchnorm(graph, params, state)
    if split_concat:
        graph, params = split_concat_projection(graph, params)
    if pad_stem:
        graph, params = pad_conv_out_channels(
            graph, params, stem_pad_targets(graph, pad_stem))
    dev_params = _to_device(params, dev, dtype)
    dev_state = _to_device(state, dev, torch.float32)

    run_graph = graph
    stem_conv = None
    if input_format == "phases":
        from dcfp_tpu_torch.ops.stem import stem_plan
        stem = stem_plan(graph)
        if stem is None:
            raise ValueError(
                "input_format='phases' requires a 3xK3-s2 stem conv on the "
                "graph input (none found)")
        if input_hw is None:
            raise ValueError("input_format='phases' requires input_hw")
        input_name, stem_conv = stem
        run_graph = _reroot_at(graph, stem_conv, input_name)
        input_hw = (int(input_hw[0]), int(input_hw[1]))
        # K2's weights, made once here rather than on every request
        from dcfp_tpu_torch.ops.kernels import stem_weights
        sp = dev_params[stem_conv]
        sp["k2_taps"], sp["k2_bias"] = stem_weights(
            sp["kernel"], sp.get("bias"), dtype, dev)
    tail_resize = None
    if output == "argmax" and "pred" in graph.nodes:
        run_graph, tail_resize = split_pred_tail(run_graph)
    if spatial_axis is None:
        run_graph = fuse_conv_epilogues(run_graph)

    @torch.inference_mode()
    def body_fn(p, image):
        if stem_conv is not None:
            from dcfp_tpu_torch.ops.kernels import stem_conv3x3_s2_prepared
            sp = p[stem_conv]
            hw = input_hw
            feed = {stem_conv: stem_conv3x3_s2_prepared(
                image.to(dev, dtype).contiguous(), sp["k2_taps"],
                sp["k2_bias"], ((hw[0] + 1) // 2, (hw[1] + 1) // 2))}
        else:
            x = image.permute(0, 3, 1, 2) if input_format == "nhwc" else image
            hw = (int(x.shape[2]), int(x.shape[3]))
            x = spatial.shard_rows(x, spatial_axis).to(dev, dtype)
            if dev.type == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            feed = {graph.inputs[0]: x}
        outs, _ = graph_apply(run_graph, p, dev_state, feed,
                              input_hw=hw, channels_first=True,
                              spatial_axis=spatial_axis)
        name = tail_resize.inputs[0] if tail_resize is not None else "pred"
        out = outs[name]
        if spatial_axis is not None:
            h = infer_shapes(run_graph, hw)[name][0]
            if out.shape[2] != h:
                out = spatial.gather_rows(out, h, spatial_axis)
        if tail_resize is not None:
            return out
        pred = out
        if output == "argmax":
            return torch.argmax(pred, dim=1).to(torch.uint8)
        return pred.permute(0, 2, 3, 1).float()

    tail_fn = None
    if tail_resize is not None:
        ac = tail_resize.attrs["align_corners"]

        @torch.inference_mode()
        def tail_fn(logits_cm, out_hw):
            from dcfp_tpu_torch.ops.kernels import resize_argmax_cm
            return resize_argmax_cm(logits_cm, out_hw, ac)

    return body_fn, tail_fn, dev_params


def infer_out_hw(input_shape, input_format: str = "nhwc",
                 input_hw=None) -> Tuple[int, int]:
    """The full-resolution output size for a deploy input shape."""
    if input_format == "phases":
        return (int(input_hw[0]), int(input_hw[1]))
    hw = (input_shape[2:4] if input_format == "nchw"
          else input_shape[1:3])
    return (int(hw[0]), int(hw[1]))


def make_inference_fn(graph: Graph, params: Dict, state: Dict, *,
                      dtype: torch.dtype = torch.bfloat16,
                      fold_bn: bool = True, output: str = "logits",
                      input_format: str = "nhwc", input_hw=None,
                      device: DeviceLike = None, pad_stem: int = 0,
                      split_concat: bool = False):
    """Returns (fn, params) where ``fn(params, image)`` runs the deploy
    forward: body then, for ``output='argmax'``, the fused tail.
    ``output``: 'logits' (float32 NHWC) or 'argmax' (uint8 (N, H, W)).
    ``input_format``, ``input_hw``, ``pad_stem`` and ``split_concat`` as
    for :func:`make_split_inference_fn`."""
    body_fn, tail_fn, dev_params = make_split_inference_fn(
        graph, params, state, dtype=dtype, fold_bn=fold_bn, output=output,
        input_format=input_format, input_hw=input_hw, device=device,
        pad_stem=pad_stem, split_concat=split_concat)
    if tail_fn is None:
        return body_fn, dev_params

    def fn(p, image):
        return tail_fn(body_fn(p, image),
                       infer_out_hw(image.shape, input_format, input_hw))

    return fn, dev_params


# ---------------------------------------------------------------------------
# fixed-shape compile: CUDA-graph capture (the 'engine build')
# ---------------------------------------------------------------------------

def _first_device(tree: Dict) -> torch.device:
    for d in tree.values():
        for v in d.values():
            return v.device
    raise ValueError("empty params")


class _Replay:
    """``fn(*args)`` captured in a CUDA graph, and its static output.
    The kernel wrappers count their launches while the graph is
    recorded, when nothing runs; the count moves to the replays, each of
    which launches what was recorded."""

    def __init__(self, fn, args, dev: torch.device, warmup: int = 3):
        from dcfp_tpu_torch.ops.kernels import LAUNCHES
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # cuDNN's plans, K1's tap tables and the resize matrices are
            # made here: a host-to-device copy cannot be captured
            for _ in range(warmup):
                fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*args)
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        for k, n in self.launches.items():
            LAUNCHES[k] -= n

    def replay(self) -> None:
        from dcfp_tpu_torch.ops.kernels import LAUNCHES
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n


def _static_input(input_shape, input_dtype, dev) -> torch.Tensor:
    return torch.zeros(tuple(input_shape), dtype=input_dtype, device=dev)


def _feed(static: torch.Tensor, image: torch.Tensor) -> None:
    if tuple(image.shape) != tuple(static.shape):
        raise ValueError(f"compiled for input {tuple(static.shape)}, got "
                         f"{tuple(image.shape)}")
    static.copy_(image)


def _check_params(p, params) -> None:
    if p is not params:
        raise ValueError("a captured forward runs on the params it was "
                         "captured with; pass the same params object")


def aot_compile(fn, params, input_shape: Tuple[int, ...],
                input_dtype: torch.dtype = torch.float32,
                device: DeviceLike = None):
    """Compile ``fn(params, image)`` at a fixed shape (the 'engine
    build'): on CUDA, warm it up on a side stream, capture one call in a
    CUDA graph and return ``run(params, image)``, which copies ``image``
    into the static input, replays the graph and returns the static
    output.  Each replay overwrites that output: use it, or copy it,
    before the next call.  On an explicit CPU ``device`` returns ``fn``
    unchanged."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return fn
    t0 = time.time()
    static = _static_input(input_shape, input_dtype, dev)
    graph = _Replay(fn, (params, static), dev)
    log.info("CUDA-graph capture took %.1fs", time.time() - t0)

    def run(p, image):
        _check_params(p, params)
        _feed(static, image)
        graph.replay()
        return graph.out

    return run


def aot_compile_split(body_fn, tail_fn, params,
                      input_shape: Tuple[int, ...],
                      input_dtype: torch.dtype = torch.float32,
                      input_format: str = "nhwc", input_hw=None,
                      device: DeviceLike = None):
    """Capture body and tail (from :func:`make_split_inference_fn`) as two
    CUDA graphs and return ``run(params, image)`` replaying them in turn;
    the tail reads the body's static logits in place.  On an explicit CPU
    ``device``, the two functions chained."""
    if tail_fn is None:
        return aot_compile(body_fn, params, input_shape, input_dtype,
                           device)
    dev = resolve_device(device)
    out_hw = infer_out_hw(input_shape, input_format, input_hw)
    if dev.type == "cpu":
        return lambda p, image: tail_fn(body_fn(p, image), out_hw)
    static = _static_input(input_shape, input_dtype, dev)
    body = _Replay(body_fn, (params, static), dev)
    tail = _Replay(tail_fn, (body.out, out_hw), dev)

    def run(p, image):
        _check_params(p, params)
        _feed(static, image)
        body.replay()
        tail.replay()
        return tail.out

    return run


# ---------------------------------------------------------------------------
# serialized artifact: torch.export programs + deploy_params.msgpack
# ---------------------------------------------------------------------------

class _Program(torch.nn.Module):
    """``fn(*args)`` as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _sorted_params(params: Dict) -> Dict:
    """Params with their keys sorted at both levels: the tree order of an
    exported program's input, whatever order the caller's dict has (the
    msgpack file's is sorted, a graph's is not)."""
    return {n: {k: params[n][k] for k in sorted(params[n])}
            for n in sorted(params)}


def _export(fn, args, path: str):
    """Trace ``fn(*args)`` with ``torch.export`` and save it to ``path``."""
    fn = getattr(fn, "__wrapped__", fn)  # the inference_mode decorator
    with torch.no_grad():
        exported = torch.export.export(_Program(fn), tuple(args),
                                       strict=False)
    # the file would carry the example inputs (the params and an image)
    exported.example_inputs = None
    with open(path, "wb") as f:  # a file object: any name, not only .pt2
        torch.export.save(exported, f)
    return exported


def _remove_stale_tail(path: str) -> None:
    """Remove a ``path + '.tail'`` left by a previous split export:
    :func:`load_serialized` would otherwise chain the stale tail onto the
    freshly exported body."""
    tail = path + ".tail"
    if os.path.exists(tail):
        os.remove(tail)
        log.info("removed stale split tail %s", tail)


def export_serialized(fn, params, input_shape: Tuple[int, ...], path: str,
                      input_dtype: torch.dtype = torch.float32) -> None:
    """Serialize ``fn(params, image)`` at a fixed input shape as a
    ``torch.export`` program (the TRT-engine-file analog, totrt.py:122);
    ``params`` is an input of the program, as in the JAX package's
    export, so the weights are not in the file.  The image is made on
    the params' device."""
    dev = _first_device(params)
    _export(fn, (_sorted_params(params),
                 _static_input(input_shape, input_dtype, dev)), path)
    # a .tail from a previous split export would be chained onto this
    # fresh body by load_serialized; export_serialized_split rewrites it
    # right after this call when the new export IS split
    _remove_stale_tail(path)
    log.info("serialized %d-byte program to %s", os.path.getsize(path), path)


def export_serialized_split(body_fn, tail_fn, params,
                            input_shape: Tuple[int, ...], path: str,
                            input_dtype: torch.dtype = torch.float32,
                            input_format: str = "nhwc",
                            input_hw=None) -> None:
    """Serialize a split deploy engine: the conv body to ``path`` and the
    K1 tail to ``path + '.tail'`` (absent when tail_fn is None)."""
    export_serialized(body_fn, params, input_shape, path, input_dtype)
    if tail_fn is None:
        return
    dev = _first_device(params)
    with torch.no_grad():
        z = getattr(body_fn, "__wrapped__", body_fn)(
            params, _static_input(input_shape, input_dtype, dev))
    out_hw = infer_out_hw(input_shape, input_format, input_hw)
    _export(lambda logits: tail_fn(logits, out_hw), (z,), path + ".tail")
    log.info("serialized %d-byte tail program to %s.tail",
             os.path.getsize(path + ".tail"), path)


def load_serialized(path: str):
    """Load a serialized deploy engine as ``run(params, image)``: the
    body program, chained with ``path + '.tail'`` where a split export
    wrote one.  The programs run eagerly (no capture), so each call
    returns fresh tensors."""
    def load(p):
        with open(p, "rb") as f, warnings.catch_warnings():
            # the archive's bytes are read-only; the tensors are copied
            warnings.filterwarnings("ignore", message=".*not writable")
            return torch.export.load(f).module()

    body = load(path)
    tail = load(path + ".tail") if os.path.exists(path + ".tail") else None

    @torch.inference_mode()
    def run(p, image):
        out = body(_sorted_params(p), image)
        return out if tail is None else tail(out)

    return run


def save_deploy_params(path: str, dev_params: Dict) -> None:
    """``deploy_params.msgpack``: the folded deploy params as the JAX
    package's deploy CLI writes them (its tree, HWIO kernels, each leaf
    at the export dtype), byte for byte."""
    from dcfp_tpu_torch.utils import checkpoint as ckpt
    ckpt.save_pytree(path, bridge.tree_to_file_layout(dev_params))


def load_deploy_params(path: str, device: DeviceLike = None) -> Dict:
    """The params of ``deploy_params.msgpack`` as the port's tensors on
    ``device`` (``None`` means CUDA), at the file's dtype; conv kernels
    channels_last on CUDA, as :func:`make_split_inference_fn` makes
    them."""
    from dcfp_tpu_torch.utils import checkpoint as ckpt
    dev = resolve_device(device)
    params, _ = bridge.params_from_numpy(ckpt.load_pytree(path), {}, dev)
    if dev.type == "cuda":
        params = {n: {k: (v.contiguous(memory_format=torch.channels_last)
                          if v.dim() == 4 else v) for k, v in d.items()}
                  for n, d in params.items()}
    return params


# ---------------------------------------------------------------------------
# latency benchmark (totrt.py:70-89: 10 warmup + 50 timed)
# ---------------------------------------------------------------------------

def _sync(out: torch.Tensor) -> None:
    """Wait for the device: kernels run in stream order, so synchronizing
    after the last output's producer covers every prior launch."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)


def benchmark(run, example_input, *, warmup: int = 10, iters: int = 50,
              blocks: int = 1) -> Dict[str, float]:
    """Warmup once, then time ``blocks`` independent ``iters``-long blocks
    on the host clock, each ending in a device synchronize.

    With blocks=1 this is exactly the reference protocol (one timed
    block, totrt.py:70-89).  With blocks>1 the headline is the MEDIAN
    block, and the per-block spread is reported.
    """
    for _ in range(warmup):
        out = run(example_input)
    _sync(out)
    block_ms = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run(example_input)
        _sync(out)
        block_ms.append((time.perf_counter() - t0) / iters * 1000.0)
    batch = example_input.shape[0]
    ms = float(np.median(block_ms))
    ips = batch * 1000.0 / ms
    log.info("latency: %.2f ms/batch, %.2f img/s%s", ms, ips,
             "" if blocks == 1 else
             " (median of %d blocks, %.2f-%.2f ms)" % (
                 blocks, min(block_ms), max(block_ms)))
    return {"ms_per_batch": ms, "images_per_sec": ips,
            "ms_blocks": [round(b, 3) for b in block_ms],
            "ms_min": round(min(block_ms), 3),
            "ms_max": round(max(block_ms), 3)}
