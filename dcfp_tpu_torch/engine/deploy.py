"""Deployment: BN-folded, reduced-precision inference with an on-device
argmax (port of ``dcfp_tpu/engine/deploy.py``, main path).

* fold BatchNorm into the preceding conv (what TensorRT's builder does);
* run in bfloat16 (the reference's fp16_mode analog); cuDNN convs on
  ``channels_last`` tensors;
* emit uint8 labels through the fused resize-argmax kernel (K1,
  ``dcfp_tpu_torch.ops.kernels``), so the full-resolution logits are
  never written to device memory;
* optionally take the image as its stride-2 phase planes
  (``input_format="phases"``), whose stem conv runs as the stem conv
  kernel (K2) and the rest of the graph re-rooted after it.

PyTorch runs eagerly, so there is no AOT compile or serialized artifact
here yet; ``make_split_inference_fn`` keeps the JAX package's body/tail
split, which is where the kernel sits.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.graph.apply import graph_apply
from dcfp_tpu_torch.graph.ir import Graph
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


def make_split_inference_fn(graph: Graph, params: Dict, state: Dict, *,
                            dtype: torch.dtype = torch.bfloat16,
                            fold_bn: bool = True, output: str = "logits",
                            input_format: str = "nhwc", input_hw=None,
                            device: DeviceLike = None):
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
    """
    if input_format not in ("nhwc", "nchw", "phases"):
        raise ValueError(f"unknown input_format {input_format!r}")
    dev = resolve_device(device)
    if fold_bn:
        graph, params, state = fold_batchnorm(graph, params, state)
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
        node = graph.node("pred")
        if node.op == "resize" and node.attrs.get("to_input"):
            tail_resize = node
            run_graph = run_graph.copy()
            run_graph.outputs = [node.inputs[0] if o == "pred" else o
                                 for o in run_graph.outputs]

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
            x = x.to(dev, dtype)
            if dev.type == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            feed = {graph.inputs[0]: x}
        outs, _ = graph_apply(run_graph, p, dev_state, feed,
                              input_hw=hw, channels_first=True)
        if tail_resize is not None:
            return outs[tail_resize.inputs[0]]
        pred = outs["pred"]
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
                      device: DeviceLike = None):
    """Returns (fn, params) where ``fn(params, image)`` runs the deploy
    forward: body then, for ``output='argmax'``, the fused tail.
    ``output``: 'logits' (float32 NHWC) or 'argmax' (uint8 (N, H, W)).
    ``input_format`` and ``input_hw`` as for
    :func:`make_split_inference_fn`."""
    body_fn, tail_fn, dev_params = make_split_inference_fn(
        graph, params, state, dtype=dtype, fold_bn=fold_bn, output=output,
        input_format=input_format, input_hw=input_hw, device=device)
    if tail_fn is None:
        return body_fn, dev_params

    def fn(p, image):
        return tail_fn(body_fn(p, image),
                       infer_out_hw(image.shape, input_format, input_hw))

    return fn, dev_params


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
