"""Post-training int8 quantization for the deploy path (port of
``dcfp_tpu/engine/quantize.py``).

The reference deploys via TensorRT fp16 (totrt.py:113-121); TensorRT's
next gear is int8 with a calibration pass.  After BN folding we

1. **calibrate**: run N images through the f32 graph and record the
   absmax (or a percentile) of |x| at every quantization point
   (symmetric per-tensor activation scales): conv inputs AND the tensors
   that stay int8 between convs;
2. **quantize weights** per output channel (symmetric, int8);
3. **run** convs as ``int8 x int8 -> int32`` and keep activations int8
   *through* relu / maxpool / residual-add / concat (requantized by
   elementwise epilogues) so chained convs never bounce through the
   float dtype.  Ops with real arithmetic (resize, global pooling,
   sigmoid) dequantize to the float dtype.

Quantizing pre-relu with the post-relu scale is exact: symmetric scales
put zero at 0, the positive range is unchanged by relu, and negative
values clip no differently than relu would zero them.

**The int8 conv.**  On CUDA every quantized conv's ``int8 x int8 ->
int32`` product is one launch of the repo's hand-written int8 matmul
(K5, ``ops/int8.tiled_mm``): the conv's input, channels last, is laid out
as its shifted-slice matrix (one row a output pixel, the k*k taps'
channels side by side, zero-padded to a multiple of 16 columns), and the
weights as the matching (k*k*Cin, Cout) matrix, made once, zero-padded to
a multiple of 4 columns.  int32 sums are exact, so any exact product
gives the JAX package's accumulators.  The requant epilogue (``* rescale
+ bias``, round half to even, clip to +-127) is plain PyTorch in the JAX
package's order.  On the CPU the accumulators come from
:func:`_qconv_plain`, a float64 ``F.conv2d`` of the int8 values (exact:
every sum is an integer below 2**53); a CUDA tensor never takes it.
The deploy tail's upsample + argmax is K1 (``ops/kernels``).

Accuracy guardrail without labeled data: ``argmax_agreement`` measures
label-map agreement between the quantized and float models.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.graph import apply as A
from dcfp_tpu_torch.graph.ir import Graph, Node
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def quant_points(graph: Graph) -> set:
    """Tensor names that need calibrated scales: conv inputs plus every
    tensor the chained interpreter keeps int8 across (conv outputs and
    add/concat outputs)."""
    pts = set()
    for n in graph.toposorted():
        if n.op == "conv":
            pts.add(n.inputs[0])
            pts.add(n.name)
        elif n.op in ("add", "concat"):
            pts.add(n.name)
    return pts


def abs_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(|x|.ravel(), q)`` (linear interpolation) as a 0-d
    float32 tensor, with the JAX package's float32 index arithmetic.
    ``torch.quantile`` refuses more than 2**24 elements (a full-width
    activation has 4x that), so the two order statistics come from
    ``kthvalue``."""
    flat = x.detach().abs().float().reshape(-1)
    n = torch.tensor(flat.numel(), dtype=torch.float32)
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    lo = int(torch.clamp(low, 0, n - 1))
    hi = int(torch.clamp(high, 0, n - 1))
    low_v = torch.kthvalue(flat, lo + 1).values.cpu()
    high_v = low_v if hi == lo else torch.kthvalue(flat, hi + 1).values.cpu()
    return low_v * low_w + high_v * high_w


@torch.inference_mode()
def calibrate_tensor_scales(graph: Graph, params, state,
                            batches: Iterable[np.ndarray],
                            percentile: float = 100.0,
                            device: DeviceLike = None) -> Dict[str, float]:
    """Per-tensor symmetric activation scales (absmax/127, or the given
    percentile of |x| for clipping outliers) at every quantization
    point, from N calibration images (NHWC) through the float32 graph on
    ``device`` (default: where the params are).  Each point's statistic
    is taken as the interpreter makes it, so only live tensors are
    held."""
    dev = _params_device(params) if device is None else resolve_device(
        device)
    points = quant_points(graph) | set(graph.inputs)
    p32 = _to_device(params, dev, torch.float32)
    s32 = _to_device(state, dev, torch.float32)
    amax: Dict[str, float] = {}
    n = 0
    for image in batches:
        found: Dict[str, torch.Tensor] = {}

        def observe(name, value):
            if name in points:
                v = _to_float(value, torch.float32)
                found[name] = (v.abs().max().float() if percentile >= 100.0
                               else abs_quantile(v, percentile / 100.0))

        x = torch.as_tensor(np.asarray(image)).to(dev, torch.float32)
        quant_graph_apply(graph, p32, s32, {}, {graph.inputs[0]: x},
                          compute_dtype=torch.float32, observe=observe)
        for k, v in found.items():
            amax[k] = max(amax.get(k, 0.0), float(v))
        n += 1
    log.info("calibrated activation scales over %d batches", n)
    return {t: max(v, 1e-8) / 127.0 for t, v in amax.items()}


def calibrate_act_scales(graph: Graph, params, state,
                         batches: Iterable[np.ndarray],
                         percentile: float = 100.0,
                         device: DeviceLike = None) -> Dict[str, float]:
    """Per-conv input activation scales {conv_name: s_in} (thin wrapper
    over :func:`calibrate_tensor_scales`)."""
    tensor_scales = calibrate_tensor_scales(graph, params, state, batches,
                                            percentile, device)
    return {n.name: tensor_scales[n.inputs[0]]
            for n in graph.conv_nodes()}


# ---------------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------------

_CHAINABLE = {"relu", "maxpool", "identity", "dropout", "add", "concat",
              "conv"}


def quantize_params(graph: Graph, params, act_scales: Dict[str, float],
                    tensor_scales: Optional[Dict[str, float]] = None
                    ) -> Dict[str, Dict]:
    """Per-output-channel symmetric int8 weights + fused rescale factors.

    qparams[conv] = {w_q int8 OIHW, rescale f32[out] (= s_in * s_w),
    bias f32[out]?}, on the device of the conv's kernel; the (static)
    scales live in ``tensor_scales``.  The arithmetic is the JAX
    package's, in numpy float32 on the host, so ``w_q`` is bit-equal to
    its (up to the layout).  Convs without a calibrated scale, or
    grouped, stay float."""
    tensor_scales = tensor_scales or {}
    q: Dict[str, Dict] = {}
    for node in graph.conv_nodes():
        name = node.name
        if name not in act_scales or node.attrs["groups"] != 1:
            continue
        kernel = params[name]["kernel"]
        w = kernel.detach().cpu().float().numpy()  # OIHW
        s_w = np.abs(w).reshape(w.shape[0], -1).max(1) / 127.0
        s_w = np.maximum(s_w, 1e-12)
        w_q = np.clip(np.rint(w / s_w[:, None, None, None]), -127,
                      127).astype(np.int8)
        s_in = float(act_scales[name])
        entry = {
            "w_q": torch.from_numpy(w_q).to(kernel.device),
            "rescale": torch.from_numpy(
                np.asarray(s_in * s_w, np.float32)).to(kernel.device),
        }
        if "bias" in params[name]:
            entry["bias"] = params[name]["bias"].detach().float()
        q[name] = entry
    chained = sum(1 for n in graph.conv_nodes() if n.name in q and
                  _emit_scale(graph, n.name, tensor_scales) is not None)
    log.info("quantized %d convs to int8 (%d emit int8 directly)",
             len(q), chained)
    return q


def _emit_scale(graph: Graph, conv_name: str,
                tensor_scales: Dict[str, float]) -> Optional[float]:
    """Scale at which a quantized conv can emit int8 directly: requires a
    calibrated scale for its output tensor and every consumer able to
    carry int8 forward.  None -> emit float."""
    return _emit(conv_name, graph.consumers(conv_name), graph.outputs,
                 tensor_scales)


def _emit(name, consumers, outputs, tensor_scales) -> Optional[float]:
    if (name in tensor_scales and consumers and name not in outputs
            and all(c.op in _CHAINABLE for c in consumers)):
        return float(tensor_scales[name])
    return None


# ---------------------------------------------------------------------------
# the int8 conv
# ---------------------------------------------------------------------------

def gemm_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(k*k*Cin, Cout) int8 matrix of OIHW ``w_q`` for the shifted-slice
    product: rows tap-major (ky, kx), then input channel, as
    :func:`_shifted_slices` lays out the columns; zero rows up to a
    multiple of 16 and zero columns up to a multiple of 4 (K5's
    alignment)."""
    o, i, kh, kw = (int(s) for s in w_q.shape)
    mat = w_q.permute(2, 3, 1, 0).reshape(kh * kw * i, o)
    k_pad = -(-mat.shape[0] // 16) * 16 - mat.shape[0]
    n_pad = -(-o // 4) * 4 - o
    return F.pad(mat, (0, n_pad, 0, k_pad)).contiguous()


def _out_size(size: int, a: Dict) -> int:
    k, s, p, d = a["kernel"], a["stride"], a["padding"], a["dilation"]
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _shifted_slices(x_q: torch.Tensor, a: Dict, k_cols: int
                    ) -> torch.Tensor:
    """The (N*Ho*Wo, k_cols) int8 matrix of an int8 NCHW conv input: row
    r holds, for output pixel r (row-major over N, Ho, Wo), the Cin
    channels under each of the k*k taps in (ky, kx) order, zero where a
    tap falls in the padding, and zeros past k*k*Cin."""
    n, c, h, w = (int(s) for s in x_q.shape)
    k, s, p, d = a["kernel"], a["stride"], a["padding"], a["dilation"]
    ho, wo = _out_size(h, a), _out_size(w, a)
    x = x_q.permute(0, 2, 3, 1)  # NHWC view (a copy-free one if the
    # tensor is channels_last, as the int8 chain leaves it)
    if k == 1 and s == 1 and p == 0 and k_cols == c:
        # a view where the pixels merge (channels_last), else a copy;
        # contiguous() also copies the merged view of an NCHW tensor of
        # one image, whose rows would be strided
        return x.reshape(n * h * w, c).contiguous()
    if p:
        x = F.pad(x, (0, 0, p, p, p, p))
    cols = x.new_zeros((n, ho, wo, k_cols))
    for ky in range(k):
        for kx in range(k):
            t = ky * k + kx
            cols[..., t * c:(t + 1) * c] = x[
                :, ky * d:ky * d + s * (ho - 1) + 1:s,
                kx * d:kx * d + s * (wo - 1) + 1:s]
    return cols.reshape(n * ho * wo, k_cols)


def _qconv_gemm(x_q: torch.Tensor, w_mat: torch.Tensor, a: Dict,
                mm: Callable) -> torch.Tensor:
    """int32 NCHW accumulators of the conv of int8 ``x_q`` as one product
    ``mm(shifted slices, w_mat)`` (``w_mat`` from :func:`gemm_weights`);
    the result is channels_last in memory."""
    n, _, h, w = (int(s) for s in x_q.shape)
    ho, wo = _out_size(h, a), _out_size(w, a)
    acc = mm(_shifted_slices(x_q, a, int(w_mat.shape[0])), w_mat)
    cout = a["out_ch"]
    return acc[:, :cout].reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


def _qconv_plain(x_q: torch.Tensor, w_q: torch.Tensor, a: Dict
                 ) -> torch.Tensor:
    """The int32 accumulators of the int8 conv as a float64 ``F.conv2d``
    of the int8 values: exact, every product and partial sum being an
    integer of magnitude below 2**53."""
    y = F.conv2d(x_q.double(), w_q.double(), stride=a["stride"],
                 padding=a["padding"], dilation=a["dilation"])
    return y.to(torch.int32)


def qconv_acc(x_q: torch.Tensor, qp: Dict, a: Dict) -> torch.Tensor:
    """int32 accumulators of a quantized conv: K5 on a CUDA tensor (its
    GEMM matrix made once, into ``qp["w_mat"]``), :func:`_qconv_plain`
    on a CPU one."""
    if x_q.device.type == "cpu":
        return _qconv_plain(x_q, qp["w_q"], a)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8 conv: no kernel for device {x_q.device}")
    from dcfp_tpu_torch.ops.int8 import tiled_mm
    if "w_mat" not in qp:
        qp["w_mat"] = gemm_weights(qp["w_q"])
    return _qconv_gemm(x_q, qp["w_mat"], a, tiled_mm)


# ---------------------------------------------------------------------------
# quantized interpreter
# ---------------------------------------------------------------------------

class _QT:
    """int8 tensor + its symmetric per-tensor scale (value = q * s)."""
    __slots__ = ("q", "s")

    def __init__(self, q, s: float):
        self.q, self.s = q, float(s)


def _to_float(v, dtype):
    if isinstance(v, _QT):
        return (v.q.float() * v.s).to(dtype)
    return v


def _to_q(v, s: float):
    """(Re)quantize a float tensor or a _QT to scale ``s``."""
    if isinstance(v, _QT):
        if abs(v.s - s) < 1e-12 * max(s, v.s):
            return v.q
        return torch.clamp(torch.round(v.q.float() * (v.s / s)),
                           -127, 127).to(torch.int8)
    return torch.clamp(torch.round(v.float() * (1.0 / s)),
                       -127, 127).to(torch.int8)


def _qconv(v, node: Node, qp: Dict, s_in: float, s_out: Optional[float],
           compute_dtype):
    """int8 conv.  Emits a _QT at the conv output's calibrated scale
    ``s_out`` (when not None) so downstream convs chain in int8, else a
    float tensor."""
    acc = qconv_acc(_to_q(v, s_in), qp, node.attrs)
    y = acc.float() * qp["rescale"][:, None, None]
    if "bias" in qp:
        y = y + qp["bias"][:, None, None]
    if s_out is not None:
        q = torch.clamp(torch.round(y * (1.0 / s_out)), -127,
                        127).to(torch.int8)
        return _QT(q, s_out)
    return y.to(compute_dtype)


def _max_pool_q(q: torch.Tensor, a: Dict) -> torch.Tensor:
    """Max pool of int8 values, exactly: through float32, which holds
    them (F.max_pool2d takes no int8); its -inf padding never wins, as
    every window holds a value of the image."""
    from dcfp_tpu_torch.ops.pool import max_pool
    return max_pool(q.float(), a["kernel"], a["stride"],
                    a["padding"]).to(torch.int8)


@torch.inference_mode()
def quant_graph_apply(graph: Graph, params, state, qparams: Dict,
                      inputs, compute_dtype=torch.bfloat16,
                      tensor_scales: Optional[Dict[str, float]] = None, *,
                      channels_first: bool = False,
                      observe: Optional[Callable] = None):
    """graph_apply (eval mode) with int8 convs chained through relu /
    maxpool / residual-add / concat.  Non-conv arithmetic and any conv
    missing from ``qparams`` run the float path.  Inputs and outputs are
    NHWC, or NCHW with ``channels_first=True``; outputs are in
    ``compute_dtype``.  ``observe(name, value)`` sees each node's value
    (a ``_QT`` or a tensor) as it is made; a value is freed after its
    last consumer."""
    tensor_scales = tensor_scales or {}
    nodes = list(graph.toposorted())
    last_use = {}
    for i, node in enumerate(nodes):
        for parent in node.inputs:
            last_use[parent] = i
        if "like" in node.attrs:
            last_use[node.attrs["like"]] = i
    for out in graph.outputs:
        last_use[out] = len(nodes)
    consumers: Dict[str, list] = {}
    for node in nodes:
        for parent in node.inputs:
            consumers.setdefault(parent, []).append(node)
    vals: Dict = {}
    input_hw = None

    def fv(name):  # float view of a stored value
        return _to_float(vals[name], compute_dtype)

    for i, node in enumerate(nodes):
        op = node.op
        if op == "input":
            x = inputs[node.name]
            x = x if channels_first else x.permute(0, 3, 1, 2)
            y = x.to(compute_dtype)
            input_hw = (int(y.shape[-2]), int(y.shape[-1]))
        elif op == "conv":
            if node.name in qparams and node.inputs[0] in tensor_scales:
                y = _qconv(vals[node.inputs[0]], node, qparams[node.name],
                           float(tensor_scales[node.inputs[0]]),
                           _emit(node.name, consumers.get(node.name),
                                 graph.outputs, tensor_scales),
                           compute_dtype)
            else:
                y = A._conv(fv(node.inputs[0]), node, params[node.name])
        elif op == "bn":
            y, _ = A._bn(fv(node.inputs[0]), node, params[node.name],
                         state[node.name], False)
        elif op == "relu":
            v = vals[node.inputs[0]]
            # int8 relu: symmetric scale keeps zero at 0
            y = (_QT(v.q.clamp_min(0), v.s) if isinstance(v, _QT)
                 else torch.relu(v))
        elif op == "sigmoid":
            y = torch.sigmoid(fv(node.inputs[0]))
        elif op == "add":
            ins = [vals[n] for n in node.inputs]
            s_out = tensor_scales.get(node.name)
            if s_out is not None and all(isinstance(v, _QT) for v in ins):
                # requant-and-add elementwise: q3 = clip(round(
                # q1*(s1/s3) + q2*(s2/s3)))
                acc = ins[0].q.float() * (ins[0].s / s_out)
                for v in ins[1:]:
                    acc = acc + v.q.float() * (v.s / s_out)
                y = _QT(torch.clamp(torch.round(acc), -127,
                                    127).to(torch.int8), s_out)
            else:
                y = _to_float(ins[0], compute_dtype)
                for v in ins[1:]:
                    y = y + _to_float(v, compute_dtype)
        elif op == "mul":
            y = fv(node.inputs[0])
            for other in node.inputs[1:]:
                y = y * fv(other)
        elif op == "concat":
            ins = [vals[n] for n in node.inputs]
            s_out = tensor_scales.get(node.name)
            if s_out is not None and all(isinstance(v, _QT) for v in ins):
                y = _QT(torch.cat([_to_q(v, s_out) for v in ins], dim=1),
                        s_out)
            else:
                y = torch.cat([_to_float(v, compute_dtype) for v in ins],
                              dim=1)
        elif op == "maxpool":
            a = node.attrs
            v = vals[node.inputs[0]]
            if isinstance(v, _QT):  # monotonic: stays int8
                y = _QT(_max_pool_q(v.q, a), v.s)
            else:
                from dcfp_tpu_torch.ops.pool import max_pool
                y = max_pool(v, a["kernel"], a["stride"], a["padding"])
        elif op == "avgpool":
            from dcfp_tpu_torch.ops.pool import adaptive_avg_pool
            y = adaptive_avg_pool(fv(node.inputs[0]),
                                  node.attrs["out_size"])
        elif op == "globalpool":
            from dcfp_tpu_torch.ops.pool import global_avg_pool
            y = global_avg_pool(fv(node.inputs[0]))
        elif op == "resize":
            from dcfp_tpu_torch.ops.resize import resize_bilinear_cf
            x = fv(node.inputs[0])
            a = node.attrs
            if "like" in a:
                ref = vals[a["like"]]
                if isinstance(ref, _QT):  # shape lives on the int8 payload
                    ref = ref.q
                target = tuple(ref.shape[-2:])
            elif a.get("to_input"):
                target = input_hw
            else:
                target = (int(round(x.shape[-2] * a["scale"])),
                          int(round(x.shape[-1] * a["scale"])))
            y = resize_bilinear_cf(x, target, a["align_corners"])
        elif op in ("identity", "dropout", "barrier"):
            y = vals[node.inputs[0]]
        else:
            raise NotImplementedError(f"op {op!r} in quantized graph")
        vals[node.name] = y
        if observe is not None:
            observe(node.name, y)
        for parent in set(node.inputs) | ({node.attrs["like"]}
                                          if "like" in node.attrs
                                          else set()):
            if last_use.get(parent) == i:
                vals.pop(parent, None)
    outs = {name: _to_float(vals[name], compute_dtype)
            for name in graph.outputs}
    if channels_first:
        return outs
    return {k: v.permute(0, 2, 3, 1) for k, v in outs.items()}


# ---------------------------------------------------------------------------
# deploy entry
# ---------------------------------------------------------------------------

def _params_device(params) -> torch.device:
    for d in params.values():
        for v in d.values():
            return v.device
    return torch.device("cpu")


def _to_device(tree, dev: torch.device, dtype: torch.dtype):
    return {n: {k: (v.to(dev, dtype) if v.is_floating_point()
                    else v.to(dev)) for k, v in d.items()}
            for n, d in tree.items()}


def make_int8_inference_fn(graph: Graph, params, state, *,
                           calib_batches: Iterable[np.ndarray],
                           percentile: float = 100.0,
                           output: str = "argmax",
                           compute_dtype=torch.bfloat16,
                           device: DeviceLike = None):
    """BN-fold, calibrate, quantize; returns (fn, bundle) with
    ``fn(bundle, image)`` -> uint8 (N, H, W) labels (``output="argmax"``;
    through K1 when the graph ends in a to-input resize 'pred') or f32
    NHWC logits, for an NHWC image.  Params and state are the port's
    tensors; everything runs on ``device`` (CUDA unless asked)."""
    from dcfp_tpu_torch.engine.deploy import fold_batchnorm, split_pred_tail
    dev = resolve_device(device)
    graph, params, state = fold_batchnorm(graph, params, state)
    tensor_scales = calibrate_tensor_scales(graph, params, state,
                                            calib_batches, percentile, dev)
    act_scales = {n.name: tensor_scales[n.inputs[0]]
                  for n in graph.conv_nodes()}
    qparams = quantize_params(graph, params, act_scales=act_scales,
                              tensor_scales=tensor_scales)
    qparams = {name: {k: v.to(dev) for k, v in d.items()}
               for name, d in qparams.items()}
    float_params = _to_device({k: v for k, v in params.items()
                               if k not in qparams}, dev, compute_dtype)
    state = _to_device(state, dev, torch.float32)

    tail_resize = None
    run_graph = graph
    if output == "argmax" and "pred" in graph.nodes:
        run_graph, tail_resize = split_pred_tail(graph)

    # "scales" rides along for callers that run quant_graph_apply on the
    # folded graph themselves; fn reads only "q" and "f"
    bundle = {"q": qparams, "f": float_params, "scales": tensor_scales}

    @torch.inference_mode()
    def fn(bundle, image):
        x = image.to(dev).permute(0, 3, 1, 2)
        if dev.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        outs = quant_graph_apply(run_graph, bundle["f"], state, bundle["q"],
                                 {run_graph.inputs[0]: x},
                                 compute_dtype=compute_dtype,
                                 tensor_scales=tensor_scales,
                                 channels_first=True)
        if tail_resize is not None:
            from dcfp_tpu_torch.ops.kernels import resize_argmax_cm
            z = outs[tail_resize.inputs[0]]
            if dev.type == "cuda":
                z = z.contiguous(memory_format=torch.channels_last)
            return resize_argmax_cm(z,
                                    tuple(image.shape[1:3]),
                                    tail_resize.attrs["align_corners"])
        pred = outs["pred"]
        if output == "argmax":
            return torch.argmax(pred, dim=1).to(torch.uint8)
        return pred.permute(0, 2, 3, 1).float()

    return fn, bundle


def argmax_agreement(labels_a, labels_b) -> float:
    """Fraction of pixels where two label maps agree (the data-free
    accuracy guardrail for quantization)."""
    a = labels_a.cpu().numpy() if isinstance(labels_a, torch.Tensor) \
        else np.asarray(labels_a)
    b = labels_b.cpu().numpy() if isinstance(labels_b, torch.Tensor) \
        else np.asarray(labels_b)
    return float((a == b).mean())
