"""The port's int8 PTQ (``dcfp_tpu_torch/engine/quantize.py``) against the
JAX package's (``dcfp_tpu/engine/quantize.py``) on the CPU, on the
``small_net`` and ``residual_net`` of ``tests/test_quantize.py`` built in
each package's IR from the same numpy params: the same quantization
points; activation scales within float32 rtol 1e-6 (absmax and
percentile); ``w_q`` bit-equal; ``rescale`` within rtol 1e-6; the int32
accumulators of every conv shape equal (the port's float64 plain conv and
its shifted-slice product, the one K5 runs on the card, against XLA's
int8 conv); the f32-compute int8 labels equal to the JAX package's; and
the JAX test's own agreement with the float model."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_quantize
from dcfp_tpu.engine import deploy as jdeploy
from dcfp_tpu.engine import quantize as jq
from dcfp_tpu_torch.bridge import params_from_numpy
from dcfp_tpu_torch.engine import deploy as tdeploy
from dcfp_tpu_torch.engine import quantize as tq
from dcfp_tpu_torch.graph.apply import graph_apply
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.ops import int8
from dcfp_tpu_torch.ops.int8 import tiled_mm_plain
from test_torch_deploy import np_params

NETS = {"small": (test_quantize.small_net, 32),
        "residual": (test_quantize.residual_net, 48)}


def _nets(key, monkeypatch):
    """(JAX graph, port graph, numpy params, state, calib, image)."""
    build, hw = NETS[key]
    jg = build()
    with monkeypatch.context() as m:
        m.setattr(test_quantize, "GraphBuilder", TBuilder)
        tg = build()
    params, state = np_params(jg, 1)
    r = np.random.default_rng(7)
    calib = [r.standard_normal((1, hw, hw, 3)).astype(np.float32)
             for _ in range(2)]
    image = r.standard_normal((2, hw, hw, 3)).astype(np.float32)
    return jg, tg, params, state, calib, image


def _folded(jg, tg, params, state):
    jf = jdeploy.fold_batchnorm(jg, params, state)
    tp, ts = params_from_numpy(params, state, device="cpu")
    return jf, tdeploy.fold_batchnorm(tg, tp, ts)


@pytest.mark.parametrize("key", sorted(NETS))
def test_quant_points_and_emits_match_jax(key, monkeypatch):
    jg, tg, params, state, calib, _ = _nets(key, monkeypatch)
    (jfg, jfp, jfs), (tfg, tfp, tfs) = _folded(jg, tg, params, state)
    assert tq.quant_points(tfg) == jq.quant_points(jfg)
    scales = jq.calibrate_tensor_scales(jfg, jfp, jfs, calib)
    assert ({n.name: tq._emit_scale(tfg, n.name, scales)
             for n in tfg.conv_nodes()}
            == {n.name: jq._emit_scale(jfg, n.name, scales)
                for n in jfg.conv_nodes()})


@pytest.mark.parametrize("percentile", [100.0, 99.0])
@pytest.mark.parametrize("key", sorted(NETS))
def test_scales_match_jax(key, percentile, monkeypatch):
    jg, tg, params, state, calib, _ = _nets(key, monkeypatch)
    (jfg, jfp, jfs), (tfg, tfp, tfs) = _folded(jg, tg, params, state)
    want = jq.calibrate_tensor_scales(jfg, jfp, jfs, calib, percentile)
    got = tq.calibrate_tensor_scales(tfg, tfp, tfs, calib, percentile)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert (tq.calibrate_act_scales(tfg, tfp, tfs, calib, percentile).keys()
            == jq.calibrate_act_scales(jfg, jfp, jfs, calib,
                                       percentile).keys())


def test_abs_quantile_matches_jnp_quantile():
    """The percentile statistic: bit-equal to ``jnp.quantile`` of |x|, also
    past the 2**24 elements ``torch.quantile`` refuses (where the float32
    index arithmetic of the JAX package's rounds the position)."""
    r = np.random.default_rng(3)
    x = r.standard_normal((3, 17, 23, 29)).astype(np.float32)
    for q in (0.5, 0.99, 0.999, 1.0):
        want = np.asarray(jnp.quantile(jnp.abs(jnp.asarray(x)).ravel(), q))
        got = tq.abs_quantile(torch.from_numpy(x), q)
        assert got.dtype == torch.float32
        assert got.item() == want.item(), q
    big = torch.from_numpy(r.standard_normal(2 ** 24 + 3).astype(np.float32))
    with pytest.raises(RuntimeError):
        torch.quantile(big.abs(), 0.99)
    want = np.asarray(jnp.quantile(jnp.abs(jnp.asarray(big.numpy())), 0.99))
    assert tq.abs_quantile(big, 0.99).item() == want.item()


@pytest.mark.parametrize("key", sorted(NETS))
def test_quantize_params_match_jax(key, monkeypatch):
    """w_q bit-equal (OIHW against HWIO), rescale within rtol 1e-6, from
    each package's own calibration; bias the folded bias."""
    jg, tg, params, state, calib, _ = _nets(key, monkeypatch)
    (jfg, jfp, jfs), (tfg, tfp, tfs) = _folded(jg, tg, params, state)
    jts = jq.calibrate_tensor_scales(jfg, jfp, jfs, calib)
    tts = tq.calibrate_tensor_scales(tfg, tfp, tfs, calib)
    want = jq.quantize_params(
        jfg, jfp, {n.name: jts[n.inputs[0]] for n in jfg.conv_nodes()}, jts)
    got = tq.quantize_params(
        tfg, tfp, {n.name: tts[n.inputs[0]] for n in tfg.conv_nodes()}, tts)
    assert set(got) == set(want) == {n.name for n in tfg.conv_nodes()}
    for name, w in want.items():
        g = got[name]
        assert g["w_q"].dtype == torch.int8
        np.testing.assert_array_equal(
            g["w_q"].numpy().transpose(2, 3, 1, 0), np.asarray(w["w_q"]))
        np.testing.assert_allclose(g["rescale"].numpy(),
                                   np.asarray(w["rescale"]), rtol=1e-6)
        assert set(g) == set(w)
        if "bias" in w:
            np.testing.assert_array_equal(g["bias"].numpy(),
                                          np.asarray(w["bias"]))
    assert int(got["s1.conv"]["w_q"].abs().max()) == 127


CONVS = [  # (cin, cout, kernel, stride, padding, dilation, hw)
    (3, 16, 3, 2, 1, 1, (33, 47)),  # the stem: K = 27 -> 32 columns
    (16, 32, 3, 1, 1, 1, (17, 23)),
    (24, 12, 3, 1, 2, 2, (19, 21)),  # dilated (layer3 at os 8)
    (20, 10, 3, 1, 4, 4, (13, 29)),  # dilated past the band of rows
    (40, 6, 1, 1, 0, 1, (15, 16)),  # 1x1, N = 6 -> 8 columns
    (32, 64, 1, 1, 0, 1, (9, 11)),  # 1x1, one contiguous (M, Cin) view
    (16, 8, 1, 2, 0, 1, (21, 20)),  # strided 1x1 (downsample)
]


def _k5_plain(a, b):
    """K5's plain version behind the checks its launch makes on the card
    (contiguity, K and N alignment)."""
    int8.mm_launch_plan(a, b)
    return tiled_mm_plain(a, b)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("cin,cout,k,s,p,d,hw", CONVS)
def test_int32_accumulators_match_jax(cin, cout, k, s, p, d, hw, n):
    """The accumulators of XLA's int8 conv (the JAX package's ``_qconv``
    product), the port's float64 plain conv and its shifted-slice product
    through K5's plain version (behind K5's launch checks): equal,
    int32."""
    r = np.random.default_rng(cin * 7 + k + n)
    x = r.integers(-127, 128, (n, cin) + hw).astype(np.int8)
    w = r.integers(-127, 128, (cout, cin, k, k)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(w.transpose(2, 3, 1, 0)), window_strides=(s, s),
        padding=((p, p), (p, p)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)).transpose(0, 3, 1, 2)
    a = dict(kernel=k, stride=s, padding=p, dilation=d, out_ch=cout)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = tq._qconv_plain(xt, wt, a)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    w_mat = tq.gemm_weights(wt)
    assert w_mat.shape[0] % 16 == 0 and w_mat.shape[1] % 4 == 0
    # the int8 chain hands convs channels_last tensors; both layouts
    for xin in (xt, xt.contiguous(memory_format=torch.channels_last)):
        gemm = tq._qconv_gemm(xin, w_mat, a, _k5_plain)
        assert gemm.dtype == torch.int32
        np.testing.assert_array_equal(gemm.numpy(), want)
    np.testing.assert_array_equal(
        tq.qconv_acc(xt, {"w_q": wt}, a).numpy(), want)


@pytest.mark.parametrize("key", sorted(NETS))
def test_int8_labels_match_jax(key, monkeypatch):
    """f32 compute: the port's int8 labels (its own calibration, its K1
    tail's plain version) equal the JAX package's int8 labels; with the
    JAX package's scales and quantized weights its quantized interpreter
    gives the JAX package's logits within 1e-6 x max."""
    jg, tg, params, state, calib, image = _nets(key, monkeypatch)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, state)
    jfn, jbundle = jq.make_int8_inference_fn(
        jg, jp, js, calib_batches=calib, output="argmax",
        compute_dtype=jnp.float32)
    want = np.asarray(jax.jit(jfn)(jbundle, jnp.asarray(image)))
    tp, ts = params_from_numpy(params, state, device="cpu")
    tfn, tbundle = tq.make_int8_inference_fn(
        tg, tp, ts, calib_batches=calib, output="argmax",
        compute_dtype=torch.float32, device="cpu")
    got = tfn(tbundle, torch.from_numpy(image))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)

    (jfg, jfp, jfs), (tfg, tfp, tfs) = _folded(jg, tg, params, state)
    jts = jq.calibrate_tensor_scales(jfg, jfp, jfs, calib)
    jqp = jq.quantize_params(
        jfg, jfp, {n.name: jts[n.inputs[0]] for n in jfg.conv_nodes()}, jts)
    jlog = np.asarray(jq.quant_graph_apply(
        jfg, {}, jfs, jqp, {"image": jnp.asarray(image)},
        compute_dtype=jnp.float32, tensor_scales=jts)["pred"])
    tqp = {n: {"w_q": torch.from_numpy(np.asarray(d["w_q"]).transpose(
        3, 2, 0, 1).copy()), **{k: torch.from_numpy(np.array(v))
                                for k, v in d.items() if k != "w_q"}}
           for n, d in jqp.items()}
    tlog = tq.quant_graph_apply(tfg, {}, tfs, tqp,
                                {"image": torch.from_numpy(image)},
                                compute_dtype=torch.float32,
                                tensor_scales=jts)["pred"].numpy()
    np.testing.assert_allclose(tlog, jlog, rtol=0,
                               atol=1e-6 * np.abs(jlog).max())


@pytest.mark.parametrize("key,floor", [("small", 0.95), ("residual", 0.98)])
def test_int8_agreement_with_float(key, floor, monkeypatch):
    """tests/test_quantize.py's guardrail on the port: int8 labels against
    the float model's, above 0.95 (small_net) and 0.98 (residual_net,
    whose interior convs chain in int8)."""
    jg, tg, params, state, calib, image = _nets(key, monkeypatch)
    tp, ts = params_from_numpy(params, state, device="cpu")
    fn, bundle = tq.make_int8_inference_fn(
        tg, tp, ts, calib_batches=calib, output="argmax",
        compute_dtype=torch.float32, device="cpu")
    q_labels = fn(bundle, torch.from_numpy(image))
    outs, _ = graph_apply(tg, tp, ts, {"image": torch.from_numpy(image)})
    f_labels = torch.argmax(outs["pred"], -1)
    assert tq.argmax_agreement(q_labels, f_labels) > floor
    logits_fn, lb = tq.make_int8_inference_fn(
        tg, tp, ts, calib_batches=calib, output="logits",
        compute_dtype=torch.float32, device="cpu")
    logits = logits_fn(lb, torch.from_numpy(image))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == tuple(outs["pred"].shape)


def test_k5_route_through_the_interpreter(monkeypatch):
    """The whole int8 deploy of residual_net (int8 and float concats, a
    pooled branch, a strided stem), batch 1, with every conv's product
    taken the way the card takes it: shifted slices and the GEMM matrix
    into K5's plain version behind its launch checks.  The labels equal
    those of the plain float64 conv route."""
    jg, tg, params, state, calib, image = _nets("residual", monkeypatch)
    tp, ts = params_from_numpy(params, state, device="cpu")
    x = torch.from_numpy(image[:1])
    fn, bundle = tq.make_int8_inference_fn(
        tg, tp, ts, calib_batches=calib, output="logits",
        compute_dtype=torch.float32, device="cpu")
    want = fn(bundle, x)
    routed = []

    def gemm_acc(x_q, qp, a):
        routed.append(a["kernel"])
        return tq._qconv_gemm(x_q, tq.gemm_weights(qp["w_q"]), a, _k5_plain)

    monkeypatch.setattr(tq, "qconv_acc", gemm_acc)
    got = fn(bundle, x)
    assert len(routed) == len(bundle["q"]) == 6
    torch.testing.assert_close(got, want, rtol=0, atol=0)
