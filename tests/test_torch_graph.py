"""The port's graph interpreter and initializer against the JAX package's,
on the CPU in float32.

Params are made with numpy from a seed, go to JAX as arrays and to the
port through ``bridge.params_from_numpy``; JAX runs eagerly."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfp_tpu.graph import apply as japply
from dcfp_tpu.graph.ir import GraphBuilder as JBuilder
from dcfp_tpu.models.registry import build_model as j_build_model
from dcfp_tpu_torch.bridge import params_from_numpy
from dcfp_tpu_torch.graph import apply as tapply
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.models.registry import build_model as t_build_model


def np_params(graph, seed):
    """Kaiming-uniform conv params and randomised BN params/statistics,
    in the JAX package's layout (HWIO kernels)."""
    r = np.random.default_rng(seed)
    params, state = {}, {}
    for node in graph.toposorted():
        a = node.attrs
        if node.op == "conv":
            cin = a["in_ch"] // a["groups"]
            bound = 1.0 / math.sqrt(a["kernel"] ** 2 * cin)
            p = {"kernel": r.uniform(-bound, bound, (a["kernel"], a["kernel"],
                                                     cin, a["out_ch"]))}
            if a["bias"]:
                p["bias"] = r.uniform(-bound, bound, a["out_ch"])
            params[node.name] = {k: v.astype(np.float32) for k, v in p.items()}
        elif node.op == "bn":
            ch = a["channels"]
            params[node.name] = {
                "scale": r.uniform(0.5, 1.5, ch).astype(np.float32),
                "bias": r.normal(0.0, 0.1, ch).astype(np.float32)}
            state[node.name] = {
                "mean": r.normal(0.0, 0.1, ch).astype(np.float32),
                "var": r.uniform(0.5, 1.5, ch).astype(np.float32)}
    return params, state


def run_both(build, inputs, seed=0, input_hw=None):
    """Build the same graph with both packages' builders, run both on the
    same numpy params and inputs; returns ({out: (jax, port)} as NHWC
    numpy)."""
    jg, tg = build(JBuilder), build(TBuilder)
    params, state = np_params(jg, seed)
    jout, _ = japply.graph_apply(
        jg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in inputs.items()}, input_hw=input_hw)
    tp, ts = params_from_numpy(params, state, device="cpu")
    tout, _ = tapply.graph_apply(
        tg, tp, ts, {k: torch.from_numpy(v) for k, v in inputs.items()},
        input_hw=input_hw)
    return {k: (np.asarray(jout[k]), tout[k].numpy()) for k in jg.outputs}


def _conv_graph(kernel, stride, dilation, groups=1, bias=False):
    def build(B):
        b = B("g")
        x = b.input("image", channels=8)
        b.conv(x, "c", out_ch=8, kernel=kernel, stride=stride,
               dilation=dilation, groups=groups, bias=bias)
        return b.finish(["c"])
    return build


@pytest.mark.parametrize("kernel,stride,dilation,groups,bias", [
    (1, 1, 1, 1, False), (3, 1, 1, 1, True), (3, 2, 1, 1, False),
    (3, 1, 2, 1, False), (3, 1, 12, 1, True), (3, 1, 24, 1, False),
    (3, 1, 36, 1, True), (7, 2, 1, 1, False), (3, 1, 1, 8, True),
])
def test_conv(rng, kernel, stride, dilation, groups, bias):
    """Including the dilations >= 18 that the JAX package runs as nine
    shifted matmuls.  atol 1e-5: f32 summation order."""
    x = rng.standard_normal((2, 40, 44, 8)).astype(np.float32)
    out = run_both(_conv_graph(kernel, stride, dilation, groups, bias),
                   {"image": x})
    j, t = out["c"]
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def _op_graph(kind):
    def build(B):
        b = B("g")
        x = b.input("image", channels=6)
        c = b.conv(x, "c0", out_ch=6, kernel=3)
        if kind == "bn":
            y = b.relu(b.bn(c, "bn"), "r")
        elif kind == "maxpool":
            y = b.maxpool(c, "mp", kernel=3, stride=2, padding=1)
        elif kind == "avgpool":
            y = b.concat([b.resize(b.adaptive_avgpool(c, f"ap{s}", out_size=s),
                                   f"up{s}", like=c, align_corners=s % 2 == 0)
                          for s in (1, 2, 3, 6)], "cat")
        elif kind == "se":  # globalpool, conv with bias, sigmoid, mul
            g = b.globalpool(c, "gp")
            g = b.conv(g, "fc", out_ch=6, kernel=1, padding=0, bias=True)
            y = b.mul([c, b.sigmoid(g, "sg")], "scale")
        elif kind == "add_concat":
            d = b.conv(x, "c1", out_ch=6, kernel=1, padding=0)
            y = b.concat([b.add_([c, d], "sum"), d], "cat")
        elif kind == "resize_scale":
            y = b.resize(c, "rs", scale=0.5, align_corners=False)
        elif kind == "resize_to_input":
            s = b.conv(c, "down", out_ch=6, kernel=3, stride=2)
            y = b.resize(s, "up", to_input=True, align_corners=True)
        elif kind == "identity_dropout":
            y = b.identity(b.dropout(c, "drop", rate=0.5), "id")
        return b.finish([y])
    return build


@pytest.mark.parametrize("kind", ["bn", "maxpool", "avgpool", "se",
                                  "add_concat", "resize_scale",
                                  "resize_to_input", "identity_dropout"])
def test_ops(rng, kind):
    """Eval BN, pools, concat, add, mul/sigmoid, all three resize forms,
    identity and eval dropout.  atol 1e-5: f32 summation order."""
    x = rng.standard_normal((2, 26, 30, 6)).astype(np.float32)
    (j, t), = run_both(_op_graph(kind), {"image": x}).values()
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_input_hw_override(rng):
    """``input_hw`` retargets to-input resizes, as for a re-rooted graph."""
    x = rng.standard_normal((1, 9, 11, 6)).astype(np.float32)
    (j, t), = run_both(_op_graph("resize_to_input"), {"image": x},
                       input_hw=(20, 24)).values()
    assert t.shape == (1, 20, 24, 6)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_graph_matches_jax(dtype):
    """Same keys, shapes (OIHW vs HWIO), dtypes and kaiming-uniform
    bounds; BN scale/bias 1/0 and statistics 0/1."""
    def build(B):
        b = B("g")
        x = b.input("image")
        c = b.conv(x, "c", out_ch=64, kernel=3, stride=2)
        c = b.bn(c, "n")
        c = b.conv(c, "dw", out_ch=64, kernel=3, groups=64, bias=True)
        return b.finish([b.conv(c, "cls", out_ch=19, kernel=1, padding=0,
                                bias=True)])
    jg, tg = build(JBuilder), build(TBuilder)
    jp, js = japply.init_graph(jg, jax.random.key(0),
                               getattr(jnp, dtype))
    tp, ts = tapply.init_graph(tg, torch.Generator().manual_seed(0),
                               getattr(torch, dtype), device="cpu")
    assert jax.tree.structure(jp) == jax.tree.structure(
        {k: dict(v) for k, v in tp.items()})
    assert set(js) == set(ts)
    for name, p in jp.items():
        node = tg.node(name)
        for k, v in p.items():
            t = tp[name][k]
            want_shape = (v.shape if v.ndim != 4 else
                          (v.shape[3], v.shape[2], v.shape[0], v.shape[1]))
            assert tuple(t.shape) == want_shape, (name, k)
            assert str(t.dtype).split(".")[1] == str(v.dtype), (name, k)
            if node.op == "conv":
                a = node.attrs
                bound = 1.0 / math.sqrt(a["kernel"] ** 2 *
                                        (a["in_ch"] // a["groups"]))
                # bf16 rounding may step one bf16 ulp past the f32 bound
                slack = 1.0 + (2.0 ** -8 if dtype == "bfloat16" else 0.0)
                for arr in (np.asarray(v, np.float32), t.float().numpy()):
                    assert np.abs(arr).max() <= bound * slack
                    if arr.size >= 1000:  # spread over the whole interval
                        assert np.abs(arr).max() > 0.95 * bound
            else:
                np.testing.assert_array_equal(t.float().numpy(),
                                              np.asarray(v, np.float32))
    for name, s in js.items():
        for k, v in s.items():
            assert ts[name][k].dtype == torch.float32
            np.testing.assert_array_equal(ts[name][k].numpy(), np.asarray(v))


def test_init_graph_is_seeded():
    g = t_build_model("simple", backbone="resnet50", num_classes=5).graph
    a, _ = tapply.init_graph(g, torch.Generator().manual_seed(3),
                             device="cpu")
    b, _ = tapply.init_graph(g, torch.Generator().manual_seed(3),
                             device="cpu")
    assert all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


R50_CFG = dict(backbone="resnet50",
               backbone_para={"os": 8, "mg_unit": [1, 2, 4], "inplanes": 128},
               num_classes=19, align_corner=True, deepsup=False)


def test_deeplabv3_r50_forward(rng):
    """The whole train model of the recipe at (1, 65, 65, 3), f32.
    Tolerance 1e-4 x max|logit|: ~100 layers of f32 convs summed in
    another order than XLA's."""
    x = rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    out = run_both(lambda B: (j_build_model if B is JBuilder
                              else t_build_model)("deeplabv3",
                                                  **R50_CFG).graph,
                   {"image": x}, seed=1)
    j, t = out["pred"]
    assert t.shape == (1, 65, 65, 19) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max())
