"""The port's deploy path and prune search against the JAX package's, on
the CPU: BN folding, the inference function (NHWC and NCHW input, logits
and argmax through the resize-argmax tail), and the FLOPs-targeted prune
of the bench configuration (DeepLabV3-R101 at 50% FLOPs).

Params are made with numpy from a seed; JAX runs eagerly with its Pallas
tail in interpret mode (CPU backend)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfp_tpu.engine import deploy as jdeploy
from dcfp_tpu.graph.ir import GraphBuilder as JBuilder
from dcfp_tpu.models.registry import build_model as j_build_model
from dcfp_tpu.prune.eic import prunable_bn_names as j_prunable
from dcfp_tpu.prune.search import prune_to_flops as j_prune_to_flops
from dcfp_tpu_torch.bridge import params_from_numpy, params_to_numpy
from dcfp_tpu_torch.engine import deploy as tdeploy
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.models.registry import build_model as t_build_model
from dcfp_tpu_torch.ops import kernels
from dcfp_tpu_torch.prune.eic import prunable_bn_names as t_prunable
from dcfp_tpu_torch.prune.search import prune_to_flops as t_prune_to_flops


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


def _tail_graph(B, relu_tail=False):
    """tests/test_pallas.py's deploy-tail graph."""
    b = B("m")
    x = b.input("image")
    x = b.conv(x, "c1", out_ch=8, kernel=3, stride=2)
    x = b.bn(x, "n1")
    x = b.relu(x, "r1")
    x = b.conv(x, "cls", out_ch=6, kernel=1, padding=0, bias=True)
    if relu_tail:
        x = b.relu(x, "r2")
    b.resize(x, "pred", to_input=True, align_corners=True)
    return b.finish(["pred"])


def _jax(fn, p, image):
    return np.asarray(fn(p, jnp.asarray(image)))


def _port(fn, p, image):
    return fn(p, torch.from_numpy(image)).numpy()


def assert_labels_match(got, want, logits, rel=1e-4):
    """Labels equal wherever the top-2 margin of the reference logits
    exceeds ``rel`` x max|logit| (below it, f32 summation order may
    legitimately flip the argmax)."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > rel * np.abs(logits).max()
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got[decided], want[decided])


def _compare_deploy(jg, tg, params, state, image):
    """JAX vs port make_inference_fn, f32: logits and argmax, NHWC and
    NCHW input."""
    tp, ts = params_from_numpy(params, state, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, state)
    for fmt in ("nhwc", "nchw"):
        img = image if fmt == "nhwc" else np.ascontiguousarray(
            image.transpose(0, 3, 1, 2))
        jfn, jpp = jdeploy.make_inference_fn(jg, jp, js, dtype=jnp.float32,
                                             output="logits",
                                             input_format=fmt)
        tfn, tpp = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.float32,
                                             output="logits",
                                             input_format=fmt, device="cpu")
        jl, tl = _jax(jfn, jpp, img), _port(tfn, tpp, img)
        assert tl.shape == jl.shape and tl.dtype == np.float32
        # f32 through conv chains summed in another order than XLA's
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max())
        jfn, jpp = jdeploy.make_inference_fn(jg, jp, js, dtype=jnp.float32,
                                             output="argmax",
                                             input_format=fmt)
        tfn, tpp = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.float32,
                                             output="argmax",
                                             input_format=fmt, device="cpu")
        ja, ta = _jax(jfn, jpp, img), _port(tfn, tpp, img)
        assert ta.dtype == np.uint8 and ta.shape == ja.shape
        assert_labels_match(ta, ja, jl)


@pytest.mark.parametrize("batch,relu_tail", [(1, False), (2, False),
                                             (1, True)])
def test_inference_fn_tail_graph(rng, batch, relu_tail):
    jg, tg = _tail_graph(JBuilder, relu_tail), _tail_graph(TBuilder, relu_tail)
    params, state = np_params(jg, 0)
    image = rng.standard_normal((batch, 33, 33, 3)).astype(np.float32)
    _compare_deploy(jg, tg, params, state, image)


def test_split_fn_hands_channel_major_logits_to_the_tail(rng):
    tg = _tail_graph(TBuilder)
    params, state = np_params(_tail_graph(JBuilder), 0)
    tp, ts = params_from_numpy(params, state, device="cpu")
    body, tail, p = tdeploy.make_split_inference_fn(
        tg, tp, ts, dtype=torch.float32, output="argmax", device="cpu")
    img = torch.from_numpy(rng.standard_normal((1, 33, 33, 3))
                           .astype(np.float32))
    z = body(p, img)
    assert tuple(z.shape) == (1, 6, 17, 17)
    labels = tail(z, tdeploy.infer_out_hw(img.shape))
    assert labels.shape == (1, 33, 33) and labels.dtype == torch.uint8
    # the tail is the resize-argmax of the graph's 'pred' node
    np.testing.assert_array_equal(
        labels.numpy(),
        kernels.resize_argmax_plain(z.permute(0, 2, 3, 1), (33, 33),
                                    True).numpy())
    fn, p2 = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.float32,
                                       output="argmax", device="cpu")
    np.testing.assert_array_equal(fn(p2, img).numpy(), labels.numpy())
    # no tail when the caller asks for logits
    _, tail2, _ = tdeploy.make_split_inference_fn(
        tg, tp, ts, dtype=torch.float32, output="logits", device="cpu")
    assert tail2 is None


def test_bf16_labels_agree(rng):
    """bf16 rounds at other places in the two frameworks (the conv bias
    is added in bf16 by XLA and may be fused by the port), so labels are
    compared by agreement, as the JAX package's own deploy notes do."""
    jg, tg = _tail_graph(JBuilder), _tail_graph(TBuilder)
    params, state = np_params(jg, 2)
    image = rng.standard_normal((2, 65, 65, 3)).astype(np.float32)
    jfn, jp = jdeploy.make_inference_fn(
        jg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, state), dtype=jnp.bfloat16,
        output="argmax")
    tp, ts = params_from_numpy(params, state, device="cpu")
    tfn, tpp = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.bfloat16,
                                         output="argmax", device="cpu")
    agree = (_jax(jfn, jp, image) == _port(tfn, tpp, image)).mean()
    assert agree >= 0.98, agree


def test_fold_batchnorm_bit_equal():
    """Host float64 folding, the same arithmetic: bit-equal params."""
    cfg = dict(backbone="resnet50", num_classes=19, align_corner=True)
    jg = j_build_model("deeplabv3", **cfg).graph
    tg = t_build_model("deeplabv3", **cfg).graph
    params, state = np_params(jg, 3)
    jg2, jp, js = jdeploy.fold_batchnorm(jg, params, state)
    tp0, ts0 = params_from_numpy(params, state, device="cpu")
    tg2, tp, ts = tdeploy.fold_batchnorm(tg, tp0, ts0)
    tpn, tsn = params_to_numpy(tp, ts)
    assert set(tpn) == set(jp) and set(tsn) == set(js)
    for name in jp:
        for k in jp[name]:
            np.testing.assert_array_equal(tpn[name][k], jp[name][k])
    assert [(n.name, n.op, n.attrs) for n in jg2.toposorted()] == \
        [(n.name, n.op, n.attrs) for n in tg2.toposorted()]


R101_CFG = dict(backbone="resnet101",
                backbone_para={"os": 8, "mg_unit": [1, 2, 4],
                               "inplanes": 128},
                num_classes=19, align_corner=True, deepsup=False)
PRUNE_KW = dict(prune_ratio=0.5, layer_keep=0.02, except_start_keys=(),
                channel_align=128)


def _bench_eic(graph):
    """The bench's synthetic EIC: |N(0, 1)| a channel, seed 0."""
    r = np.random.default_rng(0)
    return {bn: np.abs(r.standard_normal(
        graph.node(bn).attrs["channels"])).astype(np.float32)
        for bn in j_prunable(graph)}


@pytest.fixture(scope="module")
def pruned_r101():
    """The bench configuration, pruned by both packages from the same
    numpy params and the bench's synthetic EIC."""
    jg = j_build_model("deeplabv3", **R101_CFG).graph
    tg = t_build_model("deeplabv3", **R101_CFG).graph
    params, state = np_params(jg, 4)
    eic = _bench_eic(jg)
    assert list(eic) == t_prunable(tg)
    jres = j_prune_to_flops(jg, jg, params, state, eic, **PRUNE_KW)
    # the port prunes numpy copies of its own tensors
    tp, ts = params_to_numpy(*params_from_numpy(params, state, device="cpu"))
    tres = t_prune_to_flops(tg, tg, tp, ts, eic, **PRUNE_KW)
    return jres, tres


def test_prune_to_flops_matches_jax(pruned_r101):
    (jr, jgp, jrep), (tr, tgp, trep) = pruned_r101
    assert tgp == jgp == 0.58
    assert trep == jrep
    assert round(trep["flops_ratio"], 4) == 0.4694
    assert set(tr.channel_cfg) == set(jr.channel_cfg)
    for name, cfg in jr.channel_cfg.items():
        for k, v in cfg.items():
            np.testing.assert_array_equal(tr.channel_cfg[name][k], v)
    for tree_t, tree_j in ((tr.params, jr.params), (tr.state, jr.state)):
        assert set(tree_t) == set(tree_j)
        for name in tree_j:
            for k in tree_j[name]:
                np.testing.assert_array_equal(tree_t[name][k],
                                              tree_j[name][k])
    assert [(n.name, n.op, n.attrs) for n in jr.graph.toposorted()] == \
        [(n.name, n.op, n.attrs) for n in tr.graph.toposorted()]


def test_prune_trace_options(pruned_r101):
    """``trace="jaxpr"`` and ``"verify"`` prune the bench configuration to
    the IR trace's channel_cfg; another name raises."""
    (_, _, _), (tr, tgp, _) = pruned_r101
    tg = t_build_model("deeplabv3", **R101_CFG).graph
    params, state = np_params(tg, 4)
    eic = _bench_eic(tg)
    for trace in ("jaxpr", "verify"):
        res, gp, _ = t_prune_to_flops(tg, tg, params, state, eic,
                                      trace=trace, **PRUNE_KW)
        assert gp == tgp
        for name, cfg in tr.channel_cfg.items():
            for k, v in cfg.items():
                np.testing.assert_array_equal(res.channel_cfg[name][k], v)
    with pytest.raises(ValueError, match="ir|jaxpr|verify"):
        t_prune_to_flops(tg, tg, params, state, eic, trace="autograd")


def test_pruned_r101_inference(pruned_r101, rng):
    """The deploy model of the bench at 65x65, f32, through the tail."""
    (jr, _, _), (tr, _, _) = pruned_r101
    image = rng.standard_normal((1, 65, 65, 3)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, jr.params)
    js = jax.tree.map(jnp.asarray, jr.state)
    tp, ts = params_from_numpy(tr.params, tr.state, device="cpu")
    jfn, jpp = jdeploy.make_inference_fn(jr.graph, jp, js, dtype=jnp.float32,
                                         output="logits")
    tfn, tpp = tdeploy.make_inference_fn(tr.graph, tp, ts,
                                         dtype=torch.float32,
                                         output="logits", device="cpu")
    jl, tl = _jax(jfn, jpp, image), _port(tfn, tpp, image)
    assert tl.shape == (1, 65, 65, 19)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4 * np.abs(jl).max())
    jbody, jtail, jpp = jdeploy.make_split_inference_fn(
        jr.graph, jp, js, dtype=jnp.float32, output="argmax")
    ja = np.asarray(jtail(jbody(jpp, jnp.asarray(image)), (65, 65)))
    tfn, tpp = tdeploy.make_inference_fn(tr.graph, tp, ts,
                                         dtype=torch.float32,
                                         output="argmax", device="cpu")
    ta = _port(tfn, tpp, image)
    assert ta.dtype == np.uint8 and ta.shape == (1, 65, 65)
    assert_labels_match(ta, ja, jl)
    tfn, tpp = tdeploy.make_inference_fn(tr.graph, tp, ts,
                                         dtype=torch.float32,
                                         output="argmax",
                                         input_format="nchw", device="cpu")
    nchw = np.ascontiguousarray(image.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(_port(tfn, tpp, nchw), ta)


def test_benchmark_keys(rng):
    tg = _tail_graph(TBuilder)
    params, state = np_params(_tail_graph(JBuilder), 0)
    tp, ts = params_from_numpy(params, state, device="cpu")
    fn, p = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.float32,
                                      output="argmax", device="cpu")
    img = torch.from_numpy(rng.standard_normal((1, 17, 17, 3))
                           .astype(np.float32))
    stats = tdeploy.benchmark(lambda x: fn(p, x), img, warmup=1, iters=2,
                              blocks=2)
    assert set(stats) == {"ms_per_batch", "images_per_sec", "ms_blocks",
                          "ms_min", "ms_max"}
    assert len(stats["ms_blocks"]) == 2 and stats["ms_per_batch"] > 0
