"""The port's deploy graph rewrites (``dcfp_tpu_torch/engine/deploy.py``:
``split_concat_projection``, ``insert_barriers``,
``pad_conv_out_channels`` / ``stem_pad_targets``) against the JAX
package's: the same rewritten graph (names, ops, inputs, attrs) and the
same params, bit for bit, from the same BN-folded model; and the
rewritten deploy forward (``make_inference_fn(split_concat=,
pad_stem=)``) against the unrewritten one in f32, rtol 1e-5 and atol
1e-5 x max|logits|, with equal labels.  Beside them,
``utils.flops.cost_analysis`` against the graph's conv count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcfp_tpu.engine import deploy as jdeploy
from dcfp_tpu.models.registry import build_model as j_build_model
from dcfp_tpu_torch.bridge import params_from_numpy, params_to_numpy
from dcfp_tpu_torch.engine import deploy as tdeploy
from dcfp_tpu_torch.models.registry import build_model as t_build_model
from test_torch_deploy import np_params

MODELS = {
    # ASPP: a 5-branch concat whose global-pool branch is a broadcast
    # resize (its projection commutes); deep stem 64 -> 64 -> 128
    "deeplabv3": ("deeplabv3", dict(
        backbone="resnet50",
        backbone_para={"os": 16, "mg_unit": [1, 2, 4], "inplanes": 128})),
    # and the decoder's concat of two non-broadcast branches
    "deeplabv3p": ("deeplabv3p", dict(backbone="resnet50",
                                      backbone_para={"os": 16})),
}
HW = 49


def _folded(key):
    head, kw = MODELS[key]
    kw = dict(kw, num_classes=7, align_corner=True, deepsup=False)
    jg = j_build_model(head, **kw).graph
    tg = t_build_model(head, **kw).graph
    params, state = np_params(jg, 2)
    jf = jdeploy.fold_batchnorm(jg, params, state)
    tp, ts = params_from_numpy(params, state, device="cpu")
    tf = tdeploy.fold_batchnorm(tg, tp, ts)
    return (jg, params, state), (tg, tp, ts), jf, tf


def _graph(g):
    return ([(n.name, n.op, tuple(n.inputs), n.attrs)
             for n in g.toposorted()], list(g.inputs), list(g.outputs))


def _same_params(tparams, jparams):
    got = params_to_numpy(tparams, {})[0]
    assert set(got) == set(jparams)
    for name, d in jparams.items():
        assert set(got[name]) == set(d), name
        for k, v in d.items():
            np.testing.assert_array_equal(got[name][k], np.asarray(v),
                                          err_msg=f"{name}/{k}")


@pytest.mark.parametrize("key", sorted(MODELS))
def test_split_concat_projection_matches_jax(key):
    _, _, (jg, jp, _), (tg, tp, _) = _folded(key)
    jg2, jp2 = jdeploy.split_concat_projection(jg, jp)
    tg2, tp2 = tdeploy.split_concat_projection(tg, tp)
    assert _graph(tg2) == _graph(jg2)
    assert len(tg2.nodes) != len(tg.nodes)
    _same_params(tp2, jp2)
    if key == "deeplabv3":  # the pool branch's projection commuted
        assert any(n.op == "resize" and n.name.endswith(".r")
                   for n in tg2.toposorted())


def test_pad_stem_matches_jax():
    _, _, (jg, jp, _), (tg, tp, _) = _folded("deeplabv3")
    targets = tdeploy.stem_pad_targets(tg, 128)
    assert targets == jdeploy.stem_pad_targets(jg, 128)
    assert targets  # the 64-wide stem convs
    jg2, jp2 = jdeploy.pad_conv_out_channels(jg, jp, targets)
    tg2, tp2 = tdeploy.pad_conv_out_channels(tg, tp, targets)
    assert _graph(tg2) == _graph(jg2)
    _same_params(tp2, jp2)
    with pytest.raises(ValueError, match="cannot pad through"):
        tdeploy.pad_conv_out_channels(tg, tp, {"aspp.aspp1.atrous_conv":
                                               512})


def test_insert_barriers_matches_jax_and_is_identity(rng):
    _, _, (jg, _, _), (tg, tp, ts) = _folded("deeplabv3")
    after = ["backbone.layer1.0.relu", "aspp.conv1", "pred"]
    after = [a for a in after if a in tg.nodes] + ["backbone.layer4.2.conv3"]
    jb = jdeploy.insert_barriers(jg, after)
    tb = tdeploy.insert_barriers(tg, after)
    assert _graph(tb) == _graph(jb)
    assert sum(n.op == "barrier" for n in tb.toposorted()) == len(after)
    image = torch.from_numpy(rng.standard_normal(
        (1, HW, HW, 3)).astype(np.float32))
    from dcfp_tpu_torch.graph.apply import graph_apply
    want, _ = graph_apply(tg, tp, ts, {"image": image})
    got, _ = graph_apply(tb, tp, ts, {"image": image})
    assert set(got) == {f"{o}.barrier" if o in after else o
                        for o in want}
    for name, v in want.items():
        key = f"{name}.barrier" if name in after else name
        torch.testing.assert_close(got[key], v, rtol=0, atol=0)


def _logits(fn, p, image):
    return np.asarray(fn(p, image))


@pytest.mark.parametrize("key", sorted(MODELS))
def test_rewritten_forward_equals_plain(key, rng):
    """f32 logits of the rewritten deploy forward against the plain one,
    and against the JAX package's rewritten forward; labels equal."""
    (jg, params, state), (tg, tp, ts), _, _ = _folded(key)
    image = rng.standard_normal((1, HW, HW, 3)).astype(np.float32)
    timg = torch.from_numpy(image)
    plain_fn, pp = tdeploy.make_inference_fn(
        tg, tp, ts, dtype=torch.float32, output="logits", device="cpu")
    want = _logits(plain_fn, pp, timg)
    tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    rw = dict(split_concat=True, pad_stem=128)
    fn, rp = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.float32,
                                       output="logits", device="cpu", **rw)
    got = _logits(fn, rp, timg)
    np.testing.assert_allclose(got, want, **tol)
    jfn, jpp = jdeploy.make_inference_fn(
        jg, jax_tree(params), jax_tree(state), dtype=jnp.float32,
        output="logits", **rw)
    np.testing.assert_allclose(got, np.asarray(jfn(jpp, jnp.asarray(image))),
                               **tol)
    afn, ap = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.float32,
                                        output="argmax", device="cpu", **rw)
    labels = _logits(afn, ap, timg)
    assert labels.shape == (1, HW, HW)
    np.testing.assert_array_equal(labels, want.argmax(-1))


def jax_tree(tree):
    return {n: {k: jnp.asarray(v) for k, v in d.items()}
            for n, d in tree.items()}


def test_cost_analysis_counts_the_convs(rng):
    """``utils.flops.cost_analysis`` of the deploy forward: PyTorch's conv
    count is 2 x the multiply-accumulates of every conv, from the graph's
    shapes; the total adds the resizes' products."""
    from dcfp_tpu_torch.graph.shapes import infer_shapes
    from dcfp_tpu_torch.utils.flops import cost_analysis
    _, _, _, (tg, tp, ts) = _folded("deeplabv3")
    fn, pp = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.float32,
                                       output="logits", device="cpu")
    image = torch.from_numpy(rng.standard_normal(
        (1, HW, HW, 3)).astype(np.float32))
    cost = cost_analysis(fn, pp, image)
    shapes = infer_shapes(tg, (HW, HW))
    macs = sum(a["kernel"] ** 2 * a["in_ch"] // a["groups"] * a["out_ch"]
               * shapes[n.name][0] * shapes[n.name][1]
               for n in tg.conv_nodes() for a in [n.attrs])
    assert cost["flops:aten.convolution"] == 2 * macs
    assert cost["flops"] > 2 * macs
