"""The port's train step against the JAX package's, on the CPU in float32.

The same numpy params, state and batch go through ``dcfp_tpu`` (eager,
or its jitted train step) and through ``dcfp_tpu_torch`` with
``device="cpu"``: BN in train mode, the losses and their gradients, the
lr schedule and optimizers, EIC, ``expand_batch``, whole train steps (a
tiny model, and the flagship DeepLabV3-R50 with GSRL + deepsup + EIC +
SGD), remat, dropout, ``TrainLoop`` and the bridge's round trips."""

import dataclasses
import json
import math
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dcfp_tpu.engine import optim as joptim
from dcfp_tpu.engine import trainer as jtrainer
from dcfp_tpu.graph import apply as japply
from dcfp_tpu.graph.ir import GraphBuilder as JBuilder
from dcfp_tpu.losses import criteria as jcrit
from dcfp_tpu.models.heads import SegModel as JSegModel
from dcfp_tpu.models.registry import build_model as j_build_model
from dcfp_tpu.prune import eic as jeic
from dcfp_tpu_torch import bridge
from dcfp_tpu_torch.engine import optim as toptim
from dcfp_tpu_torch.engine import trainer as ttrainer
from dcfp_tpu_torch.graph import apply as tapply
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.losses import criteria as tcrit
from dcfp_tpu_torch.models.heads import SegModel as TSegModel
from dcfp_tpu_torch.models.registry import build_model as t_build_model
from dcfp_tpu_torch.prune import eic as teic

CPU = "cpu"


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


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def port_tree_np(tree):
    """A port params-shaped tree -> JAX-layout numpy."""
    return bridge.params_to_numpy(tree, {})[0]


# -- the tiny models of tests/test_trainer.py, built by either package --

def tiny_model(B, SM, num_classes=5, deepsup=False):
    b = B("tiny")
    x = b.input("image")
    x = b.conv(x, "c1", out_ch=8, kernel=3)
    x = b.bn(x, "n1")
    x = b.relu(x, "r1")
    x = b.conv(x, "c2", out_ch=8, kernel=3)
    x = b.bn(x, "n2")
    x = b.relu(x, "r2")
    pred = b.conv(x, "pred", out_ch=num_classes, kernel=1, padding=0,
                  bias=True)
    outs = [pred]
    if deepsup:
        outs.append(b.conv(x, "deepsup", out_ch=num_classes, kernel=1,
                           padding=0, bias=True))
    g = b.finish(outs)
    g.ignore_prune = []
    return SM(g, "tiny", "none", num_classes, False, deepsup, {}, {})


def tiny_resize_model(B, SM, num_classes=5, deepsup=True):
    """Outputs are resize(to_input) nodes like the real heads, so the
    fused loss tail applies."""
    b = B("tinyr")
    x = b.input("image")
    x = b.conv_bn_relu(x, "s", out_ch=8, kernel=3, stride=2)
    z = b.conv(x, "cls", out_ch=num_classes, kernel=1, padding=0, bias=True)
    outs = [b.resize(z, "pred", to_input=True, align_corners=True)]
    if deepsup:
        d = b.conv(x, "dcls", out_ch=num_classes, kernel=1, padding=0,
                   bias=True)
        outs.append(b.resize(d, "deepsup", to_input=True,
                             align_corners=True))
    g = b.finish(outs)
    g.ignore_prune = []
    return SM(g, "tinyr", "none", num_classes, True, deepsup, {}, {})


def branchy_model(B, SM, num_classes=5, rate=0.5):
    """Residual + concat + dropout + resize heads: enough structure that
    4 remat segments cut through non-trivial liveness."""
    b = B("branchy")
    x = b.input("image")
    x = b.conv_bn_relu(x, "s", out_ch=8, kernel=3, stride=2)
    c = b.conv_bn_relu(x, "b1", out_ch=8, kernel=3)
    c = b.conv(c, "b2", out_ch=8, kernel=3)
    c = b.bn(c, "b2.bn")
    y = b.relu(b.add_([c, x], "res"), "res.r")
    p = b.conv_bn_relu(y, "br", out_ch=4, kernel=1, padding=0)
    cat = b.concat([y, p], "cat")
    z = b.conv_bn_relu(cat, "h", out_ch=8, kernel=3)
    z = b.dropout(z, "drop", rate=rate)
    z = b.conv(z, "cls", out_ch=num_classes, kernel=1, padding=0, bias=True)
    pred = b.resize(z, "pred", to_input=True, align_corners=True)
    g = b.finish([pred])
    g.ignore_prune = []
    return SM(g, "branchy", "none", num_classes, True, False, {}, {})


def both(build, **kw):
    return build(JBuilder, JSegModel, **kw), build(TBuilder, TSegModel, **kw)


def close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# graph_apply in train mode
# ---------------------------------------------------------------------------

def test_bn_train_mode_output_and_running_stats(rng):
    """Batch moments over (N, H, W), the unbiased running var, and the
    caller's state left as it was."""
    jm, tm = both(tiny_model, deepsup=True)
    params, state = np_params(jm.graph, 3)
    x = rng.standard_normal((3, 9, 7, 3)).astype(np.float32)
    jout, jstate = japply.graph_apply(jm.graph, to_jax(params),
                                      to_jax(state), {"image": jnp.asarray(x)},
                                      train=True)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    before = {n: {k: v.clone() for k, v in d.items()} for n, d in ts.items()}
    tout, tstate = tapply.graph_apply(tm.graph, tp, ts,
                                      {"image": torch.from_numpy(x)},
                                      train=True)
    for name in jm.graph.outputs:
        close(tout[name].numpy(), jout[name], 0, 1e-5, name)
    for n in ("n1", "n2"):
        for k in ("mean", "var"):
            close(tstate[n][k].numpy(), jstate[n][k], 0, 1e-5, f"{n}/{k}")
            assert torch.equal(ts[n][k], before[n][k])
            assert not torch.equal(tstate[n][k], before[n][k])


def test_dropout_statistics():
    """The kept share lies within 3 sigma of 1 - rate, kept values are
    x / (1 - rate), and spatial dropout draws one value per (n, c)."""
    rate = 0.3
    for spatial in (False, True):
        b = TBuilder("d")
        x = b.input("image")
        b.dropout(x, "drop", rate=rate, spatial=spatial)
        g = b.finish(["drop"])
        xin = torch.rand(8, 4, 4, 256) + 0.5  # NHWC, all positive
        out, _ = tapply.graph_apply(g, {}, {}, {"image": xin}, train=True,
                                    generator=torch.Generator().manual_seed(1))
        y = out["drop"]
        kept = y != 0
        if spatial:
            # one draw per (n, c): constant over H, W
            assert (kept == kept[:, :1, :1, :]).all()
            draws = kept[:, 0, 0, :]
        else:
            draws = kept
        n = draws.numel()
        share = float(draws.float().mean())
        sigma = math.sqrt(rate * (1 - rate) / n)
        assert abs(share - (1 - rate)) < 3 * sigma, (spatial, share)
        torch.testing.assert_close(y[kept], xin[kept] / (1 - rate))
        # no generator, or eval mode: the identity
        for kw in ({"train": True}, {"train": False,
                                      "generator": torch.Generator()}):
            same, _ = tapply.graph_apply(g, {}, {}, {"image": xin}, **kw)
            assert torch.equal(same["drop"], xin)


@pytest.mark.parametrize("segments", [2, 4])
def test_remat_replays_dropout(rng, segments):
    """remat_segments > 1 recomputes each segment in the backward with
    the same dropout masks: outputs, BN updates and gradients equal to
    the plain run's within 1e-6 relative."""
    model = branchy_model(TBuilder, TSegModel, rate=0.5)
    params, state = np_params(model.graph, 0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3))
                         .astype(np.float32))

    def run(segs):
        tp, ts = bridge.params_from_numpy(params, state, device=CPU)
        leaves = [v.requires_grad_(True) for d in tp.values()
                  for v in d.values()]
        out, new_s = tapply.graph_apply(
            model.graph, tp, ts, {"image": x}, train=True,
            generator=torch.Generator().manual_seed(7),
            remat_segments=segs)
        grads = torch.autograd.grad((out["pred"] ** 2).sum(), leaves)
        return out["pred"].detach(), new_s, grads

    o0, s0, g0 = run(0)
    o1, s1, g1 = run(segments)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    undropped, _ = tapply.graph_apply(model.graph, tp, ts, {"image": x},
                                      train=True)
    assert not torch.allclose(undropped["pred"], o0)  # dropout is live
    torch.testing.assert_close(o1, o0, rtol=1e-6, atol=0)
    for n in s0:
        for k in s0[n]:
            torch.testing.assert_close(s1[n][k], s0[n][k], rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

LOSSES = {
    "ce": dict(loss_type="ce"),
    "ce_weighted": dict(loss_type="ce", loss_para={"balance_weight": True}),
    "ohem": dict(loss_type="ohem",
                 loss_para={"ohem_thres": 0.3, "ohem_keep": 64 * 30}),
    "gsrl": dict(loss_type="gsrl"),
    "ohem,gsrl": dict(loss_type="ohem,gsrl",
                      loss_para={"ohem_keep": 64 * 30}),
}


def _loss_case(rng, n=2, h=40, w=40, c=5, deepsup=True):
    preds = {"pred": (3 * rng.standard_normal((n, h, w, c)))
             .astype(np.float32)}
    if deepsup:
        preds["deepsup"] = rng.standard_normal((n, h, w, c)).astype(np.float32)
    labels = rng.integers(0, c, (n, h, w))
    labels[rng.random((n, h, w)) < 0.1] = 255
    weight = rng.uniform(0.2, 2.0, (n, h, w)).astype(np.float32)
    class_weights = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return preds, labels, weight, class_weights


@pytest.mark.parametrize("deepsup", [True, False])
@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_and_logit_grads(rng, name, channels_first, deepsup):
    """build_criterions' loss and its gradient w.r.t. the logits, NHWC
    and channels-first: rtol 1e-5."""
    preds, labels, weight, cw = _loss_case(rng, deepsup=deepsup)
    if channels_first:
        preds = {k: np.ascontiguousarray(v.transpose(0, 3, 1, 2))
                 for k, v in preds.items()}
    kw = dict(LOSSES[name], ignore_label=255, class_weights=cw)
    jc, tc = jcrit.build_criterions(**kw), tcrit.build_criterions(**kw)
    jl = {"ori": jnp.asarray(labels.astype(np.int32)),
          "weight": jnp.asarray(weight)}
    tl = {"ori": torch.from_numpy(labels), "weight": torch.from_numpy(weight)}

    jloss, jgrad = jax.value_and_grad(
        lambda p: jc(p, jl, channels_first=channels_first)["loss"])(
        to_jax(preds))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in preds.items()}
    tloss = tc(tp, tl, channels_first=channels_first)["loss"]
    tloss.backward()
    close(float(tloss.detach()), float(jloss), 1e-5)
    for k in preds:
        g = np.asarray(jgrad[k])
        close(tp[k].grad.numpy(), g, 1e-5, 1e-5 * np.abs(g).max(), k)


@pytest.mark.parametrize("channels_first", [False, True])
def test_ohem_threshold_and_mined(rng, channels_first):
    """The threshold within rtol 1e-6 and the mined labels equal, except
    where the true-class probability lies within 1e-6 of the
    threshold."""
    preds, labels, _, _ = _loss_case(rng, n=2, h=61, w=47, deepsup=False)
    z = preds["pred"]
    if channels_first:
        z = np.ascontiguousarray(z.transpose(0, 3, 1, 2))
    kw = dict(ignore_label=255, thresh=0.3, min_kept=64 * 40,
              channels_first=channels_first)
    jthr, jmined = jcrit.ohem_threshold_and_mined(
        jnp.asarray(z), jnp.asarray(labels.astype(np.int32)), **kw)
    tthr, tmined = tcrit.ohem_threshold_and_mined(
        torch.from_numpy(z), torch.from_numpy(labels), **kw)
    close(float(tthr), float(jthr), 1e-6)
    assert 0.3 < float(tthr) < 1.0  # the k-th value, not a floor
    probs = torch.softmax(torch.from_numpy(z), dim=1 if channels_first
                          else -1)
    safe = torch.from_numpy(np.where(labels == 255, 0, labels))
    p_true = torch.gather(probs, 1 if channels_first else -1,
                          safe.unsqueeze(1 if channels_first else -1)) \
        .squeeze(1 if channels_first else -1).numpy()
    differ = tmined.numpy() != np.asarray(jmined)
    assert not (differ & (np.abs(p_true - float(jthr)) > 1e-6)).any()
    assert (tmined.numpy() == 255).sum() > (labels == 255).sum()


def test_zoom0_indices_match():
    for n, m in [(40, 5), (61, 8), (47, 6), (1, 1), (5, 1), (129, 16)]:
        assert np.array_equal(tcrit._zoom0_indices(n, m),
                              jcrit._zoom0_indices(n, m))


# ---------------------------------------------------------------------------
# schedule, optimizers, EIC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [-1, 10])
def test_poly_warmup_schedule(warmup):
    n = 40
    j = joptim.poly_warmup_schedule(0.01, n, 0.9, warmup)
    t = toptim.poly_warmup_schedule(0.01, n, 0.9, warmup)
    for i in sorted({0, max(warmup - 1, 0), max(warmup, 0), 17, n}):
        close(t(i), float(j(jnp.asarray(i))), 1e-6, what=f"step {i}")


def _opt_tree(rng):
    return {
        "c1": {"kernel": rng.standard_normal((3, 3, 4, 6)).astype(np.float32),
               "bias": rng.standard_normal(6).astype(np.float32)},
        "n1": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
               "bias": rng.standard_normal(6).astype(np.float32)},
    }


@pytest.mark.parametrize("no_decay", [None, "bn,bias"])
@pytest.mark.parametrize("optim", ["sgd", "adamw"])
def test_optimizer_matches_optax(rng, optim, no_decay):
    """Five updates with the poly+warmup lr against the optax chain:
    rtol 1e-6."""
    p0 = _opt_tree(rng)
    p0["layer.bn1"] = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape)
                          .astype(np.float32), p0) for _ in range(5)]
    kw = dict(optim=optim, learning_rate=0.05, momentum=0.9,
              weight_decay=0.01, betas="0.9,0.999", num_steps=20, power=0.9,
              warmup=3, no_decay=no_decay)
    tx = joptim.build_optimizer(**kw, params=to_jax(p0))
    jp = to_jax(p0)
    js = tx.init(jp)
    tp, _ = bridge.params_from_numpy(p0, {}, device=CPU)
    opt = toptim.build_optimizer(**kw, params=tp)
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update(to_jax(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tg, _ = bridge.params_from_numpy(g, {}, device=CPU)
        tu, ts = opt.update(tg, ts, tp)
        tp = toptim.apply_updates(tp, tu)
    assert ts["count"] == 5
    got = port_tree_np(tp)
    jax.tree.map(lambda a, b: close(a, b, 1e-6), got,
                 jax.tree.map(np.asarray, jp))
    mask = toptim._decay_mask(tp, ["bn", "bias"])
    assert not mask["layer.bn1"]["scale"] and not mask["c1"]["bias"]
    assert mask["n1"]["scale"] and mask["c1"]["kernel"]


def test_eic_update_matches_formula(rng):
    g = rng.standard_normal(6).astype(np.float32)
    w = rng.standard_normal(6).astype(np.float32)
    eic0 = np.abs(rng.standard_normal(6)).astype(np.float32)
    r = 0.99
    got = teic.eic_update({"bn": torch.from_numpy(eic0)},
                          {"bn": {"scale": torch.from_numpy(w)}},
                          {"bn": {"scale": torch.from_numpy(g)}}, r)["bn"]
    flag = (g * w) > 0
    grad_tmp = flag * np.abs(g) + (~flag) * eic0
    want = eic0 * r + grad_tmp * (1 - r)
    close(got.numpy(), want, 1e-6)


def test_init_eic_matches_jax():
    jm, tm = both(tiny_model)
    je = jeic.init_eic(jm.graph)
    te = teic.init_eic(tm.graph, torch.device(CPU))
    assert list(te) == list(je)
    for n in je:
        assert te[n].shape == je[n].shape and not te[n].any()


# ---------------------------------------------------------------------------
# expand_batch
# ---------------------------------------------------------------------------

def compact_batch(rng, n=4, h=9, w=11, c=5, hw_valid=None):
    img = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    ori = rng.integers(0, c, (n, h, w)).astype(np.uint8)
    ori[rng.random((n, h, w)) < 0.1] = 255
    wc = rng.uniform(0.1, 1.0, (n, c + 1)).astype(np.float32)
    wc[:, -1] = 0.0
    hv, wv = hw_valid or (h - 2, w - 3)
    pad = np.array([[hv, wv, 0], [hv, wv, 1], [h, w, 0],
                    [h - 1, w - 1, 1]][:n], np.int32)
    return {"img": img, "label": {"ori": ori, "weight_class": wc},
            "pad": pad}


NORMALIZE = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def test_expand_batch_compact(rng):
    """uint8 normalize, the pad-validity zeros (one triple flipped) and
    the weight_class gather: exact."""
    batch = compact_batch(rng)
    jimg, jlab = jtrainer.expand_batch(jax.tree.map(jnp.asarray, batch),
                                       NORMALIZE, 5, 255, jnp.float32)
    timg, tlab = ttrainer.expand_batch(batch, NORMALIZE, 5, 255,
                                       torch.float32, torch.device(CPU))
    assert timg.dtype == torch.float32 and timg.shape == jimg.shape
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(tlab["ori"].numpy(), np.asarray(jlab["ori"]))
    np.testing.assert_array_equal(tlab["weight"].numpy(),
                                  np.asarray(jlab["weight"]))
    # the flipped image keeps its right-hand columns, zeroes the left
    assert (timg[1, :, :3] == 0).all() and (timg[0, :, -3:] == 0).all()


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

def _start_both(jm, tm, params, state, kw, prune_type="dcfp"):
    tx = joptim.build_optimizer(**kw)
    jstate = jtrainer.create_train_state(jm, to_jax(params), to_jax(state),
                                         tx, prune_type=prune_type)
    opt = toptim.build_optimizer(**kw)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    tstate = ttrainer.create_train_state(tm, tp, ts, opt,
                                         prune_type=prune_type, device=CPU)
    return tx, jstate, opt, tstate


def _gsrl_batch(rng, n, hw, c):
    img = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    ori = rng.integers(0, c, (n, hw, hw)).astype(np.int32)
    ori[rng.random((n, hw, hw)) < 0.05] = 255
    weight = rng.uniform(0.5, 2.0, (n, hw, hw)).astype(np.float32)
    return {"img": img, "label": {"ori": ori, "weight": weight}}


@pytest.mark.parametrize("fused", [True, False])
def test_train_step_tiny_gsrl(rng, fused):
    """One make_train_step step on tiny_resize_model with GSRL, fused
    loss tail on and off: loss, params, BN state, EIC and grad norm
    within rtol 1e-5, atol 1e-6."""
    jm, tm = both(tiny_resize_model)
    params, state = np_params(jm.graph, 0)
    kw = dict(optim="sgd", learning_rate=0.05, num_steps=100)
    tx, js, opt, ts = _start_both(jm, tm, params, state, kw)
    crit = dict(loss_type="gsrl", ignore_label=255)
    batch = _gsrl_batch(rng, 4, 16, 5)
    jstep = jtrainer.make_train_step(jm, jcrit.build_criterions(**crit), tx,
                                     fuse_loss_tail=fused)
    tstep = ttrainer.make_train_step(tm, tcrit.build_criterions(**crit), opt,
                                     fuse_loss_tail=fused, device=CPU)
    js, jmet = jstep(js, jax.tree.map(jnp.asarray, batch), jax.random.key(1))
    ts2, tmet = tstep(ts, batch)
    assert ts2.step == int(js.step) == 1
    close(float(tmet["loss"]), float(jmet["loss"]), 1e-5, 1e-6)
    close(float(tmet["grad_norm"]), float(jmet["grad_norm"]), 1e-5, 1e-6)
    jnp_ = jax.tree.map(np.asarray, {"params": js.params,
                                     "bn": js.bn_state, "eic": js.eic})
    got_p, got_s = bridge.params_to_numpy(ts2.params, ts2.bn_state)
    for tree, want in ((got_p, jnp_["params"]), (got_s, jnp_["bn"]),
                       (bridge.eic_to_numpy(ts2.eic), jnp_["eic"])):
        jax.tree.map(lambda a, b: close(a, b, 1e-5, 1e-6), tree, want)
    # the input state is left as it was
    np.testing.assert_array_equal(
        ts.params["cls"]["kernel"].numpy(),
        params["cls"]["kernel"].transpose(3, 2, 0, 1))


FLAGSHIP = dict(backbone="resnet50",
                backbone_para={"os": 8, "mg_unit": [1, 2, 4], "inplanes": 128},
                num_classes=19, align_corner=True, deepsup=True)


def _no_deepsup_dropout(model):
    g = model.graph.copy()
    g.node("conv_deepsup.3").attrs["rate"] = 0.0
    return dataclasses.replace(model, graph=g)


def update_agreement(new, ref, old):
    """How the update ``new - old`` agrees with ``ref - old`` (JAX-layout
    numpy trees): the relative L2 error of the whole update, and each
    tensor's cosine and norm ratio."""
    num = den = 0.0
    cos, ratio = {}, {}
    for n in old:
        for k in old[n]:
            a = (new[n][k] - old[n][k]).ravel().astype(np.float64)
            b = (ref[n][k] - old[n][k]).ravel().astype(np.float64)
            num += ((a - b) ** 2).sum()
            den += (b ** 2).sum()
            cos[f"{n}/{k}"] = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            ratio[f"{n}/{k}"] = np.linalg.norm(a) / np.linalg.norm(b)
    return math.sqrt(num / den), cos, ratio


def vec_rel_l2(a, b):
    a = np.concatenate([a[n] for n in b]).astype(np.float64)
    b = np.concatenate([b[n] for n in b]).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_flagship_gsrl_eic_sgd_step(rng):
    """One step of the flagship (DeepLabV3-R50, os 8, deepsup) with GSRL
    + EIC + SGD (lr 0.01, momentum 0.9, wd 5e-4, warmup -1, so the
    update is full-sized) at batch 2, 33x33, against the JAX package's
    jitted step.  Dropout is off on both sides (rate 0 on copies of the
    graphs; the JAX step always passes a key).

    The f32 train-mode forward at this size carries its rounding through
    ~100 BNs over 50 values each (the ASPP image-pool BN over 2) and
    flips ReLUs in the head, so the reference's own update moves by a
    few percent (relative L2) when its image is scaled by 1 + 2^-22; an
    element-wise rule would fail for the reference against itself.  So
    the update is held against that self-noise: the whole update's
    relative L2 error within 2x the reference's self-noise (and 0.1),
    each tensor's cosine >= 0.99 and norm ratio within 5%.  Loss rtol 1e-4; BN running
    statistics within 1e-3 x max|value|; EIC within 2x the reference's
    self-noise, a flipped channel only where |g w| <= 0.05 x max|g w|.
    """
    jm = _no_deepsup_dropout(j_build_model("deeplabv3", **FLAGSHIP))
    tm = _no_deepsup_dropout(t_build_model("deeplabv3", **FLAGSHIP))
    params, state = np_params(jm.graph, 1)
    kw = dict(optim="sgd", learning_rate=0.01, momentum=0.9,
              weight_decay=5e-4, num_steps=100, warmup=-1)
    crit = dict(loss_type="gsrl", ignore_label=255)
    batch = _gsrl_batch(rng, 2, 33, 19)
    tx, js, opt, ts = _start_both(jm, tm, params, state, kw)
    jstep = jtrainer.make_train_step(jm, jcrit.build_criterions(**crit), tx)
    tstep = ttrainer.make_train_step(tm, tcrit.build_criterions(**crit), opt,
                                     device=CPU)
    jbatch = jax.tree.map(jnp.asarray, batch)
    js, jmet = jstep(js, jbatch, jax.random.key(1))
    ts2, tmet = tstep(ts, batch)
    # the reference's self-noise: the same step on the image x (1 + 2^-22)
    _, js_p, _, _ = _start_both(jm, tm, params, state, kw)
    js_p, _ = jstep(js_p, dict(jbatch, img=jbatch["img"] * (1 + 2.0 ** -22)),
                    jax.random.key(1))

    assert np.isfinite(float(tmet["loss"]))
    close(float(tmet["loss"]), float(jmet["loss"]), 1e-4)
    got, got_s = bridge.params_to_numpy(ts2.params, ts2.bn_state)
    want = jax.tree.map(np.asarray, js.params)
    want_s = jax.tree.map(np.asarray, js.bn_state)
    for n in want_s:
        for k in want_s[n]:
            close(got_s[n][k], want_s[n][k], 0,
                  1e-3 * np.abs(want_s[n][k]).max(), f"{n}/{k}")

    err, cos, ratio = update_agreement(got, want, params)
    noise, _, _ = update_agreement(jax.tree.map(np.asarray, js_p.params),
                                   want, params)
    assert err <= min(2 * noise, 0.1), (err, noise)
    assert min(cos.values()) >= 0.99, min(cos.items(), key=lambda kv: kv[1])
    assert all(0.95 <= r <= 1.05 for r in ratio.values()), \
        (min(ratio.values()), max(ratio.values()))

    # EIC; the first SGD step's update is -lr * (g + wd * w), which
    # gives back the reference's g
    te, je = bridge.eic_to_numpy(ts2.eic), jax.tree.map(np.asarray, js.eic)
    assert set(te) == set(je) and max(v.max() for v in je.values()) > 0
    eic_noise = vec_rel_l2(jax.tree.map(np.asarray, js_p.eic), je)
    assert vec_rel_l2(te, je) <= 2 * eic_noise, (vec_rel_l2(te, je),
                                                 eic_noise)
    gw = {}
    for n in je:
        w = params[n]["scale"]
        gw[n] = np.abs(((want[n]["scale"] - w) / -0.01 - 5e-4 * w) * w)
    gw_max = max(v.max() for v in gw.values())
    for n in je:
        flipped = (te[n] > 0) != (je[n] > 0)
        assert (gw[n][flipped] <= 0.05 * gw_max).all(), n


def test_train_step_remat_matches_plain(rng):
    """make_train_step with remat_segments 3 and a live dropout (a seeded
    generator, rate 0.5) lands on the plain step's params and EIC."""
    model = branchy_model(TBuilder, TSegModel)
    params, state = np_params(model.graph, 0)
    batch = {"img": rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 5, (4, 16, 16))}
    opt = toptim.build_optimizer(optim="sgd", learning_rate=0.05,
                                 num_steps=100)
    crit = tcrit.build_criterions("ce")
    out = []
    for segs in (0, 3):
        tp, ts = bridge.params_from_numpy(params, state, device=CPU)
        st = ttrainer.create_train_state(model, tp, ts, opt,
                                         prune_type="dcfp", device=CPU)
        step = ttrainer.make_train_step(model, crit, opt,
                                        remat_segments=segs, device=CPU)
        out.append(step(st, batch, torch.Generator().manual_seed(3)))
    (s0, m0), (s1, m1) = out
    torch.testing.assert_close(m1["loss"], m0["loss"], rtol=1e-6, atol=0)
    for n in s0.params:
        for k in s0.params[n]:
            close(s1.params[n][k], s0.params[n][k], 1e-5, 1e-6, f"{n}/{k}")
    for n in s0.eic:
        close(s1.eic[n], s0.eic[n], 1e-5, 1e-6, n)


# ---------------------------------------------------------------------------
# TrainLoop
# ---------------------------------------------------------------------------

def _loop_setup(rng, **loop_kw):
    model = tiny_model(TBuilder, TSegModel)
    params, state = np_params(model.graph, 0)
    opt = toptim.build_optimizer(optim="sgd", learning_rate=0.05,
                                 num_steps=100)
    sched = toptim.poly_warmup_schedule(0.05, 100, 0.9, warmup=0)
    loop = ttrainer.TrainLoop(model=model,
                              criterion=tcrit.build_criterions("ce"),
                              optimizer=opt, lr_schedule=sched, **loop_kw)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    return loop, ttrainer.create_train_state(model, tp, ts, opt, device=CPU)


def _batches(rng, poison_at=None, signal_at=None):
    i = 0
    while True:
        if i == signal_at:
            os.kill(os.getpid(), signal.SIGTERM)
        img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        if i == poison_at:
            img[:] = np.inf
        yield {"img": img, "label": rng.integers(0, 5, (2, 16, 16))}
        i += 1


def test_train_loop_windowed_nan_guard(rng):
    """The loop fetches losses once per log window and still names the
    step of the first non-finite loss."""
    loop, state = _loop_setup(rng, num_steps=7, log_every=5)
    assert loop.run(state, _batches(rng), device=CPU).step == 7
    _, state = _loop_setup(rng, num_steps=7, log_every=5)
    with pytest.raises(FloatingPointError, match="step 3"):
        loop.run(state, _batches(rng, poison_at=3), device=CPU)


def test_train_loop_signal_snapshot_and_metrics(rng, tmp_path):
    """A SIGTERM mid-run finishes the in-flight step, snapshots, restores
    the handler and returns; the JSONL metrics get one line per log
    window."""
    snaps = []
    path = str(tmp_path / "metrics.jsonl")
    loop, state = _loop_setup(
        rng, num_steps=50, log_every=2,
        snapshot_hook=lambda st, step: snaps.append(step),
        handle_signals=True, metrics_file=path)
    prev = signal.getsignal(signal.SIGTERM)
    state = loop.run(state, _batches(rng, signal_at=4), device=CPU)
    assert state.step == 5
    assert snaps and snaps[-1] == 5
    assert signal.getsignal(signal.SIGTERM) is prev
    lines = [json.loads(ln) for ln in open(path)]
    assert lines and lines[0]["step"] == 2
    assert all(np.isfinite(ln["loss"]) and ln["grad_norm"] > 0
               for ln in lines)


def test_train_loop_save_window(rng):
    """Snapshots every save_pred_every steps once in the save window,
    and at the last step."""
    snaps = []
    loop, state = _loop_setup(
        rng, num_steps=9, log_every=4, save_pred_every=2, save_steps=5,
        snapshot_hook=lambda st, step: snaps.append((step, st.step)))
    loop.run(state, _batches(rng), device=CPU)
    assert snaps == [(6, 6), (8, 8), (9, 9)]


# ---------------------------------------------------------------------------
# bridge round trips
# ---------------------------------------------------------------------------

def test_bridge_params_round_trip(rng):
    jm, _ = both(tiny_resize_model)
    params, state = np_params(jm.graph, 2)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    p2, s2 = bridge.params_to_numpy(tp, ts)
    for a, b in ((params, p2), (state, s2)):
        jax.tree.map(np.testing.assert_array_equal, a, b)


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
def test_bridge_opt_state_round_trip(rng, optim):
    """An optax state after two updates -> the port -> optax, bit-exact;
    and one more update from the carried state agrees with optax."""
    p0 = _opt_tree(rng)
    kw = dict(optim=optim, learning_rate=0.05, weight_decay=0.01,
              num_steps=20, no_decay="bias")
    tx = joptim.build_optimizer(**kw, params=to_jax(p0))
    jp, js = to_jax(p0), tx.init(to_jax(p0))
    for _ in range(2):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), p0)
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    js_np = jax.tree.map(np.asarray, js)
    ts = bridge.opt_state_from_numpy(js_np, device=CPU)
    assert ts["count"] == 2
    if optim == "sgd":
        assert ts["trace"]["c1"]["kernel"].shape == (6, 4, 3, 3)
    back = bridge.opt_state_to_numpy(ts, like=js_np)
    assert jax.tree.structure(back) == jax.tree.structure(js_np)
    jax.tree.map(np.testing.assert_array_equal, back, js_np)

    tp, _ = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), {},
                                     device=CPU)
    opt = toptim.build_optimizer(**kw, params=tp)
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                     .astype(np.float32), p0)
    upd, js = tx.update(to_jax(g), js, jp)
    tg, _ = bridge.params_from_numpy(g, {}, device=CPU)
    tu, ts = opt.update(tg, ts, tp)
    jax.tree.map(lambda a, b: close(a, b, 1e-6, 1e-9),
                 port_tree_np(toptim.apply_updates(tp, tu)),
                 jax.tree.map(np.asarray, optax.apply_updates(jp, upd)))


def test_bridge_eic_round_trip(rng):
    eic = {"n1": np.abs(rng.standard_normal(8)).astype(np.float32),
           "n2": np.abs(rng.standard_normal(3)).astype(np.float32)}
    back = bridge.eic_to_numpy(bridge.eic_from_numpy(eic, device=CPU))
    jax.tree.map(np.testing.assert_array_equal, back, eic)


def test_train_step_after_inference(rng):
    """Serving first and training after, in one process: the resize
    matrices cached under ``torch.inference_mode`` by the deploy path
    must still be usable where autograd saves them."""
    from dcfp_tpu_torch.engine.deploy import make_inference_fn
    from dcfp_tpu_torch.ops import resize

    model = tiny_resize_model(TBuilder, TSegModel)
    params, state = np_params(model.graph, 0)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    resize._cached_interp_tensor.cache_clear()
    fn, dev_p = make_inference_fn(model.graph, tp, ts, device=CPU,
                                  dtype=torch.float32, output="logits")
    fn(dev_p, torch.zeros(2, 16, 16, 3))
    opt = toptim.build_optimizer(optim="sgd", num_steps=10)
    state0 = ttrainer.create_train_state(model, tp, ts, opt, device=CPU)
    step = ttrainer.make_train_step(model, tcrit.build_criterions("gsrl"),
                                    opt, device=CPU)
    _, metrics = step(state0, _gsrl_batch(rng, 2, 16, 5))
    assert np.isfinite(float(metrics["loss"]))
