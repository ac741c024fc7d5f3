"""The port's artifact layer against the JAX package's, on the CPU.

``dcfp_tpu_torch.utils.checkpoint`` writes flax's msgpack without flax:
its bytes must equal ``flax.serialization.msgpack_serialize``'s, and the
JAX package's files, for params, EIC, ``channel_cfg``, ``pruned`` and SGD
and AdamW ``TrainState`` trees.  Each file written by either package
loads in the other, bit-equal after ``bridge``; a ``TrainLoop`` stopped,
saved, loaded and resumed ends bit-equal to one never interrupted; the
non-strict merge reports the JAX package's keys; and reference-style
``.pth`` files load equal in both packages (``models/convert.py``)."""

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from dcfp_tpu.engine import optim as joptim
from dcfp_tpu.engine import trainer as jtrainer
from dcfp_tpu.graph.ir import GraphBuilder as JBuilder
from dcfp_tpu.models import convert as jconvert
from dcfp_tpu.models.heads import SegModel as JSegModel
from dcfp_tpu.utils import checkpoint as jckpt
from dcfp_tpu_torch import bridge
from dcfp_tpu_torch.engine import optim as toptim
from dcfp_tpu_torch.engine import trainer as ttrainer
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.losses import criteria as tcrit
from dcfp_tpu_torch.models import convert as tconvert
from dcfp_tpu_torch.models.heads import SegModel as TSegModel
from dcfp_tpu_torch.prune.eic import prunable_bn_names
from dcfp_tpu_torch.prune.pruner import DCFPPruner
from dcfp_tpu_torch.utils import checkpoint as tckpt
from test_torch_train import np_params, tiny_model, to_jax

CPU = "cpu"


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_tree_equal(a, b, where="tree"):
    """Equal nested dicts (and tuples of them); leaves compared as numpy,
    bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, set(a),
                                                          set(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}/{i}")
    elif a is None:
        assert b is None, where
    else:
        a, b = (np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                           else x) for x in (a, b))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), f"{where} differs"


def np_state(state):
    """A port TrainState as JAX-layout numpy (its state dict)."""
    return tckpt.train_state_dict(state)


@pytest.fixture
def tiny():
    jm, tm = tiny_model(JBuilder, JSegModel), tiny_model(TBuilder, TSegModel)
    params, state = np_params(jm.graph, 0)
    return jm, tm, params, state


def pruned(tm, params, state):
    r = np.random.default_rng(3)
    eic = {n: r.random(tm.graph.node(n).attrs["channels"]).astype(np.float32)
           for n in prunable_bn_names(tm.graph)}
    res = DCFPPruner(eic, global_percent=0.5).prune_model(tm.graph.copy(),
                                                          params, state)
    return eic, res


# -- the encoding -----------------------------------------------------------

def test_msgpack_bytes_equal_flax():
    r = np.random.default_rng(0)
    tree = {"b": {"z": r.standard_normal((3, 4)).astype(np.float32),
                  "a": np.arange(5, dtype=np.int8)},
            "a": [np.float32(1.5), np.int64(-3), 7, 2.5, True, None, "s"],
            "c": {}, "d": np.zeros((0, 3), np.float16),
            "e": np.asarray(4, np.int32), "f": r.random((2, 3)) > 0.5,
            "10": np.uint8(9), "9": np.arange(6).reshape(2, 3).T}
    assert tckpt.msgpack_serialize(tree) == \
        serialization.msgpack_serialize(tree)
    back = tckpt.msgpack_restore(tckpt.msgpack_serialize(tree))
    want = serialization.msgpack_restore(serialization.msgpack_serialize(
        tree))
    assert_tree_equal({k: v for k, v in back.items() if k not in "a"},
                      {k: v for k, v in want.items() if k not in "a"})
    assert back["a"][:5] == want["a"][:5] and back["a"][5:] == [None, "s"]
    # tensors are taken as numpy
    t = {"x": torch.arange(6, dtype=torch.float32).view(2, 3)}
    assert tckpt.msgpack_serialize(t) == serialization.msgpack_serialize(
        {"x": t["x"].numpy()})


def test_chunked_arrays_equal_flax(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes are chunked as flax chunks them
    (the limit lowered to 64 bytes for the test)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", 64)
    r = np.random.default_rng(1)
    tree = {"big": r.standard_normal((7, 11)).astype(np.float32),
            "nest": {"w": np.arange(40, dtype=np.int64)},
            "small": np.ones(3, np.float32)}
    blob = tckpt.msgpack_serialize(tree)
    assert blob == serialization.msgpack_serialize(tree)
    assert_tree_equal(tckpt.msgpack_restore(blob), tree)
    assert_tree_equal(serialization.msgpack_restore(blob), tree)


# -- artifacts, file for file -----------------------------------------------

def test_params_eic_cfg_pruned_files_equal(tiny, tmp_path):
    jm, tm, params, state = tiny
    eic, res = pruned(tm, params, state)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    for name, jsave, tsave in (
            ("params", lambda p: jckpt.save_pytree(p, params),
             lambda p: tckpt.save_pytree(p, bridge.params_to_numpy(tp,
                                                                   ts)[0])),
            ("eic", lambda p: jckpt.save_eic(p, eic),
             lambda p: tckpt.save_eic(p, bridge.eic_from_numpy(eic, CPU))),
            ("cfg", lambda p: jckpt.save_channel_cfg(p, res.channel_cfg),
             lambda p: tckpt.save_channel_cfg(p, res.channel_cfg)),
            ("pruned", lambda p: jckpt.save_pruned(p, res.params, res.state),
             lambda p: tckpt.save_pruned(p, res.params, res.state)),
            ("pruned_tensors",
             lambda p: jckpt.save_pruned(p, res.params, res.state),
             lambda p: tckpt.save_pruned(p, *bridge.params_from_numpy(
                 res.params, res.state, device=CPU)))):
        a, b = str(tmp_path / f"j_{name}.msgpack"), str(tmp_path /
                                                        f"t_{name}.msgpack")
        jsave(a)
        tsave(b)
        assert read(a) == read(b), name

    # and back: each file read by the other package
    a = str(tmp_path / "j_eic.msgpack")
    assert_tree_equal(tckpt.load_eic(a), jckpt.load_eic(a))
    for f in ("j_cfg", "t_cfg"):
        path = str(tmp_path / f"{f}.msgpack")
        got, want = tckpt.load_channel_cfg(path), jckpt.load_channel_cfg(path)
        assert_tree_equal(got, want)
        assert all(type(got[n][k]) is type(want[n][k])
                   for n in want for k in want[n])
    for f in ("j_pruned", "t_pruned"):
        path = str(tmp_path / f"{f}.msgpack")
        p, s = tckpt.load_pruned(path, device=CPU)
        jp, js = jckpt.load_pruned(path)
        assert_tree_equal(bridge.params_to_numpy(p, s), (jp, js))
        assert_tree_equal(jp, res.params)


OPTS = [("sgd", None), ("sgd", "bn,bias"), ("adamw", None),
        ("adamw", "bn,bias")]


def _both_states(tiny, optim, no_decay, steps, prune_type="dcfp"):
    """The same tiny model trained ``steps`` steps on one batch, first in
    the port; the JAX state carries the port's numbers (through bridge),
    so both packages hold one state."""
    jm, tm, params, state = tiny
    r = np.random.default_rng(5)
    batch = {"img": r.standard_normal((2, 9, 9, 3)).astype(np.float32),
             "label": r.integers(0, 5, (2, 9, 9))}
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    topt = toptim.build_optimizer(optim=optim, no_decay=no_decay,
                                  learning_rate=0.05, num_steps=50,
                                  params=tp)
    st = ttrainer.create_train_state(tm, tp, ts, topt,
                                     prune_type=prune_type, device=CPU)
    step = ttrainer.make_train_step(tm, tcrit.build_criterions("ce"), topt,
                                    device=CPU)
    for _ in range(steps):
        st, _ = step(st, batch)
    tx = joptim.build_optimizer(optim=optim, no_decay=no_decay,
                                learning_rate=0.05, num_steps=50,
                                params=params)
    jst = jtrainer.create_train_state(jm, to_jax(params), to_jax(state), tx,
                                      prune_type=prune_type)
    sd = tckpt.train_state_dict(st, topt.masked)
    jst = serialization.from_state_dict(jst, jax.tree.map(np.asarray, sd))
    return topt, st, jst


@pytest.mark.parametrize("prune_type", ["dcfp", None], ids=["eic", "noeic"])
@pytest.mark.parametrize("optim,no_decay", OPTS,
                         ids=[f"{o}-{'mask' if m else 'nomask'}"
                              for o, m in OPTS])
def test_train_state_files_equal_and_cross_load(tiny, tmp_path, optim,
                                                no_decay, prune_type):
    topt, st, jst = _both_states(tiny, optim, no_decay, 2, prune_type)
    a, b = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jckpt.save_train_state(a, jst)
    tckpt.save_train_state(b, st, topt)
    assert read(a) == read(b)
    assert read(b) == serialization.msgpack_serialize(
        serialization.to_state_dict(jax.tree.map(np.asarray, jst)))
    # the port reads the JAX package's file into a fresh template
    _, fresh, jfresh = _both_states(tiny, optim, no_decay, 0, prune_type)
    back = tckpt.load_train_state(a, fresh, device=CPU)
    assert back.step == 2 and back.opt_state["count"] == 2
    assert_tree_equal(np_state(back), np_state(st))
    assert (back.eic is None) == (prune_type is None)
    # the JAX package reads the port's file
    jback = jckpt.load_train_state(b, jfresh)
    assert_tree_equal(serialization.to_state_dict(
        jax.tree.map(np.asarray, jback)),
        tckpt.train_state_dict(st, topt.masked))


def test_load_train_state_refuses_other_structure(tiny, tmp_path):
    topt, st, _ = _both_states(tiny, "sgd", None, 1)
    path = str(tmp_path / "s.msgpack")
    tckpt.save_train_state(path, st, topt)
    _, other, _ = _both_states(tiny, "adamw", None, 0)
    with pytest.raises(ValueError, match="does not match"):
        tckpt.load_train_state(path, other, device=CPU)


def test_train_loop_resume_bit_equal(tiny, tmp_path):
    """A port TrainLoop stopped at step 3 by its save window, saved,
    loaded into a fresh state and resumed to step 6 ends bit-equal to the
    uninterrupted 6 steps (dropout off)."""
    jm, tm, params, state = tiny
    r = np.random.default_rng(8)
    batches = [{"img": r.standard_normal((2, 12, 12, 3)).astype(np.float32),
                "label": r.integers(0, 5, (2, 12, 12))} for _ in range(6)]

    def loop(num_steps, hook=None):
        opt = toptim.build_optimizer(optim="sgd", learning_rate=0.05,
                                     num_steps=100, warmup=2,
                                     no_decay="bn,bias",
                                     params=bridge.params_from_numpy(
                                         params, state, device=CPU)[0])
        lp = ttrainer.TrainLoop(model=tm,
                                criterion=tcrit.build_criterions("ce"),
                                optimizer=opt, num_steps=num_steps,
                                lr_schedule=opt.schedule, log_every=2,
                                save_pred_every=3, snapshot_hook=hook,
                                prune_type="dcfp")
        tp, ts = bridge.params_from_numpy(params, state, device=CPU)
        return lp, opt, ttrainer.create_train_state(tm, tp, ts, opt,
                                                    prune_type="dcfp",
                                                    device=CPU)

    lp, _, s0 = loop(6)
    full = lp.run(s0, iter(batches), device=CPU)

    paths = []

    def hook(st, step):
        paths.append(str(tmp_path / f"CS_scenes_{step}.msgpack"))
        tckpt.save_train_state(paths[-1], st, opt)

    lp, opt, s0 = loop(6, hook)
    lp.num_steps = 3
    lp.run(s0, iter(batches), device=CPU)
    assert [p.rsplit("_", 1)[1] for p in paths] == ["3.msgpack"]
    _, _, fresh = loop(6)
    resumed = tckpt.load_train_state(paths[0], fresh, device=CPU)
    assert resumed.step == 3
    lp.num_steps = 6
    end = lp.run(resumed, iter(batches[3:]), start_step=3, device=CPU)
    assert end.step == full.step == 6
    assert_tree_equal(np_state(end), np_state(full))


# -- non-strict loading -------------------------------------------------------

def test_merge_params_reports_like_jax():
    template = {"a": {"kernel": np.zeros((3, 3, 4, 8), np.float32)},
                "b": {"scale": np.ones(8, np.float32),
                      "bias": np.zeros(8, np.float32)},
                "d": {"bias": np.zeros(2, np.float32)}}
    loaded = {"a": {"kernel": np.full((3, 3, 4, 8), 2.0, np.float32)},
              "b": {"scale": np.ones(6, np.float32),
                    "bias": np.full(8, 3.0, np.float32)},
              "c": {"bias": np.zeros(5, np.float32)}}
    got, want = (mod.merge_params(template, loaded) for mod in (tckpt, jckpt))
    assert got[1] == want[1] and got[2] == want[2]
    assert any("b/scale (shape" in m for m in got[1]) and "d/bias" in got[1]
    assert got[2] == ["c/bias"]
    assert_tree_equal(got[0], want[0])


@pytest.mark.parametrize("kind", ["snapshot", "pruned", "bare"])
def test_load_params_non_strict_like_jax(tiny, tmp_path, kind):
    jm, tm, params, state = tiny
    topt, st, jst = _both_states(tiny, "sgd", None, 2)
    path = str(tmp_path / f"{kind}.msgpack")
    if kind == "snapshot":
        jckpt.save_train_state(path, jst)
    elif kind == "pruned":
        _, res = pruned(tm, params, state)
        jckpt.save_pruned(path, res.params, res.state)
    else:
        jckpt.save_pytree(path, np_state(st)["params"])
    # templates: the port's tensors and the JAX package's arrays
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    got_p, got_s = tckpt.load_params_non_strict(path, tp, ts, device=CPU)
    want_p, want_s = jckpt.load_params_non_strict(path, to_jax(params),
                                                  to_jax(state))
    assert_tree_equal(bridge.params_to_numpy(got_p, got_s),
                      (jax.tree.map(np.asarray, want_p),
                       jax.tree.map(np.asarray, want_s)))
    only_p, none_s = tckpt.load_params_non_strict(path, params, device=CPU)
    assert none_s is None
    assert_tree_equal(bridge.params_to_numpy(only_p, {})[0],
                      jax.tree.map(np.asarray, want_p))


# -- reference .pth interop ---------------------------------------------------

def test_pth_artifacts_load_equal(tiny, tmp_path):
    jm, tm, params, state = tiny
    eic, res = pruned(tm, params, state)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    sd = tconvert.to_torch_state_dict(tp, ts)
    want_sd = jconvert.to_torch_state_dict(params, state)
    assert sd.keys() == want_sd.keys()
    assert all(torch.equal(sd[k], want_sd[k]) for k in sd)
    assert all(torch.equal(v, sd[k]) for k, v in
               tconvert.to_torch_state_dict(params, state).items())

    full = str(tmp_path / "full.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               full)
    got = tckpt.load_params_non_strict(full, tp, ts, device=CPU)
    want = jckpt.load_params_non_strict(full, params, state)
    assert_tree_equal(bridge.params_to_numpy(*got), want)

    cfg = str(tmp_path / "channel_cfg.pth")
    tckpt.save_channel_cfg(cfg, res.channel_cfg)
    got, want = tckpt.load_channel_cfg(cfg), jckpt.load_channel_cfg(cfg)
    assert_tree_equal(got, want)
    assert_tree_equal(got, res.channel_cfg)

    pr = str(tmp_path / "pruned.pth")
    tckpt.save_pruned(pr, res.params, res.state)
    blob = torch.load(pr, weights_only=True)
    ref = jconvert.to_torch_state_dict(res.params, res.state)
    assert blob.keys() == ref.keys()
    assert all(torch.equal(blob[k], ref[k]) for k in ref)

    score = str(tmp_path / "score.pth")
    torch.save({"eic": {k: torch.from_numpy(v) for k, v in eic.items()}},
               score)
    assert_tree_equal(tckpt.load_eic(score), jckpt.load_eic(score))


def test_unsafe_pth_needs_opt_in(tmp_path, monkeypatch):
    from fractions import Fraction
    path = str(tmp_path / "odd.pth")
    torch.save({"obj": Fraction(1, 3)}, path)  # not weights_only loadable
    monkeypatch.delenv("DCFP_UNSAFE_TORCH_LOAD", raising=False)
    with pytest.raises(RuntimeError, match="DCFP_UNSAFE_TORCH_LOAD"):
        tckpt._torch_load(path)
    monkeypatch.setenv("DCFP_UNSAFE_TORCH_LOAD", "1")
    assert tckpt._torch_load(path) == {"obj": Fraction(1, 3)}


def test_torch_state_dict_to_graph_like_jax(tiny, tmp_path):
    jm, tm, params, state = tiny
    sd = jconvert.to_torch_state_dict(params, state)
    del sd["n1.running_var"], sd["c2.weight"]
    sd["extra.weight"] = torch.zeros(3)
    sd_ok = {k: v for k, v in sd.items() if k != "n1.running_mean"}
    sd_ok["n1.running_var"] = torch.ones(8)
    sd_ok["n1.running_mean"] = torch.zeros(8)
    got = tconvert.torch_state_dict_to_graph(tm.graph, sd_ok, device=CPU)
    want = jconvert.torch_state_dict_to_graph(jm.graph, sd_ok)
    assert got[2] == want[2] and "c2.weight" in got[2]["missing"]
    assert got[2]["unexpected"] == ["extra"]
    assert_tree_equal(bridge.params_to_numpy(got[0], got[1]),
                      (want[0], want[1]))
    assert got[0]["c1"]["kernel"].shape == (8, 3, 3, 3)  # OIHW, a rename
    with pytest.raises(KeyError, match="strict"):
        tconvert.torch_state_dict_to_graph(tm.graph, sd_ok, strict=True,
                                           device=CPU)
    path = str(tmp_path / "m.pth")
    torch.save({"model": sd_ok}, path)
    got2 = tconvert.load_torch_checkpoint(tm.graph, path, device=CPU)
    assert_tree_equal(got2[0], got[0]) and got2[2] == got[2]


def test_merge_pretrained_backbone_like_jax():
    b = JBuilder("bb")
    x = b.input("image")
    x = b.conv_bn_relu(x, "backbone.stem", out_ch=4, kernel=3)
    b.conv(x, "head", out_ch=3, kernel=1, padding=0, bias=True)
    jg = b.finish(["head"])
    tb = TBuilder("bb")
    x = tb.input("image")
    x = tb.conv_bn_relu(x, "backbone.stem", out_ch=4, kernel=3)
    tb.conv(x, "head", out_ch=3, kernel=1, padding=0, bias=True)
    tg = tb.finish(["head"])
    params, state = np_params(jg, 4)
    other, ostate = np_params(jg, 5)
    sd = {k[len("backbone."):]: v for k, v in
          jconvert.to_torch_state_dict(other, ostate).items()
          if k.startswith("backbone.")}
    jp = {n: dict(d) for n, d in params.items()}
    js = {n: dict(d) for n, d in state.items()}
    jconvert.merge_pretrained_backbone(jg, sd, jp, js)
    tp, ts = bridge.params_from_numpy(params, state, device=CPU)
    tconvert.merge_pretrained_backbone(tg, sd, tp, ts, device=CPU)
    assert_tree_equal(bridge.params_to_numpy(tp, ts), (jp, js))
    assert_tree_equal(jp["head"], params["head"])
