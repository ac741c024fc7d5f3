"""The port's spatial sharding (``parallel/spatial.py`` and the banded
paths of ``graph/apply.py``, ``losses/criteria.py``,
``engine/trainer.py``, ``engine/evaluator.py`` and the CLIs) on the CPU,
against the JAX package on the whole images and the port's own
one-process runs.

Two gloo groups, started once per module, run
``tests/torch_spatial_worker.py``: 2 ranks as a 1 x 2 mesh and 4 ranks
as a 2 x 2 (data x spatial) mesh.  Each rank runs every case in one go
and writes ``rank<r>.npz``; the JAX package runs here, in the pytest
process, on one device and on the 8-device virtual CPU mesh of
``tests/conftest.py``.  Beside them the CLIs run on a tiny Cityscapes
fixture: ``train --num-devices 2 --spatial-shards 2`` against the same
train in one process, and ``evaluate --eval-shard spatial`` against
the same evaluate in one process.  Every process gets a free localhost
port and a hard timeout, after which its whole process group is killed
and the test fails.
"""

import functools
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfp_tpu.engine import evaluator as jev
from dcfp_tpu.engine import optim as joptim
from dcfp_tpu.engine import trainer as jtrainer
from dcfp_tpu.graph.apply import graph_apply as jgraph_apply
from dcfp_tpu.graph.ir import GraphBuilder as JBuilder
from dcfp_tpu.losses import criteria as jcrit
from dcfp_tpu.models.heads import SegModel as JSegModel
from dcfp_tpu.models.registry import build_model as jbuild_model
from dcfp_tpu.parallel.mesh import create_mesh as jcreate_mesh
from dcfp_tpu_torch import bridge
from dcfp_tpu_torch.data.synthetic import make_cityscapes_fixture
from dcfp_tpu_torch.engine import optim as toptim
from dcfp_tpu_torch.engine import trainer as ttrainer
from dcfp_tpu_torch.graph.apply import graph_apply as tgraph_apply
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.losses import criteria as tcrit
from dcfp_tpu_torch.models.heads import SegModel as TSegModel
from dcfp_tpu_torch.models.registry import build_model as tbuild_model
from dcfp_tpu_torch.utils import checkpoint as ckpt

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_spec = importlib.util.spec_from_file_location(
    "torch_spatial_worker", os.path.join(HERE, "torch_spatial_worker.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)

from test_torch_parallel import (  # noqa: E402
    _start, _tree, _wait)

GROUPS = (2, 4)  # worlds: 1 x 2 and 2 x 2
BP = '{"os": 32, "mg_unit": [1, 1, 1], "inplanes": 64}'
MODEL = ["--dataset", "CS", "--model", "deeplabv3", "--backbone",
         "resnet50", "--backbone-para", BP, "--align-corner", "true"]
CLI_TRAIN = MODEL + [
    "--input-size", "48,48", "--batch-size", "2", "--num-workers", "1",
    "--log-every", "1", "--random-seed", "42", "--random-mirror",
    "--random-scale", "--num-steps", "2", "--save-pred-every", "2",
    "--loss-type", "gsrl", "--balance", "1", "--deepsup", "true",
    "--prune-type", "dcfp"]
CLI_EVAL = MODEL + ["--data-dir", "val", "--whole", "true",
                    "--num-workers", "1", "--dtype", "float32"]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worker groups and the four CLI jobs, started together; their
    outputs once all have ended."""
    tmp = tmp_path_factory.mktemp("spatial")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               DCFP_PLATFORM="cpu")
    root = str(tmp / "cs")
    env.update(DCFP_CS_ROOT=root,
               DCFP_CS_TRAIN_LIST=make_cityscapes_fixture(
                   root, n_images=4, hw=(64, 80), split="train"),
               DCFP_CS_VAL_LIST=make_cityscapes_fixture(
                   root, n_images=3, hw=(64, 80), split="val"))
    # the snapshot both evaluate jobs read
    model = tbuild_model("deeplabv3", backbone="resnet50",
                         backbone_para=W.BP, num_classes=19,
                         align_corner=True, deepsup=False)
    tp, ts = bridge.params_from_numpy(*W.eval_params(model.graph, 11),
                                      device="cpu")
    opt = toptim.build_optimizer(**W.OPT)
    snap = str(tmp / "snap.msgpack")
    ckpt.save_train_state(snap, ttrainer.create_train_state(
        model, tp, ts, opt, device="cpu"), opt)
    out = {k: str(tmp / k) for k in
           ("w2", "w4", "train_spatial", "train_one")}
    for d in out.values():
        os.makedirs(d)
    out.update({k: str(tmp / f"{k}.txt") for k in
                ("eval_spatial", "eval_one")})
    procs, logs = [], []

    def start(argv, name):
        logs.append(str(tmp / f"{name}.log"))
        procs.append(_start(argv, env, open(logs[-1], "w")))

    for world in GROUPS:
        port = _free_port()
        for rank in range(world):
            start([sys.executable, os.path.join(HERE,
                                                "torch_spatial_worker.py"),
                   str(port), str(rank), str(world), out[f"w{world}"]],
                  f"w{world}_{rank}")
    train = [sys.executable, "-m", "dcfp_tpu_torch.cli.train"] + CLI_TRAIN
    for name, flags in (("train_spatial", ["--num-devices", "2",
                                           "--spatial-shards", "2"]),
                        ("train_one", ["--num-devices", "1"])):
        start(train + flags + [
            "--snapshot-dir", out[name], "--metrics-file",
            os.path.join(out[name], "metrics.jsonl")], name)
    evaluate = [sys.executable, "-m", "dcfp_tpu_torch.cli.evaluate",
                "--restore-from", snap] + CLI_EVAL
    start(evaluate + ["--eval-shard", "spatial", "--num-devices", "2",
                      "--spatial-shards", "2", "--result-file",
                      out["eval_spatial"]], "eval_spatial")
    start(evaluate + ["--result-file", out["eval_one"]], "eval_one")
    rcs = _wait(procs, logs)
    for rc, log in zip(rcs, logs):
        assert rc == 0, open(log).read()[-6000:]
    for world in GROUPS:
        out[world] = [dict(np.load(os.path.join(out[f"w{world}"],
                                                f"rank{r}.npz")))
                      for r in range(world)]
    out["logs"] = logs
    return out


def _ranks():
    return [(world, r) for world in GROUPS for r in range(world)]


def _data_rank(world, r):
    return r // W.S


# ---------------------------------------------------------------------------
# (a) the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", GROUPS)
def test_mesh_layout(runs, world):
    """Global rank r is data rank r // 2 and spatial rank r % 2, as the
    JAX package's devices reshaped (n_data, n_spatial); a spatial group
    is the 2 consecutive ranks of its data rank."""
    for r, npz in enumerate(runs[world]):
        d = r // 2
        assert npz["mesh"].tolist() == [world // 2, 2, r, d, r % 2,
                                        2 * d, 2 * d + 1]


# ---------------------------------------------------------------------------
# (b) the ops, one a graph, against the JAX package on the whole input
# ---------------------------------------------------------------------------

def _jax_graph(graph, params, state, x_nchw, **kw):
    outs, _ = jgraph_apply(graph, jax.tree.map(jnp.asarray, params),
                           jax.tree.map(jnp.asarray, state),
                           {"image": jnp.asarray(x_nchw.transpose(0, 2, 3,
                                                                  1))}, **kw)
    return {k: np.asarray(v).transpose(0, 3, 1, 2) for k, v in outs.items()}


@pytest.mark.parametrize("case", [c for c in W.OP_CASES
                                  if not c.startswith("dropout")])
def test_op_matches_jax(runs, case):
    """Each op's bands, gathered, give the JAX package's op on the whole
    input, rtol 1e-5, atol 1e-6 (tests/test_evaluator.py's): convs at
    stride 1 and 2 over 33 and 41 rows (odd over 2 ranks), a dilation-9
    conv whose halo passes a whole 8-row band, the max pool, resizes
    both ways and from a global pool's 1x1, and the two pools."""
    shape, jg = W.op_graph(JBuilder, case)
    p, s = W.P.np_params(jg)
    want = _jax_graph(jg, p, s, W.op_input(shape))[jg.outputs[0]]
    for world, r in _ranks():
        np.testing.assert_allclose(runs[world][r][f"ops/{case}"], want,
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{case} {world}:{r}")


@pytest.mark.parametrize("case", ["dropout", "dropout2d"])
def test_dropout_matches_one_process(runs, case):
    """Both dropouts drop, on each rank, its data rank's images and its
    band's rows of the mask one process draws on the global batch (the
    data ranks' inputs stacked): bit-equal to the port's one-process
    run."""
    shape, tg = W.op_graph(TBuilder, case)
    x = W.op_input(shape)
    for world in GROUPS:
        n_data = world // W.S
        whole = torch.from_numpy(np.concatenate([x] * n_data))
        want, _ = tgraph_apply(tg, {}, {}, {"image": whole},
                               channels_first=True, train=True,
                               generator=torch.Generator().manual_seed(3))
        want = want[tg.outputs[0]].numpy()
        n = shape[0]
        for r in range(world):
            d = _data_rank(world, r)
            np.testing.assert_array_equal(runs[world][r][f"ops/{case}"],
                                          want[d * n:(d + 1) * n])
        assert 0.25 < (want == 0).mean() < 0.75


def test_graph_forward_matches_jax(runs):
    """The deeplabv3 graph (os 32, stem 64, deepsup) on 97 x 70 images:
    both heads' logits, gathered, against the JAX package's forward on
    the whole images, rtol 1e-5, atol 1e-6."""
    model = jbuild_model("deeplabv3", backbone="resnet50",
                         backbone_para=W.BP, num_classes=W.C,
                         align_corner=True, deepsup=True)
    p, s = W.P.np_params(model.graph, 6)
    want = _jax_graph(model.graph, p, s,
                      W.op_input((2, 3) + W.GRAPH_HW, 7))
    for world, r in _ranks():
        for k, v in want.items():
            np.testing.assert_allclose(runs[world][r][f"graph/{k}"], v,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} {world}:{r}")


# ---------------------------------------------------------------------------
# (c) one train step per loss against the JAX package's on the global batch
# ---------------------------------------------------------------------------

SELF_NOISE_SCALES = (1 + 2.0 ** -22, 1 - 2.0 ** -22)


def _jax_step(name, scale=1.0):
    """The JAX package's step on the global batch, its image x ``scale``:
    numpy trees, loss and grad norm."""
    jm = W.aspp_model(JBuilder, JSegModel)
    p0, s0 = W.P.np_params(jm.graph)
    tx = joptim.build_optimizer(**W.OPT)
    js = jtrainer.create_train_state(jm, jax.tree.map(jnp.asarray, p0),
                                     jax.tree.map(jnp.asarray, s0), tx,
                                     prune_type="dcfp")
    step = jtrainer.make_train_step(jm, jcrit.build_criterions(
        **W.LOSSES[name]), tx)
    batch = W.train_batch()
    batch["img"] = (batch["img"] * np.float32(scale)).astype(np.float32)
    js, m = step(js, jax.tree.map(jnp.asarray, batch), jax.random.key(1))
    want = jax.tree.map(np.asarray, {"params": js.params, "bn": js.bn_state,
                                     "eic": js.eic})
    return want, float(m["loss"]), float(m["grad_norm"])


@functools.lru_cache(maxsize=None)
def _references(name):
    """The JAX package's step on the global batch, its self-noise (twice
    the largest move of each tensor, and of the loss and grad norm, when
    the image is scaled by 1 + 2^-22 or 1 - 2^-22), and the port's
    one-process EIC, once a loss."""
    want, loss, gnorm = _jax_step(name)
    moved = [_jax_step(name, s) for s in SELF_NOISE_SCALES]
    noise = {part: {n: {k: 2 * max(float(np.abs(np.asarray(o[0][part][n][k],
                                                            np.float64)
                                                 - v).max()) for o in moved)
                        for k, v in d.items()}
                    for n, d in want[part].items()}
             for part in ("params", "bn")}
    noise["loss"] = 2 * max(abs(o[1] - loss) for o in moved)
    noise["grad_norm"] = 2 * max(abs(o[2] - gnorm) for o in moved)
    return want, loss, gnorm, noise, _port_step(name)


def _close_noise(got, want, noise, what):
    """tests/test_torch_parallel.py's one-step rule (rtol 1e-5, atol 1e-6
    x max|want|) plus ``noise``, the reference's own move."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    rule = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max() + noise
    bad = np.abs(got - want) > rule
    assert not bad.any(), (what, np.abs(got - want)[bad][:5],
                           rule[bad][:5])


def _port_step(name):
    """The port's one-process step on the global batch: the EIC."""
    tm = W.aspp_model(TBuilder, TSegModel)
    opt = toptim.build_optimizer(**W.OPT)
    tp, ts = bridge.params_from_numpy(*W.P.np_params(tm.graph), device="cpu")
    st = ttrainer.create_train_state(tm, tp, ts, opt, prune_type="dcfp",
                                     device="cpu")
    new, _ = ttrainer.make_train_step(tm, tcrit.build_criterions(
        **W.LOSSES[name]), opt, device="cpu")(st, W.train_batch())
    return bridge.eic_to_numpy(new.eic)


@pytest.mark.parametrize("name", list(W.LOSSES))
@pytest.mark.parametrize("world", GROUPS)
def test_step_matches_jax_global_batch(runs, world, name):
    """1 x 2 and 2 x 2 ranks, each on its band of its data rank's images,
    give the JAX package's step on the global batch of 4; every rank
    bit-equal.

    Loss, grad norm, params and BN running statistics are held by
    tests/test_torch_parallel.py's one-step rule (rtol 1e-5, atol 1e-6 x
    max|want|) plus the reference's own noise: twice the largest move of
    each tensor (and of the loss and the grad norm) when the JAX step's
    image is scaled by 1 +/- 2^-22.  Measured on the CPU: that floor is
    2.2e-5 (CE), 4.4e-6 (OHEM) and 2.3e-5 (GSRL) of the grad norm and up
    to 1.1e-5 x max|update| of a param (OHEM), while the ranks miss JAX
    by 1.1e-5 to 1.3e-5 of the grad norm and by up to 3.4x the bare rule
    on 5 of 216 elements of a kernel (OHEM), which the rule plus the
    floor holds with a margin of ~4x: summation-order noise from the
    band split.  The EIC, against the JAX package's and against the
    port's one-process step, within the rule plus twice the one-process
    step's own distance from JAX: on this head the one-process EIC itself
    misses the rule against JAX (by up to 1.5x for CE and GSRL, 8x for
    OHEM's few mined pixels, in BNs over 4 to 8 values a channel), a
    summation-order noise that no sharding removes."""
    want, loss, gnorm, noise, one = _references(name)
    keys = sorted(want["eic"])
    jeic = np.concatenate([want["eic"][k] for k in keys])
    one = np.concatenate([one[k] for k in keys])
    ranks = runs[world]
    for npz in ranks:
        pre = f"step/{name}"
        _close_noise(npz[f"{pre}/loss"], loss, noise["loss"], "loss")
        _close_noise(npz[f"{pre}/grad_norm"], gnorm, noise["grad_norm"],
                     "grad norm")
        for part in ("params", "bn"):
            got = _tree(npz, f"{pre}/{part}")
            assert got.keys() == want[part].keys(), part
            for n, d in want[part].items():
                for k, v in d.items():
                    _close_noise(got[n][k], v, noise[part][n][k],
                                 f"{part} {n}/{k}")
        eic = np.concatenate([npz[f"{pre}/eic/{k}"] for k in keys])
        eic_noise = 2 * np.abs(one - jeic)
        for want_eic in (jeic, one):
            rule = 1e-5 * np.abs(want_eic) + 1e-6 * np.abs(want_eic).max()
            assert (np.abs(eic - want_eic) <= rule + eic_noise).all()
    for k in ranks[0]:
        if k.startswith(f"step/{name}/"):
            for npz in ranks[1:]:
                np.testing.assert_array_equal(npz[k], ranks[0][k],
                                              err_msg=k)


@pytest.mark.parametrize("world", GROUPS)
def test_remat_step_equals_plain(runs, world):
    """A GSRL step with dropout whose forward is recomputed in 3 segments
    in the backward (its exchanges and BN sums replayed) gives the plain
    banded step's params bit for bit."""
    for npz in runs[world]:
        plain = _tree(npz, "remat0/params")
        assert plain
        for n, d in _tree(npz, "remat3/params").items():
            for k, v in d.items():
                np.testing.assert_array_equal(v, plain[n][k],
                                              err_msg=f"{n}/{k}")


def test_too_few_rows_raise_before_running():
    """A banded node with fewer rows than the spatial group has ranks
    raises a ValueError naming it before any op runs (no group is needed
    to find it)."""
    from dcfp_tpu_torch.parallel.spatial import Axis
    shape, tg = W.op_graph(TBuilder, "conv_s2")
    axis = Axis(32, 0, tuple(range(32)))
    x = torch.zeros((1, 4, 2, 21))
    with pytest.raises(ValueError, match="'op': 21 rows"):
        tgraph_apply(tg, {"op": {}}, {}, {"image": x}, channels_first=True,
                     input_hw=shape[2:], spatial_axis=axis)


# ---------------------------------------------------------------------------
# (d) the Predictor and the eval loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_preds():
    jm = W.aspp_model(JBuilder, JSegModel, deepsup=False)
    p, s = W.eval_params(jm.graph, 5)
    p, s = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s)
    single = jev.Predictor(jm.graph, p, s, align_corner=True)
    meshed = {shard: jev.Predictor(jm.graph, p, s, align_corner=True,
                                   mesh=jcreate_mesh(4, 2), shard=shard)
              for shard in ("spatial", "both")}
    return single, meshed


@pytest.mark.parametrize("world", GROUPS)
def test_predictor_whole_matches_jax(runs, jax_preds, world):
    """Whole-image logits over the spatial group (shard="spatial" on 1 x
    2, "both" on 2 x 2, each data rank its own images) against the JAX
    Predictor on one device and over its 4 x 2 mesh, rtol 1e-5, atol
    1e-6; labels through the plain K1 equal to the JAX package's where
    the top-2 margin is decided, and every rank's equal."""
    single, meshed = jax_preds
    shard = "spatial" if world == 2 else "both"
    for r, npz in enumerate(runs[world]):
        img = W.images()[_data_rank(world, r)]
        want = np.asarray(single.predict_whole(img))
        np.testing.assert_allclose(np.asarray(meshed[shard].predict_whole(
            img)), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(npz["pred/whole"], want, rtol=1e-5,
                                   atol=1e-6)
        labels = np.asarray(single.predict_whole_labels(img))
        top2 = np.sort(want, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > 1e-4 * np.abs(want).max()
        assert decided.mean() > 0.99 and len(np.unique(labels)) >= 3
        np.testing.assert_array_equal(npz["pred/labels"][decided],
                                      labels[decided])
        np.testing.assert_array_equal(
            npz["pred/labels"], runs[world][r - r % 2]["pred/labels"])


@pytest.mark.parametrize("mode", ["sliding", "ms_flip"])
def test_predictor_sliding_and_ms_match_jax(runs, jax_preds, mode):
    """Sliding 24 x 24 tiles and ms 0.75, 1 + flip (tiles) over the 2 x 2
    mesh ("both"): the JAX package's on one device, rtol 1e-5, atol
    1e-6."""
    single, _ = jax_preds
    for r, npz in enumerate(runs[4]):
        img = W.images()[_data_rank(4, r)]
        if mode == "sliding":
            want = single.predict_sliding(img, W.TILE, W.C)
        else:
            want = single.predict_multiscale(img, W.TILE, num_classes=W.C,
                                             return_probs=True, **W.MS)
        np.testing.assert_allclose(npz[f"pred/{mode}"], np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", GROUPS)
def test_eval_confusion_counted_once(runs, jax_preds, world):
    """Five items over the data ranks (all 5 on 1 x 2, 3 + 2 on 2 x 2):
    the summed confusion of the protocol and pipelined loops equals the
    JAX package's on one device, each image counted by the first rank of
    its spatial group only."""
    single, _ = jax_preds
    want = jev.evaluate(single, W.P.eval_items(), num_classes=W.C,
                        align_corner=True, fps_warmup=0)["confusion"]
    assert np.count_nonzero(np.diag(want)) >= 3
    for r, npz in enumerate(runs[world]):
        assert bool(npz["eval/counts"]) == (r % 2 == 0)
        np.testing.assert_array_equal(npz["eval/confusion"], want)
        np.testing.assert_array_equal(npz["eval/confusion_pipelined"], want)


def test_fetch_rows_gradcheck(runs):
    """fetch_rows' backward (the reverse exchange, a row read by both
    ranks summing both gradients) passes torch.autograd.gradcheck in
    f64 on 2 ranks."""
    assert all(bool(npz["gradcheck"]) for npz in runs[2])


# ---------------------------------------------------------------------------
# (e) the CLIs
# ---------------------------------------------------------------------------

def test_cli_train_spatial_equals_one_process(runs):
    """``train --num-devices 2 --spatial-shards 2`` (GSRL, balance 1,
    random scale, so compact batches with pad triples, dropout in the
    deepsup head) writes the snapshot, the EIC scores and the metrics
    once, with the one-process run's keys and shapes, and its first
    step's loss equals the one-process run's by the card-against-CPU
    train check's loss rule (rtol 1e-4: the same params and batch, bands
    summed in another order, through train-mode BN over as few as 8
    values).  Later values
    are not held element-wise: one step of this narrow net at 48 x 48
    moves by the input's own f32 rounding as much as by the bands' (the
    one-process update's relative L2 self-noise is ~0.09), and the
    worker's steps hold the numerics."""
    names = ["CS_scenes_2.msgpack", "metrics.jsonl", "score.msgpack"]
    assert sorted(os.listdir(runs["train_spatial"])) == names
    assert sorted(os.listdir(runs["train_one"])) == names
    for name in names[::2]:
        got = ckpt._flat(ckpt.load_pytree(os.path.join(
            runs["train_spatial"], name)))
        want = ckpt._flat(ckpt.load_pytree(os.path.join(
            runs["train_one"], name)))
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.shape(got[k]) == np.shape(v), k
            assert np.isfinite(np.asarray(got[k], np.float64)).all(), k

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f]

    got, want = losses(runs["train_spatial"]), losses(runs["train_one"])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    log = open(runs["logs"][sum(GROUPS)]).read()
    assert "mesh: 1 data x 2 spatial" in log


def test_cli_evaluate_spatial_equals_one_process(runs):
    """``evaluate --eval-shard spatial --num-devices 2 --spatial-shards
    2`` writes one result, equal to one process's but for the FPS."""

    def text(path):
        t = open(path).read()
        assert t.count("test with") == 1
        return t[:t.rindex(" FPS:")]

    assert text(runs["eval_spatial"]) == text(runs["eval_one"])
