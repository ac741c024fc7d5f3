"""The port's data-parallel runs (``dcfp_tpu_torch/parallel``) on the CPU:
one 2-process gloo group, started once per module, against the JAX
package's step on the global batch and the port's own one-process runs.

``tests/torch_parallel_worker.py`` is each rank: it imports only the
port, runs every case in one go and writes ``rank<r>.npz``; the JAX
package runs here, in the pytest process.  Beside it the train CLI runs
twice on a tiny Cityscapes fixture: ``--num-devices 2`` (the CLI starts
two gloo workers itself) and ``--distributed true`` in two processes.
Every process gets a free localhost port and a hard timeout, after which
its whole process group is killed and the test fails.
"""

import importlib.util
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfp_tpu.engine import evaluator as jev
from dcfp_tpu.engine import optim as joptim
from dcfp_tpu.engine import trainer as jtrainer
from dcfp_tpu.graph.ir import GraphBuilder as JBuilder
from dcfp_tpu.losses import criteria as jcrit
from dcfp_tpu.models.heads import SegModel as JSegModel
from dcfp_tpu_torch import bridge
from dcfp_tpu_torch.cli import evaluate as t_evaluate
from dcfp_tpu_torch.cli import train as t_train
from dcfp_tpu_torch.data.synthetic import make_cityscapes_fixture
from dcfp_tpu_torch.engine import evaluator as tev
from dcfp_tpu_torch.engine import optim as toptim
from dcfp_tpu_torch.engine import trainer as ttrainer
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.losses import criteria as tcrit
from dcfp_tpu_torch.models.heads import SegModel as TSegModel

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_spec = importlib.util.spec_from_file_location(
    "torch_parallel_worker", os.path.join(HERE, "torch_parallel_worker.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)

TIMEOUT_S = 240  # per process group; the file takes ~30 s alone
BP = '{"os": 32, "mg_unit": [1, 1, 1], "inplanes": 64}'
CLI_TRAIN = ["--dataset", "CS", "--model", "deeplabv3", "--backbone",
             "resnet50", "--backbone-para", BP, "--align-corner", "true",
             "--input-size", "48,48", "--batch-size", "2", "--num-workers",
             "1", "--log-every", "1", "--random-seed", "42",
             "--random-mirror", "--num-steps", "2", "--save-pred-every", "2",
             "--loss-type", "ce", "--deepsup", "true", "--prune-type", "dcfp"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(argv, env, log):
    return subprocess.Popen(argv, env=env, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True)


def _wait(procs, logs):
    """Wait for every process; on the timeout kill every process group
    and fail.  Returns the exit codes."""
    try:
        return [p.wait(timeout=TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in procs:
            p.wait()
        tails = "\n".join(open(f).read()[-3000:] for f in logs)
        pytest.fail(f"a process group outlived {TIMEOUT_S} s:\n{tails}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker group and both CLI jobs, started together; their
    outputs once all have ended."""
    tmp = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               DCFP_PLATFORM="cpu")
    root = str(tmp / "cs")
    env.update(DCFP_CS_ROOT=root, DCFP_CS_TRAIN_LIST=make_cityscapes_fixture(
        root, n_images=4, hw=(64, 80), split="train"))
    out = {k: str(tmp / k) for k in ("worker", "cli_spawn", "cli_dist")}
    for d in out.values():
        os.makedirs(d)
    procs, logs = [], []

    def start(argv, name):
        logs.append(str(tmp / f"{name}.log"))
        procs.append(_start(argv, env, open(logs[-1], "w")))

    port = _free_port()
    for rank in range(W.WORLD):
        start([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
               str(port), str(rank), out["worker"]], f"worker{rank}")
    train = [sys.executable, "-m", "dcfp_tpu_torch.cli.train"] + CLI_TRAIN
    start(train + ["--num-devices", "2", "--snapshot-dir",
                   out["cli_spawn"]], "cli_spawn")
    port = _free_port()
    for rank in range(2):
        start(train + ["--distributed", "true", "--coordinator",
                       f"localhost:{port}", "--num-processes", "2",
                       "--process-id", str(rank), "--snapshot-dir",
                       out["cli_dist"]], f"cli_dist{rank}")
    rcs = _wait(procs, logs)
    for rc, log in zip(rcs, logs):
        assert rc == 0, open(log).read()[-6000:]
    ranks = [dict(np.load(os.path.join(out["worker"], f"rank{r}.npz")))
             for r in range(W.WORLD)]
    return dict(out, ranks=ranks, logs=logs)


def _tree(npz, prefix):
    """{node: {key: array}} back from the worker's flat keys."""
    tree = {}
    for k, v in npz.items():
        if k.startswith(prefix + "/"):
            node, key = k[len(prefix) + 1:].rsplit("/", 1)
            tree.setdefault(node, {})[key] = v
    return tree


def _close(got, want, what):
    """tests/test_torch_train.py's one-step rule: rtol 1e-5, atol 1e-6 x
    max|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


def _close_trees(got, want, what):
    assert got.keys() == want.keys(), what
    for n in want:
        for k in want[n]:
            _close(got[n][k], want[n][k], f"{what} {n}/{k}")


def _fails(got, want):
    try:
        _close(got, want, "")
    except AssertionError:
        return True
    return False


# ---------------------------------------------------------------------------
# (a) one step per loss against the JAX package on the global batch
# ---------------------------------------------------------------------------

def _jax_step(name):
    jm = W.model(JBuilder, JSegModel)
    p0, s0 = W.np_params(jm.graph)
    tx = joptim.build_optimizer(**W.OPT)
    js = jtrainer.create_train_state(jm, jax.tree.map(jnp.asarray, p0),
                                     jax.tree.map(jnp.asarray, s0), tx,
                                     prune_type="dcfp")
    step = jtrainer.make_train_step(jm, jcrit.build_criterions(
        **W.LOSSES[name]), tx)
    js, m = step(js, jax.tree.map(jnp.asarray, W.train_batch()),
                 jax.random.key(1))
    out = jax.tree.map(np.asarray, {"params": js.params, "bn": js.bn_state,
                                    "eic": js.eic})
    return out, float(m["loss"]), float(m["grad_norm"])


def _port_step(batch, name):
    """The port's one-process step on ``batch`` (this process has no
    group): the JAX-layout params and BN state and the loss."""
    tm = W.model(TBuilder, TSegModel)
    p0, s0 = W.np_params(tm.graph)
    opt = toptim.build_optimizer(**W.OPT)
    tp, ts = bridge.params_from_numpy(p0, s0, device="cpu")
    st = ttrainer.create_train_state(tm, tp, ts, opt, prune_type="dcfp",
                                     device="cpu")
    new, m = ttrainer.make_train_step(tm, tcrit.build_criterions(
        **W.LOSSES[name]), opt, device="cpu")(st, batch)
    p, s = bridge.params_to_numpy(new.params, new.bn_state)
    return p, s, float(m["loss"])


@pytest.mark.parametrize("name", list(W.LOSSES))
def test_step_matches_jax_global_batch(runs, name):
    """Two ranks of 2 images give the JAX package's step on the batch of
    4: loss, grad norm, params, BN running statistics and EIC, on both
    ranks (which agree bit for bit)."""
    want, loss, gnorm = _jax_step(name)
    for npz in runs["ranks"]:
        _close(npz[f"a/{name}/loss"], loss, "loss")
        _close(npz[f"a/{name}/grad_norm"], gnorm, "grad norm")
        _close_trees(_tree(npz, f"a/{name}/params"), want["params"], "params")
        _close_trees(_tree(npz, f"a/{name}/bn"), want["bn"], "bn")
        _close(np.concatenate([npz[f"a/{name}/eic/{k}"]
                               for k in sorted(want["eic"])]),
               np.concatenate([want["eic"][k] for k in sorted(want["eic"])]),
               "eic")
    r0, r1 = runs["ranks"]
    for k in r0:
        if k.startswith(f"a/{name}/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("name", ["ce", "ohem"])
def test_per_rank_losses_would_fail(name):
    """The input has teeth: the mean of per-rank losses (DDP's reading)
    misses the global loss, per-rank BN moments miss the global running
    statistics, and rank 0's own OHEM threshold is not the global one,
    each beyond the tolerances the 2-rank step meets."""
    want, loss, _ = _jax_step(name)
    halves = [W.rows(W.train_batch(), r) for r in range(W.WORLD)]
    steps = [_port_step(h, name) for h in halves]
    assert _fails(np.mean([s[2] for s in steps]), loss)
    assert any(_fails(steps[0][1][n][k], want["bn"][n][k])
               for n in want["bn"] for k in want["bn"][n])
    if name == "ohem":
        para = W.LOSSES["ohem"]["loss_para"]

        def threshold(batch):
            tm = W.model(TBuilder, TSegModel)
            tp, ts = bridge.params_from_numpy(*W.np_params(tm.graph),
                                              device="cpu")
            from dcfp_tpu_torch.graph.apply import graph_apply
            outs, _ = graph_apply(tm.graph, tp, ts, {"image": torch.as_tensor(
                batch["img"])}, train=True)
            return float(tcrit.ohem_threshold_and_mined(
                outs["pred"], torch.as_tensor(batch["label"]["ori"]),
                thresh=para["ohem_thres"], min_kept=para["ohem_keep"])[0])

        t_global, t_rank0 = threshold(W.train_batch()), threshold(halves[0])
        assert t_rank0 == 1.0 and t_global < 1.0
        assert _fails(t_rank0, t_global)


# ---------------------------------------------------------------------------
# (b) dropout: three steps against the port's one-process run
# ---------------------------------------------------------------------------

def test_dropout_steps_match_one_process(runs):
    """Three GSRL + EIC steps with spatial dropout 0.5: both ranks'
    params bit-equal, and within relative L2 1e-5 of one process on the
    global batches with the same generator seed."""
    tm = W.model(TBuilder, TSegModel, rate=0.5)
    p0, s0 = W.np_params(tm.graph)
    opt = toptim.build_optimizer(**W.OPT)
    tp, ts = bridge.params_from_numpy(p0, s0, device="cpu")
    st = ttrainer.create_train_state(tm, tp, ts, opt, prune_type="dcfp",
                                     device="cpu")
    step = ttrainer.make_train_step(tm, tcrit.build_criterions(
        **W.LOSSES["gsrl"]), opt, device="cpu")
    gen = torch.Generator().manual_seed(7)
    for batch in W.drop_batches():
        st, m = step(st, batch, gen)
    want, _ = bridge.params_to_numpy(st.params, st.bn_state)
    r0, r1 = runs["ranks"]
    for k in r0:
        if k.startswith("b/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    got = _tree(r0, "b/params")
    a = np.concatenate([got[n][k].ravel() for n in want for k in want[n]])
    b = np.concatenate([want[n][k].ravel() for n in want for k in want[n]])
    a0 = np.concatenate([p0[n][k].ravel() for n in want for k in want[n]])
    assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
    assert np.linalg.norm(b - a0) > 0  # the steps moved the params
    np.testing.assert_allclose(float(r0["b/loss"]), float(m["loss"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) sharded eval
# ---------------------------------------------------------------------------

def test_sharded_eval_confusion_equal(runs):
    """Five items over two ranks (3 + 2): the summed confusion of the
    protocol and pipelined loops equals the port's one-process one and
    the JAX package's; rank 0 alone wrote the result file."""
    jm = W.model(JBuilder, JSegModel, deepsup=False)
    p, s = W.np_params(jm.graph, 5)
    kw = dict(num_classes=W.C, align_corner=True, fps_warmup=0)
    want = jev.evaluate(jev.Predictor(jm.graph, jax.tree.map(jnp.asarray, p),
                                      jax.tree.map(jnp.asarray, s)),
                        W.eval_items(), **kw)["confusion"]
    tm = W.model(TBuilder, TSegModel, deepsup=False)
    tp, ts = bridge.params_from_numpy(p, s, device="cpu")
    one = tev.evaluate(tev.Predictor(tm.graph, tp, ts, device="cpu"),
                       W.eval_items(), **kw)["confusion"]
    np.testing.assert_array_equal(one, want)
    assert want.sum() > 0
    r0, r1 = runs["ranks"]
    assert [int(r0["c/n_items"]), int(r1["c/n_items"])] == [3, 2]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["c/confusion"], want)
        np.testing.assert_array_equal(r["c/confusion_pipelined"], want)
    with open(os.path.join(runs["worker"], "result.txt")) as f:
        assert f.read().count("test with") == 1


# ---------------------------------------------------------------------------
# (d) the stop consensus
# ---------------------------------------------------------------------------

def test_stop_consensus(runs):
    """SIGTERM to rank 1 only, during step 4: both ranks stop at the
    log boundary after it, and rank 0 alone snapshots (once) and writes
    the metrics file."""
    r0, r1 = runs["ranks"]
    assert int(r0["d/stop_step"]) == int(r1["d/stop_step"]) == 4
    assert r0["d/snapshots"].tolist() == [4]
    assert r1["d/snapshots"].tolist() == []
    assert os.path.exists(os.path.join(runs["worker"], "metrics0.jsonl"))
    assert not os.path.exists(os.path.join(runs["worker"], "metrics1.jsonl"))


# ---------------------------------------------------------------------------
# (e) the mesh helpers
# ---------------------------------------------------------------------------

def test_mesh_helpers(runs):
    """create_pod_mesh's shapes and validation (a 1 x 2 spatial mesh,
    rank r its spatial rank r), process_batch_slice, replicate_tree
    (rank 0's values everywhere), all_gather, and sum_across with its
    SyncBN backward."""
    for r, npz in enumerate(runs["ranks"]):
        assert int(npz["e/world"]) == 2 and int(npz["e/rank"]) == r
        assert npz["e/pod_mesh"].tolist() == [2, 1, r]
        assert npz["e/pod_mesh_dcn2"].tolist() == [2, 1]
        assert npz["e/pod_mesh_spatial"].tolist() == [1, 2, r, 0, r]
        assert npz["e/validation_raised"].tolist() == [True, True]
        assert npz["e/batch_slice"].tolist() == [4 * r, 4 * r + 4]
        assert npz["e/replicated"].tolist() == [1.0, 1.0, 1.0]
        assert npz["e/gather"].tolist() == [0.0, 1.0]
        # y = x0^2 + x1^2 = 5; dL/dx_r with L = sum over ranks of y
        assert npz["e/sum_and_grad"].tolist() == [5.0, 4.0 * (1 + r)]


def test_world_of_one_is_the_identity():
    """Without a group every helper is the identity and the mesh is one
    rank on the given device."""
    from dcfp_tpu_torch.parallel import distributed, mesh
    t = torch.arange(3.0)
    assert mesh.world() == 1 and mesh.rank() == 0
    assert mesh.all_reduce_(t) is t and mesh.sum_across(t) is t
    assert mesh.all_gather(t) is t
    m = distributed.create_pod_mesh(device="cpu")
    assert (m.n_data, m.n_spatial, m.rank, m.device.type) == (1, 1, 0, "cpu")
    assert distributed.process_batch_slice(8) == slice(0, 8)
    distributed.initialize(num_processes=1)  # a no-op
    assert mesh.world() == 1
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, device="cpu")


# ---------------------------------------------------------------------------
# (f) the train CLI across processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CS_scenes_2.msgpack", "score.msgpack"])
def test_cli_spawned_equals_distributed(runs, name):
    """``--num-devices 2`` (two gloo workers the CLI starts) and
    ``--distributed true`` in two processes write the same files, once
    (rank 0)."""
    with open(os.path.join(runs["cli_spawn"], name), "rb") as f:
        spawned = f.read()
    with open(os.path.join(runs["cli_dist"], name), "rb") as f:
        assert f.read() == spawned
    assert sorted(os.listdir(runs["cli_spawn"])) == sorted(
        ["CS_scenes_2.msgpack", "score.msgpack"])
    assert "starting 2 worker processes" in open(runs["logs"][2]).read()


@pytest.mark.parametrize("name,flags,exc", [
    ("train", ["--num-devices", "2", "--spatial-shards", "3"], SystemExit),
    ("train", ["--num-devices", "2", "--batch-size", "3"], SystemExit),
    ("train", ["--num-devices", "4", "--spatial-shards", "2",
               "--batch-size", "3"], SystemExit),
    ("evaluate", ["--eval-shard", "spatial", "--num-devices", "2",
                  "--spatial-shards", "3"], ValueError),
    ("evaluate", ["--eval-shard", "both", "--num-devices", "4",
                  "--spatial-shards", "3"], ValueError)])
def test_cli_refusals_before_writing(tmp_path, monkeypatch, name, flags,
                                     exc):
    """A spatial axis that does not divide the processes, and a global
    batch that does not divide over the data axis (the processes over
    the spatial axis), are refused, the train CLI's by its parser, each
    before any file is written or any process started."""
    monkeypatch.setenv("DCFP_PLATFORM", "cpu")
    out = tmp_path / "out"
    argv = {"train": CLI_TRAIN + ["--snapshot-dir", str(out)],
            "evaluate": ["--restore-from", str(tmp_path / "missing"),
                         "--result-file", str(out / "result.txt")]}[name]
    main = {"train": t_train.main, "evaluate": t_evaluate.main}[name]
    with pytest.raises(exc) as info:
        main(argv + flags)
    if exc is ValueError:
        assert "does not divide" in str(info.value)
    assert not out.exists()
