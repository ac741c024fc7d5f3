"""The port's entry points (``dcfp_tpu_torch/cli``) against the JAX
package's (``dcfp_tpu/cli``) on the CPU, on a tiny Cityscapes fixture
(72x96 frames, DeepLabV3-R50 at os 32 with a 64-wide stem, 48x48 crops,
one decode thread everywhere): the same flags give the same files.

One module-scope fixture runs both packages' recipe once: label_index;
the JAX pretrain (CE + EIC); prune of its snapshot by both; one finetune
step by both at os 8 (GSRL, balance 2, resample, EIC, no deepsup)
resumed from the JAX package's ``pruned.msgpack``, and the JAX one again
on the image x (1 + 2^-22); the port's own pretrain.  The
eval, deploy and submission tests run both packages on the JAX
package's finetuned snapshot.  The port runs with ``DCFP_PLATFORM=cpu``.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dcfp_tpu.cli import deploy as j_deploy
from dcfp_tpu.cli import evaluate as j_evaluate
from dcfp_tpu.cli import evaluate_test as j_evaluate_test
from dcfp_tpu.cli import label_index as j_label_index
from dcfp_tpu.cli import prune as j_prune
from dcfp_tpu.cli import train as j_train
from dcfp_tpu.data.synthetic import make_cityscapes_fixture
from dcfp_tpu.engine import trainer as j_trainer
from dcfp_tpu_torch.cli import deploy as t_deploy
from dcfp_tpu_torch.cli import evaluate as t_evaluate
from dcfp_tpu_torch.cli import evaluate_test as t_evaluate_test
from dcfp_tpu_torch.cli import label_index as t_label_index
from dcfp_tpu_torch.cli import prune as t_prune
from dcfp_tpu_torch.cli import train as t_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BP = '{"os": 32, "mg_unit": [1, 1, 1], "inplanes": 64}'
MODEL = ["--dataset", "CS", "--model", "deeplabv3", "--backbone",
         "resnet50", "--backbone-para", BP, "--align-corner", "true"]
TRAIN = ["--input-size", "48,48", "--batch-size", "2", "--num-workers",
         "1", "--log-every", "1", "--random-seed", "42", "--random-mirror",
         "--random-brightness", "--random-scale"]
JAX_ONE_DEVICE = ["--num-devices", "1"]
FT_MODEL = [BP.replace('"os": 32, "mg_unit": [1, 1, 1]',
                       '"os": 8, "mg_unit": [1, 2, 4]') if a == BP else a
            for a in MODEL]
_EXPAND_BATCH = j_trainer.expand_batch


def _scaled_image(*args, **kwargs):
    """The JAX train step's batch expansion, the image then x (1 + 2^-22)."""
    img, labels = _EXPAND_BATCH(*args, **kwargs)
    return img * (1 + 2.0 ** -22), labels
PADDED = "73,97"  # pad_inf of the 72x96 frames (align_corner)

CLIS = {"label_index": (j_label_index, t_label_index),
        "train": (j_train, t_train), "prune": (j_prune, t_prune),
        "evaluate": (j_evaluate, t_evaluate),
        "evaluate_test": (j_evaluate_test, t_evaluate_test),
        "deploy": (j_deploy, t_deploy)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' recipe, once; returns the paths."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "cs")
    train_lst = make_cityscapes_fixture(root, n_images=4, hw=(72, 96),
                                        split="train")
    val_lst = make_cityscapes_fixture(root, n_images=2, hw=(72, 96),
                                      split="val", seed=1)
    test_lst = make_cityscapes_fixture(root, n_images=2, hw=(72, 96),
                                       split="test", seed=2)
    with open(test_lst, "w") as f:  # the test list has image paths only
        f.write("".join(f"leftImg8bit/test/img_{i:04d}.png\n"
                        for i in range(2)))
    # the JAX package reads DCFP_PLATFORM when its cli package is
    # imported (above); the port reads it when a CLI runs
    for k, v in dict(DCFP_CS_ROOT=root, DCFP_CS_TRAIN_LIST=train_lst,
                     DCFP_CS_VAL_LIST=val_lst, DCFP_CS_TEST_LIST=test_lst,
                     DCFP_PLATFORM="cpu").items():
        mp.setenv(k, v)
    d = {k: str(tmp / k) for k in (
        "t_index", "j_pre", "t_pre", "j_prune", "t_prune")}
    os.makedirs(d["t_index"])
    try:
        assert j_label_index.main(["--dataset", "CS",
                                   "--save-dir", root]) == 0
        assert t_label_index.main(["--dataset", "CS",
                                   "--save-dir", d["t_index"]]) == 0
        pre = ["--num-steps", "2", "--save-pred-every", "2",
               "--loss-type", "ce", "--loss-para", '{"ds_weight":0.4}',
               "--deepsup", "true", "--prune-type", "dcfp"]
        assert j_train.main(MODEL + TRAIN + pre + JAX_ONE_DEVICE + [
            "--snapshot-dir", d["j_pre"]]) == 0
        assert t_train.main(MODEL + TRAIN + pre + [
            "--snapshot-dir", d["t_pre"]]) == 0
        snap = os.path.join(d["j_pre"], "CS_scenes_2.msgpack")
        prune = MODEL + ["--model-path", snap, "--score-path",
                         os.path.join(d["j_pre"], "score.msgpack"),
                         "--prune-ratio", "0.3",
                         "--flops-input-size", "48,48"]
        assert j_prune.main(prune + ["--save-path", d["j_prune"]]) == 0
        assert t_prune.main(prune + ["--save-path", d["t_prune"]]) == 0
        cfg = os.path.join(d["j_prune"], "channel_cfg.msgpack")
        ft = ["--num-steps", "1", "--save-pred-every", "1",
              "--loss-type", "gsrl", "--balance", "2", "--resample", "true",
              "--deepsup", "false", "--prune-type", "dcfp", "--warmup", "1",
              "--channel-cfg", cfg, "--resume",
              os.path.join(d["j_prune"], "pruned.msgpack")]
        # the step at os 8 (6x6 last maps at 48^2 crops; os 32 leaves
        # 2x2, whose BNs amplify rounding order far beyond the image
        # scaling below), on the same params; then the reference's
        # self-noise: its same step on the image x (1 + 2^-22), as in
        # tests/test_torch_train.py
        for key, mod, extra in (
                ("j_ft", j_train, JAX_ONE_DEVICE),
                ("t_ft", t_train, []),
                ("j_ft_noise", j_train, JAX_ONE_DEVICE)):
            out = d[key] = str(tmp / key)
            if key == "j_ft_noise":
                mp.setattr(j_trainer, "expand_batch", _scaled_image)
            assert mod.main(FT_MODEL + TRAIN + ft + extra + [
                "--snapshot-dir", out, "--metrics-file",
                os.path.join(out, "metrics.jsonl")]) == 0
        mp.setattr(j_trainer, "expand_batch", _EXPAND_BATCH)
        yield dict(d, root=root, cfg=cfg, snap=snap, tmp=str(tmp),
                   ft=os.path.join(d["j_ft"], "CS_scenes_1.msgpack"))
    finally:
        mp.undo()


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------

def _options(parser):
    return {opt: (a.default, tuple(a.choices) if a.choices else None,
                  a.required, a.nargs, type(a).__name__)
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)
            for opt in a.option_strings}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_flag_parity(name):
    """Each port parser has its JAX counterpart's option strings, with
    the same defaults, choices, arity and action."""
    jmod, tmod = CLIS[name]
    assert _options(tmod.get_parser()) == _options(jmod.get_parser())


# ---------------------------------------------------------------------------
# label_index, prune, train
# ---------------------------------------------------------------------------

def test_label_index_pickle_byte_equal(runs):
    name = "label_index_CS.pkl"
    assert _read(os.path.join(runs["t_index"], name)) == _read(
        os.path.join(runs["root"], name))


@pytest.mark.parametrize("name", ["channel_cfg.msgpack", "pruned.msgpack"])
def test_prune_artifacts_byte_equal(runs, name):
    """From one JAX-written snapshot and score, the port's prune writes
    the JAX package's files."""
    assert _read(os.path.join(runs["t_prune"], name)) == _read(
        os.path.join(runs["j_prune"], name))


@pytest.mark.parametrize("trace", ["jaxpr", "verify"])
def test_prune_forward_trace_raises_before_writing(runs, tmp_path, trace):
    """``--trace jaxpr`` (the topology of the port's traced forward) and
    ``--trace verify`` (that topology checked against the IR's) write the
    files the JAX package's prune writes with the IR topology, byte for
    byte."""
    out = tmp_path / "prune"
    assert t_prune.main(MODEL + [
        "--model-path", runs["snap"], "--score-path",
        os.path.join(runs["j_pre"], "score.msgpack"), "--prune-ratio",
        "0.3", "--flops-input-size", "48,48", "--trace", trace,
        "--save-path", str(out)]) == 0
    for name in ("channel_cfg.msgpack", "pruned.msgpack"):
        assert _read(out / name) == _read(
            os.path.join(runs["j_prune"], name)), name


def test_train_step_loss_and_eic(runs):
    """One finetune step resumed from the JAX package's pruned.msgpack,
    no deepsup (so no dropout), at os 8: the loss at rtol 1e-4; the EIC
    under tests/test_torch_train.py's rule: within 2x the reference's
    self-noise (relative L2; its same step on the image x (1 + 2^-22)),
    a channel flipped between zero and non-zero only where its score is
    <= 0.05 x max."""
    jm = _metrics(os.path.join(runs["j_ft"], "metrics.jsonl"))
    tm = _metrics(os.path.join(runs["t_ft"], "metrics.jsonl"))
    assert len(jm) == len(tm) == 1
    np.testing.assert_allclose(tm[0]["loss"], jm[0]["loss"], rtol=1e-4)
    from dcfp_tpu.utils import checkpoint as jck

    def eic(key):
        scores = jck.load_eic(os.path.join(runs[key], "score.msgpack"))
        return np.concatenate([scores[k].ravel() for k in sorted(scores)])

    got, want, noisy = eic("t_ft"), eic("j_ft"), eic("j_ft_noise")
    assert want.max() > 0

    def rel_l2(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    noise = rel_l2(noisy, want)
    assert 0 < noise and rel_l2(got, want) <= 2 * noise, (
        rel_l2(got, want), noise)
    flipped = (got > 0) != (want > 0)
    assert (np.maximum(got, want)[flipped] <= 0.05 * want.max()).all()


@pytest.mark.parametrize("stage", ["pretrain", "finetune"])
def test_port_snapshots_read_by_jax(runs, stage):
    """The port's snapshots and EIC scores have the JAX package's trees
    (paths, shapes, dtypes), and its loaders read them."""
    from dcfp_tpu.utils import checkpoint as jck
    step = {"pretrain": 2, "finetune": 1}[stage]
    d = {"pretrain": ("t_pre", "j_pre"), "finetune": ("t_ft", "j_ft")}[stage]
    got, want = (jck.load_pytree(os.path.join(runs[k],
                                              f"CS_scenes_{step}.msgpack"))
                 for k in d)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}{key}/").items()}
        return {prefix: (np.shape(tree), np.asarray(tree).dtype.str)}

    assert flat(got) == flat(want)
    assert int(got["step"]) == step
    p, s = jck.load_params_non_strict(
        os.path.join(runs[d[0]], f"CS_scenes_{step}.msgpack"),
        want["params"], want["bn_state"])
    assert all(np.array_equal(p[n][k], got["params"][n][k])
               for n in p for k in p[n])
    eic = jck.load_eic(os.path.join(runs[d[0]], "score.msgpack"))
    assert set(eic) == set(jck.load_eic(os.path.join(runs[d[1]],
                                                     "score.msgpack")))


# ---------------------------------------------------------------------------
# evaluate, evaluate_test
# ---------------------------------------------------------------------------

EVAL_MODES = {
    "whole_ss": ["--whole", "true", "--ms", "1"],
    "ms_flip": ["--whole", "true", "--ms", "0.75,1", "--flip", "true"],
    "sliding": ["--whole", "false", "--ms", "1"],
    "boundary": ["--whole", "true", "--ms", "1", "--iou-type", "boundary"],
}


def _eval_args(runs, result_file, model=MODEL):
    return model + ["--data-dir", "val", "--input-size", "48,48",
                    "--num-workers", "1", "--restore-from", runs["ft"],
                    "--channel-cfg", runs["cfg"], "--dtype", "float32",
                    "--result-file", result_file]


def _result_without_fps(path):
    text = open(path).read()
    return text[:text.rindex(" FPS:")]


@pytest.mark.parametrize("mode", sorted(EVAL_MODES))
def test_evaluate_metrics_equal(runs, tmp_path, mode):
    """f32: result.txt equals the JAX CLI's but for the FPS.

    Both evaluate the finetuned snapshot at the output stride it was
    finetuned at (os 8).  At os 32 its BN statistics meet 3x4 maps and
    logits near 1e4, where the reference's own labels move under its
    rounding: one pixel of the first val frame, 4634.665 against
    4634.663 for classes 13 and 7, takes class 7 when the JAX CLI's
    image is scaled by 1 + 2^-22 and in the port's f64 forward, and 13
    in the JAX CLI's f32 run; boundary IoU counts that pixel's boundary.
    At os 8 no single-scale label of either frame moves under +/- 2^-22
    in either package, and the port's f64 labels equal both."""
    out = {}
    for pkg, mod in (("j", j_evaluate), ("t", t_evaluate)):
        out[pkg] = str(tmp_path / f"{pkg}.txt")
        assert mod.main(_eval_args(runs, out[pkg], FT_MODEL)
                        + EVAL_MODES[mode]) == 0
    assert _result_without_fps(out["t"]) == _result_without_fps(out["j"])


def test_evaluate_test_pngs_byte_equal(runs, tmp_path):
    args = MODEL + ["--data-dir", "test", "--whole", "true", "--ms", "1",
                    "--num-workers", "1", "--restore-from", runs["ft"],
                    "--channel-cfg", runs["cfg"]]
    for pkg, mod in (("j", j_evaluate_test), ("t", t_evaluate_test)):
        assert mod.main(args + ["--output-dir", str(tmp_path / pkg)]) == 0
    for sub in ("raw", "color"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert len(names) == 2
        assert sorted(os.listdir(tmp_path / "t" / sub)) == names
        for n in names:
            assert _read(tmp_path / "t" / sub / n) == \
                _read(tmp_path / "j" / sub / n), (sub, n)


# ---------------------------------------------------------------------------
# deploy and the artifact
# ---------------------------------------------------------------------------

def _deploy_args(runs, save_dir, *extra):
    return MODEL + ["--restore-from", runs["ft"], "--channel-cfg",
                    runs["cfg"], "--save-dir", str(save_dir), "--warmup",
                    "1", "--iters", "1"] + list(extra)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deploy_params_byte_equal(runs, tmp_path, dtype):
    """deploy_params.msgpack equals the JAX CLI's byte for byte (its tree,
    HWIO kernels, the export dtype), and meta.json holds the same."""
    args = ("--input-size", PADDED, "--input-format", "nchw",
            "--deploy-form", "split", "--dtype", dtype)
    for pkg, mod in (("j", j_deploy), ("t", t_deploy)):
        assert mod.main(_deploy_args(runs, tmp_path / pkg, *args)) == 0
    assert _read(tmp_path / "t" / "deploy_params.msgpack") == \
        _read(tmp_path / "j" / "deploy_params.msgpack")
    assert json.load(open(tmp_path / "t" / "meta.json")) == \
        json.load(open(tmp_path / "j" / "meta.json"))
    assert (tmp_path / "t" / "model.pt2").exists()
    assert (tmp_path / "t" / "model.pt2.tail").exists()


@pytest.fixture(scope="module")
def argmax_export(runs):
    """The port's split f32 argmax export at the padded eval size."""
    out = os.path.join(runs["tmp"], "export_argmax")
    assert t_deploy.main(_deploy_args(
        runs, out, "--input-size", PADDED, "--input-format", "nchw",
        "--deploy-form", "split", "--dtype", "float32")) == 0
    return out


def test_load_serialized_equals_body_and_tail(runs, argmax_export):
    """The loaded programs give the labels of the unexported body + K1
    tail on the same params, and the file's params are the folded ones."""
    from dcfp_tpu_torch.cli.common import init_params
    from dcfp_tpu_torch.engine.deploy import (load_deploy_params,
                                              load_serialized,
                                              make_split_inference_fn)
    from dcfp_tpu_torch.models.registry import build_model
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    from dcfp_tpu_torch.utils import checkpoint as ckpt
    graph = apply_channel_cfg(build_model(
        "deeplabv3", backbone="resnet50", backbone_para=json.loads(BP),
        num_classes=19, align_corner=True, deepsup=False).graph,
        ckpt.load_channel_cfg(runs["cfg"]))
    p, s = init_params(graph)
    p, s = ckpt.load_params_non_strict(runs["ft"], p, s, device="cpu")
    body, tail, dev = make_split_inference_fn(
        graph, p, s, dtype=torch.float32, output="argmax",
        input_format="nchw", device="cpu")
    aot = load_deploy_params(os.path.join(argmax_export,
                                          "deploy_params.msgpack"), "cpu")
    assert all(torch.equal(aot[n][k], dev[n][k]) for n in dev for k in dev[n])
    run = load_serialized(os.path.join(argmax_export, "model.pt2"))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, 73, 97)).astype(np.float32))
    want = tail(body(dev, x), (73, 97))
    got = run(aot, x)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert len(torch.unique(want)) > 1


def test_single_export_removes_stale_tail(runs, tmp_path):
    """A single-form export into a directory that holds a split export's
    ``model.pt2.tail`` removes it, so load_serialized cannot chain it."""
    args = ("--input-size", PADDED, "--input-format", "nchw", "--dtype",
            "float32")
    assert t_deploy.main(_deploy_args(runs, tmp_path, *args,
                                      "--deploy-form", "split")) == 0
    assert (tmp_path / "model.pt2.tail").exists()
    assert t_deploy.main(_deploy_args(runs, tmp_path, *args,
                                      "--deploy-form", "single")) == 0
    assert not (tmp_path / "model.pt2.tail").exists()
    assert json.load(open(tmp_path / "meta.json"))["form"] == "single"


@pytest.mark.parametrize("ms,extra", [
    ("0,1", []), ("-0.5,1", []), ("1,1.0", []), (",", []), ("a,1", []),
    ("1", ["--output", "argmax"]), ("1", ["--input-format", "nchw"]),
    ("1", ["--no-save-dir"])])
def test_deploy_ms_validation_messages(ms, extra):
    """--ms is validated before the model build, with the JAX CLI's
    messages."""
    base = ["--dataset", "CS", "--model", "simple", "--backbone",
            "resnet50", "--output", "logits", f"--ms={ms}"]
    if extra != ["--no-save-dir"]:
        base += ["--save-dir", "/nonexistent/ms_validation"] + extra
    msgs = []
    for mod in (j_deploy, t_deploy):
        with pytest.raises(SystemExit) as e:
            mod.main(list(base))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[0]


@pytest.mark.parametrize("mode", ["whole", "sliding", "scales"])
def test_evaluate_use_aot_equals_jit(runs, argmax_export, tmp_path, mode):
    """evaluate --use-aot serves the port's artifact in each mode (whole
    ss from the argmax export, sliding from a tile-shaped logits export,
    whole ms + flip from per-scale logits exports); f32 mIoU and every
    metric equal the jit path's."""
    eval_mode = {"whole": EVAL_MODES["whole_ss"],
                 "sliding": EVAL_MODES["sliding"],
                 "scales": EVAL_MODES["ms_flip"]}[mode]
    if mode == "whole":
        path = os.path.join(argmax_export, "model.pt2")
    else:
        out = tmp_path / "export"
        extra = (["--input-size", "48,48", "--output", "logits",
                  "--dtype", "float32"] if mode == "sliding" else
                 ["--input-size", PADDED, "--output", "logits",
                  "--dtype", "float32", "--ms", "0.75,1"])
        assert t_deploy.main(_deploy_args(runs, out, *extra)) == 0
        path = str(out / ("model.pt2" if mode == "sliding"
                          else "model_s1.0.pt2"))
    jit, aot = str(tmp_path / "jit.txt"), str(tmp_path / "aot.txt")
    assert t_evaluate.main(_eval_args(runs, jit) + eval_mode) == 0
    assert t_evaluate.main(_eval_args(runs, aot) + eval_mode + [
        "--use-aot", "true", "--aot-path", path]) == 0
    got, want = _result_without_fps(aot), _result_without_fps(jit)
    assert got == want and "meanIU" in got


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,flags", [
    ("train", ["--num-devices", "3"]), ("train", ["--spatial-shards", "2"]),
    ("train", ["--dcn-slices", "2"]), ("train", ["--distributed", "true"]),
    ("evaluate", ["--eval-shard", "spatial", "--spatial-shards", "2"]),
    ("evaluate", ["--distributed", "true"]),
    ("evaluate_test", ["--distributed", "true"])])
def test_mesh_and_distributed_flags_raise_before_writing(runs, tmp_path,
                                                         name, flags):
    """Flags the port refuses, before it writes a file or starts a
    process: 2 spatial shards over one process, a global batch of 2
    over 3 processes, a data axis of 1 over 2 slices, and
    ``--distributed true`` without a coordinator (multi-process runs
    themselves are tests/test_torch_parallel.py's and
    tests/test_torch_spatial.py's)."""
    out = tmp_path / "out"
    argv = {"train": MODEL + TRAIN + ["--snapshot-dir", str(out),
                                      "--num-steps", "1"],
            "evaluate": _eval_args(runs, str(out / "result.txt")),
            "evaluate_test": MODEL + ["--data-dir", "test",
                                      "--restore-from", runs["ft"],
                                      "--output-dir", str(out)]}[name]
    if name == "evaluate" and "--spatial-shards" in flags:
        with pytest.raises(ValueError, match="does not divide"):
            CLIS[name][1].main(argv + flags)
    elif "--num-devices" in flags or "--spatial-shards" in flags:
        with pytest.raises(SystemExit):  # the parser's error
            CLIS[name][1].main(argv + flags)
    else:
        with pytest.raises(ValueError, match="divisible|coordinator"):
            CLIS[name][1].main(argv + flags)
    assert not out.exists()


def test_cli_without_platform_needs_cuda(runs, tmp_path, monkeypatch):
    """Unset DCFP_PLATFORM means CUDA: on a host without it a CLI raises
    before it writes anything (no CPU fallback)."""
    monkeypatch.delenv("DCFP_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "snap"
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(MODEL + TRAIN + ["--snapshot-dir", str(out)])
    assert not out.exists()
    monkeypatch.setenv("DCFP_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="DCFP_PLATFORM"):
        t_train.main(MODEL + TRAIN + ["--snapshot-dir", str(out)])


# ---------------------------------------------------------------------------
# bf16 msgpack without ml_dtypes
# ---------------------------------------------------------------------------

def _bf16_tree():
    rng = np.random.default_rng(3)
    return {"a.conv": {"kernel": rng.standard_normal((3, 3, 4, 5)),
                       "bias": rng.standard_normal(5)},
            "b": {"scale": rng.standard_normal(7)}}


def test_bf16_msgpack_written_byte_equal(tmp_path):
    """A bf16 tree of the port's tensors is written as flax writes the
    JAX package's bf16 arrays: byte-equal files."""
    import jax.numpy as jnp
    from dcfp_tpu.utils import checkpoint as jck
    from dcfp_tpu_torch import bridge
    from dcfp_tpu_torch.engine.deploy import save_deploy_params
    tree = _bf16_tree()
    jck.save_pytree(str(tmp_path / "j.msgpack"),
                    {n: {k: jnp.asarray(v, jnp.bfloat16)
                         for k, v in d.items()} for n, d in tree.items()})
    p, _ = bridge.params_from_numpy(tree, {}, "cpu", torch.bfloat16)
    save_deploy_params(str(tmp_path / "t.msgpack"), p)
    assert _read(tmp_path / "t.msgpack") == _read(tmp_path / "j.msgpack")


def test_bf16_msgpack_read_without_ml_dtypes(tmp_path):
    """A JAX-written bf16 tree reads back bit-equal in a process where
    ``ml_dtypes`` cannot be imported: ``torch.bfloat16`` tensors, OIHW
    through the bridge."""
    import jax.numpy as jnp
    from dcfp_tpu.utils import checkpoint as jck
    tree = _bf16_tree()
    path = str(tmp_path / "j.msgpack")
    jck.save_pytree(path, {n: {k: jnp.asarray(v, jnp.bfloat16)
                               for k, v in d.items()}
                           for n, d in tree.items()})
    want = {f"{n}/{k}": np.asarray(jnp.asarray(v, jnp.bfloat16)).view(
        np.uint16).tolist() for n, d in tree.items() for k, v in d.items()}
    (tmp_path / "want.json").write_text(json.dumps(want))
    code = (
        "import sys, json\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from dcfp_tpu_torch.utils.checkpoint import load_pytree\n"
        "from dcfp_tpu_torch.engine.deploy import load_deploy_params\n"
        f"tree = load_pytree({path!r})\n"
        f"want = json.load(open({str(tmp_path / 'want.json')!r}))\n"
        "for key, words in want.items():\n"
        "    n, k = key.split('/')\n"
        "    t = tree[n][k]\n"
        "    assert t.dtype == torch.bfloat16, t.dtype\n"
        "    got = t.view(torch.int16).numpy().view('uint16').tolist()\n"
        "    assert got == words, key\n"
        f"p = load_deploy_params({path!r}, 'cpu')\n"
        "k = tree['a.conv']['kernel']\n"
        "assert torch.equal(p['a.conv']['kernel'].view(torch.int16),\n"
        "                   k.permute(3, 2, 0, 1).view(torch.int16))\n"
        "assert 'ml_dtypes' not in [m for m, v in sys.modules.items()\n"
        "                           if v is not None]\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]
