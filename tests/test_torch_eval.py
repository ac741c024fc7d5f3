"""The port's eval layer against the JAX package's, on the CPU: host
metrics and shapes, the device confusion update, the device boundary
transform, the Predictor's prediction modes, the protocol and pipelined
eval loops, result.txt, the served-callable hooks and the bucketing
bound, plus the port's profiling helpers.

Models: the pointwise and conv3 graphs of tests/test_evaluator.py and a
narrow DeepLabV3 (strided stem, dilated trunk, two ASPP branches with
an image pool, a to-input align-corner resize, so the label path runs
the resize-argmax tail).  Params are made with numpy from a seed and
carried across with ``bridge.params_from_numpy``; JAX runs its own way
(jitted forwards, its Pallas tail in interpret mode on the CPU).  No
test here starts a process or a loader worker."""

import re

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax
import jax.numpy as jnp

from dcfp_tpu.engine import evaluator as jev
from dcfp_tpu.graph.ir import GraphBuilder as JBuilder
from dcfp_tpu.utils import edge as jedge
from dcfp_tpu_torch.bridge import params_from_numpy
from dcfp_tpu_torch.data.base import normalize_f32
from dcfp_tpu_torch.engine import deploy as tdeploy
from dcfp_tpu_torch.engine import evaluator as tev
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.utils import edge as tedge
from dcfp_tpu_torch.utils import profiling

from test_torch_deploy import assert_labels_match, np_params

C = 6
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def pointwise_model(B):
    b = B("pw")
    x = b.input("image")
    x = b.conv(x, "c1", out_ch=8, kernel=1, padding=0)
    x = b.bn(x, "n1")
    x = b.relu(x, "r1")
    pred = b.conv(x, "pred", out_ch=C, kernel=1, padding=0, bias=True)
    return b.finish([pred])


def conv3_model(B):
    b = B("c3")
    x = b.input("image")
    x = b.conv(x, "c1", out_ch=8, kernel=3)
    x = b.bn(x, "n1")
    x = b.relu(x, "r1")
    pred = b.conv(x, "pred", out_ch=C, kernel=3, bias=True)
    return b.finish([pred])


def narrow_deeplab(B):
    b = B("dl")
    x = b.input("image")
    x = b.conv_bn_relu(x, "stem", out_ch=8, kernel=3, stride=2)
    x = b.conv_bn_relu(x, "layer1", out_ch=12, kernel=3, stride=2)
    x = b.conv_bn_relu(x, "layer2", out_ch=12, kernel=3, dilation=2)
    a0 = b.conv_bn_relu(x, "aspp.0", out_ch=8, kernel=1, padding=0)
    a1 = b.conv_bn_relu(x, "aspp.1", out_ch=8, kernel=3, dilation=3)
    gp = b.globalpool(x, "aspp.pool")
    gp = b.conv(gp, "aspp.pool_conv", out_ch=8, kernel=1, padding=0)
    gp = b.resize(gp, "aspp.pool_up", like=a0, align_corners=True)
    y = b.concat([a0, a1, gp], "aspp.cat")
    y = b.conv_bn_relu(y, "proj", out_ch=8, kernel=1, padding=0)
    z = b.conv(y, "cls", out_ch=C, kernel=1, padding=0, bias=True)
    b.resize(z, "pred", to_input=True, align_corners=True)
    return b.finish(["pred"])


MODELS = {"pointwise": pointwise_model, "conv3": conv3_model,
          "deeplab": narrow_deeplab}


class Pair:
    """One model in both packages from the same numpy params."""

    def __init__(self, name, seed=0, **kw):
        self.jg, self.tg = MODELS[name](JBuilder), MODELS[name](TBuilder)
        self.params, self.state = np_params(self.jg, seed)
        if name == "deeplab":
            # kaiming-uniform convs shrink the signal ~6x a conv + ReLU, so
            # the BN shifts and the classifier's bias would give every
            # pixel one class; kernels scaled to keep it, bias zeroed
            for p in self.params.values():
                if "kernel" in p:
                    p["kernel"] *= np.float32(2.5)
            self.params["cls"]["bias"][:] = 0.0
        self.tp, self.ts = params_from_numpy(self.params, self.state,
                                             device="cpu")
        self.kw = kw

    def jax(self, **kw):
        return jev.Predictor(self.jg, jax.tree.map(jnp.asarray, self.params),
                             jax.tree.map(jnp.asarray, self.state),
                             **{**self.kw, **kw})

    def port(self, **kw):
        return tev.Predictor(self.tg, self.tp, self.ts, device="cpu",
                             **{**self.kw, **kw})


@pytest.fixture(scope="module")
def preds():
    """Predictors shared across tests (normalize set for compact items)."""
    out = {}
    for name in MODELS:
        pair = Pair(name, normalize=(MEAN, STD))
        out[name] = (pair, pair.jax(), pair.port())
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# host metrics, shapes, the device confusion update, boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [5, 19])
def test_confusion_matrix_matches_jax(num_classes):
    """Random labels, then the boundary-IoU shape of input (pred holds
    the ignore label where gt is a boundary): idx past C*C is dropped or
    aliased into unrelated cells, identically."""
    r = np.random.default_rng(num_classes)
    gt = r.integers(0, num_classes, 2000)
    pred = r.integers(0, num_classes, 2000)
    np.testing.assert_array_equal(
        tev.confusion_matrix(gt, pred, num_classes),
        jev.confusion_matrix(gt, pred, num_classes))
    pred[r.random(2000) < 0.3] = 255
    gt[r.random(2000) < 0.2] = 255
    keep = gt != 255
    assert (gt[keep] * num_classes + pred[keep] >= num_classes ** 2).any()
    got = tev.confusion_matrix(gt, pred, num_classes)
    np.testing.assert_array_equal(
        got, jev.confusion_matrix(gt, pred, num_classes))
    assert got.dtype == np.float64


def test_metrics_pad_bucket_match_jax():
    r = np.random.default_rng(3)
    cm = r.integers(0, 50, (7, 7)).astype(np.float64)
    cm[2] = 0  # a class never in gt
    got, want = tev.metrics_from_confusion(cm), jev.metrics_from_confusion(cm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for hw in [(1024, 2048), (1025, 2049), (769, 769), (33, 45), (1, 2)]:
        assert tev.pad_inf(hw) == jev.pad_inf(hw)
        assert tev.pad_inf(hw, 16) == jev.pad_inf(hw, 16)
    for hw in [(100, 130), (128, 128), (129, 129), (31, 77), (200, 111)]:
        for q in (0, 1, 32, 64):
            for ac in (False, True):
                assert tev.bucket_hw(hw, q, ac) == jev.bucket_hw(hw, q, ac)


def test_confusion_update_device_matches_jax():
    """Ignore pixels and non-ignore gt >= C (an index past the bins,
    dropped by both) over three accumulated updates; a negative gt is
    where the two part: the JAX scatter clips it to bin 0, the port
    sends it to the trash bin (ROADMAP.md §3)."""
    r = np.random.default_rng(4)
    cm_j = jnp.zeros((C, C), jnp.int32)
    cm_t = torch.zeros((C, C), dtype=torch.int32)
    for i in range(3):
        pred = r.integers(0, C, (2, 17, 23)).astype(np.uint8)
        gt = r.integers(0, C, (2, 17, 23)).astype(np.int32)
        gt[r.random(gt.shape) < 0.2] = 255
        gt[r.random(gt.shape) < 0.1] = C + 7 + i
        cm_j = jev.confusion_update_device(cm_j, jnp.asarray(pred),
                                           jnp.asarray(gt), num_classes=C)
        cm_t = tev.confusion_update_device(cm_t, torch.from_numpy(pred),
                                           torch.from_numpy(gt),
                                           num_classes=C)
    assert cm_t.dtype == torch.int32
    np.testing.assert_array_equal(cm_t.numpy(), np.asarray(cm_j))
    valid = 3 * 2 * 17 * 23
    assert 0 < int(cm_t.sum()) < valid
    neg = torch.full((1, 4), -1, dtype=torch.int32)
    zero = torch.zeros((1, 4), dtype=torch.uint8)
    assert int(tev.confusion_update_device(
        torch.zeros((C, C), dtype=torch.int32), zero, neg,
        num_classes=C).sum()) == 0
    assert int(np.asarray(jev.confusion_update_device(
        jnp.zeros((C, C), jnp.int32), jnp.asarray(zero.numpy()),
        jnp.asarray(neg.numpy()), num_classes=C))[0, 0]) == 4


@pytest.mark.parametrize("ratio", [0.01, 0.02, 0.05])
def test_mask_to_boundary_device_matches_jax(ratio):
    """Shapes off the 128 bucket, ignore regions, a solid block, an
    all-ignore image; against the JAX device path and its host cv2 path."""
    r = np.random.default_rng(int(ratio * 100))
    for shape in [(3, 47, 61), (2, 130, 257)]:
        masks = r.integers(0, C, shape).astype(np.int64)
        masks[r.random(shape) < 0.15] = 255
        masks[0, 10:30, 10:40] = 2
        masks[-1] = 255
        got = tedge.mask_to_boundary_device(masks, C, ratio, device="cpu")
        assert got.dtype == np.int32 and got.shape == shape
        np.testing.assert_array_equal(
            got, jedge.mask_to_boundary_device(masks, C, ratio))
        np.testing.assert_array_equal(
            got[0], jedge.mask_to_boundary(masks[0].copy(), C, ratio))


# The JAX CLI's labels of the first val frame in tests/test_torch_cli.py's
# boundary case when it evaluated at os 32 (72 x 96, raster order, class x
# run length).  The port's labels differ at FLIP_PIXEL alone: 7 there (as
# the port's f64 forward and the JAX CLI on the image x (1 + 2^-22) give),
# 13 in the JAX CLI's f32 run, from logits 4634.663 against 4634.665.
FLIP_PRED = """
    7x32 6x64 7x33 6x63 7x33 6x63 7x34 6x62 7x34 6x62 7x35 6x58 13x3
    7x35 6x53 13x8 7x35 6x49 13x12 7x36 6x44 13x16 7x36 6x41 13x19
    7x37 6x37 13x22 7x37 6x34 13x25 7x37 13x1 6x30 13x28 7x38 13x11
    6x17 13x30 7x38 13x58 7x38 13x58 7x38 13x58 7x38 13x58 7x38 13x58
    7x38 13x58 7x39 13x57 7x39 13x57 7x39 13x57 7x39 13x57 7x39 13x57
    7x39 13x57 7x39 13x57 7x39 13x57 7x40 13x56 7x40 13x56 7x40 13x56
    7x40 13x56 7x40 13x56 7x40 13x56 7x40 13x56 7x40 13x56 7x40 13x56
    7x41 13x55 7x42 13x54 7x43 13x53 7x44 13x52 7x45 13x51 7x46 13x50
    7x47 13x49 7x48 13x48 7x49 13x47 7x50 13x46 7x51 13x45 7x52 13x44
    7x53 13x43 7x54 13x42 7x55 13x41 7x56 13x40 7x56 13x40 7x57 13x39
    7x58 13x38 7x59 13x37 7x60 13x36 7x61 13x35 7x62 13x34 7x63 13x33
    7x63 13x33 7x64 13x32 7x65 13x31 7x66 13x30 7x66 13x30 7x67 13x29
    7x68 13x28 7x68 13x28 7x69 13x27 7x69 10x1 13x26 7x67 10x6 13x23
"""
FLIP_PIXEL = (65, 66)


def _decode_runs(text, shape):
    vals, lens = zip(*(map(int, t.split("x")) for t in text.split()))
    return np.repeat(vals, lens).reshape(shape).astype(np.int64)


def test_boundary_of_one_pixel_flip_matches_jax(tmp_path):
    """The boundary-IoU inputs on which the two CLIs' results differed at
    os 32: the port's device and host boundary transforms equal the JAX
    package's on the gt and on both packages' labels, and so do the
    confusions; the results differ only through the flipped label pixel
    (3 boundary pixels), not in the boundary transform."""
    from dcfp_tpu_torch.data.datasets import build_dataset
    from dcfp_tpu_torch.data.synthetic import make_cityscapes_fixture
    lst = make_cityscapes_fixture(str(tmp_path), n_images=2, hw=(72, 96),
                                  split="val", seed=1)
    gt = np.asarray(build_dataset("CS", str(tmp_path), lst,
                                  split="val")[0]["label"], np.int64)
    jpred = _decode_runs(FLIP_PRED, gt.shape)
    tpred = jpred.copy()
    assert tpred[FLIP_PIXEL] == 13
    tpred[FLIP_PIXEL] = 7
    bounds = []
    for pred in (jpred, tpred):
        masks = np.stack([pred, gt])
        got = tedge.mask_to_boundary_device(masks, 19, 0.02, 255,
                                            device="cpu")
        np.testing.assert_array_equal(
            got, jedge.mask_to_boundary_device(masks, 19, 0.02, 255))
        for m, b in zip(masks, got):
            np.testing.assert_array_equal(
                tedge.mask_to_boundary(m.copy(), 19, 0.02, 255), b)
            np.testing.assert_array_equal(
                jedge.mask_to_boundary(m.copy(), 19, 0.02, 255), b)
        b = got.astype(np.int64)
        np.testing.assert_array_equal(
            tev.confusion_matrix(b[1:], b[:1], 19),
            jev.confusion_matrix(b[1:], b[:1], 19))
        bounds.append(b)
    np.testing.assert_array_equal(bounds[0][1], bounds[1][1])
    assert int((bounds[0][0] != bounds[1][0]).sum()) == 3


def test_onehot_helpers_match_jax():
    r = np.random.default_rng(5)
    mask = r.integers(0, C, (9, 11))
    mask[r.random((9, 11)) < 0.2] = 255
    oh = tedge.mask_to_onehot(mask, C)
    np.testing.assert_array_equal(oh, jedge.mask_to_onehot(mask, C))
    np.testing.assert_array_equal(tedge.onehot_to_mask(oh),
                                  jedge.onehot_to_mask(oh))


def test_normalize_f32_tensor_bit_equal_to_numpy():
    raw = np.random.default_rng(6).integers(0, 256, (2, 7, 9, 3))
    mean, std = np.float32(MEAN), np.float32(STD)
    want = normalize_f32(raw.astype(np.float32), mean, std)
    got = normalize_f32(torch.from_numpy(raw).float(),
                        torch.from_numpy(mean), torch.from_numpy(std))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the Predictor's modes
# ---------------------------------------------------------------------------

def _image(seed, hw=(33, 45), n=1):
    return np.random.default_rng(seed).standard_normal(
        (n, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("model", list(MODELS))
def test_predict_whole_and_sliding_match_jax(preds, model):
    _, jp, tp = preds[model]
    img = _image(10, (37, 53), n=2)
    got = tp.predict_whole(img)
    assert got.dtype == torch.float32 and got.shape == (2, 37, 53, C)
    np.testing.assert_allclose(got.numpy(), _np(jp.predict_whole(img)),
                               rtol=1e-5, atol=1e-6)
    got = tp.predict_sliding(img, (24, 24), C)
    np.testing.assert_allclose(got.numpy(),
                               _np(jp.predict_sliding(img, (24, 24), C)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("whole", [True, False])
@pytest.mark.parametrize("model", ["conv3", "deeplab"])
def test_predict_multiscale_probs_match_jax(preds, model, whole):
    _, jp, tp = preds[model]
    img = _image(11, (40, 48))
    kw = dict(scales=(0.75, 1.0), num_classes=C, flip=True,
              align_corner=True, whole=whole, return_probs=True)
    got = tp.predict_multiscale(img, (24, 24), **kw)
    np.testing.assert_allclose(got.numpy(),
                               _np(jp.predict_multiscale(img, (24, 24), **kw)),
                               rtol=1e-5, atol=1e-6)
    labels = tp.predict_multiscale(img, (24, 24), **{**kw,
                                                     "return_probs": False})
    assert labels.dtype == torch.uint8
    np.testing.assert_array_equal(labels.numpy(),
                                  torch.argmax(got, -1).numpy())


@pytest.mark.parametrize("model", list(MODELS))
def test_predict_whole_labels_match_jax(preds, model):
    """The deploy label path (BN folded; the deeplab's resize-argmax tail
    through K1's plain version here) against JAX's, under the near-tie
    rule on JAX's raw-graph logits."""
    _, jp, tp = preds[model]
    img = _image(12, (41, 57))
    got = tp.predict_whole_labels(img)
    assert got.dtype == torch.uint8 and got.shape == (1, 41, 57)
    assert_labels_match(got.numpy(), _np(jp.predict_whole_labels(img)),
                        _np(jp.predict_whole(img)))


def test_predict_whole_labels_bf16_agree():
    pair = Pair("deeplab", seed=1)
    img = _image(13, (65, 65), n=2)
    got = pair.port(dtype=torch.bfloat16).predict_whole_labels(img).numpy()
    want = _np(pair.jax(dtype=jnp.bfloat16).predict_whole_labels(img))
    assert (got == want).mean() >= 0.98


# ---------------------------------------------------------------------------
# the eval loops
# ---------------------------------------------------------------------------

MODES = {
    "ss": dict(whole=True),
    "ms_flip": dict(whole=True, scales=(0.75, 1.0), flip=True),
    "sliding": dict(whole=False, tile_size=(24, 24)),
    "boundary": dict(whole=True, iou_type="boundary"),
    "longsize": dict(whole=True, longsize=40),
    "compact": dict(whole=True),
}
N_IMAGES = 3


def _items(compact):
    """Three 33x45 items with ~10% ignored pixels; compact items are the
    raw uint8 image and uint8 labels, classic ones the host-normalized
    image."""
    r = np.random.default_rng(20)
    items = []
    for i in range(N_IMAGES):
        raw = r.integers(0, 256, (1, 33, 45, 3)).astype(np.uint8)
        label = r.integers(0, C, (1, 33, 45))
        label[r.random(label.shape) < 0.1] = 255
        img = normalize_f32(raw.astype(np.float32), np.float32(MEAN),
                            np.float32(STD))
        items.append({"img": raw if compact else img,
                      "label": label.astype(np.uint8) if compact else label,
                      "img_meta": [{"name": f"im{i}"}]})
    return items


def _near_ties(jp, items, mode):
    """Pixels whose label may flip between two correct f32 runs: JAX's
    reference logits of the mode have a top-2 margin <= 1e-4 x max|logit|
    (boundary mode: any pixel within the erosion's reach of one)."""
    kw = {"scales": (1.0,), "flip": False, "tile_size": (769, 769),
          **MODES[mode]}
    total = 0
    for item in _items(False):
        image = item["img"]
        orig = image.shape[1:3]
        if mode == "longsize":
            f = kw["longsize"] / max(orig)
            image = np.asarray(jev.resize_bilinear(
                jnp.asarray(image), (int(orig[0] * f + 0.5),
                                     int(orig[1] * f + 0.5))))
        hw = image.shape[1:3]
        if kw["whole"]:
            ph, pw = jev.pad_inf(hw)
            image = np.pad(image, ((0, 0), (0, ph - hw[0]),
                                   (0, pw - hw[1]), (0, 0)))
        logits = _np(jp.predict_multiscale(
            image, kw["tile_size"], kw["scales"], C, kw["flip"], True,
            kw["whole"], return_probs=True))[:, :hw[0], :hw[1]]
        if mode == "longsize":
            logits = np.asarray(jev.resize_bilinear(jnp.asarray(logits),
                                                    orig))
        top2 = np.sort(logits, -1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) <= 1e-4 * np.abs(logits).max()
        if mode == "boundary":
            d = max(int(round(0.02 * np.hypot(*orig))), 1)
            tie = scipy.ndimage.binary_dilation(
                tie[0], np.ones((2 * d + 1, 2 * d + 1)))[None]
        total += int(tie.sum())
    return total


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", ["pointwise", "deeplab"])
def test_evaluate_matches_jax(preds, model, mode):
    """Protocol and pipelined loops of both packages on the same items.
    The port's pipelined loop is bit-identical to its protocol loop; the
    confusion equals JAX's on the pointwise model, and on the DeepLabV3
    moves by at most 2 counts per near-tie pixel."""
    _, jp, tp = preds[model]
    compact = mode == "compact"
    kw = dict(num_classes=C, align_corner=True, fps_warmup=1,
              **MODES[mode])
    want = jev.evaluate(jp, _items(compact), **kw)
    got = tev.evaluate(tp, _items(compact), **kw)
    got_pipe = tev.evaluate(tp, _items(compact), pipeline=True, **kw)
    np.testing.assert_array_equal(got_pipe["confusion"], got["confusion"])
    assert got_pipe["meanIU"] == got["meanIU"]
    assert got["fps"] > 0 and got_pipe["fps"] > 0
    assert got["confusion"].sum() == want["confusion"].sum() > 0
    if model == "pointwise":
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
        assert got["meanIU"] == want["meanIU"]
    else:
        moved = np.abs(got["confusion"] - want["confusion"]).sum()
        assert moved <= 2 * _near_ties(jp, _items(False), mode)
    if compact:  # the f32 items of the same pixels give the same counts
        np.testing.assert_array_equal(
            tev.evaluate(tp, _items(False), **kw)["confusion"],
            got["confusion"])


def test_compact_items_need_normalize():
    pair = Pair("pointwise")
    with pytest.raises(ValueError, match="normalize"):
        tev.evaluate(pair.port(), _items(True), num_classes=C)
    with pytest.raises(ValueError, match="normalize"):
        tev.evaluate(pair.port(), _items(True), num_classes=C, pipeline=True)


def test_result_txt_and_saved_predictions_match_jax(preds, tmp_path):
    """result.txt byte for byte apart from the FPS value; the saved label
    PNGs decode to the same maps."""
    _, jp, tp = preds["pointwise"]
    kw = dict(num_classes=C, align_corner=True, fps_warmup=1,
              result_tag="unit", cmap=np.arange(3 * C).reshape(C, 3))
    jev.evaluate(jp, _items(False), result_file=str(tmp_path / "j.txt"),
                 save_predict_dir=str(tmp_path / "j"), **kw)
    tev.evaluate(tp, _items(False), result_file=str(tmp_path / "t.txt"),
                 save_predict_dir=str(tmp_path / "t"), **kw)
    fps = re.compile(r"FPS: [0-9.]+ img / s")
    j, t = ((tmp_path / f).read_text() for f in ("j.txt", "t.txt"))
    assert "meanIU" in t and fps.search(t)
    assert fps.sub("FPS", t) == fps.sub("FPS", j)
    from PIL import Image
    for i in range(N_IMAGES):
        got = Image.open(tmp_path / "t" / f"im{i}.png")
        want = Image.open(tmp_path / "j" / f"im{i}.png")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert got.getpalette() == want.getpalette()


def test_bucketing_bounds_shapes_same_miou():
    """tests/test_evaluator.py's bucketing case: a variable-size val set
    under bucket_quantum runs at a bounded shape set (num_compiles equal
    to JAX's program count), with the per-shape confusion unchanged."""
    pair = Pair("conv3")
    sizes = [(41, 53), (47, 61), (52, 44), (63, 33), (37, 58),
             (59, 47), (45, 45), (50, 62)]

    def loader():
        r = np.random.default_rng(1)
        for h, w in sizes:
            lab = r.integers(0, C, (1, h, w))
            lab[:, -4:, :] = 255  # ignore margin >= receptive field
            lab[:, :, -4:] = 255
            yield {"img": r.standard_normal((1, h, w, 3), dtype=np.float32),
                   "label": lab}

    runs = {}
    for q in (0, 32):
        jp, tp = pair.jax(bucket_quantum=q), pair.port(bucket_quantum=q)
        want = jev.evaluate(jp, loader(), num_classes=C, fps_warmup=0)
        got = tev.evaluate(tp, loader(), num_classes=C, fps_warmup=0)
        assert tp.num_compiles() == jp.num_compiles()
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
        runs[q] = (tp.num_compiles(), got["confusion"])
    assert runs[0][0] == len(set(sizes)) and runs[32][0] <= 2
    np.testing.assert_array_equal(runs[32][1], runs[0][1])


def test_served_callable_hooks():
    """use_aot_whole / use_aot_tiles / use_aot_scales with the port's own
    inference functions as ``run``: the same answers as the Predictor's
    own paths."""
    pair = Pair("deeplab")
    img = _image(14, (33, 41))
    base = pair.port()
    fn, fp = tdeploy.make_inference_fn(pair.tg, pair.tp, pair.ts,
                                       dtype=torch.float32, output="argmax",
                                       device="cpu")
    p = pair.port()
    p.use_aot_whole(fn, fp)
    np.testing.assert_array_equal(
        p.predict_whole_labels(img).numpy(),
        base.predict_whole_labels(img).numpy())
    with pytest.raises(RuntimeError, match="logits forward"):
        p.predict_multiscale(img, (24, 24), (1.0,), C, False, True, True)

    lfn, lp = tdeploy.make_inference_fn(pair.tg, pair.tp, pair.ts,
                                        dtype=torch.float32,
                                        output="logits", device="cpu")
    p = pair.port()
    p.use_aot_tiles(lfn, lp)
    np.testing.assert_allclose(
        p.predict_sliding(img, (24, 24), C).numpy(),
        base.predict_sliding(img, (24, 24), C).numpy(), rtol=1e-5,
        atol=1e-5)
    assert p.num_compiles() == 1  # the one ("aot", ...) sliding shape

    kw = dict(scales=(0.75, 1.0), num_classes=C, flip=True,
              align_corner=True, whole=True, return_probs=True)
    p = pair.port()
    p.use_aot_scales({(24, 30): lfn, (33, 41): lfn}, lp)
    np.testing.assert_allclose(
        p.predict_multiscale(img, (24, 24), **kw).numpy(),
        base.predict_multiscale(img, (24, 24), **kw).numpy(), rtol=1e-5,
        atol=1e-5)
    labels = p.predict_whole_labels(img)
    assert labels.dtype == torch.uint8 and labels.shape == (1, 33, 41)
    with pytest.raises(ValueError, match="no serialized executable"):
        p.predict_multiscale(img, (24, 24), **{**kw, "scales": (0.5,)})


def test_not_ported_parts_raise(monkeypatch):
    """On a mesh of one rank every shard is the rank's own Predictor on
    the mesh's device, counting its images (the spatial one's forward is
    the plain one, its axis of one rank splitting nothing), and an
    unknown shard raises; the confusion reduce is the identity in one
    process and an exact int64 sum across processes.  Spatial groups of
    more ranks are tests/test_torch_spatial.py's."""
    from dcfp_tpu_torch.parallel.mesh import create_mesh
    pair = Pair("pointwise")
    mesh = create_mesh(device="cpu")
    img = np.random.default_rng(0).standard_normal(
        (1, 9, 11, 3)).astype(np.float32)
    want = pair.port().predict_whole(img).numpy()
    for shard in ("data", "spatial", "both"):
        pred = tev.Predictor(pair.tg, pair.tp, pair.ts, mesh=mesh,
                             shard=shard)
        assert pred.device == torch.device("cpu") and pred.counts
        assert pred.spatial is None
        np.testing.assert_array_equal(pred.predict_whole(img).numpy(), want)
    with pytest.raises(ValueError, match="shard"):
        tev.Predictor(pair.tg, pair.tp, pair.ts, mesh=mesh, shard="rows")
    cm = np.eye(C)
    assert tev.allreduce_confusion(cm) is cm
    dist = torch.distributed
    seen = []

    def all_reduce(t, op=None):  # a peer rank holding the same counts
        seen.append(t.dtype)
        t.mul_(2)

    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    got = tev.allreduce_confusion(cm * 3)
    assert seen == [torch.int64] and got.dtype == np.float64
    np.testing.assert_array_equal(got, cm * 6)


def test_profiling_helpers(tmp_path):
    x = torch.ones(64, 64)
    r = profiling.timeit(torch.mm, x, x, warmup=1, iters=3)
    assert r["ms"] > 0 and r["seconds"] == pytest.approx(r["ms"] / 1e3)
    profiling.sync({"a": [x, (x,)]})  # nothing to wait for on the CPU
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.mm(x, x)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    eff = profiling.flops_efficiency(989e12, 2.0)
    assert eff == {"tflops": 494.5, "fraction_of_peak": 0.5}
