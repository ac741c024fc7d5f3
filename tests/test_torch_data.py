"""The port's data layer against the JAX package's, on the CPU.

The same fixture files (written by either package's ``synthetic`` module,
which must agree byte for byte) go through ``dcfp_tpu.data`` and
``dcfp_tpu_torch.data``: items must be equal array for array (image,
label or ``{ori, weight/weight_class}``, ``pad`` and meta) for every
dataset, split, ``balance``, ``resample``, ``compact`` and ``native``
setting; the port's native tail must be bit-equal to its numpy tail; the
label index must pickle to the same bytes; the loaders must give the same
batches for several (rank, world) splits, in threads and in worker
processes; and the host edge maps must equal JAX's.  A test that starts
loader processes leaves none behind."""

import multiprocessing as mp
import os
import pickle

import numpy as np
import pytest

from dcfp_tpu.data import datasets as jds
from dcfp_tpu.data import label_index as jli
from dcfp_tpu.data import loader as jloader
from dcfp_tpu.data import paths as jpaths
from dcfp_tpu.data import synthetic as jsyn
from dcfp_tpu.utils import edge as jedge
from dcfp_tpu_torch import native as tnative
from dcfp_tpu_torch.data import datasets as tds
from dcfp_tpu_torch.data import label_index as tli
from dcfp_tpu_torch.data import loader as tloader
from dcfp_tpu_torch.data import paths as tpaths
from dcfp_tpu_torch.data import synthetic as tsyn
from dcfp_tpu_torch.utils import edge as tedge

SHIFTED = {"CTX": 59, "ADE": 150, "COCO": 171}
CLASSES = {"CS": 19, **SHIFTED}


def _tree_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Each dataset's fixture, written by the JAX package, with a label
    index per train split (built by the JAX package)."""
    out = {}
    root = str(tmp_path_factory.mktemp("cs"))
    lists = {s: jsyn.make_cityscapes_fixture(root, n_images=5,
                                             hw=(96, 128), seed=s == "val",
                                             split=s)
             for s in ("train", "val")}
    test_list = os.path.join(root, "test.lst")
    with open(lists["val"]) as f, open(test_list, "w") as g:
        g.write("".join(ln.split()[0] + "\n" for ln in f if ln.strip()))
    lists["test"] = test_list
    out["CS"] = (root, lists)
    for fmt, nc in SHIFTED.items():
        r = str(tmp_path_factory.mktemp(fmt.lower()))
        lst = jsyn.make_shifted_fixture(r, fmt=fmt, n_images=4,
                                        hw=(80, 96), num_classes=nc)
        out[fmt] = (r, {"train": lst, "val": lst})
    for key, (r, lists) in out.items():
        ds = jds.build_dataset(key, r, lists["train"], split="train")
        jli.build_label_index(ds, os.path.join(r, f"label_index_{key}.pkl"))
    return out


def _build(mod, key, fixtures, split, **kw):
    root, lists = fixtures[key]
    if kw.get("resample"):
        kw["label_index_path"] = os.path.join(root, f"label_index_{key}.pkl")
    return mod.build_dataset(key, root, lists[split], split=split, **kw)


def assert_same(a, b, where="item"):
    """Equal trees: same keys, arrays equal in dtype, shape and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), f"{where} differs"
    else:
        assert a == b, (where, a, b)


def _items(ds, n, epoch=0):
    ds.pre_processing(epoch)
    return [ds[i] for i in range(min(n, len(ds)))]


# -- fixture writers, paths, manifests ---------------------------------------

@pytest.mark.parametrize("fmt", ["CS", "CTX", "ADE", "COCO"])
def test_fixture_writers_byte_identical(tmp_path, fmt):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    if fmt == "CS":
        for split, seed in (("train", 0), ("val", 3)):
            ma = jsyn.make_cityscapes_fixture(a, n_images=3, hw=(40, 56),
                                              seed=seed, split=split)
            mb = tsyn.make_cityscapes_fixture(b, n_images=3, hw=(40, 56),
                                              seed=seed, split=split)
            assert os.path.relpath(ma, a) == os.path.relpath(mb, b)
    else:
        kw = dict(fmt=fmt, n_images=3, hw=(30, 44),
                  num_classes=SHIFTED[fmt], seed=5)
        assert os.path.relpath(jsyn.make_shifted_fixture(a, **kw), a) == \
            os.path.relpath(tsyn.make_shifted_fixture(b, **kw), b)
    fa, fb = _tree_files(a), _tree_files(b)
    assert sorted(fa) == sorted(fb) and len(fa) > 3
    for k in fa:
        assert fa[k] == fb[k], k


def test_paths_match(monkeypatch):
    for (key, split) in jpaths._LISTS:
        assert tpaths.data_dir(key, split) == jpaths.data_dir(key, split)
    monkeypatch.setenv("DCFP_CS_ROOT", "/elsewhere/cs")
    monkeypatch.setenv("DCFP_ADE_VAL_LIST", "/elsewhere/val.odgt")
    for ds, split in (("CS", "val"), ("CSx", "train+"), ("ADE", "val")):
        assert tpaths.data_dir(ds, split) == jpaths.data_dir(ds, split)
    for model in ("resnet50", "resnet101", "hrnetv2w48", "other"):
        assert tpaths.pretrained_dir(model) == jpaths.pretrained_dir(model)
    with pytest.raises(KeyError):
        tpaths.dataset_key("VOC")


def test_remaps_and_helpers_match(fixtures):
    np.testing.assert_array_equal(tds._shift_lut(255), jds._shift_lut(255))
    for ids, it in (([1, 2, 3], None), ([1, 2, 3], 7), (["a"], 4)):
        assert tds._repeat_for_iters(ids, it) == jds._repeat_for_iters(ids,
                                                                       it)
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for key in CLASSES:
        t = _build(tds, key, fixtures, "train")
        j = _build(jds, key, fixtures, "train")
        assert type(t).__name__ == type(j).__name__
        assert t.num_classes == j.num_classes == CLASSES[key]
        assert_same(t.files, j.files, key)
        fwd = t.id2trainId(raw)
        assert_same(fwd, j.id2trainId(raw), key)
        assert_same(t.id2trainId(fwd, reverse=True),
                    j.id2trainId(fwd, reverse=True), key)
    with pytest.raises(KeyError):
        tds.build_dataset("VOC", ".", "x")


def test_label_index_pickle_equal(fixtures, tmp_path):
    for key in CLASSES:
        root, _ = fixtures[key]
        ds = _build(tds, key, fixtures, "train")
        path = str(tmp_path / f"{key}.pkl")
        index = tli.build_label_index(ds, path)
        with open(path, "rb") as f:
            port = f.read()
        with open(os.path.join(root, f"label_index_{key}.pkl"), "rb") as f:
            ref = f.read()
        assert port == ref, key
        assert pickle.dumps(index) == pickle.dumps(pickle.loads(ref))


# -- items --------------------------------------------------------------------

# (balance, resample): balance 2 needs the sampled class of resampling
LONG_TAIL = [(0, False), (0, True), (1, False), (1, True), (2, True)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("compact", [False, True], ids=["f32", "compact"])
@pytest.mark.parametrize("balance,resample", LONG_TAIL,
                         ids=[f"b{b}r{int(r)}" for b, r in LONG_TAIL])
def test_cs_train_items_equal(fixtures, balance, resample, compact, native):
    """Random scale, photometric jitter, pad (crop above the smallest
    scaled image), component-centred crops, flip: the same draws."""
    kw = dict(crop_size=(72, 100), scale=True, mirror=True,
              brightness=True, balance=balance, resample=resample,
              compact=compact, native=native, seed=4, beta=0.99)
    t = _items(_build(tds, "CS", fixtures, "train", **kw), 6)
    j = _items(_build(jds, "CS", fixtures, "train", **kw), 6)
    assert len(t) >= 5
    assert_same(t, j)


@pytest.mark.parametrize("compact", [False, True], ids=["f32", "compact"])
@pytest.mark.parametrize("balance,resample", [(0, False), (2, True)],
                         ids=["b0r0", "b2r1"])
@pytest.mark.parametrize("key", sorted(SHIFTED))
def test_shifted_train_items_equal(fixtures, key, balance, resample,
                                   compact):
    kw = dict(crop_size=(64, 64), scale=True, mirror=True, brightness=True,
              balance=balance, resample=resample, compact=compact, seed=9)
    for native in (True, False):
        t = _items(_build(tds, key, fixtures, "train", native=native,
                          **kw), 4)
        j = _items(_build(jds, key, fixtures, "train", native=native,
                          **kw), 4)
        assert_same(t, j, key)


@pytest.mark.parametrize("compact", [False, True], ids=["f32", "compact"])
@pytest.mark.parametrize("split,key", [("val", "CS"), ("test", "CS"),
                                       ("val", "CTX"), ("val", "ADE"),
                                       ("val", "COCO")])
def test_eval_items_equal(fixtures, split, key, compact):
    t = _items(_build(tds, key, fixtures, split, compact=compact), 5)
    j = _items(_build(jds, key, fixtures, split, compact=compact), 5)
    assert len(t) >= 4
    assert_same(t, j, f"{key}/{split}")


@pytest.mark.parametrize("balance,resample", [(0, False), (1, True)],
                         ids=["b0r0", "b1r1"])
def test_native_tail_bit_equal_to_numpy(fixtures, balance, resample):
    """The port's C++ tail against its own numpy tail, same draws; the
    library is built, and every item went through it."""
    assert tnative.built()
    kw = dict(crop_size=(112, 150), scale=True, mirror=True,
              brightness=True, balance=balance, resample=resample, seed=2)
    tnative.reset_calls()
    nat = _items(_build(tds, "CS", fixtures, "train", native=True, **kw), 6)
    calls = tnative.calls()
    assert calls["fused_crop_normalize"] == calls["fused_crop_label"] \
        == len(nat) >= 5
    ref = _items(_build(tds, "CS", fixtures, "train", native=False, **kw), 6)
    assert tnative.calls() == calls
    assert_same(nat, ref)


def test_native_disable_switch(fixtures, monkeypatch):
    monkeypatch.setenv("DCFP_DISABLE_NATIVE", "1")
    assert tnative.lib() is None and not tnative.built()
    img = np.zeros((4, 4, 3), np.uint8)
    assert tnative.crop_normalize(img, 0, 0, (2, 2), False, np.zeros(3),
                                  np.ones(3)) is None


def _numpy_crop(img, lab, off, crop, flip, mean, std, ignore):
    """The JAX package's numpy data-layer tail at any offset: its
    ``normalize_f32`` on the RGB image, then the crop, with 0.0 (after
    normalize) and ``ignore`` outside the image, then the flip; the
    contract ``dcfp_tpu.native`` is held to (``tests/test_native.py``),
    with offsets that may start above or left of the image."""
    from dcfp_tpu.data.base import normalize_f32
    ch, cw = crop
    h, w = lab.shape
    rgb = normalize_f32(img.astype(np.float32)[:, :, ::-1], mean, std)
    out_img = np.zeros((ch, cw, 3), np.float32)
    out_lab = np.full((ch, cw), ignore, np.int64)
    y0, x0 = max(off[0], 0), max(off[1], 0)
    y1, x1 = min(off[0] + ch, h), min(off[1] + cw, w)
    if y1 > y0 and x1 > x0:
        out_img[y0 - off[0]:y1 - off[0], x0 - off[1]:x1 - off[1]] = \
            rgb[y0:y1, x0:x1]
        out_lab[y0 - off[0]:y1 - off[0], x0 - off[1]:x1 - off[1]] = \
            lab[y0:y1, x0:x1]
    if flip:
        out_img, out_lab = out_img[:, ::-1], out_lab[:, ::-1]
    return np.ascontiguousarray(out_img), np.ascontiguousarray(out_lab)


def _jax_native_lib():
    """The JAX package's native library, or None where it did not load.
    That package builds it under one fixed temporary name, so processes
    that build it at once (the test workers that import
    ``tests/test_native.py``) can lose the race and keep its numpy
    fallback, or find a half-written file."""
    from dcfp_tpu import native as jnative
    try:
        return jnative if jnative.lib() is not None else None
    except OSError:
        return None


def test_native_kernels_match_jax():
    """The port's three C++ kernels against the JAX package's numpy
    data-layer path, bit for bit, and against the JAX package's C++
    kernels where that library loaded in this process."""
    assert tnative.built()
    jnative = _jax_native_lib()
    r = np.random.default_rng(0)
    img = r.integers(0, 256, (37, 51, 3), dtype=np.uint8)
    lab = r.integers(0, 30, (37, 51)).astype(np.int64)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    for off, crop, flip in (((0, 0), (20, 20), False),
                            ((-3, 40), (40, 30), True),
                            ((30, -5), (16, 64), True)):
        a = tnative.crop_normalize(img, *off, crop, flip, mean, std)
        b = tnative.crop_label(lab, *off, crop, flip, 255)
        assert_same((a, b), _numpy_crop(img, lab, off, crop, flip, mean,
                                        std, 255))
        if jnative is not None:
            assert_same(a, jnative.crop_normalize(img, *off, crop, flip,
                                                  mean, std))
            assert_same(b, jnative.crop_label(lab, *off, crop, flip, 255))
    lut = jds._shift_lut(255)
    raw = r.integers(0, 256, (9, 13), dtype=np.uint8)
    assert_same(tnative.lut_remap(raw, lut), lut[raw])
    if jnative is not None:
        assert_same(tnative.lut_remap(raw, lut), jnative.lut_remap(raw, lut))


# -- loaders ------------------------------------------------------------------

@pytest.fixture
def no_new_children():
    """Every loader process the test started has been joined by the time
    it ends (children of earlier tests in this process are not its)."""
    before = {p.pid for p in mp.active_children()}
    yield
    left = [p for p in mp.active_children() if p.pid not in before]
    assert left == [], left


def test_collate_equal(fixtures):
    kw = dict(crop_size=(48, 48), balance=1, compact=True, seed=1)
    t = tloader.collate(_items(_build(tds, "CS", fixtures, "train", **kw),
                               3))
    j = jloader.collate(_items(_build(jds, "CS", fixtures, "train", **kw),
                               3))
    assert_same(t, j)


def _train_batches(mod, ds_mod, fixtures, n, **kw):
    ds = _build(ds_mod, "CS", fixtures, "train", crop_size=(40, 48),
                scale=True, mirror=True, brightness=True, balance=2,
                resample=True, compact=True, seed=6)
    loader = mod.TrainLoader(ds, seed=13, **kw)
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()
        loader.stop()


SPLITS = [(0, 1), (1, 2), (2, 3)]


@pytest.mark.parametrize("workers", [0, 2], ids=["thread", "2procs"])
@pytest.mark.parametrize("rank,world", SPLITS,
                         ids=[f"r{r}w{w}" for r, w in SPLITS])
def test_train_loader_batches_equal(fixtures, rank, world, workers,
                                    no_new_children):
    """The port's loader, in its prefetch thread or in two decode
    processes, against the JAX package's sequential loader: the same
    batches across an epoch boundary (the resample index regenerates)."""
    kw = dict(batch_size=3, rank=rank, world=world)
    t = _train_batches(tloader, tds, fixtures, 6, num_workers=workers,
                       use_processes=workers > 1, **kw)
    j = _train_batches(jloader, jds, fixtures, 6, prefetch=0, **kw)
    assert_same(t, j)


@pytest.mark.parametrize("workers", [0, 2], ids=["thread", "2procs"])
@pytest.mark.parametrize("rank,world", SPLITS,
                         ids=[f"r{r}w{w}" for r, w in SPLITS])
def test_eval_loader_batches_equal(fixtures, rank, world, workers,
                                   no_new_children):
    for compact in (False, True):
        t = tloader.EvalLoader(_build(tds, "CS", fixtures, "val",
                                      compact=compact), batch_size=2,
                               rank=rank, world=world, num_workers=workers,
                               use_processes=workers > 1)
        j = jloader.EvalLoader(_build(jds, "CS", fixtures, "val",
                                      compact=compact), batch_size=2,
                               rank=rank, world=world, prefetch=0)
        tb = list(t)
        assert len(tb) == len(t) == len(j)
        assert_same(tb, list(j))


class _Failing:
    """A picklable dataset whose item 3 raises."""

    def __init__(self, n=8):
        self.n = n

    def __len__(self):
        return self.n

    def pre_processing(self, epoch, max_epoch=0):
        pass

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("bad item 3")
        return {"img": np.full((2, 2), i, np.float32)}


@pytest.mark.parametrize("workers", [0, 2], ids=["thread", "2procs"])
def test_loader_worker_error_surfaces(workers, no_new_children):
    ev = tloader.EvalLoader(_Failing(), batch_size=1, num_workers=workers,
                            use_processes=workers > 1)
    with pytest.raises(ValueError, match="bad item 3"):
        list(ev)
    tr = tloader.TrainLoader(_Failing(), batch_size=8, num_workers=workers,
                             use_processes=workers > 1)
    it = iter(tr)
    try:
        with pytest.raises(ValueError, match="bad item 3"):
            next(it)
    finally:
        it.close()
        tr.stop()


class _Cv2Threads:
    """Items that record OpenCV's thread count and the process id where
    they are decoded."""
    rng = None

    def __len__(self):
        return 8

    def pre_processing(self, epoch):
        pass

    def __getitem__(self, i):
        import cv2
        return {"threads": np.array(cv2.getNumThreads()),
                "pid": np.array(os.getpid())}


def test_decode_processes_fork_with_cv2_sequential(no_new_children):
    """Decode processes are forked with OpenCV's thread count at 0, so
    none inherits the parent's pool (not fork-safe: a child forked while
    a pool thread holds its lock hangs in its first parallel cv2 call),
    for the train and the eval loader; the parent keeps its count."""
    import cv2
    before = cv2.getNumThreads()
    mask = (np.random.default_rng(0).random((256, 256)) > 0.5)
    cv2.connectedComponents(mask.astype(np.uint8), connectivity=8)
    tr = tloader.TrainLoader(_Cv2Threads(), batch_size=2, num_workers=2,
                             use_processes=True)
    it = iter(tr)
    try:
        batches = [next(it) for _ in range(4)]
    finally:
        it.close()
        tr.stop()
    batches += list(tloader.EvalLoader(_Cv2Threads(), batch_size=2,
                                       num_workers=2, use_processes=True))
    # setNumThreads(0) runs cv2 sequentially; getNumThreads reports 1
    assert all(int(t) == 1 for b in batches for t in b["threads"])
    assert os.getpid() not in {int(p) for b in batches for p in b["pid"]}
    assert cv2.getNumThreads() == before


# -- host edge maps -----------------------------------------------------------

def _masks(seed, n=3, h=23, w=31, c=5):
    r = np.random.default_rng(seed)
    m = r.integers(0, c, (n, h, w))
    m[:, 5:9, 7:20] = 2  # a solid block: interiors and bands
    m[r.random(m.shape) < 0.05] = 255
    return m


@pytest.mark.parametrize("ratio", [0.02, 0.1])
def test_host_boundary_matches_jax(ratio):
    for mask in _masks(1):
        got = tedge.mask_to_boundary(mask, 5, dilation_ratio=ratio)
        assert_same(got, jedge.mask_to_boundary(mask, 5,
                                                dilation_ratio=ratio))
        onehot = tedge.mask_to_onehot(mask, 5)
        assert_same(tedge.binary_to_boundary(onehot[2], ratio),
                    jedge.binary_to_boundary(onehot[2], ratio))
    stack = _masks(2)
    dev = tedge.mask_to_boundary_device(stack, 5, ratio, device="cpu")
    host = np.stack([tedge.mask_to_boundary(m, 5, ratio) for m in stack])
    np.testing.assert_array_equal(dev, host)


@pytest.mark.parametrize("radius", [(-1, -1), (2, -1), (3, 1)])
def test_edge_maps_match_jax(radius):
    rmax, rmin = radius
    for mask in _masks(3):
        onehot = tedge.mask_to_onehot(mask, 5)
        assert_same(tedge.onehot_to_multiclass_edges(onehot, rmax, 5, rmin),
                    jedge.onehot_to_multiclass_edges(onehot, rmax, 5, rmin))
        assert_same(tedge.onehot_to_binary_edges(onehot, rmax, 5, rmin),
                    jedge.onehot_to_binary_edges(onehot, rmax, 5, rmin))
