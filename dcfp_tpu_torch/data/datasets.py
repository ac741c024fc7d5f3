"""The four dataset families: Cityscapes, Pascal Context, ADE20K,
COCO-Stuff (reference datasets/{CS,CTX,ADE,COCO}datasets.py), plus the
explicit registry replacing the reference's ``eval(dataset+'datasets')``
dispatch (datasets/__init__.py:5-7).  Port of
``dcfp_tpu/data/datasets.py``."""

from __future__ import annotations

import json
import math
import os.path as osp
from typing import List, Optional

import numpy as np

from dcfp_tpu_torch.data.base import BaseDataset, load_pickle
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


def _repeat_for_iters(ids: List, max_iters: Optional[int]):
    if max_iters is None:
        return ids
    return ids * int(math.ceil(float(max_iters) / len(ids)))


def _shift_lut(ignore_label: int) -> np.ndarray:
    """label-1 remap LUT: 0 -> ignore, k -> k-1 (CTX/ADE/COCO pattern)."""
    lut = np.arange(-1, 255, dtype=np.int64)
    lut[lut < 0] = ignore_label
    lut = np.concatenate([lut, [ignore_label]])[:256]
    return lut


class CityscapesDataset(BaseDataset):
    """19-class Cityscapes with .lst manifests and labelId->trainId remap
    (reference datasets/CSdatasets.py)."""

    CLASS_WEIGHTS = np.array([
        0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489,
        0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
        1.0865, 1.1529, 1.0507], np.float32)
    LABEL_TOTAL_SUM = np.array([
        2.03641652e+09, 3.36090793e+08, 1.26063612e+09, 3.61994980e+07,
        4.84541660e+07, 6.77895060e+07, 1.14770880e+07, 3.04481930e+07,
        8.79783988e+08, 6.39495360e+07, 2.21979646e+08, 6.73264240e+07,
        7.46316200e+06, 3.86328286e+08, 1.47723280e+07, 1.29902900e+07,
        1.28639550e+07, 5.44915200e+06, 2.28612330e+07])
    CMAP = np.array([
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32]], np.uint8)
    ID_TO_TRAINID = {-1: 255, 0: 255, 1: 255, 2: 255, 3: 255, 4: 255,
                     5: 255, 6: 255, 7: 0, 8: 1, 9: 255, 10: 255, 11: 2,
                     12: 3, 13: 4, 14: 255, 15: 255, 16: 255, 17: 5,
                     18: 255, 19: 6, 20: 7, 21: 8, 22: 9, 23: 10, 24: 11,
                     25: 12, 26: 13, 27: 14, 28: 15, 29: 255, 30: 255,
                     31: 16, 32: 17, 33: 18}

    def __init__(self, root: str, list_path: str, max_iters=None, **kw):
        super().__init__(**kw)
        self.num_classes = 19
        self.root, self.list_path = root, list_path
        self.class_weights = self.CLASS_WEIGHTS
        # forward LUT over raw ids 0..255
        self._lut = np.full(256, self.ignore_label, np.int64)
        for k, v in self.ID_TO_TRAINID.items():
            if 0 <= k < 256:
                self._lut[k] = v
        self._rev = {v: k for k, v in self.ID_TO_TRAINID.items()
                     if v != self.ignore_label}

        with open(list_path) as f:
            lines = [ln.strip().split() for ln in f if ln.strip()]
        if self.split == "test":
            self.img_ids = [ln[0] for ln in lines]
            self.files = [{"img": osp.join(root, p),
                           "name": osp.splitext(osp.basename(p))[0]}
                          for p in self.img_ids]
        else:
            self.img_ids = _repeat_for_iters(lines, max_iters)
            self.files = [
                {"img": osp.join(root, img), "label": osp.join(root, lab),
                 "name": osp.splitext(osp.basename(lab))[0]}
                for img, lab in self.img_ids]
            if self.resample:
                pkl = kw.get("label_index_path") or osp.join(
                    osp.dirname(list_path),
                    "label_index_CStest.pkl" if len(self.img_ids) == 3475
                    else "label_index_CS.pkl")
                self.class_files = load_pickle(pkl)
        log.info("%d images are loaded!", len(self.files))

    def id2trainId(self, label, reverse=False):
        if reverse:
            out = np.full_like(label, 0)
            for train_id, raw_id in self._rev.items():
                out[label == train_id] = raw_id
            return out
        return self._lut[label.astype(np.int64)]


class _ShiftedDataset(BaseDataset):
    """Shared label-1 remap (CTX/ADE/COCO reference pattern)."""

    def id2trainId(self, label, reverse=False):
        if reverse:
            out = label.copy().astype(np.int64)
            out[out == self.ignore_label] = -1
            return out + 1
        out = label.astype(np.int64) - 1
        out[out < 0] = self.ignore_label
        return out


class ContextDataset(_ShiftedDataset):
    """59-class Pascal Context (reference datasets/CTXdatasets.py)."""

    def __init__(self, root: str, list_path: str, max_iters=None, **kw):
        super().__init__(**kw)
        self.num_classes = 59
        self.root, self.list_path = root, list_path
        self.class_weights = None
        with open(list_path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        names = _repeat_for_iters(names, max_iters)
        self.files = [{"img": osp.join(root, f"images/{n}.jpg"),
                       "label": osp.join(root, f"labels/{n}.png"),
                       "name": n} for n in names]
        if self.resample:
            pkl = kw.get("label_index_path") or osp.join(
                osp.dirname(list_path), "label_index_CTX.pkl")
            self.class_files = load_pickle(pkl)
        log.info("%d images are loaded!", len(self.files))


class ADEDataset(_ShiftedDataset):
    """150-class ADE20K with .odgt JSON-line manifests
    (reference datasets/ADEdatasets.py)."""

    def __init__(self, root: str, list_path: str, max_iters=None, **kw):
        super().__init__(**kw)
        self.num_classes = 150
        self.root, self.list_path = root, list_path
        self.class_weights = None
        with open(list_path) as f:
            items = [json.loads(ln) for ln in f if ln.strip()]
        items = _repeat_for_iters(items, max_iters)
        self.files = [
            {"img": osp.join(root, it["fpath_img"]),
             "label": osp.join(root, it["fpath_segm"]),
             "name": osp.splitext(osp.basename(it["fpath_segm"]))[0]}
            for it in items]
        if self.resample:
            pkl = kw.get("label_index_path") or osp.join(
                osp.dirname(list_path), "label_index_ADE.pkl")
            self.class_files = load_pickle(pkl)
        log.info("%d images are loaded!", len(self.files))


class COCOStuffDataset(_ShiftedDataset):
    """171-class COCO-Stuff (reference datasets/COCOdatasets.py)."""

    def __init__(self, root: str, list_path: str, max_iters=None, **kw):
        super().__init__(**kw)
        self.num_classes = 171
        self.root, self.list_path = root, list_path
        self.class_weights = None
        with open(list_path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        names = _repeat_for_iters(names, max_iters)
        self.files = [
            {"img": osp.join(root, f"images/{n}.jpg"),
             "label": osp.join(root, f"annotations/{n}_labelTrainIds.png"),
             "name": n} for n in names]
        if self.resample:
            pkl = kw.get("label_index_path") or osp.join(
                osp.dirname(list_path), "label_index_COCO.pkl")
            self.class_files = load_pickle(pkl)
        log.info("%d images are loaded!", len(self.files))


DATASETS = {
    "CS": CityscapesDataset,
    "CTX": ContextDataset,
    "ADE": ADEDataset,
    "COCO": COCOStuffDataset,
}


def build_dataset(dataset: str, root: str, list_path: str, **kw):
    for key, cls in DATASETS.items():
        if dataset.startswith(key):
            return cls(root, list_path, **kw)
    raise KeyError(f"unknown dataset {dataset!r}; have {sorted(DATASETS)}")
