"""Path registry (reference mypath.py), env-overridable, no ``eval``
(port of ``dcfp_tpu/data/paths.py``).

``DCFP_DATA_ROOT`` relocates all dataset roots; individual entries can be
overridden with ``DCFP_<DS>_ROOT`` / ``DCFP_<DS>_<SPLIT>_LIST``.
Pretrained backbone checkpoints resolve under ``DCFP_PRETRAINED_DIR``.
The manifests are the vendored list files under ``datasets/list/``,
read by relative path like the JAX package's, never imported.
"""

from __future__ import annotations

import os
import os.path as osp

_DATA_ROOT = os.environ.get("DCFP_DATA_ROOT", "data")
_PRETRAINED = os.environ.get("DCFP_PRETRAINED_DIR", "pretrained_models")

_ROOTS = {
    "CS": osp.join(_DATA_ROOT, "CS"),
    "CTX": osp.join(_DATA_ROOT, "CTX"),
    "ADE": _DATA_ROOT,
    "COCO": osp.join(_DATA_ROOT, "cocostuff"),
}

_LISTS = {
    ("CS", "train"): "datasets/list/cityscapes/train.lst",
    ("CS", "trainval"): "datasets/list/cityscapes/trainval.lst",
    # coarse-augmented lists shipped by the reference but unmapped there
    # (mypath.py:8-11 covers only train/trainval/val/test): mapped here
    # so `--data-set CS --data-split train+` just works.
    ("CS", "train+"): "datasets/list/cityscapes/train+.lst",
    ("CS", "train++"): "datasets/list/cityscapes/train++.lst",
    ("CS", "val"): "datasets/list/cityscapes/val.lst",
    ("CS", "test"): "datasets/list/cityscapes/test.lst",
    ("CTX", "train"): "datasets/list/ctx/train.txt",
    ("CTX", "train_all"): "datasets/list/ctx/train_all.txt",
    ("CTX", "val"): "datasets/list/ctx/val.txt",
    ("ADE", "train"): "datasets/list/ade/training.odgt",
    ("ADE", "val"): "datasets/list/ade/validation.odgt",
    ("COCO", "train"): "datasets/list/cocostuff/train.txt",
    ("COCO", "val"): "datasets/list/cocostuff/test.txt",
}

_PRETRAINED_FILES = {
    "resnet50": "resnet50-25c4b509.pth",
    "resnet101": "resnet101-2a57e44d.pth",
    "resnet152": "resnet152-0d43d698.pth",
    "hrnetv2w48": "hrnetv2_w48-imagenet.pth",
}


def dataset_key(dataset: str) -> str:
    for key in ("CS", "CTX", "ADE", "COCO"):
        if dataset.startswith(key):
            return key
    raise KeyError(dataset)


def data_dir(dataset: str, split: str):
    """(root, list_path) for a dataset+split (reference mypath.py:35-39)."""
    key = dataset_key(dataset)
    root = os.environ.get(f"DCFP_{key}_ROOT", _ROOTS[key])
    lst = os.environ.get(f"DCFP_{key}_{split.upper()}_LIST",
                         _LISTS[(key, split)])
    return root, lst


def pretrained_dir(model: str) -> str:
    return os.environ.get(
        f"DCFP_PRETRAINED_{model.upper()}",
        osp.join(_PRETRAINED, _PRETRAINED_FILES.get(model, model + ".pth")))
