"""Synthetic dataset fixtures: tiny on-disk datasets in each manifest
format (CS .lst / CTX .txt / ADE .odgt / COCO .txt) for tests and for
benchmarking without real data (port of ``dcfp_tpu/data/synthetic.py``:
the same files, byte for byte, from the same seed)."""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Tuple

import numpy as np


def make_cityscapes_fixture(root: str, n_images: int = 6,
                            hw: Tuple[int, int] = (96, 128),
                            seed: int = 0, split: str = "train") -> str:
    """Writes images+labels with *raw* Cityscapes label ids (remapped by
    the loader) and a .lst manifest; returns the manifest path."""
    import cv2
    rng = np.random.default_rng(seed)
    h, w = hw
    img_dir = osp.join(root, f"leftImg8bit/{split}")
    lab_dir = osp.join(root, f"gtFine/{split}")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    raw_ids = np.array([7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25,
                        26, 27, 28, 31, 32, 33, 0])  # 19 classes + void
    lines = []
    for i in range(n_images):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        # blocky label layout so connected components are nontrivial
        lab = np.zeros((h, w), np.uint8)
        for _ in range(8):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            dy, dx = rng.integers(8, h // 2), rng.integers(8, w // 2)
            lab[y0:y0 + dy, x0:x0 + dx] = raw_ids[rng.integers(0,
                                                               len(raw_ids))]
        img_rel = f"leftImg8bit/{split}/img_{i:04d}.png"
        lab_rel = f"gtFine/{split}/lab_{i:04d}.png"
        cv2.imwrite(osp.join(root, img_rel), img)
        cv2.imwrite(osp.join(root, lab_rel), lab)
        lines.append(f"{img_rel}\t{lab_rel}")
    manifest = osp.join(root, f"{split}.lst")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


def make_shifted_fixture(root: str, fmt: str = "CTX", n_images: int = 4,
                         hw: Tuple[int, int] = (80, 96), num_classes: int = 59,
                         seed: int = 0) -> str:
    """Fixture for the label-1-shift datasets.  ``fmt``: CTX / ADE / COCO."""
    import cv2
    rng = np.random.default_rng(seed)
    h, w = hw
    if fmt == "CTX":
        img_dir, lab_dir = "images", "labels"
        lab_suffix = ".png"
    elif fmt == "COCO":
        img_dir, lab_dir = "images", "annotations"
        lab_suffix = "_labelTrainIds.png"
    elif fmt == "ADE":
        img_dir, lab_dir = "images", "annotations"
        lab_suffix = ".png"
    else:
        raise ValueError(fmt)
    os.makedirs(osp.join(root, img_dir), exist_ok=True)
    os.makedirs(osp.join(root, lab_dir), exist_ok=True)
    names, items = [], []
    for i in range(n_images):
        name = f"im_{i:04d}"
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        lab = rng.integers(0, min(num_classes, 254) + 1,
                           (h, w)).astype(np.uint8)  # 0 = void
        cv2.imwrite(osp.join(root, img_dir, f"{name}.jpg"), img)
        lab_name = (f"{name}{lab_suffix}" if fmt != "CTX"
                    else f"{name}.png")
        cv2.imwrite(osp.join(root, lab_dir, lab_name), lab)
        names.append(name)
        items.append({"fpath_img": f"{img_dir}/{name}.jpg",
                      "fpath_segm": f"{lab_dir}/{lab_name}",
                      "width": w, "height": h})
    if fmt == "ADE":
        manifest = osp.join(root, "training.odgt")
        with open(manifest, "w") as f:
            for it in items:
                f.write(json.dumps(it) + "\n")
    else:
        manifest = osp.join(root, "train.txt")
        with open(manifest, "w") as f:
            f.write("\n".join(names) + "\n")
    return manifest
