"""Offline class index for long-tail resampling
(reference label_index.py:34-71): scans a train split once and records,
per class, the files containing it, plus per-class file counts
('label_f') — the fixture consumed by ``resample=True`` datasets.
Port of ``dcfp_tpu/data/label_index.py``: the same pickle."""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


def build_label_index(dataset, save_path: str = None) -> Dict:
    import cv2
    index: Dict = {str(i): [] for i in range(dataset.num_classes)}
    n = len(dataset.files)
    for idx in range(n):
        datafile = dataset.files[idx]
        label = cv2.imread(datafile["label"], cv2.IMREAD_GRAYSCALE)
        label = dataset.id2trainId(label)
        label[label == dataset.ignore_label] = dataset.num_classes
        count = np.bincount(label.reshape(-1),
                            minlength=dataset.num_classes + 1)[:-1]
        for i in np.where(count > 0)[0]:
            index[str(i)].append({"idx": idx, "name": datafile["name"]})
        if (idx + 1) % 200 == 0:
            log.info("label_index: %d/%d", idx + 1, n)
    index["label_f"] = np.array(
        [len(index[str(i)]) for i in range(dataset.num_classes)], np.float64)
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)),
                    exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(index, f)
        log.info("saved label index to %s", save_path)
    return index
