"""Base dataset: manifests, augmentation, long-tail machinery (port of
``dcfp_tpu/data/base.py``).

Host-side re-implementation of reference datasets/Base.py with the same
augmentation semantics (random scale with long/short-side pinning
:98-110, photometric jitter :112-182, pad-to-crop + random crop
:184-222, horizontal flip :255-258, BGR->RGB /255 normalize :91-96) and
the same long-tail machinery (balance pixel-weight maps :73-89,
class-uniform resampling :28-58 with class-centered crops :203-222).
Items are numpy, built by numpy and ``cv2`` on the host, and equal the
JAX package's item for item: the same names, the same order of random
draws.  ``cv2`` is imported where it is used, never at module level.

Differences by design (shared with the JAX package):
* arrays come out HWC (NHWC batches), not CHW;
* label remap is a 256-entry LUT instead of a python dict loop;
* the resample index is regenerated from a shared (seed, epoch) PRNG on
  every process instead of an NCCL broadcast (datasets/Base.py:51-57) —
  same distribution, no collective, reproducible.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dcfp_tpu_torch.utils.logger import get_logger


def normalize_f32(image, mean, std):
    """The protocol's normalize op sequence (/255, -mean, /std in that
    order — reference Base.py:91-96), shared by the host augmentation
    pipeline, the evaluator's compact-uint8 host path and
    ``Predictor.prep_raw`` on the device, so compact items stay
    bitwise-equal to classic f32 items.  Works on numpy arrays and on
    tensors: ``image`` must already be float32 (a fresh array or tensor;
    it is updated in place after the division).

    On a tensor the 255 is a 0-d tensor on the image's device: PyTorch's
    CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which is not always the IEEE quotient numpy computes."""
    if isinstance(image, torch.Tensor):
        image = image / torch.full((), 255.0, dtype=image.dtype,
                                   device=image.device)
    else:
        image = image / 255.0
    image -= mean
    image /= std
    return image


log = get_logger()


class BaseDataset:
    def __init__(self, split: str = "train", crop_size=(321, 321),
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 scale: bool = True, mirror: bool = True,
                 brightness: bool = True, ignore_label: int = 255,
                 balance: int = 0, resample: bool = False,
                 beta: float = 0.9999, longsize: int = -1,
                 shortsize: int = -1, seed: int = 0, native: bool = True,
                 compact: bool = False, **kwargs):
        self.split = split
        self.crop_h, self.crop_w = crop_size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.scale = scale
        self.is_mirror = mirror
        self.brightness = brightness
        self.ignore_label = ignore_label
        self.balance = balance
        self.resample = resample
        self.beta = beta
        self.long_size = longsize
        self.short_size = shortsize
        self.seed = seed
        self.native = native  # fused C++ crop/normalize when available
        self.compact = compact  # uint8 batches, normalize on device
        self.rng = np.random.default_rng(seed)
        # subclasses fill these:
        self.files: List[Dict[str, str]] = []
        self.num_classes: int = 0
        self.class_files: Optional[Dict] = None  # label_index pkl contents
        self.file_index: List[int] = []
        self.class_index: List[int] = []

    # -- length / resampling -------------------------------------------------
    def __len__(self):
        if self.resample:
            if self.file_index:
                return len(self.file_index)
            # reference formula (Base.py:28-32); exact when every class
            # occurs in the split
            return int(self.class_files["label_f"].max() * self.num_classes)
        return len(self.files)

    def pre_processing(self, epoch: int, max_epoch: int = 0):
        """Per-epoch hook (reference Base.py:34-36): regenerate the
        class-uniform resample index."""
        if self.resample:
            self.gen_index(epoch)

    def gen_index(self, seed: int = 0):
        """Class-uniform file index (reference Base.py:38-58): each class
        contributes max_class_count entries — whole repeats of its file
        list plus a random remainder sample.  Seeded by (dataset seed,
        epoch) so every data-parallel process derives the same index with
        no broadcast."""
        rng = np.random.default_rng((self.seed, seed))
        length = int(self.class_files["label_f"].max())
        self.file_index, self.class_index = [], []
        for i in range(self.num_classes):
            len_i = len(self.class_files[str(i)])
            if len_i == 0:  # class absent from the split entirely
                continue
            ind = list(range(len_i)) * (length // len_i)
            last = length % len_i
            ind += rng.choice(len_i, size=last, replace=False).tolist()
            self.file_index += ind
            self.class_index += [i] * len(ind)
        log.info("created balance dataset: %d samples", len(self.file_index))

    def get_datafile(self, index: int) -> Tuple[Dict, Dict]:
        img_meta: Dict[str, Any] = {"idx": index}
        if self.resample:
            class_ = self.class_index[index]
            index = self.class_files[str(class_)][self.file_index[index]][
                "idx"]
            datafile = self.files[index]
            img_meta["index"] = index
            img_meta["class"] = class_
        else:
            datafile = self.files[index]
        img_meta["name"] = datafile["name"]
        return datafile, img_meta

    # -- label machinery ------------------------------------------------------
    def id2trainId(self, label: np.ndarray, reverse: bool = False
                   ) -> np.ndarray:
        """Identity by default; subclasses override (LUT-based)."""
        return label

    def get_label(self, label: np.ndarray, img_meta: Dict):
        """Attach balance pixel weights (reference Base.py:73-89)."""
        if self.balance <= 0:
            return label.copy()
        labels = {"ori": label.copy()}
        lb = label.copy()
        lb[label == self.ignore_label] = self.num_classes
        class_num = np.bincount(lb.reshape(-1),
                                minlength=self.num_classes + 1)[:-1]
        if self.balance == 1:
            weight_class = 1.0 / (class_num + 1)
        elif self.balance == 2:
            weight_class = ((1 + 1e-8 - self.beta **
                             class_num[img_meta["class"]]) /
                            (1 + 1e-8 - self.beta ** class_num))
        else:
            raise ValueError(f"balance={self.balance}")
        weight_class = np.clip(weight_class, 0.0, 1.0)
        weight_class = np.append(weight_class, 0.0)
        labels["weight"] = weight_class[lb].astype(np.float32)
        return labels

    # -- augmentations --------------------------------------------------------
    def input_transform(self, image: np.ndarray) -> np.ndarray:
        image = image.astype(np.float32)[:, :, ::-1]  # BGR -> RGB
        return normalize_f32(image, self.mean, self.std)

    def generate_scale_label(self, image, label):
        f_scale = 0.5 + self.rng.integers(0, 16) / 10.0
        h, w = image.shape[:2]
        if self.long_size > 0:
            long_size = int(self.long_size * f_scale + 0.5)
            f_scale = long_size * 1.0 / max(h, w)
        elif self.short_size > 0:
            short_size = int(self.short_size * f_scale + 0.5)
            f_scale = short_size * 1.0 / min(h, w)
        import cv2
        image = cv2.resize(image, None, fx=f_scale, fy=f_scale,
                           interpolation=cv2.INTER_LINEAR)
        label = cv2.resize(label, None, fx=f_scale, fy=f_scale,
                           interpolation=cv2.INTER_NEAREST)
        return image, label

    def _jitter_brightness(self, img):
        if self.rng.random() < 0.5:
            return img
        shift = int(self.rng.integers(-10, 11))
        return np.clip(np.around(img.astype(np.float32) + shift),
                       0, 255).astype(np.uint8)

    def _jitter_contrast(self, img):
        if self.rng.random() < 0.5:
            return img
        alpha = self.rng.uniform(0.75, 1.25)
        return np.clip(np.around(img.astype(np.float32) * alpha),
                       0, 255).astype(np.uint8)

    def _jitter_saturation(self, img):
        if self.rng.random() < 0.5:
            return img
        import cv2
        hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV).astype(np.float32)
        alpha = self.rng.uniform(0.75, 1.25)
        hsv[:, :, 1] = np.clip(np.around(hsv[:, :, 1] * alpha), 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)

    def _jitter_hue(self, img):
        if self.rng.random() < 0.5:
            return img
        import cv2
        hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
        delta = int(self.rng.integers(-18, 19))
        hsv[:, :, 0] = (hsv[:, :, 0].astype(np.int32) + delta) % 180
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)

    def photometric(self, image):
        """Jitter order matches reference Base.py:242-250."""
        image = self._jitter_brightness(image)
        mode = int(self.rng.integers(0, 2))
        if mode == 1:
            image = self._jitter_contrast(image)
        image = self._jitter_saturation(image)
        image = self._jitter_hue(image)
        if mode == 0:
            image = self._jitter_contrast(image)
        return image

    # -- cropping -------------------------------------------------------------
    def crop_img(self, img, label, img_meta):
        import cv2
        img_h, img_w = label.shape
        pad_h = max(self.crop_h - img_h, 0)
        pad_w = max(self.crop_w - img_w, 0)
        if pad_h > 0 or pad_w > 0:
            img = cv2.copyMakeBorder(img, 0, pad_h, 0, pad_w,
                                     cv2.BORDER_CONSTANT, value=(0., 0., 0.))
            label = cv2.copyMakeBorder(label, 0, pad_h, 0, pad_w,
                                       cv2.BORDER_CONSTANT,
                                       value=(self.ignore_label,))
        h_off, w_off = self.get_crop_location(label, img_meta)
        img = np.asarray(img[h_off:h_off + self.crop_h,
                             w_off:w_off + self.crop_w], np.float32)
        label = np.asarray(label[h_off:h_off + self.crop_h,
                                 w_off:w_off + self.crop_w], np.int64)
        return img, label

    def get_crop_location(self, label, img_meta):
        """Random crop; under resample, centered on a random connected
        component of the sampled class (reference Base.py:203-222)."""
        img_h, img_w = label.shape
        h_off = w_off = 0
        if self.resample:
            import cv2
            mask = (label == img_meta["class"]).astype(np.uint8)
            nums, comp = cv2.connectedComponents(mask, connectivity=8)
            if nums >= 2:
                n = int(self.rng.integers(1, nums))
                hs, ws = np.where(comp == n)
                n = int(self.rng.integers(0, len(hs)))
                h_off = (hs[n] - self.crop_h // 2 -
                         int(self.rng.integers(-(self.crop_h // 4),
                                               self.crop_h // 4 + 1)))
                w_off = (ws[n] - self.crop_w // 2 -
                         int(self.rng.integers(-(self.crop_w // 4),
                                               self.crop_w // 4 + 1)))
            else:
                h_off = int(self.rng.integers(0, img_h - self.crop_h + 1))
                w_off = int(self.rng.integers(0, img_w - self.crop_w + 1))
        else:
            h_off = int(self.rng.integers(0, img_h - self.crop_h + 1))
            w_off = int(self.rng.integers(0, img_w - self.crop_w + 1))
        h_off = int(np.clip(h_off, 0, img_h - self.crop_h))
        w_off = int(np.clip(w_off, 0, img_w - self.crop_w))
        return h_off, w_off

    # -- item -----------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict[str, Any]:
        import cv2
        datafile, img_meta = self.get_datafile(index)
        image = cv2.imread(datafile["img"], cv2.IMREAD_COLOR)
        if image is None:
            raise FileNotFoundError(datafile["img"])
        img_meta["size"] = np.array(image.shape)
        if self.split == "test":
            return {"img": self.input_transform(image).copy(),
                    "img_meta": img_meta}
        label = cv2.imread(datafile["label"], cv2.IMREAD_GRAYSCALE)
        if label is None:
            raise FileNotFoundError(datafile["label"])
        label = self.id2trainId(label)
        if self.split == "val":
            if self.compact:
                # raw uint8 RGB + uint8 labels: normalization happens on
                # device (Predictor.prep_raw) — 4x less host->device
                # traffic than the classic f32 item, bitwise-equal metrics
                return {"img": np.ascontiguousarray(image[:, :, ::-1]),
                        "label": label.astype(np.uint8).copy(),
                        "img_meta": img_meta}
            return {"img": self.input_transform(image).copy(),
                    "label": label.astype(np.int64).copy(),
                    "img_meta": img_meta}
        # train path (reference Base.py:239-261), HWC output
        if self.scale:
            image, label = self.generate_scale_label(image, label)
        if self.brightness:
            image = self.photometric(image)
        if self.compact:
            return self._compact_item(image, label, img_meta)
        out = self._native_tail(image, label, img_meta)
        if out is not None:
            image, label = out
        else:
            image = self.input_transform(image)
            image, label = self.crop_img(image, label, img_meta)
            if self.is_mirror and self.rng.integers(0, 2) == 1:
                image = image[:, ::-1]
                label = label[:, ::-1]
        labels = self.get_label(label, img_meta)
        return {"img": np.ascontiguousarray(image), "label": labels,
                "img_meta": img_meta}

    def _compact_item(self, image, label, img_meta):
        """Compact batch format: uint8 RGB crop + uint8 labels + a
        per-image class-weight vector, with normalization / weight-map
        expansion deferred to the device (engine/trainer.expand_batch).

        Rationale: the classic f32 batch is ~113 MB at the Cityscapes
        recipe shape (f32 image + int64 labels + f32 weight map) vs
        ~19 MB compact — and the host skips the f32 normalize pass
        entirely.  ``pad`` = (h_valid, w_valid, flip) lets the
        device reproduce the reference's post-normalize zero padding
        exactly (pad pixels are 0.0 AFTER normalize, Base.py:184-201,
        and the horizontal flip mirrors them to the left edge).
        Draws the PRNG in the same order as the classic tail, so equal
        seeds produce equal crops.
        """
        import cv2
        img_h, img_w = label.shape
        pad_h = max(self.crop_h - img_h, 0)
        pad_w = max(self.crop_w - img_w, 0)
        if pad_h or pad_w:
            image = cv2.copyMakeBorder(image, 0, pad_h, 0, pad_w,
                                       cv2.BORDER_CONSTANT, value=(0, 0, 0))
            label = cv2.copyMakeBorder(label, 0, pad_h, 0, pad_w,
                                       cv2.BORDER_CONSTANT,
                                       value=(self.ignore_label,))
        h_off, w_off = self.get_crop_location(label, img_meta)
        img_c = image[h_off:h_off + self.crop_h,
                      w_off:w_off + self.crop_w, ::-1]  # BGR -> RGB
        lab_c = label[h_off:h_off + self.crop_h, w_off:w_off + self.crop_w]
        flip = bool(self.is_mirror and self.rng.integers(0, 2) == 1)
        if flip:
            img_c = img_c[:, ::-1]
            lab_c = lab_c[:, ::-1]
        h_valid = int(min(self.crop_h, img_h - h_off))
        w_valid = int(min(self.crop_w, img_w - w_off))
        lab_c = np.ascontiguousarray(lab_c, dtype=np.uint8)
        if self.balance > 0:
            labels = {"ori": lab_c,
                      "weight_class": self._weight_class(lab_c, img_meta)}
        else:
            labels = lab_c
        return {"img": np.ascontiguousarray(img_c), "label": labels,
                "pad": np.array([h_valid, w_valid, int(flip)], np.int32),
                "img_meta": img_meta}

    def _weight_class(self, label: np.ndarray, img_meta: Dict) -> np.ndarray:
        """(num_classes + 1,) per-class pixel weights of this crop
        (trailing entry = 0.0 for ignore), the factored form of
        get_label's per-pixel map."""
        lb = label.astype(np.int64, copy=True)
        lb[label == self.ignore_label] = self.num_classes
        class_num = np.bincount(lb.reshape(-1),
                                minlength=self.num_classes + 1)[:-1]
        if self.balance == 1:
            weight_class = 1.0 / (class_num + 1)
        elif self.balance == 2:
            weight_class = ((1 + 1e-8 - self.beta **
                             class_num[img_meta["class"]]) /
                            (1 + 1e-8 - self.beta ** class_num))
        else:
            raise ValueError(f"balance={self.balance}")
        weight_class = np.clip(weight_class, 0.0, 1.0)
        return np.append(weight_class, 0.0).astype(np.float32)

    def _native_tail(self, image, label, img_meta):
        """Fused C++ normalize+pad+crop+flip (``dcfp_tpu_torch.native``):
        one pass over the output crop, bitwise-equal to the numpy path
        and drawing the PRNG in the same order.  Returns None to fall
        back."""
        if not self.native or image.dtype != np.uint8:
            return None
        from dcfp_tpu_torch import native
        if native.lib() is None:
            return None
        label = label.astype(np.int64, copy=False)
        pad_h = max(self.crop_h - label.shape[0], 0)
        pad_w = max(self.crop_w - label.shape[1], 0)
        if pad_h or pad_w:
            # only the label needs materializing: get_crop_location reads
            # padded contents; image pad (0.0 post-normalize) and label
            # pad (ignore) are handled by the kernel's bounds check
            label_p = np.pad(label, ((0, pad_h), (0, pad_w)),
                             constant_values=self.ignore_label)
        else:
            label_p = label
        h_off, w_off = self.get_crop_location(label_p, img_meta)
        flip = bool(self.is_mirror and self.rng.integers(0, 2) == 1)
        img_c = native.crop_normalize(image, h_off, w_off,
                                      (self.crop_h, self.crop_w), flip,
                                      self.mean, self.std)
        lab_c = native.crop_label(label, h_off, w_off,
                                  (self.crop_h, self.crop_w), flip,
                                  self.ignore_label)
        if img_c is None or lab_c is None:
            return None
        return img_c, lab_c


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)
