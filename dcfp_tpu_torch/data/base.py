"""The dataset layer's normalize op (port of ``dcfp_tpu/data/base.py``,
``normalize_f32`` only).

``BaseDataset`` and the host augmentation pipeline wait for the data
slice: they decode and warp with ``cv2``, which the port does not take.
"""

from __future__ import annotations

import torch


def normalize_f32(image, mean, std):
    """The protocol's normalize op sequence (/255, -mean, /std in that
    order — reference Base.py:91-96), shared by the evaluator's
    compact-uint8 host path and ``Predictor.prep_raw`` on the device, so
    compact items stay bitwise-equal to classic f32 items.  Works on
    numpy arrays and on tensors: ``image`` must already be float32 (a
    fresh array or tensor; it is updated in place after the division).

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
