"""Explicit model registry (replaces the reference's
``eval('networks.'+args.model+'.Seg_Model')`` string dispatch,
train.py:192)."""

from __future__ import annotations

from typing import Any, Callable, Dict

from dcfp_tpu_torch.models.heads import (SegModel, build_deeplabv3,
                                   build_deeplabv3p, build_psp, build_simple)

MODELS: Dict[str, Callable[..., SegModel]] = {
    "deeplabv3": build_deeplabv3,
    "deeplabv3p": build_deeplabv3p,
    "psp": build_psp,
    "simple": build_simple,
}


def build_model(model: str, **kwargs: Any) -> SegModel:
    if model not in MODELS:
        raise KeyError(f"unknown model {model!r}; have {sorted(MODELS)}")
    return MODELS[model](**kwargs)
