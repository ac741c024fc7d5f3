"""Params/state between the JAX package's numpy pytrees and the port.

Both packages key params by graph node name (``backbone.layer3.0.conv2``)
as ``{node: {"kernel", "bias", "scale", ...}}``; state is
``{bn: {"mean", "var"}}``.  The names contain dots, which
``nn.ParameterDict`` and ``register_buffer`` reject, so the port keeps the
same plain dicts, of tensors.  Conv kernels are HWIO in the JAX package
and OIHW here; every other array keeps its shape.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dcfp_tpu_torch.device import DeviceLike, resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]
State = Dict[str, Dict[str, torch.Tensor]]


def _from_np(key: str, value, device: torch.device,
             dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(value)
    if key == "kernel" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _to_np(key: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    a = t.numpy()
    if key == "kernel" and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return np.ascontiguousarray(a)


def params_from_numpy(params, state, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Tuple[Params, State]:
    """JAX-layout numpy (or array-like) params/state -> the port's tensors
    on ``device``.  ``dtype`` casts floating params (state stays as
    given, like the JAX package's float32 BN statistics)."""
    dev = resolve_device(device)
    p = {n: {k: _from_np(k, v, dev, dtype) for k, v in d.items()}
         for n, d in params.items()}
    s = {n: {k: _from_np(k, v, dev, None) for k, v in d.items()}
         for n, d in state.items()}
    return p, s


def params_to_numpy(params: Params, state: State
                    ) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                               Dict[str, Dict[str, np.ndarray]]]:
    """The port's tensors -> JAX-layout numpy (bf16 widens to float32)."""
    p = {n: {k: _to_np(k, v) for k, v in d.items()}
         for n, d in params.items()}
    s = {n: {k: _to_np(k, v) for k, v in d.items()}
         for n, d in state.items()}
    return p, s
