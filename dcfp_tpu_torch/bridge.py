"""Params/state between the JAX package's numpy pytrees and the port.

Both packages key params by graph node name (``backbone.layer3.0.conv2``)
as ``{node: {"kernel", "bias", "scale", ...}}``; state is
``{bn: {"mean", "var"}}``.  The names contain dots, which
``nn.ParameterDict`` and ``register_buffer`` reject, so the port keeps the
same plain dicts, of tensors.  Conv kernels are HWIO in the JAX package
and OIHW here; every other array keeps its shape.  In the port a tensor
is in the port's layout and a numpy array in the JAX package's (the
pruner's trees, the checkpoint files).

The checkpoint files hold the JAX package's layout, so every artifact
crosses this module on its way to and from disk, the optimizer state in
the optax chain's state-dict form (``opt_state_to_state_dict``).
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
    if isinstance(value, torch.Tensor):  # a bfloat16 leaf of a file
        t = value.permute(3, 2, 0, 1) if (key == "kernel"
                                          and value.dim() == 4) else value
        t = t.contiguous()
    else:
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


def _tree_from_np(tree, dev: torch.device,
                  dtype: Optional[torch.dtype] = None):
    return {n: {k: _from_np(k, v, dev, dtype) for k, v in d.items()}
            for n, d in tree.items()}


def tree_to_numpy(tree):
    """A params/state-shaped tree -> JAX-layout numpy: tensors convert as
    in :func:`params_to_numpy`; numpy leaves are JAX layout already."""
    return {n: {k: (_to_np(k, v) if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in d.items()}
            for n, d in tree.items()}


def tree_to_file_layout(tree):
    """A params-shaped tree of the port's tensors -> the JAX package's
    layout (HWIO kernels) on the host, each tensor at its own dtype: the
    tree the checkpoint writer packs, bfloat16 included."""
    return {n: {k: (v.detach().cpu().permute(2, 3, 1, 0).contiguous()
                    if k == "kernel" and v.dim() == 4
                    else v.detach().cpu().contiguous())
                for k, v in d.items()}
            for n, d in tree.items()}


def params_from_numpy(params, state, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Tuple[Params, State]:
    """JAX-layout numpy (or array-like, or the bfloat16 tensors a file
    gives) params/state -> the port's tensors on ``device``.  ``dtype``
    casts floating params (state stays as given, like the JAX package's
    float32 BN statistics)."""
    dev = resolve_device(device)
    return _tree_from_np(params, dev, dtype), _tree_from_np(state, dev)


def params_to_numpy(params: Params, state: State
                    ) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                               Dict[str, Dict[str, np.ndarray]]]:
    """The port's tensors -> JAX-layout numpy (bf16 widens to float32)."""
    return tree_to_numpy(params), tree_to_numpy(state)


def _states(opt_state):
    """The optax chain's per-transform states, in chain order: tuples are
    walked, named tuples (``TraceState``, ``ScaleByAdamState``,
    ``MaskedState``...) are leaves."""
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return [s for part in opt_state for s in _states(part)]
    return [opt_state]


def opt_state_from_numpy(opt_state, device: DeviceLike = None) -> dict:
    """An optax SGD (``add_decayed_weights``, ``trace``, lr schedule) or
    AdamW (``scale_by_adam``, ``add_decayed_weights``, lr schedule) chain
    state, with numpy (or array-like) leaves, -> the port's optimizer
    state: ``{"count", "trace"}`` or ``{"count", "mu", "nu"}``.  Kernel
    leaves go HWIO -> OIHW.  The chain's counts must agree."""
    dev = resolve_device(device)
    out: dict = {}
    counts = []
    for s in _states(opt_state):
        fields = getattr(s, "_fields", ())
        for f in ("trace", "mu", "nu"):
            if f in fields:
                out[f] = _tree_from_np(getattr(s, f), dev)
        if "count" in fields:
            counts.append(int(np.asarray(s.count)))
    if not counts or len(set(counts)) != 1:
        raise ValueError(f"optimizer state counts disagree: {counts}")
    if not ("trace" in out) ^ ("mu" in out and "nu" in out):
        raise ValueError("not an SGD (trace) or AdamW (mu, nu) state")
    out["count"] = counts[0]
    return out


def opt_state_to_numpy(state: dict, like):
    """The port's optimizer state -> the optax chain state shaped like
    ``like`` (an optax state of the same chain): its ``trace`` / ``mu`` /
    ``nu`` and every ``count`` are replaced, with numpy leaves in JAX
    layout (int32 counts)."""
    if isinstance(like, tuple) and not hasattr(like, "_fields"):
        return tuple(opt_state_to_numpy(state, part) for part in like)
    fields = getattr(like, "_fields", ())
    new = {f: tree_to_numpy(state[f]) for f in ("trace", "mu", "nu")
           if f in fields}
    if "count" in fields:
        new["count"] = np.asarray(state["count"], np.int32)
    return like._replace(**new) if new else like


def eic_from_numpy(eic, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """JAX EIC scores ``{bn: (C,)}`` -> float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {n: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for n, v in eic.items()}


def eic_to_numpy(eic: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {n: v.detach().cpu().numpy() for n, v in eic.items()}


def opt_state_to_state_dict(state: dict, masked: bool = False) -> dict:
    """The port's optimizer state -> the state dict that flax's
    ``to_state_dict`` makes of the optax chain it ports, numpy leaves in
    JAX layout: SGD ``{"0": decay, "1": {"trace"}, "2": {"count"}}``,
    AdamW ``{"0": {"count", "mu", "nu"}, "1": decay, "2": {"count"}}``,
    where the weight decay's state is empty, ``{"inner_state": {}}``
    under a ``no_decay`` mask (``masked``), and every count int32."""
    count = np.asarray(state["count"], np.int32)
    decay = {"inner_state": {}} if masked else {}
    if "trace" in state:
        return {"0": decay, "1": {"trace": tree_to_numpy(state["trace"])},
                "2": {"count": count}}
    return {"0": {"count": count, "mu": tree_to_numpy(state["mu"]),
                  "nu": tree_to_numpy(state["nu"])},
            "1": decay, "2": {"count": count}}


def opt_state_from_state_dict(sd: dict, device: DeviceLike = None) -> dict:
    """Inverse of :func:`opt_state_to_state_dict`: tensors on ``device``
    (``None`` means CUDA).  The chain's counts must agree."""
    dev = resolve_device(device)
    counts = [int(np.asarray(part["count"])) for part in sd.values()
              if isinstance(part, dict) and "count" in part]
    if not counts or len(set(counts)) != 1:
        raise ValueError(f"optimizer state counts disagree: {counts}")
    trace = sd.get("1", {}).get("trace")
    if trace is not None:
        return {"count": counts[0], "trace": _tree_from_np(trace, dev)}
    adam = sd.get("0", {})
    if "mu" not in adam or "nu" not in adam:
        raise ValueError("not an SGD (trace) or AdamW (mu, nu) state")
    return {"count": counts[0], "mu": _tree_from_np(adam["mu"], dev),
            "nu": _tree_from_np(adam["nu"], dev)}
