"""Convert torch checkpoints (reference format) to graph params/state
(port of ``dcfp_tpu/models/convert.py``).

Because graph node names equal the reference's module paths, conversion is
name-driven: ``<name>.weight`` of a conv becomes ``params[name]['kernel']``;
BN ``weight``/``bias`` become scale/bias and ``running_mean``/
``running_var`` become state.  The port's kernels are OIHW, the
reference's layout, so where the JAX package transposes to HWIO this is a
rename.  Handles the reference's checkpoint wrappers ``{'model': ...}`` /
``{'state_dict': ...}`` and the ``module.`` DDP prefix (reference
utils/pyt_utils.py:43-96 load_model).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dcfp_tpu_torch.device import DeviceLike, resolve_device
from dcfp_tpu_torch.graph.ir import Graph
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


def _unwrap(sd: Mapping[str, Any]) -> Mapping[str, Any]:
    if "model" in sd and isinstance(sd["model"], Mapping):
        sd = sd["model"]
    elif "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}
    return sd


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _f32(v, dev: torch.device) -> torch.Tensor:
    t = v.detach() if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.array(v))
    return t.to(dev, torch.float32, copy=True)


def torch_state_dict_to_graph(graph: Graph, sd: Mapping[str, Any], *,
                              prefix: str = "", strict: bool = False,
                              device: DeviceLike = None
                              ) -> Tuple[Dict, Dict, Dict]:
    """Returns (params, state, report), float32 tensors on ``device``
    (``None`` means CUDA).  ``prefix`` is prepended to graph node names
    when looking up torch keys (use ``prefix=''`` for full-model
    checkpoints; a bare ImageNet backbone loads through
    :func:`merge_pretrained_backbone`)."""
    dev = resolve_device(device)
    sd = _unwrap(sd)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    missing, loaded = [], []
    for node in graph.toposorted():
        key = prefix + node.name
        if node.op == "conv":
            wkey = f"{key}.weight"
            if wkey not in sd:
                missing.append(wkey)
                continue
            p = {"kernel": _f32(sd[wkey], dev).contiguous()}  # OIHW
            bkey = f"{key}.bias"
            if node.attrs["bias"]:
                if bkey in sd:
                    p["bias"] = _f32(sd[bkey], dev)
                else:
                    p["bias"] = torch.zeros((node.attrs["out_ch"],),
                                            dtype=torch.float32, device=dev)
                    missing.append(bkey)
            params[node.name] = p
            loaded.append(key)
        elif node.op == "bn":
            wkey = f"{key}.weight"
            if wkey not in sd:
                missing.append(wkey)
                continue
            params[node.name] = {"scale": _f32(sd[wkey], dev),
                                 "bias": _f32(sd[f"{key}.bias"], dev)}
            state[node.name] = {
                "mean": _f32(sd[f"{key}.running_mean"], dev),
                "var": _f32(sd[f"{key}.running_var"], dev)}
            loaded.append(key)
    graph_keys = {prefix + n.name for n in graph.param_nodes()}
    unexpected = sorted(
        {k.rsplit(".", 1)[0] for k in sd if k.endswith((".weight",))}
        - graph_keys)
    report = {"missing": missing, "unexpected": unexpected,
              "loaded": len(loaded)}
    if missing:
        log.warning("convert: %d missing keys (e.g. %s)", len(missing),
                    missing[:4])
    if strict and (missing or unexpected):
        raise KeyError(f"strict conversion failed: {report}")
    return params, state, report


def load_torch_checkpoint(graph: Graph, path: str, *, prefix: str = "",
                          strict: bool = False, device: DeviceLike = None):
    """Load a torch ``.pth`` file from disk (``weights_only`` unless
    ``DCFP_UNSAFE_TORCH_LOAD=1``) onto ``device``."""
    from dcfp_tpu_torch.utils.checkpoint import _torch_load
    sd = _torch_load(path)
    return torch_state_dict_to_graph(graph, sd, prefix=prefix, strict=strict,
                                     device=device)


def _oihw(key: str, v) -> torch.Tensor:
    """A port tensor as it is (OIHW kernels); a numpy leaf is JAX layout
    and its 4-d kernel transposes HWIO -> OIHW."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    a = np.asarray(v)
    if key == "kernel" and a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def to_torch_state_dict(params: Mapping[str, Any],
                        state: Optional[Mapping[str, Any]] = None) -> Dict:
    """Graph params/state (the port's tensors, or JAX-layout numpy) -> a
    reference-format torch state_dict of CPU tensors (``<name>.weight``
    OIHW kernels, BN weight/bias/running_mean/running_var), so artifacts
    produced here can be consumed by the reference's ``load_model``
    (utils/pyt_utils.py:43-96) / ``init_pruned_model``
    (channel_pruner.py:29-74) flows."""
    sd: Dict[str, Any] = {}
    for name, p in params.items():
        if "kernel" in p:
            sd[f"{name}.weight"] = _oihw("kernel", p["kernel"])
            if "bias" in p:
                sd[f"{name}.bias"] = _oihw("bias", p["bias"])
        elif "scale" in p:
            sd[f"{name}.weight"] = _oihw("scale", p["scale"])
            sd[f"{name}.bias"] = _oihw("bias", p["bias"])
    for name, s in (state or {}).items():
        sd[f"{name}.running_mean"] = _oihw("mean", s["mean"])
        sd[f"{name}.running_var"] = _oihw("var", s["var"])
    return sd


def channel_cfg_to_torch(channel_cfg: Mapping[str, Any]) -> Dict:
    """channel_cfg pytree -> the reference's channel_cfg.pth schema
    (ints + torch tensors; channel_pruner.py:821-842), loadable under
    ``torch.load(weights_only=True)``."""
    return {name: {k: (torch.from_numpy(np.ascontiguousarray(v))
                       if np.ndim(v) else int(v))
                   for k, v in entry.items()}
            for name, entry in channel_cfg.items()}


def merge_pretrained_backbone(graph: Graph, sd: Mapping[str, Any],
                              params: Dict, state: Dict,
                              backbone_prefix: str = "backbone.",
                              device: DeviceLike = None):
    """Overlay an ImageNet backbone checkpoint (keys without the
    ``backbone.`` prefix, reference networks/backbone/resnet.py:185-187)
    onto freshly-initialized full-model params in place, the overlaid
    tensors on ``device`` (``None`` means CUDA)."""
    sd = _unwrap(sd)
    prefixed = {backbone_prefix + k: v for k, v in sd.items()}
    new_params, new_state, report = torch_state_dict_to_graph(
        graph, prefixed, prefix="", device=device)
    n = 0
    for name, p in new_params.items():
        if name.startswith(backbone_prefix):
            params[name] = p
            n += 1
    for name, s in new_state.items():
        if name.startswith(backbone_prefix):
            state[name] = s
    log.info("merged pretrained backbone into %d layers", n)
    return params, state
