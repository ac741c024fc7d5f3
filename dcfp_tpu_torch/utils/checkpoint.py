"""Checkpoint IO: snapshots, resume, prune artifacts (port of
``dcfp_tpu/utils/checkpoint.py``).

Replaces the reference's ``torch.save(state_dict)`` snapshots
(train.py:278-288) and the non-strict ``load_model`` with
missing/unexpected-key logging (utils/pyt_utils.py:43-96).  The files are
the system's, not a framework's: they hold exactly what the JAX package
writes, so either package reads what the other wrote:

* ``<snapshot_dir>/<DS>_scenes_<iter>.msgpack`` — full TrainState
  (``step``, ``params``, ``bn_state``, ``opt_state`` in the optax chain's
  state-dict form, ``eic``) for exact resume;
* ``score.msgpack``        — EIC scores (reference score.pth);
* ``channel_cfg.msgpack``  — pruned-width config (channel_cfg.pth);
* ``pruned.msgpack``       — pruned params+state (pruned.pth).

Each is flax's msgpack encoding of a state dict of numpy arrays, HWIO conv
kernels, written here without flax (``msgpack_serialize`` follows
``flax/serialization.py`` byte for byte): dict keys sorted, sequences as
``{"0": ...}`` dicts, arrays as msgpack ext type 1 with the payload
``packb((shape, dtype.name, bytes))``, numpy scalars as ext type 3, and
arrays above ``MAX_CHUNK_SIZE`` bytes chunked.  A bfloat16 leaf is packed
as flax packs one, ``(shape, "bfloat16", its 2-byte words)``, and a
``"bfloat16"`` record is read back into a ``torch.bfloat16`` tensor, bit
for bit: numpy has no bfloat16 without ``ml_dtypes``, which the port does
not use.  The port's tensors cross
``dcfp_tpu_torch.bridge`` on the way (OIHW <-> HWIO).  Writes are atomic
(tmp + rename) so a preempted job never leaves a truncated snapshot.
``msgpack`` is imported where it is used, never at module level.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dcfp_tpu_torch import bridge
from dcfp_tpu_torch.device import DeviceLike
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()

# flax's limit: msgpack holds at most 2**31 - 1 bytes an object
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------------------
# flax's msgpack encoding
# ---------------------------------------------------------------------------

class Bf16Words:
    """A bfloat16 leaf on its way to a file: its shape and its 2-byte
    words (uint16, C order), which numpy can hold without ``ml_dtypes``."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().cpu().contiguous()
        self.shape = tuple(t.shape)
        self.words = t.view(torch.int16).numpy().view(np.uint16)

    @property
    def nbytes(self) -> int:
        return self.words.nbytes


def _leaf_np(x):
    """A leaf as the file holds it: numpy, or :class:`Bf16Words` for a
    bfloat16 tensor (kept at its width, as the JAX package keeps it)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return Bf16Words(x)
        return x.detach().cpu().numpy()
    return x


def _ndarray_to_bytes(arr) -> bytes:
    import msgpack
    if isinstance(arr, Bf16Words):
        tpl = (arr.shape, "bfloat16", arr.words.tobytes("C"))
        return msgpack.packb(tpl, use_bin_type=True)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    tpl = (arr.shape, arr.dtype.name, arr.tobytes("C"))
    return msgpack.packb(tpl, use_bin_type=True)


def _ext_pack(x):
    import msgpack
    if isinstance(x, (np.ndarray, Bf16Words)):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR,
                               _ndarray_to_bytes(np.asarray(x)))
    return x


def _ndarray_from_bytes(data: bytes):
    """A packed array: numpy (a read-only view of the buffer), or a
    ``torch.bfloat16`` tensor for a ``"bfloat16"`` record."""
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        words = np.frombuffer(buffer, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext_unpack(code, data):
    import msgpack
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _sorted_tree(tree):
    """JAX's ``tree_map(lambda x: x, ...)``: dicts rebuilt with sorted
    keys, lists kept, tensors to numpy."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted_tree(v) for v in tree]
    return _leaf_np(tree)


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    data: Dict[str, Any] = {"__msgpack_chunked_array__": True,
                            "shape": {str(i): d
                                      for i, d in enumerate(arr.shape)}}
    flat = arr.reshape(-1)
    data["chunks"] = {str(i): flat[s:s + chunksize] for i, s in
                      enumerate(range(0, flat.size, chunksize))}
    return data


def _chunk_leaves(d):
    """flax's ``_chunk_array_leaves_in_place``: dict values and the root."""
    if isinstance(d, dict):
        for k, v in d.items():
            if isinstance(v, (np.ndarray, Bf16Words)):
                d[k] = _chunk_leaf(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif isinstance(d, (np.ndarray, Bf16Words)):
        return _chunk_leaf(d)
    return d


def _chunk_leaf(v):
    if v.nbytes <= MAX_CHUNK_SIZE:
        return v
    if isinstance(v, Bf16Words):
        raise ValueError(f"a bfloat16 leaf of {v.nbytes} bytes would need "
                         "flax's chunking, which is not written for it")
    return _chunk(v)


def _unchunk_leaves(d):
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_leaves(v)
    return d


def _unchunk(data):
    shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def msgpack_serialize(pytree) -> bytes:
    """flax's ``msgpack_serialize``: the same bytes for the same tree of
    dicts, lists and array leaves (tensors are taken as numpy)."""
    import msgpack
    tree = _chunk_leaves(_sorted_tree(pytree))
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def msgpack_restore(encoded: bytes):
    """flax's ``msgpack_restore``: nested dicts of numpy arrays (read-only
    views of the buffer) and Python scalars."""
    import msgpack
    tree = msgpack.unpackb(encoded, ext_hook=_ext_unpack, raw=False)
    return _unchunk_leaves(tree)


def to_state_dict(tree):
    """flax's ``to_state_dict`` of the JAX package's host tree: string
    keys, sequences as ``{"0": ...}`` dicts, every leaf an ndarray (a
    Python or numpy scalar becomes a 0-d array, as ``np.asarray`` makes
    it), ``None`` kept."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    if tree is None:
        return None
    leaf = _leaf_np(tree)
    return leaf if isinstance(leaf, Bf16Words) else np.asarray(leaf)


# ---------------------------------------------------------------------------
# low-level pytree IO
# ---------------------------------------------------------------------------

def _write_atomic(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def save_pytree(path: str, tree: Any) -> None:
    blob = msgpack_serialize(to_state_dict(tree))
    _write_atomic(path, blob)
    log.info("saved %s (%.1f MB)", path, len(blob) / 1e6)


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ---------------------------------------------------------------------------
# reference (.pth) artifact interop
# ---------------------------------------------------------------------------
# Every loader below also accepts the reference's torch artifacts:
# full/pruned model checkpoints (train.py:278-282, prune.py:97),
# channel_cfg.pth (channel_pruner.py:821-842 — the same schema this
# framework exports), and score.pth ({'eic': {bn: tensor}},
# dcfp_pruner.py:25-26).

def _is_torch_file(path: str) -> bool:
    return path.endswith((".pth", ".pt"))


def _torch_load(path: str):
    """Load a reference ``.pth`` artifact safely.

    ``weights_only=True`` first: every reference artifact we interop with
    (state_dicts, score.pth, channel_cfg.pth, pruned.pth) is a plain
    container of tensors/ints, so the restricted unpickler suffices.  The
    unrestricted path executes arbitrary pickle code and is only enabled
    by the explicit opt-in env ``DCFP_UNSAFE_TORCH_LOAD=1`` (for exotic
    third-party files), with a warning."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # pickle.UnpicklingError subclass in torch>=2.4
        if os.environ.get("DCFP_UNSAFE_TORCH_LOAD") != "1":
            raise RuntimeError(
                f"{path} is not loadable with torch weights_only=True "
                f"({e}).  If you trust this file, set "
                "DCFP_UNSAFE_TORCH_LOAD=1 to allow full unpickling "
                "(executes arbitrary code from the file).") from e
        log.warning("DCFP_UNSAFE_TORCH_LOAD=1: unpickling %s without "
                    "weights_only protection", path)
        return torch.load(path, map_location="cpu", weights_only=False)


def _torch_trees(sd, params_template: Any, state_template: Any):
    """Reference state_dict -> (params, state) JAX-layout numpy trees
    shaped like the (JAX-layout) templates.  Name-driven: graph node
    names equal reference module paths, conv kernels transpose
    OIHW->HWIO, as the files hold them."""
    from dcfp_tpu_torch.models.convert import _to_np, _unwrap
    sd = dict(_unwrap(sd))
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for name, leaf in (params_template or {}).items():
        if "kernel" in leaf:
            w = sd.get(f"{name}.weight")
            if w is None:
                continue
            entry = {"kernel": np.ascontiguousarray(np.transpose(
                _to_np(w), (2, 3, 1, 0)).astype(np.float32))}
            b = sd.get(f"{name}.bias")
            if "bias" in leaf and b is not None:
                entry["bias"] = _to_np(b).astype(np.float32)
            params[name] = entry
        elif "scale" in leaf:
            w, b = sd.get(f"{name}.weight"), sd.get(f"{name}.bias")
            if w is None:
                continue
            params[name] = {"scale": _to_np(w).astype(np.float32),
                            "bias": _to_np(b).astype(np.float32)}
    for name in (state_template or {}):
        rm = sd.get(f"{name}.running_mean")
        rv = sd.get(f"{name}.running_var")
        if rm is not None:
            state[name] = {"mean": _to_np(rm).astype(np.float32),
                           "var": _to_np(rv).astype(np.float32)}
    return params, state


# ---------------------------------------------------------------------------
# strict resume (TrainState round-trip)
# ---------------------------------------------------------------------------

def train_state_dict(state, masked: bool = False) -> Dict[str, Any]:
    """A port ``TrainState`` -> the state dict that flax makes of the JAX
    package's ``TrainState`` (JAX-layout numpy, int32 ``step``).
    ``masked``: the optimizer's weight decay runs under a ``no_decay``
    mask (``Optimizer.masked``), which shows in the optax chain's
    state."""
    params, bn_state = bridge.params_to_numpy(state.params, state.bn_state)
    return {"step": np.asarray(state.step, np.int32), "params": params,
            "bn_state": bn_state,
            "opt_state": bridge.opt_state_to_state_dict(
                state.opt_state, masked=masked),
            "eic": (None if state.eic is None
                    else bridge.eic_to_numpy(state.eic))}


def save_train_state(path: str, state, optimizer) -> None:
    """``state`` (a port ``TrainState``) as the JAX package writes its own;
    ``optimizer`` is the one that made its ``opt_state``."""
    save_pytree(path, train_state_dict(state, optimizer.masked))


def load_train_state(path: str, template, device: DeviceLike = None):
    """Exact-structure restore into a port ``TrainState`` shaped like
    ``template``, tensors on ``device`` (``None`` means CUDA).  The file's
    leaves must be the template's, path for path and shape for shape."""
    from dcfp_tpu_torch.engine.trainer import TrainState
    sd = load_pytree(path)
    # (the decay's empty state, masked or not, has no leaf)
    want = {k: np.shape(v)
            for k, v in _flat(train_state_dict(template)).items()}
    got = {k: np.shape(v) for k, v in _flat(sd).items()}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        shaped = sorted(k for k in set(want) & set(got)
                        if want[k] != got[k])
        raise ValueError(f"{path} does not match the template: missing "
                         f"{missing[:8]}, unexpected {extra[:8]}, "
                         f"shape differs {shaped[:8]}")
    params, bn_state = bridge.params_from_numpy(sd["params"],
                                                sd["bn_state"], device)
    eic = (None if sd["eic"] is None
           else bridge.eic_from_numpy(sd["eic"], device))
    return TrainState(step=int(sd["step"]), params=params,
                      bn_state=bn_state,
                      opt_state=bridge.opt_state_from_state_dict(
                          sd["opt_state"], device),
                      eic=eic)


# ---------------------------------------------------------------------------
# non-strict param loading (utils/pyt_utils.py:43-96 parity)
# ---------------------------------------------------------------------------

def _flat(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        out[prefix.rstrip("/")] = tree  # a bfloat16 leaf of a file
    elif tree is not None:
        out[prefix.rstrip("/")] = np.asarray(_leaf_np(tree))
    return out


def _unflat_into(template: Any, flat: Dict[str, np.ndarray],
                 prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflat_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    key = prefix.rstrip("/")
    return flat.get(key, template)


def merge_params(template: Any, loaded: Any
                 ) -> Tuple[Any, List[str], List[str]]:
    """Copy every leaf of ``loaded`` whose path and shape match
    ``template``; keep template values elsewhere.  Returns
    (merged, missing_keys, unexpected_keys) and logs the diff, mirroring
    the reference's non-strict load.  Both trees in one layout (the
    files' JAX layout, as :func:`load_params_non_strict` gives them)."""
    t_flat, l_flat = _flat(template), _flat(loaded)
    merged: Dict[str, np.ndarray] = {}
    missing, unexpected = [], []
    for k, tv in t_flat.items():
        lv = l_flat.get(k)
        if lv is None:
            missing.append(k)
        elif tuple(np.shape(lv)) != tuple(np.shape(tv)):
            missing.append(f"{k} (shape {np.shape(lv)} != {np.shape(tv)})")
        else:
            merged[k] = lv
    unexpected = [k for k in l_flat if k not in t_flat]
    if missing:
        log.warning("missing keys in checkpoint: %s",
                    ", ".join(missing[:20]) +
                    (" ..." if len(missing) > 20 else ""))
    if unexpected:
        log.warning("unexpected keys in checkpoint: %s",
                    ", ".join(unexpected[:20]) +
                    (" ..." if len(unexpected) > 20 else ""))
    return _unflat_into(template, merged), missing, unexpected


def load_params_non_strict(path: str, params_template: Any,
                           state_template: Optional[Any] = None,
                           device: DeviceLike = None):
    """Load a snapshot or bare params file into (params, bn_state)
    templates (the port's tensors, or JAX-layout numpy), returning the
    port's tensors on ``device`` (``None`` means CUDA); without a
    ``state_template`` the state returned is None.  Accepts full
    TrainState snapshots (uses their params/bn_state entries),
    pruned.msgpack ({'params','state'}), a bare params tree, or a
    reference torch ``.pth`` checkpoint (auto-converted by module-path
    name).  The merge runs in the files' layout, so it reports the keys
    and shapes the JAX package reports."""
    p_tmpl = bridge.tree_to_numpy(params_template)
    s_tmpl = (None if state_template is None
              else bridge.tree_to_numpy(state_template))
    if _is_torch_file(path):
        loaded_params, loaded_state = _torch_trees(
            _torch_load(path), p_tmpl, s_tmpl)
        log.info("converted reference checkpoint %s (%d param nodes)",
                 path, len(loaded_params))
    else:
        raw = load_pytree(path)
        if isinstance(raw, dict) and "params" in raw:
            loaded_params = raw["params"]
            loaded_state = raw.get("bn_state", raw.get("state"))
        else:
            loaded_params, loaded_state = raw, None
    params, _, _ = merge_params(p_tmpl, loaded_params)
    if s_tmpl is not None and loaded_state is not None:
        s_tmpl, _, _ = merge_params(s_tmpl, loaded_state)
    params, bn_state = bridge.params_from_numpy(params, s_tmpl or {},
                                                device)
    return params, (None if state_template is None else bn_state)


# ---------------------------------------------------------------------------
# prune artifacts
# ---------------------------------------------------------------------------

def save_eic(path: str, eic: Dict[str, Any]) -> None:
    """EIC scores (tensors or numpy) -> ``score.msgpack``."""
    save_pytree(path, {k: _leaf_np(v) for k, v in eic.items()})


def load_eic(path: str) -> Dict[str, np.ndarray]:
    """EIC scores as numpy, the input of ``prune.search.prune_to_flops``."""
    if _is_torch_file(path):
        from dcfp_tpu_torch.models.convert import _to_np
        blob = _torch_load(path)
        eic = blob.get("eic", blob)  # reference: {'eic': {bn: tensor}}
        return {k: _to_np(v).astype(np.float32) for k, v in eic.items()}
    return {k: np.asarray(v) for k, v in load_pytree(path).items()}


def _torch_save(path: str, obj) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj, tmp)
    os.replace(tmp, path)
    log.info("saved %s (torch format)", path)


def save_channel_cfg(path: str, channel_cfg: Dict) -> None:
    """A ``.pth`` path writes the reference's own channel_cfg schema so
    the artifact feeds straight back into the reference's
    ``init_pruned_model`` (channel_pruner.py:29-74)."""
    if _is_torch_file(path):
        from dcfp_tpu_torch.models.convert import channel_cfg_to_torch
        _torch_save(path, channel_cfg_to_torch(channel_cfg))
        return
    save_pytree(path, channel_cfg)


def load_channel_cfg(path: str) -> Dict:
    if _is_torch_file(path):
        from dcfp_tpu_torch.models.convert import _to_np
        cfg = {name: {k: (v if isinstance(v, int) else _to_np(v))
                      for k, v in entry.items()}
               for name, entry in _torch_load(path).items()}
    else:
        cfg = load_pytree(path)
    out = {}
    for name, entry in cfg.items():
        out[name] = {k: (int(v) if np.ndim(v) == 0 else np.asarray(v))
                     for k, v in entry.items()}
    return out


def save_pruned(path: str, params: Any, state: Any) -> None:
    """Pruned params and state (the port's tensors, or the pruner's
    JAX-layout numpy).  A ``.pth`` path writes a reference-format torch
    state_dict (consumed by the reference's load_model after
    init_pruned_model)."""
    if _is_torch_file(path):
        from dcfp_tpu_torch.models.convert import to_torch_state_dict
        _torch_save(path, to_torch_state_dict(params, state))
        return
    save_pytree(path, {"params": bridge.tree_to_numpy(params),
                       "state": bridge.tree_to_numpy(state)})


def load_pruned(path: str, device: DeviceLike = None):
    """(params, state) of ``pruned.msgpack`` as the port's tensors on
    ``device`` (``None`` means CUDA)."""
    blob = load_pytree(path)
    return bridge.params_from_numpy(blob["params"], blob["state"], device)
