"""Native (C++) data-path kernels, built on demand with g++ and bound
via ctypes (port of ``dcfp_tpu/native``).  ``lib()`` returns the loaded
library or None when no toolchain is available — callers fall back to
the numpy path.  Nothing is built at import: the first ``lib()`` call
compiles ``augment.cc`` into ``dcfp_tpu_torch/_build/``, under a name that
carries a hash of the source, the flags and the host's CPU model.

Set ``DCFP_DISABLE_NATIVE=1`` to force the pure-python pipeline.

``calls()`` counts the calls made into each kernel, by this process and
by the processes it forked after importing this module (the counts live
in an anonymous shared mapping and are added to atomically), so a
training run can prove its items went through the library even when its
loader decodes in worker processes.  A worker started by ``spawn``
counts in its own copy.  ``built()`` tells whether the library loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()

_SRC = os.path.join(os.path.dirname(__file__), "augment.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native")
_lock = threading.Lock()
_lib = None
_tried = False

KERNELS = ("fused_crop_normalize", "fused_crop_label", "label_lut_remap")
# one int64 slot per kernel, shared with forked children
_COUNTS = mmap.mmap(-1, 8 * len(KERNELS))
_SLOTS = np.frombuffer(_COUNTS, np.int64)


def calls() -> Dict[str, int]:
    """Calls made into each native kernel since the last reset."""
    return {k: int(_SLOTS[i]) for i, k in enumerate(KERNELS)}


def reset_calls() -> None:
    _SLOTS[:] = 0


def _count(name: str) -> None:
    addr = _SLOTS.ctypes.data + 8 * KERNELS.index(name)
    _lib.count_call(ctypes.c_void_p(addr))


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` builds for it, so a
    library built on another host is never loaded here."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def _target() -> str:
    h = hashlib.sha256(open(_SRC, "rb").read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_cpu_model().encode())
    return os.path.join(_BUILD_DIR, f"libaugment_{h.hexdigest()[:16]}.so")


def _build() -> Optional[str]:
    so = _target()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent build never sees a stub
        log.info("built native augment library: %s", so)
        return so
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        detail = getattr(e, "stderr", b"") or b""
        log.warning("native build failed (%s); using numpy fallback. %s",
                    e.__class__.__name__, detail.decode()[:500])
        return None


def lib():
    """The loaded ctypes library, or None (numpy fallback)."""
    global _lib, _tried
    if os.environ.get("DCFP_DISABLE_NATIVE") == "1":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        L = ctypes.CDLL(so)
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        L.fused_crop_normalize.argtypes = [
            u8p, i64, i64, i64, i64, i64, i64, ctypes.c_int,
            f32p, f32p, f32p]
        L.fused_crop_label.argtypes = [
            i64p, i64, i64, i64, i64, i64, i64, ctypes.c_int, i64, i64p]
        L.label_lut_remap.argtypes = [u8p, i64, i64p, i64p]
        L.count_call.argtypes = [ctypes.c_void_p]
        _lib = L
        return _lib


def built() -> bool:
    """Whether the library is loaded (``lib()`` builds it if needed)."""
    return lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def crop_normalize(img_u8: np.ndarray, off_h: int, off_w: int,
                   crop_hw, flip: bool, mean: np.ndarray,
                   std: np.ndarray) -> Optional[np.ndarray]:
    """uint8 HWC BGR -> normalized f32 RGB crop, one pass.  None if the
    native lib is unavailable."""
    L = lib()
    if L is None or img_u8.dtype != np.uint8 or img_u8.ndim != 3 \
            or img_u8.shape[2] != 3:
        return None
    img_u8 = np.ascontiguousarray(img_u8)
    ch, cw = crop_hw
    out = np.empty((ch, cw, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    L.fused_crop_normalize(
        _ptr(img_u8, ctypes.c_uint8), img_u8.shape[0], img_u8.shape[1],
        int(off_h), int(off_w), ch, cw, int(bool(flip)),
        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
        _ptr(out, ctypes.c_float))
    _count("fused_crop_normalize")
    return out


def crop_label(label: np.ndarray, off_h: int, off_w: int, crop_hw,
               flip: bool, ignore_label: int) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    label = np.ascontiguousarray(label, np.int64)
    ch, cw = crop_hw
    out = np.empty((ch, cw), np.int64)
    L.fused_crop_label(
        _ptr(label, ctypes.c_int64), label.shape[0], label.shape[1],
        int(off_h), int(off_w), ch, cw, int(bool(flip)),
        int(ignore_label), _ptr(out, ctypes.c_int64))
    _count("fused_crop_label")
    return out


def lut_remap(label_u8: np.ndarray, lut: np.ndarray
              ) -> Optional[np.ndarray]:
    L = lib()
    if L is None or label_u8.dtype != np.uint8:
        return None
    label_u8 = np.ascontiguousarray(label_u8)
    lut = np.ascontiguousarray(lut, np.int64)
    out = np.empty(label_u8.shape, np.int64)
    L.label_lut_remap(_ptr(label_u8, ctypes.c_uint8), label_u8.size,
                      _ptr(lut, ctypes.c_int64), _ptr(out, ctypes.c_int64))
    _count("label_lut_remap")
    return out
