"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled at
first use with ``nvcc`` for Hopper (``sm_90a``) into
``dcfp_tpu_torch/_build/`` and loaded with ``ctypes``.  The library's file
name carries a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  Nothing here runs at import time, and there is
no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time (parallel builds overlap); 0.0 when
                    # a built library was reused
    log: str        # nvcc/ptxas output (registers, spills)


_LOADED: Dict[str, Built] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the port's CUDA kernels are built from source")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load_all(names: Iterable[str]) -> Dict[str, Built]:
    """Build (if needed) and load ``csrc/<name>.cu`` for every name;
    cached per process.  The missing libraries are compiled in parallel,
    one ``nvcc`` per source, all started together."""
    names = list(dict.fromkeys(names))
    todo = [n for n in names if n not in _LOADED]
    jobs = {}
    for name in todo:
        so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, cmd, tmp, so, time.perf_counter())
    logs, secs = {}, {}
    for name, (proc, cmd, tmp, so, t0) in jobs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:"
                               f"\n{' '.join(cmd)}\n{out}")
        os.replace(tmp, so)  # atomic: concurrent builders never see a stub
    for name in todo:
        so = _target(name)
        _LOADED[name] = Built(ctypes.CDLL(str(so)), so, secs.get(name, 0.0),
                              logs.get(name, ""))
    return {name: _LOADED[name] for name in names}


def load(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return load_all([name])[name]
