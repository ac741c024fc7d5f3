"""CLI package (port of ``dcfp_tpu/cli``): the scripts' commands with the
module renamed, ``python -m dcfp_tpu_torch.cli.<name>``.

The CLIs run on the CUDA card.  ``DCFP_PLATFORM=cpu`` runs them on the
CPU instead; unset, or set to ``cuda``/``gpu``, the device is CUDA and a
host without CUDA raises (no fallback).  The variable is read when a CLI
runs, not at import.  The JAX package's ``DCFP_NUM_CPU_DEVICES`` (virtual
XLA devices) and ``DCFP_COMPILE_CACHE`` (XLA's compile cache) have no
counterpart here and switch nothing.
"""

from __future__ import annotations

import os

import torch

_CUDA = ("", "cuda", "gpu")


def platform_device() -> torch.device:
    """The device ``DCFP_PLATFORM`` selects: CPU for ``cpu``, else CUDA,
    which raises on a host without it."""
    from dcfp_tpu_torch.device import resolve_device
    p = os.environ.get("DCFP_PLATFORM", "").strip().lower()
    if p == "cpu":
        return torch.device("cpu")
    if p not in _CUDA:
        raise ValueError(f"DCFP_PLATFORM={p!r}: the port runs on 'cpu' or "
                         "'cuda'")
    return resolve_device("cuda")
