"""EIC (expected importance of channels) scoring — the DCFP training-time
statistic (reference pruners/dcfp_pruner.py:7-26).  Port of
``dcfp_tpu/prune/eic.py``.

Per prunable BN scale parameter gamma, per step:

    flag    = grad(gamma) * gamma > 0          # gradient shrinks channel
    eic_new = where(flag, r * eic + (1-r) * |grad|, eic)

The train step applies it to the raw gradients, before the optimizer
touches them, and carries the score as state.
"""

from __future__ import annotations

from typing import Dict

import torch

from dcfp_tpu_torch.graph.ir import Graph

EicState = Dict[str, torch.Tensor]


def prunable_bn_names(graph: Graph):
    ignore = set(graph.ignore_prune)
    return [n.name for n in graph.bn_nodes() if n.name not in ignore]


def init_eic(graph: Graph, device: torch.device) -> EicState:
    return {name: torch.zeros((graph.node(name).attrs["channels"],),
                              dtype=torch.float32, device=device)
            for name in prunable_bn_names(graph)}


def eic_update(eic: EicState, params, grads, r: float = 0.999) -> EicState:
    new = {}
    for name, score in eic.items():
        g = grads[name]["scale"].float()
        w = params[name]["scale"].float()
        new[name] = torch.where(g * w > 0, r * score + (1.0 - r) * g.abs(),
                                score)
    return new
