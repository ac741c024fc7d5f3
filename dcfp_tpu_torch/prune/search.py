"""FLOPs-targeted prune search (reference prune.py:61-124).

Sweeps ``global_percent`` upward from 0.5 in steps of 0.02 until the
pruned/deploy-model FLOPs ratio reaches 1 - prune_ratio, measuring FLOPs
analytically at 512x512 on the deepsup-free graph exactly as the
reference does (prune.py:70-79, 100-116)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from dcfp_tpu_torch.graph.ir import Graph
from dcfp_tpu_torch.prune.pruner import (DCFPPruner, PruneResult,
                                         apply_channel_cfg)
from dcfp_tpu_torch.utils.flops import count_flops_params, flops_to_string
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()


def prune_to_flops(train_graph: Graph, deploy_graph: Graph, params, state,
                   eic: Dict[str, np.ndarray], *, prune_ratio: float = 0.6,
                   layer_keep: float = 0.02,
                   except_start_keys: Sequence[str] = ("conv_deepsup",),
                   input_hw: Tuple[int, int] = (512, 512),
                   start_percent: float = 0.5, step: float = 0.02,
                   max_percent: float = 0.99, channel_align: int = 1,
                   trace: str = "ir"
                   ) -> Tuple[PruneResult, float, Dict[str, float]]:
    """Returns (prune_result, global_percent, flops_report).

    ``train_graph`` carries the deepsup head (pruned with
    except=conv_deepsup, matching prune.py:94-96); ``deploy_graph`` is the
    deepsup-free architecture used for FLOPs accounting.

    ``params``/``state`` are numpy in HWIO layout
    (``dcfp_tpu_torch.bridge.params_to_numpy``).

    ``trace`` selects the topology derivation: ``"ir"`` (declared layer
    graph), ``"jaxpr"`` (the forward-traced derivation,
    :mod:`dcfp_tpu_torch.prune.fx_trace`: the aten graph of the port's
    eval forward, the analog of the reference's autograd walk,
    channel_pruner.py:501-737; the name is the JAX package's), or
    ``"verify"`` (compute both, error on any disagreement, prune with
    the IR one).  The forward is traced on fake tensors at
    ``input_hw``.
    """
    base_flops, base_params = count_flops_params(deploy_graph, input_hw)
    log.info("baseline: %s, %.2fM params", flops_to_string(base_flops),
             base_params / 1e6)

    from dcfp_tpu_torch.prune.trace import trace_topology
    if trace not in ("ir", "jaxpr", "verify"):
        raise ValueError("trace must be ir|jaxpr|verify, got %r" % trace)
    # the topology is a function of the architecture only — hoist it out
    # of the global_percent sweep
    topo = trace_topology(train_graph) if trace != "jaxpr" else None
    if trace in ("jaxpr", "verify"):
        from dcfp_tpu_torch.prune.fx_trace import (topology_mismatches,
                                                   trace_topology_fx)
        topo_fx = trace_topology_fx(
            train_graph, params, state,
            input_shape=(1, input_hw[0], input_hw[1], 3))
        if trace == "verify":
            bad = topology_mismatches(topo, topo_fx)
            if bad:
                raise RuntimeError(
                    "IR and forward-traced topology derivations "
                    "disagree:\n  " + "\n  ".join(bad))
            log.info("trace=verify: IR and forward-traced topologies "
                     "agree (%d coupling groups)", len(topo.spaces))
        else:
            topo = topo_fx

    gp = start_percent
    while gp <= max_percent:
        pruner = DCFPPruner(eic, global_percent=gp, layer_keep=layer_keep,
                            except_start_keys=list(except_start_keys),
                            channel_align=channel_align)
        result = pruner.prune_model(train_graph.copy(), params, state,
                                    topology=topo)
        pruned_deploy = apply_channel_cfg(deploy_graph, result.channel_cfg)
        flops, n_params = count_flops_params(pruned_deploy, input_hw)
        ratio = flops / base_flops
        log.info("global_percent=%.2f -> %s (%.1f%% of base), %.2fM params",
                 gp, flops_to_string(flops), 100 * ratio, n_params / 1e6)
        if ratio <= 1.0 - prune_ratio:
            report = {"base_flops": float(base_flops),
                      "pruned_flops": float(flops),
                      "flops_ratio": float(ratio),
                      "base_params": float(base_params),
                      "pruned_params": float(n_params)}
            return result, gp, report
        gp = round(gp + step, 10)
    raise RuntimeError(
        f"prune search hit max_percent={max_percent} without reaching "
        f"{100 * (1 - prune_ratio):.0f}% FLOPs")
