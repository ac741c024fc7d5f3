"""EIC (expected importance of channels) helpers — the part of
``dcfp_tpu/prune/eic.py`` the prune path needs.  The score's training-time
update (``init_eic`` / ``eic_update``) belongs to the train step and is
not ported yet."""

from __future__ import annotations

from dcfp_tpu_torch.graph.ir import Graph


def prunable_bn_names(graph: Graph):
    ignore = set(graph.ignore_prune)
    return [n.name for n in graph.bn_nodes() if n.name not in ignore]
