"""Channel pruning engine: mask generation, bias compensation, surgery.

A copy of ``dcfp_tpu/prune/pruner.py``.  It works on numpy params in the
JAX package's HWIO layout: pass the port's tensors through
``dcfp_tpu_torch.bridge.params_to_numpy`` first.

Functional re-design of reference pruners/channel_pruner.py +
pruners/dcfp_pruner.py.  State is explicit: masks are a dict
``{space_id: bool[channels]}``; surgery slices the param pytree and
rewrites conv/bn channel attrs, yielding a genuinely smaller graph for
deployment (no multiply-by-mask at inference).

Key semantics preserved:
* per-BN masks thresholded per pool — pool 0 = 'backbone.*', pool 1 = head
  — at the ``global_percent`` quantile of EIC scores
  (dcfp_pruner.py:36-66);
* ``layer_keep`` minimum-channel floor (dcfp_pruner.py:79-82);
* residual groups share one mask, OR-combined over members
  (channel_pruner.py:750-761);
* concat in-masks spliced from parent spaces (channel_pruner.py:810-819);
* bias compensation: a pruned channel's constant post-BN activation
  relu(beta) is absorbed into the consumer — subtracted from the
  consumer's BN running_mean or added to its conv bias
  (channel_pruner.py:843-905);
* exclusion closure over except_start_keys + model ignore_prune_layer +
  BN<->conv links (channel_pruner.py:950-979).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dcfp_tpu_torch.graph.ir import Graph
from dcfp_tpu_torch.prune.trace import Segment, Topology, trace_topology
from dcfp_tpu_torch.utils.logger import get_logger

log = get_logger()

Masks = Dict[str, np.ndarray]  # space_id -> bool[channels]


def _np(x) -> np.ndarray:
    return np.asarray(x)


@dataclasses.dataclass
class PruneResult:
    graph: Graph
    params: Dict
    state: Dict
    channel_cfg: Dict


class ChannelPruner:
    """Base pruner: topology, exclusion logic, mask propagation, surgery.

    Subclasses implement :meth:`conv_masks` returning a per-conv bool mask
    for every BN-paired conv (reference gen_channel_mask)."""

    def __init__(self, except_start_keys: Optional[Sequence[str]] = None,
                 channel_align: int = 1):
        self.except_start_keys = list(except_start_keys or [])
        # Accelerator extension: round every kept-channel count UP to a
        # multiple of ``channel_align`` by resurrecting the highest-scoring
        # pruned channels.  Matrix-unit tiles are multiples of 8..128;
        # ragged channel counts (e.g. 237) waste lanes in every conv the
        # channel touches, so aligned counts trade a little FLOPs for much
        # better tiling.
        self.channel_align = max(int(channel_align), 1)

    # -- hooks ---------------------------------------------------------------
    def conv_masks(self, graph: Graph, topo: Topology,
                   except_layers: set) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def space_score(self, graph: Graph, topo: Topology, space: str,
                    members: Sequence[str]) -> np.ndarray:
        """Per-channel importance of a space (used only to pick which
        pruned channels to resurrect for alignment).  Subclasses with real
        scores override."""
        size = graph.node(members[0]).attrs["out_ch"]
        return np.zeros(size, np.float64)

    def _align_mask(self, mask: np.ndarray, score: np.ndarray) -> np.ndarray:
        a = self.channel_align
        kept = int(mask.sum())
        if a <= 1 or kept == 0 or kept % a == 0:
            return mask
        target = min(-(-kept // a) * a, mask.size)
        extra = target - kept
        if extra <= 0:
            return mask
        pruned_idx = np.where(~mask)[0]
        order = np.argsort(-score[pruned_idx], kind="stable")
        out = mask.copy()
        out[pruned_idx[order[:extra]]] = True
        return out

    # -- exclusion (channel_pruner.py:950-979) --------------------------------
    def _except_layers(self, graph: Graph, topo: Topology) -> set:
        keys = list(self.except_start_keys) + list(graph.ignore_prune)
        expanded = list(keys)
        for key in keys:
            if key in topo.norm_conv:
                expanded.append(topo.norm_conv[key])
            elif key in topo.conv_norm:
                expanded.append(topo.conv_norm[key])
        out = set()
        for node in graph.param_nodes():
            for key in expanded:
                if node.name.startswith(key):
                    out.add(node.name)
                    break
        return out

    # -- mask propagation ------------------------------------------------------
    def space_masks(self, graph: Graph, topo: Topology) -> Masks:
        """Generate per-space masks: OR over member conv masks; members
        without a mask (no BN / excepted / output-protected) force ones."""
        except_layers = self._except_layers(graph, topo)
        per_conv = self.conv_masks(graph, topo, except_layers)
        masks: Masks = {}
        protected = set(topo.output_spaces)
        for space, members in topo.spaces.items():
            size = graph.node(members[0]).attrs["out_ch"]
            if space in protected:
                masks[space] = np.ones(size, bool)
                continue
            acc = np.zeros(size, bool)
            forced = False
            for conv in members:
                m = per_conv.get(conv)
                if m is None or conv in except_layers:
                    forced = True
                    break
                acc |= m.astype(bool)
            if forced:
                masks[space] = np.ones(size, bool)
            else:
                masks[space] = self._align_mask(
                    acc, self.space_score(graph, topo, space, members))
        return masks

    def in_mask(self, topo: Topology, masks: Masks, conv: str) -> np.ndarray:
        segs = topo.in_segments[conv]
        parts = [masks[s.space] if s.space is not None
                 else np.ones(s.size, bool) for s in segs]
        return np.concatenate(parts)

    # -- bias compensation (channel_pruner.py:843-905) -------------------------
    def _space_bias(self, graph: Graph, topo: Topology, params,
                    space: str) -> np.ndarray:
        """Sum of BN shift (beta) over member convs of a space — the
        constant a pruned channel would contribute post-BN."""
        size = graph.node(topo.spaces[space][0]).attrs["out_ch"]
        bias = np.zeros(size, np.float64)
        for conv in topo.spaces[space]:
            bn = topo.conv_norm.get(conv)
            if bn is not None and bn in params:
                bias += _np(params[bn]["bias"]).astype(np.float64)
        return bias

    def _segment_bias(self, graph, topo, params, segs: List[Segment]
                      ) -> np.ndarray:
        parts = []
        for s in segs:
            if s.space is None:
                parts.append(np.zeros(s.size, np.float64))
            else:
                parts.append(self._space_bias(graph, topo, params, s.space))
        return np.concatenate(parts)

    def compensate_bias(self, graph: Graph, topo: Topology, params, state,
                        masks: Masks) -> Tuple[Dict, Dict]:
        """Absorb pruned channels' relu(beta) through each consumer conv.
        Returns updated (params, state) — numpy copies."""
        params = {k: {kk: _np(vv).copy() for kk, vv in v.items()}
                  for k, v in params.items()}
        state = {k: {kk: _np(vv).copy() for kk, vv in v.items()}
                 for k, v in state.items()}
        for conv in topo.conv_space:
            if graph.node(conv).attrs.get("groups", 1) > 1:
                # depthwise: a pruned input channel IS the pruned output
                # channel (shared mask), so its constant dies with the
                # channel — nothing to absorb.  (The reference's
                # matmul-based absorption cannot express this case,
                # channel_pruner.py:893-895.)
                continue
            segs = topo.in_segments[conv]
            if all(s.space is None for s in segs):
                continue  # input-fed conv, nothing prunable upstream
            in_m = self.in_mask(topo, masks, conv).astype(np.float64)
            bias = self._segment_bias(graph, topo, params, segs)
            activation = np.maximum((1.0 - in_m) * bias, 0.0)
            if not activation.any():
                continue
            kernel = _np(params[conv]["kernel"]).astype(np.float64)  # HWIO
            offset = np.einsum("hwio,i->o", kernel, activation)
            bn = topo.conv_norm.get(conv)
            if bn is not None:
                state[bn]["mean"] = (state[bn]["mean"].astype(np.float64)
                                     - offset).astype(np.float32)
            else:
                node = graph.node(conv)
                if node.attrs["bias"] and "bias" in params[conv]:
                    params[conv]["bias"] = (
                        params[conv]["bias"].astype(np.float64)
                        + offset).astype(np.float32)
                else:
                    # conv had no bias: compensation introduces one; the
                    # deployed graph's attrs pick it up from the params
                    params[conv]["bias"] = offset.astype(np.float32)
        return params, state

    # -- surgery -----------------------------------------------------------------
    def deploy(self, graph: Graph, topo: Topology, params, state,
               masks: Masks) -> PruneResult:
        """Slice params/state and rewrite channel attrs -> smaller model."""
        new_graph = graph.copy()
        new_params: Dict = {}
        new_state: Dict = {}
        channel_cfg: Dict = {}

        for node in graph.toposorted():
            if node.op == "conv":
                out_m = masks.get(topo.conv_space[node.name])
                if out_m is None:
                    out_m = np.ones(node.attrs["out_ch"], bool)
                in_m = self.in_mask(topo, masks, node.name)
                k = _np(params[node.name]["kernel"])
                depthwise = node.attrs.get("groups", 1) > 1
                if depthwise:
                    # kernel is (k, k, 1, C): channels map 1:1 and the
                    # conv shares its space's mask, so only the out dim
                    # slices; groups shrinks with it (the reference's
                    # deploy_subnet sets module.groups = in_channels,
                    # channel_pruner.py:934-936)
                    k = k[:, :, :, out_m]
                else:
                    k = k[:, :, in_m, :][:, :, :, out_m]
                p = {"kernel": k}
                if "bias" in params[node.name]:
                    p["bias"] = _np(params[node.name]["bias"])[out_m]
                new_params[node.name] = p
                nn = new_graph.node(node.name)
                nn.attrs["in_ch"] = int(in_m.sum())
                nn.attrs["out_ch"] = int(out_m.sum())
                if depthwise:
                    nn.attrs["groups"] = int(out_m.sum())
                nn.attrs["bias"] = "bias" in p
                channel_cfg[node.name] = {
                    "in_channels": int(in_m.sum()),
                    "raw_in_channels": int(in_m.size),
                    "in_mask": in_m.astype(np.int8),
                    "out_channels": int(out_m.sum()),
                    "raw_out_channels": int(out_m.size),
                    "out_mask": out_m.astype(np.int8),
                }
            elif node.op == "bn":
                conv = topo.norm_conv.get(node.name)
                if conv is not None:
                    m = masks.get(topo.conv_space[conv])
                else:
                    m = None
                if m is None:
                    m = np.ones(node.attrs["channels"], bool)
                new_params[node.name] = {
                    "scale": _np(params[node.name]["scale"])[m],
                    "bias": _np(params[node.name]["bias"])[m],
                }
                new_state[node.name] = {
                    "mean": _np(state[node.name]["mean"])[m],
                    "var": _np(state[node.name]["var"])[m],
                }
                new_graph.node(node.name).attrs["channels"] = int(m.sum())
                channel_cfg[node.name] = {
                    "out_channels": int(m.sum()),
                    "raw_out_channels": int(m.size),
                    "out_mask": m.astype(np.int8),
                }
        return PruneResult(new_graph, new_params, new_state, channel_cfg)

    # -- the full pipeline (channel_pruner.py:967-990 prune_model) --------------
    def prune_model(self, graph: Graph, params, state,
                    except_start_keys: Optional[Sequence[str]] = None,
                    topology: Optional[Topology] = None) -> PruneResult:
        if except_start_keys:
            self.except_start_keys = (list(self.except_start_keys)
                                      + list(except_start_keys))
        topo = topology if topology is not None else trace_topology(graph)
        masks = self.space_masks(graph, topo)
        total = sum(m.size for m in masks.values())
        kept = sum(int(m.sum()) for m in masks.values())
        log.info("prune: keeping %d/%d grouped channels (%.1f%%)", kept,
                 total, 100.0 * kept / max(total, 1))
        params, state = self.compensate_bias(graph, topo, params, state,
                                             masks)
        return self.deploy(graph, topo, params, state, masks)


class DCFPPruner(ChannelPruner):
    """EIC-score pruner with two global threshold pools
    (reference pruners/dcfp_pruner.py:29-94)."""

    def __init__(self, eic: Dict[str, np.ndarray], global_percent: float = 0.8,
                 layer_keep: float = 0.01,
                 except_start_keys: Optional[Sequence[str]] = None,
                 channel_align: int = 1):
        super().__init__(except_start_keys, channel_align)
        self.eic = {k: _np(v) for k, v in eic.items()}
        self.global_percent = global_percent
        self.layer_keep = layer_keep

    def space_score(self, graph, topo, space, members):
        size = graph.node(members[0]).attrs["out_ch"]
        score = np.zeros(size, np.float64)
        for conv in members:
            bn = topo.conv_norm.get(conv)
            if bn is not None and bn in self.eic:
                score = np.maximum(score, self.eic[bn].astype(np.float64))
        return score

    @staticmethod
    def bn_group(bn_name: str) -> int:
        return 0 if bn_name.startswith("backbone") else 1

    def _thresholds(self, graph: Graph, topo: Topology,
                    except_layers: set) -> List[float]:
        pools: List[List[np.ndarray]] = [[], []]
        for bn, conv in topo.norm_conv.items():
            if bn in except_layers or bn not in self.eic:
                continue
            pools[self.bn_group(bn)].append(self.eic[bn].ravel())
        thresh = [0.0, 0.0]
        for i, pool in enumerate(pools):
            if pool:
                scores = np.sort(np.concatenate(pool))
                idx = min(int(scores.size * self.global_percent),
                          scores.size - 1)
                thresh[i] = float(scores[idx])
        return thresh

    def conv_masks(self, graph: Graph, topo: Topology,
                   except_layers: set) -> Dict[str, np.ndarray]:
        thresh = self._thresholds(graph, topo, except_layers)
        out: Dict[str, np.ndarray] = {}
        for bn, conv in topo.norm_conv.items():
            if conv in except_layers or bn in except_layers:
                continue
            if bn not in self.eic:
                continue
            score = self.eic[bn].ravel()
            mask = score > thresh[self.bn_group(bn)]
            min_keep = max(int(score.size * self.layer_keep), 1)
            if mask.sum() < min_keep:
                top = np.argsort(-score)[:min_keep]
                mask = mask.copy()
                mask[top] = True
            out[conv] = mask
        return out


class RandomChannelPruner(ChannelPruner):
    """Bernoulli baseline (reference pruners/random_pruner.py:11-34)."""

    def __init__(self, global_percent: float = 0.8, layer_keep: float = 0.01,
                 seed: int = 0,
                 except_start_keys: Optional[Sequence[str]] = None,
                 channel_align: int = 1):
        super().__init__(except_start_keys, channel_align)
        self.global_percent = global_percent
        self.layer_keep = layer_keep
        self.rng = np.random.default_rng(seed)

    def conv_masks(self, graph: Graph, topo: Topology,
                   except_layers: set) -> Dict[str, np.ndarray]:
        out = {}
        for bn, conv in topo.norm_conv.items():
            if conv in except_layers or bn in except_layers:
                continue
            ch = graph.node(conv).attrs["out_ch"]
            mask = self.rng.random(ch) > self.global_percent
            min_keep = max(int(ch * self.layer_keep), 1)
            if mask.sum() < min_keep:
                mask[self.rng.choice(ch, min_keep, replace=False)] = True
            out[conv] = mask
        return out


# ---------------------------------------------------------------------------
# rebuild from channel_cfg (reference channel_pruner.py:29-74
# init_pruned_model)
# ---------------------------------------------------------------------------

def apply_channel_cfg(graph: Graph, channel_cfg: Dict) -> Graph:
    """Rewrite a freshly-built full graph to the pruned widths so a pruned
    checkpoint loads shape-exactly (finetune path, train.py:200-205)."""
    g = graph.copy()
    for name, cfg in channel_cfg.items():
        if name not in g.nodes:
            continue
        node = g.node(name)
        if node.op == "conv":
            node.attrs["in_ch"] = cfg["in_channels"]
            node.attrs["out_ch"] = cfg["out_channels"]
            if node.attrs.get("groups", 1) > 1:
                # depthwise: groups shrinks with the shared channel mask
                node.attrs["groups"] = cfg["out_channels"]
        elif node.op == "bn":
            node.attrs["channels"] = cfg["out_channels"]
    return g


def slice_params_to_cfg(params: Dict, state: Dict, channel_cfg: Dict
                        ) -> Tuple[Dict, Dict]:
    """Take leading channels of full-width params to fit a pruned graph —
    parity helper for the reference's re-init-then-load flow
    (channel_pruner.py:50-71)."""
    new_params, new_state = {}, {}
    for name, p in params.items():
        cfg = channel_cfg.get(name)
        if cfg is None:
            new_params[name] = p
            continue
        q = {}
        for k, v in p.items():
            v = _np(v)
            if k == "kernel":
                v = v[:, :, :cfg["in_channels"], :cfg["out_channels"]]
            else:
                v = v[:cfg["out_channels"]]
            q[k] = v
        new_params[name] = q
    for name, s in state.items():
        cfg = channel_cfg.get(name)
        if cfg is None:
            new_state[name] = s
            continue
        new_state[name] = {k: _np(v)[:cfg["out_channels"]]
                           for k, v in s.items()}
    return new_params, new_state
