"""The port's forward-traced topology (``dcfp_tpu_torch/prune/fx_trace.py``,
the aten graph of its eval forward) against the port's declared-IR
tracer and the JAX package's jaxpr tracer, on the five model families of
``tests/test_jaxpr_trace.py`` and the eight random DAGs of
``tests/test_fuzz_prune.py``: coupling groups, BN links, per-conv input
segmentations and protected output spaces must agree exactly
(``topology_mismatches`` empty).  Then ``prune_to_flops`` under
``trace="ir"``, ``"jaxpr"`` and ``"verify"`` against the JAX package's
``"verify"``, and ``"verify"`` refusing a broken IR topology."""

import dataclasses

import numpy as np
import pytest

import test_fuzz_prune
from dcfp_tpu.models.registry import build_model as j_build_model
from dcfp_tpu.prune.eic import prunable_bn_names as j_prunable
from dcfp_tpu.prune.jaxpr_trace import trace_topology_jaxpr
from dcfp_tpu.prune.search import prune_to_flops as j_prune_to_flops
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.models.registry import build_model as t_build_model
from dcfp_tpu_torch.prune import fx_trace
from dcfp_tpu_torch.prune import trace as ttrace
from dcfp_tpu_torch.prune.fx_trace import (topology_mismatches,
                                           trace_topology_fx)
from dcfp_tpu_torch.prune.search import prune_to_flops as t_prune_to_flops
from test_torch_deploy import np_params

CASES = [
    ("deeplabv3", "resnet50",
     {"os": 8, "mg_unit": [1, 2, 4], "inplanes": 128}, {}, True),
    ("deeplabv3p", "resnet50", {"os": 16}, {}, True),
    ("psp", "resnet50", {"os": 8}, {}, True),
    ("simple", "resnet50", {"os": 32, "mg_unit": [1, 1, 1],
                            "inplanes": 64}, {}, False),
    ("simple", "hrnetv2w48", {"width": 18},
     {"in_channels": [270, 270]}, False),
]


def _models(head, backbone, bpara, mpara, deepsup):
    kw = dict(backbone=backbone, backbone_para=bpara, model_para=mpara,
              num_classes=7, align_corner=False, deepsup=deepsup)
    return j_build_model(head, **kw).graph, t_build_model(head, **kw).graph


@pytest.mark.parametrize("head,backbone,bpara,mpara,deepsup", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_fx_topology_matches_ir_and_jaxpr(head, backbone, bpara, mpara,
                                          deepsup):
    jg, tg = _models(head, backbone, bpara, mpara, deepsup)
    params, state = np_params(jg, 0)
    hw = 65 if backbone.startswith("resnet") else 64
    t_fx = trace_topology_fx(tg, params, state, input_shape=(1, hw, hw, 3))
    assert topology_mismatches(ttrace.trace_topology(tg), t_fx) == []
    t_jx = trace_topology_jaxpr(jg, params, state,
                                input_shape=(1, hw, hw, 3))
    assert topology_mismatches(t_jx, t_fx) == []
    # the derivation is not empty: every BN linked, concats spliced
    assert len(t_fx.norm_conv) == len(tg.bn_nodes())
    assert t_fx.output_spaces


@pytest.mark.parametrize("seed", range(8))
def test_fx_topology_on_fuzzed_graphs(seed, monkeypatch):
    """tests/test_fuzz_prune.py's random DAGs (residual adds, concats of
    concats, depthwise convs, SE gates, max pools), built once in each
    package's IR."""
    jg = test_fuzz_prune.random_net(seed)
    monkeypatch.setattr(test_fuzz_prune, "GraphBuilder", TBuilder)
    tg = test_fuzz_prune.random_net(seed)
    params, state = np_params(jg, seed)
    t_fx = trace_topology_fx(tg, params, state, input_shape=(1, 17, 17, 3))
    assert topology_mismatches(ttrace.trace_topology(tg), t_fx) == []
    t_jx = trace_topology_jaxpr(jg, params, state,
                                input_shape=(1, 17, 17, 3))
    assert topology_mismatches(t_jx, t_fx) == []


@pytest.mark.parametrize("axis,size,inner,old,new,want", [
    (1, 8, 1, (2, 8, 3, 5), (16, 15), (0, 1)),  # N merged above C
    (1, 8, 1, (1, 8, 3, 5), (1, 8, 15), (1, 1)),
    (2, 8, 1, (9, 1, 8, 1, 9), (1, 9, 72), (2, 9)),  # the resize's bmm
    (2, 8, 9, (1, 1, 72), (1, 1, 8, 1, 9), (2, 1)),  # and back
    (1, 8, 1, (1, 8, 4), (1, 2, 16), None),  # C split over two axes
])
def test_remap_view(axis, size, inner, old, new, want):
    assert fx_trace._remap_view(axis, size, inner, old, new) == want


PRUNE_KW = dict(prune_ratio=0.3, layer_keep=0.02,
                except_start_keys=("conv_deepsup",), input_hw=(65, 65))


@pytest.fixture(scope="module")
def flagship():
    """The recipe's train graph (DeepLabV3-R50, os 8, mg [1, 2, 4],
    inplanes 128, deepsup) and its deploy graph, numpy params and a
    seeded EIC."""
    kw = dict(backbone="resnet50",
              backbone_para={"os": 8, "mg_unit": [1, 2, 4],
                             "inplanes": 128}, num_classes=19)
    jt = j_build_model("deeplabv3", deepsup=True, **kw).graph
    jd = j_build_model("deeplabv3", deepsup=False, **kw).graph
    tt = t_build_model("deeplabv3", deepsup=True, **kw).graph
    td = t_build_model("deeplabv3", deepsup=False, **kw).graph
    params, state = np_params(jt, 3)
    r = np.random.default_rng(1)
    eic = {bn: np.abs(r.standard_normal(
        jt.node(bn).attrs["channels"])).astype(np.float32)
        for bn in j_prunable(jt)}
    return jt, jd, tt, td, params, state, eic


def test_prune_to_flops_traces_match_jax_verify(flagship):
    """The same channel_cfg, global_percent and FLOPs report under the
    port's ir, jaxpr and verify as under the JAX package's verify."""
    jt, jd, tt, td, params, state, eic = flagship
    want, wgp, wrep = j_prune_to_flops(jt, jd, params, state, eic,
                                       trace="verify", **PRUNE_KW)
    for trace in ("ir", "jaxpr", "verify"):
        got, gp, rep = t_prune_to_flops(tt, td, params, state, eic,
                                        trace=trace, **PRUNE_KW)
        assert (gp, rep) == (wgp, wrep), trace
        assert set(got.channel_cfg) == set(want.channel_cfg)
        for name, cfg in want.channel_cfg.items():
            for k, v in cfg.items():
                np.testing.assert_array_equal(got.channel_cfg[name][k], v,
                                              err_msg=f"{trace} {name}")


def test_verify_refuses_a_broken_ir_topology(flagship, monkeypatch):
    """An IR topology that lost one BN link or merged two coupling groups
    makes ``trace="verify"`` raise before any pruning, naming it."""
    _, _, tt, td, params, state, eic = flagship
    good = ttrace.trace_topology(tt)
    bn = sorted(good.norm_conv)[5]
    unlinked = dataclasses.replace(
        good, norm_conv={k: v for k, v in good.norm_conv.items()
                         if k != bn})
    a, b = sorted(good.spaces)[:2]
    merged_spaces = {k: v for k, v in good.spaces.items() if k != b}
    merged_spaces[a] = good.spaces[a] + good.spaces[b]
    renamed = {b: a}
    merged = dataclasses.replace(
        good, spaces=merged_spaces,
        conv_space={c: renamed.get(s, s)
                    for c, s in good.conv_space.items()},
        in_segments={c: [dataclasses.replace(
            g, space=renamed.get(g.space, g.space)) for g in segs]
            for c, segs in good.in_segments.items()},
        output_spaces=sorted({renamed.get(s, s)
                              for s in good.output_spaces}))
    for broken, what in ((unlinked, "BN pairing differs"),
                         (merged, "coupling groups differ")):
        monkeypatch.setattr(ttrace, "trace_topology",
                            lambda graph, t=broken: t)
        with pytest.raises(RuntimeError, match=what):
            t_prune_to_flops(tt, td, params, state, eic, trace="verify",
                             **PRUNE_KW)
