"""The yardstick's own arithmetic and reference against the program's
copies, and the rule that neither the benchmark nor its reference loads
JAX, the JAX package, or (for the reference) the program."""

import ast
import json
import os

import pytest
import torch

from tiny import ROOT

HERE = os.path.join(ROOT, "perfbench")
CONFIGS = ("deeplabv3_r101_p50", "deeplabv3_r50_p60")


def desc(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def port_graph(d):
    from dcfp_tpu_torch.models.registry import build_model
    from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
    model = build_model(d["model"], backbone=d["backbone"],
                        backbone_para=d["backbone_para"],
                        num_classes=d["num_classes"],
                        align_corner=d["align_corner"], deepsup=d["deepsup"])
    return apply_channel_cfg(model.graph, d["channel_cfg"])


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("hw", [(65, 129), (97, 97)])
def test_macs_equal_the_programs_count(name, hw):
    from dcfp_tpu_torch.utils.flops import count_flops_params
    from perfbench import arith
    d = desc(name)
    want, _ = count_flops_params(port_graph(d), hw, batch=2)
    assert arith.macs(d, hw, 2) == want


def test_serving_frame_costs_1_94_tflop():
    from perfbench import arith
    assert 2 * arith.macs(desc(CONFIGS[0]), (1025, 2049)) == pytest.approx(
        1.9376e12, rel=1e-4)


def test_k1_bound_is_chip_smokes():
    """chip_smoke.py's K1 bound: bf16 logits read once, labels written
    once, (out_h*w*3 + out_h*out_w*4) float32 operations a channel; at the
    deploy shape 0.0026 ms, set by the operations."""
    from perfbench import arith
    n, c, h, w, oh, ow = 2, 7, 16, 16, 64, 64
    ops = n * c * (oh * w * 3 + oh * ow * 4)
    byt = n * c * h * w * 2 + n * oh * ow
    assert arith.k1_bound_s(n, c, h, w, oh, ow) == max(
        byt / 3.35e12, ops / 67e12)
    deploy = arith.k1_bound_s(1, 19, 129, 257, 1025, 2049)
    assert deploy * 1e3 == pytest.approx(0.0026, abs=5e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_layers_are_the_configured_graph(name):
    from perfbench.reference import deeplab
    d = desc(name)
    g = port_graph(d)
    convs = {n.name: n for n in g.conv_nodes()}
    ref = deeplab.convs(d)
    assert [c.name for c in ref] and set(c.name for c in ref) == set(convs)
    for c in ref:
        a = convs[c.name].attrs
        assert (a["in_ch"], a["out_ch"], a["kernel"], a["stride"],
                a["dilation"], a["bias"]) == (c.cin, c.cout, c.k, c.stride,
                                              c.dilation, c.bias)
        bn = deeplab.bn_of(c.name)
        if bn is not None:
            node = g.node(bn)
            assert node.op == "bn" and list(node.inputs) == [c.name]
    from dcfp_tpu_torch.prune.eic import prunable_bn_names
    assert deeplab.prunable_bns(d) == list(prunable_bn_names(g))


def test_reference_forward_is_the_programs_on_the_cpu():
    """f32 on the CPU, the same seeded weights: the program's graph
    interpreter and the plain reference agree to rounding."""
    from dcfp_tpu_torch.graph.apply import graph_apply
    from perfbench import weights
    from perfbench.reference import deeplab
    d = desc(CONFIGS[0])
    params, state = weights.make(d, 3, torch.device("cpu"))
    x = torch.randn(1, 3, 65, 97, generator=torch.Generator().manual_seed(1))
    ref = deeplab.forward(d, params, state, x)[0]["pred"]
    g = port_graph(d)
    g.outputs = [g.node("pred").inputs[0]]
    outs, _ = graph_apply(g, params, state, {"image": x},
                          channels_first=True)
    got = outs[g.outputs[0]]
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_reference_train_step_is_the_programs_on_the_cpu():
    """One finetune step, f32 on the CPU, the same weights, batch and
    dropout generator: the losses agree to 1e-5, the first gradient's
    median leaf to 5e-3 (a step at this size is ill-conditioned: BN of the
    image-pool branch normalizes over 4 values), the BN statistics' worst
    leaf to 1e-4."""
    from perfbench import checks, train, traffic as gen, weights
    from perfbench.reference import train as ref_train
    from tiny import TRAIN, spec
    s = spec(TRAIN)
    d, t = s["desc"], dict(s["traffic"], checked_steps=1)
    dev = torch.device("cpu")
    params, state = weights.make(d, 5, dev)
    pool = gen.batches(t, d, 5, dev)
    loop, st = train.build(d, params, state, dev)
    st, run = train.first_steps(d, t, loop, st, gen.batch_stream(pool),
                                torch.Generator().manual_seed(5), dev)
    found = checks.train_outputs(d, run, ref_train.Trainer(d, params, state),
                                 [gen.batch(pool, 0)],
                                 torch.Generator().manual_seed(5))
    assert found["loss_gap"] < 1e-5
    assert found["grad_median"] < 5e-3 and found["bn_worst"] < 1e-4


def test_nothing_imports_jax_and_the_reference_not_the_program():
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(HERE)
             for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "dcfp_tpu"}, path
    yardstick = [os.path.join(HERE, "reference", f)
                 for f in os.listdir(os.path.join(HERE, "reference"))
                 if f.endswith(".py")]
    yardstick += [os.path.join(HERE, f) for f in
                  ("arith.py", "weights.py", "checks.py", "traffic.py",
                   "trace.py")]
    for path in yardstick:
        for m in imports(path):
            assert m.split(".")[0] != "dcfp_tpu_torch", (path, m)
            if m.startswith("perfbench"):
                assert m.startswith("perfbench.reference") or m in (
                    "perfbench",), (path, m)
