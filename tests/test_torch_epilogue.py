"""The conv epilogue of the port's deploy body on the CPU: the graph
rewrite (``engine/deploy.py`` ``fuse_conv_epilogues``) on the benchmark's
pruned R101 and on small graphs, the rewritten body against the
unrewritten one and against the JAX package's deploy body, the plain
epilogue (``ops/kernels.py`` ``conv_epilogue``) against its definition,
the exported deploy artifact with the operator inside, and the kernel's
name under the benchmark's kernel classes.  The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py."""

import collections
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfp_tpu.engine import deploy as jdeploy
from dcfp_tpu.models.registry import build_model as j_build_model
from dcfp_tpu_torch.bridge import params_from_numpy
from dcfp_tpu_torch.engine import deploy as tdeploy
from dcfp_tpu_torch.graph import apply as apply_mod
from dcfp_tpu_torch.graph.apply import graph_apply, init_graph
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.models.registry import build_model as t_build_model
from dcfp_tpu_torch.ops import kernels
from dcfp_tpu_torch.prune.pruner import apply_channel_cfg
from perfbench.trace import kernel_class
from test_torch_deploy import np_params

ROOT = Path(__file__).resolve().parent.parent
R101_CONFIG = ROOT / "perfbench" / "configs" / "deeplabv3_r101_p50.json"
SMALL = dict(backbone="resnet50",
             backbone_para={"os": 16, "mg_unit": [1, 2, 4], "inplanes": 128},
             num_classes=7, align_corner=True, deepsup=False)
HW = 49


def _epilogues(graph):
    """(act, has residual) of every conv, counted."""
    return collections.Counter(
        (n.attrs.get("epilogue"), len(n.inputs) == 2)
        for n in graph.conv_nodes())


def test_r101_bench_graph_takes_115_epilogues():
    """The serving cell's graph: 77 bias + ReLU, 33 bias + residual +
    ReLU, the 4 downsample blocks' other conv and the classifier with the
    bias alone; no add, ReLU or identity is left in the body."""
    desc = json.loads(R101_CONFIG.read_text())
    graph = apply_channel_cfg(t_build_model(
        desc["model"], backbone=desc["backbone"],
        backbone_para=desc["backbone_para"],
        num_classes=desc["num_classes"], align_corner=desc["align_corner"],
        deepsup=desc["deepsup"]).graph, desc["channel_cfg"])
    params, state = init_graph(graph, torch.Generator().manual_seed(0),
                               device="cpu")
    folded, _, _ = tdeploy.fold_batchnorm(graph, params, state)
    body, _ = tdeploy.split_pred_tail(folded)
    fused = tdeploy.fuse_conv_epilogues(body)
    assert _epilogues(fused) == {("relu", False): 77, ("relu", True): 33,
                                 ("none", False): 5}
    ops = collections.Counter(n.op for n in fused.toposorted())
    assert ops["add"] == ops["relu"] == ops["identity"] == 0
    assert ops["conv"] == 115
    bias_only = {n.name for n in fused.conv_nodes()
                 if n.attrs["epilogue"] == "none"}
    assert fused.outputs[0] in bias_only  # the classifier
    assert sum(n.endswith(".conv3") for n in bias_only) == 4
    # the downsample conv, later in graph order, takes the block's add
    ds = [n for n in fused.conv_nodes() if n.name.endswith("downsample.0")]
    assert len(ds) == 4
    assert all(n.inputs[1].endswith(".conv3") for n in ds)
    # every input is made before its consumer, as the interpreter needs
    seen = set(fused.inputs)
    for n in fused.toposorted():
        assert set(n.inputs) <= seen, n.name
        seen.add(n.name)
    assert tdeploy.fuse_conv_epilogues(fused).nodes.keys() == \
        fused.nodes.keys()


def _chain(shared):
    """conv(bias) -> identity -> add(., x) -> relu -> conv, where
    ``shared`` names the value that a second consumer also reads."""
    b = TBuilder("m")
    x = b.input("image")
    x = b.conv(x, "c0", out_ch=8, kernel=1, padding=0, bias=True)
    c = b.conv(x, "c1", out_ch=8, kernel=3, bias=True)
    i = b.identity(c, "i1")
    s = b.add_([i, x], "sum")
    r = b.relu(s, "out")
    outs = [b.conv(r, "head", out_ch=4, kernel=1, padding=0)]
    if shared is not None:
        outs.append(b.conv({"c1": c, "i1": i, "sum": s}[shared], "tap",
                           out_ch=4, kernel=1, padding=0))
    return b.finish(outs)


@pytest.mark.parametrize("shared,kept", [
    (None, set()), ("c1", {"i1", "sum", "out"}), ("i1", {"sum", "out"}),
    ("sum", {"out"})])
def test_value_with_two_consumers_is_not_merged(shared, kept):
    """A node is merged into the conv only where the value before it has
    that node as its one consumer; graph outputs stay."""
    g = _chain(shared)
    fused = tdeploy.fuse_conv_epilogues(g)
    left = {n.name for n in fused.toposorted()} - {"image", "c0", "c1",
                                                   "head", "tap"}
    assert left == kept
    c1 = fused.node("c1")
    assert c1.attrs["epilogue"] == ("relu" if shared is None else "none")
    assert (len(c1.inputs) == 2) == (shared in (None, "sum"))
    assert fused.outputs == g.outputs
    # c0 feeds c1 and the add: it keeps the bias alone
    assert fused.node("c0").attrs["epilogue"] == "none"


def test_graph_output_is_not_merged():
    b = TBuilder("m")
    x = b.input("image")
    x = b.conv(x, "c", out_ch=4, kernel=3, bias=True)
    x = b.relu(x, "r")
    g = b.finish(["r"])
    fused = tdeploy.fuse_conv_epilogues(g)
    assert fused.node("c").attrs["epilogue"] == "none"
    assert fused.node("r").inputs == ("c",) and fused.outputs == ["r"]


def _folded_small():
    jg = j_build_model("deeplabv3", **SMALL).graph
    tg = t_build_model("deeplabv3", **SMALL).graph
    params, state = np_params(jg, 5)
    return jg, tg, params, state


def test_rewritten_body_matches_unrewritten_and_jax(rng):
    """f32 low-res logits of the deploy body (rewritten) against the
    folded graph run as it is (rtol 1e-5, atol 1e-5 x max|logit|, the
    rewrite tests' tolerance) and against the JAX package's deploy body
    (atol 1e-4 x max|logit|, the deploy tests')."""
    jg, tg, params, state = _folded_small()
    image = rng.standard_normal((1, HW, HW, 3)).astype(np.float32)
    tp, ts = params_from_numpy(params, state, device="cpu")
    body, _, dev_params = tdeploy.make_split_inference_fn(
        tg, tp, ts, dtype=torch.float32, output="argmax", device="cpu")
    got = body(dev_params, torch.from_numpy(image)).numpy()
    folded, fp, fs = tdeploy.fold_batchnorm(tg, tp, ts)
    plain, tail = tdeploy.split_pred_tail(folded)
    outs, _ = graph_apply(plain, fp, fs, {"image": torch.from_numpy(
        image).permute(0, 3, 1, 2)}, channels_first=True)
    want = outs[tail.inputs[0]].numpy()
    assert got.shape == want.shape == (1, 7, 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    jbody, _, jpp = jdeploy.make_split_inference_fn(
        jg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, state), dtype=jnp.float32,
        output="argmax")
    jl = np.asarray(jbody(jpp, jnp.asarray(image)))
    jl = jl if jl.shape == got.shape else jl.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, jl, rtol=0, atol=1e-4 * np.abs(jl).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("c", [19, 32])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_epilogue_matches_definition(rng, dtype, c, residual, relu):
    """``relu(x + b + r)`` summed in f32 in that order and rounded once
    to x's dtype; bit-equal.  The CPU path counts no launch."""
    x = torch.from_numpy(rng.standard_normal((2, c, 5, 7))
                         .astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dtype)
    r = (torch.from_numpy(rng.standard_normal((2, c, 5, 7))
                          .astype(np.float32)).to(dtype)
         if residual else None)
    want = x.float() + b.float()[:, None, None]
    if residual:
        want = want + r.float()
    if relu:
        want = want.clamp_min(0)
    want = want.to(dtype)
    before = dict(kernels.LAUNCHES)
    got = kernels.conv_epilogue(x, b, r, relu=relu)
    assert kernels.LAUNCHES == before
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(kernels.conv_epilogue_plain(x, b, r, relu),
                               want, rtol=0, atol=0)
    cl = kernels.conv_epilogue(
        x.contiguous(memory_format=torch.channels_last), b,
        None if r is None else r.contiguous(
            memory_format=torch.channels_last), relu=relu)
    assert cl.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(cl, want, rtol=0, atol=0)


def test_epilogue_refuses_bad_operands():
    x = torch.zeros((1, 4, 3, 3))
    with pytest.raises(ValueError, match="bias"):
        kernels.conv_epilogue(x, torch.zeros(5))
    with pytest.raises(ValueError, match="bias"):
        kernels.conv_epilogue(x, torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="residual"):
        kernels.conv_epilogue(x, torch.zeros(4), torch.zeros((1, 4, 3, 2)))
    with pytest.raises(TypeError, match="no kernel"):
        kernels.conv_epilogue(x.double(), torch.zeros(4).double())


def test_channels_last_body_feeds_every_epilogue_channels_last(
        rng, monkeypatch):
    """The layout the CUDA kernel reads: on a body run in channels_last,
    as the deploy body runs on the card, every epilogue's x and residual
    are channels_last, the ASPP projection's too (the image-pool
    branch's resize takes the layout of the branch it is sized to, so
    the concat keeps channels_last)."""
    _, tg, params, state = _folded_small()
    tp, ts = params_from_numpy(params, state, device="cpu")
    folded, fp, fs = tdeploy.fold_batchnorm(tg, tp, ts)
    body, tail = tdeploy.split_pred_tail(folded)
    fused = tdeploy.fuse_conv_epilogues(body)
    fp = {n: {k: (v.contiguous(memory_format=torch.channels_last)
                  if v.dim() == 4 else v) for k, v in d.items()}
          for n, d in fp.items()}
    seen = []

    def spy(x, bias, residual=None, relu=False):
        seen.append(all(t.is_contiguous(memory_format=torch.channels_last)
                        for t in (x,) + (() if residual is None
                                         else (residual,))))
        return kernels.conv_epilogue(x, bias, residual, relu=relu)

    monkeypatch.setattr(apply_mod, "conv_epilogue", spy)
    image = torch.from_numpy(rng.standard_normal((1, 3, HW, HW)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    outs, _ = graph_apply(fused, fp, fs, {"image": image},
                          channels_first=True)
    assert len(seen) == sum("epilogue" in n.attrs
                            for n in fused.conv_nodes())
    assert all(seen)
    # the layout moves no value
    want, _ = graph_apply(fused, tdeploy.fold_batchnorm(tg, tp, ts)[1], fs,
                          {"image": image.contiguous()}, channels_first=True)
    name = tail.inputs[0]
    np.testing.assert_allclose(outs[name].numpy(), want[name].numpy(),
                               rtol=1e-5,
                               atol=1e-5 * want[name].abs().max().item())


def test_exported_body_carries_the_operator(rng, tmp_path):
    """The split deploy artifact (``export_serialized_split``) records
    the epilogue as one operator in the body, and ``load_serialized``
    gives the labels of the unexported body and tail."""
    b = TBuilder("m")
    x = b.input("image")
    x = b.conv(x, "c1", out_ch=8, kernel=3, stride=2)
    x = b.bn(x, "n1")
    s = b.relu(x, "r1")
    x = b.conv(s, "c2", out_ch=8, kernel=3)
    x = b.bn(x, "n2")
    x = b.relu(b.add_([x, s], "sum"), "r2")
    x = b.conv(x, "cls", out_ch=6, kernel=1, padding=0, bias=True)
    b.resize(x, "pred", to_input=True, align_corners=True)
    tg = b.finish(["pred"])
    params, state = np_params(tg, 1)
    tp, ts = params_from_numpy(params, state, device="cpu")
    body, tail, p = tdeploy.make_split_inference_fn(
        tg, tp, ts, dtype=torch.float32, output="argmax", device="cpu")
    image = torch.from_numpy(rng.standard_normal((1, 33, 33, 3))
                             .astype(np.float32))
    want = tail(body(p, image), (33, 33))
    path = str(tmp_path / "model.pt2")
    tdeploy.export_serialized_split(body, tail, p, (1, 33, 33, 3), path)
    with open(path, "rb") as f:
        program = torch.export.load(f)
    calls = [n for n in program.graph.nodes if n.op == "call_function"
             and "conv_epilogue" in str(n.target)]
    assert len(calls) == 3  # c1 + ReLU, c2 + residual + ReLU, cls
    run = tdeploy.load_serialized(path)
    torch.testing.assert_close(run(p, image), want, rtol=0, atol=0)


def test_kernel_name_is_an_elementwise_class():
    """``perfbench.trace.kernel_class`` reads the epilogue's kernel as
    elementwise work, so ``serve.elementwise_ms`` measures the bias,
    residual and ReLU before and after the rewrite."""
    src = (ROOT / "dcfp_tpu_torch" / "csrc" / "epilogue.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\(", src)
    assert names == ["epilogue_elementwise_kernel"]
    for t, v in (("float", 4), ("__nv_bfloat16", 8), ("__half", 1)):
        demangled = (f"void (anonymous namespace)::{names[0]}<{t}, true, "
                     f"true, {v}>({t} const*, {t} const*, {t} const*, "
                     f"{t}*, long long, int)")
        assert kernel_class(demangled) == "elementwise"
