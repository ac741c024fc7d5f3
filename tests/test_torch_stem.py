"""The port's phase-plane stem (K2's plain version, the phase extraction,
``stem_plan`` and the ``phases`` deploy input) against the JAX package's,
on the CPU.

Inputs are made with numpy from a seed.  The JAX stem conv runs its
Pallas kernel in interpret mode, as tests/test_stem.py runs it; the CUDA
kernel is held against the plain version on the card by chip_smoke.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfp_tpu.engine import deploy as jdeploy
from dcfp_tpu.graph.ir import GraphBuilder as JBuilder
from dcfp_tpu.models.registry import build_model as j_build_model
from dcfp_tpu.ops.pallas_kernels import extract_stem_phases as j_phases
from dcfp_tpu.ops.pallas_kernels import stem_conv3x3_s2 as j_stem_conv
from dcfp_tpu.ops.stem import stem_plan as j_stem_plan
from dcfp_tpu_torch.bridge import params_from_numpy
from dcfp_tpu_torch.engine import deploy as tdeploy
from dcfp_tpu_torch.graph.ir import GraphBuilder as TBuilder
from dcfp_tpu_torch.models.registry import build_model as t_build_model
from dcfp_tpu_torch.ops import kernels
from dcfp_tpu_torch.ops.stem import extract_stem_phases, stem_plan


def bf16_close(got, want):
    """Within 1 bf16 ulp of each other, plus 1e-6 x max|want| for values
    near 0, where two f32 sums in different orders differ by more than a
    bf16 ulp of the (tiny) result."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    slack = 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > ulp + slack
    assert not bad.any(), (int(bad.sum()), np.abs(got - want).max())


@pytest.mark.parametrize("h,w,c", [(65, 129, 3), (33, 47, 4)])
def test_extract_phases_equal_jax(rng, h, w, c):
    """The same (4*C, Hp, Wp) planes, row padding included, from numpy
    and from a tensor (the JAX side's host path, which tests/test_stem.py
    holds equal to its device path)."""
    x = rng.standard_normal((h, w, c)).astype(np.float32)
    want = j_phases(x)
    got_np = extract_stem_phases(x)
    got_t = extract_stem_phases(torch.from_numpy(x))
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    assert got_np.shape == want.shape
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("h,w,cin,cout,dtype", [
    (65, 129, 3, 64, "float32"), (33, 47, 4, 8, "bfloat16")])
def test_stem_conv_plain_matches_jax(rng, h, w, cin, cout, dtype, relu):
    x = rng.standard_normal((h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    out_hw = ((h + 1) // 2, (w + 1) // 2)
    ph = j_phases(x)
    want = np.asarray(j_stem_conv(jnp.asarray(ph).astype(dtype),
                                  jnp.asarray(k), jnp.asarray(b), out_hw,
                                  relu=relu).astype(jnp.float32))
    tph = torch.from_numpy(ph)[None].to(getattr(torch, dtype))
    tk = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())  # OIHW
    before = dict(kernels.LAUNCHES)
    got = kernels.stem_conv3x3_s2(tph, tk, torch.from_numpy(b), out_hw,
                                  relu=relu)
    # the CPU path runs the plain version and never counts a launch
    assert kernels.LAUNCHES == before
    assert got.dtype == tph.dtype and tuple(got.shape) == (1, cout) + out_hw
    got = got[0].permute(1, 2, 0).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        bf16_close(got, want)


def _fcn(build):
    """tests/test_stem.py's FCN on ResNet-50."""
    return build("simple", backbone="resnet50",
                 backbone_para={"os": 32, "mg_unit": [1, 1, 1],
                                "inplanes": 128},
                 num_classes=7, align_corner=False, deepsup=False).graph


def test_stem_plan_matches_jax():
    want = j_stem_plan(_fcn(j_build_model))
    assert want is not None and want[0] == "image"
    assert stem_plan(_fcn(t_build_model)) == want


def _stem_graph(B, stem_stride=2):
    """A small deploy graph behind a thin 3x3 / s2 stem conv."""
    b = B("m")
    x = b.input("image")
    x = b.conv(x, "stem", out_ch=8, kernel=3, stride=stem_stride)
    x = b.relu(b.bn(x, "stem_bn"), "stem_relu")
    x = b.conv(x, "c2", out_ch=8, kernel=3)
    x = b.relu(b.bn(x, "c2_bn"), "c2_relu")
    x = b.conv(x, "cls", out_ch=5, kernel=1, padding=0, bias=True)
    b.resize(x, "pred", to_input=True, align_corners=True)
    return b.finish(["pred"])


def _np_params(graph, seed):
    r = np.random.default_rng(seed)
    params, state = {}, {}
    for node in graph.toposorted():
        a = node.attrs
        if node.op == "conv":
            bound = 1.0 / math.sqrt(a["kernel"] ** 2 * a["in_ch"])
            p = {"kernel": r.uniform(-bound, bound, (a["kernel"], a["kernel"],
                                                     a["in_ch"], a["out_ch"]))}
            if a["bias"]:
                p["bias"] = r.uniform(-bound, bound, a["out_ch"])
            params[node.name] = {k: v.astype(np.float32) for k, v in p.items()}
        elif node.op == "bn":
            ch = a["channels"]
            params[node.name] = {
                "scale": r.uniform(0.5, 1.5, ch).astype(np.float32),
                "bias": r.normal(0.0, 0.1, ch).astype(np.float32)}
            state[node.name] = {
                "mean": r.normal(0.0, 0.1, ch).astype(np.float32),
                "var": r.uniform(0.5, 1.5, ch).astype(np.float32)}
    return params, state


def test_phases_inference_matches_jax(rng):
    """f32, phases input: the same labels as the JAX package's phases
    path, exactly, and logits within 1e-5."""
    hw = (65, 97)
    jg, tg = _stem_graph(JBuilder), _stem_graph(TBuilder)
    params, state = _np_params(jg, 0)
    img = rng.standard_normal((1,) + hw + (3,)).astype(np.float32)
    phases = np.stack([j_phases(img[0])])
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    tp, ts = params_from_numpy(params, state, device="cpu")
    before = dict(kernels.LAUNCHES)
    out = {}
    for output in ("logits", "argmax"):
        jfn, jpp = jdeploy.make_inference_fn(
            jg, jp, js, dtype=jnp.float32, output=output,
            input_format="phases", input_hw=hw)
        tfn, tpp = tdeploy.make_inference_fn(
            tg, tp, ts, dtype=torch.float32, output=output,
            input_format="phases", input_hw=hw, device="cpu")
        out[output] = (np.asarray(jfn(jpp, jnp.asarray(phases))),
                       tfn(tpp, torch.from_numpy(phases)).numpy())
    jl, tl = out["logits"]
    assert tl.shape == jl.shape == (1,) + hw + (5,)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    ja, ta = out["argmax"]
    assert ta.dtype == np.uint8 and ta.shape == (1,) + hw
    np.testing.assert_array_equal(ta, ja)
    assert kernels.LAUNCHES == before
    # the port's phases path computes what its NHWC path does
    nfn, npp = tdeploy.make_inference_fn(tg, tp, ts, dtype=torch.float32,
                                         output="logits", device="cpu")
    np.testing.assert_allclose(nfn(npp, torch.from_numpy(img)).numpy(), tl,
                               rtol=0, atol=1e-5)


def test_phases_input_errors():
    tg = _stem_graph(TBuilder)
    tp, ts = params_from_numpy(*_np_params(_stem_graph(JBuilder), 0),
                               device="cpu")
    with pytest.raises(ValueError, match="input_hw"):
        tdeploy.make_inference_fn(tg, tp, ts, input_format="phases",
                                  device="cpu")
    flat = _stem_graph(TBuilder, stem_stride=1)  # no k3/s2 stem
    fp, fs = params_from_numpy(*_np_params(_stem_graph(JBuilder, 1), 0),
                               device="cpu")
    with pytest.raises(ValueError, match="stem conv"):
        tdeploy.make_inference_fn(flat, fp, fs, input_format="phases",
                                  input_hw=(9, 9), device="cpu")
    assert stem_plan(flat) is None
    assert tdeploy.infer_out_hw((1, 12, 40, 25), "phases", (33, 47)) == \
        (33, 47)


def test_stem_wrapper_rejects_bad_inputs():
    ph = torch.zeros(1, 12, 40, 25)
    k = torch.zeros(8, 3, 3, 3)
    with pytest.raises(ValueError, match="phase planes"):
        kernels.stem_conv3x3_s2(torch.zeros(1, 8, 40, 25), k, None, (17, 24))
    with pytest.raises(ValueError, match="too small"):
        kernels.stem_conv3x3_s2(ph, k, None, (40, 24))
    with pytest.raises(TypeError):
        kernels.stem_conv3x3_s2(ph.double(), k, None, (17, 24))
    with pytest.raises(ValueError, match="kernel"):
        kernels.stem_conv3x3_s2(ph, torch.zeros(8, 3, 1, 1), None, (17, 24))
    with pytest.raises(ValueError, match="bias"):
        kernels.stem_conv3x3_s2(ph, k, torch.zeros(7), (17, 24))


def test_prepared_weights_match_the_wrapper():
    """The phases deploy body runs K2 on weights prepared once
    (``stem_weights``): the same result as the wrapper, and bad prepared
    weights are refused."""
    g = torch.Generator().manual_seed(0)
    ph = torch.randn(2, 12, 40, 25, generator=g).bfloat16()
    k = torch.randn(8, 3, 3, 3, generator=g)
    b = torch.randn(8, generator=g)
    km, kb = kernels.stem_weights(k, b, ph.dtype, ph.device)
    assert km.shape == (27, 8) and km.dtype == kb.dtype == torch.float32
    for relu in (False, True):
        torch.testing.assert_close(
            kernels.stem_conv3x3_s2_prepared(ph, km, kb, (17, 24),
                                             relu=relu),
            kernels.stem_conv3x3_s2(ph, k, b, (17, 24), relu=relu),
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="prepared"):
        kernels.stem_conv3x3_s2_prepared(ph, km.bfloat16(), kb, (17, 24))
    with pytest.raises(ValueError, match="prepared"):
        kernels.stem_conv3x3_s2_prepared(ph, km.t(), kb, (17, 24))
    with pytest.raises(ValueError, match="too small"):
        kernels.stem_conv3x3_s2_prepared(ph, km, kb, (40, 24))
