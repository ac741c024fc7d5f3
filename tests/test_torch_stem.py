"""The port's phase-plane stem (K2's plain version, the phase extraction,
``stem_plan`` and the ``phases`` deploy input) against the JAX package's,
on the CPU.

Inputs are made with numpy from a seed.  The JAX stem conv runs its
Pallas kernel in interpret mode, as tests/test_stem.py runs it; the CUDA
kernel is held against the plain version on the card by chip_smoke.py."""

import math
import pathlib

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
from dcfp_tpu_torch.ops.stem import (STEM_CARRY_ROWS, STEM_ROW_TILE,
                                     extract_stem_phases, stem_plan)


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


# ---------------------------------------------------------------------------
# K2's launch plan (``kernels.stem_conv_plan``): the shapes chip_smoke.py
# launches K2 at, and the arithmetic of its runs, footprints and slots
# ---------------------------------------------------------------------------

def _chip_cases():
    """chip_smoke.py's K2_CASES and K2_ODD, as (n, h, w, cin, cout, off)."""
    import sys
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke
    return ([c + (0,) for c in chip_smoke.K2_CASES] + list(chip_smoke.K2_ODD))


def _plane_shape(h, w):
    ho, wo = (h + 1) // 2, (w + 1) // 2
    hp = -(-(ho + 1) // STEM_ROW_TILE) * STEM_ROW_TILE + STEM_CARRY_ROWS
    return ho, wo, hp, wo + 1


# the chip's cases, then a run over many rows (Wo = 1), one pixel, and
# Wo = 1025 with a cout that shrinks the run
K2_PLAN_CASES = _chip_cases() + [(1, 40, 1, 3, 64, 0), (1, 1, 1, 4, 8, 0),
                                 (1, 1025, 2049, 3, 256, 0)]


def _segments(runs: dict, i: int, wo: int):
    """Segment k of run ``i``: (k, first staged column, exclusive end of
    the needed columns, staged width, first slot), as ``stage_run``."""
    segs, a0, w0, bl = (int(runs[k][i]) for k in ("segs", "a0", "w0", "bl"))
    out = []
    for k in range(segs):
        a = a0 if k == 0 else 0
        end = (bl if k == segs - 1 else wo - 1) + 2
        s = 0 if k == 0 else w0 + (k - 1) * runs["wfull"]
        out.append((k, a, end, (end - a + 1) & ~1, s))
    return out


def _slots(runs: dict, i: int, wo: int) -> np.ndarray:
    """Each pixel's slot in a staged line of run ``i`` (``slot_of``):
    where plane row oy, column ox of its segment sits."""
    p = int(runs["p0"][i]) + np.arange(int(runs["len"][i]))
    oy, ox = p // wo, p % wo
    k = oy - int(runs["oy0"][i])
    return np.where(k == 0, ox - int(runs["a0"][i]),
                    int(runs["w0"][i]) + (k - 1) * runs["wfull"] + ox)


def _koff(cin: int, line: int) -> np.ndarray:
    """The kernel's per-k table: where column k of A (k < 16 * ksteps,
    taps in (i, j, c) order) sits in a stage relative to a pixel's slot,
    ``(plane * 2 + i // 2) * line + j // 2``; -1 past the 9*cin taps."""
    ks = -(-9 * cin // 16)
    out = np.full(16 * ks, -1, np.int64)
    for k in range(9 * cin):
        i, j, c = k // (3 * cin), (k // cin) % 3, k % cin
        plane = ((i & 1) * 2 + (j & 1)) * cin + c
        out[k] = (plane * 2 + (i >> 1)) * line + (j >> 1)
    return out


@pytest.mark.parametrize("n,h,w,cin,cout,off", K2_PLAN_CASES)
def test_k2_plan_runs_cover_and_stage(n, h, w, cin, cout, off):
    """The plan's runs cover every output pixel once and its channel
    groups every channel once; each run's staged footprint holds every
    plane element its pixels' taps read, at the slot the kernel reads; the
    shared memory is the kernel's formula and fits 227 KB; 4-byte loads
    only where every staged word is 4-byte aligned and inside its row;
    the bulk store only where cout % 8 == 0."""
    ho, wo, hp, wp = _plane_shape(h, w)
    align = 16 if off == 0 else 2
    plan = kernels.stem_conv_plan(n, cin, cout, hp, wp, ho, wo, align)
    runs = kernels.k2_runs(plan.m, ho, wo)
    nruns = len(runs["p0"])
    assert plan.m % 16 == 0 and plan.threads == 256 and plan.stages == 2
    assert plan.ksteps == -(-9 * cin // 16)
    assert plan.tiles == n * nruns * plan.groups
    assert 1 <= plan.grid <= min(plan.tiles, 2 * 132)
    # runs: consecutive, m pixels each but the last, every pixel once
    np.testing.assert_array_equal(runs["p0"], np.arange(nruns) * plan.m)
    assert (runs["len"] >= 1).all() and int(runs["len"].sum()) == ho * wo
    # channel groups: cg chunks of 64 each, every channel once
    assert plan.chunks == -(-cout // 64) and plan.cg <= plan.chunks
    assert plan.groups == -(-plan.chunks // plan.cg)
    assert (plan.groups - 1) * plan.cg * 64 < cout <= plan.groups * plan.cg * 64
    # footprints
    assert plan.line % 2 == 0 and int(runs["width"].max()) == plan.line
    assert int(runs["segs"].max()) == plan.rows
    four = plan.load == "4-byte"
    for i in range(nruns):
        segs = _segments(runs, i, wo)
        p = int(runs["p0"][i]) + np.arange(int(runs["len"][i]))
        oy, ox = p // wo, p % wo
        k = oy - int(runs["oy0"][i])
        slots = _slots(runs, i, wo)
        assert k.min() == 0 and k.max() == len(segs) - 1
        prev_end = 0
        for kk, a, end, width, s in segs:
            assert s == prev_end and s % 2 == 0 and width % 2 == 0
            prev_end = s + width
            sel = k == kk
            # taps at ox and ox + 1, staged and loaded (both routes)
            assert (ox[sel] >= a).all() and (ox[sel] + 1 < end).all()
            assert end <= a + width and end <= wo + 1 <= wp
            np.testing.assert_array_equal(slots[sel], s + ox[sel] - a)
            if four:  # every word aligned, none past its row
                assert a % 2 == 0 and a + width <= wp
        assert prev_end == int(runs["width"][i]) <= plan.line
        assert int(runs["oy0"][i]) + len(segs) <= ho  # + 1 row < hp
    assert plan.smem == kernels._k2_smem(cin, cout, plan.m, plan.line,
                                         plan.cg, plan.groups,
                                         plan.store == "bulk")
    assert plan.smem <= 227 * 1024
    if four:
        assert wp % 2 == 0 and align % 4 == 0
    assert plan.load == ("4-byte" if wp % 2 == 0 and off == 0 else "2-byte")
    if plan.store == "bulk":
        assert cout % 8 == 0 and plan.groups == 1
    # cached: a request makes no new plan
    assert kernels.stem_conv_plan(n, cin, cout, hp, wp, ho, wo,
                                  align) is plan


def test_k2_plan_deploy_shape():
    """At the deploy shape: runs of 256 pixels (two output rows at most,
    a 260-element line), one chunk, two blocks an SM, 4-byte loads and
    one bulk copy a run; 2-byte loads when the phases start off 4
    bytes."""
    plan = kernels.stem_conv_plan(1, 3, 64, 536, 1026, 513, 1025, 16)
    assert (plan.m, plan.rows, plan.line, plan.cg, plan.groups) == \
        (256, 2, 260, 1, 1)
    assert (plan.tiles, plan.grid) == (2055, 264)
    assert (plan.load, plan.store) == ("4-byte", "bulk")
    assert 48 * 1024 < plan.smem <= kernels.K2_SMEM_SOFT
    odd = kernels.stem_conv_plan(1, 3, 64, 536, 1026, 513, 1025, 2)
    assert odd.load == "2-byte" and odd.smem == plan.smem


def test_k2_plan_rejects_bad_shapes():
    with pytest.raises(ValueError, match="bad shape"):
        kernels.stem_conv_plan(1, 5, 64, 40, 25, 17, 24, 16)
    with pytest.raises(ValueError, match="too small"):
        kernels.stem_conv_plan(1, 3, 64, 17, 25, 17, 24, 16)


def _emulate_k2(planes, km, b, out_hw, relu, plan):
    """K2's index arithmetic in Python: for each tile, stage the run's
    footprint as ``stage_run`` does, gather A through the slots and the
    per-k table (zero past the taps), multiply by the tile's channels of
    ``km`` and add the bias; the runs land in a channels_last buffer."""
    n, _, hp, wp = planes.shape
    ho, wo = out_hw
    cin, cout = km.shape[0] // 9, km.shape[1]
    runs = kernels.k2_runs(plan.m, ho, wo)
    koff = _koff(cin, plan.line)
    kmp = torch.zeros(16 * plan.ksteps, cout)
    kmp[:9 * cin] = km
    out = torch.full((n * ho * wo, cout), float("nan"))
    for img in range(n):
        for i in range(len(runs["p0"])):
            st = torch.zeros(8 * cin, plan.line)
            oy0 = int(runs["oy0"][i])
            for k, a, end, width, s in _segments(runs, i, wo):
                stop = a + width if plan.load == "4-byte" else end
                for line in range(8 * cin):
                    row = planes[img, line // 2, oy0 + k + line % 2]
                    st[line, s:s + stop - a] = row[a:stop]
            flat = st.reshape(-1)
            slots = torch.from_numpy(_slots(runs, i, wo))
            idx = slots[:, None] + torch.from_numpy(koff)[None, :]
            a_mat = torch.where(torch.from_numpy(koff)[None, :] >= 0,
                                flat[idx.clamp_min(0)], torch.zeros(()))
            p0 = img * ho * wo + int(runs["p0"][i])
            for g in range(plan.groups):
                c0 = g * plan.cg * 64
                c1 = min(cout, c0 + plan.cg * 64)
                y = a_mat @ kmp[:, c0:c1] + b[c0:c1]
                out[p0:p0 + len(slots), c0:c1] = torch.relu(y) if relu else y
    return out.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,cin,cout,align", [
    (1, 33, 47, 1, 24, 16), (2, 21, 9, 2, 64, 16), (1, 27, 40, 3, 96, 16),
    (1, 17, 33, 4, 8, 2), (1, 9, 13, 3, 2048, 16), (1, 5, 130, 3, 42, 16)])
def test_k2_emulation_equals_plain(n, h, w, cin, cout, align, relu):
    """The plan's runs, staged footprints, slots and per-k table, walked in
    Python, give ``_stem_plain`` exactly in f32 (small integers, so every
    sum is exact in any order), for cin 1-4, cout below, at and above 64,
    channel groups, and both load routes."""
    ho, wo, hp, wp = _plane_shape(h, w)
    r = np.random.default_rng(cin * 100 + cout)
    planes = torch.from_numpy(
        r.integers(-4, 5, (n, 4 * cin, hp, wp)).astype(np.float32))
    km = torch.from_numpy(r.integers(-3, 4, (9 * cin, cout)).astype(np.float32))
    b = torch.from_numpy(r.integers(-8, 9, cout).astype(np.float32))
    plan = kernels.stem_conv_plan(n, cin, cout, hp, wp, ho, wo, align)
    if cout == 2048:
        assert plan.groups > 1
    want = kernels._stem_plain(planes, km, b, (ho, wo), relu)
    got = _emulate_k2(planes, km, b, (ho, wo), relu, plan)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
