"""K1 (resize-argmax) of the port on the CPU: its wrappers take the plain
PyTorch version there, which must give the JAX package's labels.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas.py does.  The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcfp_tpu.ops.pallas_kernels import resize_argmax as j_resize_argmax
from dcfp_tpu_torch.ops import kernels

# the cases of tests/test_pallas.py
CASES = [((1, 17, 33, 19), (65, 129), True),
         ((2, 16, 16, 7), (64, 64), False),
         ((1, 9, 9, 150), (33, 33), True)]


def _both(z):
    """numpy f32 -> (JAX array, torch tensor) of the same values."""
    return jnp.asarray(z), torch.from_numpy(z)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_hw,ac", CASES)
def test_plain_equals_jax(rng, shape, out_hw, ac, dtype):
    """Exact label equality: both interpolate with the same f32 matrices
    and round to the logits dtype before the compare; random normal
    logits leave no near-ties at the last bit."""
    z = rng.standard_normal(shape).astype(np.float32)
    jz, tz = _both(z)
    if dtype == "bfloat16":
        jz, tz = jz.astype(jnp.bfloat16), tz.to(torch.bfloat16)
    want = np.asarray(j_resize_argmax(jz, out_hw, ac, interpret=True))
    before = dict(kernels.LAUNCHES)
    got = kernels.resize_argmax(tz, out_hw, ac)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    got_cm = kernels.resize_argmax_cm(tz.permute(0, 3, 1, 2).contiguous(),
                                      out_hw, ac)
    np.testing.assert_array_equal(got_cm.numpy(), want)
    np.testing.assert_array_equal(
        kernels.resize_argmax_plain(tz, out_hw, ac).numpy(), want)
    # the CPU path runs the plain version and never counts a launch
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cm_matches_nhwc(rng, dtype):
    z = torch.from_numpy(rng.standard_normal((2, 11, 17, 19))
                         .astype(np.float32)).to(dtype)
    want = kernels.resize_argmax(z, (33, 65), True)
    got = kernels.resize_argmax_cm(z.permute(0, 3, 1, 2), (33, 65), True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ties_go_to_first_max():
    z = np.zeros((1, 4, 4, 5), np.float32)
    z[..., 1] = 3.0
    z[..., 3] = 3.0  # tie with channel 1 -> must pick 1
    want = np.asarray(j_resize_argmax(jnp.asarray(z), (8, 8), False,
                                      interpret=True))
    got = kernels.resize_argmax(torch.from_numpy(z), (8, 8), False).numpy()
    assert (got == 1).all()
    np.testing.assert_array_equal(got, want)


def test_taps_reproduce_matrix():
    """The kernel's tap tables hold the matrices' own weights: scattering
    them back gives each interpolation matrix bit for bit."""
    from dcfp_tpu_torch.ops.resize import _interp_matrix
    for (i, o, ac) in [(129, 1025, True), (257, 2049, True), (16, 64, False),
                       (1, 4, True), (8, 8, False), (17, 5, False)]:
        idx, wts = kernels._taps(i, o, ac, torch.device("cpu"))
        mat = np.zeros((o, i), np.float32)
        for r in range(o):
            for t in range(2):
                mat[r, idx[r, t]] += wts[r, t].item()
        np.testing.assert_array_equal(mat, _interp_matrix(i, o, ac))


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="classes"):
        kernels.resize_argmax(torch.zeros(1, 4, 4, 257), (8, 8))
    with pytest.raises(ValueError, match="classes"):
        kernels.resize_argmax_cm(torch.zeros(1, 300, 4, 4), (8, 8))
    for dt in (torch.int32, torch.uint8, torch.float64):
        with pytest.raises(TypeError):
            kernels.resize_argmax(torch.zeros(1, 4, 4, 3, dtype=dt), (8, 8))
    with pytest.raises(ValueError, match="rank"):
        kernels.resize_argmax(torch.zeros(4, 4, 3), (8, 8))


def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch):
    """The built library's name hashes its source and every shared header,
    so editing either rebuilds it; the six sources all exist."""
    from dcfp_tpu_torch.ops import cuda_build
    for name in kernels.SOURCES:
        assert (cuda_build.CSRC_DIR / f"{name}.cu").exists(), name
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = cuda_build._target("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = cuda_build._target("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, cuda_build._target("k")}) == 3
    assert first.parent == cuda_build.BUILD_DIR


# K1's planner on the shapes chip_smoke.py launches it at: the cases of
# phase_k1, those of K1_ODD, a down-sampling case, C = 1 and C = 256;
# then odd scales, down-sampling along rows and 21 classes (PASCAL VOC);
# then footprints that fit only past 96 KB or 48 KB, one output row,
# one output column, C = 256 up-sampled, and one output pixel.
PLAN_CASES = [((1, 19, 129, 257), (1025, 2049), True),
              ((1, 19, 17, 33), (65, 129), True),
              ((2, 7, 16, 16), (64, 64), False),
              ((1, 150, 9, 9), (33, 33), True),
              ((1, 171, 65, 129), (513, 1025), False),
              ((2, 19, 33, 61), (257, 481), True),
              ((1, 171, 17, 29), (131, 227), False),
              ((1, 5, 40, 257), (20, 100), False),
              ((1, 1, 9, 10), (37, 45), True),
              ((2, 256, 6, 7), (23, 27), True),
              ((1, 3, 257, 257), (100, 100), False),
              ((1, 1, 129, 257), (1025, 2049), True),
              ((1, 256, 65, 129), (513, 1025), False),
              ((2, 19, 9, 13), (65, 97), True),
              ((1, 40, 7, 9), (29, 35), False),
              ((1, 5, 40, 57), (20, 23), False),
              ((1, 19, 300, 40), (50, 160), False),
              ((1, 19, 65, 129), (129, 257), True),
              ((1, 21, 33, 65), (513, 1025), False),
              ((1, 19, 9, 1500), (33, 16), False),
              ((1, 19, 9, 1200), (33, 24), False),
              ((1, 7, 1, 50), (1, 200), True),
              ((1, 7, 50, 1), (200, 1), True),
              ((1, 256, 33, 65), (129, 257), True),
              ((1, 19, 129, 257), (1, 1), False)]


@pytest.mark.parametrize("shape,out_hw,ac", PLAN_CASES)
def test_plan_tiles_cover_and_fit(shape, out_hw, ac):
    """The plan's tiles cover every output pixel exactly once, each
    tile's footprint (rows ytap[y0].x .. + span_r, columns xtap[x0].x ..
    + span_c) holds every tap of its pixels, the shared memory is the
    kernel's formula and fits 227 KB, and the channel chunks walk the
    channels once, in ascending order."""
    n, c, h, w = shape
    out_h, out_w = out_hw
    plan = kernels.resize_argmax_plan(n, c, h, w, out_h, out_w, ac)
    yi = kernels._tap_table(h, out_h, ac)[0]
    xi = kernels._tap_table(w, out_w, ac)[0]
    assert plan.p == kernels.K1_PIXELS and plan.tw % plan.p == 0
    assert plan.threads == plan.tr * plan.tw // plan.p <= 256
    assert plan.grid == (-(-out_w // plan.tw), -(-out_h // plan.tr), n)
    hits = np.zeros((out_h, out_w), np.int64)
    for by in range(plan.grid[1]):
        y0 = by * plan.tr
        rows = slice(y0, min(y0 + plan.tr, out_h))
        assert yi[rows].min() >= yi[y0, 0]
        assert yi[rows].max() < yi[y0, 0] + plan.span_r
        for bx in range(plan.grid[0]):
            x0 = bx * plan.tw
            cols = slice(x0, min(x0 + plan.tw, out_w))
            assert xi[cols].min() >= xi[x0, 0]
            assert xi[cols].max() < xi[x0, 0] + plan.span_c
            hits[rows, cols] += 1
    assert (hits == 1).all()
    assert plan.smem == kernels._k1_smem(plan.tr, plan.tw, plan.span_r,
                                         plan.span_c, c, plan.c_chunk)
    assert plan.smem <= 227 * 1024
    assert plan.c_chunk == kernels.K1_CHUNK
    walk = [ch for c0 in range(0, c, plan.c_chunk)
            for ch in range(c0, min(c0 + plan.c_chunk, c))]
    assert walk == list(range(c))
    # cached beside the tap tables: a request makes no new plan
    assert kernels.resize_argmax_plan(n, c, h, w, out_h, out_w, ac) is plan


def test_plan_deploy_shape():
    """At the deploy shape one block owns 8 x 256 outputs, all 19
    channels in one chunk, from a 2 x 33 footprint."""
    plan = kernels.resize_argmax_plan(1, 19, 129, 257, 1025, 2049, True)
    assert (plan.tr, plan.tw, plan.c_chunk) == (8, 256, 32)
    assert (plan.span_r, plan.span_c, plan.grid) == (2, 33, (9, 129, 1))
    assert plan.smem < 48 * 1024


@pytest.mark.parametrize("shape,out_hw,ac,match", [
    ((1, 19, 0, 257), (1025, 2049), True, "empty"),
    # one output column reaching 60k source columns needs > 227 KB
    ((1, 32, 2, 120000), (2, 9), False, "fits"),
    # a 1 x 8 tile of 20000 -> 8 columns stages the whole row
    ((1, 19, 129, 20000), (1025, 8), False, "fits")])
def test_plan_rejects_what_does_not_fit(shape, out_hw, ac, match):
    with pytest.raises(ValueError, match=match):
        kernels.resize_argmax_plan(*shape, *out_hw, ac)
