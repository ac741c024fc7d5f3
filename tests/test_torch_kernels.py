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
