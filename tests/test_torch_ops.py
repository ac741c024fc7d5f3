"""The port's resize and pooling ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcfp_tpu.ops import pool as jpool
from dcfp_tpu.ops import resize as jresize
from dcfp_tpu_torch.ops import pool as tpool
from dcfp_tpu_torch.ops import resize as tresize


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("sizes", [(1, 4), (4, 1), (7, 21), (16, 5), (8, 8),
                                   (33, 65), (129, 1025), (257, 2049)])
def test_interp_matrix_equal(align, sizes):
    a = tresize._interp_matrix(sizes[0], sizes[1], align)
    b = jresize._interp_matrix(sizes[0], sizes[1], align)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sizes", [(13, 1), (13, 2), (17, 3), (65, 6),
                                   (6, 6), (5, 7)])
def test_adaptive_matrix_equal(sizes):
    np.testing.assert_array_equal(tpool._adaptive_matrix(*sizes),
                                  jpool._adaptive_matrix(*sizes))


# the shapes of tests/test_graph_ops.py's resize test
_RESIZE_SHAPES = [((7, 9), (21, 27)), ((16, 16), (5, 7)), ((8, 8), (8, 8)),
                  ((1, 1), (4, 4))]


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("shape", _RESIZE_SHAPES)
def test_resize_bilinear_f32(rng, align, shape):
    """f32: same matrices, f32 matmuls; atol 1e-6 covers summation order
    and FMA contraction differences between the two BLAS back ends."""
    (h, w), (oh, ow) = shape
    x = rng.standard_normal((2, h, w, 3), dtype=np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), (oh, ow), align))
    got = tresize.resize_bilinear(torch.from_numpy(x), (oh, ow), align)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    got_cf = tresize.resize_bilinear_cf(_nchw(x), (oh, ow), align)
    np.testing.assert_allclose(_nhwc(got_cf), want, rtol=0, atol=1e-6)
    want_cf = np.asarray(jresize.resize_bilinear_cf(
        jnp.asarray(x.transpose(0, 3, 1, 2)), (oh, ow), align))
    np.testing.assert_allclose(got_cf.numpy(), want_cf, rtol=0, atol=1e-6)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("shape", _RESIZE_SHAPES)
def test_resize_bilinear_bf16(rng, align, shape):
    """bf16 in, f32 interpolation, bf16 out.  A last-bit difference in
    the f32 value can move the final bf16 rounding by one bf16 ulp
    (2^-8 relative), hence rtol 2^-7."""
    (h, w), (oh, ow) = shape
    x = rng.standard_normal((2, h, w, 3), dtype=np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jresize.resize_bilinear(
        jnp.asarray(x).astype(jnp.bfloat16), (oh, ow), align)
        .astype(jnp.float32))
    got = tresize.resize_bilinear(xb, (oh, ow), align)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    got_cf = tresize.resize_bilinear_cf(xb.permute(0, 3, 1, 2), (oh, ow),
                                        align)
    np.testing.assert_allclose(_nhwc(got_cf), want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("kps", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_max_pool(rng, kps):
    """Max is exact; -inf padding on both sides."""
    x = rng.standard_normal((2, 13, 15, 4), dtype=np.float32)
    want = np.asarray(jpool.max_pool(jnp.asarray(x), *kps))
    np.testing.assert_array_equal(_nhwc(tpool.max_pool(_nchw(x), *kps)),
                                  want)


@pytest.mark.parametrize("out_size", [1, 2, 3, 6])
def test_adaptive_avg_pool(rng, out_size):
    """Same bin matrices, f32 matmuls: atol 1e-6 (summation order)."""
    x = rng.standard_normal((2, 13, 17, 4), dtype=np.float32)
    want = np.asarray(jpool.adaptive_avg_pool(jnp.asarray(x), out_size))
    got = tpool.adaptive_avg_pool(_nchw(x), out_size)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)


def test_global_avg_pool(rng):
    """A mean over 13x17 values: atol 1e-6 (summation order)."""
    x = rng.standard_normal((2, 13, 17, 4), dtype=np.float32)
    want = np.asarray(jpool.global_avg_pool(jnp.asarray(x)))
    got = tpool.global_avg_pool(_nchw(x))
    assert got.shape == (2, 4, 1, 1)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)


def test_resize_under_export_caches_no_fake_tensor(rng):
    """``torch.export`` traces with fake tensors: the interpolation
    matrices it makes stay out of the cache, and an eager call after the
    trace gets real ones and the exported program's result."""
    class Resize(torch.nn.Module):
        def forward(self, x):
            return tresize.resize_bilinear_cf(x, (9, 11), True)

    x = torch.from_numpy(rng.standard_normal((1, 2, 4, 5)).astype(np.float32))
    tresize._cached_interp_tensor.cache_clear()
    with torch.no_grad():
        exported = torch.export.export(Resize(), (x,), strict=False)
    assert tresize._cached_interp_tensor.cache_info().currsize == 0
    want = Resize()(x)
    assert type(tresize._interp_tensor(4, 9, True, x.device)) is torch.Tensor
    assert torch.equal(exported.module()(x), want)
