"""The port's fused bottleneck (K3's plain version and its wrapper) against
the JAX package's ``fused_bottleneck``, on the CPU.

Inputs are made with numpy from a seed.  The JAX op runs its Pallas
kernel in interpret mode, as tests/test_bottleneck.py runs it; the CUDA
kernel is held against the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dcfp_tpu.ops.bottleneck import fused_bottleneck as j_fused
from dcfp_tpu_torch.ops import kernels
from dcfp_tpu_torch.ops.bottleneck import (_tile, bottleneck_weights,
                                           fused_bottleneck,
                                           fused_bottleneck_launch,
                                           fused_bottleneck_plain,
                                           smem_bytes, tiles_per_axis)


def _weights(rng, cin, cm, bias=True):
    """tests/test_bottleneck.py's draws, HWIO as the JAX op takes them."""
    w1 = rng.standard_normal((1, 1, cin, cm)) * 0.05
    w2 = rng.standard_normal((3, 3, cm, cm)) * 0.05
    w3 = rng.standard_normal((1, 1, cm, cin)) * 0.05
    ws = [w.astype(np.float32) for w in (w1, w2, w3)]
    bs = ([rng.standard_normal(n).astype(np.float32) for n in (cm, cm, cin)]
          if bias else [None] * 3)
    return ws, bs


def _port_args(x, ws, bs, dtype):
    """HWC numpy -> (1, C, H, W) tensor, HWIO -> OIHW, biases f32."""
    tx = torch.from_numpy(x.transpose(2, 0, 1).copy())[None].to(dtype)
    tw = [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(dtype)
          for w in ws]
    tb = [None if b is None else torch.from_numpy(b) for b in bs]
    return tx, (tw[0], tb[0], tw[1], tb[1], tw[2], tb[2])


def _jax_args(x, ws, bs, dtype):
    return jnp.asarray(x, dtype), (
        jnp.asarray(ws[0], dtype), None if bs[0] is None else jnp.asarray(bs[0]),
        jnp.asarray(ws[1], dtype), None if bs[1] is None else jnp.asarray(bs[1]),
        jnp.asarray(ws[2], dtype), None if bs[2] is None else jnp.asarray(bs[2]))


@pytest.mark.parametrize("h,w,cin,cm,d", [(13, 17, 256, 128, 2),
                                          (9, 21, 256, 128, 4)])
def test_plain_matches_jax_f32(rng, h, w, cin, cm, d):
    """tests/test_bottleneck.py's cases at its tolerance; the biases are
    positive and negative, so the zero padding of t1 (not x) shows at
    the border."""
    x = rng.standard_normal((h, w, cin)).astype(np.float32)
    ws, bs = _weights(rng, cin, cm)
    jx, jargs = _jax_args(x, ws, bs, jnp.float32)
    want = np.asarray(j_fused(jx, *jargs, dilation=d))
    tx, targs = _port_args(x, ws, bs, torch.float32)
    before = dict(kernels.LAUNCHES)
    got = fused_bottleneck(tx, *targs, dilation=d)
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    assert got.shape == tx.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want,
                               rtol=2e-5, atol=2e-5)


def test_plain_matches_jax_bf16(rng):
    """tests/test_bottleneck.py's bf16 case, by its rule: max <= 0.15 and
    under 1% of values off by more than 0.05."""
    h, w, cin, cm, d = 12, 19, 256, 128, 2
    x = rng.standard_normal((h, w, cin)).astype(np.float32)
    ws, bs = _weights(rng, cin, cm, bias=False)
    jx, jargs = _jax_args(x, ws, bs, jnp.bfloat16)
    want = np.asarray(j_fused(jx, *jargs, dilation=d), np.float32)
    tx, targs = _port_args(x, ws, bs, torch.bfloat16)
    got = fused_bottleneck(tx, *targs, dilation=d)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got[0].permute(1, 2, 0).float().numpy() - want)
    assert diff.max() <= 0.15, diff.max()
    assert (diff > 0.05).mean() < 0.01


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_plain_matches_f32_chain_d16(rng, layout):
    """d = 16 (the pruned R101's layer4) against an f32 chain of convs,
    on a map smaller than the dilation in one axis, so most taps fall in
    the padding; the output keeps x's memory format."""
    cin, cm, d = 32, 16, 16
    x = torch.from_numpy(rng.standard_normal((2, cin, 20, 13))
                         .astype(np.float32))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    w1, w2, w3 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  * 0.1 for s in ((cm, cin, 1, 1), (cm, cm, 3, 3),
                                  (cin, cm, 1, 1)))
    b1, b2, b3 = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                  for n in (cm, cm, cin))
    t1 = F.relu(F.conv2d(x, w1, b1))
    t2 = F.relu(F.conv2d(t1, w2, b2, padding=d, dilation=d))
    want = F.relu(F.conv2d(t2, w3, b3) + x)
    got = fused_bottleneck(x, w1, b1, w2, b2, w3, b3, dilation=d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert got.is_contiguous(
        memory_format=torch.channels_last) == (layout == "channels_last")
    np.testing.assert_array_equal(
        fused_bottleneck_plain(x.contiguous(), w1, b1, w2, b2, w3, b3,
                               dilation=d).numpy(), got.numpy())


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(1, 8, 5, 5)
    w1, w2, w3 = torch.zeros(4, 8, 1, 1), torch.zeros(4, 4, 3, 3), \
        torch.zeros(8, 4, 1, 1)
    with pytest.raises(ValueError, match="rank|expected"):
        fused_bottleneck(x[0], w1, None, w2, None, w3, None)
    with pytest.raises(TypeError):
        fused_bottleneck(x.double(), w1, None, w2, None, w3, None)
    with pytest.raises(TypeError):
        fused_bottleneck(x.half(), w1, None, w2, None, w3, None)
    with pytest.raises(ValueError, match="w2"):
        fused_bottleneck(x, w1, None, torch.zeros(4, 4, 1, 1), None, w3, None)
    with pytest.raises(ValueError, match="w3"):
        fused_bottleneck(x, w1, None, w2, None, torch.zeros(4, 8, 1, 1), None)
    with pytest.raises(ValueError, match="w1"):
        fused_bottleneck(x, torch.zeros(4, 6, 1, 1), None, w2, None, w3, None)
    with pytest.raises(ValueError, match="b3"):
        fused_bottleneck(x, w1, None, w2, None, w3, torch.zeros(4))
    with pytest.raises(ValueError, match="dilation"):
        fused_bottleneck(x, w1, None, w2, None, w3, None, dilation=0)


def test_launch_rejects_misaligned_bf16():
    """K3's bf16 path reads x in 16-byte runs: a view that starts off a
    16-byte boundary is refused before anything is launched."""
    buf = torch.zeros(1 + 8 * 5 * 5, dtype=torch.bfloat16)
    x = buf[1:].view(1, 5, 5, 8).permute(0, 3, 1, 2)  # channels_last
    assert x.is_contiguous(memory_format=torch.channels_last)
    weights = bottleneck_weights(
        torch.zeros(4, 8, 1, 1), None, torch.zeros(4, 4, 3, 3), None,
        torch.zeros(8, 4, 1, 1), None, torch.bfloat16, x.device)
    with pytest.raises(ValueError, match="16-byte"):
        fused_bottleneck_launch(x, weights, dilation=1)


# the kernel's own launches: chip_smoke.py's K3 cases, the pruned R101's
# layer3/layer4 shapes, and ragged maps with dilations up to 16
_K3_SHAPES = [
    (12, 19, 2, 256, 128), (13, 17, 2, 256, 128), (16, 33, 1, 128, 128),
    (9, 21, 4, 256, 128), (11, 13, 3, 48, 24), (20, 37, 8, 64, 32),
    (21, 40, 16, 64, 32), (129, 257, 2, 1024, 128), (129, 257, 16, 2048, 256),
    (7, 5, 16, 64, 32), (33, 1, 3, 64, 64), (1, 50, 5, 64, 64),
    (100, 67, 16, 256, 256), (23, 29, 5, 52, 40)]


def _owned(size, d, t):
    """Output rows (or columns) of each block along one axis, with the
    kernel's index map: block ``res * n + k`` owns ``res + d * (k * t + i)``
    for i < t, and returns at once if its first one lies past the map."""
    n = -(-(-(-size // d)) // t)  # tiles per residue class in the grid
    blocks = []
    for res in range(d):
        for k in range(n):
            if res + d * k * t >= size:
                continue  # the early return
            blocks.append([res + d * (k * t + i) for i in range(t)
                           if res + d * (k * t + i) < size])
    return blocks


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("h,w,d,cin,cm", _K3_SHAPES)
def test_tiles_cover_every_output_once(h, w, d, cin, cm, itemsize):
    """The planned tiles cover every output pixel exactly once, and the
    blocks that do work are the ``tiles_per_axis`` the time model counts."""
    r, s, _ = _tile(h, w, d, cin, cm, itemsize)
    rows, cols = _owned(h, d, r), _owned(w, d, s)
    assert sorted(y for b in rows for y in b) == list(range(h))
    assert sorted(x for b in cols for x in b) == list(range(w))
    if itemsize == 2:
        assert len(rows) == tiles_per_axis(h, d, r)
        assert len(cols) == tiles_per_axis(w, d, s)


@pytest.mark.parametrize("h,w,d,cin,cm,itemsize", [
    (129, 257, 2, 1024, 128, 2),    # pruned R101 layer3, bf16
    (129, 257, 16, 2048, 256, 2),   # pruned R101 layer4, bf16
    (129, 257, 16, 2048, 256, 4),   # the same in f32
    (13, 17, 2, 256, 128, 4),       # tests/test_bottleneck.py, f32
    (11, 13, 3, 48, 24, 2)])        # cm and cin off the 64-wide boxes
def test_tile_fits_the_kernel(h, w, d, cin, cm, itemsize):
    """The CUDA kernel's tile: within its pixel limits (bf16 wgmma: 128
    outputs on a grid of 192; f32: 64 on 128) and shared memory with the
    ring's slots, and, with the kernel's own index map (block
    ``ry * n + t`` owns rows ``ry + d * (t * R + r)``), every output row
    and column belongs to exactly one tile position.  At the pruned
    R101's shapes the bf16 tiles are larger than the mma.sync kernel's
    64 outputs."""
    r, s, stages = _tile(h, w, d, cin, cm, itemsize)
    if itemsize == 2:
        assert r * s <= 128 and (r + 2) * (s + 2) <= 192
        assert 2 <= stages <= 4
        if h > 100:
            assert r * s > 64
    else:
        assert r * s <= 64 and (r + 2) * (s + 2) <= 128 and stages == 0
    assert smem_bytes(r, s, cm, itemsize, max(stages, 2)) <= 232448 - 2048
    for size, t in ((h, r), (w, s)):
        n = -(-(-(-size // d)) // t)  # tiles per residue class
        owned = [res + d * (k * t + i) for res in range(d) for k in range(n)
                 for i in range(t)]
        owned = [o for o in owned if o < size]
        assert sorted(owned) == list(range(size))


def test_bf16_weights_padded_for_tma():
    """bf16 weights are [output][input], zero-padded to multiples of 64
    (whole TMA boxes); the padding holds zeros and the rest the weights.
    f32 keeps [input][output], unpadded."""
    rng = np.random.default_rng(3)
    cin, cm = 48, 24
    w1, w2, w3 = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                  for sh in ((cm, cin, 1, 1), (cm, cm, 3, 3), (cin, cm, 1, 1)))
    p1, b1, p2, b2, p3, b3 = bottleneck_weights(w1, None, w2, None, w3, None,
                                                torch.bfloat16, "cpu")
    assert p1.shape == (64, 64) and p2.shape == (9, 64, 64)
    assert p3.shape == (64, 64)
    assert b1.shape == (cm,) and b3.shape == (cin,)
    assert torch.equal(p1[:cm, :cin], w1.reshape(cm, cin).bfloat16())
    assert torch.equal(p2[:, :cm, :cm], w2.permute(2, 3, 0, 1)
                       .reshape(9, cm, cm).bfloat16())
    assert torch.equal(p3[:cin, :cm], w3.reshape(cin, cm).bfloat16())
    for p, (r, c) in ((p1, (cm, cin)), (p3, (cin, cm))):
        assert not p[r:].any() and not p[:, c:].any()
    assert not p2[:, cm:].any() and not p2[:, :, cm:].any()
    f1, _, f2, _, f3, _ = bottleneck_weights(w1, None, w2, None, w3, None,
                                             torch.float32, "cpu")
    assert f1.shape == (cin, cm) and f2.shape == (9, cm, cm)
    assert f3.shape == (cm, cin)
