"""The port's ASPP probe ops (K4 ``aspp_fused``, its weight stack and the
cuDNN yardstick) against the probe ``tools/exp_aspp.py``, on the CPU.

Inputs are made with numpy from a seed.  The probe's Pallas kernel runs
in interpret mode, in both of its schedules; the port's wrapper takes its
plain version for CPU tensors.  The CUDA kernel is held against the plain
version on the card by chip_smoke.py."""

import importlib
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcfp_tpu_torch.bridge import params_from_numpy
from dcfp_tpu_torch.ops import aspp as port
from dcfp_tpu_torch.ops import kernels

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


@pytest.fixture(scope="module")
def probe():
    """tools/exp_aspp.py, imported with its compile cache off: with the
    cache on, its import would change JAX's process-wide config."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCFP_COMPILE_CACHE", "0")
        mp.syspath_prepend(str(TOOLS))
        yield importlib.import_module("exp_aspp")


def within_one_ulp(got, want):
    """Every value within 1 bf16 ulp of the other's, plus 1e-6 x max|want|
    near 0: two f32 sums of the same products in different orders round
    to bf16 values at most 1 ulp apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want)).clip(1e-30)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    err = np.abs(got - want)
    assert (err <= ulp + 1e-6 * np.abs(want).max()).all(), err.max()


def _inputs(probe, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((h, w, cin)) * 0.5, jnp.bfloat16)
    ks, stacked = probe.make_weights(rng, cin, cout)
    return x, ks, stacked


def _torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("kconcat", [False, True])
@pytest.mark.parametrize("h,w,cin,cout", [(20, 30, 256, 128),
                                          (80, 84, 128, 16)])
def test_plain_matches_pallas(probe, h, w, cin, cout, kconcat):
    """Both TPU schedules in interpret mode, within 1 bf16 ulp; the first
    shape is small beside the dilations (most taps fall in the padding),
    the second big enough that the d = 36 taps of the middle land inside
    the image (checked)."""
    x, _, stacked = _inputs(probe, h, w, cin, cout)
    want = np.asarray(probe.aspp_fused(x, stacked, interpret=True,
                                       kconcat=kconcat), np.float32)
    before = dict(kernels.LAUNCHES)
    got = port.aspp_fused(_torch(x), _torch(stacked))
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    assert got.shape == (h, w, 3 * cout) and got.dtype == torch.bfloat16
    within_one_ulp(got.float().numpy(), want)
    if h >= 80:
        assert h - 1 > 2 * max(port.DILATIONS) and w - 1 > 2 * max(
            port.DILATIONS)
        assert np.abs(want[:, :, 2 * cout:]).max() > 0


def test_aspp_convs_matches_xla(probe):
    """The yardstick against the probe's ``aspp_xla``, within 1 bf16 ulp."""
    x, ks, _ = _inputs(probe, 24, 40, 64, 32, seed=1)
    want = np.asarray(probe.aspp_xla(x, ks), np.float32)
    oihw = [_torch(k).permute(3, 2, 0, 1) for k in ks]
    got = port.aspp_convs(_torch(x), oihw)
    assert got.shape == (24, 40, 96)
    within_one_ulp(got.float().numpy(), want)


def test_aspp_weights_match_the_probe_stack(probe):
    """``aspp_weights`` of the OIHW kernels, converted from the probe's
    HWIO ones as ``bridge`` converts params, equals the probe's stack."""
    _, ks, stacked = _inputs(probe, 4, 4, 48, 24, seed=2)
    params, _ = params_from_numpy(
        {f"aspp.aspp{i}.atrous_conv": {"kernel": np.asarray(k, np.float32)}
         for i, k in enumerate(ks, start=2)}, {}, device="cpu")
    got = port.aspp_weights(*(params[f"aspp.aspp{i}.atrous_conv"]["kernel"]
                              for i in (2, 3, 4)))
    assert got.shape == (27, 48, 24) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(stacked, np.float32))


def test_wrapper_rejects_bad_inputs():
    """Wrong dtypes, shapes and devices raise before any launch; so do
    shapes the CUDA kernel cannot tile (its checks run before the build,
    so they are reachable here)."""
    before = dict(kernels.LAUNCHES)
    x = torch.zeros(5, 6, 16, dtype=torch.bfloat16)
    wts = torch.zeros(27, 16, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        port.aspp_fused(x.float(), wts.float())
    with pytest.raises(TypeError):
        port.aspp_fused(x, wts.float())
    with pytest.raises(ValueError, match="weights"):
        port.aspp_fused(x, wts[:26])
    with pytest.raises(ValueError, match="weights"):
        port.aspp_fused(x, torch.zeros(27, 8, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="H, W, Cin"):
        port.aspp_fused(x[None], wts)
    with pytest.raises(ValueError, match="device"):
        port.aspp_fused(x.to("meta"), wts.to("meta"))
    with pytest.raises(ValueError, match="Cin % 8"):  # Cin 12
        port.aspp_fused_launch(torch.zeros(5, 6, 12, dtype=torch.bfloat16),
                               torch.zeros(27, 8, 12, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        port.aspp_fused_launch(x.transpose(0, 1), wts.transpose(1, 2))
    with pytest.raises(ValueError, match="27, Cout, Cin"):  # not transposed
        port.aspp_fused_launch(x, wts)
    with pytest.raises(ValueError, match="27, Cout, Cin"):
        port.aspp_fused_launch(x, port.aspp_kernel_weights(wts).float())
    with pytest.raises(ValueError, match="27, Cout, Cin"):  # not padded
        port.aspp_fused_launch(x, wts.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="aspp_weights"):
        port.aspp_weights(torch.zeros(8, 16, 3, 3), torch.zeros(8, 16, 1, 1),
                          torch.zeros(8, 16, 3, 3))
    assert kernels.LAUNCHES == before


# the shapes chip_smoke.py and the probe run K4 at: stage B (the served
# pruned R101's layer4 output), stage N, and the edge shapes (K4_ODD,
# K4_NARROW, K4_SPARSE); then this file's CPU cases
SHAPES = [(129, 257, 2048, 128), (40, 61, 256, 128), (23, 37, 200, 72),
          (20, 9, 72, 64), (40, 50, 136, 192), (20, 30, 256, 128),
          (80, 84, 128, 16)]


def _blocks(h, w, r, s):
    """csrc/aspp.cu's pixel rectangles: block i starts at
    ((i // ntx) r, (i % ntx) s)."""
    ntx = -(-w // s)
    return [((i // ntx) * r, (i % ntx) * s)
            for i in range(-(-h // r) * ntx)]


@pytest.mark.parametrize("h,w,cin,cout", SHAPES)
def test_aspp_tile_fits_and_covers(h, w, cin, cout):
    """The planned rectangle is whole m-tiles (128 or 256 pixels, each side
    within a TMA box's 256), its ring fits a block's 227 KB, and the
    blocks own every output pixel exactly once."""
    r, s, stages = port.aspp_tile(h, w, cin, cout)
    assert r * s in (128, 256) and r <= 256 and s <= 256
    assert 2 <= stages <= 4
    assert port.aspp_smem_bytes(r, s, stages) <= 232448
    owned = np.zeros((h, w), np.int64)
    for y0, x0 in _blocks(h, w, r, s):
        for p in range(r * s):
            y, x = y0 + p // s, x0 + p % s
            if y < h and x < w:
                owned[y, x] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("h,w,cin,cout", SHAPES)
def test_live_taps_match_brute_force(h, w, cin, cout):
    """A block's live taps are exactly those for which one of its outputs
    inside the image reads a pixel inside the image; at the edge shapes
    some (block, branch) keeps only its centre tap."""
    r, s, _ = port.aspp_tile(h, w, cin, cout)
    fewest = 9
    for y0, x0 in _blocks(h, w, r, s):
        ys = np.arange(y0, min(y0 + r, h))[:, None]
        xs = np.arange(x0, min(x0 + s, w))[None, :]
        for d in port.DILATIONS:
            want = [tap for tap in range(9)
                    if ((0 <= ys + (tap // 3 - 1) * d)
                        & (ys + (tap // 3 - 1) * d < h)
                        & (0 <= xs + (tap % 3 - 1) * d)
                        & (xs + (tap % 3 - 1) * d < w)).any()]
            got = port.live_taps(y0, x0, r, s, h, w, d)
            assert got == want and 4 in got
            fewest = min(fewest, len(got))
    if (h, w) == (40, 50):
        assert fewest == 1


@pytest.mark.parametrize("h,w,cin,cout", [(40, 61, 256, 128),
                                          (23, 37, 200, 72)])
def test_dead_taps_add_nothing(h, w, cin, cout):
    """At stage N's shape and the odd one: for every block, the plain
    version with the weights of the block's dead taps zeroed (every
    branch at once) equals the full plain version on the block's outputs,
    bit for bit, in f32; so skipping them changes nothing."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((h, w, cin)).astype(np.float32))
    wts = torch.from_numpy(
        rng.standard_normal((27, cin, cout)).astype(np.float32))
    full = port.aspp_fused_plain(x, wts)
    r, s, _ = port.aspp_tile(h, w, cin, cout)
    groups = {}
    for y0, x0 in _blocks(h, w, r, s):
        live = tuple(tuple(port.live_taps(y0, x0, r, s, h, w, d))
                     for d in port.DILATIONS)
        groups.setdefault(live, []).append((y0, x0))
    assert len(groups) > 1
    for live, blocks in groups.items():
        zeroed = wts.clone()
        for b, taps in enumerate(live):
            for tap in set(range(9)) - set(taps):
                zeroed[b * 9 + tap] = 0
        got = port.aspp_fused_plain(x, zeroed)
        for y0, x0 in blocks:
            assert torch.equal(got[y0:y0 + r, x0:x0 + s],
                               full[y0:y0 + r, x0:x0 + s])


@pytest.mark.parametrize("cin,cout", [(2048, 128), (200, 72), (72, 64)])
def test_kernel_weights_round_trip(cin, cout):
    """K4's padded (27, Cout, Cinp) weights hold the (27, Cin, Cout) stack
    transposed in their leading Cin columns and zeros past them (Cinp a
    multiple of 64: whole TMA boxes)."""
    rng = np.random.default_rng(cin)
    wts = torch.from_numpy(rng.standard_normal((27, cin, cout)).astype(
        np.float32)).to(torch.bfloat16)
    wt = port.aspp_kernel_weights(wts)
    cinp = -(-cin // 64) * 64
    assert wt.shape == (27, cout, cinp) and wt.is_contiguous()
    assert wt.dtype == torch.bfloat16
    assert torch.equal(wt[:, :, :cin].transpose(1, 2), wts)
    assert not wt[:, :, cin:].any()
