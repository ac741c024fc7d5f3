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
    with pytest.raises(ValueError, match="aspp_weights"):
        port.aspp_weights(torch.zeros(8, 16, 3, 3), torch.zeros(8, 16, 1, 1),
                          torch.zeros(8, 16, 3, 3))
    assert kernels.LAUNCHES == before
