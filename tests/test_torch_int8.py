"""The port's int8 probe ops (K5 ``tiled_mm``, K6 ``chain_int8`` and what
drives them) against the probe ``tools/exp_int8.py``, on the CPU.

Inputs are made with numpy from a seed.  The probe's Pallas kernels run
in interpret mode; the port's wrappers take their plain versions for CPU
tensors.  The CUDA kernels are held against the plain versions on the
card by chip_smoke.py."""

import importlib
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcfp_tpu_torch.ops import int8 as port
from dcfp_tpu_torch.ops import kernels

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
D = port.D


@pytest.fixture(scope="module")
def probe():
    """tools/exp_int8.py, imported with its compile cache off: with the
    cache on, its import would change JAX's process-wide config."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCFP_COMPILE_CACHE", "0")
        mp.syspath_prepend(str(TOOLS))
        yield importlib.import_module("exp_int8")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chain_inputs(rng, h0, w, cin, cm, cout):
    """The probe's draws (exp_int8.py stage B): random halo rows too."""
    x8 = rng.integers(-64, 64, (h0 + 2 * D, w, cin)).astype(np.int8)
    w1 = rng.integers(-16, 16, (cin, cm)).astype(np.int8)
    w2 = rng.integers(-16, 16, (9, cm, cm)).astype(np.int8)
    w3 = rng.integers(-16, 16, (cm, cout)).astype(np.int8)
    return x8, w1, w2, w3


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_tiled_mm_plain_matches_pallas(probe, rng, dtype):
    """M 1024 (two of the probe's 512-row tiles): int8 exactly; bf16 within
    1e-5 x (|a| @ |b|) elementwise."""
    m, k, n = 1024, 64, 32
    if dtype == "int8":
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta, tb = _t(a), _t(b)
    else:
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        ta, tb = _t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16)
    want = np.asarray(probe.pallas_mm(ja, jb, interpret=True))
    before = dict(kernels.LAUNCHES)
    got = port.tiled_mm(ta, tb)
    assert kernels.LAUNCHES == before  # the CPU path launches nothing
    assert got.shape == (m, n)
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        mag = np.abs(np.asarray(ja, np.float32)) @ np.abs(
            np.asarray(jb, np.float32))
        assert (np.abs(got.numpy() - want) <= 1e-5 * mag).all()


def test_tiled_mm_plain_ragged_m():
    """Every row for M off any tile (the TPU kernel leaves the tail
    unwritten): the exact integer product."""
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, (1000, 48)).astype(np.int8)
    b = rng.integers(-128, 128, (48, 20)).astype(np.int8)
    got = port.tiled_mm(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("h0,w", [(8, 16), (4, 13)])
def test_chain_plain_bit_exact_vs_pallas(probe, rng, h0, w):
    """Bit for bit against the probe's kernel in interpret mode, with
    random halo rows (a kernel that zeroed them would differ: checked)
    and, in the second case, W not a multiple of 8."""
    cin, cm, cout = 32, 16, 32
    x8, w1, w2, w3 = _chain_inputs(rng, h0, w, cin, cm, cout)
    scales = (0.02, 0.01, 2e-3)
    want = np.asarray(probe.chain_int8(
        jnp.asarray(x8), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(w3),
        scales, th=4, interpret=True))
    args = [_t(v) for v in (x8, w1, w2, w3)]
    before = dict(kernels.LAUNCHES)
    got = port.chain_int8(*args, scales)
    assert kernels.LAUNCHES == before
    assert got.dtype == torch.bfloat16 and got.shape == (h0, w, cout)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    # the data exercises the requant: zeros, clipped and mid values
    assert 0.2 < float((got != 0).float().mean()) < 1.0
    # the halo rows feed the 3x3: zeroing them changes the answer
    x0 = x8.copy()
    x0[:D] = 0
    x0[-D:] = 0
    zeroed = port.chain_int8(_t(x0), *args[1:], scales)
    assert not torch.equal(zeroed, got)


def test_chain_plain_any_h0_vs_numpy(probe, rng):
    """H0 = 7, not a multiple of the TPU kernel's 4-row tile, against the
    probe's float reference ``_chain_numpy`` rounded to bf16.  The scales
    are powers of two, so each product with a scale is exact in both the
    reference's float64 and the port's f32 and the two agree bit for bit."""
    h0, w, cin, cm, cout = 7, 11, 48, 32, 16
    x8, w1, w2, w3 = _chain_inputs(rng, h0, w, cin, cm, cout)
    scales = (2.0 ** -6, 2.0 ** -7, 2.0 ** -9)
    want = probe._chain_numpy(*(v.astype(np.int64) for v in (x8, w1, w2, w3)),
                              scales)
    got = port.chain_int8(*(_t(v) for v in (x8, w1, w2, w3)), scales)
    assert got.shape == (h0, w, cout)
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(want).to(torch.bfloat16).float().numpy())
    assert float((got != 0).float().mean()) > 0.2


def test_chain_blocks_matches_jax_loop(probe, rng):
    """Two blocks of ``chain_int8_blocks`` against the probe's stage-B loop
    written out with its ``chain_int8``: requant x 50, clip -64..63, pad D
    rows; equal int8 carries."""
    h0, w, c, cm = 8, 12, 32, 16
    x8, w1, w2, w3 = _chain_inputs(rng, h0, w, c, cm, c)
    scales = (0.02, 0.01, 1e-3)
    x = jnp.asarray(x8)
    for _ in range(2):
        out = probe.chain_int8(x, jnp.asarray(w1), jnp.asarray(w2),
                               jnp.asarray(w3), scales, th=4, interpret=True)
        nxt = jnp.clip(jnp.round(out.astype(jnp.float32) * 50.0), -64,
                       63).astype(jnp.int8)
        x = jnp.pad(nxt, ((D, D), (0, 0), (0, 0)))
    want = np.asarray(x)
    got = port.chain_int8_blocks(*(_t(v) for v in (x8, w1, w2, w3)), scales,
                                 blocks=2)
    assert got.dtype == torch.int8 and got.shape == x8.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 10  # the carry is not saturated or zero
    np.testing.assert_array_equal(
        port.chain_int8_blocks_plain(*(_t(v) for v in (x8, w1, w2, w3)),
                                     scales, blocks=2).numpy(), want)


def test_chain_bf16_matches_jax(probe, rng):
    """The bf16 yardstick against the probe's ``chain_bf16`` (HWIO there,
    OIHW here); each conv rounds its f32 sums to bf16, so two
    implementations differ by a few bf16 ulps where an intermediate
    rounds the other way: within 2e-2 x max|out|."""
    h0, w, cin, cm, cout = 6, 10, 32, 16, 24
    x = (rng.standard_normal((h0 + 2 * D, w, cin)) * 0.5).astype(np.float32)
    k1 = (rng.standard_normal((1, 1, cin, cm)) * 0.2).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, cm, cm)) * 0.2).astype(np.float32)
    k3 = (rng.standard_normal((1, 1, cm, cout)) * 0.2).astype(np.float32)
    want = np.asarray(probe.chain_bf16(
        *(jnp.asarray(v, jnp.bfloat16) for v in (x, k1, k2, k3))), np.float32)
    got = port.chain_bf16(
        _t(x).to(torch.bfloat16),
        *(_t(k.transpose(3, 2, 0, 1)).to(torch.bfloat16)
          for k in (k1, k2, k3)))
    assert got.shape == (h0, w, cout) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_wrappers_reject_bad_inputs():
    """Wrong dtypes, shapes and devices raise before any launch; so do
    shapes the CUDA kernels cannot tile (their checks run before the
    build, so they are reachable here)."""
    before = dict(kernels.LAUNCHES)
    a8, b8 = torch.zeros(64, 32, dtype=torch.int8), torch.zeros(
        32, 16, dtype=torch.int8)
    with pytest.raises(TypeError):
        port.tiled_mm(a8.float(), b8.float())
    with pytest.raises(TypeError):
        port.tiled_mm(a8, b8.to(torch.bfloat16))
    with pytest.raises(ValueError, match="K"):
        port.tiled_mm(a8, torch.zeros(16, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="device"):
        port.tiled_mm(a8.to("meta"), b8.to("meta"))
    with pytest.raises(ValueError, match="K=24"):
        port.tiled_mm_launch(torch.zeros(64, 24, dtype=torch.int8),
                             torch.zeros(24, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="N=6"):
        port.tiled_mm_launch(a8, torch.zeros(32, 6, dtype=torch.int8))

    x8 = torch.zeros(8, 9, 32, dtype=torch.int8)
    w1, w2, w3 = (torch.zeros(s, dtype=torch.int8)
                  for s in ((32, 16), (9, 16, 16), (16, 32)))
    sc = (1.0, 1.0, 1.0)
    with pytest.raises(TypeError):
        port.chain_int8(x8.float(), w1, w2, w3, sc)
    with pytest.raises(ValueError, match="w2"):
        port.chain_int8(x8, w1, torch.zeros(9, 16, 8, dtype=torch.int8), w3,
                        sc)
    with pytest.raises(ValueError, match="w1"):
        port.chain_int8(x8, torch.zeros(16, 16, dtype=torch.int8), w2, w3,
                        sc)
    with pytest.raises(ValueError, match="halo"):
        port.chain_int8(x8[:4], w1, w2, w3, sc)
    with pytest.raises(ValueError, match="rank|H0"):
        port.chain_int8(x8[0], w1, w2, w3, sc)
    with pytest.raises(ValueError, match="3 scales"):
        port.chain_int8(x8, w1, w2, w3, (1.0, 1.0))
    with pytest.raises(ValueError, match="device"):
        port.chain_int8(*(t.to("meta") for t in (x8, w1, w2, w3)), sc)
    with pytest.raises(ValueError, match="Cout"):
        port.chain_int8_blocks(x8, w1, w2, torch.zeros(16, 8,
                                                       dtype=torch.int8),
                               sc, blocks=2)
    with pytest.raises(ValueError, match="multiples of 16"):  # Cin 24
        port.chain_int8_launch(
            torch.zeros(8, 9, 24, dtype=torch.int8),
            port.chain_int8_weights(torch.zeros(24, 16, dtype=torch.int8),
                                    w2, torch.zeros(16, 24,
                                                    dtype=torch.int8)), sc)
    with pytest.raises(ValueError, match="weights must be"):  # w2 [in][out]
        port.chain_int8_launch(x8, (w1.t(), w2.transpose(1, 2)[:, :8],
                                    w3.t()), sc)
    with pytest.raises(ValueError, match="weights must be"):  # not made
        port.chain_int8_launch(x8, (w1.t(), w2, w3.t()), sc)
    made = port.chain_int8_weights(w1, w2, w3)
    with pytest.raises(ValueError, match="weights must be"):  # not padded
        port.chain_int8_launch(x8, made._replace(w2=made.w2[:, :16, :16]),
                               sc)
    big = torch.zeros(32, 2048, dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):  # Cm 2048
        port.chain_int8_launch(x8, port.chain_int8_weights(
            big, torch.zeros(9, 2048, 2048, dtype=torch.int8), big.t()), sc)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("cin,cm,cout", [
    (1024, 256, 1024),  # the probe's stage B
    (48, 48, 40),       # chip_smoke.py's K6_ODD
    (64, 80, 42)])      # its K6_EDGE: Cm off the 128-byte row
def test_chain_weights_round_trip(cin, cm, cout):
    """K6's padded [output][input] weights hold the originals in their
    leading rows and columns and zeros everywhere else (multiples of 128:
    whole TMA boxes)."""
    rng = np.random.default_rng(cin + cm + cout)
    _, w1, w2, w3 = (_t(v) for v in _chain_inputs(rng, 1, 1, cin, cm, cout))
    cw = port.chain_int8_weights(w1, w2, w3)
    assert (cw.cm, cw.cout) == (cm, cout)
    cinp, cmp, coutp = (-(-v // 128) * 128 for v in (cin, cm, cout))
    assert cw.w1.shape == (cmp, cinp) and cw.w2.shape == (9, cmp, cmp)
    assert cw.w3.shape == (coutp, cmp)
    assert all(t.is_contiguous() for t in cw[:3])
    assert torch.equal(cw.w1[:cm, :cin].t(), w1)
    assert torch.equal(cw.w2[:, :cm, :cm].transpose(1, 2), w2)
    assert torch.equal(cw.w3[:cout, :cm].t(), w3)
    nonzero = sum(int((t != 0).sum()) for t in cw[:3])
    assert nonzero == sum(int((t != 0).sum()) for t in (w1, w2, w3))


def _chain_owned(size, d, t):
    """Outputs along one axis of each working block of csrc/int8_chain.cu:
    block ``res * n + k`` owns ``res + d * (k * t + i)`` for i < t and
    returns at once if its first one lies past the axis."""
    n = -(-(-(-size // d)) // t)
    return [[res + d * (k * t + i) for i in range(t)
             if res + d * (k * t + i) < size]
            for res in range(d) for k in range(n) if res + d * k * t < size]


@pytest.mark.parametrize("h0,w,cin,cm,cout", [
    (128, 256, 1024, 256, 1024),  # the probe's stage B
    (129, 257, 1024, 128, 1024),  # the pruned R101's layer3
    (7, 45, 48, 48, 40),          # chip_smoke.py's K6_ODD
    (9, 11, 64, 80, 42),          # its K6_EDGE: W below one tile
    (8, 16, 32, 16, 32),          # this file's CPU cases
    (7, 11, 48, 32, 16)])
def test_chain_tile_fits_and_covers(h0, w, cin, cm, cout):
    """The planned tile is within the kernel's limits (R*S <= 128 outputs
    on a grid of <= 192 y1 pixels, shared memory within a block's 227 KB
    at the planned ring depth), every output is owned by exactly one
    block, and a tile's grid reaches every input row and column its
    outputs' taps read."""
    r, s, stages = port.chain_tile(h0, w, cin, cm, cout)
    assert r * s <= 128 and (r + 2) * (s + 2) <= 192 and 2 <= stages <= 4
    assert port.chain_smem_bytes(r, s, cm, stages) <= 232448
    rows, cols = _chain_owned(h0, D, r), _chain_owned(w, D, s)
    assert sorted(y for b in rows for y in b) == list(range(h0))
    assert sorted(x for b in cols for x in b) == list(range(w))
    for b in rows:  # grid rows b[0] + D * i, i < r + 2: taps at +0, D, 2D
        assert {y + k * D for y in b for k in range(3)} <= {
            b[0] + D * i for i in range(r + 2)}
    for b in cols:  # grid columns b[0] + D * (i - 1), i < s + 2
        assert {x + k * D for x in b for k in (-1, 0, 1)} <= {
            b[0] + D * (i - 1) for i in range(s + 2)}


@pytest.mark.parametrize("cm,fits", [(128, True), (256, True), (512, True),
                                     (2048, False)])
def test_chain_smem(cm, fits):
    """K6's shared memory at the probe's stage-B shape: Cm 128 (the pruned
    layer3's), 256 (the probe's) and 512 fit a block's 227 KB on the
    planned tile; at Cm 2048 not even a 1 x 1 tile with a 2-slot ring
    fits, and the planner says so."""
    tile = port.chain_tile(128, 256, 1024, cm, 1024)
    if fits:
        assert port.chain_smem_bytes(tile[0], tile[1], cm, tile[2]) <= 232448
    else:
        assert tile is None
        assert port.chain_smem_bytes(1, 1, cm, 2) > 232448


@pytest.mark.parametrize("m,k,n,dtype,offset", [
    (1024, 1024, 1024, "int8", 0),     # the probe's 1024^3
    (1024, 1024, 1024, "bfloat16", 0),
    (1000, 1008, 200, "int8", 0),      # 200-byte b rows: no TMA stride
    (1000, 1008, 200, "bfloat16", 0),
    (64, 4096, 1024, "int8", 0),       # skinny M
    (64, 4096, 1024, "bfloat16", 0),
    (130, 16, 4, "int8", 4),           # N % 4, K 16 bytes, b off 16 bytes
    (70, 8, 6, "bfloat16", 0),         # N % 2 only, K 16 bytes
    (33, 24, 64, "bfloat16", 2)])      # b on a 4-byte boundary only
def test_mm_plan_admits_and_covers(m, k, n, dtype, offset):
    """Every shape and alignment the launch took before the wgmma
    redesign still passes its checks, and the planned grid of 128 x 64
    tiles covers M x N exactly (>= 128 blocks at 1024^2, for 132 SMs);
    b goes through the transpose when TMA cannot read it, and always for
    int8 (s8 wgmma takes B only K-major)."""
    dt = getattr(torch, dtype)
    a = torch.zeros(m, k, dtype=dt)
    buf = torch.zeros(k * n + 16, dtype=dt)
    start = -buf.data_ptr() % 16 // buf.element_size() + offset
    b = buf[start:start + k * n].view(k, n)
    assert b.data_ptr() % 16 == offset * buf.element_size() % 16
    plan = port.mm_launch_plan(a, b)
    gx, gy = plan["grid"]
    bm, bn = port.MM_TILE
    assert (gx - 1) * bn < n <= gx * bn and (gy - 1) * bm < m <= gy * bm
    if (m, n) == (1024, 1024):
        assert gx * gy >= 128
    assert plan["transpose_b"] == (dtype == "int8" or n % 8 != 0
                                   or b.data_ptr() % 16 != 0)
