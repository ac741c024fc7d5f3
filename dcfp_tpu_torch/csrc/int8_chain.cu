// K6: the fused int8 bottleneck chain of the int8 probe, for Hopper.
//
// Replaces tools/exp_int8.py `_chain_kernel` (the TPU kernel behind
// `chain_int8`).  For x (H0 + 2D, W, Cin) int8, whose first and last D
// rows are real input rows (the halo), and int8 weights W1 (Cin -> Cm),
// W2 (9 taps, Cm -> Cm), W3 (Cm -> Cout) with f32 scales s1, s2, s3:
//
//   y1  = requant(x W1, s1)                    all H0 + 2D rows
//   y2  = requant(sum_taps y1[tap] W2[tap], s2)  3x3, dilation D, y1's
//                                             columns zero-padded by D
//   out = bf16(float(y2 W3) * s3)              (H0, W, Cout)
//
// with requant(a, s) = int8(clip(rint(float(a) * s), 0, 127)): one f32
// conversion, one f32 multiply, round half to even, ReLU as the lower
// clip.  Every sum is an exact int32 on the tensor cores, so the result
// is bit-exact.  The int32 sums, y1 and y2 never leave the chip.
//
// Tiling (csrc/mma_tile.cuh): a block owns TH x TW = 4 x 32 output
// pixels.  It computes y1 on the (TH + 2D) x (TW + 2D) grid of pixels
// its taps read (8 x 36 at D = 2; columns outside the image are zero
// after the requant, rows are real input rows) into shared memory, in
// chunks of 128 grid pixels by 128 channels, with x and W1 staged 64
// channels deep by cp.async.  The 3x3 then reads its A fragments from
// the y1 grid at each tap's row shift (ldmatrix takes a row address per
// lane), and y2 goes to shared memory for the last 1x1 and its bf16
// store.  y1 on the grid costs (8 x 36) / (4 x 32) = 2.25x the conv1
// work of the tile; a taller tile would not fit y1 at Cm 256 (78 KB).
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 1,979 TOP/s dense
// int8): at the probe's shape (H0 128, W 256, 1024 -> 256 -> 1024) it
// needs 73 GOP, ~37 us, against 103 MB, ~31 us: operations, barely; at
// the pruned R101's layer3 (129 x 257, 1024 -> 128 -> 1024) 27 GOP
// against 103 MB: bytes.  It takes about 0.43 and 0.31 ms on an H100 at
// 700 W (chip_smoke.py), 2-3x the bf16 cuDNN chain: mma.sync reaches
// about half of the dense int8 rate, conv1 is redone on the grid's ring
// (and its last 32-pixel chunk costs a full one), one block of 8 warps
// fits an SM, and each block restages the weights from L2; wgmma and a
// larger tile are the steps beyond.

#include "mma_tile.cuh"

namespace {

using namespace dcfp;

constexpr int kTH = 4, kTW = 32;  // output tile: rows x columns
static_assert(kTH * kTW == kTile, "one 128-pixel chunk of outputs");

__device__ __forceinline__ int requant(int a, float s) {
  const float f = rintf(__fmul_rn(__int2float_rn(a), s));
  return (int)fminf(fmaxf(f, 0.f), 127.f);
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(const unsigned char* __restrict__ x,
             const unsigned char* __restrict__ w1,
             const unsigned char* __restrict__ w2,
             const unsigned char* __restrict__ w3,
             float s1, float s2, float s3, __nv_bfloat16* __restrict__ out,
             int hp, int w, int cin, int cm, int cout, int d, int ldy) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                  // [kStages][kStage]
  unsigned char* ws = xs + kStages * kStage;  // [kStages][kStage]
  unsigned char* y1s = ws + kStages * kStage;  // [Qp][ldy]
  const int gw = kTW + 2 * d, q_all = (kTH + 2 * d) * gw;
  unsigned char* y2s = y1s + ((q_all + 15) / 16 * 16) * ldy;  // [128][ldy]

  const Lane ln;
  const int h0 = hp - 2 * d;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int cmp = (cm + 31) / 32 * 32;  // y1 / y2 columns, zero past cm
  int acc[4][4][4];
  const unsigned char* arow[4];

  // x element offset of y1 grid pixel q, or -1 outside the image's
  // columns or past the last input row
  auto grid_off = [&](int q) -> long long {
    const int gy = r0 + q / gw, gx = c0 - d + q % gw;
    if (q >= q_all || gy >= hp || gx < 0 || gx >= w) return -1;
    return ((long long)gy * w + gx) * cin;
  };

  // ---- 1. y1 = requant(x W1, s1) on the grid ----
  for (int qc = 0; qc < q_all; qc += kTile) {
    const int left = min(q_all - qc, kTile) - ln.wm * 64;
    const int mt_used = left <= 0 ? 0 : min(4, (left + 15) / 16);
    for (int co0 = 0; co0 < cmp; co0 += kTile) {
      zero(acc);
      pipeline(
          (cin + kKb - 1) / kKb,
          [&](int s, int buf) {
            unsigned char* dst = xs + buf * kStage;
            for (int e = threadIdx.x; e < kTile * (kKb / 16); e += kThreads) {
              const int r = e / (kKb / 16), k = s * kKb + (e % (kKb / 16)) * 16;
              const long long off = grid_off(qc + r);
              const bool ok = off >= 0 && k < cin;
              cp_async16(dst + r * kLd + (e % (kKb / 16)) * 16,
                         ok ? x + off + k : x, ok);
            }
            stage_rows(ws + buf * kStage, w1, cin, cm, cin, co0, s * kKb);
          },
          [&](int, int buf) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              arow[i] = xs + buf * kStage +
                        (ln.wm * 64 + i * 16 + ln.ar) * kLd + ln.ak;
            warp_step(acc, arow, mt_used, ws + buf * kStage, ln, 2);
          });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = co0 + ln.wn * 32 + j * 8 + ln.t * 2;
          if (c >= cmp) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = qc + ln.wm * 64 + i * 16 + ln.g + 8 * h;
            if (q >= q_all) continue;
            const bool inside = grid_off(q) >= 0;
            const int v0 = inside && c < cm ? requant(acc[i][j][2 * h], s1) : 0;
            const int v1 =
                inside && c + 1 < cm ? requant(acc[i][j][2 * h + 1], s1) : 0;
            *reinterpret_cast<uint16_t*>(y1s + q * ldy + c) =
                (uint16_t)(v0 | (v1 << 8));
          }
        }
      }
    }
  }

  // ---- 2. y2 = requant(3x3 dilated conv of y1, s2) on the tile ----
  const int ksteps = (cmp + kKb - 1) / kKb;
  int grow[4];  // y1 grid row of this lane's ldmatrix row, per m-tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ln.wm * 64 + i * 16 + ln.ar;
    grow[i] = (p / kTW) * gw + p % kTW;
  }
  for (int co0 = 0; co0 < cmp; co0 += kTile) {
    zero(acc);
    pipeline(
        9 * ksteps,
        [&](int s, int buf) {
          const int tap = s / ksteps, kk = s % ksteps;
          stage_rows(ws + buf * kStage, w2 + (long long)tap * cm * cm, cm, cm,
                     cm, co0, kk * kKb);
        },
        [&](int s, int buf) {
          const int tap = s / ksteps, kk = s % ksteps;
          const int shift = (tap / 3) * d * gw + (tap % 3) * d;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            arow[i] = y1s + (grow[i] + shift) * ldy + kk * kKb + ln.ak;
          warp_step(acc, arow, 4, ws + buf * kStage, ln,
                    min(2, (cmp - kk * kKb) / 32));
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = co0 + ln.wn * 32 + j * 8 + ln.t * 2;
        if (c >= cmp) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = ln.wm * 64 + i * 16 + ln.g + 8 * h;
          const int v0 = c < cm ? requant(acc[i][j][2 * h], s2) : 0;
          const int v1 = c + 1 < cm ? requant(acc[i][j][2 * h + 1], s2) : 0;
          *reinterpret_cast<uint16_t*>(y2s + p * ldy + c) =
              (uint16_t)(v0 | (v1 << 8));
        }
      }
    }
  }

  // ---- 3. out = bf16(float(y2 W3) * s3) ----
#pragma unroll
  for (int i = 0; i < 4; ++i)
    arow[i] = y2s + (ln.wm * 64 + i * 16 + ln.ar) * ldy + ln.ak;
  for (int co0 = 0; co0 < cout; co0 += kTile) {
    zero(acc);
    pipeline(
        ksteps,
        [&](int s, int buf) {
          stage_rows(ws + buf * kStage, w3, cm, cout, cm, co0, s * kKb);
        },
        [&](int s, int buf) {
          const unsigned char* a3[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a3[i] = arow[i] + s * kKb;
          warp_step(acc, a3, 4, ws + buf * kStage, ln,
                    min(2, (cmp - s * kKb) / 32));
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = co0 + ln.wn * 32 + j * 8 + ln.t * 2;
        if (c >= cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = ln.wm * 64 + i * 16 + ln.g + 8 * h;
          const int oy = r0 + p / kTW, ox = c0 + p % kTW;
          if (oy >= h0 || ox >= w) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((long long)oy * w + ox) * cout + c) =
              __floats2bfloat162_rn(
                  __fmul_rn(__int2float_rn(acc[i][j][2 * h]), s3),
                  __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s3));
        }
      }
    }
  }
}

// Dynamic shared memory (bytes): the staging buffers, then y1 on the
// grid and y2 on the tile, rows of Cm rounded up to 32 plus 16 bytes.
size_t smem_bytes(int cm, int d) {
  const size_t ldy = (cm + 31) / 32 * 32 + 16;
  const size_t q = (size_t)(kTH + 2 * d) * (kTW + 2 * d);
  return 2 * (size_t)kStages * kStage + ((q + 15) / 16 * 16 + kTile) * ldy;
}

}  // namespace

// Plain C entry, loaded with ctypes.  x (hp, w, cin) int8 contiguous;
// weights int8, contiguous, [output][input]: w1 (cm, cin), w2 (9, cm, cm)
// with taps (ky * 3 + kx), w3 (cout, cm); s1, s2, s3 the f32 scales;
// out (hp - 2d, w, cout) bf16.  Needs cin % 16 == 0, cm % 16 == 0, cout
// even, x and the weights 16-byte aligned, and smem_bytes(cm, d) within
// the device's limit; the wrapper checks.  Launches on `stream`, which
// must belong to the current device, and returns cudaGetLastError() (0
// on success); it does not synchronise.
extern "C" int dcfp_chain_int8(const void* x, const void* w1, const void* w2,
                               const void* w3, float s1, float s2, float s3,
                               void* out, int hp, int w, int cin, int cm,
                               int cout, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || hp <= 2 * d || w < 1 || cin < 16 || cin % 16 || cm < 16 ||
      cm % 16 || cout < 2 || cout % 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cm, d);
  if (const int e = set_smem((const void*)chain_kernel, smem)) return e;
  const dim3 grid((w + kTW - 1) / kTW, (hp - 2 * d + kTH - 1) / kTH);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int ldy = (cm + 31) / 32 * 32 + 16;
  chain_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const unsigned char*>(x),
      static_cast<const unsigned char*>(w1),
      static_cast<const unsigned char*>(w2),
      static_cast<const unsigned char*>(w3),
      s1, s2, s3, static_cast<__nv_bfloat16*>(out), hp, w, cin, cm, cout, d,
      ldy);
  return (int)cudaGetLastError();
}
