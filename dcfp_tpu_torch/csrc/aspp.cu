// K4: the three dilated ASPP branches in one kernel, for Hopper.
//
// Replaces tools/exp_aspp.py `_aspp_kernel` and `_aspp_kernel_kconcat`
// (two TPU schedules of the same function, behind `aspp_fused`).  For x
// (H, W, Cin) bf16 and weights Wt (27, Cout, Cin) bf16, tap
// b*9 + ky*3 + kx of branch b, it computes
//
//   out[y, x, b*Cout + o] = bf16(relu(sum_{ky, kx, c}
//       x[y + (ky-1)*d_b, x + (kx-1)*d_b, c] * Wt[b*9 + ky*3 + kx, o, c]))
//
// with d = (12, 24, 36), SAME zero padding, f32 sums and one rounding.
// x is read in place: a tap outside the image reads zeros (cp.async's
// zero fill), where the TPU wrapper first writes a padded copy of x.
//
// Tiling (csrc/mma_tile.cuh): a block owns 128 consecutive output pixels
// (row-major, so a tile may wrap a row) by 128 output channels, and runs
// the three branches one after another into the same f32 accumulators
// (64 per thread; all three at once would need 192).  Within a branch it
// walks Cin 32 channels at a time and, for each chunk, the 9 taps: the
// tap's 128 shifted pixels and the chunk of Wt go to shared memory by
// cp.async, four buffers deep, and run on mma.sync m16n8k16.  Every block
// takes the chunks in the same order, so blocks that run together read
// the same channels of neighbouring rows, and the taps they share come
// from L2.  ReLU and the bf16 rounding happen on the fragments.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense
// bf16): at the pruned R101's ASPP shape (129 x 257 x 2048 -> 3 x 128)
// the taps inside the image need 386 GFLOP (469 with all 27), ~390 us,
// against 175 MB, ~52 us: operations.  It takes about 1.9 ms on an H100
// at 700 W (chip_smoke.py), twice cuDNN's three convs: mma.sync reaches
// about half of the dense rate, taps wholly outside the image still run
// on zeros, and each block restages Wt (14 MB) from L2; wgmma with a TMA
// ring and a larger tile are the steps beyond.

#include "mma_tile.cuh"

namespace {

using namespace dcfp;

constexpr int kRuns = kKb / 16;  // 16-byte runs per staged row

__global__ void __launch_bounds__(kThreads)
aspp_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ wt,
            __nv_bfloat16* __restrict__ out, int h, int w, int cin, int cout,
            int d0, int d1, int d2) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* as = smem;                    // [kStages][kStage]
  unsigned char* bs = smem + kStages * kStage;  // [kStages][kStage]
  const Lane ln;
  const int hw = h * w;
  const int p0 = blockIdx.x * kTile, co0 = blockIdx.y * kTile;
  const int kbytes = cin * 2;
  const int ksteps = (kbytes + kKb - 1) / kKb;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(wt);
  const int left = hw - p0 - ln.wm * 64;
  const int mt_used = left <= 0 ? 0 : min(4, (left + 15) / 16);

  // this thread's two staging rows (pixels) of the A block
  int py[2], px[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = p0 + threadIdx.x / kRuns + i * (kThreads / kRuns);
    py[i] = p < hw ? p / w : -1 << 20;  // far outside: every tap misses
    px[i] = p < hw ? p % w : 0;
  }
  const unsigned char* arow[4];
  float acc[4][4][4];

  for (int b = 0; b < 3; ++b) {
    const int d = b == 0 ? d0 : b == 1 ? d1 : d2;
    zero(acc);
    pipeline(
        9 * ksteps,
        [&](int s, int buf) {
          const int kk = s / 9, tap = s % 9;
          const int dy = (tap / 3 - 1) * d, dx = (tap % 3 - 1) * d;
          const int run = (threadIdx.x % kRuns) * 16;
          const int k = kk * kKb + run;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = threadIdx.x / kRuns + i * (kThreads / kRuns);
            const int ty = py[i] + dy, tx = px[i] + dx;
            const bool ok =
                ty >= 0 && ty < h && tx >= 0 && tx < w && k < kbytes;
            cp_async16(as + buf * kStage + r * kLd + run,
                       ok ? xb + ((long long)ty * w + tx) * kbytes + k : xb, ok);
          }
          stage_rows(bs + buf * kStage,
                     wb + (long long)(b * 9 + tap) * cout * kbytes, kbytes,
                     cout, kbytes, co0, kk * kKb);
        },
        [&](int, int buf) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            arow[i] = as + buf * kStage + (ln.wm * 64 + i * 16 + ln.ar) * kLd +
                      ln.ak;
          warp_step(acc, arow, mt_used, bs + buf * kStage, ln, 2);
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = co0 + ln.wn * 32 + j * 8 + ln.t * 2;
        if (c >= cout) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = p0 + ln.wm * 64 + i * 16 + ln.g + 8 * hh;
          if (p >= hw) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              out + (long long)p * 3 * cout + b * cout + c) =
              __floats2bfloat162_rn(fmaxf(acc[i][j][2 * hh], 0.f),
                                    fmaxf(acc[i][j][2 * hh + 1], 0.f));
        }
      }
    }
  }
}

}  // namespace

// Plain C entry, loaded with ctypes.  x (h, w, cin) bf16 contiguous; wt
// (27, cout, cin) bf16 contiguous, taps b*9 + ky*3 + kx; out
// (h, w, 3*cout) bf16; d0..d2 the branches' dilations.  Needs
// cin % 8 == 0, cout even, x and wt 16-byte aligned; the wrapper checks.
// Launches on `stream`, which must belong to the current device, and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int dcfp_aspp_fused(const void* x, const void* wt, void* out,
                               int h, int w, int cin, int cout, int d0,
                               int d1, int d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || cin < 8 || cin % 8 || cout < 2 || cout % 2 ||
      d0 < 1 || d1 < 1 || d2 < 1)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)h * w;
  const dim3 grid((unsigned)((pixels + kTile - 1) / kTile),
                  (cout + kTile - 1) / kTile);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)kStages * kStage;
  if (const int e = set_smem((const void*)aspp_kernel, smem)) return e;
  aspp_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), static_cast<__nv_bfloat16*>(out),
      h, w, cin, cout, d0, d1, d2);
  return (int)cudaGetLastError();
}
