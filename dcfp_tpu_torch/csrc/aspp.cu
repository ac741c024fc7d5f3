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
//
// Design (csrc/sm90_tile.cuh): an implicit GEMM whose shift lives in the
// TMA box's coordinates.  A block owns an R x S rectangle of output pixels
// (R*S = 128 or 256), 128 output channels and one branch, so the grid is
// (rectangles, 3 branches, Cout / 128).  For tap (ky, kx) and 64 input
// channels from c0, A is one 3D TMA box of x, (R, S, 64 channels = 128
// bytes), at (y0 + (ky-1) d, x0 + (kx-1) d, c0): TMA zero-fills what lies
// outside x, below 0 included, which is the SAME padding, and puts pixel
// r*S + s at row r*S + s of the 128-byte swizzle, where a wgmma
// descriptor reads it.  B is a TMA box of the weights (64 inputs x 128
// outputs, zero-filled past Cout; the wrapper pads Cin to whole boxes).
// One producer thread keeps a ring of 2-4 stages (A and B) full behind
// full/empty mbarriers; two consumer warpgroups take R*S / 128 m-tiles
// each and run wgmma m64n128k16 (bf16 in, f32 sums) from the ring, one
// stage's group in flight while the next is issued.
//
// Taps whose box lies wholly outside the image add exactly zero, so the
// producer and the consumers walk the same list of the block's live taps
// and skip the rest (at 129 x 257 and d = 36, 18% of all taps' work lies
// outside the image; more at smaller images).  The stages run channel
// chunk by chunk, every live tap within a chunk, so the blocks that run
// together read the same 64 channels of x (which at 129 x 257 x 2048 is
// larger than L2) while they are in L2.  ReLU and the one rounding to bf16
// happen on the accumulators, stored straight to out.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense
// bf16): at the pruned R101's ASPP shape (129 x 257 x 2048 -> 3 x 128)
// the taps inside the image need 386 GFLOP (469 with all 27), ~390 us,
// against 175 MB, ~52 us: operations.  Beyond the bound, the L2 traffic:
// a 256-pixel block reads per tap and 64 channels a 32 KB box of x and a
// 16 KB box of weights for 4.2 MFLOP, 85 FLOP a byte, about what an SM's
// share of L2 can feed to its tensor cores.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (k46_parts.py, CUDA events over 30 launches): about
// 0.67 ms at 8 x 32 with 4 slots, against 0.92 for cuDNN's three convs.
// The loads alone take 0.63 ms, the wgmmas with only the weight boxes
// 0.61 (77% of the dense rate on the work they run): both streams are
// near their limits.  All 27 taps took 0.95 ms, a 2-slot ring 1.42.
// Times: PERF.md (chip_smoke.py, pair_times.py).

#include "sm90_tile.cuh"

namespace {

using namespace sm90;

typedef __nv_bfloat16 bf16;
constexpr int kCons = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kCons + 1);  // + the producer warpgroup
constexpr int kNc = 128;                     // output channels per block
constexpr int kKc = 64;                      // input channels per stage
constexpr int kBBytes = kNc * 128;           // weight bytes per stage

// The block's live taps (ky * 3 + kx) in order: those whose shifted
// rectangle of the valid output pixels, rows y0 .. min(y0 + R, h) - 1 and
// columns x0 .. min(x0 + S, w) - 1, meets the image.  ops/aspp.py
// `live_taps` is the same rule.
__device__ __forceinline__ int live_taps(int (&taps)[9], int y0, int x0,
                                         int R, int S, int h, int w, int d) {
  const int y1 = min(y0 + R, h) - 1, x1 = min(x0 + S, w) - 1;
  int n = 0;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = (tap / 3 - 1) * d, dx = (tap % 3 - 1) * d;
    if (y0 + dy < h && y1 + dy >= 0 && x0 + dx < w && x1 + dx >= 0)
      taps[n++] = tap;
  }
  return n;
}

// mx: x as (cin, w, h), boxes (64, S, R); mw: the weights as
// (cinp, cout, 27), boxes (64, 128, 1).
__global__ void __launch_bounds__(kThreads, 1)
aspp_kernel(const __grid_constant__ CUtensorMap mx,
            const __grid_constant__ CUtensorMap mw, bf16* __restrict__ out,
            int h, int w, int cin, int cout, int d0, int d1, int d2, int R,
            int S, int ntx, int stages) {
  const int b = blockIdx.y;
  const int d = b == 0 ? d0 : b == 1 ? d1 : d2;
  const int y0 = (blockIdx.x / ntx) * R, x0 = (blockIdx.x % ntx) * S;
  const int co0 = blockIdx.z * kNc;
  const int abytes = R * S * 128;  // one A box
  const int mpw = R * S / 128;     // m-tiles per consumer warpgroup

  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* bs = as + (size_t)stages * abytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + (size_t)stages * kBBytes);
  uint64_t* empty = full + stages;

  int taps[9];
  const int nt = live_taps(taps, y0, x0, R, S, h, w, d);
  const int steps = (cin + kKc - 1) / kKc * nt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kCons * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == kCons) {  // producer: one thread issues every copy
    reg_dealloc<40>();
    if (tid == 0) {
      Ring r(stages);
      for (int s = 0; s < steps; ++s) {
        const int tap = taps[s % nt], c0 = s / nt * kKc;
        mbar_wait(empty + r.slot, r.phase ^ 1);
        mbar_arrive_tx(full + r.slot, abytes + kBBytes);
        tma_load_3d(as + (size_t)r.slot * abytes, &mx, full + r.slot, c0,
                    x0 + (tap % 3 - 1) * d, y0 + (tap / 3 - 1) * d);
        tma_load_3d(bs + r.slot * kBBytes, &mw, full + r.slot, c0, co0,
                    b * 9 + tap);
        r.next();
      }
    }
    return;
  }

  // consumers: warpgroup wg owns m-tiles [wg * mpw, wg * mpw + mpw) (64
  // pixels each) by all 128 channels
  reg_alloc<232>();
  const int warp = tid / 32, lane = tid % 32;
  float acc[2][64];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
  auto fence_all = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) fence_acc(acc[mt]);
  };
  Ring r(stages);
  int prev = -1;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(full + r.slot, r.phase);
    const unsigned char* a = as + (size_t)r.slot * abytes + wg * mpw * 8192;
    const unsigned char* bb = bs + r.slot * kBBytes;
    fence_all();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = desc_b128(bb + ks * 32, 16, 1024);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < mpw)
          wgmma_bf16_ss_n128(acc[mt], desc_b128(a + mt * 8192 + ks * 32, 16,
                                                1024),
                             db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // step s - 1's group has read its slot
    fence_all();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
    prev = r.slot;
    r.next();
  }
  wgmma_wait<0>();
  fence_all();

  // ReLU, one rounding, out[y, x, b*Cout + c]; the accumulator holds rows
  // warp*16 + g (+8) of its m-tile, columns 8j + 2t (+1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= mpw) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wg * mpw + mt) * 64 + warp * 16 + g + 8 * hh;
      const int oy = y0 + p / S, ox = x0 + p % S;
      if (oy >= h || ox >= w) continue;
      bf16* o = out + ((long long)oy * w + ox) * 3 * cout + b * cout;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = co0 + 8 * j + 2 * t;
        if (c >= cout) continue;  // cout is even: c + 1 < cout too
        *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(
            fmaxf(acc[mt][4 * j + 2 * hh], 0.f),
            fmaxf(acc[mt][4 * j + 2 * hh + 1], 0.f));
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of the kernel (ops/aspp.py `aspp_smem_bytes`
// states the same): 1024 bytes of alignment slack, `stages` A boxes
// (R*S rows of 128 bytes) and B boxes (16 KB), the barriers.
static size_t smem_bytes(int R, int S, int stages) {
  return 1024 + (size_t)stages * (R * S * 128 + kBBytes) +
         2 * stages * sizeof(uint64_t);
}

// Plain C entry, loaded with ctypes.  x (h, w, cin) bf16 contiguous; wt
// (27, cout, cinp) bf16 contiguous, taps b*9 + ky*3 + kx, cin zero-padded
// to cinp, a multiple of 64 (ops/aspp.py `aspp_kernel_weights`); out
// (h, w, 3*cout) bf16; d0..d2 the branches' dilations; R x S the pixel
// rectangle (R*S 128 or 256, R and S <= 256) and `stages` (2-4) the
// ring's depth, from ops/aspp.py `aspp_tile`.  Needs cin % 8 == 0, cout
// even, x and wt 16-byte aligned; the wrapper checks.  Launches on
// `stream`, which must belong to the current device, and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int dcfp_aspp_fused(const void* x, const void* wt, void* out,
                               int h, int w, int cin, int cout, int d0,
                               int d1, int d2, int R, int S, int stages,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1 || cin < 8 || cin % 8 || cout < 2 || cout % 2 ||
      d0 < 1 || d1 < 1 || d2 < 1 || R < 1 || S < 1 || R > 256 || S > 256 ||
      (R * S != 128 && R * S != 256) || stages < 2 || stages > 4)
    return (int)cudaErrorInvalidValue;
  const int cinp = (cin + kKc - 1) / kKc * kKc;
  CUtensorMap mx, mw;
  const CUtensorMapDataType bt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  {
    const uint64_t dims[3] = {(uint64_t)cin, (uint64_t)w, (uint64_t)h};
    const uint64_t strides[2] = {(uint64_t)cin * 2, (uint64_t)w * cin * 2};
    const uint32_t box[3] = {kKc, (uint32_t)S, (uint32_t)R};
    if (const int e = make_map(&mx, bt, 3, x, dims, strides, box)) return e;
  }
  {
    const uint64_t dims[3] = {(uint64_t)cinp, (uint64_t)cout, 27};
    const uint64_t strides[2] = {(uint64_t)cinp * 2,
                                 (uint64_t)cout * cinp * 2};
    const uint32_t box[3] = {kKc, kNc, 1};
    if (const int e = make_map(&mw, bt, 3, wt, dims, strides, box)) return e;
  }
  const size_t smem = smem_bytes(R, S, stages);
  if (const int e = set_smem((const void*)aspp_kernel, smem)) return e;
  const int nty = (h + R - 1) / R, ntx = (w + S - 1) / S;
  const dim3 grid((unsigned)(nty * ntx), 3, (cout + kNc - 1) / kNc);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  aspp_kernel<<<grid, kThreads, smem, s>>>(
      mx, mw, static_cast<bf16*>(out), h, w, cin, cout, d0, d1, d2, R, S,
      ntx, stages);
  return (int)cudaGetLastError();
}
