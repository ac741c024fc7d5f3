// K5: the tiled matmul of the int8 probe, for Hopper.
//
// Replaces tools/exp_int8.py `_mm_kernel` (the TPU kernel behind
// `pallas_mm`).  For row-major a (M, K) and b (K, N) it computes
//
//   out = a @ b     int8 x int8 -> int32 (exact), or bf16 x bf16 -> f32
//
// for every row: the TPU grid covers M // 512 row tiles and leaves a
// ragged tail unwritten, this kernel masks it.
//
// Tiling (csrc/mma_tile.cuh): a block owns a 128 x 128 tile of out and
// walks K 64 bytes at a time (64 int8 or 32 bf16 values), two buffers
// deep.  A rows go to shared memory by cp.async.  b is row-major, but the
// tensor cores take B as [column][k]: each thread loads its 8 words of the
// next step's b block into registers before the current step's mma, and
// after them writes the words transposed (byte_perm: 4 x 4 bytes for
// int8, 2 x 2 halves for bf16), so the loads' latency hides behind the
// tensor cores and every fragment then comes from ldmatrix.  int8 runs
// mma.sync m16n8k32 with s32 sums, bf16 m16n8k16 with f32 sums; a pair
// of sums per store.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense
// bf16, 1,979 TOP/s dense int8): at 1024^3 the output alone is 4 MB,
// so the bytes (1.9 us int8, 2.5 us bf16) outweigh the operations (1.1
// and 2.2 us).  It takes about 0.023 ms (int8) and 0.043 ms (bf16) on
// an H100 at 700 W (chip_smoke.py): 1024^3 makes only 64 block tiles for
// 132 SMs, the b block moves through registers one step ahead, and
// mma.sync reaches about half of the dense rate that wgmma can; smaller
// tiles for small products and wgmma with a TMA ring are the steps
// beyond this first version.

#include "mma_tile.cuh"

namespace {

using namespace dcfp;

// The b block of step s: 64 bytes of K (rows) x 128 columns, 8 words per
// thread.  int8: 4 x 4-byte blocks (4 rows x 4 columns), 2 per thread;
// bf16: 2 x 2 blocks (2 rows x 2 columns), 4 per thread.  Within a warp
// the 32 lanes take 8 row groups x 4 column groups, so each row's words
// are 16 contiguous bytes in global memory and the transposed stores
// fall on distinct banks (bf16) or two-way (int8).
template <bool kInt8>
struct BBlock {
  static constexpr int kRowsPer = kInt8 ? 4 : 2;  // rows per block
  static constexpr int kBlocks = kInt8 ? 2 : 4;   // blocks per thread

  __device__ static void coords(int i, int* kg, int* ng) {
    const int id = threadIdx.x + kThreads * i;
    const int lane = id & 31, w = id >> 5;
    *kg = (w & 1) * 8 + (lane & 7);         // 16 row groups
    *ng = (w >> 1) * 4 + (lane >> 3);       // column groups
  }

  // regs[i * kRowsPer + r] = the word of rows (kg*kRowsPer + r) of step s
  __device__ static void load(uint32_t (&regs)[8],
                              const unsigned char* __restrict__ b, int k,
                              int n, int n0, int s) {
    constexpr int es = kInt8 ? 1 : 2;
    constexpr int kPerStep = kKb / es;
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      int kg, ng;
      coords(i, &kg, &ng);
      const int col = n0 + ng * (4 / es);  // first of the block's columns
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        const int row = s * kPerStep + kg * kRowsPer + r;
        uint32_t v = 0;
        if (row < k && col < n)
          v = *reinterpret_cast<const uint32_t*>(
              b + ((long long)row * n + col) * es);
        regs[i * kRowsPer + r] = v;
      }
    }
  }

  // bs[column][k bytes] from the registers, transposed
  __device__ static void store(unsigned char* bs, const uint32_t (&regs)[8]) {
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      int kg, ng;
      coords(i, &kg, &ng);
      const uint32_t* r = regs + i * kRowsPer;
      if constexpr (kInt8) {
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
        const uint32_t c[4] = {__byte_perm(t0, t1, 0x5410),
                               __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410),
                               __byte_perm(t2, t3, 0x7632)};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(bs + (ng * 4 + j) * kLd + kg * 4) =
              c[j];
      } else {
        const uint32_t c[2] = {__byte_perm(r[0], r[1], 0x5410),
                               __byte_perm(r[0], r[1], 0x7632)};
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<uint32_t*>(bs + (ng * 2 + j) * kLd + kg * 4) =
              c[j];
      }
    }
  }
};

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const unsigned char* __restrict__ a,
          const unsigned char* __restrict__ b, void* __restrict__ out, int m,
          int n, int k) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  using BB = BBlock<kInt8>;
  constexpr int es = kInt8 ? 1 : 2;
  __shared__ __align__(16) unsigned char as[2][kStage];
  __shared__ __align__(16) unsigned char bs[2][kStage];

  const Lane ln;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int kbytes = k * es;
  const int steps = (kbytes + kKb - 1) / kKb;
  const int rows_left = m - m0 - ln.wm * 64;
  const int mt_used = rows_left <= 0 ? 0 : min(4, (rows_left + 15) / 16);

  Acc acc[4][4][4];
  zero(acc);
  uint32_t regs[8];

  stage_rows(as[0], a, kbytes, m, kbytes, m0, 0);
  cp_async_commit();
  BB::load(regs, b, k, n, n0, 0);
  BB::store(bs[0], regs);
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {
      stage_rows(as[cur ^ 1], a, kbytes, m, kbytes, m0, (s + 1) * kKb);
      cp_async_commit();
      BB::load(regs, b, k, n, n0, s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* arow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      arow[i] = as[cur] + (ln.wm * 64 + i * 16 + ln.ar) * kLd + ln.ak;
    warp_step(acc, arow, mt_used, bs[cur], ln, 2);
    if (more) BB::store(bs[cur ^ 1], regs);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + ln.wn * 32 + j * 8 + ln.t * 2;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + ln.wm * 64 + i * 16 + ln.g + 8 * h;
        if (row >= m) continue;
        Acc* o = static_cast<Acc*>(out) + (long long)row * n + col;
        if constexpr (kInt8)
          *reinterpret_cast<int2*>(o) =
              make_int2((int)acc[i][j][2 * h], (int)acc[i][j][2 * h + 1]);
        else
          *reinterpret_cast<float2*>(o) =
              make_float2((float)acc[i][j][2 * h], (float)acc[i][j][2 * h + 1]);
      }
    }
  }
}

}  // namespace

// Plain C entry, loaded with ctypes.  a (m, k) and b (k, n) are
// contiguous row-major, int8 (is_bf16 = 0) or bf16 (is_bf16 = 1); out
// (m, n) is int32 or f32.  Needs k * itemsize % 16 == 0, n % 4 == 0
// (int8) or n % 2 == 0 (bf16), a 16-byte and b 4-byte aligned, out
// 8-byte aligned; the wrapper checks.  Launches on `stream`, which must
// belong to the current device, and returns cudaGetLastError() (0 on
// success); it does not synchronise.
extern "C" int dcfp_tiled_mm(const void* a, const void* b, void* out,
                             int is_bf16, int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = is_bf16 ? 2 : 1;
  if (m < 1 || n < 1 || k < 1 || (k * es) % 16 || n % (is_bf16 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const unsigned char* pa = static_cast<const unsigned char*>(a);
  const unsigned char* pb = static_cast<const unsigned char*>(b);
  if (is_bf16)
    mm_kernel<false><<<grid, kThreads, 0, s>>>(pa, pb, out, m, n, k);
  else
    mm_kernel<true><<<grid, kThreads, 0, s>>>(pa, pb, out, m, n, k);
  return (int)cudaGetLastError();
}
