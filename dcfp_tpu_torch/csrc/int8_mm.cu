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
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense
// bf16, 1,979 TOP/s dense int8): at 1024^3 the output alone is 4 MB, so
// the bytes (1.9 us int8, 2.5 us bf16) outweigh the operations (1.1 and
// 2.2 us).  A call that short is set by how fast the card fills: every
// SM needs a tile, and each tile's K loop must keep the tensor cores fed.
//
// Design (csrc/sm90_tile.cuh).  A block owns a 128 x 64 tile of out, so
// 1024^2 makes 128 blocks for the 132 SMs.  Three warpgroups: two
// consumers (64 rows each) and one producer thread that keeps a ring of
// four stages full by TMA, each stage 128 bytes of K (64 bf16 or 128 int8
// values) of a (16 KB) and of b (8 KB), written with the 128-byte swizzle;
// the consumers run wgmma m64n64 straight from the ring (k16 bf16 -> f32,
// k32 s8 -> s32), one stage's group in flight while the next is issued,
// and release a slot when its group has completed.  TMA fills the ragged
// edges of M, N and K with zeros.
//
// The B operand.  bf16 wgmma reads B MN-major (its transpose bit covers
// 16-bit types), so a bf16 b whose rows are a multiple of 16 bytes on a
// 16-byte boundary goes in as it is.  s8 wgmma takes B only K-major, and
// TMA needs row strides that are multiples of 16 bytes (the probe's
// 1000 x 1008 x 200 int8 b has 200-byte rows): every int8 b, and any bf16
// b that TMA cannot read, is first transposed to bt (N, K) by
// `transpose_kernel` in the same call, whose rows are K values, a multiple
// of 16 bytes by the contract.  The wrapper allocates bt; its time is in
// K5's time.
//
// Measured (chip_smoke.py and pair_times.py, 20 calls in a CUDA graph,
// NVIDIA H100 80GB HBM3, power limit 700.00 W): at 1024^3 int8 0.0087 ms
// and bf16 0.0078 ms, against 0.0232 and 0.0423 for the mma.sync version
// before it in the same run (torch._int_mm 0.0389, torch.matmul bf16 out
// 0.0058, torch.mm f32 out 0.0063); at 64 x 4096 x 1024, 0.0177 and
// 0.0152 against 0.0769 and 0.1532.  Still 3-5x its byte bound: each
// block owns one 128 x 64 tile and runs only 8-16 stages of K, so the
// ring's fill and drain are likely a large share of its time.

#include <type_traits>

#include "sm90_tile.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128, kBN = 64;  // block tile
constexpr int kKb = 128;            // bytes of K per stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;       // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kKb;  // 16 KB
constexpr int kBBytes = kBN * kKb;  // 8 KB
constexpr size_t kSmem =
    1024 + kStages * (kABytes + kBBytes) + 2 * kStages * sizeof(uint64_t);

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// kBKmajor: B is bt (N, K) (K-major), else b (K, N) (MN-major, bf16).
template <bool kInt8, bool kBKmajor>
__global__ void __launch_bounds__(kThreads, 1)
mm_kernel(const __grid_constant__ CUtensorMap ma,
          const __grid_constant__ CUtensorMap mb, void* __restrict__ out,
          int m, int n, int steps) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kKe = kInt8 ? kKb : kKb / 2;  // K values per stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = align1024(smem_raw);
  unsigned char* bs = as + kStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers * 4);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer: one thread issues every copy
    if (tid == 0) {
      Ring r(kStages);
      for (int s = 0; s < steps; ++s) {
        mbar_wait(empty + r.slot, r.phase ^ 1);
        mbar_arrive_tx(full + r.slot, kABytes + kBBytes);
        tma_load_2d(as + r.slot * kABytes, &ma, full + r.slot, s * kKe, m0);
        if (kBKmajor)
          tma_load_2d(bs + r.slot * kBBytes, &mb, full + r.slot, s * kKe, n0);
        else
          tma_load_2d(bs + r.slot * kBBytes, &mb, full + r.slot, n0, s * kKe);
        r.next();
      }
    }
    return;
  }

  // consumers
  const int warp = tid / 32, lane = tid % 32;
  const bool active = m0 + wg * 64 < m;  // rows past M: nothing to do
  Acc acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  Ring r(kStages);
  int prev = -1;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(full + r.slot, r.phase);
    if (active) {
      const unsigned char* a = as + r.slot * kABytes + wg * 64 * kKb;
      const unsigned char* b = bs + r.slot * kBBytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = desc_b128(a + ks * 32, 16, 1024);
        if constexpr (kInt8) {
          wgmma_s8_ss(acc, da, desc_b128(b + ks * 32, 16, 1024));
        } else if constexpr (kBKmajor) {
          wgmma_bf16_ss<0>(acc, da, desc_b128(b + ks * 32, 16, 1024));
        } else {  // MN-major: a k16 step is 16 rows of 128 bytes
          wgmma_bf16_ss<1>(acc, da, desc_b128(b + ks * 2048, 1024, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // step s - 1's group has read its slot
      fence_acc(acc);
    }
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
    prev = r.slot;
    r.next();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (!active) return;

  const int g = lane / 4, t = lane % 4;
  const int row0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;  // n is even: a pair never straddles
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      Acc* o = static_cast<Acc*>(out) + (long long)row * n + col;
      if constexpr (kInt8)
        *reinterpret_cast<int2*>(o) = make_int2(acc[4 * j + 2 * h],
                                                acc[4 * j + 2 * h + 1]);
      else
        *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * h],
                                                    acc[4 * j + 2 * h + 1]);
    }
  }
}

// bt[c][r] = b[r][c] for b (k, n): 32 x 32 tiles through shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
transpose_kernel(const T* __restrict__ b, T* __restrict__ bt, int k, int n) {
  __shared__ T tile[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8)
    if (k0 + i < k && n0 + tx < n)
      tile[i][tx] = b[(long long)(k0 + i) * n + n0 + tx];
  __syncthreads();
  for (int i = ty; i < 32; i += 8)
    if (n0 + i < n && k0 + tx < k)
      bt[(long long)(n0 + i) * k + k0 + tx] = tile[tx][i];
}

template <bool kInt8, bool kBKmajor>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, void* out, int m,
           int n, int steps, cudaStream_t s) {
  auto kernel = mm_kernel<kInt8, kBKmajor>;
  if (const int e = set_smem((const void*)kernel, kSmem)) return e;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, s>>>(ma, mb, out, m, n, steps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  a (m, k) and b (k, n) are
// contiguous row-major, int8 (is_bf16 = 0) or bf16 (is_bf16 = 1); out
// (m, n) is int32 or f32.  bt is scratch for b transposed, (n, k) in b's
// type, on a 16-byte boundary: required for int8; for bf16 it may be null
// when n % 8 == 0 and b starts on a 16-byte boundary, and b is then read
// as it is.  Needs k * itemsize % 16 == 0, n % 4 == 0 (int8) or
// n % 2 == 0 (bf16), a on a 16-byte and b on a 4-byte boundary, out 8-byte
// aligned; the wrapper checks.  Launches on `stream`, which must belong
// to the current device, and returns cudaGetLastError() (0 on success);
// it does not synchronise.
extern "C" int dcfp_tiled_mm(const void* a, const void* b, void* bt,
                             void* out, int is_bf16, int m, int n, int k,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = is_bf16 ? 2 : 1;
  if (m < 1 || n < 1 || k < 1 || (k * es) % 16 || n % (is_bf16 ? 2 : 4) ||
      (!is_bf16 && !bt))
    return (int)cudaErrorInvalidValue;
  if ((m + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type =
      is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const uint32_t ke = kKb / es;  // K values in a box's 128-byte rows
  CUtensorMap ma, mb;
  {
    const uint64_t dims[2] = {(uint64_t)k, (uint64_t)m};
    const uint64_t strides[1] = {(uint64_t)k * es};
    const uint32_t box[2] = {ke, (uint32_t)kBM};
    if (const int e = make_map(&ma, type, 2, a, dims, strides, box)) return e;
  }
  if (bt) {
    const dim3 tgrid((n + 31) / 32, (k + 31) / 32);
    if (tgrid.y > 65535) return (int)cudaErrorInvalidValue;
    if (is_bf16)
      transpose_kernel<uint16_t><<<tgrid, 256, 0, s>>>(
          static_cast<const uint16_t*>(b), static_cast<uint16_t*>(bt), k, n);
    else
      transpose_kernel<uint8_t><<<tgrid, 256, 0, s>>>(
          static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), k, n);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
    const uint64_t dims[2] = {(uint64_t)k, (uint64_t)n};
    const uint64_t strides[1] = {(uint64_t)k * es};
    const uint32_t box[2] = {ke, (uint32_t)kBN};
    if (const int e = make_map(&mb, type, 2, bt, dims, strides, box)) return e;
  } else {
    const uint64_t dims[2] = {(uint64_t)n, (uint64_t)k};
    const uint64_t strides[1] = {(uint64_t)n * 2};
    const uint32_t box[2] = {(uint32_t)kBN, 64};
    if (const int e = make_map(&mb, type, 2, b, dims, strides, box)) return e;
  }
  const int steps = (k * es + kKb - 1) / kKb;
  if (!is_bf16) return launch<true, true>(ma, mb, out, m, n, steps, s);
  if (bt) return launch<false, true>(ma, mb, out, m, n, steps, s);
  return launch<false, false>(ma, mb, out, m, n, steps, s);
}
