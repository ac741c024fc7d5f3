// Shared pieces of the port's tiled tensor-core kernels (K4, K5, K6).
//
// Each of them runs one or more GEMM passes of a 128 x 128 block tile
// (rows: pixels or matrix rows; columns: output channels) with 256
// threads = 8 warps, split 2 x 4 over (rows, columns): a warp owns 4
// m-tiles of 16 rows by 4 n-tiles of 8 columns.  K advances 64 bytes per
// step (64 int8 or 32 bf16 values), staged into shared memory rows of 80
// bytes (an odd number of 16-byte units, so the 8 rows an ldmatrix reads
// fall on distinct banks) by cp.async, kStages buffers deep: the copies
// of the next three steps are in flight while a step runs on the tensor
// cores.
//
// Fragments come from ldmatrix, which takes one row address per lane, so
// an A operand can be read straight from any rows of shared memory (a
// dilated tap is a shift of the row index).  bf16 runs mma.sync m16n8k16
// with f32 sums, int8 m16n8k32 with s32 sums; both take A [row][k] and B
// [column][k] and have the same byte layout per fragment, so the same
// ldmatrix addresses serve both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dcfp {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // block tile: rows and columns
constexpr int kKb = 64;      // bytes of K per step
constexpr int kLd = kKb + 16;  // staging row stride in bytes
constexpr int kStage = kTile * kLd;  // bytes of one staged operand
constexpr int kStages = 4;           // buffers per staged operand

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (nothing
// is read then, but src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a 128-row x 64-byte block of a row-major byte matrix: dst[r][k]
// = m[(r0 + r) * ld + k0 + k] for r0 + r < rows and k0 + k < kbytes,
// zero elsewhere.  ld, k0 and kbytes are multiples of 16 and m is 16-byte
// aligned, so each 16-byte run is wholly inside or outside.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const unsigned char* m,
                                           long long ld, int rows,
                                           int kbytes, int r0, int k0) {
  for (int e = threadIdx.x; e < kTile * (kKb / 16); e += kThreads) {
    const int r = e / (kKb / 16), k = (e % (kKb / 16)) * 16;
    const bool ok = r0 + r < rows && k0 + k < kbytes;
    cp_async16(dst + r * kLd + k,
               ok ? m + (long long)(r0 + r) * ld + k0 + k : m, ok);
  }
}

// Lane coordinates shared by every pass.
struct Lane {
  int g, t;    // mma fragment row group and thread in group
  int wm, wn;  // warp position: rows wm*64.., columns wn*32..
  int ar, ak;  // ldmatrix A: row within an m-tile, byte offset (0 / 16)
  int br, bk;  // ldmatrix B (two n-tiles): row within 16, byte offset
  __device__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    wm = warp >> 2;
    wn = warp & 3;
    ar = (lane & 7) + ((lane >> 3) & 1) * 8;
    ak = (lane >> 4) * 16;
    br = (lane & 7) + (lane >> 4) * 8;
    bk = ((lane >> 3) & 1) * 16;
  }
};

template <typename Acc>
__device__ __forceinline__ void zero(Acc (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// One 64-byte K step of this warp's 4 x 4 tiles.  arow[i]: this lane's
// ldmatrix row address for m-tile i at the step's first byte (ak
// included); m-tiles >= mt_used are skipped.  bs: the staged B block
// [column][k].  ksub: 32-byte halves of the step to run (1 or 2).
template <typename Acc>
__device__ __forceinline__ void warp_step(Acc (&acc)[4][4][4],
                                          const unsigned char* const* arow,
                                          int mt_used,
                                          const unsigned char* bs,
                                          const Lane& ln, int ksub) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks >= ksub) break;
    uint32_t b[4][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t r[4];
      ldsm_x4(r, bs + (ln.wn * 32 + j * 16 + ln.br) * kLd + ks * 32 + ln.bk);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < mt_used) {
        uint32_t a[4];
        ldsm_x4(a, arow[i] + ks * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
}

// Run `steps` K steps through kStages buffers: stage(s, buf) issues the
// cp.async copies of step s into buffer buf; compute(s, buf) consumes
// them.  The copies of the next kStages - 1 steps are in flight while a
// step computes, and one barrier per step both publishes step s's data
// and frees the buffer that step s - 1 read.  Every thread of the block
// must call it; on return all copies have landed and every buffer is
// free.
template <class Stage, class Compute>
__device__ __forceinline__ void pipeline(int steps, Stage stage,
                                         Compute compute) {
  if (steps <= 0) return;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's)
    __syncthreads();               // ... everyone's; step s-1 is done
    const int next = s + kStages - 1;
    if (next < steps) stage(next, next % kStages);
    cp_async_commit();
    compute(s, s % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

inline int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace dcfp
