// Hopper (sm_90a) pieces shared by the port's wgmma kernels: K5, the
// tiled matmul (int8_mm.cu), K3's bf16 path (bottleneck.cu), K6, the int8
// chain (int8_chain.cu), and K4, the fused ASPP branches (aspp.cu).
//
// No kernel replaces a TPU kernel by itself; this header holds what they
// share.  The TPU kernels they replace (tools/exp_int8.py `_mm_kernel`
// and `_chain_kernel`, dcfp_tpu/ops/bottleneck.py `_kernel`,
// tools/exp_aspp.py `_aspp_kernel`) stream their operands through VMEM
// with BlockSpecs; on the H100 the
// tensor cores reach their dense rate (989 TFLOP/s bf16, 1,979 TOP/s
// int8) only through wgmma, fed from shared memory that the copy engine
// keeps full.  So:
//
//  - Host: `make_map` encodes a CUtensorMap (TMA descriptor).
//    cuTensorMapEncodeTiled lives in libcuda, and the port's libraries
//    are built `nvcc -shared` without -lcuda; the function is fetched at
//    run time with cudaGetDriverEntryPoint, so the build flags (hashed
//    into every library's name) stay as they were.  A map goes to the
//    kernel as a `const __grid_constant__ CUtensorMap` parameter, so a
//    CUDA graph captures it by value.
//  - Device: a ring of full/empty mbarriers; TMA loads (2D and 3D, with
//    signed coordinates: a box that reaches past any edge of the tensor,
//    below 0 included, is zero-filled there) that complete on a full
//    barrier; cp.async that arrive on one; wgmma shared-memory
//    descriptors for the 128-byte swizzle that TMA writes; wgmma issue
//    helpers, bf16 -> f32 (k16; m64n64 with A from shared memory or from
//    registers, B K-major or MN-major; m64n128 from shared memory) and
//    s8 -> s32 (k32, B K-major, the only form s8 has; m64n64 from shared
//    memory, m64n128 with A from shared memory or from registers); the
//    fence, commit and wait steps.
//
// Layouts.  A TMA box whose inner extent is 128 bytes, written with
// CU_TENSOR_MAP_SWIZZLE_128B, puts row r of the box at byte r * 128 with
// its 16-byte chunks XORed by (r % 8); the box base must be 1024-byte
// aligned.  For a K-major operand (rows = M or N, 128 bytes of K each)
// the descriptor's stride byte offset (SBO) is 1024 (8 rows) and a k
// step inside the 128 bytes advances the start address by 32 bytes.  For
// an MN-major bf16 B (rows = K, 64 values of N each) SBO is again the
// 1024 bytes of 8 K rows, a k16 step advances 16 rows (2048 bytes), and
// the leading byte offset (the stride between 64-wide N atoms) is unused
// at N = 64.
//
// What it bought (chip_smoke.py and pair_times.py, NVIDIA H100 80GB HBM3,
// power limit 700.00 W, against the mma.sync versions in the same run):
// K5 at 1024^3 0.0232 -> 0.0087 ms (int8) and 0.0423 -> 0.0078 ms (bf16);
// K3 at the pruned R101's layer3 0.489 -> 0.236 ms and layer4 3.00 ->
// 0.680 ms.  K6 and K4: their own notes.  All are still bound by their
// own pipelines, not by the card; the kernels' notes say where.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major tensor of `rank` (2 or 3) dims, innermost first: dims[i]
// elements, strides[i] bytes between consecutive indices of dim i + 1
// (each a multiple of 16), boxes of box[i] elements with a 128-byte
// inner extent, 128-byte swizzle, zeros outside the tensor.  Returns 0
// or a CUDA error code.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                    const void* base, const uint64_t* dims,
                    const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return (int)cudaErrorInvalidValue;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], e[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) {
      if (strides[i] % 16) return (int)cudaErrorInvalidValue;
      s[i] = strides[i];
    }
  }
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base),
                        d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Shared memory a block may use on the H100 (227 KB); above 48 KB only
// after the attribute is set, else the launch is refused.
constexpr size_t kSmemLimit = 232448;

inline int set_smem(const void* kernel, size_t smem) {
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// -------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarriers.  A full barrier counts the producer's arrivals and the TMA
// bytes; an empty barrier counts the consumers' releases.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// An arrival that fires when this thread's earlier cp.async copies have
// landed (the pending count is raised first, so it adds no arrival).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// A ring position: slot and the parity of its current round.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  int stages;
  __device__ explicit Ring(int n) : stages(n) {}
  __device__ void next() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// TMA loads, global -> shared, completing on `bar`.  Coordinates in
// elements, innermost first, signed: elements of the box outside the
// tensor (negative coordinates included) land as zeros, and the whole
// box's bytes count towards the barrier's transaction.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// 16 bytes global -> shared by cp.async; zeros when !valid (src is not
// read then, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Offset of 16-byte chunk `c` (0..7) of row `r` in a 128-byte-swizzled
// tile of 128-byte rows: what TMA's SWIZZLE_128B writes and what a
// descriptor with layout B128 reads.
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, layout B128 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc_b128(uint32_t a, uint32_t lbo,
                                              uint32_t sbo) {
  return ((uint64_t)(a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_b128(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return desc_b128(smem_u32(p), lbo, sbo);
}

// Order this thread's view of shared memory, written through the
// generic proxy (st.shared, cp.async), before its later reads through
// the async proxy (wgmma descriptors).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma (issue ... wait).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SM90_D32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define SM90_ACC32(c, d)                                                 \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]),         \
      c(d[7]), c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), \
      c(d[14]), c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]),        \
      c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),        \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])

// d (64 x 64 f32, 32 a thread) += A (64 x 16 bf16, descriptor) *
// B (16 x 64 bf16, descriptor; kTnspB = 1 for MN-major).  The
// accumulator layout: warp w of the warpgroup holds rows 16w + g and
// 16w + g + 8 (g = lane / 4), d[4j..4j+1] and d[4j+2..4j+3] at columns
// 8j + 2 (lane % 4) + {0, 1}.
template <int kTnspB>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : SM90_ACC32("+f", d)
      : "l"(da), "l"(db), "r"(1), "n"(kTnspB));
}

// The same with A from registers: the m16n8k16 A fragment (as ldmatrix
// x4 loads it) of rows 16w .. 16w + 15 in warp w.  B K-major.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SM90_ACC32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 s32) += A (64 x 32 s8) * B (32 x 64 s8), both K-major
// descriptors; the accumulator layout of wgmma_bf16_ss.  With acc = 0
// (the s8 helpers take it) the product overwrites d instead: a pass
// starts so, rather than with zeros written into d.
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[32], uint64_t da,
                                            uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " SM90_D32
      ", %32, %33, p;\n}\n"
      : SM90_ACC32("+r", d)
      : "l"(da), "l"(db), "r"(acc));
}

#define SM90_D64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define SM90_ACC64(c, d)                                                 \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]),         \
      c(d[7]), c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), \
      c(d[14]), c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]),        \
      c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),        \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]),        \
      c(d[32]), c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]),        \
      c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]), c(d[43]),        \
      c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),        \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]),        \
      c(d[56]), c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]),        \
      c(d[62]), c(d[63])

// d (64 x 128 f32, 64 a thread) += A (64 x 16 bf16) * B (16 x 128 bf16),
// both K-major descriptors (B: 128 rows of 128 bytes, SBO 1024).  The
// accumulator layout of wgmma_bf16_ss with j = 0 .. 15.
__device__ __forceinline__ void wgmma_bf16_ss_n128(float (&d)[64],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC64("+f", d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128 s32, 64 a thread) += A (64 x 32 s8) * B (32 x 128 s8), B a
// K-major descriptor of 128 rows; the accumulator layout of
// wgmma_bf16_ss_n128.  A from a descriptor, or (_rs) from registers: the
// m16n8k32 s8 A fragment of rows 16w .. 16w + 15 in warp w, as ldmatrix
// x4 loads a 16-row x 32-byte block (rows 0-7 and 8-15 of bytes 0-15,
// then of bytes 16-31); CUTLASS's MMA_64x128x32_S32S8S8_RS_TN form.
__device__ __forceinline__ void wgmma_s8_ss_n128(int (&d)[64], uint64_t da,
                                                 uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64
      ", %64, %65, p;\n}\n"
      : SM90_ACC64("+r", d)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_s8_rs_n128(int (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : SM90_ACC64("+r", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// Registers of a warpgroup role (all four warps together), sm_90a only.
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Named barrier over the consumer warpgroups (id 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace sm90
