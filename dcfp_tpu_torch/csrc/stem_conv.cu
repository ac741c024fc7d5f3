// K2: the stem conv (3x3 / stride 2 / pad 1) from stride-2 phase planes,
// for Hopper.
//
// Replaces dcfp_tpu/ops/pallas_kernels.py `_stem_kernel`, driven by
// `_stem_conv_planes` (the TPU kernel behind `stem_conv3x3_s2`).  For
// phase planes P (N, 4*cin, Hp, Wp) made by `extract_stem_phases`, where
// plane ((a*2 + b)*cin + c) holds xpad[a::2, b::2, c], it computes
//
//   out[n, oy, ox, o] = act(bias[o] + sum_{i, j, c}
//       P[n, ((i&1)*2 + (j&1))*cin + c, oy + i/2, ox + j/2] * K[(i*3+j)*cin + c, o])
//
// so every tap is a unit-stride read of one plane.  Numerics: products
// accumulated in f32 in (i, j, c) order, bias added in f32, optional
// ReLU, one rounding to the phases dtype.  The weights arrive as f32
// already rounded to the phases dtype, as the TPU kernel's `km` is.
// The output is written channels_last, (N, Ho, Wo, cout) in memory, the
// layout the cuDNN convs that follow take without a copy.
//
// What bounds it on the card: at the deploy shape (12 bf16 planes of
// 536 x 1026 -> 513 x 1025 x 64 bf16) it reads the planes' first Ho+1 =
// 514 rows, 12.7 MB (the other 22 are the TPU layout's row tile and carry
// rows), and writes 67.3 MB, ~24 us at HBM rate, against 1.8 GFLOP,
// under 2 us on the bf16 tensor cores: it is bound by bytes, and the
// output store is 84% of them.  Measured on an H100 (PERF.md), this
// design takes ~45 us, and not for the bytes: without the output store
// it is 3% faster.  What is left is the issue of the compute phase
// (the gather of A, the mma, bias/ReLU/rounding, the quad transposes:
// ~10%), 16 warps an SM at the 128 registers that two blocks an SM
// allow; uncapped registers (one block) or 80 (three, at M = 128) are
// slower.
//
// bf16 (the deploy path): persistent blocks (two an SM, 256 threads) walk
// tiles in address order.  A tile is a run of M consecutive output pixels
// of one image (flattened (oy, ox); M = 256 at the deploy shape), so with
// channels_last its output is ONE contiguous run of M * cout * 2 bytes;
// rectangular tiles would leave a ragged 1-pixel column (Wo = 8*128 + 1).
// Per tile, for cout > 64 in 64-channel chunks:
//  - Stage the footprint in shared memory, double-buffered: the next
//    tile's is loaded while this one computes and stores.  A run touches
//    output rows oy0..oy1 (its segments); segment k needs plane rows
//    oy0+k and oy0+k+1 over its columns + 1.  Each (plane, row offset)
//    line holds the segments side by side, each from an even column with
//    an even width, so a pixel's taps sit at `slot(pixel) + koff[k]`.
//    TMA cannot describe the planes (row pitch 2*Wp bytes, 2052 at the
//    deploy shape, off 16), so the loads are 4-byte cp.async where Wp is
//    even and the base 4-byte aligned, 2-byte loads otherwise (never a
//    vector load off its alignment).
//  - Tensor cores: mma.sync m16n8k16 (bf16 in, f32 sums), the same
//    16-deep k-steps in the same order as the first, per-warp design of
//    this kernel (B fragments held in registers, A gathered straight from
//    the planes), so the output is bit-equal to it.  A (pixels x 9*cin, zero past the taps) is
//    gathered from the staged footprint through the per-k table `koff`,
//    once per 16-pixel m-tile and reused for every channel chunk; B (the
//    weights as mma fragments) and the bias sit in shared memory.  The
//    work is ~2 us of tensor time, so the choice against wgmma (RS, A
//    from registers) is registers and simplicity: mma.sync needs no
//    descriptors or warpgroup fences, and a 16 x 32 piece of
//    accumulators (16 registers) at a time keeps two blocks an SM.
//  - Epilogue: bias, ReLU and the one rounding in registers; a 4 x 4
//    transpose inside each quad of lanes turns the mma fragment into
//    16-byte channel runs of one pixel, stored to a shared output buffer
//    laid out as the output run (rotated by row so a quarter-warp hits
//    all 32 banks once).  For cout % 8 == 0 the run leaves as ONE bulk
//    copy shared -> global (cp.async.bulk, L2 evict-first), the buffer
//    double-buffered and reused after `cp.async.bulk.wait_group.read`;
//    otherwise (cout 42, say) the threads copy it out, placed in shared
//    memory at its output address mod 16, in 16-byte streaming stores
//    with 2-byte ends.
// The host plan (`stem_conv_plan` in ops/kernels.py) fixes M, the staged
// line length (the longest footprint over all tiles), the channel groups
// (a cout too wide for one block's shared memory is split into groups of
// chunks; each tile then writes its pixels' channels of one group), the
// grid, the shared memory and both routes; the C entry refuses a plan
// whose shared memory is not its own formula (`smem_bytes`) and a route
// the pointers do not allow, and the kernel traps on a footprint longer
// than the plan's line.
//
// f32: the tensor cores would round the inputs, so each thread owns one
// output pixel and 8 of its channels with f32 FMAs; the 27 x cout
// weights and the bias sit in shared memory, read as broadcasts, and the
// 8 threads of a pixel share its 27 phase loads.  Blocks walk the pixels
// grid-stride, so the weights are staged once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChan = 8;  // output channels per thread

// ---- f32: CUDA-core FMAs ----

__global__ void __launch_bounds__(kThreads)
stem_fma_kernel(const float* __restrict__ ph, const float* __restrict__ wk,
                const float* __restrict__ bias, int cin, int cout, int hp,
                int wp, int ho, int wo, int relu, float* __restrict__ out) {
  // shared: weights (9*cin, coutp) with the columns past cout zero, then
  // the bias (coutp)
  extern __shared__ float smem[];
  const int groups = (cout + kChan - 1) / kChan;
  const int coutp = groups * kChan;
  const int taps = 9 * cin;
  float* ws = smem;
  float* bs = smem + taps * coutp;
  for (int e = threadIdx.x; e < taps * coutp; e += blockDim.x) {
    const int t = e / coutp, o = e % coutp;
    ws[e] = o < cout ? wk[t * cout + o] : 0.f;
  }
  for (int o = threadIdx.x; o < coutp; o += blockDim.x)
    bs[o] = o < cout ? bias[o] : 0.f;
  __syncthreads();

  const int per_block = kThreads / groups;  // pixels per block step
  const int local = threadIdx.x / groups;
  const int c0 = (threadIdx.x % groups) * kChan;
  if (local >= per_block) return;
  const int n = blockIdx.y;
  const float* phn = ph + (size_t)n * 4 * cin * hp * wp;
  const size_t plane = (size_t)hp * wp;
  const int total = ho * wo;

  for (int pix = blockIdx.x * per_block + local; pix < total;
       pix += gridDim.x * per_block) {
    const int oy = pix / wo, ox = pix % wo;
    float acc[kChan];
#pragma unroll
    for (int k = 0; k < kChan; ++k) acc[k] = 0.f;
    int t = 0;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        const float* src = phn + ((i & 1) * 2 + (j & 1)) * cin * plane +
                           (size_t)(oy + (i >> 1)) * wp + ox + (j >> 1);
        for (int c = 0; c < cin; ++c, ++t) {
          const float v = src[c * plane];
          const float4* wr =
              reinterpret_cast<const float4*>(ws + t * coutp + c0);
          const float4 w0 = wr[0], w1 = wr[1];
          acc[0] = fmaf(v, w0.x, acc[0]);
          acc[1] = fmaf(v, w0.y, acc[1]);
          acc[2] = fmaf(v, w0.z, acc[2]);
          acc[3] = fmaf(v, w0.w, acc[3]);
          acc[4] = fmaf(v, w1.x, acc[4]);
          acc[5] = fmaf(v, w1.y, acc[5]);
          acc[6] = fmaf(v, w1.z, acc[6]);
          acc[7] = fmaf(v, w1.w, acc[7]);
        }
      }
    }
    float* dst = out + ((size_t)n * total + pix) * cout + c0;
#pragma unroll
    for (int k = 0; k < kChan; ++k) {
      float y = acc[k] + bs[c0 + k];
      if (relu) y = fmaxf(y, 0.f);
      if (c0 + k < cout) dst[k] = y;
    }
  }
}

int launch_fma(const void* ph, const void* wk, const void* bias, int n,
               int cin, int cout, int hp, int wp, int ho, int wo, int relu,
               void* out, cudaStream_t s) {
  const int groups = (cout + kChan - 1) / kChan;
  if (groups > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(9 * cin + 1) * groups * kChan * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stem_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_block = kThreads / groups;
  const long long need = ((long long)ho * wo + per_block - 1) / per_block;
  // a few blocks per SM, each walking the pixels grid-stride
  const long long cap = (long long)(sms > 0 ? sms : 132) * 8;
  const dim3 grid((unsigned)(need < cap ? need : cap), n);
  stem_fma_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(ph), static_cast<const float*>(wk),
      static_cast<const float*>(bias), cin, cout, hp, wp, ho, wo, relu,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ---- bf16: persistent runs on the tensor cores ----

using sm90::smem_u32;

__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;   // blocks an SM the plan's grid counts on
constexpr int kNt = 8;          // n-tiles of 8 channels: a 64-channel chunk
constexpr int kFrag = kNt * 32; // B fragments (uint2) of a chunk's k-step

// What the host plan fixes (ops/kernels.py `stem_conv_plan`).
struct Plan {
  int m;       // pixels of a run (a multiple of 16, <= 256)
  int line;    // staged elements of each (plane, row offset) line
  int cg;      // 64-channel chunks of a tile
  int groups;  // channel groups: tiles of one run
  int load4;   // 4-byte cp.async staging, else 2-byte loads
  int bulk;    // one bulk copy per run, else the threads store
};

struct Shape {
  int n, cin, cout, hp, wp, ho, wo, relu;
};

// A staged run's first pixel over the batch and its pixel count.
struct Meta {
  long long pix;
  int len, pad;
};

// Shared memory of a block, the formula the host plan repeats
// (ops/kernels.py `_k2_smem`): the output buffers (two for the bulk
// route), two footprint stages, the B fragments and the bias of a
// channel group, then for each stage the run's pixel slots and its Meta.
long long smem_bytes(int cin, int cout, int m, int line, int cg, int groups,
                     int bulk) {
  const long long ks = (9 * cin + 15) / 16;
  const long long ostride = groups == 1 ? cout : 64LL * cg;
  return (bulk ? 2 : 1) * (m * ostride * 2 + 16) + 2 * 16LL * cin * line +
         cg * ks * kFrag * 8 + cg * 64LL * 4 +
         2 * (m * 4LL + (long long)sizeof(Meta));
}

__device__ __forceinline__ uint32_t bf162_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
      "[%1], %2, %3;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma16816(float (&acc)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Transpose the 4 x 4 words held by a quad of lanes: lane t's word j
// becomes lane j's word t.  Two butterfly steps, no indexing by a
// register (which would put `a` in local memory).
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int tig) {
  const bool h = tig & 2;
  uint32_t x0 = h ? a[0] : a[2], x1 = h ? a[1] : a[3];
  x0 = __shfl_xor_sync(0xffffffffu, x0, 2);
  x1 = __shfl_xor_sync(0xffffffffu, x1, 2);
  if (h) {
    a[0] = x0;
    a[1] = x1;
  } else {
    a[2] = x0;
    a[3] = x1;
  }
  const bool l = tig & 1;
  x0 = l ? a[0] : a[1];
  x1 = l ? a[2] : a[3];
  x0 = __shfl_xor_sync(0xffffffffu, x0, 1);
  x1 = __shfl_xor_sync(0xffffffffu, x1, 1);
  if (l) {
    a[0] = x0;
    a[2] = x1;
  } else {
    a[1] = x0;
    a[3] = x1;
  }
}

// One tile: a run of pixels of one image and a group of channel chunks.
// Segment k of the run is output row oy0 + k; its staged columns start
// at `a0` (k = 0, rounded down to even) or 0, and end at the run's last
// column + 2 in its last row, else at Wo + 1, rounded up to even.
// Tiles run in 32-bit indices (the plan keeps them under 2^30), and
// where Wo >= M a run touches at most two rows, so a row is found by a
// compare, not a division.
struct Run {
  long long pix;  // first pixel over the batch, n * Ho * Wo + p0
  int n, p0, len;
  int oy0, ox0;   // the first pixel's row and column
  int segs;       // output rows touched
  int a0, w0;     // segment 0's first staged column and width
  int bl;         // column of the run's last pixel
};

__device__ __forceinline__ Run run_of(int tile, const Shape& S,
                                      const Plan& P, int runs) {
  Run r;
  const int q = P.groups == 1 ? tile : tile / P.groups;  // the run
  r.n = S.n == 1 ? 0 : q / runs;
  const int total = S.ho * S.wo;
  r.p0 = (q - r.n * runs) * P.m;
  r.len = min(P.m, total - r.p0);
  r.pix = (long long)r.n * total + r.p0;
  r.oy0 = r.p0 / S.wo;
  r.ox0 = r.p0 - r.oy0 * S.wo;
  const int x1 = r.ox0 + r.len - 1;  // the last pixel, from row oy0
  const int k1 = S.wo >= P.m ? (int)(x1 >= S.wo) : x1 / S.wo;
  r.segs = k1 + 1;
  r.bl = x1 - k1 * S.wo;
  r.a0 = r.ox0 & ~1;
  r.w0 = ((r.segs == 1 ? r.bl : S.wo - 1) + 3 - r.a0) & ~1;
  return r;
}

// The slot of run pixel t in each staged line: where plane row oy, column
// ox of its segment sits.
__device__ __forceinline__ int slot_of(const Run& r, int t, int wo,
                                       int wfull, bool wide) {
  const int x = r.ox0 + t, k = wide ? (int)(x >= wo) : x / wo;
  const int ox = x - k * wo;
  return k == 0 ? ox - r.a0 : r.w0 + (k - 1) * wfull + ox;
}

// Stage a run's footprint: line L = plane * 2 + row offset; each warp
// takes whole lines, its lanes the columns.
template <bool kWord>
__device__ __forceinline__ void stage_run(const unsigned short* ph,
                                          const Run& r, const Shape& S,
                                          int line, unsigned short* st,
                                          int warp, int lane) {
  const int wfull = (S.wo + 2) & ~1;
  const int width = r.segs == 1
                        ? r.w0
                        : r.w0 + (r.segs - 2) * wfull + ((r.bl + 3) & ~1);
  if (width > line) __trap();  // the plan's line covers every run
  const size_t plane = (size_t)S.hp * S.wp;
  for (int L = warp; L < 8 * S.cin; L += kWarps) {
    const unsigned short* src_l =
        ph + ((size_t)r.n * 4 * S.cin + (L >> 1)) * plane +
        (size_t)(r.oy0 + (L & 1)) * S.wp;
    unsigned short* dst = st + L * line;
    for (int k = 0; k < r.segs; ++k) {
      const int a = k == 0 ? r.a0 : 0;
      const int end = (k == r.segs - 1 ? r.bl : S.wo - 1) + 2;  // exclusive
      const int w = (end - a + 1) & ~1;
      const int s = k == 0 ? 0 : r.w0 + (k - 1) * wfull;
      const unsigned short* src = src_l + (size_t)k * S.wp + a;
      if (kWord) {
        // Wp even and a even: a + w <= Wp, every word aligned
        for (int q = 2 * lane; q < w; q += 64) cp_async4(dst + s + q, src + q);
      } else {
        for (int q = lane; q < w; q += 32)
          dst[s + q] = a + q < end ? src[q] : (unsigned short)0;
      }
    }
  }
}

// B fragments and bias of channel group `cbase` / 64 .. + cg: fragment
// e = ((c * KS + ks) * 8 + nt) * 32 + lane holds the lane's two
// registers, as the mma reads them.
template <int KS>
__device__ __forceinline__ void stage_weights(const float* wk,
                                              const float* bias, int cbase,
                                              int cg, int taps, int cout,
                                              uint2* wf, float* bs, int tid) {
  for (int e = tid; e < cg * KS * kFrag; e += kThreads) {
    const int ln = e & 31, nt = (e >> 5) & 7, cks = e >> 8;
    const int ks = cks % KS, c = cks / KS;
    const int col = cbase + c * 64 + nt * 8 + (ln >> 2);
    uint32_t reg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ks * 16 + (ln & 3) * 2 + h * 8;
      const float lo =
          (k < taps && col < cout) ? wk[(size_t)k * cout + col] : 0.f;
      const float hi =
          (k + 1 < taps && col < cout) ? wk[(size_t)(k + 1) * cout + col]
                                       : 0.f;
      reg[h] = pack_bf16(bf16_bits(lo), bf16_bits(hi));
    }
    wf[e] = make_uint2(reg[0], reg[1]);
  }
  for (int e = tid; e < cg * 64; e += kThreads)
    bs[e] = cbase + e < cout ? bias[cbase + e] : 0.f;
}

// The threads' store of a run (route b): `s` is at `d`'s address mod 16,
// so the middle leaves in aligned 16-byte streaming stores.
__device__ __forceinline__ void copy_run(unsigned char* d,
                                         const unsigned char* s, int bytes,
                                         int tid) {
  const int head = min(bytes, (int)((16 - ((size_t)d & 15)) & 15));
  const int body = (bytes - head) >> 4;
  for (int e = 2 * tid; e < head; e += 2 * kThreads)
    *reinterpret_cast<unsigned short*>(d + e) =
        *reinterpret_cast<const unsigned short*>(s + e);
  for (int u = tid; u < body; u += kThreads)
    __stcs(reinterpret_cast<uint4*>(d + head) + u,
           reinterpret_cast<const uint4*>(s + head)[u]);
  for (int e = head + (body << 4) + 2 * tid; e < bytes; e += 2 * kThreads)
    *reinterpret_cast<unsigned short*>(d + e) =
        *reinterpret_cast<const unsigned short*>(s + e);
}

// KS k-steps of 16 cover the 9*cin taps (zero past them).
template <int KS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stem_mma_kernel(const unsigned short* __restrict__ ph,
                const float* __restrict__ wk, const float* __restrict__ bias,
                Shape S, Plan P, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char sm_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma group / thread in group
  const int cin = S.cin, cout = S.cout, taps = 9 * cin;
  const int total = S.ho * S.wo;
  const int runs = (total + P.m - 1) / P.m;  // runs of an image
  const int tiles = S.n * runs * P.groups;
  const int ostride = P.groups == 1 ? cout : P.cg * 64;  // buffer row
  const int obytes = P.m * ostride * 2 + 16;
  const int selems = 8 * cin * P.line;  // elements of a stage
  unsigned char* obuf = sm_raw;
  unsigned short* stage =
      reinterpret_cast<unsigned short*>(sm_raw + (P.bulk ? 2 : 1) * obytes);
  uint2* wf = reinterpret_cast<uint2*>(stage + 2 * selems);
  float* bs = reinterpret_cast<float*>(wf + P.cg * KS * kFrag);
  int* slot = reinterpret_cast<int*>(bs + P.cg * 64);  // [2][m]
  Meta* meta = reinterpret_cast<Meta*>(slot + 2 * P.m);   // [2]
  const int wfull = (S.wo + 2) & ~1;
  const bool wide = S.wo >= P.m;
  const bool vec = cout % 8 == 0;  // 16-byte channel runs
  const uint64_t policy = evict_first();

  // where this thread's A columns k = ks*16 + tig*2 + {0,1,8,9} sit in a
  // stage, relative to a pixel's slot; -1 past the taps
  int koff[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = ks * 16 + tig * 2 + (e & 1) + (e >> 1) * 8;
      const int i = k / (3 * cin), j = (k / cin) % 3, c = k % cin;
      koff[ks][e] = k < taps ? ((((i & 1) * 2 + (j & 1)) * cin + c) * 2 +
                                (i >> 1)) * P.line + (j >> 1)
                             : -1;
    }
  }
  if (P.groups == 1)
    stage_weights<KS>(wk, bias, 0, P.cg, taps, cout, wf, bs, tid);

  // stage run `t` into buffer b: its footprint, its pixels' slots and its
  // Meta, each once a tile
  auto prepare = [&](int t, int b) {
    const Run r = run_of(t, S, P, runs);
    if (P.load4)
      stage_run<true>(ph, r, S, P.line, stage + b * selems, warp, lane);
    else
      stage_run<false>(ph, r, S, P.line, stage + b * selems, warp, lane);
    for (int i = tid; i < P.m; i += kThreads)
      slot[b * P.m + i] = i < r.len ? slot_of(r, i, S.wo, wfull, wide) : 0;
    if (tid == 0) meta[b] = Meta{r.pix, r.len, 0};
  };
  int tile = blockIdx.x;
  if (tile < tiles) prepare(tile, 0);
  sm90::cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    // the next run's, while this one computes and stores; buffer (it+1)&1
    // was last read before the previous iteration's second barrier
    const int next = tile + (int)gridDim.x;
    if (next < tiles) prepare(next, (it + 1) & 1);
    sm90::cp_async_commit();
    const int cbase = (P.groups == 1 ? 0 : tile % P.groups) * P.cg * 64;
    if (P.groups > 1)
      stage_weights<KS>(wk, bias, cbase, P.cg, taps, cout, wf, bs, tid);
    cp_async_wait<1>();
    if (P.bulk && tid == 0) bulk_wait_read<1>();  // this buffer was read
    __syncthreads();

    const int b = it & 1;
    const unsigned short* st = stage + b * selems;
    const int* sl = slot + b * P.m;
    const int len = meta[b].len;  // registers: the store below runs past
    unsigned char* ob = obuf + (P.bulk ? b * obytes : 0);  // the barrier
    const int nch = min(P.cg * 64, cout - cbase);  // channels of the tile
    unsigned char* dst = reinterpret_cast<unsigned char*>(out) +
                         ((size_t)meta[b].pix * cout + cbase) * 2;
    // the run sits in the buffer at its output address mod 16 (0 when vec)
    unsigned char* obs = ob + (P.groups == 1 ? (size_t)dst & 15 : 0);
    for (int q = warp; q < (len + 15) >> 4; q += kWarps) {
      const int t0 = q * 16 + g;
      const int s0 = sl[t0], s1 = sl[t0 + 8];
      uint32_t af[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned short v[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = koff[ks][e];
          v[0][e] = o >= 0 ? st[s0 + o] : (unsigned short)0;
          v[1][e] = o >= 0 ? st[s1 + o] : (unsigned short)0;
        }
        af[ks][0] = pack_bf16(v[0][0], v[0][1]);
        af[ks][1] = pack_bf16(v[1][0], v[1][1]);
        af[ks][2] = pack_bf16(v[0][2], v[0][3]);
        af[ks][3] = pack_bf16(v[1][2], v[1][3]);
      }
      for (int c = 0; c * 64 < nch; ++c) {
        uint4 run16[2][2];  // [half of the chunk][row g, g + 8]
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          uint32_t wv[2][4];  // [row][n-tile]: channel pairs, packed
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = hc * 4 + j;
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
              mma16816(acc, af[ks], wf[((c * KS + ks) * kNt + nt) * 32 + lane]);
            const int lc = c * 64 + nt * 8 + tig * 2;  // channel in tile
            const float2 bb = *reinterpret_cast<const float2*>(bs + lc);
            float y[4] = {acc[0] + bb.x, acc[1] + bb.y, acc[2] + bb.x,
                          acc[3] + bb.y};
            if (S.relu) {
#pragma unroll
              for (int e = 0; e < 4; ++e) y[e] = fmaxf(y[e], 0.f);
            }
            if (vec) {
              wv[0][j] = bf162_bits(y[0], y[1]);
              wv[1][j] = bf162_bits(y[2], y[3]);
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(
                    obs + ((t0 + 8 * h) * ostride + lc) * 2);
                if (lc < nch) o[0] = __float2bfloat16_rn(y[2 * h]);
                if (lc + 1 < nch) o[1] = __float2bfloat16_rn(y[2 * h + 1]);
              }
            }
          }
          if (vec) {
            quad_transpose(wv[0], tig);
            quad_transpose(wv[1], tig);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              run16[hc][h] = make_uint4(wv[h][0], wv[h][1], wv[h][2], wv[h][3]);
          }
        }
        if (vec) {
          // lane (g, tig) holds channels (hc*4 + tig)*8 .. + 7 of rows g
          // and g + 8; odd g store the second half first
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int hc = o ^ (g & 1);
              const int lc = c * 64 + (hc * 4 + tig) * 8;
              const uint4 v = hc == 0 ? run16[0][h] : run16[1][h];
              if (lc < nch)
                *reinterpret_cast<uint4*>(
                    ob + ((t0 + 8 * h) * ostride + lc) * 2) = v;
            }
          }
        }
      }
    }
    if (P.bulk) sm90::fence_proxy_async();  // the buffer, to the copy engine
    __syncthreads();

    if (P.bulk) {
      if (tid == 0)
        bulk_store(dst, ob, (uint32_t)len * cout * 2, policy);
    } else if (P.groups == 1) {
      copy_run(dst, obs, len * cout * 2, tid);
    } else {  // each pixel's channels of the group: one row a pixel
      const int units = vec ? nch >> 3 : nch;  // 16 or 2 bytes
      for (int e = tid; e < len * units; e += kThreads) {
        const int row = e / units, u = e - row * units;
        unsigned char* d = dst + (size_t)row * cout * 2;
        const unsigned char* s = ob + row * ostride * 2;
        if (vec)
          __stcs(reinterpret_cast<uint4*>(d) + u,
                 reinterpret_cast<const uint4*>(s)[u]);
        else
          reinterpret_cast<unsigned short*>(d)[u] =
              reinterpret_cast<const unsigned short*>(s)[u];
      }
    }
  }
  if (P.bulk && tid == 0) bulk_wait_all();
}

template <int KS>
int launch_ks(const void* ph, const void* wk, const void* bias,
              const Shape& S, const Plan& P, int grid, int smem, void* out,
              cudaStream_t s) {
  const int e = sm90::set_smem((const void*)stem_mma_kernel<KS>, smem);
  if (e) return e;
  stem_mma_kernel<KS><<<grid, kThreads, smem, s>>>(
      static_cast<const unsigned short*>(ph), static_cast<const float*>(wk),
      static_cast<const float*>(bias), S, P,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

int launch_mma(const void* ph, const void* wk, const void* bias,
               const Shape& S, const Plan& P, int grid, int smem, void* out,
               cudaStream_t s) {
  const int chunks = (S.cout + 63) / 64;
  const uintptr_t pa = (uintptr_t)ph, oa = (uintptr_t)out;
  if (P.m < 16 || P.m > 256 || P.m % 16 || P.line < 2 || P.line % 2 ||
      P.cg < 1 || P.cg > chunks || P.groups != (chunks + P.cg - 1) / P.cg ||
      grid < 1 || (long long)S.ho * S.wo > (1LL << 30) || (oa & 15) ||
      (long long)S.n * ((S.ho * S.wo + P.m - 1) / P.m) * P.groups >
          (1LL << 30) ||
      (P.load4 && (S.wp % 2 || (pa & 3))) ||
      (P.bulk && (P.groups != 1 || S.cout % 8)))
    return (int)cudaErrorInvalidValue;
  if (smem != smem_bytes(S.cin, S.cout, P.m, P.line, P.cg, P.groups,
                         P.bulk) ||
      (size_t)smem > sm90::kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int ks = (9 * S.cin + 15) / 16;
  if (ks == 1) return launch_ks<1>(ph, wk, bias, S, P, grid, smem, out, s);
  if (ks == 2) return launch_ks<2>(ph, wk, bias, S, P, grid, smem, out, s);
  return launch_ks<3>(ph, wk, bias, S, P, grid, smem, out, s);
}

}  // namespace

// Plain C entry, loaded with ctypes.  ph is contiguous (N, 4*cin, Hp, Wp),
// f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), with Hp >= Ho + 1 and
// Wp >= Wo + 1; wk is contiguous f32 (9*cin, cout), rows in (i, j, c)
// order; bias is f32 (cout); out is (N, Ho, Wo, cout) contiguous in the
// phases dtype.  bf16 takes the host plan (ops/kernels.py
// `stem_conv_plan`): m, line, cg, groups, grid, smem, load4, bulk; out
// must start on 16 bytes; a plan that disagrees with `smem_bytes` or a
// route the pointers do not allow is refused.  f32 ignores the plan.
// Launches on `stream`, which must belong to the current device, and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int dcfp_stem_conv3x3_s2(const void* ph, int is_bf16, int n,
                                    int cin, int cout, int hp, int wp,
                                    int ho, int wo, const void* wk,
                                    const void* bias, int relu, void* out,
                                    int m, int line, int cg, int groups,
                                    int grid, int smem, int load4, int bulk,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ho < 1 || wo < 1) return 0;
  if (n < 1 || cin < 1 || cin > 4 || cout < 1 || n > 65535 ||
      hp < ho + 1 || wp < wo + 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const Shape S{n, cin, cout, hp, wp, ho, wo, relu};
    const Plan P{m, line, cg, groups, load4, bulk};
    return launch_mma(ph, wk, bias, S, P, grid, smem, out, s);
  }
  return launch_fma(ph, wk, bias, n, cin, cout, hp, wp, ho, wo, relu, out, s);
}
