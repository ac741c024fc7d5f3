// K1: fused bilinear upsample + channel argmax ("resize_argmax") for Hopper.
//
// Replaces dcfp_tpu/ops/pallas_kernels.py `_kernel`, driven by
// `_resize_argmax_cm` (the TPU kernel behind `resize_argmax` and
// `resize_argmax_cm`).  It computes, for logits z (N, C, h, w),
//
//   out[n, y, x] = argmax_c  sum_ij Wh[y, i] * Ww[x, j] * z[n, c, i, j]
//
// without writing the upsampled (N, C, H, W) logits to device memory.
// z is read through its strides, so both the contiguous (N, C, h, w)
// layout and the channels_last layout the classifier conv leaves on the
// card are read in place, without a copy.
// The numerics follow the unfused argmax(resize_bilinear(z)):
//   * the f32 interpolation matrices of ops/resize.py `_interp_matrix`,
//     of which each row has at most two non-zeros, passed in as per-row
//     and per-column tap tables (indices + the matrices' own weights);
//   * interpolation along H first, then along W, in f32, every product
//     and sum rounded on its own (__fmul_rn / __fadd_rn, so no FMA
//     contraction);
//   * for bf16 logits the value is rounded to bf16 before the compare,
//     as `_kernel` does;
//   * a channel replaces the running best only on a strict `>`, so ties
//     go to the first maximal channel (argmax semantics).
//
// What bounds it on the card: at the deploy shape (C=19, 129x257 ->
// 1025x2049) it reads 1.26 MB of bf16 logits and writes 2.1 MB of labels,
// about 1 us at HBM rate, while the separable interpolation is ~175 M f32
// operations: it is bound by operations, and since every product and sum
// is rounded on its own (no FMA), by instruction issue (~5 us at the f32
// rate with one operation an instruction).
//
// The design: one block owns a tile of TR output rows x TW columns
// (8 x 256 at the deploy shape), planned on the host by ops/kernels.py
// `resize_argmax_plan`.  The taps are non-decreasing, so the tile's source
// footprint is a small rectangle (2 x 33 at scale 8).  For each chunk of
// 32 channels (ascending; fewer where C is smaller) the block
//   1. stages the footprint into shared memory as f32, through the
//      strides, channel-fastest for channels_last and column-fastest for
//      NCHW, with element loads (a pixel of 19 bf16 channels is 38 bytes,
//      so no vector load is aligned);
//   2. runs the H pass once per (tile row, footprint column, channel):
//      the value a = wy0 * z[i0] + wy1 * z[i1] is the same number for all
//      the outputs of a row that share the column, so it is computed once
//      and read by each of them, bit-equal to recomputing it per pixel;
//   3. runs the W pass from shared memory: each thread owns 8 pixels of
//      one row, 32 apart, so a warp's lanes read a few neighbouring
//      columns and its 16-byte loads (4 channels) are mostly broadcasts;
//      bf16 pixels are rounded, compared and selected two at a time
//      (bf16x2), and each pixel's running (best, index) stays in
//      registers across chunks (strict `>`, channels ascending, so the
//      first maximum still wins).
// A column holds the chunk's channels in an odd number of float4 groups,
// so neighbouring columns' groups fall in distinct banks; the padding is
// -inf, which never wins.  The labels go through shared memory, placed so
// that each row's run has the same address mod 16 there as in the output,
// and leave in aligned 16-byte stores, with byte stores at the two ends
// of the run (the row stride, 2049 at the deploy shape, is odd).
// Each tile's footprint must fit in shared memory, so the planner refuses
// a shape where even a 1 x 8 tile's does not (a strong down-sampling of a
// wide row, such as 19 channels of 20000 columns to 8).
// Where the time goes (k46_parts.py): the W pass about a third, the
// staging's global loads, which wait on the tap loads and then hold the
// barrier, about a quarter; registers are capped at 64 so that four
// blocks an SM hide more of that latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPix = 8;           // output pixels a thread owns along a row
constexpr int kChunk = 32;        // channels a block walks at a time
constexpr int kMaxThreads = 256;  // TR * TW / kPix, at most
// blocks of kMaxThreads an SM holds: registers capped at 64, so that
// enough blocks are resident to hide each one's staging loads
constexpr int kMinBlocks = 4;
constexpr long long kSmemMax = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 value to the logits dtype and back.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// w.x * a + w.y * b, each product and the sum rounded on its own
__device__ __forceinline__ float lerp2(float2 w, float a, float b) {
  return __fadd_rn(__fmul_rn(w.x, a), __fmul_rn(w.y, b));
}

// Bytes of one tile row of labels in shared memory: the run of TW labels
// starts at its output address mod 16.
__host__ __device__ __forceinline__ int label_stride(int tw) {
  return (tw + 15 + 15) / 16 * 16;
}

// Floats a footprint column holds in shared memory: the chunk's channels
// in whole float4 groups, an odd number of them, so that neighbouring
// columns' 16-byte groups fall in distinct banks.
__host__ __device__ __forceinline__ int col_stride(int c, int c_chunk) {
  return 4 * ((((c < c_chunk ? c : c_chunk) + 3) / 4) | 1);
}

// Shared memory of one block, in this order:
//   labels [TR][label_stride(TW)] uint8 | row taps [TR] int2, [TR] float2 |
//   staged footprint [SR][SPC][CS] f32 | H pass [TR][SPC][CS] f32
// with CS = col_stride(C, chunk); ops/kernels.py `_k1_smem` is the same
// formula.
long long smem_bytes(int tr, int tw, int span_r, int span_c, int cs) {
  return (long long)tr * label_stride(tw) + tr * 16LL +
         (long long)(span_r + tr) * span_c * cs * 4;
}

// Step 1: the footprint rows 0..sr-1, columns 0..spc-1, channels
// 0..cnt-1 of the chunk (zt points at its first element) into zs.
template <typename T>
__device__ __forceinline__ void stage(float* zs, const T* zt, int cnt, int sr,
                                      int spc, int SPC, int CS, long long sc,
                                      long long sh, long long sw, bool cl,
                                      int tid, int nthr) {
  if (cl) {  // channels innermost: lanes walk the channels, then columns
    for (int ir = 0; ir < sr; ++ir)
      for (int f = tid; f < spc * kChunk; f += nthr) {
        const int cc = f % kChunk, j = f / kChunk;
        if (cc < cnt)
          zs[(ir * SPC + j) * CS + cc] =
              to_f32(zt[ir * sh + j * sw + cc * sc]);
      }
  } else {  // columns innermost: lanes walk the columns
    for (int ir = 0; ir < sr; ++ir)
      for (int f = tid; f < spc * cnt; f += nthr) {
        const int cc = f / spc, j = f - cc * spc;
        zs[(ir * SPC + j) * CS + cc] = to_f32(zt[ir * sh + j * sw + cc * sc]);
      }
  }
}

// Step 2: the H pass of the tile's rows at every footprint column, four
// channels a load; the padding after the chunk's last channel becomes
// -inf, which never wins a strict `>` (its value is -inf or NaN).
__device__ __forceinline__ void h_pass(float* as, const float* zs,
                                       const int2* rtap, const float2* rwt,
                                       int cnt, int rows, int spc, int SPC,
                                       int CS, int tid, int nthr) {
  for (int f = tid; f < rows * spc; f += nthr) {
    const int r = f / spc, j = f - r * spc;
    const int2 t = rtap[r];
    const float2 w = rwt[r];
    const float* a = zs + (t.x * SPC + j) * CS;
    const float* b = zs + (t.y * SPC + j) * CS;
    float* d = as + (r * SPC + j) * CS;
#pragma unroll
    for (int cc = 0; cc < kChunk; cc += 4) {
      if (cc >= cnt) break;
      const float4 p = *reinterpret_cast<const float4*>(a + cc);
      const float4 q = *reinterpret_cast<const float4*>(b + cc);
      float4 v = make_float4(lerp2(w, p.x, q.x), lerp2(w, p.y, q.y),
                             lerp2(w, p.z, q.z), lerp2(w, p.w, q.w));
      if (cc + 1 >= cnt) v.y = -CUDART_INF_F;
      if (cc + 2 >= cnt) v.z = -CUDART_INF_F;
      if (cc + 3 >= cnt) v.w = -CUDART_INF_F;
      *reinterpret_cast<float4*>(d + cc) = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    resize_argmax_kernel(const T* __restrict__ z, int C, long long sn,
                         long long sc, long long sh, long long sw, int H,
                         int W, const int2* __restrict__ ytap,
                         const float2* __restrict__ ywt,
                         const int2* __restrict__ xtap,
                         const float2* __restrict__ xwt,
                         uint8_t* __restrict__ out, int TR, int TW, int SR,
                         int SPC, int CS) {
  // bf16 pixels are rounded, compared and selected in pairs
  constexpr bool kBf16Pairs = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LS = label_stride(TW);
  uint8_t* lab = smem;
  int2* rtap = reinterpret_cast<int2*>(smem + TR * LS);
  float2* rwt = reinterpret_cast<float2*>(rtap + TR);
  float* zs = reinterpret_cast<float*>(rwt + TR);
  float* as = zs + SR * SPC * CS;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TR, n = blockIdx.z;
  const int nx = min(TW, W - x0), ny = min(TR, H - y0);
  // the tile's source footprint (taps are non-decreasing)
  const int rs = ytap[y0].x, sr = ytap[y0 + ny - 1].y - rs + 1;
  const int cs = xtap[x0].x, spc = xtap[x0 + nx - 1].y - cs + 1;
  if (sr > SR || spc > SPC) __trap();  // the plan covers every tile
  if (tid < ny) {
    const int2 t = ytap[y0 + tid];
    rtap[tid] = make_int2(t.x - rs, t.y - rs);
    rwt[tid] = ywt[y0 + tid];
  }

  // this thread: tile row r, and kPix pixels of it, tpr apart (so the
  // lanes of a warp read few footprint columns, and a 16-byte load is
  // mostly a broadcast); pixels past the output's last column repeat it
  // and are skipped in pairs
  const int tpr = TW / kPix;
  const int r = tid / tpr, q = tid - r * tpr;
  auto pix = [&](int k) { return q + k * tpr; };
  int o0[kPix], o1[kPix];
  float2 wx[kPix];
  bool live[kPix / 2];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int x = x0 + min(pix(k), nx - 1);
    const int2 t = xtap[x];
    o0[k] = (r * SPC + t.x - cs) * CS;
    o1[k] = (r * SPC + t.y - cs) * CS;
    wx[k] = xwt[x];
  }
#pragma unroll
  for (int k = 0; k < kPix; k += 2) live[k / 2] = r < ny && pix(k) < nx;
  // running best and index: bf16 pixels in pairs (two bf16 values, two
  // 16-bit indices a register), f32 pixels one by one
  float best[kPix];
  int idx[kPix];
  __nv_bfloat162 best2[kPix / 2];
  unsigned idx2[kPix / 2];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    best[k] = -CUDART_INF_F;
    idx[k] = 0;
  }
#pragma unroll
  for (int k = 0; k < kPix / 2; ++k) {
    best2[k] = __float2bfloat162_rn(-CUDART_INF_F);
    idx2[k] = 0;
  }

  const T* zt = z + n * sn + rs * sh + cs * sw;
  const bool cl = sc < sw;
  stage<T>(zs, zt, min(kChunk, C), sr, spc, SPC, CS, sc, sh, sw, cl, tid,
           nthr);
  __syncthreads();
  h_pass(as, zs, rtap, rwt, min(kChunk, C), ny, spc, SPC, CS, tid, nthr);
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cnt = min(kChunk, C - c0);
    // Step 3: the W pass of this chunk, four channels a load
#pragma unroll
    for (int cc = 0; cc < kChunk; cc += 4) {
      if (cc >= cnt) break;
      if constexpr (kBf16Pairs) {
        const unsigned cpair = (unsigned)(c0 + cc) * 0x10001u;
#pragma unroll
        for (int k = 0; k < kPix; k += 2) {
          if (!live[k / 2]) continue;
          const float4 a0 = *reinterpret_cast<const float4*>(as + o0[k] + cc);
          const float4 a1 = *reinterpret_cast<const float4*>(as + o1[k] + cc);
          const float4 b0 =
              *reinterpret_cast<const float4*>(as + o0[k + 1] + cc);
          const float4 b1 =
              *reinterpret_cast<const float4*>(as + o1[k + 1] + cc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // both pixels rounded to bf16 at once, compared as bf16: the
            // order of bf16 values is that of their f32 widenings
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                lerp2(wx[k], lane(a0, e), lane(a1, e)),
                lerp2(wx[k + 1], lane(b0, e), lane(b1, e)));
            const unsigned m = __hgt2_mask(v, best2[k / 2]);
            best2[k / 2] = __hmax2(best2[k / 2], v);
            idx2[k / 2] = (idx2[k / 2] & ~m) | ((cpair + e * 0x10001u) & m);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (!live[k / 2]) continue;
          const float4 a0 = *reinterpret_cast<const float4*>(as + o0[k] + cc);
          const float4 a1 = *reinterpret_cast<const float4*>(as + o1[k] + cc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v =
                round_to(lerp2(wx[k], lane(a0, e), lane(a1, e)), zt);
            if (v > best[k]) {
              best[k] = v;
              idx[k] = c0 + cc + e;
            }
          }
        }
      }
    }
    if (c0 + kChunk < C) {  // the next chunk: zs is free since the last sync
      const int next = min(kChunk, C - c0 - kChunk);
      stage<T>(zs, zt + (c0 + kChunk) * sc, next, sr, spc, SPC, CS, sc, sh,
               sw, cl, tid, nthr);
      __syncthreads();
      h_pass(as, zs, rtap, rwt, next, ny, spc, SPC, CS, tid, nthr);
      __syncthreads();
    }
  }

  // labels into shared memory at their output address mod 16 ...
  if (r < ny) {
    const uint8_t* g = out + ((long long)n * H + y0 + r) * W + x0;
    uint8_t* s = lab + r * LS + (reinterpret_cast<uintptr_t>(g) & 15);
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const unsigned label =
          kBf16Pairs ? (idx2[k / 2] >> (16 * (k & 1))) & 0xffff : idx[k];
      s[pix(k)] = (uint8_t)label;
    }
  }
  __syncthreads();
  // ... and out: a warp per row, aligned 16-byte words, bytes at the ends
  const int lane_id = tid & 31, warp = tid >> 5;
  const int nwarps = (nthr + 31) >> 5, wl = min(32, nthr - warp * 32);
  for (int rr = warp; rr < ny; rr += nwarps) {
    uint8_t* g = out + ((long long)n * H + y0 + rr) * W + x0;
    const int off = (int)(reinterpret_cast<uintptr_t>(g) & 15);
    const uint8_t* s = lab + rr * LS + off;
    const int head = min(nx, (16 - off) & 15);
    const int words = (nx - head) >> 4;
    const int tail = nx - head - (words << 4);
    for (int i = lane_id; i < words; i += wl)
      *reinterpret_cast<uint4*>(g + head + 16 * i) =
          *reinterpret_cast<const uint4*>(s + head + 16 * i);
    for (int i = lane_id; i < head + tail; i += wl) {
      const int b = i < head ? i : i + 16 * words;
      g[b] = s[b];
    }
  }
}

template <typename T>
int launch(const void* z, int n, int c, long long sn, long long sc,
           long long sh, long long sw, int out_h, int out_w, const void* ytap,
           const void* ywt, const void* xtap, const void* xwt, void* out,
           int tr, int tw, int span_r, int span_c, int cs, long long smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resize_argmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((out_w + tw - 1) / tw, (out_h + tr - 1) / tr, n);
  resize_argmax_kernel<T><<<grid, tr * tw / kPix, (size_t)smem, s>>>(
      static_cast<const T*>(z), c, sn, sc, sh, sw, out_h, out_w,
      static_cast<const int2*>(ytap), static_cast<const float2*>(ywt),
      static_cast<const int2*>(xtap), static_cast<const float2*>(xwt),
      static_cast<uint8_t*>(out), tr, tw, span_r, span_c, cs);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  z is (N, C, h, w) with element
// strides sn, sc, sh, sw, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// ytap/ywt are (H, 2) int32/f32 and xtap/xwt (W, 2); out is contiguous
// (N, H, W) uint8.  The tiling is ops/kernels.py `resize_argmax_plan`'s:
// tr x tw output tiles, p pixels a thread, channels in chunks of c_chunk
// (32), footprints of at most span_r x span_c source pixels,
// smem bytes of shared memory; the entry checks them and refuses
// (cudaErrorInvalidValue) a plan it cannot launch.  Launches on `stream`,
// which must belong to the current device, and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int dcfp_resize_argmax_cm(
    const void* z, int is_bf16, int n, int c, long long sn, long long sc,
    long long sh, long long sw, int out_h, int out_w, const void* ytap,
    const void* ywt, const void* xtap, const void* xwt, void* out, int tr,
    int tw, int p, int c_chunk, int span_r, int span_c, long long smem,
    void* stream) {
  if (out_h < 1 || out_w < 1 || n < 1) return 0;
  const int cs = col_stride(c, c_chunk);
  if (c < 1 || c > 256 || p != kPix || c_chunk != kChunk || tr < 1 ||
      tw < kPix ||
      tw % kPix != 0 || tr * (tw / kPix) > kMaxThreads || span_r < 1 ||
      span_c < 1 || n > 65535 || (out_h + tr - 1) / tr > 65535 ||
      smem != smem_bytes(tr, tw, span_r, span_c, cs) || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(z, n, c, sn, sc, sh, sw, out_h, out_w, ytap,
                                 ywt, xtap, xwt, out, tr, tw, span_r, span_c,
                                 cs, smem, s);
  return launch<float>(z, n, c, sn, sc, sh, sw, out_h, out_w, ytap, ywt, xtap,
                       xwt, out, tr, tw, span_r, span_c, cs, smem, s);
}
