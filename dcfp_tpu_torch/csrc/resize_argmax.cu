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
// about 1 us at HBM rate, while the interpolation is ~40 M pixel-channels
// of a few f32 operations each: it is bound by operations.  The design
// keeps the input (a few MB) resident in L2/L1, so the four neighbour
// loads of each pixel-channel cost cache hits rather than HBM traffic, and
// writes each label once, coalesced (neighbouring threads own
// neighbouring pixels of one row).  Sharing the H pass across a tile in
// shared memory would cut the arithmetic by about half; that is left for
// a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 value to the logits dtype and back.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void resize_argmax_kernel(const T* __restrict__ z, int C,
                                     long long sn, long long sc, long long sh,
                                     long long sw, int H, int W,
                                     const int2* __restrict__ ytap,
                                     const float2* __restrict__ ywt,
                                     const int2* __restrict__ xtap,
                                     const float2* __restrict__ xwt,
                                     uint8_t* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int n = blockIdx.z;

  const int2 iy = ytap[y];
  const float2 wy = ywt[y];
  const int2 ix = xtap[x];
  const float2 wx = xwt[x];
  const long long o00 = iy.x * sh + ix.x * sw, o01 = iy.x * sh + ix.y * sw;
  const long long o10 = iy.y * sh + ix.x * sw, o11 = iy.y * sh + ix.y * sw;

  const T* zc = z + n * sn;
  float best = -CUDART_INF_F;
  int idx = 0;
  for (int c = 0; c < C; ++c, zc += sc) {
    // H pass at the two source columns, then the W pass.
    const float a0 = __fadd_rn(__fmul_rn(wy.x, to_f32(zc[o00])),
                               __fmul_rn(wy.y, to_f32(zc[o10])));
    const float a1 = __fadd_rn(__fmul_rn(wy.x, to_f32(zc[o01])),
                               __fmul_rn(wy.y, to_f32(zc[o11])));
    const float v = round_to(
        __fadd_rn(__fmul_rn(wx.x, a0), __fmul_rn(wx.y, a1)), zc);
    if (v > best) {
      best = v;
      idx = c;
    }
  }
  out[((size_t)n * H + y) * W + x] = (uint8_t)idx;
}

}  // namespace

// Plain C entry, loaded with ctypes.  z is (N, C, h, w) with element
// strides sn, sc, sh, sw, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// ytap/ywt are (H, 2) int32/f32 and xtap/xwt (W, 2); out is contiguous
// (N, H, W) uint8.  Launches on `stream`, which must belong to the current
// device, and returns cudaGetLastError() (0 on success); it does not
// synchronise.
extern "C" int dcfp_resize_argmax_cm(const void* z, int is_bf16, int n, int c,
                                     long long sn, long long sc, long long sh,
                                     long long sw, int out_h, int out_w,
                                     const void* ytap, const void* ywt,
                                     const void* xtap, const void* xwt,
                                     void* out, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((out_w + block.x - 1) / block.x,
                  (out_h + block.y - 1) / block.y, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* yt = static_cast<const int2*>(ytap);
  const float2* yw = static_cast<const float2*>(ywt);
  const int2* xt = static_cast<const int2*>(xtap);
  const float2* xw = static_cast<const float2*>(xwt);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (is_bf16) {
    resize_argmax_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), c, sn, sc, sh, sw, out_h, out_w,
        yt, yw, xt, xw, o);
  } else {
    resize_argmax_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(z), c, sn, sc, sh, sw, out_h, out_w, yt, yw,
        xt, xw, o);
  }
  return (int)cudaGetLastError();
}
