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
// under 2 us on the bf16 tensor cores: it is bound by bytes.
//
// bf16 (the deploy path): a tensor-core GEMM, pixels x (9*cin -> 16*KS)
// by (9*cin) x cout, with mma.sync m16n8k16 (bf16 in, f32 sums).  Each
// warp holds the whole weight matrix of a 64-channel chunk in registers
// as B fragments, loaded once, and walks 16-pixel tiles grid-stride;
// each thread gathers its A fragment (two pixels, eight taps) straight
// from the planes, a unit-stride read per tap, so no shared memory is
// used and the only traffic is the planes (from L2 after first touch)
// and the output.  Bias, ReLU and the one rounding follow in registers,
// and each thread stores channel pairs.
//
// f32: the tensor cores would round the inputs, so each thread owns one
// output pixel and 8 of its channels with f32 FMAs; the 27 x cout
// weights and the bias sit in shared memory, read as broadcasts, and the
// 8 threads of a pixel share its 27 phase loads.  Blocks walk the pixels
// grid-stride, so the weights are staged once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- bf16: tensor cores ----

constexpr int kNt = 8;  // n-tiles of 8 channels per warp: a 64-channel chunk

__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo,
                                              unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// KS k-steps of 16 cover the 9*cin taps (zero past them).
template <int KS>
__global__ void __launch_bounds__(kThreads)
stem_mma_kernel(const unsigned short* __restrict__ ph,
                const float* __restrict__ wk, const float* __restrict__ bias,
                int cin, int cout, int hp, int wp, int ho, int wo, int relu,
                __nv_bfloat16* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma group / thread in group
  const int taps = 9 * cin;
  const int n = blockIdx.y;
  const int c0 = blockIdx.z * kNt * 8;  // first channel of this chunk
  const int plane = hp * wp;

  // B fragments (weights) and this thread's bias, held for the kernel
  uint32_t bf[KS][kNt][2];
  float bv[kNt][2];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int col = c0 + nt * 8 + g;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = ks * 16 + tig * 2 + r * 8;
        const float lo = (k < taps && col < cout) ? wk[k * cout + col] : 0.f;
        const float hi =
            (k + 1 < taps && col < cout) ? wk[(k + 1) * cout + col] : 0.f;
        bf[ks][nt][r] = pack_bf16(bf16_bits(lo), bf16_bits(hi));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ch = c0 + nt * 8 + tig * 2 + r;
      bv[nt][r] = ch < cout ? bias[ch] : 0.f;
    }
  }
  // plane offsets of this thread's A columns: k = ks*16 + tig*2 + {0,1,8,9}
  int koff[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = ks * 16 + tig * 2 + (e & 1) + (e >> 1) * 8;
      const int i = k / (3 * cin), j = (k / cin) % 3, c = k % cin;
      koff[ks][e] = k < taps ? (((i & 1) * 2 + (j & 1)) * cin + c) * plane +
                                   (i >> 1) * wp + (j >> 1)
                             : -1;
    }
  }

  const unsigned short* phn = ph + (size_t)n * 4 * cin * plane;
  const int total = ho * wo;
  const int tiles = (total + 15) / 16;
  for (int tile = blockIdx.x * (kThreads / 32) + warp; tile < tiles;
       tile += gridDim.x * (kThreads / 32)) {
    int pix[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pix[h] = tile * 16 + g + 8 * h;
      base[h] = pix[h] < total ? (pix[h] / wo) * wp + pix[h] % wo : -1;
    }
    // A fragments: regs {row g, k..k+1}, {row g+8, k..}, {row g, k+8..},
    // {row g+8, k+8..}
    uint32_t af[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned short v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[h][e] = (base[h] >= 0 && koff[ks][e] >= 0)
                        ? phn[base[h] + koff[ks][e]]
                        : (unsigned short)0;
      af[ks][0] = pack_bf16(v[0][0], v[0][1]);
      af[ks][1] = pack_bf16(v[1][0], v[1][1]);
      af[ks][2] = pack_bf16(v[0][2], v[0][3]);
      af[ks][3] = pack_bf16(v[1][2], v[1][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      if (c0 + nt * 8 >= cout) break;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
            : "r"(af[ks][0]), "r"(af[ks][1]), "r"(af[ks][2]), "r"(af[ks][3]),
              "r"(bf[ks][nt][0]), "r"(bf[ks][nt][1]));
      }
      const int ch = c0 + nt * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (base[h] < 0) continue;
        float y0 = acc[2 * h] + bv[nt][0], y1 = acc[2 * h + 1] + bv[nt][1];
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        __nv_bfloat16* dst = out + ((size_t)n * total + pix[h]) * cout + ch;
        if ((cout & 1) == 0 && ch + 1 < cout) {  // 4-byte aligned pair
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(y0, y1);
        } else {
          if (ch < cout) dst[0] = __float2bfloat16_rn(y0);
          if (ch + 1 < cout) dst[1] = __float2bfloat16_rn(y1);
        }
      }
    }
  }
}

int launch_mma(const void* ph, const void* wk, const void* bias, int n,
               int cin, int cout, int hp, int wp, int ho, int wo, int relu,
               void* out, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = ((long long)ho * wo + 15) / 16;
  const long long need = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap = (long long)(sms > 0 ? sms : 132) * 4;
  const int chunks = (cout + kNt * 8 - 1) / (kNt * 8);
  const dim3 grid((unsigned)(need < cap ? need : cap), n, chunks);
  const unsigned short* p = static_cast<const unsigned short*>(ph);
  const float* w = static_cast<const float*>(wk);
  const float* b = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const int ks = (9 * cin + 15) / 16;
  if (ks == 1)
    stem_mma_kernel<1><<<grid, kThreads, 0, s>>>(p, w, b, cin, cout, hp, wp,
                                                 ho, wo, relu, o);
  else if (ks == 2)
    stem_mma_kernel<2><<<grid, kThreads, 0, s>>>(p, w, b, cin, cout, hp, wp,
                                                 ho, wo, relu, o);
  else
    stem_mma_kernel<3><<<grid, kThreads, 0, s>>>(p, w, b, cin, cout, hp, wp,
                                                 ho, wo, relu, o);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  ph is contiguous (N, 4*cin, Hp, Wp),
// f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), with Hp >= Ho + 1 and
// Wp >= Wo + 1; wk is contiguous f32 (9*cin, cout), rows in (i, j, c)
// order; bias is f32 (cout); out is (N, Ho, Wo, cout) contiguous in the
// phases dtype.  Launches on `stream`, which must belong to the current
// device, and returns cudaGetLastError() (0 on success); it does not
// synchronise.
extern "C" int dcfp_stem_conv3x3_s2(const void* ph, int is_bf16, int n,
                                    int cin, int cout, int hp, int wp,
                                    int ho, int wo, const void* wk,
                                    const void* bias, int relu, void* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ho < 1 || wo < 1) return 0;
  if (n < 1 || cin < 1 || cin > 4 || cout < 1 || n > 65535 || cout > 65535 * 64)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_mma(ph, wk, bias, n, cin, cout, hp, wp, ho, wo, relu, out,
                      s);
  return launch_fma(ph, wk, bias, n, cin, cout, hp, wp, ho, wo, relu, out, s);
}
