// Conv epilogue for Hopper: a conv's bias, the residual add of a ResNet
// block and the ReLU, in one pass over the conv's output.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses a conv's bias add and
// the residual add and ReLU that follow it into the convolution's output.
// The port's deploy body runs cuDNN's conv without its bias and then this
// kernel (engine/deploy.py `fuse_conv_epilogues`, graph/apply.py `_conv`),
// where aten ran up to three passes over the same tensor: the bias add
// (broadcast over the channels_last output, and not vectorized), the
// residual add and the clamp.  For x (N, C, H, W) it computes
//
//   y[n, c, h, w] = act(x[n, c, h, w] + bias[c] (+ r[n, c, h, w]))
//
// in f32, the sums in that order, with one rounding to the tensor's type
// (f32, bf16 or f16); act is the identity or ReLU, which passes NaN as
// torch.relu does.  ops/kernels.py `conv_epilogue_plain` is the same
// contract in plain PyTorch, and the two agree bit for bit.  x, r and y
// are channels_last-contiguous, as the deploy body's convs leave them:
// the channel is the innermost index.
//
// What bounds it: two or three f32 additions an element against two
// (x, y) or three (x, r, y) element reads and writes, far below the
// card's ridge, so it is bound by bytes: (2 or 3) x N*C*H*W x sizeof(T),
// plus the bias, at HBM rate.  On the pruned R101 deploy body at
// 1025x2049 in bf16 that is 9.62 GB a frame over 115 launches, 2.87 ms at
// 3.35 TB/s.
//
// The design: blocks of 256 threads, at most eight an SM, walk the tensor
// in 16-byte vectors (8 bf16 or f16, or 4 f32 elements each of x, r and
// y) in a grid-stride loop.  Each block first reads the bias into shared
// memory as f32, once.  Each thread carries the channel of its vector's
// first element from one step of the loop to the next (the step is
// fixed, so there is no division inside the loop); a vector holds
// consecutive channels, whose biases it reads from shared memory as
// float4s.  x and r are read with the streaming hint: this is their last
// use on the deploy body.  The vector path needs C a multiple of the
// vector width, so that a vector holds whole channels of one pixel, and
// x, r and y 16-byte aligned; otherwise (the classifier's 19 channels,
// an offset view) the same kernel walks single elements.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;         // 2048 threads, an SM's most
constexpr int kSmemMax = 227 * 1024;    // what one block may have on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <bool kRelu>
__device__ __forceinline__ float act(float v) {
  return (kRelu && v < 0.f) ? 0.f : v;  // not fmaxf, which drops NaN
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {  // V elements, moved as one unit
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_last(const T* p, long long k) {
  Pack<T, V> v;
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p) + k);
    v = *reinterpret_cast<const Pack<T, V>*>(&u);
  } else {
    v.e[0] = p[k];
  }
  return v;
}

template <typename T, bool kRes, bool kRelu, int V>
__global__ void __launch_bounds__(kThreads)
    epilogue_elementwise_kernel(const T* __restrict__ x,
                                const T* __restrict__ bias,
                                const T* __restrict__ r, T* __restrict__ y,
                                long long units, int c) {
  extern __shared__ __align__(16) float bias_s[];
  for (int i = threadIdx.x; i < c; i += kThreads) bias_s[i] = to_f32(bias[i]);
  __syncthreads();
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  if (first >= units) return;
  // the channel of the unit's first element (a multiple of V)
  int ch = (int)(first * V % c);
  const int dch = (int)(stride * V % c);
  for (long long k = first; k < units; k += stride) {
    const Pack<T, V> xv = load_last<T, V>(x, k);
    Pack<T, V> rv = xv;
    if (kRes) rv = load_last<T, V>(r, k);
    float b[V];
    if constexpr (V >= 4) {  // V consecutive channels
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(bias_s + ch)[q];
        b[4 * q] = f.x;
        b[4 * q + 1] = f.y;
        b[4 * q + 2] = f.z;
        b[4 * q + 3] = f.w;
      }
    } else {  // one element
      b[0] = bias_s[ch];
    }
    Pack<T, V> yv;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = to_f32(xv.e[j]) + b[j];
      if (kRes) v += to_f32(rv.e[j]);
      yv.e[j] = from_f32<T>(act<kRelu>(v));
    }
    reinterpret_cast<Pack<T, V>*>(y)[k] = yv;
    ch += dch;
    if (ch >= c) ch -= c;
  }
}

template <typename T, bool kRes, bool kRelu, int V>
int launch(const void* x, const void* bias, const void* r, void* y,
           long long n, int c, int sms, cudaStream_t s) {
  auto kernel = epilogue_elementwise_kernel<T, kRes, kRelu, V>;
  const int smem = c * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long units = n / V;
  const long long blocks = (units + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  kernel<<<(int)(blocks < most ? blocks : most), kThreads, (size_t)smem,
           s>>>(static_cast<const T*>(x), static_cast<const T*>(bias),
                static_cast<const T*>(r), static_cast<T*>(y), units, c);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_v(const void* x, const void* bias, const void* r, void* y,
             long long n, int c, int relu, int sms, cudaStream_t s) {
  if (r != nullptr)
    return relu ? launch<T, true, true, V>(x, bias, r, y, n, c, sms, s)
                : launch<T, true, false, V>(x, bias, r, y, n, c, sms, s);
  return relu ? launch<T, false, true, V>(x, bias, r, y, n, c, sms, s)
              : launch<T, false, false, V>(x, bias, r, y, n, c, sms, s);
}

template <typename T>
int launch_as(const void* x, const void* bias, const void* r, void* y,
              long long n, int c, int relu, bool vec, int sms,
              cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  return vec ? launch_v<T, V>(x, bias, r, y, n, c, relu, sms, s)
             : launch_v<T, 1>(x, bias, r, y, n, c, relu, sms, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Plain C entry, loaded with ctypes.  x, r (NULL for none) and y hold n
// elements of channels_last-contiguous (N, C, H, W) tensors; bias holds
// C.  All four share one type: dtype 0 is f32, 1 bf16, 2 f16.  relu = 1
// applies ReLU.  Refuses (cudaErrorInvalidValue) C < 1, an n that is not
// a multiple of C, or a bias that does not fit in shared memory.
// Launches on `stream`, which must belong to the current device, and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int dcfp_conv_epilogue(const void* x, const void* bias,
                                  const void* r, void* y, long long n, int c,
                                  int dtype, int relu, void* stream) {
  if (n == 0) return 0;
  if (c < 1 || n < 0 || n % c != 0 || (long long)c * 4 > kSmemMax ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int v = dtype == 0 ? 4 : 8;  // elements of a 16-byte vector
  const bool vec = c % v == 0 && aligned16(x) && aligned16(y) &&
                   (r == nullptr || aligned16(r));
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_as<__nv_bfloat16>(x, bias, r, y, n, c, relu, vec, sms, s);
  if (dtype == 2)
    return launch_as<__half>(x, bias, r, y, n, c, relu, vec, sms, s);
  return launch_as<float>(x, bias, r, y, n, c, relu, vec, sms, s);
}
