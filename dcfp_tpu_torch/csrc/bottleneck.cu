// K3: the fused residual bottleneck for Hopper.
//
// Replaces dcfp_tpu/ops/bottleneck.py `_kernel`, driven by
// `flat_bottleneck` (the TPU kernel behind `fused_bottleneck`).  For x
// (N, cin, H, W), read through its strides (contiguous NCHW or
// channels_last), and BN-folded weights W1 (cin -> cm), W2 (9 taps of
// cm -> cm), W3 (cm -> cin) in x's dtype (their layouts per path at the C
// entry) with f32 biases, it computes
//
//   t1 = relu(x W1 + b1)                       rounded to x's dtype
//   t2 = relu(sum_taps t1[tap] W2[tap] + b2)   rounded to x's dtype
//   y  = relu(t2 W3 + b3 + x)                  rounded once
//
// with f32 accumulation, the dilated 3x3 zero-padding t1 (a tap outside
// the image adds 0, not relu(b1)), and writes y in x's layout.  Neither
// t1 nor t2 touches device memory.
//
// Tiling.  A dilated 3x3 reads rows y-d, y, y+d.  A block owns R x S
// output pixels spaced by the dilation (rows ry + d*(ty*R + r), columns
// likewise), so the taps of the whole tile fall on an (R+2) x (S+2) grid
// of t1 pixels, which the block computes once into shared memory: conv1
// is recomputed only on the grid's ring, (R+2)(S+2)/(RS) ~ 1.6x at 8x8,
// for any dilation, and the shared memory needed does not grow with d.
// Then t2 for the tile goes to shared memory, and conv3 + b3 + x, ReLU
// and the store run in chunks of 128 output channels.
//
// Two paths, one tiling.  256 threads = 8 warps per block.
//
// bf16 (the deploy dtype): the three products run on the tensor cores,
// mma.sync m16n8k16 with bf16 inputs and f32 sums.  Each product is a
// (pixels x K) by (K x 128 channels) pass; the 8 warps split it 2 x 4
// over (pixels, channels), each warp 4 (conv1) or 2 (3x3, conv3) m-tiles
// of 16 pixels by 4 n-tiles of 8 channels.  K is staged 64 deep: the
// weights, [output][input] (the B operand's col layout), and for conv1
// the x pixels of the grid, in 16-byte runs into shared memory with
// 144-byte rows; the fragments come from ldmatrix.  ldmatrix takes one
// row address per lane, so the 3x3 reads its A fragments straight from
// the t1 grid at each tap's shift (the dilated gather costs nothing);
// t1 and t2 rows are padded to 4 (mod 8) words so the 8 rows of a matrix
// fall on distinct banks.  Bias, ReLU and the bf16 rounding of t1, t2 and
// y happen on the fragments, in registers.
//
// f32 (exact, for checks): CUDA-core FMAs, since the tensor cores would
// round the inputs.  Lanes own pixels (lane + 32*i), warps 16 consecutive
// channels, each thread up to 4 x 16 (conv1) or 2 x 16 f32 sums; K is
// staged 32 deep, the weights [input][output] as f32 read as float4
// broadcasts, the activations one scalar per pixel on rows whose stride
// is an odd number of words.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense
// bf16): at the pruned R101's layer3 shape (1x1024x129x257 bf16, cm 128,
// d 2) the block reads x once and writes y once, 137 MB, ~41 us, against
// 27 GFLOP, ~27 us: bytes.  At layer4's (2048, cm 256, d 16) 109 GFLOP,
// ~110 us, outweigh 275 MB: operations.  The bf16 path runs at about 55
// and 36 TFLOP/s there (0.50 and 3.0 ms on an H100 at 700 W,
// chip_smoke.py), far from either bound: staging is synchronous (no
// cp.async or TMA ring, so the tensor cores wait on every load), the
// tile is small (<= 64 outputs, so each weight chunk is reused on few
// pixels), and conv1 is redone on the grid's ring.  wgmma with a
// TMA-fed ring and larger tiles is the path to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCo = 128;           // output channels per pass
constexpr int kCw = kCo / kWarps;  // 16 channels per thread
constexpr int kK = 32;             // reduction depth per staging step
constexpr int kGrid = 128;         // t1 grid pixels: 4 per lane
constexpr int kOut = 64;           // output pixels: 2 per lane
constexpr int kXs = kGrid + 1;     // row stride of the x staging buffer

// ---- f32: CUDA-core FMAs ----

// Stage a kK x kCo block of a row-major (rows, cols) weight matrix,
// ws[k][c] = m[(k0 + k) * cols + c0 + c], zero outside.
__device__ __forceinline__ void stage_weights(float* ws, const float* m,
                                              int rows, int cols, int k0,
                                              int c0) {
  for (int e = threadIdx.x; e < kK * kCo; e += kThreads) {
    const int k = e / kCo, c = e % kCo;
    float v = 0.f;
    if (k0 + k < rows && c0 + c < cols)
      v = m[(long long)(k0 + k) * cols + c0 + c];
    ws[e] = v;
  }
}

// This thread's 16 weights of row k of the staged block.
__device__ __forceinline__ void weight_row(const float* ws, int k, int cw0,
                                           float (&wv)[kCw]) {
  const float4* wr = reinterpret_cast<const float4*>(ws + k * kCo + cw0);
#pragma unroll
  for (int v = 0; v < kCw / 4; ++v) {
    const float4 q = wr[v];
    wv[4 * v] = q.x;
    wv[4 * v + 1] = q.y;
    wv[4 * v + 2] = q.z;
    wv[4 * v + 3] = q.w;
  }
}

__global__ void __launch_bounds__(kThreads)
bottleneck_fma_kernel(const float* __restrict__ x, long long sn, long long sc,
                      long long sh, long long sw, int cin, int h, int w,
                      int cm, int d, const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ w3,
                      const float* __restrict__ b3, float* __restrict__ out,
                      int R, int S, int ny, int nx, int ldt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [kK][kCo]
  float* xs = ws + kK * kCo;                        // [kK][kXs]
  float* t1s = xs + kK * kXs;                       // [(R+2)(S+2)][ldt]
  float* t2s = t1s + (R + 2) * (S + 2) * ldt;       // [R*S][ldt]
  // element offset of each grid / output pixel in x, or -1 outside
  __shared__ long long goff[kGrid];
  __shared__ long long poff[kOut];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cw0 = warp * kCw;
  const int Q = (R + 2) * (S + 2), P = R * S;
  const int nq = (Q + 31) / 32, np = (P + 31) / 32;  // lane rows in use
  const int cmp = (cm + kK - 1) / kK * kK;  // t1/t2 columns read
  const int ry = blockIdx.y / ny, ty = blockIdx.y % ny;
  const int rx = blockIdx.x / nx, tx = blockIdx.x % nx;
  const long long base = (long long)blockIdx.z * sn;

  if (threadIdx.x < kGrid) {
    const int q = threadIdx.x;
    const int gy = ry + d * (ty * R + q / (S + 2) - 1);
    const int gx = rx + d * (tx * S + q % (S + 2) - 1);
    goff[q] = (q < Q && gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? base + gy * sh + gx * sw
                  : -1;
  } else if (threadIdx.x < kGrid + kOut) {
    const int p = threadIdx.x - kGrid;
    const int oy = ry + d * (ty * R + p / S);
    const int ox = rx + d * (tx * S + p % S);
    poff[p] = (p < P && oy < h && ox < w) ? base + oy * sh + ox * sw : -1;
  }

  // ---- 1. t1 = relu(x W1 + b1) on the grid, zero outside the image ----
  for (int co0 = 0; co0 < cmp; co0 += kCo) {
    float acc[4][kCw];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCw; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += kK) {
      __syncthreads();
      // xs[k][q] = x[q, k0 + k]: lanes read consecutive channels
      const int k = k0 + lane;
      for (int q = warp; q < kGrid; q += kWarps) {
        const long long off = goff[q];
        xs[lane * kXs + q] =
            (off >= 0 && k < cin) ? x[off + k * sc] : 0.f;
      }
      stage_weights(ws, w1, cin, cm, k0, co0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kK; ++kk) {
        float wv[kCw];
        weight_row(ws, kk, cw0, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < nq) {
            const float a = xs[kk * kXs + lane + 32 * i];
#pragma unroll
            for (int j = 0; j < kCw; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = lane + 32 * i;
      if (q >= Q) continue;
      const bool inside = goff[q] >= 0;
#pragma unroll
      for (int j = 0; j < kCw; ++j) {
        const int c = co0 + cw0 + j;
        if (c >= cmp) continue;
        t1s[q * ldt + c] =
            (inside && c < cm) ? fmaxf(acc[i][j] + b1[c], 0.f) : 0.f;
      }
    }
  }

  // ---- 2. t2 = relu(sum_taps t1 W2 + b2) on the tile ----
  int gbase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = lane + 32 * i;
    gbase[i] = p < P ? (p / S) * (S + 2) + p % S : 0;
  }
  for (int co0 = 0; co0 < cmp; co0 += kCo) {
    float acc[2][kCw];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kCw; ++j) acc[i][j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * (S + 2) + tap % 3;
      const float* row0 = t1s + (gbase[0] + shift) * ldt;
      const float* row1 = t1s + (gbase[1] + shift) * ldt;
      for (int k0 = 0; k0 < cmp; k0 += kK) {
        __syncthreads();
        stage_weights(ws, w2 + (long long)tap * cm * cm, cm, cm, k0, co0);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kK; ++kk) {
          float wv[kCw];
          weight_row(ws, kk, cw0, wv);
          const float a0 = row0[k0 + kk];
#pragma unroll
          for (int j = 0; j < kCw; ++j) acc[0][j] = fmaf(a0, wv[j], acc[0][j]);
          if (np > 1) {
            const float a1 = row1[k0 + kk];
#pragma unroll
            for (int j = 0; j < kCw; ++j)
              acc[1][j] = fmaf(a1, wv[j], acc[1][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = lane + 32 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < kCw; ++j) {
        const int c = co0 + cw0 + j;
        if (c >= cmp) continue;
        t2s[p * ldt + c] = c < cm ? fmaxf(acc[i][j] + b2[c], 0.f) : 0.f;
      }
    }
  }

  // ---- 3. y = relu(t2 W3 + b3 + x), stored in x's layout ----
  for (int co0 = 0; co0 < cin; co0 += kCo) {
    float acc[2][kCw];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kCw; ++j) acc[i][j] = 0.f;
    const float* row0 = t2s + lane * ldt;
    const float* row1 = t2s + (lane + 32) * ldt;
    for (int k0 = 0; k0 < cmp; k0 += kK) {
      __syncthreads();
      stage_weights(ws, w3, cm, cin, k0, co0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kK; ++kk) {
        float wv[kCw];
        weight_row(ws, kk, cw0, wv);
        // t2s has P rows: lanes past them add 0 and store nothing
        const float a0 = lane < P ? row0[k0 + kk] : 0.f;
#pragma unroll
        for (int j = 0; j < kCw; ++j) acc[0][j] = fmaf(a0, wv[j], acc[0][j]);
        if (np > 1) {
          const float a1 = lane + 32 < P ? row1[k0 + kk] : 0.f;
#pragma unroll
          for (int j = 0; j < kCw; ++j) acc[1][j] = fmaf(a1, wv[j], acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = lane + 32 * i;
      if (p >= P) continue;
      const long long off = poff[p];
      if (off < 0) continue;
#pragma unroll
      for (int j = 0; j < kCw; ++j) {
        const int c = co0 + cw0 + j;
        if (c >= cin) continue;
        const long long at = off + c * sc;
        out[at] = fmaxf(acc[i][j] + b3[c] + x[at], 0.f);
      }
    }
  }
}

// Tile bookkeeping shared by both kernels: tiles per residue class of the
// dilation along each axis, and the grid.
dim3 tile_grid(int n, int h, int w, int d, int R, int S, int* ny, int* nx) {
  *ny = ((h + d - 1) / d + R - 1) / R;
  *nx = ((w + d - 1) / d + S - 1) / S;
  return dim3(d * *nx, d * *ny, n);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch_fma(const void* x, int n, int cin, int h, int w, long long sn,
               long long sc, long long sh, long long sw, int cm, int d,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, void* out, int R, int S,
               cudaStream_t s) {
  const int cmp = (cm + kK - 1) / kK * kK;
  const int ldt = cmp + 1;  // row stride: an odd number of words
  const size_t smem = (size_t)(kK * kCo + kK * kXs) * sizeof(float) +
                      (size_t)((R + 2) * (S + 2) + R * S) * ldt * sizeof(float);
  if (const int e = set_smem((const void*)bottleneck_fma_kernel, smem)) return e;
  int ny, nx;
  const dim3 grid = tile_grid(n, h, w, d, R, S, &ny, &nx);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  bottleneck_fma_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), sn, sc, sh, sw, cin, h, w, cm, d,
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<float*>(out), R, S, ny, nx, ldt);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores (ldmatrix + mma.sync m16n8k16, f32 sums) ----

typedef __nv_bfloat16 bf16;
constexpr int kKc = 64;        // reduction depth staged per step
constexpr int kLdx = kKc + 8;  // staging row stride (bf16): 144 B rows
constexpr int kRows = 128;     // staging rows: grid pixels, or channels

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dst[r][k] = m[(r0 + r) * cols + k0 + k] for r < kRows, k < kKc, zero
// outside the row-major (rows, cols) matrix m.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* m, int rows,
                                           int cols, int r0, int k0) {
  if ((cols & 7) == 0) {  // 16-byte runs
    for (int e = threadIdx.x; e < kRows * (kKc / 8); e += kThreads) {
      const int r = e / (kKc / 8), k = (e % (kKc / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < rows && k0 + k < cols)
        v = *reinterpret_cast<const uint4*>(m + (size_t)(r0 + r) * cols +
                                            k0 + k);
      *reinterpret_cast<uint4*>(dst + r * kLdx + k) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kKc; e += kThreads) {
      const int r = e / kKc, k = e % kKc;
      dst[r * kLdx + k] = (r0 + r < rows && k0 + k < cols)
                              ? m[(size_t)(r0 + r) * cols + k0 + k]
                              : __float2bfloat16_rn(0.f);
    }
  }
}

// dst[q][k] = x[q, k0 + k] for the grid pixels q (offsets goff, -1
// outside the image), zero outside.
__device__ __forceinline__ void stage_pixels(bf16* dst, const bf16* x,
                                             const long long* goff,
                                             long long sc, int cin, int k0) {
  if (sc == 1 && (cin & 7) == 0) {  // channels_last: 16-byte runs
    for (int e = threadIdx.x; e < kRows * (kKc / 8); e += kThreads) {
      const int q = e / (kKc / 8), k = (e % (kKc / 8)) * 8;
      const long long off = goff[q];
      uint4 v = make_uint4(0, 0, 0, 0);
      if (off >= 0 && k0 + k < cin)
        v = *reinterpret_cast<const uint4*>(x + off + k0 + k);
      *reinterpret_cast<uint4*>(dst + q * kLdx + k) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kKc; e += kThreads) {
      const int q = e / kKc, k = e % kKc;
      const long long off = goff[q];
      dst[q * kLdx + k] = (off >= 0 && k0 + k < cin)
                              ? x[off + (k0 + k) * sc]
                              : __float2bfloat16_rn(0.f);
    }
  }
}

// Weights: W1 (cm, cin), W2 (9, cm_out, cm_in), W3 (cin, cm), each
// [output channel][input channel], the B operand's "col" layout.
__global__ void __launch_bounds__(kThreads)
bottleneck_mma_kernel(const bf16* __restrict__ x, long long sn, long long sc,
                      long long sh, long long sw, int cin, int h, int w,
                      int cm, int d, const bf16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const bf16* __restrict__ w3,
                      const float* __restrict__ b3, bf16* __restrict__ out,
                      int R, int S, int ny, int nx, int ldt) {
  const int Q = (R + 2) * (S + 2), P = R * S;
  const int Qp = (Q + 15) / 16 * 16, Pp = (P + 15) / 16 * 16;
  const int cmp = (cm + 15) / 16 * 16;  // t1/t2 columns, zero past cm
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kLdx]
  bf16* ws = xs + kRows * kLdx;                   // [kRows][kLdx]
  bf16* t1s = ws + kRows * kLdx;                  // [Qp][ldt]
  bf16* t2s = t1s + Qp * ldt;                     // [Pp][ldt]
  __shared__ long long goff[kGrid];
  __shared__ long long poff[kOut];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;     // mma fragment coordinates
  const int wm = warp >> 2, wn = warp & 3;     // 2 x 4 warps over (M, N)
  // ldmatrix: the A row and k half this lane addresses, and the B
  // (two n-tiles) row and k half
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 8;
  const int br = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 8;
  const int ry = blockIdx.y / ny, ty = blockIdx.y % ny;
  const int rx = blockIdx.x / nx, tx = blockIdx.x % nx;
  const long long base = (long long)blockIdx.z * sn;

  if (threadIdx.x < kGrid) {
    const int q = threadIdx.x;
    const int gy = ry + d * (ty * R + q / (S + 2) - 1);
    const int gx = rx + d * (tx * S + q % (S + 2) - 1);
    goff[q] = (q < Q && gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? base + gy * sh + gx * sw
                  : -1;
  } else if (threadIdx.x < kGrid + kOut) {
    const int p = threadIdx.x - kGrid;
    const int oy = ry + d * (ty * R + p / S);
    const int ox = rx + d * (tx * S + p % S);
    poff[p] = (p < P && oy < h && ox < w) ? base + oy * sh + ox * sw : -1;
  }

  // B fragments of this warp's 4 n-tiles (32 channels) at k-step ks
  auto load_b = [&](uint32_t (&b)[4][2], int ks) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t r[4];
      ldsm_x4(r, ws + (wn * 32 + j * 16 + br) * kLdx + ks * 16 + bk);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
  };

  // ---- 1. t1 = relu(x W1 + b1) on the grid, zero outside the image ----
  for (int co0 = 0; co0 < cmp; co0 += kRows) {
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += kKc) {
      __syncthreads();
      stage_pixels(xs, x, goff, sc, cin, k0);
      stage_rows(ws, w1, cm, cin, co0, k0);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kKc / 16; ++ks) {
        uint32_t b[4][2];
        load_b(b, ks);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mt = wm * 4 + i;
          if (mt * 16 < Qp) {
            uint32_t a[4];
            ldsm_x4(a, xs + (mt * 16 + ar) * kLdx + ks * 16 + ak);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mt = wm * 4 + i;
      if (mt * 16 >= Qp) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = co0 + wn * 32 + j * 8 + tig * 2;
        if (c >= cmp) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = mt * 16 + g + 8 * hh;
          const bool inside = goff[q] >= 0;
          const float v0 = (inside && c < cm)
                               ? fmaxf(acc[i][j][2 * hh] + b1[c], 0.f) : 0.f;
          const float v1 = (inside && c + 1 < cm)
                               ? fmaxf(acc[i][j][2 * hh + 1] + b1[c + 1], 0.f)
                               : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(t1s + q * ldt + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // ---- 2. t2 = relu(sum_taps t1 W2 + b2) on the tile ----
  int grow[2];  // t1 grid row of this lane's ldmatrix row, per m-tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = (wm * 2 + i) * 16 + ar;
    grow[i] = p < P ? (p / S) * (S + 2) + p % S : 0;
  }
  for (int co0 = 0; co0 < cmp; co0 += kRows) {
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * (S + 2) + tap % 3;
      for (int k0 = 0; k0 < cmp; k0 += kKc) {
        __syncthreads();
        stage_rows(ws, w2 + (size_t)tap * cm * cm, cm, cm, co0, k0);
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kKc / 16; ++ks) {
          if (k0 + ks * 16 >= cmp) break;
          uint32_t b[4][2];
          load_b(b, ks);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int mt = wm * 2 + i;
            if (mt * 16 < Pp) {
              uint32_t a[4];
              ldsm_x4(a, t1s + (grow[i] + shift) * ldt + k0 + ks * 16 + ak);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_16816(acc[i][j], a, b[j][0], b[j][1]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = wm * 2 + i;
      if (mt * 16 >= Pp) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = co0 + wn * 32 + j * 8 + tig * 2;
        if (c >= cmp) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = mt * 16 + g + 8 * hh;
          const float v0 =
              c < cm ? fmaxf(acc[i][j][2 * hh] + b2[c], 0.f) : 0.f;
          const float v1 =
              c + 1 < cm ? fmaxf(acc[i][j][2 * hh + 1] + b2[c + 1], 0.f) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(t2s + p * ldt + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // ---- 3. y = relu(t2 W3 + b3 + x), stored in x's layout ----
  const bool pairs = sc == 1 && (cin & 1) == 0;  // 4-byte channel pairs
  for (int co0 = 0; co0 < cin; co0 += kRows) {
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int k0 = 0; k0 < cmp; k0 += kKc) {
      __syncthreads();
      stage_rows(ws, w3, cin, cm, co0, k0);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kKc / 16; ++ks) {
        if (k0 + ks * 16 >= cmp) break;
        uint32_t b[4][2];
        load_b(b, ks);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int mt = wm * 2 + i;
          if (mt * 16 < Pp) {
            uint32_t a[4];
            ldsm_x4(a, t2s + (mt * 16 + ar) * ldt + k0 + ks * 16 + ak);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_16816(acc[i][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = wm * 2 + i;
      if (mt * 16 >= Pp) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = co0 + wn * 32 + j * 8 + tig * 2;
        if (c >= cin) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = mt * 16 + g + 8 * hh;
          if (p >= P) continue;
          const long long off = poff[p];
          if (off < 0) continue;
          const float y0 = acc[i][j][2 * hh] + b3[c];
          if (pairs) {
            const long long at = off + c;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(x + at));
            *reinterpret_cast<__nv_bfloat162*>(out + at) =
                __floats2bfloat162_rn(
                    fmaxf(y0 + xv.x, 0.f),
                    fmaxf(acc[i][j][2 * hh + 1] + b3[c + 1] + xv.y, 0.f));
          } else {
            const long long at = off + c * sc;
            out[at] = __float2bfloat16_rn(
                fmaxf(y0 + __bfloat162float(x[at]), 0.f));
            if (c + 1 < cin) {
              const float y1 = acc[i][j][2 * hh + 1] + b3[c + 1];
              out[at + sc] = __float2bfloat16_rn(
                  fmaxf(y1 + __bfloat162float(x[at + sc]), 0.f));
            }
          }
        }
      }
    }
  }
}

int launch_mma(const void* x, int n, int cin, int h, int w, long long sn,
               long long sc, long long sh, long long sw, int cm, int d,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, void* out, int R, int S,
               cudaStream_t s) {
  const int Qp = ((R + 2) * (S + 2) + 15) / 16 * 16;
  const int Pp = (R * S + 15) / 16 * 16;
  // row stride: 16-byte rows for ldmatrix, 4 (mod 8) words between rows
  // so the eight rows of a matrix fall on distinct banks
  const int ldt = (cm + 15) / 16 * 16 + 8;
  const size_t smem =
      (size_t)(2 * kRows * kLdx + (Qp + Pp) * ldt) * sizeof(bf16);
  if (const int e = set_smem((const void*)bottleneck_mma_kernel, smem)) return e;
  int ny, nx;
  const dim3 grid = tile_grid(n, h, w, d, R, S, &ny, &nx);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  bottleneck_mma_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), sn, sc, sh, sw, cin, h, w, cm, d,
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(w3), static_cast<const float*>(b3),
      static_cast<bf16*>(out), R, S, ny, nx, ldt);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  x is (N, cin, H, W) with element
// strides sn, sc, sh, sw, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); out has
// x's shape and strides.  Weights are contiguous in x's dtype: for f32,
// w1 (cin, cm), w2 (9, cm_in, cm_out), w3 (cm, cin); for bf16 (the
// tensor-core path, B operands [output][input]), w1 (cm, cin),
// w2 (9, cm_out, cm_in), w3 (cin, cm).  b1 (cm), b2 (cm) and b3 (cin) are
// f32.  R x S is the output tile (R*S <= 64, (R+2)(S+2) <= 128).
// Launches on `stream`, which must belong to the current device, and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int dcfp_fused_bottleneck(const void* x, int is_bf16, int n,
                                     int cin, int h, int w, long long sn,
                                     long long sc, long long sh, long long sw,
                                     int cm, int d, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* w3,
                                     const void* b3, void* out, int R, int S,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || cin < 1 || cm < 1 || d < 1 || R < 1 || S < 1 ||
      R * S > kOut || (R + 2) * (S + 2) > kGrid)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_mma(x, n, cin, h, w, sn, sc, sh, sw, cm, d, w1, b1, w2, b2,
                      w3, b3, out, R, S, s);
  return launch_fma(x, n, cin, h, w, sn, sc, sh, sw, cm, d, w1, b1, w2, b2,
                    w3, b3, out, R, S, s);
}
