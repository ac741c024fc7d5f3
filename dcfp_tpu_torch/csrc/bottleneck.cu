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
// Two paths.
//
// bf16 (the deploy dtype), redesigned for Hopper (csrc/sm90_tile.cuh): a
// tile of up to 128 outputs (grid <= 192 t1 pixels), 384 threads = two
// consumer warpgroups and one producer warpgroup.  The three products
// run on wgmma m64n64k16 (bf16 in, f32 sums), each a (pixels x K) by
// (K x 128 channels) pass in which warpgroup i takes channels
// [64 i, 64 i + 64) over all the pass's 64-row m-tiles.  B, the weights
// ([output][input], zero-padded to multiples of 64 once by the wrapper),
// comes from shared memory: the producer's thread 0 loads 64-input x
// 128-output boxes by TMA with the 128-byte swizzle into a ring of 2-4
// 16 KB slots (full/empty mbarriers).  A comes from registers: a wgmma
// descriptor cannot address the dilated gather, so the consumers load
// m16k16 fragments with ldmatrix, as mma.sync did, from the t1 grid at
// each tap's shifted rows (3x3) or from t2 (conv3).  conv1's A is the
// grid's x pixels, strided by d and so no TMA box: the producer's 128
// threads stage them by cp.async in 16-byte runs (an arrival on the full
// barrier fires when they land), into 128-byte rows with the same XOR
// swizzle the ldmatrix addresses undo; the x ring shares its room with
// t2, which conv1 does not use yet.  A block whose tile lies past the
// image in its residue class returns at once.  Bias, ReLU and the bf16
// rounding of t1, t2 and y happen on the accumulators.
//
// f32 (exact, for checks): CUDA-core FMAs, since the tensor cores would
// round the inputs.  256 threads = 8 warps, tiles of <= 64 outputs on a
// grid of <= 128.  Lanes own pixels (lane + 32*i), warps 16 consecutive
// channels, each thread up to 4 x 16 (conv1) or 2 x 16 f32 sums; K is
// staged 32 deep, the weights [input][output] as f32 read as float4
// broadcasts, the activations one scalar per pixel on rows whose stride
// is an odd number of words.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense
// bf16): at the pruned R101's layer3 shape (1x1024x129x257 bf16, cm 128,
// d 2) the block reads x once and writes y once, 137 MB, ~41 us, against
// 27 GFLOP, ~27 us: bytes.  At layer4's (2048, cm 256, d 16) 109 GFLOP,
// ~110 us, outweigh 275 MB: operations.  Beyond the bounds, each block
// restages every weight from L2 and redoes conv1 on its grid's ring
// (192 / 128 pixels at an 8 x 16 tile), and conv1's passes of 128
// channels restage x (twice at cm 256).  conv3's epilogue was the largest
// cost of the first wgmma version: each warpgroup now copies its residual
// slice into shared memory by cp.async while the pass's wgmmas run, adds
// it there and stores y in 16-byte coalesced runs.  Measured
// (chip_smoke.py and pair_times.py, CUDA events over 30 launches, NVIDIA
// H100 80GB HBM3, power limit 700.00 W): layer3 0.236 ms and layer4 0.680
// ms, against 0.489 and 3.00 for the mma.sync version before it in the
// same run and 0.351 and 0.732 for the cuDNN chain; still 5.8x and 6.2x
// the bounds.  The 3x3's wgmmas take A from registers, and ptxas injects
// warpgroup.arrive fences around them (C7519 in the build log).

#include "sm90_tile.cuh"

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

int launch_fma(const void* x, int n, int cin, int h, int w, long long sn,
               long long sc, long long sh, long long sw, int cm, int d,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, void* out, int R, int S,
               cudaStream_t s) {
  const int cmp = (cm + kK - 1) / kK * kK;
  const int ldt = cmp + 1;  // row stride: an odd number of words
  const size_t smem = (size_t)(kK * kCo + kK * kXs) * sizeof(float) +
                      (size_t)((R + 2) * (S + 2) + R * S) * ldt * sizeof(float);
  if (const int e = sm90::set_smem((const void*)bottleneck_fma_kernel, smem))
    return e;
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

// ---- bf16: wgmma, weights by TMA, x by cp.async (csrc/sm90_tile.cuh) ----

typedef __nv_bfloat16 bf16;
constexpr int kCons = 2;                     // consumer warpgroups
constexpr int kMmaThreads = 128 * (kCons + 1);  // + the producer warpgroup
constexpr int kNc = 128;                     // output channels per pass
constexpr int kKs = 64;                      // K (bf16) per stage
constexpr int kSlot = kNc * kKs * 2;         // weight bytes per stage
constexpr int kMaxQ = 192, kMaxP = 128;      // grid and tile pixels

struct MmaGeom {
  int Q, P, Qp, Pp, cmp, cinp, ldt;
  size_t t1, u, bars, goff, poff, total;  // byte offsets and size
};

// The layout of the dynamic shared memory (1024-byte aligned base):
// the weight ring (stages x 16 KB), t1 on the grid (Qp rows of ldt bf16;
// during conv3 the two warpgroups' epilogue buffers, Pp x 128 bytes each),
// then t2 on the tile (cmp / 64 blocks of Pp 128-byte swizzled rows),
// which during conv1 holds the x ring instead (stages x Qp rows of 128
// bytes, swizzled alike), the barriers and the pixel tables.  ops/bottleneck.py `smem_bytes` states the same sum.
__host__ __device__ inline MmaGeom mma_geom(int R, int S, int cin, int cm,
                                            int stages) {
  MmaGeom g;
  g.Q = (R + 2) * (S + 2);
  g.P = R * S;
  g.Qp = (g.Q + 63) / 64 * 64;
  g.Pp = (g.P + 63) / 64 * 64;
  g.cmp = (cm + 63) / 64 * 64;
  g.cinp = (cin + 63) / 64 * 64;
  // 16 bytes past a multiple of 128: the 8 rows an ldmatrix reads fall
  // on distinct banks
  g.ldt = g.cmp + 8;
  g.t1 = (size_t)stages * kSlot;
  // t1's room also holds conv3's epilogue buffers (2 x Pp x 128 bytes)
  const size_t t1 = (size_t)g.Qp * g.ldt * 2, yb = (size_t)g.Pp * 256;
  g.u = g.t1 + (t1 > yb ? t1 : yb);
  const size_t t2 = (size_t)g.Pp * g.cmp * 2, xr = (size_t)stages * g.Qp * 128;
  g.bars = g.u + (t2 > xr ? t2 : xr);
  g.goff = g.bars + 2 * stages * sizeof(uint64_t);
  g.poff = g.goff + g.Qp * sizeof(long long);
  g.total = 1024 + g.poff + g.Pp * sizeof(long long);
  return g;
}

// Weights (bf16, zero-padded to cinp / cmp): W1 (cmp, cinp),
// W2 (9, cmp, cmp), W3 (cinp, cmp), each [output][input] (K-major B),
// read through the tensor maps m1, m2 (3D: input, output, tap) and m3 in
// boxes of 64 inputs x 128 outputs.  Biases f32, unpadded.
__global__ void __launch_bounds__(kMmaThreads, 1)
bottleneck_wgmma_kernel(const __grid_constant__ CUtensorMap m1,
                        const __grid_constant__ CUtensorMap m2,
                        const __grid_constant__ CUtensorMap m3,
                        const bf16* __restrict__ x, long long sn,
                        long long sc, long long sh, long long sw, int cin,
                        int h, int w, int cm, int d,
                        const float* __restrict__ b1,
                        const float* __restrict__ b2,
                        const float* __restrict__ b3, bf16* __restrict__ out,
                        int R, int S, int ny, int nx, int stages) {
  using namespace sm90;
  const MmaGeom G = mma_geom(R, S, cin, cm, stages);
  const int ry = blockIdx.y / ny, ty = blockIdx.y % ny;
  const int rx = blockIdx.x / nx, tx = blockIdx.x % nx;
  // a tile past the image in its residue class: nothing to do
  if (ry + d * ty * R >= h || rx + d * tx * S >= w) return;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wring = sm;
  bf16* t1 = reinterpret_cast<bf16*>(sm + G.t1);
  unsigned char* t2b = sm + G.u;  // t2 and, during conv1, the x ring
  unsigned char* xring = sm + G.u;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G.bars);
  uint64_t* empty = full + stages;
  long long* goff = reinterpret_cast<long long*>(sm + G.goff);
  long long* poff = reinterpret_cast<long long*>(sm + G.poff);
  const long long base = (long long)blockIdx.z * sn;

  for (int q = threadIdx.x; q < G.Qp; q += kMmaThreads) {
    const int gy = ry + d * (ty * R + q / (S + 2) - 1);
    const int gx = rx + d * (tx * S + q % (S + 2) - 1);
    goff[q] = (q < G.Q && gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? base + gy * sh + gx * sw
                  : -1;
  }
  for (int p = threadIdx.x; p < G.Pp; p += kMmaThreads) {
    const int oy = ry + d * (ty * R + p / S);
    const int ox = rx + d * (tx * S + p % S);
    poff[p] = (p < G.P && oy < h && ox < w) ? base + oy * sh + ox * sw : -1;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 129);  // thread 0's expect_tx + every producer
      mbar_init(empty + s, kCons * 4);   // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int np1 = (G.cmp + kNc - 1) / kNc;   // passes over t1's channels
  const int np3 = (G.cinp + kNc - 1) / kNc;  // passes over y's channels
  const int kc1 = G.cinp / kKs, kc2 = G.cmp / kKs;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == kCons) {
    // ---- producer warpgroup: weights by TMA (thread 0, which also
    // arrives with the expected bytes), x by cp.async (all 128 threads),
    // one more full-barrier arrival per thread a stage ----
    reg_dealloc<40>();
    const bool runs = sc == 1 && (cin & 7) == 0;  // 16-byte channel runs
    Ring r(stages);
    auto acquire = [&]() { mbar_wait(empty + r.slot, r.phase ^ 1); };
    auto weights_tx = [&]() {
      if (tid == 0) mbar_arrive_tx(full + r.slot, kSlot);
      return wring + r.slot * kSlot;
    };
    auto release = [&]() {  // after this thread's stores or cp.async
      mbar_arrive(full + r.slot);
      r.next();
    };
    for (int p1 = 0; p1 < np1; ++p1) {
      for (int kc = 0; kc < kc1; ++kc) {
        acquire();
        unsigned char* ws = weights_tx();
        if (tid == 0) tma_load_2d(ws, &m1, full + r.slot, kc * kKs, p1 * kNc);
        unsigned char* xs = xring + (size_t)r.slot * G.Qp * 128;
        const int k0 = kc * kKs;
        if (runs) {
          for (int e = tid; e < G.Qp * 8; e += 128) {
            const int q = e >> 3, c = e & 7;
            const long long off = goff[q];
            const bool ok = off >= 0 && k0 + c * 8 < cin;
            cp_async16(xs + swz128(q, c), ok ? x + off + k0 + c * 8 : x, ok);
          }
          mbar_arrive_cp_async(full + r.slot);
        } else {
          for (int e = tid; e < G.Qp * kKs; e += 128) {
            const int q = e / kKs, k = e % kKs;
            const long long off = goff[q];
            const bf16 v = (off >= 0 && k0 + k < cin)
                               ? x[off + (k0 + k) * sc]
                               : __float2bfloat16_rn(0.f);
            *reinterpret_cast<bf16*>(xs + swz128(q, k >> 3) + (k & 7) * 2) = v;
          }
        }
        release();
      }
    }
    for (int p2 = 0; p2 < np1; ++p2)
      for (int tap = 0; tap < 9; ++tap)
        for (int kc = 0; kc < kc2; ++kc) {
          acquire();
          unsigned char* ws = weights_tx();
          if (tid == 0)
            tma_load_3d(ws, &m2, full + r.slot, kc * kKs, p2 * kNc, tap);
          release();
        }
    for (int p3 = 0; p3 < np3; ++p3)
      for (int kc = 0; kc < kc2; ++kc) {
        acquire();
        unsigned char* ws = weights_tx();
        if (tid == 0) tma_load_2d(ws, &m3, full + r.slot, kc * kKs, p3 * kNc);
        release();
      }
    return;
  }

  // ---- consumer warpgroups: wg owns channels [pass * 128 + wg * 64, +64)
  // of every pass, over all the pass's 64-row m-tiles ----
  reg_alloc<232>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ar = lane & 15, ak = lane >> 4;  // ldmatrix row, 16-byte half
  const int nq = G.Qp / 64, npm = G.Pp / 64;
  const uint32_t t1a = smem_u32(t1), t2a = smem_u32(t2b);
  Ring r(stages);
  int pending = -1;  // the slot whose wgmma group may still be in flight
  float acc[3][32];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  };
  auto fence_all = [&]() {
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) fence_acc(acc[mt]);
  };
  auto release = [&](int slot) {
    if (lane == 0) mbar_arrive(empty + slot);
  };
  // A from shared memory (conv1's x ring, conv3's t2): `abase` is m-tile
  // 0 of the stage's 64 K values in 128-byte-swizzled rows.  One group
  // stays in flight; the slot of the one before it is released.
  auto stage_ss = [&](uint32_t abase, int mts, bool on) {
    mbar_wait(full + r.slot, r.phase);
    if (on) {
      fence_proxy_async();  // x written by cp.async / st.shared
      const unsigned char* ws = wring + r.slot * kSlot + wg * 64 * 128;
      fence_all();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db = desc_b128(ws + ks * 32, 16, 1024);
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
          if (mt < mts)
            wgmma_bf16_ss<0>(acc[mt],
                             desc_b128(abase + mt * 8192 + ks * 32, 16, 1024),
                             db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_all();
    }
    if (pending >= 0) release(pending);
    pending = r.slot;
    r.next();
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    fence_all();
    if (pending >= 0) release(pending);
    pending = -1;
  };
  // A from registers (the 3x3's shifted t1 rows): fragments for every
  // (k16 step, m-tile) by ldmatrix from arow[mt], this lane's row at the
  // stage's first column; the registers must hold until the group is
  // done, so the stage waits for it.
  auto stage_rs = [&](const uint32_t (&arow)[2], int mts, bool on) {
    mbar_wait(full + r.slot, r.phase);
    if (on) {
      const unsigned char* ws = wring + r.slot * kSlot + wg * 64 * 128;
      uint32_t a[4][2][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < mts) ldsm_x4(a[ks][mt], arow[mt] + (2 * ks + ak) * 16);
      fence_all();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db = desc_b128(ws + ks * 32, 16, 1024);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < mts) wgmma_bf16_rs(acc[mt], a[ks][mt], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            asm volatile("" : "+r"(a[ks][mt][i])::"memory");
    }
    release(r.slot);
    r.next();
  };

  // ---- 1. t1 = relu(x W1 + b1) on the grid, zero outside the image ----
  for (int p1 = 0; p1 < np1; ++p1) {
    const int col0 = p1 * kNc + wg * 64;
    const bool on = col0 < G.cmp;
    zero();
    for (int kc = 0; kc < kc1; ++kc)
      stage_ss(smem_u32(xring) + r.slot * G.Qp * 128, nq, on);
    drain();
    if (!on) continue;
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      if (mt >= nq) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + 8 * j + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = mt * 64 + warp * 16 + g + 8 * hh;
          const bool inside = goff[q] >= 0;
          const float v0 = (inside && c < cm)
                               ? fmaxf(acc[mt][4 * j + 2 * hh] + b1[c], 0.f) : 0.f;
          const float v1 = (inside && c + 1 < cm)
                               ? fmaxf(acc[mt][4 * j + 2 * hh + 1] + b1[c + 1], 0.f)
                               : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(t1 + q * G.ldt + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  bar_sync(1, kCons * 128);  // t1 complete; the x ring is free for t2

  // ---- 2. t2 = relu(sum_taps t1 W2 + b2) on the tile, written in
  // 64-channel blocks of 128-byte-swizzled rows (conv3's A layout) ----
  uint32_t grow[2];  // t1 row of this lane's ldmatrix row, per m-tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = mt * 64 + warp * 16 + ar;
    grow[mt] = p < G.P ? (p / S) * (S + 2) + p % S : 0;
  }
  for (int p2 = 0; p2 < np1; ++p2) {
    const int col0 = p2 * kNc + wg * 64;
    const bool on = col0 < G.cmp;
    zero();
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * (S + 2) + tap % 3;
      for (int kc = 0; kc < kc2; ++kc) {
        uint32_t arow[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          arow[mt] = t1a + (grow[mt] + shift) * G.ldt * 2 + kc * kKs * 2;
        stage_rs(arow, npm, on);
      }
    }
    if (!on) continue;
    unsigned char* blk = t2b + (col0 >> 6) * G.Pp * 128;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= npm) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + 8 * j + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = mt * 64 + warp * 16 + g + 8 * hh;
          const float v0 =
              c < cm ? fmaxf(acc[mt][4 * j + 2 * hh] + b2[c], 0.f) : 0.f;
          const float v1 =
              c + 1 < cm ? fmaxf(acc[mt][4 * j + 2 * hh + 1] + b2[c + 1], 0.f)
                         : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(blk + swz128(p, j) + 4 * t) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  fence_proxy_async();       // t2 is read by wgmma (the async proxy)
  bar_sync(1, kCons * 128);  // t2 complete

  // ---- 3. y = relu(t2 W3 + b3 + x), stored in x's layout.  In
  // channels_last with 16-byte channel runs, each warpgroup copies the
  // residual x of its 64 channels into a buffer in t1's room by cp.async
  // while the pass's wgmmas run, adds it there and stores y from there,
  // 16 coalesced bytes a thread; otherwise element by element. ----
  const bool runs = sc == 1 && (cin & 7) == 0;
  const bool pairs = sc == 1 && (cin & 1) == 0;  // 4-byte channel pairs
  unsigned char* yb = sm + G.t1 + wg * G.Pp * 128;
  for (int p3 = 0; p3 < np3; ++p3) {
    const int col0 = p3 * kNc + wg * 64;
    const bool on = col0 < G.cinp;
    if (on && runs) {
      for (int e = tid; e < G.Pp * 8; e += 128) {
        const int p = e >> 3, c = e & 7;
        const long long off = poff[p];
        const bool ok = off >= 0 && col0 + c * 8 < cin;
        cp_async16(yb + swz128(p, c), ok ? x + off + col0 + c * 8 : x, ok);
      }
      cp_async_commit();
    }
    zero();
    for (int kc = 0; kc < kc2; ++kc) stage_ss(t2a + kc * G.Pp * 128, npm, on);
    drain();
    if (!on) continue;
    if (runs) {
      cp_async_wait_all();
      bar_sync(2 + wg, 128);  // the warpgroup's residual has landed
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= npm) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col0 + 8 * j + 2 * t;
          if (c >= cin) continue;  // cin % 8 == 0: c + 1 < cin too
          const float2 bv = make_float2(b3[c], b3[c + 1]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = mt * 64 + warp * 16 + g + 8 * hh;
            __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(
                yb + swz128(p, j) + 4 * t);
            const float2 xv = __bfloat1622float2(*v);
            *v = __floats2bfloat162_rn(
                fmaxf(acc[mt][4 * j + 2 * hh] + bv.x + xv.x, 0.f),
                fmaxf(acc[mt][4 * j + 2 * hh + 1] + bv.y + xv.y, 0.f));
          }
        }
      }
      bar_sync(2 + wg, 128);  // y is in the buffer
      for (int e = tid; e < G.Pp * 8; e += 128) {
        const int p = e >> 3, c = e & 7;
        const long long off = poff[p];
        if (off >= 0 && col0 + c * 8 < cin)
          *reinterpret_cast<uint4*>(out + off + col0 + c * 8) =
              *reinterpret_cast<const uint4*>(yb + swz128(p, c));
      }
      bar_sync(2 + wg, 128);  // the buffer is free for the next pass
      continue;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= npm) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        if (c >= cin) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = mt * 64 + warp * 16 + g + 8 * hh;
          if (p >= G.P) continue;
          const long long off = poff[p];
          if (off < 0) continue;
          const float y0 = acc[mt][4 * j + 2 * hh] + b3[c];
          if (pairs) {
            const long long at = off + c;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(x + at));
            *reinterpret_cast<__nv_bfloat162*>(out + at) =
                __floats2bfloat162_rn(
                    fmaxf(y0 + xv.x, 0.f),
                    fmaxf(acc[mt][4 * j + 2 * hh + 1] + b3[c + 1] + xv.y,
                          0.f));
          } else {
            const long long at = off + c * sc;
            out[at] = __float2bfloat16_rn(
                fmaxf(y0 + __bfloat162float(x[at]), 0.f));
            if (c + 1 < cin) {
              const float y1 = acc[mt][4 * j + 2 * hh + 1] + b3[c + 1];
              out[at + sc] = __float2bfloat16_rn(
                  fmaxf(y1 + __bfloat162float(x[at + sc]), 0.f));
            }
          }
        }
      }
    }
  }
}

int launch_wgmma(const void* x, int n, int cin, int h, int w, long long sn,
                 long long sc, long long sh, long long sw, int cm, int d,
                 const void* w1, const void* b1, const void* w2,
                 const void* b2, const void* w3, const void* b3, void* out,
                 int R, int S, int stages, cudaStream_t s) {
  if (R * S > kMaxP || (R + 2) * (S + 2) > kMaxQ || stages < 2)
    return (int)cudaErrorInvalidValue;
  const MmaGeom G = mma_geom(R, S, cin, cm, stages);
  CUtensorMap m1, m2, m3;
  const CUtensorMapDataType bt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t box2[2] = {kKs, kNc}, box3[3] = {kKs, kNc, 1};
  {
    const uint64_t dims[2] = {(uint64_t)G.cinp, (uint64_t)G.cmp};
    const uint64_t strides[1] = {(uint64_t)G.cinp * 2};
    if (const int e = sm90::make_map(&m1, bt, 2, w1, dims, strides, box2))
      return e;
  }
  {
    const uint64_t dims[3] = {(uint64_t)G.cmp, (uint64_t)G.cmp, 9};
    const uint64_t strides[2] = {(uint64_t)G.cmp * 2,
                                 (uint64_t)G.cmp * G.cmp * 2};
    if (const int e = sm90::make_map(&m2, bt, 3, w2, dims, strides, box3))
      return e;
  }
  {
    const uint64_t dims[2] = {(uint64_t)G.cmp, (uint64_t)G.cinp};
    const uint64_t strides[1] = {(uint64_t)G.cmp * 2};
    if (const int e = sm90::make_map(&m3, bt, 2, w3, dims, strides, box2))
      return e;
  }
  if (const int e = sm90::set_smem((const void*)bottleneck_wgmma_kernel,
                                   G.total))
    return e;
  int ny, nx;
  const dim3 grid = tile_grid(n, h, w, d, R, S, &ny, &nx);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  bottleneck_wgmma_kernel<<<grid, kMmaThreads, G.total, s>>>(
      m1, m2, m3, static_cast<const bf16*>(x), sn, sc, sh, sw, cin, h, w, cm,
      d, static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const float*>(b3), static_cast<bf16*>(out), R, S, ny, nx,
      stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  x is (N, cin, H, W) with element
// strides sn, sc, sh, sw, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); out has
// x's shape and strides.  Weights are contiguous in x's dtype: for f32,
// w1 (cin, cm), w2 (9, cm_in, cm_out), w3 (cm, cin); for bf16 (the wgmma
// path, B operands [output][input], zero-padded to cinp and cmp, cin and
// cm rounded up to 64), w1 (cmp, cinp), w2 (9, cmp, cmp), w3 (cinp, cmp),
// on 16-byte boundaries.  b1 (cm), b2 (cm) and b3 (cin) are f32.  R x S is
// the output tile: f32 R*S <= 64, (R+2)(S+2) <= 128; bf16 R*S <= 128,
// (R+2)(S+2) <= 192, with `stages` (>= 2) slots in its ring (ignored for
// f32).  Launches on `stream`, which must belong to the current device,
// and returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int dcfp_fused_bottleneck(const void* x, int is_bf16, int n,
                                     int cin, int h, int w, long long sn,
                                     long long sc, long long sh, long long sw,
                                     int cm, int d, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* w3,
                                     const void* b3, void* out, int R, int S,
                                     int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || cin < 1 || cm < 1 || d < 1 || R < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_wgmma(x, n, cin, h, w, sn, sc, sh, sw, cm, d, w1, b1, w2,
                        b2, w3, b3, out, R, S, stages, s);
  if (R * S > kOut || (R + 2) * (S + 2) > kGrid)
    return (int)cudaErrorInvalidValue;
  return launch_fma(x, n, cin, h, w, sn, sc, sh, sw, cm, d, w1, b1, w2, b2,
                    w3, b3, out, R, S, s);
}
