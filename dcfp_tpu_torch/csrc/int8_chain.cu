// K6: the fused int8 bottleneck chain of the int8 probe, for Hopper.
//
// Replaces tools/exp_int8.py `_chain_kernel` (the TPU kernel behind
// `chain_int8`).  For x (H0 + 2D, W, Cin) int8, whose first and last D
// rows are real input rows (the halo), and int8 weights W1 (Cin -> Cm),
// W2 (9 taps, Cm -> Cm), W3 (Cm -> Cout) with f32 scales s1, s2, s3:
//
//   y1  = requant(x W1, s1)                    all H0 + 2D rows
//   y2  = requant(sum_taps y1[tap] W2[tap], s2)  3x3, dilation D, y1's
//                                             columns zero-padded by D
//   out = bf16(float(y2 W3) * s3)              (H0, W, Cout)
//
// with requant(a, s) = int8(clip(rint(float(a) * s), 0, 127)): one f32
// conversion, one f32 multiply, round half to even, ReLU as the lower
// clip.  Every sum is an exact int32 on the tensor cores, so the result
// is bit-exact.  The int32 sums, y1 and y2 never leave the chip.
//
// Tiling: K3's (csrc/bottleneck.cu).  A block owns R x S outputs spaced by
// D (rows ry + D (ty R + r), columns likewise), so the 3x3's taps of the
// whole tile fall on an (R+2) x (S+2) grid of y1 pixels (<= 192), computed
// once into shared memory: conv1 runs (R+2)(S+2) / (RS) ~ 1.4x over at
// 8 x 16.  The grid's rows are real input rows (the halo), and a column
// outside the image is y1 = 0 by itself: x is zero-filled there and
// requant(0, s) == 0.  ops/int8.py `chain_tile` picks R x S and the ring's
// depth from a time model.
//
// Design (csrc/sm90_tile.cuh), 384 threads: two consumer warpgroups and
// one producer warpgroup.  Each product runs in passes of 128 output
// channels on wgmma s8 -> s32.  B, the weights ([output][input],
// zero-padded to multiples of 128 by the wrapper), comes by TMA, 128
// inputs x 128 outputs (16 KB) a stage, into a ring of 2-4 slots with
// full/empty mbarriers, loaded by the producer's thread 0.
//  - conv1: A is x on the grid, whose pixels are spaced by D and so no
//    TMA box: the producer's 128 threads stage them by cp.async (zero
//    fill outside the image) into 128-byte rows in the 128-byte swizzle.
//    Warpgroup i takes channels [64 i, 64 i + 64) of each pass over all
//    the grid's m-tiles (m64n64k32, A by descriptor), and requantizes y1
//    into shared memory.
//  - the 3x3: A comes from registers, by ldmatrix at each tap's shifted
//    rows of y1 (a descriptor cannot address them).  Warpgroup i takes
//    m-tile i of the tile by all 128 channels (m64n128k32), so each A
//    fragment is read once and each B row serves 128 outputs; y2 is
//    requantized into the swizzle in blocks of 128 channels.
//  - conv3: in ping-pong, warpgroup i owns the passes p with p % 2 == i
//    (all 128 channels over both m-tiles, m64n128k32, A = y2 by
//    descriptor) and passes by the other's stages, so one warpgroup's
//    epilogue (bf16 through shared memory, out in 16-byte runs) runs
//    while the other's wgmmas do.
// Each product's first wgmma overwrites its accumulators.  A block whose
// tile lies past the image in its residue class returns at once.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 1,979 TOP/s dense
// int8): at the probe's shape (H0 128, W 256, 1024 -> 256 -> 1024) it
// needs 73 GOP, ~37 us, against 103 MB, ~31 us: operations, barely; at
// the pruned R101's layer3 (129 x 257, 1024 -> 128 -> 1024) 27 GOP
// against 103 MB: bytes.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (k46_parts.py, CUDA events over 30 launches): about 0.111 ms at the
// probe's shape and 0.093 at layer3, against 0.15 for the bf16 cuDNN
// chain at both.  Parts
// switched off each save 5-16%: the wgmmas, x's first read from HBM at
// each wave's start, the requant math, conv3's output stores; the weight
// stream costs nothing.  Times: PERF.md (chip_smoke.py, pair_times.py).

#include "sm90_tile.cuh"

namespace {

using namespace sm90;

typedef __nv_bfloat16 bf16;
constexpr int kCons = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kCons + 1);  // + the producer warpgroup
constexpr int kNc = 128;                     // output channels per pass
constexpr int kKb = 128;                     // K (int8) per stage
constexpr int kSlot = kNc * kKb;             // weight bytes per stage
constexpr int kMaxQ = 192, kMaxP = 128;      // grid and tile pixels

__device__ __forceinline__ int requant(int a, float s) {
  const float f = rintf(__fmul_rn(__int2float_rn(a), s));
  return (int)fminf(fmaxf(f, 0.f), 127.f);
}

struct Geom {
  int Q, P, Qp, Pp, cmp, cinp, coutp, ldy;
  size_t y1, u, bars, goff, poff, total;  // byte offsets and size
};

// The layout of the dynamic shared memory (1024-byte aligned base): the
// weight ring (stages x 16 KB); y1 on the grid (Qp rows of ldy bytes;
// during conv3 the two warpgroups' output buffers, Pp x 128 bytes each);
// y2 on the tile (cmp / 128 blocks of Pp 128-byte swizzled rows), which
// during conv1 holds the x ring instead (stages x Qp rows of 128 bytes,
// swizzled alike); the barriers; the pixel tables.  ops/int8.py
// `chain_smem_bytes` states the same sum.
__host__ __device__ inline Geom geom(int R, int S, int cin, int cm, int cout,
                                     int stages) {
  Geom g;
  g.Q = (R + 2) * (S + 2);
  g.P = R * S;
  g.Qp = (g.Q + 63) / 64 * 64;
  g.Pp = (g.P + 63) / 64 * 64;
  g.cmp = (cm + 127) / 128 * 128;
  g.cinp = (cin + 127) / 128 * 128;
  g.coutp = (cout + 127) / 128 * 128;
  // 16 bytes past a multiple of 128: the 8 rows an ldmatrix reads fall on
  // distinct banks
  g.ldy = g.cmp + 16;
  g.y1 = (size_t)stages * kSlot;
  const size_t y1 = (size_t)g.Qp * g.ldy, ob = (size_t)g.Pp * 256;
  g.u = g.y1 + (y1 > ob ? y1 : ob);
  const size_t y2 = (size_t)g.Pp * g.cmp, xr = (size_t)stages * g.Qp * 128;
  g.bars = g.u + (y2 > xr ? y2 : xr);
  g.goff = g.bars + 2 * stages * sizeof(uint64_t);
  g.poff = g.goff + g.Qp * sizeof(long long);
  g.total = 1024 + g.poff + g.Pp * sizeof(long long);
  return g;
}

// Weights (int8, zero-padded): W1 (cmp, cinp), W2 (9, cmp, cmp),
// W3 (coutp, cmp), each [output][input] (K-major B), read through the
// tensor maps m1, m2 (3D: input, output, tap) and m3 in boxes of 128
// inputs x 128 outputs.
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const __grid_constant__ CUtensorMap m1,
             const __grid_constant__ CUtensorMap m2,
             const __grid_constant__ CUtensorMap m3,
             const unsigned char* __restrict__ x, float s1, float s2,
             float s3, bf16* __restrict__ out, int hp, int w, int cin,
             int cm, int cout, int d, int R, int S, int ny, int nx,
             int stages) {
  const Geom G = geom(R, S, cin, cm, cout, stages);
  const int h0 = hp - 2 * d;
  const int ry = blockIdx.y / ny, ty = blockIdx.y % ny;
  const int rx = blockIdx.x / nx, tx = blockIdx.x % nx;
  // a tile past the image in its residue class: nothing to do
  if (ry + d * ty * R >= h0 || rx + d * tx * S >= w) return;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wring = sm;
  unsigned char* y1 = sm + G.y1;
  unsigned char* y2b = sm + G.u;  // y2 and, during conv1, the x ring
  unsigned char* xring = sm + G.u;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G.bars);
  uint64_t* empty = full + stages;
  long long* goff = reinterpret_cast<long long*>(sm + G.goff);
  long long* poff = reinterpret_cast<long long*>(sm + G.poff);

  // grid pixel q = (r', s') sits at input row ry + D (ty R + r') (output
  // row oy reads input rows oy, oy + D, oy + 2D) and column
  // rx + D (tx S + s' - 1); -1 past the input's rows or columns
  for (int q = threadIdx.x; q < G.Qp; q += kThreads) {
    const int gy = ry + d * (ty * R + q / (S + 2));
    const int gx = rx + d * (tx * S + q % (S + 2) - 1);
    goff[q] = (q < G.Q && gy < hp && gx >= 0 && gx < w)
                  ? ((long long)gy * w + gx) * cin
                  : -1;
  }
  for (int p = threadIdx.x; p < G.Pp; p += kThreads) {
    const int oy = ry + d * (ty * R + p / S);
    const int ox = rx + d * (tx * S + p % S);
    poff[p] = (p < G.P && oy < h0 && ox < w)
                  ? ((long long)oy * w + ox) * cout
                  : -1;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 129);  // thread 0's expect_tx + every producer
      mbar_init(empty + s, kCons * 4);  // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int np1 = G.cmp / kNc;    // passes over y1's and y2's channels
  const int np3 = G.coutp / kNc;  // passes over out's channels
  const int kc1 = G.cinp / kKb, kc2 = G.cmp / kKb;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == kCons) {
    // ---- producer warpgroup: weights by TMA (thread 0, which also
    // arrives with the expected bytes), x by cp.async (all 128 threads),
    // one more full-barrier arrival per thread a stage ----
    reg_dealloc<40>();
    Ring r(stages);
    auto acquire = [&]() { mbar_wait(empty + r.slot, r.phase ^ 1); };
    auto weights_tx = [&]() {
      if (tid == 0) mbar_arrive_tx(full + r.slot, kSlot);
      return wring + r.slot * kSlot;
    };
    auto release = [&]() {  // after this thread's cp.async
      mbar_arrive(full + r.slot);
      r.next();
    };
    for (int p1 = 0; p1 < np1; ++p1) {
      for (int kc = 0; kc < kc1; ++kc) {
        acquire();
        unsigned char* ws = weights_tx();
        if (tid == 0) tma_load_2d(ws, &m1, full + r.slot, kc * kKb, p1 * kNc);
        unsigned char* xs = xring + (size_t)r.slot * G.Qp * 128;
        const int k0 = kc * kKb;
        for (int e = tid; e < G.Qp * 8; e += 128) {
          const int q = e >> 3, c = e & 7;
          const long long off = goff[q];
          const bool ok = off >= 0 && k0 + c * 16 < cin;
          cp_async16(xs + swz128(q, c), ok ? x + off + k0 + c * 16 : x, ok);
        }
        mbar_arrive_cp_async(full + r.slot);
        release();
      }
    }
    for (int p2 = 0; p2 < np1; ++p2)
      for (int tap = 0; tap < 9; ++tap)
        for (int kc = 0; kc < kc2; ++kc) {
          acquire();
          unsigned char* ws = weights_tx();
          if (tid == 0)
            tma_load_3d(ws, &m2, full + r.slot, kc * kKb, p2 * kNc, tap);
          release();
        }
    for (int p3 = 0; p3 < np3; ++p3)
      for (int kc = 0; kc < kc2; ++kc) {
        acquire();
        unsigned char* ws = weights_tx();
        if (tid == 0) tma_load_2d(ws, &m3, full + r.slot, kc * kKb, p3 * kNc);
        release();
      }
    return;
  }

  // ---- consumer warpgroups ----
  reg_alloc<232>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ar = lane & 15, ak = lane >> 4;  // ldmatrix row, 16-byte half
  const int nq = G.Qp / 64, npm = G.Pp / 64;
  const uint32_t y1a = smem_u32(y1), y2a = smem_u32(y2b);
  Ring r(stages);
  int pending = -1;  // the slot whose wgmma group may still be in flight
  auto release = [&](int slot) {
    if (lane == 0) mbar_arrive(empty + slot);
  };
  // after a stage's commit and wait<1>: free the slot of the group before
  auto retire = [&]() {
    if (pending >= 0) release(pending);
    pending = r.slot;
    r.next();
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    if (pending >= 0) release(pending);
    pending = -1;
  };
  // a stage this warpgroup has no work in: wait for it, free it
  auto pass_by = [&]() {
    mbar_wait(full + r.slot, r.phase);
    release(r.slot);
    r.next();
  };
  // Each product's first wgmma overwrites its accumulators (acc = 0), so
  // nothing else writes them while wgmmas are in flight.

  // ---- 1. y1 = requant(x W1, s1) on the grid: zero outside the image's
  // columns by itself (x is zero-filled there), and past cm (W1 is).
  // Warpgroup wg takes channels [64 wg, 64 wg + 64) of each 128-channel
  // pass over all nq m-tiles, m64n64k32 from the x ring. ----
  {
    int acc[3][32];
    auto fence_all = [&]() {
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) fence_acc(acc[mt]);
    };
    for (int p1 = 0; p1 < np1; ++p1) {
      const int col0 = p1 * kNc + wg * 64;
      for (int kc = 0; kc < kc1; ++kc) {
        mbar_wait(full + r.slot, r.phase);
        fence_proxy_async();  // x written by cp.async
        const unsigned char* ws = wring + r.slot * kSlot + wg * 64 * 128;
        const uint32_t abase = smem_u32(xring) + r.slot * G.Qp * 128;
        fence_all();
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t db = desc_b128(ws + ks * 32, 16, 1024);
#pragma unroll
          for (int mt = 0; mt < 3; ++mt)
            if (mt < nq)
              wgmma_s8_ss(acc[mt],
                          desc_b128(abase + mt * 8192 + ks * 32, 16, 1024),
                          db, kc > 0 || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_all();
        retire();
      }
      drain();
      fence_all();
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) {
        if (mt >= nq) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col0 + 8 * j + 2 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q = mt * 64 + warp * 16 + g + 8 * hh;
            const int v0 = requant(acc[mt][4 * j + 2 * hh], s1);
            const int v1 = requant(acc[mt][4 * j + 2 * hh + 1], s1);
            *reinterpret_cast<uint16_t*>(y1 + q * G.ldy + c) =
                (uint16_t)(v0 | (v1 << 8));
          }
        }
      }
    }
  }
  bar_sync(1, kCons * 128);  // y1 complete; the x ring is free for y2

  // ---- 2. y2 = requant(sum_taps y1 W2, s2) on the tile, written in
  // 128-channel blocks of 128-byte-swizzled rows (conv3's A layout).
  // Warpgroup wg takes m-tile wg (if the tile has it) by all 128 channels
  // of each pass, m64n128k32 with A from registers: ldmatrix at each
  // tap's shifted y1 rows (the registers must hold until the group is
  // done, so each stage waits for its own). ----
  {
    int acc[64];
    const bool mine = wg < npm;
    const int pr = wg * 64 + warp * 16 + ar;  // this lane's ldmatrix row
    const uint32_t grow = pr < G.P ? (pr / S) * (S + 2) + pr % S : 0;
    for (int p2 = 0; p2 < np1; ++p2) {
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * (S + 2) + tap % 3;
        for (int kc = 0; kc < kc2; ++kc) {
          if (!mine) {
            pass_by();
            continue;
          }
          mbar_wait(full + r.slot, r.phase);
          const unsigned char* ws = wring + r.slot * kSlot;
          const uint32_t arow = y1a + (grow + shift) * G.ldy + kc * kKb;
          uint32_t a[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            ldsm_x4(a[ks], arow + (2 * ks + ak) * 16);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_s8_rs_n128(acc, a[ks], desc_b128(ws + ks * 32, 16, 1024),
                             tap > 0 || kc > 0 || ks > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              asm volatile("" : "+r"(a[ks][i])::"memory");
          release(r.slot);
          r.next();
        }
      }
      if (!mine) continue;
      unsigned char* blk = y2b + p2 * G.Pp * 128;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t;  // byte within the block
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = wg * 64 + warp * 16 + g + 8 * hh;
          const int v0 = requant(acc[4 * j + 2 * hh], s2);
          const int v1 = requant(acc[4 * j + 2 * hh + 1], s2);
          *reinterpret_cast<uint16_t*>(blk + swz128(p, c >> 4) + (c & 15)) =
              (uint16_t)(v0 | (v1 << 8));
        }
      }
    }
  }
  fence_proxy_async();       // y2 is read by wgmma (the async proxy)
  bar_sync(1, kCons * 128);  // y2 complete; y1 is free

  // ---- 3. out = bf16(float(y2 W3) * s3), ping-pong: warpgroup wg owns
  // the passes p3 with p3 % 2 == wg, all 128 channels over all m-tiles
  // (m64n128k32 from y2), and passes by the other warpgroup's stages, so
  // one warpgroup's epilogue runs while the other's wgmmas do.  With
  // Cout % 8 == 0 the epilogue writes 64 channels at a time into the
  // warpgroup's buffer in y1's room and stores them from there, 16
  // coalesced bytes a thread; otherwise pair by pair from the
  // accumulators. ----
  {
    int acc[2][64];
    auto fence_all = [&]() {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) fence_acc(acc[mt]);
    };
    const bool runs = (cout & 7) == 0;
    unsigned char* ob = y1 + wg * G.Pp * 128;
    for (int p3 = 0; p3 < np3; ++p3) {
      const int col0 = p3 * kNc;
      if (p3 % kCons != wg || col0 >= cout) {
        for (int kc = 0; kc < kc2; ++kc) pass_by();
        continue;
      }
      for (int kc = 0; kc < kc2; ++kc) {
        mbar_wait(full + r.slot, r.phase);
        const unsigned char* ws = wring + r.slot * kSlot;
        const uint32_t abase = y2a + kc * G.Pp * 128;
        fence_all();
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t db = desc_b128(ws + ks * 32, 16, 1024);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (mt < npm)
              wgmma_s8_ss_n128(acc[mt],
                               desc_b128(abase + mt * 8192 + ks * 32, 16,
                                         1024),
                               db, kc > 0 || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_all();
        retire();
      }
      drain();
      fence_all();
      if (runs) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (col0 + 64 * hf >= cout) break;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= npm) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int p = mt * 64 + warp * 16 + g + 8 * hh;
                const int e = 4 * (8 * hf + j) + 2 * hh;
                *reinterpret_cast<__nv_bfloat162*>(ob + swz128(p, j) +
                                                   4 * t) =
                    __floats2bfloat162_rn(
                        __fmul_rn(__int2float_rn(acc[mt][e]), s3),
                        __fmul_rn(__int2float_rn(acc[mt][e + 1]), s3));
              }
            }
          }
          bar_sync(2 + wg, 128);  // the half is in the buffer
          const int c0 = col0 + 64 * hf;
          for (int e = tid; e < G.Pp * 8; e += 128) {
            const int p = e >> 3, c = e & 7;
            const long long off = poff[p];
            if (off >= 0 && c0 + c * 8 < cout)
              *reinterpret_cast<uint4*>(out + off + c0 + c * 8) =
                  *reinterpret_cast<const uint4*>(ob + swz128(p, c));
          }
          bar_sync(2 + wg, 128);  // the buffer is free again
        }
        continue;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= npm) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = col0 + 8 * j + 2 * t;
          if (c >= cout) continue;  // cout is even: c + 1 < cout too
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = mt * 64 + warp * 16 + g + 8 * hh;
            const long long off = p < G.P ? poff[p] : -1;
            if (off < 0) continue;
            *reinterpret_cast<__nv_bfloat162*>(out + off + c) =
                __floats2bfloat162_rn(
                    __fmul_rn(__int2float_rn(acc[mt][4 * j + 2 * hh]), s3),
                    __fmul_rn(__int2float_rn(acc[mt][4 * j + 2 * hh + 1]),
                              s3));
          }
        }
      }
    }
  }
}

}  // namespace

// Plain C entry, loaded with ctypes.  x (hp, w, cin) int8 contiguous on a
// 16-byte boundary; weights int8, contiguous, [output][input], zero-padded
// to multiples of 128 (ops/int8.py `chain_int8_weights`): w1 (cmp, cinp),
// w2 (9, cmp, cmp) with taps (ky * 3 + kx), w3 (coutp, cmp); s1, s2, s3
// the f32 scales; out (hp - 2d, w, cout) bf16.  R x S is the output tile
// (R*S <= 128, (R+2)(S+2) <= 192) and `stages` (2-4) the ring's depth,
// from ops/int8.py `chain_tile`.  Needs cin % 16 == 0, cm % 16 == 0, cout
// even and the shared memory within the device's limit; the wrapper
// checks.  Launches on `stream`, which must belong to the current device,
// and returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int dcfp_chain_int8(const void* x, const void* w1, const void* w2,
                               const void* w3, float s1, float s2, float s3,
                               void* out, int hp, int w, int cin, int cm,
                               int cout, int d, int R, int S, int stages,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || hp <= 2 * d || w < 1 || cin < 16 || cin % 16 || cm < 16 ||
      cm % 16 || cout < 2 || cout % 2 || R < 1 || S < 1 ||
      R * S > kMaxP || (R + 2) * (S + 2) > kMaxQ || stages < 2 || stages > 4)
    return (int)cudaErrorInvalidValue;
  const Geom G = geom(R, S, cin, cm, cout, stages);
  CUtensorMap m1, m2, m3;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const uint32_t box2[2] = {kKb, kNc}, box3[3] = {kKb, kNc, 1};
  {
    const uint64_t dims[2] = {(uint64_t)G.cinp, (uint64_t)G.cmp};
    const uint64_t strides[1] = {(uint64_t)G.cinp};
    if (const int e = make_map(&m1, u8, 2, w1, dims, strides, box2)) return e;
  }
  {
    const uint64_t dims[3] = {(uint64_t)G.cmp, (uint64_t)G.cmp, 9};
    const uint64_t strides[2] = {(uint64_t)G.cmp, (uint64_t)G.cmp * G.cmp};
    if (const int e = make_map(&m2, u8, 3, w2, dims, strides, box3)) return e;
  }
  {
    const uint64_t dims[2] = {(uint64_t)G.cmp, (uint64_t)G.coutp};
    const uint64_t strides[1] = {(uint64_t)G.cmp};
    if (const int e = make_map(&m3, u8, 2, w3, dims, strides, box2)) return e;
  }
  if (const int e = set_smem((const void*)chain_kernel, G.total)) return e;
  const int h0 = hp - 2 * d;
  const int ny = ((h0 + d - 1) / d + R - 1) / R;
  const int nx = ((w + d - 1) / d + S - 1) / S;
  const dim3 grid(d * nx, d * ny);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  chain_kernel<<<grid, kThreads, G.total, s>>>(
      m1, m2, m3, static_cast<const unsigned char*>(x), s1, s2, s3,
      static_cast<bf16*>(out), hp, w, cin, cm, cout, d, R, S, ny, nx, stages);
  return (int)cudaGetLastError();
}
