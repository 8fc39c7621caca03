// Phase-regenerating packed NDFT kernels for Hopper (sm_90a), plain C
// interface.
//
// The "doubling" and "direct" modes of the JAX package's ops/pallas_ndft.py
// `_adjoint_kernel` (pallas_call at :326) and `_forward_kernel` (:508), phase
// sources `_build_T6_doubling` (:85) and `_build_T6` (:68): a block reads the
// f32 coordinates x (Dtot, n) of its points and makes cos/sin(2 pi p x) for
// p < P itself instead of reading a table.
//   _adjoint_kernel -> adjoint_regen_tc_kernel (tensor cores, 3xTF32)
//                      + reduce_slices_kernel (tc_common.cuh)
//   _forward_kernel -> forward_kernel (packed_ndft.cuh, CUDA cores)
//
//   DIRECT    one sincospif(2 p x) per mode (exact argument: 2 p is an
//             integer, so sin/cos(pi * 2 p x) never forms 2 pi p x);
//   DOUBLING  one sincospif(2 x), then rows [have, 2 have) = rows
//             [0, have) rotated by e^{i have 2 pi x}, the rotator from row
//             have/2 by the double-angle identity -- the recurrence of
//             _build_T6_doubling, stopped at P.
//
// Widths: the fused path keeps the Nyquist mode, so WR = 2P = N + 2 (34 at
// N = 32, 18 at N = 16): 8 k + 2.
//
// The adjoint, C[(r, a), b] = sum_i (alpha_r[i] L0[a, i]) L1[b, i] per 2-D
// window and v_r[a] = sum_i alpha_r[i] L0[a, i] per 1-D window.
// - Numerics (3xTF32): every float32 operand u is split as big = tf32(u)
//   and small = tf32(u - big) (round to nearest, ties away), and the
//   product is big*big + big*small + small*big on mma.sync.m16n8k8.tf32
//   with float32 accumulation.  The dropped small*small term and the
//   rounding of the small parts leave about 3 * 2^-22 relative per
//   product, where one tf32 product would leave 2^-11.  Tensor-core sums may
//   truncate, so each 64-point tile is summed in fresh accumulators and the
//   tile sums are added in float32 on the CUDA cores.
// - What bounds it on an H100 SXM (published peaks at 700 W): the
//   contraction is 2 nv npairs WR^2 n flops, three times over on the TF32
//   tensor cores (495 TFLOP/s dense): at n = 2e5, three pairs, WR = 34 that
//   is 0.084 ms at nv = 10 and 0.0084 ms at nv = 1.  The coordinates and
//   alpha (5.6-12.8 MB, 2-4 us at 3.35 TB/s) do not bound it.  What holds
//   it back is the rate of mma.sync itself (wgmma is the way to the peak):
//   on an NVIDIA H100 80GB HBM3 at 700 W its time followed the count of
//   HMMA.1688.F32.TF32 instructions, with or without the phase generation,
//   so the design spends no MMA on a pad column and keeps the splits, loads
//   and phases off the tensor pipe's path.
// - Design: one block per (window, point chunk, group of up to 512 / WR
//   right-hand sides) holds every right-hand side of its group, so each
//   point's phases are made once per pass.  M is the flattened (r, a) rows,
//   nv WR of them in 16-row tiles (340 -> 352 at nv = 10, WR = 34: padding
//   each rhs to 48 rows would waste 29%); N is the first WR - 2 columns
//   (tiles of 8); K is points, 8 per MMA.  The last two columns (the
//   Nyquist mode's cos and sin) are CUDA-core FMAs on the A values already
//   in registers: a tensor-core tile for them would be 6/8 padding, a fifth
//   of all MMAs at WR = 34 and a third at 18.  A 1-D window is column 0 of a
//   pair whose L1 row is cos 0 = 1: its blocks, in the same grid, add the A
//   values on the CUDA cores and run beside the pairs' blocks.  Per 64-point
//   tile, threads [0, 64) make L0 and threads [64, 128) make L1 (phases<>,
//   float32) into shared memory, L1 already split into its tf32 parts; the
//   other threads copy alpha with cp.async.  Points are stored so that a
//   thread's two k columns sit side by side (pos()): one 8- or 16-byte load
//   per fragment row, conflict-free.  Two tile buffers: the phases of tile
//   k + 1 are made while the MMAs of tile k run.  The A fragment is formed
//   (alpha * L0) and split in registers.  The warps split the M tiles and,
//   for few M tiles, the 8-point k-steps of a tile (summed through shared
//   memory in a fixed order).  Each chunk writes its own partial slice and
//   reduce_slices_kernel adds them in a fixed order: no atomics,
//   bitwise-repeatable results.
//
// The forward keeps the CUDA-core template of packed_ndft.cuh (one point per
// thread, phases in registers from RegenSrc).

#include "packed_ndft.cuh"
#include "tc_common.cuh"

namespace {

enum PhaseGen { DOUBLING = 0, DIRECT = 1 };

// Rows [HAVE, HAVE + TAKE) = rows [0, TAKE) rotated by e^{i HAVE theta}, the
// rotator from row HAVE/2 by the double-angle identity; then the next block.
// A template recursion, so every index is a compile-time constant and the
// rows stay in registers.
template <int P, int HAVE, int W>
__device__ __forceinline__ void grow_doubling(float (&o)[W]) {
  if constexpr (HAVE < P) {
    constexpr int TAKE = HAVE < P - HAVE ? HAVE : P - HAVE;
    const float ch = o[HAVE / 2], sh = o[P + HAVE / 2];
    const float ck = ch * ch - sh * sh, sk = 2.f * ch * sh;
#pragma unroll
    for (int k = 0; k < TAKE; ++k) {
      o[HAVE + k] = o[k] * ck - o[P + k] * sk;
      o[P + HAVE + k] = o[P + k] * ck + o[k] * sk;
    }
    grow_doubling<P, 2 * HAVE, W>(o);
  }
}

// o[0, P) = cos(2 pi p x), o[P, 2P) = sin(2 pi p x), o[2P, W) = 0.
template <int WR, int GEN, int W>
__device__ __forceinline__ void phases(float x, float (&o)[W]) {
  constexpr int P = WR / 2;
  static_assert(P >= 2 && W >= WR, "unsupported width");
  if constexpr (GEN == DIRECT) {
#pragma unroll
    for (int p = 0; p < P; ++p) sincospif(2.f * p * x, &o[P + p], &o[p]);
  } else {
    o[0] = 1.f;
    o[P] = 0.f;
    sincospif(2.f * x, &o[P + 1], &o[1]);
    grow_doubling<P, 2, W>(o);
  }
#pragma unroll
  for (int a = WR; a < W; ++a) o[a] = 0.f;
}

template <int WR, int GEN>
struct RegenSrc {
  const float* x;  // (Dtot, n) coordinates
  int n;

  template <int W>
  __device__ __forceinline__ void column(int j, int i, bool live, float (&out)[W]) const {
    phases<WR, GEN>(live ? __ldg(x + (size_t)j * n + i) : 0.f, out);
#pragma unroll
    for (int a = 0; a < W; ++a) out[a] = live ? out[a] : 0.f;
  }
};

// --- the adjoint on the tensor cores (3xTF32) -----------------------------------------

constexpr int RG_ROWS = 512;         // M rows (rhs x WR) per block: 32 tiles of 16
constexpr int RG_LD0 = TP + 8;       // L0 / alpha row (floats): float2 fragment reads hit 32 banks
constexpr int RG_LD1 = 2 * TP + 16;  // L1 row of (big, small) words: uint4 fragment reads hit 32 banks

// Inside each 8-point k-step a tile stores point k at slot pos(k), so that
// points t and t + 4 -- the two k columns of one thread's A and B fragments
// -- sit side by side: one float2 (L0, alpha) or uint4 (L1's big and small
// parts of both) load per fragment row.
__device__ __forceinline__ int pos(int k) { return (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1); }

// u rounded to tf32 (to nearest, ties away from zero: cvt.rna.tf32.f32's
// value for a finite u, by an integer add and a mask -- the instruction
// spends three where this spends two) as a float32 bit pattern whose low 13
// bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float u) { return (__float_as_uint(u) + 0x1000u) & 0xffffe000u; }

// u = big + small to about 2^-22 |u|: small = tf32(u - big), from the
// rounded big (u - big is exact: both lie within a factor 2 of each other)
__device__ __forceinline__ void split_tf32(float u, uint32_t& big, uint32_t& small) {
  big = tf32_rna(u);
  small = tf32_rna(__fsub_rn(u, __uint_as_float(big)));
}

// D += A B, A 16x8 (row), B 8x8 (col), tf32 in, float32 accumulate
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one tile buffer, points in pos() order: L0 (float32); L1 as (big, small)
// tf32 parts per point, except its last two rows (the tensor cores take
// none of them), which hold (the float32 value, 0); alpha of the block's
// right-hand sides and zero rows for the pad M rows
template <int WR>
struct RegenTile {
  static constexpr int RA = RG_ROWS / WR + 1;
  float L0[WR][RG_LD0];
  uint32_t L1[WR][RG_LD1];
  float al[RA][RG_LD0];
};

// One chunk's partial sums for a group of up to RG_ROWS / WR right-hand
// sides.  blockIdx.y < npairs: a 2-D window, C[(r, a), b] for b < WR - 2 on
// the tensor cores (NTC tiles of 8 columns) and the last two columns (the
// Nyquist mode's cos and sin: WR = 8 k + 2) by CUDA-core FMAs on the same A
// values.  blockIdx.y >= npairs: a 1-D window, v_r[a] = sum_i A[(r, a), i],
// on the CUDA cores (column b = 0 of a pair whose L1 row is cos 0 = 1; no L1,
// no MMA).  NW warps, WK along the 8 k-steps of a tile, NW / WK along M with
// up to MPW M tiles each (mt = wm + WM q).  With one M tile per warp, three
// blocks fit an SM.
template <int WR, int GEN, int NW, int WK, int MPW>
__global__ void __launch_bounds__(NW * 32, MPW == 1 ? 3 : 1) adjoint_regen_tc_kernel(
    const float* __restrict__ x, int n, const float* __restrict__ alpha, int nv, Rows pairs, int npairs,
    Rows singles, int nsingles, int chunk, float* __restrict__ part, size_t S) {
  using T = RegenTile<WR>;
  constexpr int NTC = (WR - 2) / 8, WM = NW / WK, KPW = TP / 8 / WK, RBMAX = RG_ROWS / WR, NTH = NW * 32;
  static_assert(WR % 8 == 2 && NTH > 2 * TP && (TP / 8) % WK == 0, "unsupported width or launch configuration");
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [2]
  const int c = blockIdx.x, w = blockIdx.y, r0 = blockIdx.z * RBMAX;
  const bool single = w >= npairs;
  const int rb = min(RBMAX, nv - r0);
  const int mrows = rb * WR, mtb = (mrows + 15) / 16;
  const int i_begin = c * chunk, i_end = min(n, i_begin + chunk);
  const int ntiles = (i_end - i_begin + TP - 1) / TP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wk = warp / WM;

  // constant zeros of both buffers: alpha's rows past the group
  for (int idx = tid; idx < 2 * (T::RA - rb) * TP; idx += NTH) {
    const int rem = idx % ((T::RA - rb) * TP);
    tiles[idx / ((T::RA - rb) * TP)].al[rb + rem / TP][rem % TP] = 0.f;
  }

  // each of the warp's M rows m = (r, a) flattened: the offsets of its L0 row
  // a and alpha row r (a pad row, m >= rb WR, reads the zero row rb) at the
  // thread's fragment slot 2 t
  int oL[MPW][2], oA[MPW][2];
#pragma unroll
  for (int q = 0; q < MPW; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm + WM * q) * 16 + g + 8 * h, r = min(m / WR, rb);
      oL[q][h] = (m - m / WR * WR) * RG_LD0 + 2 * t;
      oA[q][h] = r * RG_LD0 + 2 * t;
    }

  // phase makers: threads [0, TP) make L0 of their point, threads [TP, 2 TP)
  // L1 (a 2-D window only); the others copy alpha
  const int ii_g = tid % TP, p_g = pos(ii_g);
  const int makers = single ? TP : 2 * TP;
  const int jrow = single ? singles.v[w - npairs] : pairs.v[2 * w + (tid < TP ? 0 : 1)];
  const float* xrow = x + (size_t)jrow * n;
  auto load_x = [&](int i0) { return tid < makers && i0 + ii_g < i_end ? __ldg(xrow + i0 + ii_g) : 0.f; };
  // phases of the points [i0, i0 + TP) from their coordinates xv (one per
  // maker, 0 past i_end), and alpha's rows by cp.async (zero past i_end)
  auto stage = [&](T& tl, int i0, float xv) {
    if (tid < makers) {
      const bool live = i0 + ii_g < i_end;
      float col[WR];
      phases<WR, GEN>(xv, col);
      if (tid < TP) {
#pragma unroll
        for (int a = 0; a < WR; ++a) tl.L0[a][p_g] = live ? col[a] : 0.f;
      } else {
#pragma unroll
        for (int a = 0; a < WR; ++a) {
          const float u = live ? col[a] : 0.f;
          uint2 v = make_uint2(__float_as_uint(u), 0u);
          if (a < WR - 2) split_tf32(u, v.x, v.y);
          *reinterpret_cast<uint2*>(&tl.L1[a][2 * p_g]) = v;
        }
      }
    } else if (tid >= 2 * TP) {
      for (int idx = tid - 2 * TP; idx < rb * TP; idx += NTH - 2 * TP) {
        const int r = idx / TP, ii = idx % TP, i = i0 + ii;
        const float* src = alpha + (size_t)(r0 + r) * n;
        cp_async4(&tl.al[r][pos(ii)], i < i_end ? src + i : src, i < i_end ? 4 : 0);
      }
    }
  };

  // racc: the tensor-core columns; ex[q][2 h + cc]: row g + 8 h, column
  // WR - 2 + cc (a 1-D window: cc = 0 holds v)
  float racc[MPW][NTC][4], ex[MPW][4];
#pragma unroll
  for (int q = 0; q < MPW; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ex[q][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NTC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) racc[q][j][e] = 0.f;
  }

  float xv = load_x(i_begin);
  stage(tiles[0], i_begin, xv);
  cp_commit();
  if (ntiles > 1) xv = load_x(i_begin + TP);
  cp_wait<0>();
  __syncthreads();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {  // tile it + 1 into the other buffer, read last in tile it - 1
      stage(tiles[(it + 1) & 1], i_begin + (it + 1) * TP, xv);
      if (it + 2 < ntiles) xv = load_x(i_begin + (it + 2) * TP);
    }
    cp_commit();

    const T& tl = tiles[it & 1];
    if (single) {
#pragma unroll
      for (int e = 0; e < KPW; ++e) {
        const int kb = (wk + WK * e) * 8;
#pragma unroll
        for (int q = 0; q < MPW; ++q) {
          if (wm + WM * q < mtb) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 av = *reinterpret_cast<const float2*>(&tl.al[0][0] + oA[q][h] + kb);
              const float2 lv = *reinterpret_cast<const float2*>(&tl.L0[0][0] + oL[q][h] + kb);
              ex[q][2 * h] = fmaf(av.x, lv.x, ex[q][2 * h]);
              ex[q][2 * h] = fmaf(av.y, lv.y, ex[q][2 * h]);
            }
          }
        }
      }
    } else {
      float tacc[MPW][NTC][4];
#pragma unroll
      for (int q = 0; q < MPW; ++q)
#pragma unroll
        for (int j = 0; j < NTC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[q][j][e] = 0.f;
#pragma unroll
      for (int e = 0; e < KPW; ++e) {
        const int kb = (wk + WK * e) * 8;
        uint32_t bb[NTC][2], bs[NTC][2];  // L1 fragments (big, small), shared by the warp's M tiles
#pragma unroll
        for (int j = 0; j < NTC; ++j) {
          const uint4 v = *reinterpret_cast<const uint4*>(&tl.L1[j * 8 + g][2 * (kb + 2 * t)]);
          bb[j][0] = v.x;
          bs[j][0] = v.y;
          bb[j][1] = v.z;
          bs[j][1] = v.w;
        }
        // the last two L1 rows at the thread's points t, t + 4
        const uint4 n0 = *reinterpret_cast<const uint4*>(&tl.L1[WR - 2][2 * (kb + 2 * t)]);
        const uint4 n1 = *reinterpret_cast<const uint4*>(&tl.L1[WR - 1][2 * (kb + 2 * t)]);
#pragma unroll
        for (int q = 0; q < MPW; ++q) {
          if (wm + WM * q < mtb) {
            const float2 a0 = *reinterpret_cast<const float2*>(&tl.al[0][0] + oA[q][0] + kb);
            const float2 a1 = *reinterpret_cast<const float2*>(&tl.al[0][0] + oA[q][1] + kb);
            const float2 l0 = *reinterpret_cast<const float2*>(&tl.L0[0][0] + oL[q][0] + kb);
            const float2 l1 = *reinterpret_cast<const float2*>(&tl.L0[0][0] + oL[q][1] + kb);
            // A at rows (g, g + 8) x columns (t, t + 4)
            const float v0 = __fmul_rn(a0.x, l0.x), v1 = __fmul_rn(a1.x, l1.x);
            const float v2 = __fmul_rn(a0.y, l0.y), v3 = __fmul_rn(a1.y, l1.y);
            uint32_t Ab[4], As[4];
            split_tf32(v0, Ab[0], As[0]);
            split_tf32(v1, Ab[1], As[1]);
            split_tf32(v2, Ab[2], As[2]);
            split_tf32(v3, Ab[3], As[3]);
            // term-major: NTC independent accumulators between dependent MMAs
#pragma unroll
            for (int j = 0; j < NTC; ++j) mma1688(tacc[q][j], As, bb[j][0], bb[j][1]);
#pragma unroll
            for (int j = 0; j < NTC; ++j) mma1688(tacc[q][j], Ab, bs[j][0], bs[j][1]);
#pragma unroll
            for (int j = 0; j < NTC; ++j) mma1688(tacc[q][j], Ab, bb[j][0], bb[j][1]);
            ex[q][0] = fmaf(v2, __uint_as_float(n0.z), fmaf(v0, __uint_as_float(n0.x), ex[q][0]));
            ex[q][1] = fmaf(v2, __uint_as_float(n1.z), fmaf(v0, __uint_as_float(n1.x), ex[q][1]));
            ex[q][2] = fmaf(v3, __uint_as_float(n0.z), fmaf(v1, __uint_as_float(n0.x), ex[q][2]));
            ex[q][3] = fmaf(v3, __uint_as_float(n1.z), fmaf(v1, __uint_as_float(n1.x), ex[q][3]));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < MPW; ++q)
#pragma unroll
        for (int j = 0; j < NTC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) racc[q][j][e] += tacc[q][j][e];
    }
    cp_wait<0>();
    __syncthreads();  // tile it + 1 landed; every reader of tile it is done
  }

  if constexpr (WK > 1) {  // add the k-split's partial sums in a fixed order (wk = 0, 1, ...)
    float* red = reinterpret_cast<float*>(smem);  // the buffers are idle: [WK - 1][WM][E][32]
    constexpr int E = MPW * (NTC + 1) * 4;
    static_assert((WK - 1) * WM * E * 32 * 4 <= 2 * sizeof(T), "exchange exceeds the tile buffers");
    auto slot = [&](int k, int q, int j, int e) -> float& {  // j = NTC: ex
      return red[(((k - 1) * WM + wm) * E + (q * (NTC + 1) + j) * 4 + e) * 32 + lane];
    };
    if (wk > 0) {
#pragma unroll
      for (int q = 0; q < MPW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < NTC; ++j) slot(wk, q, j, e) = racc[q][j][e];
          slot(wk, q, NTC, e) = ex[q][e];
        }
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int k = 1; k < WK; ++k)
#pragma unroll
      for (int q = 0; q < MPW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < NTC; ++j) racc[q][j][e] += slot(k, q, j, e);
          ex[q][e] += slot(k, q, NTC, e);
        }
  }

  // the CUDA-core sums cover the thread's points t, t + 4: add the quad's
  // four in a fixed order (every lane gets the same sum)
#pragma unroll
  for (int q = 0; q < MPW; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ex[q][e] += __shfl_xor_sync(0xffffffffu, ex[q][e], 1);
      ex[q][e] += __shfl_xor_sync(0xffffffffu, ex[q][e], 2);
    }

  float* slice = part + (size_t)c * S;
#pragma unroll
  for (int q = 0; q < MPW; ++q) {
    const int mt = wm + WM * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * 16 + g + 8 * h;
      if (mt < mtb && m < mrows) {
        const int r = m / WR, a = m - r * WR;
        if (single) {
          if (t == 0) slice[(size_t)nv * npairs * WR * WR + ((size_t)(r0 + r) * nsingles + w - npairs) * WR + a] = ex[q][2 * h];
        } else {
          float* o = slice + ((size_t)(r0 + r) * npairs + w) * WR * WR + a * WR;
#pragma unroll
          for (int j = 0; j < NTC; ++j)  // columns 8 j + 2 t, + 1
            *reinterpret_cast<float2*>(o + j * 8 + 2 * t) = make_float2(racc[q][j][2 * h], racc[q][j][2 * h + 1]);
          if (t == 0) *reinterpret_cast<float2*>(o + WR - 2) = make_float2(ex[q][2 * h], ex[q][2 * h + 1]);
        }
      }
    }
  }
}

template <int WR, int GEN, int NW, int WK, int MPW>
int launch_regen_tc(const float* x, int n, const float* alpha, int nv, const Rows& pairs, int npairs,
                    const Rows& singles, int nsingles, float* part, int nchunks, int chunk, size_t S,
                    cudaStream_t st) {
  constexpr int RBMAX = RG_ROWS / WR;
  constexpr int smem = 2 * sizeof(RegenTile<WR>);
  const cudaError_t e = cudaFuncSetAttribute(adjoint_regen_tc_kernel<WR, GEN, NW, WK, MPW>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nchunks, npairs + nsingles, (nv + RBMAX - 1) / RBMAX);
  adjoint_regen_tc_kernel<WR, GEN, NW, WK, MPW><<<grid, NW * 32, smem, st>>>(
      x, n, alpha, nv, pairs, npairs, singles, nsingles, chunk, part, S);
  return (int)cudaSuccess;
}

template <int WR, int GEN>
int adjoint_regen(const float* x, const float* alpha, int n, int nv, const int* pairs, int npairs,
                  const int* singles, int nsingles, float* part, int nchunks, int chunk, int nw, int wk,
                  int mpw, float* out, cudaStream_t st) {
  const size_t S = (size_t)nv * (npairs * WR * WR + nsingles * WR);
  const Rows pr = make_rows(pairs, 2 * npairs), sg = make_rows(singles, nsingles);
  int code;
#define ADJ_RG(W, K, M) \
  code = launch_regen_tc<WR, GEN, W, K, M>(x, n, alpha, nv, pr, npairs, sg, nsingles, part, nchunks, chunk, S, st)
  if (nw == 8 && wk == 4 && mpw == 1) ADJ_RG(8, 4, 1);
  else if (nw == 8 && wk == 2 && mpw == 1) ADJ_RG(8, 2, 1);
  else if (nw == 8 && wk == 1 && mpw == 1) ADJ_RG(8, 1, 1);
  else if (nw == 8 && wk == 1 && mpw == 2) ADJ_RG(8, 1, 2);
  else if (nw == 12 && wk == 1 && mpw == 2) ADJ_RG(12, 1, 2);
  else if (nw == 8 && wk == 1 && mpw == 4) ADJ_RG(8, 1, 4);
  else return (int)cudaErrorInvalidValue;
#undef ADJ_RG
  if (code != 0) return code;
  launch_reduce_slices(part, nchunks, S, out, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaGetLastError() code after the launches (0 = success).
// part: (nchunks, S) float32 scratch; nw / wk / mpw: the warps, their
// k-split and the M tiles per warp (ops/_cuda_build.py `adjoint_tc_split`).
int adjoint_launch(const float* x, int phase_gen, const float* alpha, int WR, int n, int nv,
                   const int* pairs, int npairs, const int* singles, int nsingles, float* part,
                   int nchunks, int chunk, int nw, int wk, int mpw, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NDFT_ADJ(W, G) \
  return adjoint_regen<W, G>(x, alpha, n, nv, pairs, npairs, singles, nsingles, part, nchunks, chunk, nw, wk, mpw, out, st)
  if (phase_gen == DOUBLING) {
    if (WR == 18) NDFT_ADJ(18, DOUBLING);
    if (WR == 34) NDFT_ADJ(34, DOUBLING);
  } else if (phase_gen == DIRECT) {
    if (WR == 18) NDFT_ADJ(18, DIRECT);
    if (WR == 34) NDFT_ADJ(34, DIRECT);
  }
#undef NDFT_ADJ
  return (int)cudaErrorInvalidValue;
}

int forward_launch(const float* x, int phase_gen, int WR, int n, const int* pairs,
                   int npairs, const float* G2, const int* singles, int nsingles,
                   const float* G1, int nsets, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NDFT_FWD(W, G) \
  launch_forward<W>(RegenSrc<W, G>{x, n}, n, pairs, npairs, G2, singles, nsingles, G1, nsets, y, st)
  if (phase_gen == DOUBLING) {
    if (WR == 18) NDFT_FWD(18, DOUBLING);
    else if (WR == 34) NDFT_FWD(34, DOUBLING);
    else return (int)cudaErrorInvalidValue;
  } else if (phase_gen == DIRECT) {
    if (WR == 18) NDFT_FWD(18, DIRECT);
    else if (WR == 34) NDFT_FWD(34, DIRECT);
    else return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef NDFT_FWD
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
