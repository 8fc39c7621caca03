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
//   _forward_kernel -> split_regen_weights_kernel (once per pass)
//                      + forward_regen_tc_kernel (tensor cores, 3xTF32)
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
// The forward, y_s[i] = sum_w L0_w[:, i]^T G_s,w L1_w[:, i] + sum_k
// Ls_k[:, i]^T g_s,k, as Z[i, (s, a)] = sum_b L1[b, i] G_s[a, b] on the
// tensor cores and an epilogue that multiplies by L0[a, i] and sums over a.
// - Numerics: 3xTF32 as in the adjoint, on L1 (split once per window as its
//   phases are made) and G (split once per pass into fragment order by
//   split_regen_weights_kernel).  A tensor-core sum runs over b only (at
//   most 32 terms), so each set starts from fresh accumulators and nothing
//   is carried across tiles; the rank-2 Nyquist update, the epilogue, the
//   1-D windows and the sum over windows are float32 FMAs.
// - What bounds it on an H100 SXM: 2 nsets npairs WR^2 n flops three times
//   over on the TF32 tensor cores (495 TFLOP/s dense); beside them, not
//   after them, the epilogue's 2 nsets npairs WR n and the 1-D windows'
//   2 nsets nsingles WR n flops on the CUDA cores (67 TFLOP/s) take a tenth
//   of that: at n = 2e5, WINDOWS_FUSED (three pairs, one single), WR = 34,
//   0.17 ms at nsets = 20 and 0.0084 ms at nsets = 1.  The coordinates and
//   y (6.4 MB at nsets = 20, 2 us) do not bound it.
// - Design: one block per 256 points (16 warps, one 16-row M tile each)
//   holds every weight set of the pass (up to 32; more sets run as further
//   passes), so each point's phases are made once per window.  M is points;
//   N is (set, a), 8-column tiles per set (WR = 34 -> 40, 18 -> 24: the pad
//   columns' weights are zero); K is the first WR - 2 rows of L1, 8 per
//   MMA.  The last two rows (the Nyquist mode) are a rank-2 CUDA-core update
//   of the accumulators, as the adjoint keeps its last two columns off the
//   tensor cores.  Per window, threads [0, 256) make the points' L0 and
//   threads [256, 512) their L1 (split) into shared memory; each warp then
//   loads its A fragments, L0 at its accumulator slots and the Nyquist rows
//   into registers, where they serve every set.  The split weights of groups
//   of up to 4 sets stream through two buffers by cp.async while the MMAs of
//   the previous group run.  The epilogue sums over a in the thread and the
//   quad, in a fixed order, and one lane per (set, point) adds it into a y
//   tile in shared memory; the 1-D windows follow in the same launch on the
//   CUDA cores (one point per thread), and y is written once.  No atomics: a
//   second launch is bitwise equal.
// - What holds it back on an NVIDIA H100 80GB HBM3 (700 W): the issue rate
//   of mma.sync.  At nsets = 20 the kernel issues 45M HMMA.1688.F32.TF32,
//   about 4 SM cycles each over its time at the 1.98 GHz boost clock, a
//   quarter of the dense TF32 peak; builds of this file with parts of the
//   set loop removed left the MMAs most of that time, and the rest of the
//   loop (B loads, epilogue, shuffles, y-tile adds) overlapping them only in
//   part, the weights' L2 traffic and the phase generation small shares.
//   Flattening (set, a) over groups of 4 sets (no pad column, 15% fewer
//   MMAs, L0 then read from shared memory in the epilogue) helped many sets
//   and hurt few: no gain over a fused step, so the padded layout stays.
//   Two M tiles per warp (one B load for both) were no better than one.
//   Fewer instructions need other MMAs: wgmma, or m16n8k16 on a three-term
//   fp16 split (half the HMMA count of 3xTF32, with the same 11-bit parts).

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

// --- the adjoint on the tensor cores (3xTF32) -----------------------------------------

constexpr int RG_ROWS = 512;         // M rows (rhs x WR) per block: 32 tiles of 16
constexpr int RG_LD0 = TP + 8;       // L0 / alpha row (floats): float2 fragment reads hit 32 banks
constexpr int RG_LD1 = 2 * TP + 16;  // L1 row of (big, small) words: uint4 fragment reads hit 32 banks

// Inside each 8-point k-step a tile stores point k at slot pos(k), so that
// points t and t + 4 -- the two k columns of one thread's A and B fragments
// -- sit side by side: one float2 (L0, alpha) or uint4 (L1's big and small
// parts of both) load per fragment row.
__device__ __forceinline__ int pos(int k) { return (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1); }

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


// --- the forward on the tensor cores (3xTF32) -----------------------------------------

constexpr int FR_NW = 16;        // warps a block, one 16-row M tile each
constexpr int FR_R = FR_NW * 16;  // points a block
constexpr int FR_SG = 4;          // weight sets per staged group, at most
constexpr int FR_SMAX = 32;       // weight sets per pass, at most (the y tile in shared memory)

template <int WR>
struct RegenFwd {
  static constexpr int KT = (WR - 2) / 8;   // 8-deep k-steps: b < WR - 2 on the tensor cores
  static constexpr int NTN = (WR + 7) / 8;  // 8-column N tiles of one set: a < 8 NTN, pad columns zero
  static constexpr int FRAG_WORDS = KT * NTN * 32 * 4;        // per (k-step, N tile, lane): b0, b1 big; b0, b1 small
  static constexpr int SET_WORDS = FRAG_WORDS + NTN * 8 * 2;  // + (G[a][WR - 2], G[a][WR - 1]) as float32
};

// the phases of a block's FR_R points for one window, point-major columns:
// L1's rows b < WR - 2 as (big, small) tf32 parts, its last two rows (the
// Nyquist mode, off the tensor cores) and L0 as float32.  LD = FR_R + 4: the
// fragment reads (rows t and t + 4 of four k columns, points g and g + 8)
// hit distinct banks.
template <int WR>
struct RegenFwdPhases {
  static constexpr int LD = FR_R + 4;
  uint2 L1[WR - 2][LD];
  float Ln[2][LD];
  float L0[WR][LD];
};

// G2 (ns, npairs, WR, WR) float32 -> Gf[w][s]: SET_WORDS words per (window,
// set), the B fragments of B[b][a] = G[a][b] (b < WR - 2) split into tf32
// parts, then G's last two columns; pad columns a >= WR are zero
template <int WR>
__global__ void split_regen_weights_kernel(const float* __restrict__ G2, int npairs, int ns,
                                           uint32_t* __restrict__ Gf) {
  using F = RegenFwd<WR>;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)npairs * ns * F::SET_WORDS) return;
  const int rem = (int)(idx % F::SET_WORDS);
  const size_t ws = idx / F::SET_WORDS;
  const int w = (int)(ws / ns), s = (int)(ws % ns);
  const float* G = G2 + ((size_t)s * npairs + w) * WR * WR;
  if (rem < F::FRAG_WORDS) {
    const int e = rem & 3, lane = (rem >> 2) & 31, jk = rem >> 7;
    const int j = jk % F::NTN, kk = jk / F::NTN;
    const int a = j * 8 + (lane >> 2), b = kk * 8 + (lane & 3) + 4 * (e & 1);
    uint32_t big, small;
    split_tf32(a < WR ? G[a * WR + b] : 0.f, big, small);
    Gf[idx] = e < 2 ? big : small;
  } else {
    const int r = rem - F::FRAG_WORDS, a = r >> 1;
    Gf[idx] = __float_as_uint(a < WR ? G[a * WR + WR - 2 + (r & 1)] : 0.f);
  }
}

// y_s[i] for the block's FR_R points and the pass's ns weight sets.
// Z[i, (s, a)] = sum_b L1[b, i] G_s[a, b]: M = points (warp w owns the 16-row
// tile w), N = (set, a) in NTN 8-column tiles per set, K = b.  Per window the
// threads make the phases of the block's points into shared memory, then
// each warp holds its A fragments (L1, split), L0 at its accumulator slots
// and the two Nyquist rows in registers for every set.  The split weights
// stream through two buffers by cp.async, groups of sg sets, the next group
// (of this or the next window) landing while the MMAs of the current one
// run.  Per set: KT k-steps of three MMAs per N tile into fresh accumulators
// (a sum over b only), the rank-2 Nyquist update on the CUDA cores, then the
// epilogue: times L0[a, i], summed over a in the thread and the quad, added
// into the y tile by one lane per (set, point).  The 1-D windows follow on
// the CUDA cores, one point per thread; y is written once.
template <int WR, int GEN>
__global__ void __launch_bounds__(FR_NW * 32, 1) forward_regen_tc_kernel(
    const float* __restrict__ x, int n, Rows pairs, int npairs, const uint32_t* __restrict__ Gf,
    Rows singles, int nsingles, const float* __restrict__ G1, int ns, int sg, float* __restrict__ y) {
  using F = RegenFwd<WR>;
  constexpr int KT = F::KT, NTN = F::NTN, NTH = FR_NW * 32, R = FR_R;
  using Ph = RegenFwdPhases<WR>;
  static_assert(WR % 8 == 2 && sizeof(Ph) % 16 == 0, "unsupported width");
  extern __shared__ __align__(16) unsigned char smem[];
  Ph& ph = *reinterpret_cast<Ph*>(smem);
  uint32_t* gbuf = reinterpret_cast<uint32_t*>(smem + sizeof(Ph));                          // [2][sg * SET_WORDS]
  float* sY = reinterpret_cast<float*>(smem + sizeof(Ph) + (size_t)2 * sg * F::SET_WORDS * 4);  // [ns][R]
  const int i0 = blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mb = warp * 16;
  const bool live = i0 + mb < n;
  for (int idx = tid; idx < ns * R; idx += NTH) sY[idx] = 0.f;
  __syncthreads();  // the y tile is zero before any thread adds to it

  const int ngroups = (ns + sg - 1) / sg, steps = npairs * ngroups;
  auto load_group = [&](int u) {  // step u = (window u / ngroups, set group u % ngroups)
    const int w = u / ngroups, s0 = u % ngroups * sg, words = min(sg, ns - s0) * F::SET_WORDS;
    const uint32_t* src = Gf + ((size_t)w * ns + s0) * F::SET_WORDS;
    uint32_t* dst = gbuf + (u & 1) * sg * F::SET_WORDS;
    for (int idx = tid; idx < words / 4; idx += NTH) cp_async16(dst + 4 * idx, src + 4 * idx, 16);
  };
  // the phases of the block's points (0 past n: finite, never written out):
  // entry idx < R makes L0 of point idx, entry R + p L1 of point p
  auto make_phases = [&](int ja, int jb) {
    for (int idx = tid; idx < 2 * R; idx += NTH) {
      const int p = idx % R, i = i0 + p;
      float col[WR];
      phases<WR, GEN>(i < n ? __ldg(x + (size_t)(idx < R ? ja : jb) * n + i) : 0.f, col);
      if (idx < R) {
#pragma unroll
        for (int a = 0; a < WR; ++a) ph.L0[a][p] = col[a];
      } else {
#pragma unroll
        for (int b = 0; b < WR - 2; ++b) {
          uint2 v;
          split_tf32(col[b], v.x, v.y);
          ph.L1[b][p] = v;
        }
        ph.Ln[0][p] = col[WR - 2];
        ph.Ln[1][p] = col[WR - 1];
      }
    }
  };

  // A fragments (rows g, g + 8 x columns t, t + 4 of each k-step), L0 at the
  // accumulator slots (rows g, g + 8 x columns a, a + 1, a = 8 j + 2 t) and
  // the Nyquist rows (WR - 2, WR - 1) at rows g, g + 8
  uint32_t Ab[KT][4], As[KT][4];
  float l0[NTN][4], ln[4];

  if (steps > 0) load_group(0);
  cp_commit();
  for (int u = 0; u < steps; ++u) {
    const int w = u / ngroups, gi = u % ngroups;
    if (u + 1 < steps) load_group(u + 1);  // into the buffer step u - 1 read
    cp_commit();
    if (gi == 0) make_phases(pairs.v[2 * w], pairs.v[2 * w + 1]);
    cp_wait<1>();
    __syncthreads();  // group u landed; the window's phases are in place
    if (gi == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint2 v0 = ph.L1[kk * 8 + t][mb + g], v1 = ph.L1[kk * 8 + t][mb + g + 8];
        const uint2 v2 = ph.L1[kk * 8 + t + 4][mb + g], v3 = ph.L1[kk * 8 + t + 4][mb + g + 8];
        Ab[kk][0] = v0.x, As[kk][0] = v0.y;
        Ab[kk][1] = v1.x, As[kk][1] = v1.y;
        Ab[kk][2] = v2.x, As[kk][2] = v2.y;
        Ab[kk][3] = v3.x, As[kk][3] = v3.y;
      }
#pragma unroll
      for (int j = 0; j < NTN; ++j) {
        const int a = j * 8 + 2 * t;  // WR is even: a < WR iff a + 1 < WR
        l0[j][0] = a < WR ? ph.L0[a][mb + g] : 0.f;
        l0[j][1] = a < WR ? ph.L0[a + 1][mb + g] : 0.f;
        l0[j][2] = a < WR ? ph.L0[a][mb + g + 8] : 0.f;
        l0[j][3] = a < WR ? ph.L0[a + 1][mb + g + 8] : 0.f;
      }
      ln[0] = ph.Ln[0][mb + g];
      ln[1] = ph.Ln[1][mb + g];
      ln[2] = ph.Ln[0][mb + g + 8];
      ln[3] = ph.Ln[1][mb + g + 8];
    }

    const uint32_t* gb = gbuf + (u & 1) * sg * F::SET_WORDS;
    const int s0 = gi * sg, cnt = live ? min(sg, ns - s0) : 0;
#pragma unroll 1
    for (int sl = 0; sl < cnt; ++sl) {
      const uint32_t* gs = gb + sl * F::SET_WORDS;
      float cz[NTN][4];
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cz[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint4 bf[NTN];  // B fragments of this k-step: (b0, b1) big, (b0, b1) small
#pragma unroll
        for (int j = 0; j < NTN; ++j) bf[j] = reinterpret_cast<const uint4*>(gs)[(kk * NTN + j) * 32 + lane];
        // term-major: NTN independent accumulators between dependent MMAs
#pragma unroll
        for (int j = 0; j < NTN; ++j) mma1688(cz[j], As[kk], bf[j].x, bf[j].y);
#pragma unroll
        for (int j = 0; j < NTN; ++j) mma1688(cz[j], Ab[kk], bf[j].z, bf[j].w);
#pragma unroll
        for (int j = 0; j < NTN; ++j) mma1688(cz[j], Ab[kk], bf[j].x, bf[j].y);
      }
      // (G[a][WR - 2], G[a][WR - 1], G[a + 1][WR - 2], G[a + 1][WR - 1]) at a = 8 j + 2 t
      const float4* gn = reinterpret_cast<const float4*>(gs + F::FRAG_WORDS);
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int j = 0; j < NTN; ++j) {
        const float4 v = gn[j * 4 + t];
        const float c0 = fmaf(ln[1], v.y, fmaf(ln[0], v.x, cz[j][0]));
        const float c1 = fmaf(ln[1], v.w, fmaf(ln[0], v.z, cz[j][1]));
        const float c2 = fmaf(ln[3], v.y, fmaf(ln[2], v.x, cz[j][2]));
        const float c3 = fmaf(ln[3], v.w, fmaf(ln[2], v.z, cz[j][3]));
        p0 = fmaf(c1, l0[j][1], fmaf(c0, l0[j][0], p0));
        p1 = fmaf(c3, l0[j][3], fmaf(c2, l0[j][2], p1));
      }
      // the quad's four in a fixed order
      p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
      p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
      const int s = s0 + sl;
      if (t == (s & 3)) {  // one lane per (set, point): no races across windows
        sY[s * R + mb + g] += p0;
        sY[s * R + mb + g + 8] += p1;
      }
    }
    __syncthreads();  // every reader of buffer u & 1 (and, at gi == 0, of the phases) is done
  }

  // the 1-D windows on the CUDA cores: y_s[i] += sum_a Ls[a, i] g_s[a]
  for (int k = 0; k < nsingles; ++k) {
    const float* xs = x + (size_t)singles.v[k] * n;
    for (int p = tid; p < R; p += NTH) {
      const int i = i0 + p;
      float col[WR];
      phases<WR, GEN>(i < n ? __ldg(xs + i) : 0.f, col);
      for (int s = 0; s < ns; ++s) {
        const float* gv = G1 + ((size_t)s * nsingles + k) * WR;
        float e0 = 0.f, e1 = 0.f;
#pragma unroll
        for (int a = 0; a < WR; a += 2) {
          e0 = fmaf(col[a], __ldg(gv + a), e0);
          e1 = fmaf(col[a + 1], __ldg(gv + a + 1), e1);
        }
        sY[s * R + p] += e0 + e1;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < ns * R; idx += NTH) {
    const int i = i0 + idx % R;
    if (i < n) y[(size_t)(idx / R) * n + i] = sY[idx];
  }
}

// one pass of ns <= FR_SMAX weight sets: split the weights, then the forward
template <int WR, int GEN>
int forward_regen(const float* x, int n, const int* pairs, int npairs, const float* G2, const int* singles,
                  int nsingles, const float* G1, int ns, uint32_t* Gf, float* y, cudaStream_t st) {
  if (ns < 1 || ns > FR_SMAX || n < 1) return (int)cudaErrorInvalidValue;
  const int sg = ns < FR_SG ? ns : FR_SG;
  if (npairs > 0) {
    const size_t words = (size_t)npairs * ns * RegenFwd<WR>::SET_WORDS;
    split_regen_weights_kernel<WR><<<(unsigned)((words + 255) / 256), 256, 0, st>>>(G2, npairs, ns, Gf);
  }
  auto kernel = forward_regen_tc_kernel<WR, GEN>;
  const size_t smem = sizeof(RegenFwdPhases<WR>) + (size_t)2 * sg * RegenFwd<WR>::SET_WORDS * 4 + (size_t)ns * FR_R * 4;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(n + FR_R - 1) / FR_R, FR_NW * 32, smem, st>>>(x, n, make_rows(pairs, 2 * npairs), npairs, Gf,
                                                          make_rows(singles, nsingles), nsingles, G1, ns, sg, y);
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
  if (!windows_fit(npairs, nsingles)) return (int)cudaErrorInvalidValue;
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

// One pass of 1 <= ns <= forward_max_sets() weight sets.  Gf: scratch of
// forward_scratch_words(WR, npairs, ns) uint32 words (the split weights).
int forward_launch(const float* x, int phase_gen, int WR, int n, const int* pairs, int npairs,
                   const float* G2, const int* singles, int nsingles, const float* G1, int ns, void* Gf,
                   float* y, void* stream) {
  if (!windows_fit(npairs, nsingles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* W = static_cast<uint32_t*>(Gf);
#define NDFT_FWD(WW, G) return forward_regen<WW, G>(x, n, pairs, npairs, G2, singles, nsingles, G1, ns, W, y, st)
  if (phase_gen == DOUBLING) {
    if (WR == 18) NDFT_FWD(18, DOUBLING);
    if (WR == 34) NDFT_FWD(34, DOUBLING);
  } else if (phase_gen == DIRECT) {
    if (WR == 18) NDFT_FWD(18, DIRECT);
    if (WR == 34) NDFT_FWD(34, DIRECT);
  }
#undef NDFT_FWD
  return (int)cudaErrorInvalidValue;
}

// the most weight sets forward_launch takes in one pass
int forward_max_sets() { return FR_SMAX; }

// uint32 words of forward_launch's scratch for npairs windows and ns sets
// (0 for a width the forward is not compiled for)
long long forward_scratch_words(int WR, int npairs, int ns) {
  const long long per = WR == 18 ? RegenFwd<18>::SET_WORDS : WR == 34 ? RegenFwd<34>::SET_WORDS : 0;
  return per * npairs * ns;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
