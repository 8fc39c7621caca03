// Tensor-core NDFT kernels for bf16 phase tables on Hopper (sm_90a), plain C
// interface.
//
// Replace, for a bf16 table tab[j][a][i] (Dtot, WR, ld >= n, WR = 2P rows
// per coordinate row j: cos(2 pi p x_j[i]) for a = p < P, sin for a = P + p),
// the "table_f32" mode of the JAX package's ops/pallas_ndft.py (the JAX main
// path: bf16 table, float32 alpha and weights, float32 sums):
//   _adjoint_kernel (pallas_call at :326) -> adjoint_tc_kernel for the 2-D
//       windows, adjoint_singles_kernel (packed_ndft.cuh, CUDA cores) for the
//       1-D windows, reduce_slices_kernel (tc_common.cuh: fixed-order
//       split-K sum);
//   _forward_kernel (pallas_call at :508) -> split_weights_kernel (once per
//       call) + forward_tc_kernel.
//
// Numerics.  Every table entry is bf16, so it is an exact bf16 tensor-core
// operand.  The other operand is float32 (alpha * L0 in the adjoint, the
// combined weights G in the forward); it is split into three bf16 terms
// hi + mid + lo that hold its 24-bit significand exactly (split3).  A
// bf16 x bf16 product is exact in float32, so three mma.sync into one
// float32 accumulator form the same products as float32 FMAs; only the
// order of the sums differs.  One bf16 pass would round u to 8 bits (JAX's
// "table" mode, not its main path).  Tensor-core sums may truncate, so the
// adjoint accumulates each 64-point tile in fresh registers and adds the
// tile sums in float32 on the CUDA cores; the forward's tensor-core sums run
// over b only (WR terms).
//
// What bounds them on an H100 SXM (published peaks at 700 W): at n = 2e5,
// five 2-D windows, WR = 32, one pass reads 128 MB of table (38 us at
// 3.35 TB/s); the adjoint does 2 nv npairs WR^2 n flops, the forward
// 2 nsets npairs WR^2 n, three times over on the bf16 tensor cores
// (989 TFLOP/s): nv = 10 and nsets = 20 are bound by the tensor cores
// (0.062 / 0.128 ms), one right-hand side or weight set by the table bytes.
//
// Design:
// - Tensor cores through mma.sync.m16n8k16 (bf16 in, float32 out), fed by
//   cp.async 16-byte copies into shared memory (a ring of 3-5 stages in the
//   adjoint, as many as 48 KB hold, double-buffered weight groups in the
//   forward).  The table rows
//   need a 16-byte aligned row stride (ld % 8 == 0: pack_phase_table pads
//   its storage to a multiple of 64 points); the ragged edge is zero-filled
//   by the copies' source-size operand.  alpha (nv, n) is unpadded and is
//   copied 4 bytes at a time, masked.
// - Adjoint, C[(r, a), b] = sum_i (alpha_r[i] L0[a, i]) L1[b, i]: M = nv WR
//   rows (16-row tiles), N = WR, K = points.  One block owns every
//   right-hand side (up to 512 / WR) of its window and point chunk, so the
//   table is read once per pass.  The warps (8, or 12 for 17-24 M tiles)
//   split the M tiles, and for few M tiles (nv = 1, 2 at WR = 32) also the
//   four 16-point k-steps of a tile (WK, summed in the block through shared
//   memory); each chunk writes its own partial slice, and a second kernel
//   adds the slices in a fixed order: no atomics, bitwise-repeatable.  The A fragment (alpha * L0, split three
//   ways) is built in registers; B = L1 is read from the padded tile
//   (144-byte rows: conflict-free).
// - Forward, Z[i, (s, a)] = sum_b L1[b, i] G_s[a, b]: M = points, N = (set,
//   a) in 8-column tiles, K = WR.  A = L1^T comes from the table tile by
//   ldmatrix.trans, once per window; B = the three split terms of G,
//   pre-split once per call into fragment order (one 8-byte load per lane
//   per term, shared by the warp's two M tiles).  The epilogue multiplies by
//   L0[a, i], reduces over a (in the thread, then a quad shuffle) and adds
//   into a shared-memory y tile; 1-D windows are added on the CUDA cores; y
//   is written once.  A block holds 256 points and loops over every window
//   and every weight set (groups of up to 4 double-buffered through shared
//   memory), so each set reads the table once; G is read from L2 once per
//   window per 256 points (480 MB at nsets = 20, n = 2e5).  Above 32 sets
//   the launcher runs one pass per 32 sets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_ndft.cuh"
#include "tc_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TC_NT = 256;         // forward threads per block (8 warps)
constexpr int TC_TP = 64;          // adjoint points per ring stage
constexpr int TC_LDT = TC_TP + 8;  // padded tile row (bf16): 144 bytes
constexpr int TC_RBMAX_ROWS = 512;  // adjoint rows (rhs x WR) per block: 32 M tiles
constexpr int FWD_R = 256;         // forward points per block
constexpr int FWD_SG = 4;          // weight sets per staged group
constexpr int FWD_SMAX = 32;       // weight sets per forward pass

// D += A B, A 16x16 (row), B 16x8 (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ float2 unpack(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the top 8 significand bits of x (bf16 by truncation) as a float32
__device__ __forceinline__ float top8(float x) { return __uint_as_float(__float_as_uint(x) & 0xffff0000u); }

// (x0, x1) = hi + mid + lo exactly, each a bf16x2 word (x0 in the low half):
// t[0] = hi, t[1] = mid, t[2] = lo.  hi truncates x to its top 8 significand
// bits, so x - hi holds the low 16 bits exactly (same sign and binade:
// Sterbenz); mid truncates that remainder to its top 8 bits and lo, the
// rest, has at most 8.  Bit masks, subtractions and byte permutes only: no
// conversion instructions, which run at a quarter of the FP32 rate.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&t)[3]) {
  const float r0 = __fsub_rn(x0, top8(x0)), r1 = __fsub_rn(x1, top8(x1));
  const float l0 = __fsub_rn(r0, top8(r0)), l1 = __fsub_rn(r1, top8(r1));
  t[0] = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
  t[1] = __byte_perm(__float_as_uint(r0), __float_as_uint(r1), 0x7632);
  t[2] = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// --- adjoint -------------------------------------------------------------------

// one ring stage: the window's two table tiles and alpha of RB right-hand sides
template <int WR, int RB>
struct __align__(16) AdjStage {
  uint16_t L0[WR][TC_LDT];  // bf16 bits (a __shared__ array needs a trivial type)
  uint16_t L1[WR][TC_LDT];
  float al[RB][TC_TP];
};

// A fragment slot of alpha_r * L0[a] at two neighbouring points, split
template <int S>
__device__ __forceinline__ void a_slot(uint32_t (&A)[3][4], float2 al, float2 l) {
  uint32_t t[3];
  split3(__fmul_rn(al.x, l.x), __fmul_rn(al.y, l.y), t);
  A[0][S] = t[0];
  A[1][S] = t[1];
  A[2][S] = t[2];
}

// partial C of one point chunk for every rhs of the block's
// window: NW warps, WK along the k-steps of a tile, NW / WK along M with up
// to MPW M tiles each
template <int WR, int NW, int WK, int MPW>
__global__ void __launch_bounds__(NW * 32, 1) adjoint_tc_kernel(
    const bf16* __restrict__ tab, int ld, const float* __restrict__ alpha, int n, int nv,
    Rows pairs, int npairs, int chunk, float* __restrict__ part, size_t S) {
  constexpr int NTN = WR / 8, WM = NW / WK, KPW = 4 / WK, RBMAX = TC_RBMAX_ROWS / WR;
  constexpr int NTH = NW * 32;
  constexpr int RB = (WM * MPW * 16 + WR - 1) / WR;  // right-hand sides the warps cover
  using Stage = AdjStage<WR, RB>;
  // as many stages as static shared memory (48 KB) holds, 3 to 6
  constexpr int STAGES = 48000 / sizeof(Stage) < 3 ? 3 : 48000 / sizeof(Stage) > 6 ? 6 : 48000 / sizeof(Stage);
  // the warp's M tiles share their rows a of L0 (mt = wm + WM q)
  static_assert(MPW == 1 || WM * 16 % WR == 0, "M tiles of a warp must share their L0 rows");
  __shared__ Stage st[STAGES];
  const int c = blockIdx.x, w = blockIdx.y, r0 = blockIdx.z * RBMAX;
  const int rb = min(RBMAX, nv - r0);
  const int mtb = rb * WR / 16;
  const int i_begin = c * chunk, i_end = min(n, i_begin + chunk);
  const int ntiles = (i_end - i_begin + TC_TP - 1) / TC_TP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wk = warp / WM;
  const bf16* L0g = tab + (size_t)pairs.v[2 * w] * WR * ld;
  const bf16* L1g = tab + (size_t)pairs.v[2 * w + 1] * WR * ld;

  auto load = [&](int s, int i0) {
    Stage& sg = st[s];
    for (int idx = tid; idx < 2 * WR * (TC_TP / 8); idx += NTH) {
      const int which = idx / (WR * 8), a = (idx / 8) % WR, q = idx % 8;
      const int i = i0 + q * 8;
      const bf16* row = (which ? L1g : L0g) + (size_t)a * ld;
      const int bytes = max(0, min(16, (i_end - i) * 2));
      cp_async16(which ? &sg.L1[a][q * 8] : &sg.L0[a][q * 8], bytes > 0 ? row + i : row, bytes);
    }
    for (int idx = tid; idx < rb * TC_TP; idx += NTH) {
      const int r = idx / TC_TP, ii = idx % TC_TP, i = i0 + ii;
      const float* src = alpha + (size_t)(r0 + r) * n;
      cp_async4(&sg.al[r][ii], i < i_end ? src + i : src, i < i_end ? 4 : 0);
    }
  };

  float racc[MPW][NTN][4];
#pragma unroll
  for (int q = 0; q < MPW; ++q)
#pragma unroll
    for (int j = 0; j < NTN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) racc[q][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, i_begin + s * TC_TP);
    cp_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile `it` landed; every reader of the stage refilled below is done
    const int nx = it + STAGES - 1;
    if (nx < ntiles) load(nx % STAGES, i_begin + nx * TC_TP);
    cp_commit();

    const Stage& sg = st[it % STAGES];
    float tacc[MPW][NTN][4];
#pragma unroll
    for (int q = 0; q < MPW; ++q)
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tacc[q][j][e] = 0.f;
#pragma unroll
    for (int e = 0; e < KPW; ++e) {
      const int kb = (wk + WK * e) * 16 + 2 * t;
      uint32_t b[NTN][2];
#pragma unroll
      for (int j = 0; j < NTN; ++j) {
        b[j][0] = *reinterpret_cast<const uint32_t*>(&sg.L1[j * 8 + g][kb]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&sg.L1[j * 8 + g][kb + 8]);
      }
      const int a0 = wm * 16 % WR;  // the same for all the warp's M tiles
      const float2 l00 = unpack(reinterpret_cast<const bf16*>(&sg.L0[a0 + g][kb]));
      const float2 l10 = unpack(reinterpret_cast<const bf16*>(&sg.L0[a0 + g + 8][kb]));
      const float2 l01 = unpack(reinterpret_cast<const bf16*>(&sg.L0[a0 + g][kb + 8]));
      const float2 l11 = unpack(reinterpret_cast<const bf16*>(&sg.L0[a0 + g + 8][kb + 8]));
#pragma unroll
      for (int q = 0; q < MPW; ++q) {
        const int mt = wm + WM * q;
        if (mt < mtb) {
          const int r = mt * 16 / WR;
          const float2 al0 = *reinterpret_cast<const float2*>(&sg.al[r][kb]);
          const float2 al1 = *reinterpret_cast<const float2*>(&sg.al[r][kb + 8]);
          uint32_t A[3][4];
          a_slot<0>(A, al0, l00);
          a_slot<1>(A, al0, l10);
          a_slot<2>(A, al1, l01);
          a_slot<3>(A, al1, l11);
#pragma unroll
          for (int term = 2; term >= 0; --term)
#pragma unroll
            for (int j = 0; j < NTN; ++j) mma16816(tacc[q][j], A[term], b[j][0], b[j][1]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < MPW; ++q)
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) racc[q][j][e] += tacc[q][j][e];
  }

  if (WK > 1) {  // add the k-split's partial sums in a fixed order (wk = 0, 1, ...)
    cp_wait<0>();
    __syncthreads();  // the ring is idle: its memory holds the exchange
    float* red = reinterpret_cast<float*>(st);  // [WK - 1][WM][MPW * NTN * 4][32]
    constexpr int E = MPW * NTN * 4;
    static_assert((WK - 1) * WM * E * 32 * 4 <= STAGES * sizeof(Stage), "exchange exceeds the ring");
    if (wk > 0) {
#pragma unroll
      for (int q = 0; q < MPW; ++q)
#pragma unroll
        for (int j = 0; j < NTN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(((wk - 1) * WM + wm) * E + (q * NTN + j) * 4 + e) * 32 + lane] = racc[q][j][e];
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int k = 1; k < WK; ++k)
#pragma unroll
      for (int q = 0; q < MPW; ++q)
#pragma unroll
        for (int j = 0; j < NTN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) racc[q][j][e] += red[(((k - 1) * WM + wm) * E + (q * NTN + j) * 4 + e) * 32 + lane];
  }
  float* slice = part + (size_t)c * S;
#pragma unroll
  for (int q = 0; q < MPW; ++q) {
    const int mt = wm + WM * q;
    if (mt < mtb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h, r = m / WR, a = m % WR;
        float* o = slice + ((size_t)(r0 + r) * npairs + w) * WR * WR + a * WR + 2 * t;
#pragma unroll
        for (int j = 0; j < NTN; ++j) {
          o[j * 8] = racc[q][j][2 * h];
          o[j * 8 + 1] = racc[q][j][2 * h + 1];
        }
      }
    }
  }
}

// the 1-D windows' rows for adjoint_singles_kernel (packed_ndft.cuh)
template <int WR>
struct Bf16Rows {
  const bf16* tab;
  int ld;

  template <int LD>
  __device__ __forceinline__ void stage_single(float (*sL)[LD], int j, int i0, int i_end, int t) const {
    const bf16* Ls = tab + (size_t)j * WR * ld;
    for (int idx = t; idx < WR * TP; idx += NT) {
      const int a = idx / TP, ii = idx % TP, i = i0 + ii;
      sL[ii][a] = i < i_end ? __bfloat162float(Ls[(size_t)a * ld + i]) : 0.f;
    }
  }
};

// --- forward -------------------------------------------------------------------

template <int WR>
struct TcFwd {
  static constexpr int NTN = WR / 8, KK = WR / 16;
  static constexpr int SET_WORDS = NTN * KK * 3 * 64;  // one split weight set: WR^2 * 6 bytes
  static constexpr int LDR = FWD_R + 8;                // padded tile row (bf16): 528 bytes
  static constexpr size_t L_BYTES = (size_t)2 * WR * LDR * 2;
  // tiles, two staged groups of min(FWD_SG, nsets) split weight sets, y
  static size_t smem(int nsets) {
    const int sg = nsets < FWD_SG ? nsets : FWD_SG;
    return L_BYTES + (size_t)2 * sg * SET_WORDS * 4 + (size_t)nsets * FWD_R * 4;
  }
};

// G2 (nsets, npairs, WR, WR) float32 -> Gf[w][s][j][kk][term][lane][2]: the
// B fragments (b0b1, b2b3) of every 8-column tile j and 16-deep step kk,
// split into hi / mid / lo bf16 terms
template <int WR>
__global__ void split_weights_kernel(const float* __restrict__ G2, int npairs, int nsets,
                                     uint32_t* __restrict__ Gf) {
  using F = TcFwd<WR>;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)npairs * nsets * F::SET_WORDS) return;
  const int rem = (int)(idx % F::SET_WORDS);
  const size_t ws = idx / F::SET_WORDS;
  const int w = (int)(ws / nsets), s = (int)(ws % nsets);
  const int reg = rem & 1, lane = (rem >> 1) & 31, rest = rem >> 6;
  const int term = rest % 3, kk = (rest / 3) % F::KK, j = rest / 3 / F::KK;
  const int a = j * 8 + (lane >> 2), b = kk * 16 + 2 * (lane & 3) + 8 * reg;
  const float* src = G2 + (((size_t)s * npairs + w) * WR + a) * WR + b;
  uint32_t tt[3];
  split3(src[0], src[1], tt);
  Gf[idx] = tt[term];
}

// y_s[i] for the block's FWD_R points and all nsets weight sets
template <int WR>
__global__ void __launch_bounds__(TC_NT, 2) forward_tc_kernel(
    const bf16* __restrict__ tab, int ld, int n, Rows pairs, int npairs,
    const uint32_t* __restrict__ Gf, Rows singles, int nsingles, const float* __restrict__ G1,
    int nsets, float* __restrict__ y) {
  using F = TcFwd<WR>;
  constexpr int NTN = F::NTN, KK = F::KK, LDR = F::LDR, R = FWD_R, MW = R / 16 / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sgmax = min(FWD_SG, nsets);  // weight sets per staged group
  bf16* sL0 = reinterpret_cast<bf16*>(smem);
  bf16* sL1 = sL0 + WR * LDR;
  uint32_t* sG = reinterpret_cast<uint32_t*>(smem + F::L_BYTES);  // [2][sgmax * SET_WORDS]
  float* sY = reinterpret_cast<float*>(smem + F::L_BYTES + (size_t)2 * sgmax * F::SET_WORDS * 4);  // [nsets][R]
  const int i_r = blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int idx = tid; idx < nsets * R; idx += TC_NT) sY[idx] = 0.f;

  auto load_rows = [&](bf16* dst, int j) {
    const bf16* src = tab + (size_t)j * WR * ld;
    for (int idx = tid; idx < WR * (R / 8); idx += TC_NT) {
      const int a = idx / (R / 8), q = idx % (R / 8), i = i_r + q * 8;
      const bf16* row = src + (size_t)a * ld;
      const int bytes = max(0, min(16, (n - i) * 2));
      cp_async16(dst + a * LDR + q * 8, bytes > 0 ? row + i : row, bytes);
    }
  };
  const int ngroups = (nsets + sgmax - 1) / sgmax;
  auto load_group = [&](int w, int gi) {
    const int s0 = gi * sgmax, words = min(sgmax, nsets - s0) * F::SET_WORDS;
    const uint32_t* src = Gf + ((size_t)w * nsets + s0) * F::SET_WORDS;
    uint32_t* dst = sG + (gi & 1) * sgmax * F::SET_WORDS;
    for (int idx = tid; idx < words / 4; idx += TC_NT) cp_async16(dst + 4 * idx, src + 4 * idx, 16);
  };
  bool live[MW];
#pragma unroll
  for (int q = 0; q < MW; ++q) live[q] = i_r + (warp + 8 * q) * 16 < n;

  for (int w = 0; w < npairs; ++w) {
    __syncthreads();  // the previous window's readers are done with the tiles
    load_rows(sL0, pairs.v[2 * w]);
    load_rows(sL1, pairs.v[2 * w + 1]);
    load_group(w, 0);
    cp_commit();
    uint32_t A[MW][KK][4];  // L1^T fragments of the warp's M tiles
    float l0[MW][NTN][4];   // L0[a, i] at the accumulator's (i, a) slots
    for (int gi = 0; gi < ngroups; ++gi) {
      if (gi + 1 < ngroups) {
        load_group(w, gi + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      if (gi == 0) {
#pragma unroll
        for (int q = 0; q < MW; ++q) {
          if (!live[q]) continue;
          const int mb = (warp + 8 * q) * 16;
#pragma unroll
          for (int kk = 0; kk < KK; ++kk)
            ldsm_x4_trans(A[q][kk], sL1 + (kk * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDR + mb +
                                        (((lane >> 3) & 1) << 3));
#pragma unroll
          for (int j = 0; j < NTN; ++j) {
            const bf16* p = sL0 + (j * 8 + 2 * t) * LDR + mb + g;
            l0[q][j][0] = __bfloat162float(p[0]);
            l0[q][j][1] = __bfloat162float(p[LDR]);
            l0[q][j][2] = __bfloat162float(p[8]);
            l0[q][j][3] = __bfloat162float(p[LDR + 8]);
          }
        }
      }
      const uint2* gbuf = reinterpret_cast<const uint2*>(sG + (gi & 1) * sgmax * F::SET_WORDS);
      const int s0 = gi * sgmax, cnt = min(sgmax, nsets - s0);
#pragma unroll 1
      for (int sl = 0; sl < cnt; ++sl) {
        const uint2* gs = gbuf + sl * (F::SET_WORDS / 2);
        float p[MW][2];
#pragma unroll
        for (int q = 0; q < MW; ++q) p[q][0] = p[q][1] = 0.f;
#pragma unroll
        for (int j = 0; j < NTN; ++j) {
          uint2 bb[KK][3];  // B fragments of set s0 + sl, shared by the warp's M tiles
#pragma unroll
          for (int kk = 0; kk < KK; ++kk)
#pragma unroll
            for (int term = 0; term < 3; ++term) bb[kk][term] = gs[((j * KK + kk) * 3 + term) * 32 + lane];
#pragma unroll
          for (int q = 0; q < MW; ++q) {
            if (!live[q]) continue;
            float cz[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < KK; ++kk)
#pragma unroll
              for (int term = 2; term >= 0; --term) mma16816(cz, A[q][kk], bb[kk][term].x, bb[kk][term].y);
            p[q][0] = fmaf(cz[0], l0[q][j][0], p[q][0]);
            p[q][0] = fmaf(cz[1], l0[q][j][1], p[q][0]);
            p[q][1] = fmaf(cz[2], l0[q][j][2], p[q][1]);
            p[q][1] = fmaf(cz[3], l0[q][j][3], p[q][1]);
          }
        }
        const int s = s0 + sl;
#pragma unroll
        for (int q = 0; q < MW; ++q) {
          if (!live[q]) continue;
          float p0 = p[q][0], p1 = p[q][1];
          p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
          p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
          const int mb = (warp + 8 * q) * 16;
          if (t == (s & 3)) {  // (set, point) belongs to one lane: no races across windows
            sY[s * R + mb + g] += p0;
            sY[s * R + mb + g + 8] += p1;
          }
        }
      }
      __syncthreads();  // readers of this group's buffer are done
    }
  }

  for (int k = 0; k < nsingles; ++k) {
    __syncthreads();
    load_rows(sL0, singles.v[k]);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < MW; ++q) {
      if (!live[q]) continue;
      const int mb = (warp + 8 * q) * 16;
      for (int s = t; s < nsets; s += 4) {
        const float* gv = G1 + ((size_t)s * nsingles + k) * WR;
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int a = 0; a < WR; ++a) {
          const float gw = __ldg(gv + a);
          p0 = fmaf(__bfloat162float(sL0[a * LDR + mb + g]), gw, p0);
          p1 = fmaf(__bfloat162float(sL0[a * LDR + mb + g + 8]), gw, p1);
        }
        sY[s * R + mb + g] += p0;
        sY[s * R + mb + g + 8] += p1;
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < nsets * R; idx += TC_NT) {
    const int s = idx / R, i = i_r + idx % R;
    if (i < n) y[(size_t)s * n + i] = sY[idx];
  }
}

// --- launchers -----------------------------------------------------------------

template <int WR, int NW, int WK, int MPW>
void launch_adjoint_tc(const bf16* tab, int ld, const float* alpha, int n, int nv, const int* pairs,
                       int npairs, float* part, int nchunks, int chunk, size_t S, cudaStream_t st) {
  constexpr int RBMAX = TC_RBMAX_ROWS / WR;
  dim3 grid(nchunks, npairs, (nv + RBMAX - 1) / RBMAX);
  adjoint_tc_kernel<WR, NW, WK, MPW><<<grid, NW * 32, 0, st>>>(tab, ld, alpha, n, nv,
                                                                make_rows(pairs, 2 * npairs), npairs,
                                                                chunk, part, S);
}

template <int WR>
int adjoint_tc(const bf16* tab, int ld, const float* alpha, int n, int nv, const int* pairs,
               int npairs, const int* singles, int nsingles, float* part, int nchunks, int chunk,
               int nw, int wk, int mpw, float* out, cudaStream_t st) {
  const size_t S2 = (size_t)nv * npairs * WR * WR;
  const size_t S = S2 + (size_t)nv * nsingles * WR;
  if (npairs > 0) {
#define ADJ_TC(W, K, M) \
  launch_adjoint_tc<WR, W, K, M>(tab, ld, alpha, n, nv, pairs, npairs, part, nchunks, chunk, S, st)
    if (nw == 8 && wk == 4 && mpw == 1) ADJ_TC(8, 4, 1);
    else if (nw == 8 && wk == 2 && mpw == 1) ADJ_TC(8, 2, 1);
    else if (nw == 8 && wk == 1 && mpw == 1) ADJ_TC(8, 1, 1);
    else if (nw == 8 && wk == 1 && mpw == 2) ADJ_TC(8, 1, 2);
    else if (nw == 12 && wk == 1 && mpw == 2) ADJ_TC(12, 1, 2);
    else if (nw == 8 && wk == 1 && mpw == 4) ADJ_TC(8, 1, 4);
    else return (int)cudaErrorInvalidValue;
#undef ADJ_TC
  }
  if (nsingles > 0) {
    constexpr int RS = NT / WR;
    dim3 grid(nchunks, nsingles, (nv + RS - 1) / RS);
    adjoint_singles_kernel<WR, Bf16Rows<WR>><<<grid, NT, 0, st>>>(
        Bf16Rows<WR>{tab, ld}, alpha, n, nv, make_rows(singles, nsingles), nsingles, chunk, part, S, S2);
  }
  launch_reduce_slices(part, nchunks, S, out, st);
  return (int)cudaGetLastError();
}

template <int WR>
int forward_tc(const bf16* tab, int ld, int n, const int* pairs, int npairs, const float* G2,
               const int* singles, int nsingles, const float* G1, int nsets, uint32_t* Gf, float* y,
               cudaStream_t st) {
  using F = TcFwd<WR>;
  cudaError_t e = cudaFuncSetAttribute(forward_tc_kernel<WR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)F::smem(FWD_SMAX));
  if (e != cudaSuccess) return (int)e;
  const Rows pr = make_rows(pairs, 2 * npairs), sg = make_rows(singles, nsingles);
  for (int s0 = 0; s0 < nsets; s0 += FWD_SMAX) {
    const int ns = min(FWD_SMAX, nsets - s0);
    if (npairs > 0) {
      const size_t words = (size_t)npairs * ns * F::SET_WORDS;
      split_weights_kernel<WR><<<(unsigned)((words + 255) / 256), 256, 0, st>>>(
          G2 + (size_t)s0 * npairs * WR * WR, npairs, ns, Gf);
    }
    forward_tc_kernel<WR><<<(n + FWD_R - 1) / FWD_R, TC_NT, F::smem(ns), st>>>(
        tab, ld, n, pr, npairs, Gf, sg, nsingles, G1 + (size_t)s0 * nsingles * WR, ns, y + (size_t)s0 * n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaGetLastError() code after the launches (0 = success).
// part: (nchunks, S) float32 scratch; nw / wk / mpw: the warps, their
// k-split and the M tiles per warp (ops/_cuda_build.py `adjoint_tc_split`).
int tc_adjoint_launch(const void* tab, int ld, const float* alpha, int WR, int n, int nv,
                      const int* pairs, int npairs, const int* singles, int nsingles, float* part,
                      int nchunks, int chunk, int nw, int wk, int mpw, float* out, void* stream) {
  if (!windows_fit(npairs, nsingles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* T = static_cast<const bf16*>(tab);
  if (WR == 16)
    return adjoint_tc<16>(T, ld, alpha, n, nv, pairs, npairs, singles, nsingles, part, nchunks, chunk, nw,
                          wk, mpw, out, st);
  if (WR == 32)
    return adjoint_tc<32>(T, ld, alpha, n, nv, pairs, npairs, singles, nsingles, part, nchunks, chunk, nw,
                          wk, mpw, out, st);
  return (int)cudaErrorInvalidValue;
}

// Gf: npairs * min(nsets, 32) * WR^2 * 3 / 2 uint32 scratch (the split weights)
int tc_forward_launch(const void* tab, int ld, int WR, int n, const int* pairs, int npairs,
                      const float* G2, const int* singles, int nsingles, const float* G1, int nsets,
                      void* Gf, float* y, void* stream) {
  if (!windows_fit(npairs, nsingles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* T = static_cast<const bf16*>(tab);
  uint32_t* W = static_cast<uint32_t*>(Gf);
  if (WR == 16) return forward_tc<16>(T, ld, n, pairs, npairs, G2, singles, nsingles, G1, nsets, W, y, st);
  if (WR == 32) return forward_tc<32>(T, ld, n, pairs, npairs, G2, singles, nsingles, G1, nsets, W, y, st);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
