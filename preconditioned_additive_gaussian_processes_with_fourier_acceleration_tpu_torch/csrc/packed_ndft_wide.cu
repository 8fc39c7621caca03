// Wide packed NDFT kernels for Hopper (sm_90a), plain C interface: every
// even width 2P = WR the narrow kernels are not built for, every phase
// source.
//
// Port of the two Pallas kernels of the JAX package's ops/pallas_ndft.py at
// the widths the narrow kernels (packed_ndft.cu, packed_ndft_tc.cu,
// packed_ndft_regen.cu: 2P in {16, 32} and {18, 34}) are not built for --
// matern12's accuracy widths, N = 64 to 1024 and past them:
//   _adjoint_kernel (pallas_call at :326) -> wide_adjoint_wg_kernel (2-D windows, tensor cores)
//                                            + wide_singles_kernel (1-D windows, CUDA cores)
//                                            + reduce_slices_kernel (tc_common.cuh)
//   _forward_kernel (pallas_call at :508) -> wide_forward_wg_kernel (2-D windows, tensor cores)
//                                            + wide_singles_forward_kernel (1-D windows, CUDA cores)
// in all four of its phase sources.  The kernels read a float32 or a bf16
// table (`WideKind`).  The regenerating sources ("doubling", "direct")
// first write the phases of every coordinate row into a float32 slab
// (wide_phases_kernel, scratch the caller allocates), each by the formula of
// its plain version (ops/packed_ndft.py phase_slab):
//   DIRECT    cos/sin(pi * 2p x) per mode (cospif/sinpif: 2p is an integer);
//   DOUBLING  row p is row (p & 1) rotated, for every set bit k >= 1 of p
//             from the lowest up, by e^{i 2^k theta}; the rotators come from
//             sincospif(2x) by the double-angle identity.  That is the
//             recurrence of _build_T6_doubling (rows [have, 2 have) = rows
//             [0, have) rotated by the rotator of row have/2) evaluated per
//             row: the same operations in the same order.
// and the kernels read the slab as a float32 table.
//
// What bounds them on an H100 SXM (published peaks at 700 W): the 2-D
// windows do 2 nv npairs WR^2 n flops (adjoint) and 2 nsets npairs WR^2 n
// (forward).  In 3xTF32 (three TF32 products per float32 product) on the
// tensor cores that is 3x over 495 TFLOP/s: at n = 1e5, one pair, WR = 256,
// nv = 1, 0.079 ms against 0.061 ms for the 205 MB float32 table at 3.35
// TB/s -- operations bound them, bytes nearly.  A bf16 table's values are
// exact in tf32 (8 significant bits, tf32 has 11), so its products need two
// TF32 passes, not three.  mma.sync's TF32 issues at about a quarter of the
// tensor-core peak on this card (packed_ndft_regen.cu's kernels, NVIDIA H100
// 80GB HBM3), below the CUDA cores' 67 TFLOP/s of float32; wgmma is the
// route to the full rate, so the 2-D windows of both run on it.  The 1-D
// windows have 1/WR of a pair's work and are bound by the table's bytes.

// Adjoint, 2-D windows (wide_adjoint_wg_kernel): a split-K GEMM per window,
// C[(r, a), b] = sum_i (alpha_r[i] L0[a, i]) L1[b, i], M = nv WR flattened
// (r, a) rows, N = WR, K = the points.
// - A block: 128 M rows (two consumer warpgroups, one 64-row wgmma tile
//   each), one N tile of NT <= 144 columns (WR in ceil(WR / 144) tiles,
//   each rounded up to a compiled width, 64, 72, 128, 136 or 144: 2P = 130
//   runs 136, 256 two of 128, 2P < 64 one of 64), one window,
//   one point chunk; one producer warp (of a third warpgroup, for
//   setmaxnreg).  Pad rows and columns are computed from zeros (TMA fills
//   past WR and past n) or from rows past M, and never written.
// - The producer warp keeps a three-stage ring of 32 points a stage: per
//   stage one TMA copy (cp.async.bulk.tensor, a 3-D map over points, mode
//   rows, coordinate rows) of the tile's NT L1 rows, up to 17 of 8 L0 rows
//   (the block's 128 M rows need at most two runs of a: all rows when
//   WR <= 136), and alpha of the block's right-hand sides by plain loads;
//   full / empty mbarriers.  float32 rows are 128 bytes, copied with the
//   128-byte swizzle that wgmma reads.
// - B = L1 from shared memory through a descriptor (the table's rows are
//   K-major, as tf32 operands must be).  float32: the consumers round the
//   L1 tile to tf32 in place (big) and write the remainder, rounded, into a
//   second buffer (small), so big * big + small * big + big * small are the
//   three products; bf16: they write L1 as float32 into the swizzled
//   buffer, and big * B + small * B are the two.
// - A = alpha_r * L0 from registers: loaded from the swizzled stage, scaled
//   and split into big / small tf32 (tc_common.cuh split_tf32).
// - Three warps of the producer warpgroup prepare B (a `ready` barrier a
//   stage), so the two consumer warpgroups run apart: one's A fragments and
//   sums while the other's products run.
// - Each stage's products go to a fresh accumulator, added to the sum in
//   float32 (round to nearest) when they are done: the tensor cores'
//   float32 accumulation rounds with a bias, and over a chunk of 2e4
//   points it erred by 1.4e-4 relative (NVIDIA H100 80GB HBM3); two
//   accumulators in registers bound the N tile to 144 columns.
// - The chunks write partial slices; reduce_slices_kernel adds them in a
//   fixed order: no atomics, a second launch is bitwise equal.
// Shared memory 184 KB: one block an SM of 384 threads, the consumers at
// 224 registers (setmaxnreg; 144 of them the two accumulators), the
// producer warpgroup at 56.
//
// Adjoint, 1-D windows (wide_singles_kernel): v[r, b] = sum_i alpha_r[i]
// L[b, i] has 1/WR of a pair's work and stays a CUDA-core float32 tile GEMM
// (64 x 64 output tiles, 4 x 4 register tiles, 32 points a step staged as 8
// consecutive points of 4 rows a warp into conflict-free banks).
//
// Forward, 2-D windows (wide_forward_wg_kernel): per window, per set,
// Z_s^T = L1^T G_s^T with the points as M (tf32 wgmma takes both shared
// operands K-major only; G_s's rows are K-major over b, the table's rows
// are not), then y_s[i] += sum_a L0[a, i] Z_s[a, i] in registers.
// - A block: 128 points (two consumer warpgroups, one 64-row M tile each)
//   and up to 32 weight sets, all of them, so the table's rows are read
//   from device memory once per block; one N tile of NT <= 136 columns a
//   at a time (WR in ceil(WR / 136) tiles, each rounded up to 64, 72, 128
//   or 136: 2P = 130 runs 136, 256 two of 128); K = b in stages of 32 (2P =
//   130 runs 160, the rows past WR zero).
// - The weights are split once a call (wide_split_weights_kernel) into big
//   and small tf32 halves, rows padded to 16 bytes, in scratch the caller
//   allocates.  What bounds the kernel is shared memory's bandwidth: per
//   stage the wgmmas read their B tile once per product and warpgroup
//   (96 KB of a float32-table stage), and splitting G in shared memory, as
//   the adjoint splits its L1, read and wrote 48 KB more; split in device
//   memory, the halves cost 16 KB more L2 reads a stage and the split
//   nothing per block (NVIDIA H100 80GB HBM3: 1.05x to 1.52x as fast at nsets >= 2).
// - The producer warp's ring (three stages on float32 tables, four on
//   bf16): per stage one TMA copy each of G_s's big and small tile (32 b x
//   NT a, from a 4-D map) and four of L1's 32 b rows over the block's
//   points; per (window, N tile) one of the L0 tile (NT rows over the
//   points), kept for every set.
// - A = L1^T from registers, loaded from the swizzled stage and split into
//   big / small (float32 table: big * big + small * big + big * small) or
//   taken as it is (bf16: A * big + A * small).  B = G by descriptor.  The
//   M rows map to points so that the A loads and the epilogue's L0 loads
//   hit 32 distinct banks.
// - The epilogue: Z never leaves registers.  Each thread multiplies its
//   accumulator by L0 at its two points, sums its columns, then the four
//   lanes of a quad with shuffles; lane cq keeps y of the sets 4q + cq in
//   registers, added in a fixed order over windows and tiles.  y is
//   written once, no atomics, a second launch is bitwise equal.
// - One accumulator over K: K = WR is at most a few thousand terms, where
//   the tensor cores' float32 accumulation errs below 1e-4 (held against
//   float64 at 2P = 1026 and 2050; the adjoint's fresh per-stage
//   accumulators are for K = 2e4 points).
// Shared memory 219 KB at NT = 136 (float32): one block an SM of 384
// threads, setmaxnreg as the adjoint.
//
// Forward, 1-D windows (wide_singles_forward_kernel): y_s[i] += sum_a L[a,
// i] g_s[a], a GEMV per set bound by the table's bytes: CUDA cores, 128
// points and up to 32 sets a block, two threads a point; it adds to y after
// the 2-D windows' kernel (or writes y without 2-D windows).

#include <cuda.h>
#include <cuda_bf16.h>

#include "packed_ndft.cuh"
#include "tc_common.cuh"
#include "tma_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

enum WideKind { W_F32 = 0, W_BF16 = 1 };  // the kinds of tma_common.cuh tensor_map
enum PhaseGen { G_DOUBLING = 0, G_DIRECT = 1 };  // PHASE_GEN_CODES of ops/_cuda_build.py

constexpr int ROT = 20;  // rotators e^{i 2^k theta}, k < ROT: modes p < 2^20

struct WideSrc {
  const void* p;  // table (Dtot, WR, stride)
  int stride;     // elements between two table rows
  int WR;
};

// Phase row a of coordinate row j at point i, from the table
template <int KIND>
__device__ __forceinline__ float phase(const WideSrc& src, int j, int a, int i) {
  const size_t o = ((size_t)j * src.WR + a) * src.stride + i;
  if constexpr (KIND == W_F32) {
    return __ldg(static_cast<const float*>(src.p) + o);
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(src.p)[o]);
  }
}

// --- phases of the regenerating sources ----------------------------------------------

// slab[(j WR + a) ld + i] = phase row a of coordinate row j at point i:
// cos(2 pi p x) in rows a = p < P, sin in rows P + p.  One thread a point.
template <int GEN>
__global__ void __launch_bounds__(256) wide_phases_kernel(const float* __restrict__ x, int xstride, int P, int n,
                                                          int ld, float* __restrict__ slab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, j = blockIdx.y;
  if (i >= n) return;
  const float xi = x[(size_t)j * xstride + i];
  float* cs = slab + (size_t)j * 2 * P * ld + i;
  float* sn = cs + (size_t)P * ld;
  if constexpr (GEN == G_DIRECT) {
    for (int p = 0; p < P; ++p) {
      const float arg = 2.f * p * xi;
      cs[(size_t)p * ld] = cospif(arg);
      sn[(size_t)p * ld] = sinpif(arg);
    }
  } else {
    float rc[ROT], rs[ROT];
    sincospif(2.f * xi, &rs[0], &rc[0]);
#pragma unroll
    for (int k = 1; k < ROT; ++k) {
      rc[k] = rc[k - 1] * rc[k - 1] - rs[k - 1] * rs[k - 1];
      rs[k] = 2.f * rc[k - 1] * rs[k - 1];
    }
    for (int p = 0; p < P; ++p) {
      float vc = 1.f, vs = 0.f;
      if (p & 1) {
        vc = rc[0];
        vs = rs[0];
      }
#pragma unroll
      for (int k = 1; k < ROT; ++k) {
        if ((p >> k) == 0) break;
        if ((p >> k) & 1) {
          const float nc = vc * rc[k] - vs * rs[k];
          const float ns = vs * rc[k] + vc * rs[k];
          vc = nc;
          vs = ns;
        }
      }
      cs[(size_t)p * ld] = vc;
      sn[(size_t)p * ld] = vs;
    }
  }
}

// --- adjoint, 2-D windows: wgmma in 3xTF32 ---------------------------------------------

constexpr int WG_CONSUMERS = 256;                // two warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 128;   // and the producer warpgroup: a loader warp, three B-prep warps
constexpr int WG_PREP = 96;                      // the B-prep threads
constexpr int WG_REGS_CONSUMER = 224;            // setmaxnreg: 2 x 128 x 224 + 128 x 56 <= 65536
constexpr int WG_REGS_PRODUCER = 56;
constexpr int WG_ROWS = 128;                     // M rows a block
constexpr int WG_KS = 32;                        // points a stage: one 128-byte float32 row
static_assert(WG_KS == TMA_POINTS, "a stage is one box of the table's tensor map");
constexpr int WG_NMAX = WGMMA_ROWS_MAX;          // the widest N tile: 144 (two accumulators in registers)
constexpr int WG_ACC = WGMMA_ROWS_ACC;           // registers of one accumulator
constexpr int WG_STAGES = 3;                     // the ring
constexpr int WG_SLOTS = 136;                    // L0 rows a stage: WR <= 136, or two 8-row-rounded runs of 128
constexpr int WG_AR = 64;                        // alpha rows a stage: the rhs of 128 M rows at 2P = 2
constexpr int WG_L1_BYTES = WG_NMAX * WG_KS * 4;
constexpr int WG_L0_BYTES = WG_SLOTS * WG_KS * 4;
constexpr int WG_AL_BYTES = WG_AR * WG_KS * 4;
// per stage s: L1 (TMA), Bx (small part / float32 copy), L0 (TMA), alpha;
// every buffer 1024-byte aligned (the 128-byte swizzle's period)
constexpr int WG_OFF_BX = WG_STAGES * WG_L1_BYTES;
constexpr int WG_OFF_L0 = WG_OFF_BX + WG_STAGES * WG_L1_BYTES;
constexpr int WG_OFF_AL = WG_OFF_L0 + WG_STAGES * WG_L0_BYTES;
constexpr int WG_OFF_BAR = WG_OFF_AL + WG_STAGES * WG_AL_BYTES;
constexpr int WG_SMEM = WG_OFF_BAR + 24 * WG_STAGES + 1024;  // three barriers a stage; + the base's alignment
static_assert(WG_L1_BYTES % 1024 == 0 && WG_L0_BYTES % 1024 == 0, "stage buffers must stay 1024-byte aligned");
static_assert(WG_SMEM <= 232448, "more shared memory than a block can have");

// the consumers' generic writes of shared memory, seen by wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// keeps the accumulator's registers out of reach of the compiler's
// reordering around the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[WG_ACC]) {
#pragma unroll
  for (int i = 0; i < WG_ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// L0 row `slot` of a stage at point k: float32 rows of 128 bytes with the
// 128-byte swizzle (16-byte chunk k / 4 at chunk (k / 4) ^ (slot % 8)),
// bf16 rows of 64 bytes with the 64-byte swizzle (chunk (k / 8) ^ ((slot / 2) % 4))
template <int KIND>
__device__ __forceinline__ float l0_at(const unsigned char* L0, int slot, int k) {
  if constexpr (KIND == W_F32) {
    return *reinterpret_cast<const float*>(L0 + slot * 128 + ((((k >> 2) ^ (slot & 7)) << 4) | ((k & 3) << 2)));
  } else {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
        L0 + slot * 64 + ((((k >> 3) ^ ((slot >> 1) & 3)) << 4) | ((k & 7) << 1))));
  }
}

// B of one stage, by the WG_PREP threads (t < WG_PREP): float32, L1
// rounded to tf32 in place and the rounded remainder into Bx at the same
// offsets (the swizzle does not move them); bf16, L1's plain 64-byte rows
// into Bx as float32 rows with the 128-byte swizzle
template <int KIND>
__device__ __forceinline__ void prep_b(unsigned char* L1, unsigned char* Bx, int nt, int t) {
  if constexpr (KIND == W_F32) {
    float4* big = reinterpret_cast<float4*>(L1);
    float4* small = reinterpret_cast<float4*>(Bx);
#pragma unroll 1
    for (int idx = t; idx < nt * 8; idx += WG_PREP) {
      const float4 v = big[idx];
      uint32_t b[4], s[4];
      split_tf32(v.x, b[0], s[0]);
      split_tf32(v.y, b[1], s[1]);
      split_tf32(v.z, b[2], s[2]);
      split_tf32(v.w, b[3], s[3]);
      big[idx] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                             __uint_as_float(b[3]));
      small[idx] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]),
                               __uint_as_float(s[3]));
    }
  } else {
#pragma unroll 1
    for (int idx = t; idx < nt * 8; idx += WG_PREP) {
      const int row = idx >> 3, q = idx & 7;
      const uint2 raw = *reinterpret_cast<const uint2*>(L1 + row * 64 + q * 8);
      *reinterpret_cast<float4*>(Bx + row * 128 + ((q ^ (row & 7)) << 4)) =
          make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                      __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
    }
  }
}

// The A fragments of one stage (4 k-steps of 8 points): rows slot[h] of
// L0, scaled by alpha row ar[h], split into big / small tf32
template <int KIND>
__device__ __forceinline__ void make_a(uint32_t (&fa)[4][2][4], const unsigned char* L0, const float* al,
                                       int (&slot)[2], int (&ar)[2], int cq) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * ks + cq + 4 * q;
        split_tf32(al[ar[h] * WG_KS + k] * l0_at<KIND>(L0, slot[h], k), fa[ks][0][h + 2 * q], fa[ks][1][h + 2 * q]);
      }
}

// One stage's products into a fresh accumulator d (the first overwrites
// it): per k-step big * big, small * big and (float32) big * small;
// descriptors advance 32 bytes (2 units) a k-step
template <int KIND, int NT>
__device__ __forceinline__ void stage_products(float (&d)[WG_ACC], const uint32_t (&fa)[4][2][4], uint32_t big,
                                               uint32_t small) {
  const uint64_t db = sw128_desc(big), ds = sw128_desc(small);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_rows<NT>(d, fa[ks][0], db + 2 * ks, ks > 0);
    wgmma_rows<NT>(d, fa[ks][1], db + 2 * ks, 1);
    if constexpr (KIND == W_F32) wgmma_rows<NT>(d, fa[ks][0], ds + 2 * ks, 1);
  }
}

// The accumulator slice of width W at d[OFF..] (wgmma_rows) to columns
// cb.. of the tile: float2 stores of the live rows and columns
template <int W, int OFF>
__device__ __forceinline__ void store_slice(const float (&d)[WG_ACC], float* (&orow)[2], bool (&ok)[2], int cb,
                                            int ncols, int cq) {
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int h = (i >> 1) & 1, col = cb + 8 * (i >> 2) + 2 * cq;
    if (ok[h] && col < ncols) *reinterpret_cast<float2*>(orow[h] + col) = make_float2(d[OFF + i], d[OFF + i + 1]);
  }
}

// One chunk's partial C of one window over 128 M rows and one N tile.
// map0: L0 boxes of 8 rows, map1: L1 boxes of nt rows, both 32 points wide.
// Output (r, a, b) at part + c S + w WR^2 + r rstride + a WR + b.  NT: the
// tile width, fixed at compile time, so that the products run without
// branches and ptxas keeps them in flight (a width taken at run time
// serialized them and cost a third more time: NVIDIA H100 80GB HBM3,
// 2P = 256, nv = 10, 1.77 against 1.35 ms); wg_kernel lists the widths.
template <int KIND, int NT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wide_adjoint_wg_kernel(const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
                           const float* __restrict__ alpha, int n, int nv, int WR, Rows pairs, int ntn, int chunk,
                           float* __restrict__ part, size_t S, size_t rstride) {
  constexpr int nt = NT;
  constexpr int ROWB = KIND == W_F32 ? 128 : 64;  // bytes of a staged table row
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(base);
  // a barrier a stage each, 8 bytes apart: the loads have landed (full),
  // B is prepared (ready), the consumers are done with the stage (empty)
  const uint32_t full = sbase + WG_OFF_BAR, ready = full + 8 * WG_STAGES, empty = ready + 8 * WG_STAGES;
  const int t = threadIdx.x;
  // the warpgroup, uniform to the compiler (a shuffle from lane 0), so that
  // the wgmmas under branches on it are not serialized
  const int wg = __shfl_sync(0xffffffffu, t / 128, 0);
  const int tn = blockIdx.x % ntn, m_cta = (blockIdx.x / ntn) * WG_ROWS, n0 = tn * nt;
  const int w = blockIdx.y, c = blockIdx.z;
  const int M = nv * WR;
  const int i_begin = c * chunk, i_end = min(n, i_begin + chunk);
  const int nstage = (i_end - i_begin + WG_KS - 1) / WG_KS;
  // L0 rows of the block's M rows: all WR rows at slots a when WR <= WG_SLOTS;
  // else the 128-row run from a_s (seg1 rows to WR, then seg2 from row 0,
  // slots from slot2), each run in whole 8-row boxes
  const bool all_rows = WR <= WG_SLOTS;
  const int a_s = all_rows ? 0 : m_cta % WR;
  const int seg1 = all_rows ? WR : min(WG_ROWS, WR - a_s);
  const int seg2 = all_rows ? 0 : WG_ROWS - seg1;
  const int nb1 = (seg1 + 7) / 8, slot2 = 8 * nb1, nb0 = nb1 + (seg2 + 7) / 8;
  const int r_lo = m_cta / WR;
  const int nar = min(nv - 1, (m_cta + WG_ROWS - 1) / WR) - r_lo + 1;

  if (t == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 33);              // the loader lane with the bytes, then all 32 lanes after alpha
      mbar_init(ready + 8 * s, WG_PREP / 32);   // the B-prep warps
      mbar_init(empty + 8 * s, 8);              // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: its first warp loads, the others prepare B
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_REGS_PRODUCER));
    if (t >= WG_CONSUMERS + 32) {
      const int pt = t - WG_CONSUMERS - 32;
      for (int k = 0; k < nstage; ++k) {
        const int s = k % WG_STAGES;
        mbar_wait(full + 8 * s, (k / WG_STAGES) & 1);
        prep_b<KIND>(base + s * WG_L1_BYTES, base + WG_OFF_BX + s * WG_L1_BYTES, nt, pt);
        fence_proxy_async();  // the generic writes, before the consumers' wgmmas read them
        __syncwarp();
        if (pt % 32 == 0) mbar_arrive(ready + 8 * s);
      }
      return;
    }
    const int lane = t - WG_CONSUMERS;
    const int ja = pairs.v[2 * w], jb = pairs.v[2 * w + 1];
    const uint32_t tx = (uint32_t)(8 * nb0 + nt) * ROWB;  // bytes a stage: the boxes, pad rows included
    for (int k = 0; k < nstage; ++k) {
      const int s = k % WG_STAGES, u = k / WG_STAGES, i0 = i_begin + k * WG_KS;
      if (u > 0) mbar_wait(empty + 8 * s, (u - 1) & 1);  // stage k - WG_STAGES is done with the buffers
      if (lane == 0) mbar_arrive_tx(full + 8 * s, tx);
      __syncwarp();
      if (lane < nb0) {
        const int row = lane < nb1 ? a_s + 8 * lane : 8 * (lane - nb1);
        const int slot = lane < nb1 ? 8 * lane : slot2 + 8 * (lane - nb1);
        tma_load(sbase + WG_OFF_L0 + s * WG_L0_BYTES + slot * ROWB, &map0, full + 8 * s, i0, row, ja);
      }
      if (lane == 31) tma_load(sbase + s * WG_L1_BYTES, &map1, full + 8 * s, i0, n0, jb);
      float* al = reinterpret_cast<float*>(base + WG_OFF_AL + s * WG_AL_BYTES);
      const int i = i0 + lane;
      for (int ar = 0; ar < nar; ++ar)
        al[ar * WG_KS + lane] = i < i_end ? __ldg(alpha + (size_t)(r_lo + ar) * n + i) : 0.f;
      mbar_arrive(full + 8 * s);
    }
  } else {  // the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_REGS_CONSUMER));
    const int wq = (t % 128) / 32, lane = t % 32, g = lane / 4, cq = lane % 4;
    const int mt0 = m_cta + 64 * wg;  // the warpgroup's 64-row M tile
    const bool live = mt0 < M;
    // this thread's rows of A: block rows tr and tr + 8 (rows past M compute
    // from slot 0 and are never written)
    int slot[2], ar[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tr = 64 * wg + 16 * wq + g + 8 * h, m = m_cta + tr, r = m / WR, a = m - r * WR;
      const bool ok = m < M;
      slot[h] = !ok ? 0 : all_rows ? a : tr < seg1 ? tr : slot2 + tr - seg1;
      ar[h] = ok ? r - r_lo : 0;
    }
    // each stage's products go to a fresh accumulator, added to the sum
    // (round to nearest) once they are done: the tensor cores' own float32
    // accumulation rounds with a bias that grows with the points it sums
    float acc[WG_ACC], fresh[WG_ACC];
#pragma unroll
    for (int e = 0; e < WG_ACC; ++e) acc[e] = fresh[e] = 0.f;
    uint32_t fa[4][2][4];
    // the two warpgroups run apart: one's A fragments and sums while the
    // other's products run.  A warpgroup past M still waits for every
    // stage, so that its arrivals never run ahead of the live one's.
    for (int k = 0; k < nstage; ++k) {
      const int s = k % WG_STAGES, par = (k / WG_STAGES) & 1;
      if (k > 0) {  // stage k - 1's products are done with its buffers
        if (live) {
          wgmma_wait0();
          fence_acc(fresh);
#pragma unroll
          for (int e = 0; e < WG_ACC; ++e) acc[e] += fresh[e];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((k - 1) % WG_STAGES));
      }
      mbar_wait(ready + 8 * s, par);
      mbar_wait(full + 8 * s, par);  // complete already; orders the TMA's L0 and alpha before the reads
      if (live) {
        make_a<KIND>(fa, base + WG_OFF_L0 + s * WG_L0_BYTES,
                     reinterpret_cast<const float*>(base + WG_OFF_AL + s * WG_AL_BYTES), slot, ar, cq);
        wgmma_fence();
        if constexpr (KIND == W_F32) {
          stage_products<KIND, NT>(fresh, fa, sbase + s * WG_L1_BYTES, sbase + WG_OFF_BX + s * WG_L1_BYTES);
        } else {
          stage_products<KIND, NT>(fresh, fa, sbase + WG_OFF_BX + s * WG_L1_BYTES, 0);
        }
        wgmma_commit();
      }
    }
    if (live) {
      wgmma_wait0();
      fence_acc(fresh);
#pragma unroll
      for (int e = 0; e < WG_ACC; ++e) acc[e] += fresh[e];
      float* orow[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt0 + 16 * wq + g + 8 * h, r = m / WR, a = m - r * WR;
        ok[h] = m < M;
        orow[h] = part + (size_t)c * S + (size_t)w * WR * WR + (size_t)r * rstride + (size_t)a * WR + n0;
      }
      const int ncols = min(nt, WR - n0);
      if constexpr (nt >= 128) {  // the slices of wgmma_rows
        store_slice<128, 0>(acc, orow, ok, 0, ncols, cq);
        if constexpr ((nt & 16) != 0) store_slice<16, 64>(acc, orow, ok, wgmma_cols(nt, 16), ncols, cq);
        if constexpr ((nt & 8) != 0) store_slice<8, 64>(acc, orow, ok, wgmma_cols(nt, 8), ncols, cq);
      } else {
        store_slice<64, 0>(acc, orow, ok, 0, ncols, cq);
        if constexpr ((nt & 8) != 0) store_slice<8, 56>(acc, orow, ok, wgmma_cols(nt, 8), ncols, cq);
      }
    }
  }
}

// The N-tile widths of the 2-D windows' kernel, one instance each: those
// of 2P = N and N + 2 for N = 64, 128, 256, ..., and 144, the widest
constexpr int WG_WIDTHS[] = {64, 72, 128, 136, 144};

template <int KIND>
auto wg_kernel(int nt) {
  return nt == 64    ? wide_adjoint_wg_kernel<KIND, 64>
         : nt == 72  ? wide_adjoint_wg_kernel<KIND, 72>
         : nt == 128 ? wide_adjoint_wg_kernel<KIND, 128>
         : nt == 136 ? wide_adjoint_wg_kernel<KIND, 136>
                     : wide_adjoint_wg_kernel<KIND, 144>;
}

// The N tiles and the M row pairs of tiles of the 2-D windows' kernel: WR
// in ceil(WR / 144) tiles, each the narrowest width of WG_WIDTHS that holds
// its share (ops/_cuda_build.py `wide_tiles` computes the same)
struct WgTiles {
  int nt, ntn, mpairs;
};

WgTiles wg_tiles(int WR, int nv) {
  const int ntn = (WR + WG_NMAX - 1) / WG_NMAX;
  const int need = (WR + ntn - 1) / ntn;
  int nt = WG_NMAX;
  for (int k = 4; k >= 0; --k)
    if (WG_WIDTHS[k] >= need) nt = WG_WIDTHS[k];
  const long long mtiles = ((long long)nv * WR + 63) / 64;
  return {nt, ntn, (int)((mtiles + 1) / 2)};
}

// --- adjoint, 1-D windows: CUDA cores ----------------------------------------------------

constexpr int AT = 256;                      // threads
constexpr int ABM = 64, ABN = 64, ABK = 32;  // output tile, points per step
constexpr int ALD = ABM + 4;

// One chunk's partial v over one 64 x 64 output tile (rhs r x mode b) of a
// 1-D window; output (r, b) at part + c S + base + w WR + r rstride + b.
// A warp owns 8 columns of the tile (tn = 2 warp, 2 warp + 1) over all 64
// rows, so pad columns' warps skip their FMAs.
template <int KIND>
__global__ void __launch_bounds__(AT, KIND == W_BF16 ? 2 : 3)
    wide_singles_kernel(WideSrc src, const float* __restrict__ alpha, int n, int nv, Rows singles, int ntn, int chunk,
                        float* __restrict__ part, size_t S, size_t base, size_t rstride) {
  __shared__ __align__(16) float sA[ABK][ALD];
  __shared__ __align__(16) float sB[ABK][ALD];
  const int WR = src.WR;
  const int m0 = (blockIdx.x / ntn) * ABM, n0 = (blockIdx.x % ntn) * ABN;
  const int w = blockIdx.y, c = blockIdx.z;
  const int j = singles.v[w];
  const int i_begin = c * chunk, i_end = min(n, i_begin + chunk);
  const int t = threadIdx.x, tm = t % 16, tn = t / 16;
  const bool idle = n0 + tn * 4 >= WR;
  // staging map: a thread stages points k8 + 8 q (q < 4) of tile rows
  // srow[h] (h < 2) of A and of B: a warp stages 8 consecutive points of 4
  // rows per instruction (whole 32-byte sectors) into 32 distinct banks
  const int lane = t % 32, k8 = lane % 8;
  const int srow[2] = {lane / 8 + 4 * (t / 32), lane / 8 + 4 * (t / 32 + 8)};
  bool okA[2], okB[2];
  int brow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    okA[h] = m0 + srow[h] < nv;
    brow[h] = n0 + srow[h];
    okB[h] = brow[h] < WR;
  }
  float acc[4][4] = {};
  for (int i0 = i_begin; i0 < i_end; i0 += ABK) {
    __syncthreads();  // the previous step's FMAs are done with the tiles
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = k8 + 8 * q, i = i0 + kk;
        const bool live = i < i_end;
        sA[kk][srow[h]] = (live && okA[h]) ? alpha[(size_t)(m0 + srow[h]) * n + i] : 0.f;
        sB[kk][srow[h]] = (live && okB[h]) ? phase<KIND>(src, j, brow[h], i) : 0.f;
      }
    }
    __syncthreads();
    if (idle) continue;
#pragma unroll 8
    for (int k = 0; k < ABK; ++k) {
      float av[4], bv[4];
      load_vec<4>(av, &sA[k][tm * 4]);
      load_vec<4>(bv, &sB[k][tn * 4]);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = m0 + tm * 4 + p;
    if (r >= nv) continue;
    float* out = part + (size_t)c * S + base + (size_t)w * WR + (size_t)r * rstride;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = n0 + tn * 4 + q;
      if (b < WR) out[b] = acc[p][q];
    }
  }
}

template <int KIND>
cudaError_t wide_adjoint(const WideSrc& src, const float* alpha, int n, int nv, const int* pairs, int npairs,
                         const int* singles, int nsingles, float* part, int nchunks, int chunk, float* out,
                         cudaStream_t st) {
  const size_t WR = src.WR;
  const size_t S2 = (size_t)nv * npairs * WR * WR;
  const size_t S = S2 + (size_t)nv * nsingles * WR;
  if (npairs > 0) {
    int Dtot = 0;
    for (int k = 0; k < 2 * npairs; ++k) Dtot = pairs[k] + 1 > Dtot ? pairs[k] + 1 : Dtot;
    const WgTiles g = wg_tiles(src.WR, nv);
    CUtensorMap map0, map1;
    if (!tensor_map(&map0, KIND, src.p, src.stride, src.WR, n, Dtot, 8, true) ||
        !tensor_map(&map1, KIND, src.p, src.stride, src.WR, n, Dtot, g.nt, false))
      return cudaErrorInvalidValue;
    const auto kernel = wg_kernel<KIND>(g.nt);
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (e != cudaSuccess) return e;
    dim3 grid(g.mpairs * g.ntn, npairs, nchunks);
    kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(map0, map1, alpha, n, nv, src.WR, make_rows(pairs, 2 * npairs), g.ntn,
                                              chunk, part, S, (size_t)npairs * WR * WR);
  }
  if (nsingles > 0) {
    const int ntn = (src.WR + ABN - 1) / ABN, ntm = (nv + ABM - 1) / ABM;
    dim3 grid(ntm * ntn, nsingles, nchunks);
    wide_singles_kernel<KIND><<<grid, AT, 0, st>>>(src, alpha, n, nv, make_rows(singles, nsingles), ntn, chunk, part,
                                                   S, S2, (size_t)nsingles * WR);
  }
  launch_reduce_slices(part, nchunks, S, out, st);
  return cudaSuccess;
}

// --- forward, 2-D windows: wgmma in 3xTF32, the points as M ----------------------------

constexpr int FW_POINTS = 128;  // points a block: one 64-row M tile per consumer warpgroup
constexpr int FW_BOXES = FW_POINTS / WG_KS;  // 32-point TMA boxes a block
constexpr int FW_SETS = 32;     // weight sets a block (the grid tiles more); 8 per lane of a quad
constexpr int FW_KS = 32;       // b a stage: one 128-byte float32 row of G
// the ring: three stages (float32 tables, whose L1 rows take twice the
// bytes and the L0 tile too) or four (bf16)
constexpr int FW_STAGES_F32 = 3, FW_STAGES_BF16 = 4;
constexpr int FW_NMAX = 136;    // the widest N tile: the ring and the L0 tile fit shared memory

// Shared memory of the instance with N tile NT: per stage the big and the
// small tf32 half of G_s's tile (NT rows of 32 b each, 128-byte swizzle)
// and L1's 32 b rows over the block's points (FW_BOXES boxes of 32 points);
// the L0 tile of NT a rows over the block's points; barriers.  Every buffer
// 1024-byte aligned (the 128-byte swizzle's period).
template <int KIND, int NT>
struct FwSmem {
  static constexpr int ROWB = KIND == W_F32 ? 128 : 64;  // bytes of a staged table row of 32 points
  static constexpr int STAGES = KIND == W_F32 ? FW_STAGES_F32 : FW_STAGES_BF16;
  static constexpr int G = NT * 128;
  static constexpr int L1 = FW_BOXES * FW_KS * ROWB;
  static constexpr int L0 = FW_BOXES * NT * ROWB;
  static constexpr int OFF_GS = STAGES * G;
  static constexpr int OFF_L1 = 2 * STAGES * G;
  static constexpr int OFF_L0 = OFF_L1 + STAGES * L1;
  static constexpr int OFF_BAR = OFF_L0 + L0;
  static constexpr int BYTES = OFF_BAR + 8 * (2 * STAGES + 2) + 1024;  // + the base's alignment
  static_assert(G % 1024 == 0 && L1 % 1024 == 0 && OFF_L0 % 1024 == 0, "stage buffers must stay 1024-byte aligned");
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

// a box of the 4-D tensor map of G at (b c0, a c1, window c2, set c3)
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A = L1^T of one stage (4 k-steps of 8 b) for this thread's points inner[h]
// of its 32-point box: float32 split into big / small tf32, bf16 exact
template <int KIND>
__device__ __forceinline__ void make_a_fwd(uint32_t (&fa)[4][2][4], const unsigned char* L1, const int (&inner)[2],
                                           int cq) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = l0_at<KIND>(L1, 8 * ks + cq + 4 * q, inner[h]);
        if constexpr (KIND == W_F32) {
          split_tf32(v, fa[ks][0][h + 2 * q], fa[ks][1][h + 2 * q]);
        } else {
          fa[ks][0][h + 2 * q] = __float_as_uint(v);
        }
      }
}

// One stage's products into d (the first of a set overwrites it): per k-step
// big * big, small * big and big * small (float32 table), or A * big and
// A * small (bf16 table: A is exact in tf32)
template <int KIND, int NT>
__device__ __forceinline__ void fwd_products(float (&d)[WG_ACC], const uint32_t (&fa)[4][2][4], uint32_t big,
                                             uint32_t small, int keep) {
  const uint64_t db = sw128_desc(big), ds = sw128_desc(small);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_rows<NT>(d, fa[ks][0], db + 2 * ks, ks > 0 ? 1 : keep);
    if constexpr (KIND == W_F32) wgmma_rows<NT>(d, fa[ks][1], db + 2 * ks, 1);
    wgmma_rows<NT>(d, fa[ks][0], ds + 2 * ks, 1);
  }
}

// v[h] += sum over the accumulator slice of width W at d[OFF..] (wgmma_rows)
// of its columns a (cb.. of the tile) times L0[a] at this thread's points
template <int KIND, int W, int OFF>
__device__ __forceinline__ void dot_slice(const float (&d)[WG_ACC], const unsigned char* L0, int cb,
                                          const int (&inner)[2], int cq, float (&v)[2]) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const int h = (i >> 1) & 1, col = cb + 8 * (i >> 2) + 2 * cq + (i & 1);
    v[h] = fmaf(d[OFF + i], l0_at<KIND>(L0, col, inner[h]), v[h]);
  }
}

// y_s[i] = sum_w sum_a L0_w[a, i] (G_{s,w} L1_w)[a, i] over the block's 128
// points and up to 32 weight sets.  Per window, per N tile of NT columns a
// (the L0 tile loaded once), per set: Z^T = L1^T G_s^T on wgmma (M = the
// points, N = a, K = b in stages of 32), then the epilogue in registers.
// maps: l0 the table in boxes of 32 points x NT rows, l1 in boxes of 32 x 32
// rows, g the split weights (b, a, window, set; sets nsets.. the small
// halves) in boxes of 32 b x NT a.
template <int KIND, int NT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wide_forward_wg_kernel(const __grid_constant__ CUtensorMap mapl0, const __grid_constant__ CUtensorMap mapl1,
                           const __grid_constant__ CUtensorMap mapg, int n, int WR, Rows pairs, int npairs, int nsets,
                           float* __restrict__ y) {
  using SM = FwSmem<KIND, NT>;
  constexpr int ROWB = SM::ROWB, NS = SM::STAGES;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(base);
  // a barrier a stage each: the loads have landed (full), the consumers
  // are done with the stage (empty); and the L0 tile's: loaded (l0full),
  // done with (l0empty)
  const uint32_t full = sbase + SM::OFF_BAR, empty = full + 8 * NS;
  const uint32_t l0full = empty + 8 * NS, l0empty = l0full + 8;
  const int t = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, t / 128, 0);  // uniform to the compiler (as the adjoint's)
  const int i0 = blockIdx.x * FW_POINTS, s0 = blockIdx.y * FW_SETS;
  const int ns = min(FW_SETS, nsets - s0);
  const int ntn = (WR + NT - 1) / NT, nk = (WR + FW_KS - 1) / FW_KS;

  if (t == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);   // the loader lane with the bytes
      mbar_init(empty + 8 * s, 8);  // the 8 consumer warps
    }
    mbar_init(l0full, 1);
    mbar_init(l0empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup (for setmaxnreg): its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_REGS_PRODUCER));
    if (t >= WG_CONSUMERS + 32) return;
    const int lane = t - WG_CONSUMERS;
    const uint32_t tx = (uint32_t)(2 * NT * 128 + FW_BOXES * FW_KS * ROWB);  // bytes a stage
    int it = 0, tile = 0;
    for (int w = 0; w < npairs; ++w) {
      const int ja = pairs.v[2 * w], jb = pairs.v[2 * w + 1];
      for (int tn = 0; tn < ntn; ++tn, ++tile) {
        for (int s = 0; s < ns; ++s) {
          for (int k = 0; k < nk; ++k, ++it) {
            const int st = it % NS, u = it / NS;
            if (u > 0) mbar_wait(empty + 8 * st, (u - 1) & 1);  // stage it - NS is done with the buffers
            if (lane == 0) mbar_arrive_tx(full + 8 * st, tx);
            __syncwarp();
            if (lane < FW_BOXES)
              tma_load(sbase + SM::OFF_L1 + st * SM::L1 + lane * FW_KS * ROWB, &mapl1, full + 8 * st,
                       i0 + WG_KS * lane, FW_KS * k, jb);
            if (lane == FW_BOXES) tma_load4(sbase + st * SM::G, &mapg, full + 8 * st, FW_KS * k, NT * tn, w, s0 + s);
            if (lane == FW_BOXES + 1)
              tma_load4(sbase + SM::OFF_GS + st * SM::G, &mapg, full + 8 * st, FW_KS * k, NT * tn, w, nsets + s0 + s);
            // the tile's L0 once the first stages are on their way: the
            // consumers need it after a set's last stage, and are done with
            // the previous tile's before they take these stages
            if (s == 0 && k == min(nk, NS) - 1) {
              if (tile > 0) mbar_wait(l0empty, (tile - 1) & 1);
              if (lane == 0) mbar_arrive_tx(l0full, (uint32_t)(FW_BOXES * NT * ROWB));
              __syncwarp();
              if (lane < FW_BOXES)
                tma_load(sbase + SM::OFF_L0 + lane * NT * ROWB, &mapl0, l0full, i0 + WG_KS * lane, NT * tn, ja);
            }
          }
        }
      }
    }
  } else {  // the two consumer warpgroups, 64 points each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_REGS_CONSUMER));
    const int wq = (t % 128) / 32, lane = t % 32, g = lane / 4, cq = lane % 4;
    // M rows 16 wq + g + 8 h of the warpgroup's tile are points inner[h] of
    // its 32-point box `box`: 16-byte chunks c and c ^ 5 (c = 2 (wq & 1) +
    // h) of the staged rows for g < 4 and g >= 4, so that the A loads (rows
    // 4q + cq) and the epilogue's L0 loads (rows 2cq + e) hit 32 distinct
    // banks under the swizzle
    const int box = 2 * wg + (wq >> 1);
    int inner[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inner[h] = 4 * ((2 * (wq & 1) + h) ^ (5 * (g >> 2))) + (g & 3);
    float acc[WG_ACC];
#pragma unroll
    for (int e = 0; e < WG_ACC; ++e) acc[e] = 0.f;
    float yr[FW_SETS / 4][2];  // y of sets 4 q + cq at this thread's two points
#pragma unroll
    for (int q = 0; q < FW_SETS / 4; ++q) yr[q][0] = yr[q][1] = 0.f;
    uint32_t fa[4][2][4];
    const unsigned char* L0 = base + SM::OFF_L0 + box * NT * ROWB;
    int it = 0, tile = 0;
    for (int w = 0; w < npairs; ++w) {
      for (int tn = 0; tn < ntn; ++tn, ++tile) {
        for (int s = 0; s < ns; ++s) {
          for (int k = 0; k < nk; ++k, ++it) {
            const int st = it % NS, par = (it / NS) & 1;
            mbar_wait(full + 8 * st, par);
            make_a_fwd<KIND>(fa, base + SM::OFF_L1 + st * SM::L1 + box * FW_KS * ROWB, inner, cq);
            wgmma_fence();
            fwd_products<KIND, NT>(acc, fa, sbase + st * SM::G, sbase + SM::OFF_GS + st * SM::G, k > 0);
            wgmma_commit();
            wgmma_wait0();
            fence_acc(acc);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * st);
          }
          if (s == 0) mbar_wait(l0full, tile & 1);
          // y_s at this thread's points += sum_a L0[a] Z[a]: its columns, then
          // the four lanes of the quad (butterfly: every lane the same sum)
          float v[2] = {0.f, 0.f};
          if constexpr (NT >= 128) {  // the slices of wgmma_rows
            dot_slice<KIND, 128, 0>(acc, L0, 0, inner, cq, v);
            if constexpr ((NT & 8) != 0) dot_slice<KIND, 8, 64>(acc, L0, wgmma_cols(NT, 8), inner, cq, v);
          } else {
            dot_slice<KIND, 64, 0>(acc, L0, 0, inner, cq, v);
            if constexpr ((NT & 8) != 0) dot_slice<KIND, 8, 56>(acc, L0, wgmma_cols(NT, 8), inner, cq, v);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
            v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
          }
#pragma unroll
          for (int q = 0; q < FW_SETS / 4; ++q)
            if (4 * q + cq == s) {
              yr[q][0] += v[0];
              yr[q][1] += v[1];
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(l0empty);  // every set's epilogue of the tile is done with L0
      }
    }
#pragma unroll
    for (int q = 0; q < FW_SETS / 4; ++q) {
      const int s = 4 * q + cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + WG_KS * box + inner[h];
        if (s < ns && i < n) y[(size_t)(s0 + s) * n + i] = yr[q][h];
      }
    }
  }
}

// The N-tile widths of the forward's 2-D windows, one instance each (those
// of the adjoint but 144: its L0 tile and three stages would not fit)
constexpr int FW_WIDTHS[] = {64, 72, 128, 136};

template <int KIND>
auto fw_kernel(int nt) {
  return nt == 64    ? wide_forward_wg_kernel<KIND, 64>
         : nt == 72  ? wide_forward_wg_kernel<KIND, 72>
         : nt == 128 ? wide_forward_wg_kernel<KIND, 128>
                     : wide_forward_wg_kernel<KIND, 136>;
}

template <int KIND>
int fw_smem(int nt) {
  return nt == 64    ? FwSmem<KIND, 64>::BYTES
         : nt == 72  ? FwSmem<KIND, 72>::BYTES
         : nt == 128 ? FwSmem<KIND, 128>::BYTES
                     : FwSmem<KIND, 136>::BYTES;
}

// The forward's N tile: WR in ceil(WR / 136) tiles, each the narrowest
// width of FW_WIDTHS that holds its share (ops/_cuda_build.py
// `wide_forward_tiles` computes the same)
int fw_tile(int WR) {
  const int ntn = (WR + FW_NMAX - 1) / FW_NMAX;
  const int need = (WR + ntn - 1) / ntn;
  int nt = FW_NMAX;
  for (int k = 3; k >= 0; --k)
    if (FW_WIDTHS[k] >= need) nt = FW_WIDTHS[k];
  return nt;
}

// The weights' split, once a call: G2 (nsets, npairs, WR, WR) at element
// strides (gset, gpair, grow, 1) -> out (2, nsets, npairs, WR, WRp), WRp =
// WR rounded up to 4 floats (16-byte rows for the TMA copies): [0] big =
// tf32(G), [1] small = tf32(G - big) (tc_common.cuh split_tf32), zeros in
// the pad.  One thread an element of out's half.
__global__ void __launch_bounds__(256) wide_split_weights_kernel(const float* __restrict__ G2, long long gset,
                                                                 long long gpair, long long grow, int WR, int WRp,
                                                                 int npairs, long long half, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= half) return;
  const int b = (int)(e % WRp);
  const long long r = e / WRp;
  const int a = (int)(r % WR);
  const long long sw = r / WR;
  const long long w = sw % npairs, s = sw / npairs;
  uint32_t big = 0, small = 0;
  if (b < WR) split_tf32(G2[s * gset + w * gpair + a * grow + b], big, small);
  out[e] = __uint_as_float(big);
  out[half + e] = __uint_as_float(small);
}

int fw_row(int WR) { return (WR + 3) / 4 * 4; }

// The split weights (2 nsets, npairs, WR, WRp) as a 4-D tensor map (b, a,
// window, set) in boxes of 32 b x `rows` a, float32 with the 128-byte
// swizzle; reads past WR fill zeros
bool g_map(CUtensorMap* map, const float* gsplit, int WR, int npairs, int nsets, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t WRp = fw_row(WR);
  const cuuint64_t dims[4] = {(cuuint64_t)WR, (cuuint64_t)WR, (cuuint64_t)npairs, 2 * (cuuint64_t)nsets};
  const cuuint64_t strides[3] = {WRp * 4, WR * WRp * 4, npairs * WR * WRp * 4};
  const cuuint32_t box[4] = {FW_KS, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(gsplit), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --- forward, 1-D windows: CUDA cores ------------------------------------------------------

constexpr int FT = 256;  // threads
constexpr int FP = 128;  // points per block
constexpr int FK = 32;   // rows of a per staged chunk
constexpr int FS = 32;   // weight sets per block (the grid tiles more)

// y_s[i] (+)= sum_k sum_a L_k[a, i] g_{s,k}[a] over 128 points and up to
// 32 sets, two threads a point; accumulate: add to y (the 2-D windows'
// kernel wrote it), else write it.  y is written once, no cross-block sum.
template <int KIND>
__global__ void __launch_bounds__(FT) wide_singles_forward_kernel(WideSrc src, int n, Rows singles, int nsingles,
                                                                  const float* __restrict__ G1, int nsets,
                                                                  int accumulate, float* __restrict__ y) {
  __shared__ __align__(16) float L[FK][FP + 4];
  __shared__ float gs[FK * FS];  // gs[aa FS + s]
  __shared__ float ys[FS][FP];
  const int WR = src.WR;
  const int t = threadIdx.x, ii = t % FP, half = t / FP;
  const int i0 = blockIdx.x * FP, s0 = blockIdx.y * FS;
  const int ns = min(FS, nsets - s0);
  for (int idx = t; idx < FS * FP; idx += FT) (&ys[0][0])[idx] = 0.f;
  for (int k = 0; k < nsingles; ++k) {
    const int j = singles.v[k];
    float accs[FS / 2] = {};
    for (int a0 = 0; a0 < WR; a0 += FK) {
      __syncthreads();  // the previous chunk's readers of the tiles are done
      for (int idx = t; idx < FK * FP; idx += FT) {
        const int jj = idx % FP, aa = idx / FP, a = a0 + aa, i = i0 + jj;
        L[aa][jj] = (a < WR && i < n) ? phase<KIND>(src, j, a, i) : 0.f;
      }
      for (int idx = t; idx < FK * FS; idx += FT) {
        const int s = idx % FS, aa = idx / FS, a = a0 + aa;
        gs[idx] = (s < ns && a < WR) ? G1[((size_t)(s0 + s) * nsingles + k) * WR + a] : 0.f;
      }
      __syncthreads();
      for (int aa = 0; aa < FK; ++aa) {
        const float l = L[aa][ii];
#pragma unroll
        for (int q = 0; q < FS / 2; ++q) accs[q] = fmaf(l, gs[aa * FS + 2 * q + half], accs[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < FS / 2; ++q)
      if (2 * q + half < ns) ys[2 * q + half][ii] += accs[q];
  }
  __syncthreads();
  for (int idx = t; idx < FS * FP; idx += FT) {
    const int s = idx / FP, jj = idx % FP, i = i0 + jj;
    if (s < ns && i < n) {
      float* out = y + (size_t)(s0 + s) * n + i;
      *out = accumulate ? *out + ys[s][jj] : ys[s][jj];
    }
  }
}

template <int KIND>
cudaError_t wide_forward(const WideSrc& src, int n, const int* pairs, int npairs, const float* gsplit,
                         const int* singles, int nsingles, const float* G1, int nsets, float* y, cudaStream_t st) {
  const dim3 grid((n + FW_POINTS - 1) / FW_POINTS, (nsets + FW_SETS - 1) / FW_SETS);
  if (npairs > 0) {
    int Dtot = 0;
    for (int k = 0; k < 2 * npairs; ++k) Dtot = pairs[k] + 1 > Dtot ? pairs[k] + 1 : Dtot;
    const int nt = fw_tile(src.WR);
    CUtensorMap map0, map1, mapg;
    if (!tensor_map(&map0, KIND, src.p, src.stride, src.WR, n, Dtot, nt, true) ||
        !tensor_map(&map1, KIND, src.p, src.stride, src.WR, n, Dtot, FW_KS, true) ||
        !g_map(&mapg, gsplit, src.WR, npairs, nsets, nt))
      return cudaErrorInvalidValue;
    const auto kernel = fw_kernel<KIND>(nt);
    const int smem = fw_smem<KIND>(nt);
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, WG_THREADS, smem, st>>>(map0, map1, mapg, n, src.WR, make_rows(pairs, 2 * npairs), npairs, nsets,
                                           y);
  }
  if (nsingles > 0) {
    const cudaError_t e = cudaGetLastError();  // the 2-D windows' launch, before a second one
    if (e != cudaSuccess) return e;
    wide_singles_forward_kernel<KIND><<<grid, FT, 0, st>>>(src, n, make_rows(singles, nsingles), nsingles, G1, nsets,
                                                           npairs > 0, y);
  }
  return cudaSuccess;
}

bool bad_args(int kind, int WR, int n, int npairs, int nsingles) {
  return kind < W_F32 || kind > W_BF16 || WR < 2 || WR % 2 != 0 || n < 1 || !windows_fit(npairs, nsingles) ||
         npairs + nsingles == 0;
}

}  // namespace

extern "C" {

// Each returns the cudaGetLastError() code after its launches (0 = success).

// The phases of the regenerating sources: slab (Dtot, 2P, ld) float32, its
// first n points of each row written, from the float32 coordinates x (Dtot
// rows, xstride apart).  gen: 0 doubling, 1 direct.
int wide_phases_launch(int gen, const float* x, int xstride, int Dtot, int P, int n, int ld, float* slab,
                       void* stream) {
  if (gen < G_DOUBLING || gen > G_DIRECT || Dtot < 1 || Dtot > 65535 || P < 1 || P > (1 << ROT) || n < 1 || ld < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + 255) / 256, Dtot);
  if (gen == G_DOUBLING) {
    wide_phases_kernel<G_DOUBLING><<<grid, 256, 0, st>>>(x, xstride, P, n, ld, slab);
  } else {
    wide_phases_kernel<G_DIRECT><<<grid, 256, 0, st>>>(x, xstride, P, n, ld, slab);
  }
  return (int)cudaGetLastError();
}

// kind: 0 float32 table, 1 bf16 table; src: the table (Dtot, WR, .), its
// rows 16-byte aligned (stride: the row stride in elements).  With 2-D
// windows the chunk is a whole number of 32-point stages (ops/_cuda_build.py
// `wide_chunks`).
int wide_adjoint_launch(int kind, const void* src, int stride, const float* alpha, int WR, int n, int nv,
                        const int* pairs, int npairs, const int* singles, int nsingles, float* part, int nchunks,
                        int chunk, float* out, void* stream) {
  if (bad_args(kind, WR, n, npairs, nsingles) || nv < 1 || nchunks < 1 || nchunks > 65535 || chunk < 1 ||
      (npairs > 0 && (chunk % WG_KS != 0 || reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
                      (size_t)stride * (kind == W_F32 ? 4 : 2) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WideSrc s{src, stride, WR};
  const cudaError_t e =
      kind == W_F32
          ? wide_adjoint<W_F32>(s, alpha, n, nv, pairs, npairs, singles, nsingles, part, nchunks, chunk, out, st)
          : wide_adjoint<W_BF16>(s, alpha, n, nv, pairs, npairs, singles, nsingles, part, nchunks, chunk, out, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The weights of the forward's 2-D windows split into tf32 halves (see
// wide_split_weights_kernel): G2 (nsets, npairs, WR, WR) at element
// strides (gset, gpair, grow, 1), out (2, nsets, npairs, WR, WR rounded up
// to 4) contiguous.
int wide_split_weights_launch(const float* G2, long long gset, long long gpair, long long grow, int WR, int npairs,
                              int nsets, float* out, void* stream) {
  if (WR < 2 || npairs < 1 || nsets < 1 || gset < 0 || gpair < 0 || grow < WR) return (int)cudaErrorInvalidValue;
  const long long half = (long long)nsets * npairs * WR * fw_row(WR);
  wide_split_weights_kernel<<<(unsigned)((half + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      G2, gset, gpair, grow, WR, fw_row(WR), npairs, half, out);
  return (int)cudaGetLastError();
}

// gsplit: the weights of the 2-D windows as wide_split_weights_launch
// writes them, 16-byte aligned; G1: (nsets, nsingles, WR) contiguous.  A
// launch with 2-D windows refuses a table or split weights off 16-byte
// boundaries.
int wide_forward_launch(int kind, const void* src, int stride, int WR, int n, const int* pairs, int npairs,
                        const float* gsplit, const int* singles, int nsingles, const float* G1, int nsets, float* y,
                        void* stream) {
  const bool misaligned = reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
                          (size_t)stride * (kind == W_F32 ? 4 : 2) % 16 != 0 ||
                          reinterpret_cast<uintptr_t>(gsplit) % 16 != 0;
  if (bad_args(kind, WR, n, npairs, nsingles) || nsets < 1 || nsets > 65535 * FW_SETS || (npairs > 0 && misaligned))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WideSrc s{src, stride, WR};
  const cudaError_t e = kind == W_F32
                            ? wide_forward<W_F32>(s, n, pairs, npairs, gsplit, singles, nsingles, G1, nsets, y, st)
                            : wide_forward<W_BF16>(s, n, pairs, npairs, gsplit, singles, nsingles, G1, nsets, y, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
