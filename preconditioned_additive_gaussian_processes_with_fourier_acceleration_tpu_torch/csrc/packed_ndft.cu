// Packed NDFT kernels for float32 phase tables at 2P = 16 and 32 on Hopper
// (sm_90a), plain C interface.
//
// The "table_f32" mode of the JAX package's ops/pallas_ndft.py for a float32
// table tab[j][a][i] (Dtot, WR, stride >= n), WR = 2P rows per coordinate row
// j (cos(2 pi p x_j[i]) for a = p < P, sin for a = P + p), row stride
// `stride` (pack_phase_table pads it to a multiple of 64 points; the TMA
// copies need a multiple of 4); alpha (nv, n) and the weights are float32:
//   _adjoint_kernel (pallas_call at :326) -> f32_adjoint_kernel (2-D windows)
//                                            + adjoint_singles_kernel (1-D
//                                            windows, packed_ndft.cuh)
//                                            + reduce_slices_kernel (tc_common.cuh)
//   _forward_kernel (pallas_call at :508) -> f32_forward_kernel
// bf16 tables go to packed_ndft_tc.cu, other widths to packed_ndft_wide.cu;
// ops/packed_ndft.py `table_route` picks the kernel by width, table type and
// the number of right-hand sides or weight sets.
//
// What bounds them on an H100 SXM (published peaks at its 700 W limit): the
// solvers launch one right-hand side or one weight set at a time, and there
// the table's bytes bound both: one pair at 2P = 32, n = 1e5 reads 25.6 MB
// (7.6 us at 3.35 TB/s) for 2 (2P)^2 n = 0.2 GFLOP (3.1 us on the CUDA cores'
// 67 TFLOP/s).  So both kernels stream the table once at the memory's rate
// and keep every thread of a block doing FMAs.
//
// Design, both kernels:
// - One block an SM (shared memory), about as many blocks as SMs: a block
//   walks a contiguous chunk of points (whole stages of TP = 4096 / WR
//   points: 128 at 2P = 32, 256 at 16) with one producer warp and eight
//   consumer warps.
// - The producer keeps a ring of stages full with TMA copies (tma_common.cuh:
//   a 3-D tensor map over points, mode rows and coordinate rows, boxes of 32
//   points x WR rows with the 128-byte swizzle, so that 16-byte loads of
//   eight rows at one point chunk hit distinct banks); a stage holds the WR
//   L0 rows and the WR L1 rows of its points, 32 KB, and the points past n
//   arrive as zeros.  Full and empty mbarriers.
// - Shared memory, not the FMAs, bounds the consumers: a warp's 16-byte load
//   moves 512 bytes into registers, four of the SM's cycles at 128 bytes a
//   cycle, the time of 16 FMA instructions on its four schedulers, broadcast
//   or not.  So each lane keeps a register tile of TA rows x TB columns of
//   a WR x WR matrix (`LaneTile`: 8 x 8 or 4 x 8 at 2P = 32, 4 x 4 or 2 x 4
//   at 16) and takes four points a step: TA + TB 16-byte loads of the stage
//   feed 4 TA TB FMAs.  Where the tile leaves half a warp to cover the
//   matrix, the two halves take different points.
//
// Adjoint (f32_adjoint_kernel), A_w,r = sum_i alpha_r[i] L0[:, i] L1[:, i]^T:
// a block is (chunk, window, group of RB right-hand sides); every lane
// group keeps the whole RB x WR x WR output in registers, so no thread
// idles at nv = 1.  alpha comes with the stage by 4-byte cp.async copies
// (any n, zeros past n), arriving on the stage's full barrier.  The four
// stages of the ring hold 128 KB in flight a block.  At the end the lane
// groups' and the warps' sums are added in a fixed order (shuffles, then
// shared memory over the ring), one partial slice a block;
// reduce_slices_kernel adds the chunks' slices in a fixed order, launched
// as a programmatic dependent so that its launch overlaps the kernel: no
// atomics, a second launch is bitwise equal.  The wrapper sends many right-hand sides to the
// wide pair, whose tensor cores are faster once the FMAs, not the bytes,
// bound the work.
//
// Forward (f32_forward_kernel), y_s[i] = sum_w L0[:, i]^T G_s,w L1[:, i] +
// sum_k Ls_k[:, i]^T g_s,k: a block is a chunk of at most FwdCfg::CHUNK
// points and up to FwdCfg::SETS weight sets (16 at 2P = 16, one at 32; more
// sets run in passes), windows in order (pairs, then singles), the stages
// of one window's tiles between them.  The producer also copies each
// window's weights for every set of the pass into one of two padded shared
// buffers (16-byte cp.async, a window ahead).  With one set a lane holds
// its tile of G in registers (loaded once a window) and adds sum_a L0[a, i]
// sum_b G[a, b] L1[b, i] over its rows and columns for four points; a fixed
// shuffle tree adds the lane group's sums, and the lane that owns a point
// adds it to the block's y in shared memory, the same lane for every
// window, so the windows add in order.  At 2P = 16 with several sets a
// thread takes a point instead (FwdCfg::POINT_A_THREAD).  The table is read
// once a pass whatever the number of windows; y is written once.  The
// wrapper sends several sets at 2P = 32 to the wide pair.

#include <cuda.h>

#include "packed_ndft.cuh"
#include "tc_common.cuh"
#include "tma_common.cuh"

// F32_STREAM_ONLY = 1 builds a yardstick (scripts/torch_table_kernels_ab.py
// --kernels f32): the consumers wait for every stage and free it without
// reading it, so a launch takes the time of the kernels' data path alone
// (the TMA ring, alpha, the weights, the sums and their writes); its
// outputs are not the function's.
#ifndef F32_STREAM_ONLY
#define F32_STREAM_ONLY 0
#endif

namespace {

// the 1-D windows' phase source for adjoint_singles_kernel
template <int WR>
struct TableSrc {
  const float* tab;
  int n;       // points (alpha's row length)
  int stride;  // elements between two table rows (>= n)

  template <int LD>
  __device__ __forceinline__ void stage_single(float (*sL)[LD], int j, int i0, int i_end, int t) const {
    const float* Ls = tab + (size_t)j * WR * stride;
    for (int idx = t; idx < WR * TP; idx += NT) {
      const int a = idx / TP, ii = idx % TP, i = i0 + ii;
      sL[ii][a] = i < i_end ? __ldg(Ls + (size_t)a * stride + i) : 0.f;
    }
  }
};

constexpr int F_NW = 8;                 // consumer warps
constexpr int F_CONS = 32 * F_NW;       // consumer threads
constexpr int F_THREADS = F_CONS + 32;  // and the producer warp
constexpr int F_OPERAND = 16384;        // bytes of one operand's stage: WR rows x TP points

template <int WR>
struct F32Tile {
  static_assert(WR == 16 || WR == 32, "the float32-table kernels are built for 2P = 16 and 32");
  static constexpr int TP = F_OPERAND / (4 * WR);  // points a stage
  static constexpr int NBOX = TP / TMA_POINTS;     // boxes of the tensor map an operand
  static constexpr int BOX = TMA_POINTS * WR * 4;  // bytes of a box: WR rows of 128 bytes
};

// The register tile of a lane over one WR x WR output (adjoint: A for RB
// right-hand sides; forward: the weights G): TA rows a = ag + (WR / TA) p and
// TB columns b = bg + (WR / TB) q, lane ag (WR / TB) + bg of a group of LPC
// lanes; the H = 32 / LPC groups of a warp (halves) take different points.
// A shared-memory load of 16 bytes costs a warp four cycles of the SM's
// 128 bytes a cycle, the time of 16 FMA instructions on its four
// schedulers, so the tiles give each loaded value as many FMAs as the
// registers allow: a stage's four points of TA + TB rows (and RB alpha
// values) feed 4 RB TA TB FMAs.
template <int WR, int RB>
struct LaneTile {
  static constexpr int TA = WR == 32 ? (RB == 1 ? 8 : 4) : (RB <= 2 ? 4 : 2);
  static constexpr int TB = WR == 32 ? 8 : 4;
  static constexpr int SA = WR / TA, SB = WR / TB;  // row and column steps
  static constexpr int LPC = SA * SB;               // lanes that cover the output
  static constexpr int H = 32 / LPC;                // lane groups of a warp
  static_assert(LPC == 16 || LPC == 32, "a lane group is a half warp or a warp");
};

// a 16-byte load of row r (< WR) at point chunk cc (< 8) of a box: chunk
// cc of the row sits at chunk cc ^ (r % 8) (the 128-byte swizzle)
__device__ __forceinline__ float4 box_row(const unsigned char* box, int r, int cc) {
  return *reinterpret_cast<const float4*>(box + r * 128 + ((cc ^ (r & 7)) << 4));
}

// a barrier of the F_CONS consumer threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(F_CONS) : "memory"); }

// arrives on the barrier once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// the point group (box j, 4-point chunk cc) of a stage that lane group hg of
// the consumers takes at step m: group hg + (F_NW H) m, chunk (hg mod 8) of
// every box, so the groups of one warp read distinct chunks
template <int H>
__device__ __forceinline__ void point_group(int hg, int m, int& j, int& cc) {
  const int g = hg + F_NW * H * m;
  j = g / 8;
  cc = g % 8;
}

// --- adjoint, 2-D windows ------------------------------------------------------------------------

constexpr int AJ_STAGES = 4;

template <int WR, int RB>
struct AdjSmem {
  static constexpr int AL = RB * F32Tile<WR>::TP * 4;                      // alpha of a stage
  static constexpr int STAGE = 2 * F_OPERAND + (AL + 1023) / 1024 * 1024;  // 1024-byte aligned (the swizzle)
  static constexpr int RING = AJ_STAGES * STAGE;
  static constexpr int E = RB * LaneTile<WR, RB>::TA * LaneTile<WR, RB>::TB;  // outputs a lane
  static constexpr int RED = F_NW * E * 33 * 4;  // the warps' sums, lane-major (33: no bank conflict)
  static constexpr int OFF_BAR = RING > RED ? RING : RED;
  static constexpr int BYTES = OFF_BAR + 16 * AJ_STAGES + 1024;  // two barriers a stage; + the base's alignment
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

// One chunk's partial A of one window for right-hand sides r0 .. r0 + RB - 1,
// at part + c S + (r npairs + w) WR^2 + a WR + b.
template <int WR, int RB>
__global__ void __launch_bounds__(F_THREADS, 1)
    f32_adjoint_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ alpha, int n, int nv,
                       Rows pairs, int npairs, int chunk, float* __restrict__ part, size_t S) {
  using T = F32Tile<WR>;
  using M = AdjSmem<WR, RB>;
  using L = LaneTile<WR, RB>;
  constexpr int TP = T::TP, NBOX = T::NBOX, TA = L::TA, TB = L::TB;
  extern __shared__ __align__(16) unsigned char f_smem[];
  unsigned char* base = f_smem + ((1024 - (smem_addr(f_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(base);
  const uint32_t full = sbase + M::OFF_BAR, empty = full + 8 * AJ_STAGES;
  const int t = threadIdx.x, c = blockIdx.x, w = blockIdx.y, r0 = blockIdx.z * RB;
  const int i_begin = c * chunk, i_end = min(n, i_begin + chunk);
  const int nstage = (i_end - i_begin + TP - 1) / TP;

  if (t == 0) {
    for (int s = 0; s < AJ_STAGES; ++s) {
      mbar_init(full + 8 * s, 33);     // the loader lane with the bytes, then all 32 lanes' alpha copies
      mbar_init(empty + 8 * s, F_NW);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the sum of the chunks' slices may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (t >= F_CONS) {  // the producer warp
    const int lane = t - F_CONS;
    const int ja = pairs.v[2 * w], jb = pairs.v[2 * w + 1];
    for (int k = 0; k < nstage; ++k) {
      const int s = k % AJ_STAGES, u = k / AJ_STAGES, i0 = i_begin + k * TP;
      if (u > 0) mbar_wait(empty + 8 * s, (u - 1) & 1);  // stage k - AJ_STAGES is done with the buffers
      if (lane == 0) mbar_arrive_tx(full + 8 * s, 2 * F_OPERAND);
      __syncwarp();
      if (lane < 2 * NBOX) {
        const int j = lane % NBOX, op = lane / NBOX;
        tma_load(sbase + s * M::STAGE + op * F_OPERAND + j * T::BOX, &map, full + 8 * s, i0 + TMA_POINTS * j, 0,
                 op ? jb : ja);
      }
      // alpha of the stage's points (chunks are whole stages: only the last
      // stage of the last chunk passes n), zeros past n and past nv
      float* al = reinterpret_cast<float*>(base + s * M::STAGE + 2 * F_OPERAND);
      for (int e = lane; e < RB * TP; e += 32) {
        const int rr = e / TP, i = i0 + e % TP, r = r0 + rr;
        const bool ok = i < n && r < nv;
        cp_async4(al + e, ok ? alpha + (size_t)r * n + i : alpha, ok ? 4 : 0);
      }
      cp_async_arrive(full + 8 * s);
    }
    return;
  }

  // the consumers: lane (ag, bg) of lane group hg keeps rows ag + SA p and
  // columns bg + SB q of every right-hand side's output
  const int lane = t % 32, lg = lane % L::LPC, hg = t / L::LPC, ag = lg / L::SB, bg = lg % L::SB;
  float acc[RB][TA][TB];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr)
#pragma unroll
    for (int p = 0; p < TA; ++p)
#pragma unroll
      for (int q = 0; q < TB; ++q) acc[rr][p][q] = 0.f;
  for (int k = 0; k < nstage; ++k) {
    const int s = k % AJ_STAGES;
    mbar_wait(full + 8 * s, (k / AJ_STAGES) & 1);
    const unsigned char* stage = base + s * M::STAGE;
    const float* al = reinterpret_cast<const float*>(stage + 2 * F_OPERAND);
#pragma unroll 1
    for (int m = 0; m < (F32_STREAM_ONLY ? 0 : TP / 4 / (F_NW * L::H)); ++m) {
      int j, cc;
      point_group<L::H>(hg, m, j, cc);
      const unsigned char* b0 = stage + j * T::BOX;
      const unsigned char* b1 = b0 + F_OPERAND;
      float4 l0[TA], l1[TB], av[RB];
#pragma unroll
      for (int p = 0; p < TA; ++p) l0[p] = box_row(b0, ag + L::SA * p, cc);
#pragma unroll
      for (int q = 0; q < TB; ++q) l1[q] = box_row(b1, bg + L::SB * q, cc);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) av[rr] = *reinterpret_cast<const float4*>(al + rr * TP + TMA_POINTS * j + 4 * cc);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
#pragma unroll
        for (int p = 0; p < TA; ++p) {
          const float x0 = av[rr].x * l0[p].x, x1 = av[rr].y * l0[p].y, x2 = av[rr].z * l0[p].z,
                      x3 = av[rr].w * l0[p].w;
#pragma unroll
          for (int q = 0; q < TB; ++q) {
            float v = acc[rr][p][q];
            v = fmaf(x0, l1[q].x, v);
            v = fmaf(x1, l1[q].y, v);
            v = fmaf(x2, l1[q].z, v);
            acc[rr][p][q] = fmaf(x3, l1[q].w, v);
          }
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // the lane groups of a warp added (xor 16: the same sum in both), then the
  // warps' sums in warp order, over the ring (every stage has landed and
  // been read): lane-major rows of 33 floats, output e of lane lg of warp wq
  // at (wq E + e) 33 + lg
  if constexpr (L::H == 2) {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int p = 0; p < TA; ++p)
#pragma unroll
        for (int q = 0; q < TB; ++q) acc[rr][p][q] += __shfl_xor_sync(0xffffffffu, acc[rr][p][q], 16);
  }
  consumers_sync();
  float* red = reinterpret_cast<float*>(base);
  constexpr int E = M::E, O = RB * WR * WR;
  const int wq = t / 32;
  if (lane < L::LPC) {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int p = 0; p < TA; ++p)
#pragma unroll
        for (int q = 0; q < TB; ++q) red[(wq * E + (rr * TA + p) * TB + q) * 33 + lg] = acc[rr][p][q];
  }
  consumers_sync();
  for (int o = t; o < O; o += F_CONS) {
    const int rr = o / (WR * WR), a = o / WR % WR, b = o % WR;
    const int e = (rr * TA + a / L::SA) * TB + b / L::SB, l = (a % L::SA) * L::SB + b % L::SB;
    float v = red[e * 33 + l];
#pragma unroll
    for (int q = 1; q < F_NW; ++q) v += red[(q * E + e) * 33 + l];
    const int r = r0 + rr;
    if (r < nv) part[(size_t)c * S + ((size_t)r * npairs + w) * WR * WR + o % (WR * WR)] = v;
  }
}

// the instances: RB right-hand sides a block (ops/_cuda_build.py f32_rhs_per_block)
template <int WR, int RB>
cudaError_t adjoint_pairs(const CUtensorMap& map, const float* alpha, int n, int nv, const int* pairs, int npairs,
                          int nchunks, int chunk, float* part, size_t S, cudaStream_t st) {
  const auto kernel = f32_adjoint_kernel<WR, RB>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AdjSmem<WR, RB>::BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid(nchunks, npairs, (nv + RB - 1) / RB);
  kernel<<<grid, F_THREADS, AdjSmem<WR, RB>::BYTES, st>>>(map, alpha, n, nv, make_rows(pairs, 2 * npairs), npairs,
                                                           chunk, part, S);
  return cudaSuccess;
}

// the chunks' slices added into out (reduce_slices_kernel), launched as a
// programmatic dependent of the 2-D windows' kernel when that wrote last:
// its blocks start while that grid runs and wait for it (griddepcontrol)
cudaError_t reduce_after(const float* part, int nchunks, size_t S, float* out, bool dependent, cudaStream_t st) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)((S + RED_X - 1) / RED_X));
  cfg.blockDim = dim3(RED_X, RED_Y);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, reduce_slices_kernel<true>, part, nchunks, S, out);
}

// --- forward ---------------------------------------------------------------------------------------

constexpr int FW_STAGES = 3;

// The weight sets of a pass and the most points of a block (the wrapper
// reads them: forward_max_sets, forward_max_chunk), and the mapping: one
// set on the lane tiles, the weights loaded once a window; several sets at
// 2P = 16 a thread a point (POINT_A_THREAD: its 32 table values stay in
// registers over the sets, each weight a 16-byte broadcast feeding four
// FMAs, no sum across lanes), 16 sets a pass.  At 2P = 32 a pass takes one
// set: the route gives several to the wide pair, whose tensor cores are
// faster there (ops/packed_ndft.py F32_MAX_NSETS).
template <int WR>
struct FwdCfg {
  static constexpr bool POINT_A_THREAD = WR == 16;
  static constexpr int SETS = WR == 16 ? 16 : 1;
  static constexpr int CHUNK = WR == 16 ? 1024 : 2048;
};

template <int WR>
struct FwdSmem {
  static constexpr int SETS = FwdCfg<WR>::SETS, CHUNK = FwdCfg<WR>::CHUNK;
  static constexpr int GP = WR + 4;                  // a weight row in shared memory, floats (padded)
  static constexpr int GSLOT = SETS * WR * GP * 4;   // one window's weights, every set
  static constexpr int STAGE = 2 * F_OPERAND;
  static constexpr int OFF_G = FW_STAGES * STAGE;
  static constexpr int OFF_Y = OFF_G + 2 * GSLOT;
  static constexpr int OFF_BAR = OFF_Y + SETS * CHUNK * 4;
  static constexpr int BYTES = OFF_BAR + 8 * (2 * FW_STAGES + 4) + 1024;
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

// sum over the LPC lanes of a lane group (a warp or a half warp) of p[0..3],
// by a fixed tree: the lanes whose bits LPC/2 and LPC/4 are (h, l) end with
// the sum of p[2 h + l]; returns it, and that point in pt
template <int LPC>
__device__ __forceinline__ float sum_lanes4(const float (&p)[4], int lane, int& pt) {
  constexpr unsigned FULL = 0xffffffffu;
  const bool h = lane & (LPC / 2), l = lane & (LPC / 4);
  float k0 = h ? p[2] : p[0], k1 = h ? p[3] : p[1];
  k0 += __shfl_xor_sync(FULL, h ? p[0] : p[2], LPC / 2);
  k1 += __shfl_xor_sync(FULL, h ? p[1] : p[3], LPC / 2);
  float v = (l ? k1 : k0) + __shfl_xor_sync(FULL, l ? k0 : k1, LPC / 4);
#pragma unroll
  for (int m = LPC / 8; m >= 1; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  pt = 2 * h + l;
  return v;
}

// A lane's table values of one point group (four points, chunk cc of a
// box): rows ag + SA p of L0 and bg + SB q of L1, or, for a 1-D window,
// rows lg + LPC r of Ls (in l0)
template <int WR, typename L>
__device__ __forceinline__ void load_group(const unsigned char* box0, const unsigned char* box1, int cc, bool pair,
                                           int ag, int bg, int lg, float4 (&l0)[L::TA], float4 (&l1)[L::TB]) {
  if (pair) {
#pragma unroll
    for (int p = 0; p < L::TA; ++p) l0[p] = box_row(box0, ag + L::SA * p, cc);
#pragma unroll
    for (int q = 0; q < L::TB; ++q) l1[q] = box_row(box1, bg + L::SB * q, cc);
  } else {
#pragma unroll
    for (int r = 0; r < WR / L::LPC; ++r) l0[r] = box_row(box0, lg + L::LPC * r, cc);
  }
}

// a lane's tile of the weights of one set (padded rows of WR + 4 floats)
template <int WR, typename L>
__device__ __forceinline__ void load_weights(const float* g, int ag, int bg, float (&gb)[L::TA][L::TB]) {
#pragma unroll
  for (int p = 0; p < L::TA; ++p)
#pragma unroll
    for (int q = 0; q < L::TB; ++q) gb[p][q] = g[(ag + L::SA * p) * (WR + 4) + bg + L::SB * q];
}

// a lane's share of y at the four points of a group for one set: sum over
// its rows a of L0[a] sum over its columns b of G[a][b] L1[b], or, for a
// 1-D window, sum over its rows of Ls[a] g[a]
template <int WR, typename L>
__device__ __forceinline__ void group_sums(bool pair, const float* g, int lg, const float4 (&l0)[L::TA],
                                           const float4 (&l1)[L::TB], const float (&gb)[L::TA][L::TB],
                                           float (&acc)[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  if (pair) {
#pragma unroll
    for (int p = 0; p < L::TA; ++p) {
      float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
#pragma unroll
      for (int q = 0; q < L::TB; ++q) {
        z0 = fmaf(gb[p][q], l1[q].x, z0);
        z1 = fmaf(gb[p][q], l1[q].y, z1);
        z2 = fmaf(gb[p][q], l1[q].z, z2);
        z3 = fmaf(gb[p][q], l1[q].w, z3);
      }
      acc[0] = fmaf(l0[p].x, z0, acc[0]);
      acc[1] = fmaf(l0[p].y, z1, acc[1]);
      acc[2] = fmaf(l0[p].z, z2, acc[2]);
      acc[3] = fmaf(l0[p].w, z3, acc[3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < WR / L::LPC; ++r) {
      const float gs = g[lg + L::LPC * r];
      acc[0] = fmaf(l0[r].x, gs, acc[0]);
      acc[1] = fmaf(l0[r].y, gs, acc[1]);
      acc[2] = fmaf(l0[r].z, gs, acc[2]);
      acc[3] = fmaf(l0[r].w, gs, acc[3]);
    }
  }
}

// the lane group's shares added (sum_lanes4), then by the owner of each of
// the four points to y at y4[0..3]
template <int LPC>
__device__ __forceinline__ void add_owned(const float (&acc)[4], int lane, bool owner, float* y4) {
  int pt;
  const float v = sum_lanes4<LPC>(acc, lane, pt);
  if (owner) y4[pt] += v;
}

// y_s[i] for the points of one chunk and nsets <= FwdCfg::SETS weight sets
template <int WR>
__global__ void __launch_bounds__(F_THREADS, 1)
    f32_forward_kernel(const __grid_constant__ CUtensorMap map, int n, Rows pairs, int npairs,
                       const float* __restrict__ G2, Rows singles, int nsingles, const float* __restrict__ G1,
                       int nsets, int chunk, float* __restrict__ y) {
  using T = F32Tile<WR>;
  using M = FwdSmem<WR>;
  using L = LaneTile<WR, 1>;
  constexpr int TP = T::TP, NBOX = T::NBOX, GP = M::GP, TA = L::TA, TB = L::TB, LPC = L::LPC;
  extern __shared__ __align__(16) unsigned char f_smem[];
  unsigned char* base = f_smem + ((1024 - (smem_addr(f_smem) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(base);
  const uint32_t full = sbase + M::OFF_BAR, empty = full + 8 * FW_STAGES;
  const uint32_t gfull = empty + 8 * FW_STAGES, gempty = gfull + 16;
  const int t = threadIdx.x, c = blockIdx.x;
  const int i_begin = c * chunk, len = min(n, i_begin + chunk) - i_begin;
  const int ntile = (len + TP - 1) / TP, nwin = npairs + nsingles;

  if (t == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);      // the loader lane with the bytes
      mbar_init(empty + 8 * s, F_NW);  // the consumer warps
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(gfull + 8 * s, 32);  // the producer's 32 lanes' weight copies
      mbar_init(gempty + 8 * s, F_NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t >= F_CONS) {  // the producer warp
    const int lane = t - F_CONS;
    int k = 0;  // stages issued
    for (int w = 0; w < nwin; ++w) {
      const int slot = w & 1;
      const bool pair = w < npairs;
      if (w >= 2) mbar_wait(gempty + 8 * slot, ((w >> 1) - 1) & 1);  // window w - 2 is done with the slot
      unsigned char* g = base + M::OFF_G + slot * M::GSLOT;
      constexpr int Q = WR / 4;  // 16-byte pieces a weight row
      if (pair) {
        for (int e = lane; e < nsets * WR * Q; e += 32) {
          const int s = e / (WR * Q), a = (e / Q) % WR, q = e % Q;
          cp_async16(g + ((s * WR + a) * GP + 4 * q) * 4, G2 + (((size_t)s * npairs + w) * WR + a) * WR + 4 * q, 16);
        }
      } else {
        for (int e = lane; e < nsets * Q; e += 32) {
          const int s = e / Q, q = e % Q;
          cp_async16(g + (s * WR * GP + 4 * q) * 4, G1 + ((size_t)s * nsingles + (w - npairs)) * WR + 4 * q, 16);
        }
      }
      cp_async_arrive(gfull + 8 * slot);
      const int ja = pair ? pairs.v[2 * w] : singles.v[w - npairs], jb = pair ? pairs.v[2 * w + 1] : 0;
      const int nops = pair ? 2 : 1;
      for (int tt = 0; tt < ntile; ++tt, ++k) {
        const int s = k % FW_STAGES, u = k / FW_STAGES;
        if (u > 0) mbar_wait(empty + 8 * s, (u - 1) & 1);
        if (lane == 0) mbar_arrive_tx(full + 8 * s, nops * F_OPERAND);
        __syncwarp();
        if (lane < nops * NBOX) {
          const int j = lane % NBOX, op = lane / NBOX;
          tma_load(sbase + s * M::STAGE + op * F_OPERAND + j * T::BOX, &map, full + 8 * s,
                   i_begin + tt * TP + TMA_POINTS * j, 0, op ? jb : ja);
        }
      }
    }
    return;
  }

  // the consumers: lane (ag, bg) of lane group hg holds the weights G[a][b]
  // of rows a = ag + SA p, columns b = bg + SB q, and adds for four points
  // sum_p L0[a] sum_q G[a][b] L1[b]; the lane group's sums per point are
  // then added by sum_lanes4, and the owner lane of a point adds it to y
  const int lane = t % 32, lg = lane % LPC, hg = t / LPC, ag = lg / L::SB, bg = lg % L::SB;
  const bool owner = (lg & (LPC / 4 - 1)) == 0;
  constexpr int STEPS = TP / 4 / (F_NW * L::H);  // point groups of a stage a lane group takes
  float* sY = reinterpret_cast<float*>(base + M::OFF_Y);
  constexpr int CHUNK = M::CHUNK;
  for (int e = t; e < nsets * CHUNK; e += F_CONS) sY[e] = 0.f;
  consumers_sync();
  const bool per_point = FwdCfg<WR>::POINT_A_THREAD && nsets > 1;
  int k = 0;
  for (int w = 0; w < nwin; ++w) {
    const int slot = w & 1;
    const bool pair = w < npairs;
    mbar_wait(gfull + 8 * slot, (w >> 1) & 1);
    const float* g = reinterpret_cast<const float*>(base + M::OFF_G + slot * M::GSLOT);
    float gb[TA][TB];  // the lane tiles' weights (one set)
    if (pair && !per_point) load_weights<WR, L>(g, ag, bg, gb);
    for (int tt = 0; tt < ntile; ++tt, ++k) {
      const int s = k % FW_STAGES;
      mbar_wait(full + 8 * s, (k / FW_STAGES) & 1);
      const unsigned char* b0 = base + s * M::STAGE;
      const unsigned char* b1 = b0 + F_OPERAND;
      float* ys = sY + tt * TP;
      if (F32_STREAM_ONLY) {
      } else if (per_point) {
        // several sets at 2P = 16: a consumer thread takes one point of the
        // stage (TP = F_CONS), its 2 x 16 table values in registers over the
        // sets, the weights' rows as 16-byte broadcasts; its y is its own
        static_assert(TP == F_CONS || !FwdCfg<WR>::POINT_A_THREAD, "a thread a point of the stage");
        const int j = t / TMA_POINTS, e = t % TMA_POINTS;  // box, point in the box
        float l0[WR], l1[WR];
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const int off = j * T::BOX + r * 128 + ((((e >> 2) ^ (r & 7)) << 4) | ((e & 3) << 2));
          l0[r] = *reinterpret_cast<const float*>(b0 + off);
          l1[r] = pair ? *reinterpret_cast<const float*>(b1 + off) : 0.f;
        }
#pragma unroll 1
        for (int set = 0; set < nsets; ++set) {
          float tot = 0.f;
          if (pair) {
#pragma unroll
            for (int a = 0; a < WR; ++a) {
              float z = 0.f;
#pragma unroll
              for (int q = 0; q < WR / 4; ++q) {
                const float4 gv = *reinterpret_cast<const float4*>(g + (set * WR + a) * GP + 4 * q);
                z = fmaf(gv.x, l1[4 * q], z);
                z = fmaf(gv.y, l1[4 * q + 1], z);
                z = fmaf(gv.z, l1[4 * q + 2], z);
                z = fmaf(gv.w, l1[4 * q + 3], z);
              }
              tot = fmaf(l0[a], z, tot);
            }
          } else {
#pragma unroll
            for (int q = 0; q < WR / 4; ++q) {
              const float4 gv = *reinterpret_cast<const float4*>(g + set * WR * GP + 4 * q);
              tot = fmaf(gv.x, l0[4 * q], tot);
              tot = fmaf(gv.y, l0[4 * q + 1], tot);
              tot = fmaf(gv.z, l0[4 * q + 2], tot);
              tot = fmaf(gv.w, l0[4 * q + 3], tot);
            }
          }
          ys[set * CHUNK + t] += tot;
        }
      } else {
        // one set on the lane tiles, the weights in registers over the window
#pragma unroll 1
        for (int m = 0; m < STEPS; ++m) {
          int j, cc;
          point_group<L::H>(hg, m, j, cc);
          float4 l0[TA], l1[TB];
          float acc[4];
          load_group<WR, L>(b0 + j * T::BOX, b1 + j * T::BOX, cc, pair, ag, bg, lg, l0, l1);
          group_sums<WR, L>(pair, g, lg, l0, l1, gb, acc);
          add_owned<LPC>(acc, lane, owner, ys + TMA_POINTS * j + 4 * cc);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(gempty + 8 * slot);
  }
  consumers_sync();
  for (int set = 0; set < nsets; ++set)
    for (int p = t; p < len; p += F_CONS) y[(size_t)set * n + i_begin + p] = sY[set * CHUNK + p];
}

// the table's tensor map over the coordinate rows the windows use; false if
// the table is not what the TMA copies read (16-byte aligned, a row stride
// of whole 16 bytes)
bool table_map(CUtensorMap* map, const void* tab, int stride, int WR, int n, const int* pairs, int npairs,
               const int* singles, int nsingles) {
  if (reinterpret_cast<uintptr_t>(tab) % 16 != 0 || stride % 4 != 0 || stride < n) return false;
  int Dtot = 0;
  for (int k = 0; k < 2 * npairs; ++k) Dtot = pairs[k] + 1 > Dtot ? pairs[k] + 1 : Dtot;
  for (int k = 0; k < nsingles; ++k) Dtot = singles[k] + 1 > Dtot ? singles[k] + 1 : Dtot;
  return tensor_map(map, 0, tab, stride, WR, n, Dtot, WR, false);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The adjoint: the 2-D windows on f32_adjoint_kernel with rb right-hand sides
// a block, the 1-D windows on adjoint_singles_kernel, both into the partial
// slices part (nchunks, S) of chunks of `chunk` points (whole stages), then
// reduce_slices_kernel into out (S = nv npairs WR^2 + nv nsingles WR).
// Returns the cudaGetLastError() code after the launches (0 = success), or
// cudaErrorInvalidValue for what the kernels do not take.
int adjoint_launch(const void* tab, int stride, const float* alpha, int WR, int n, int nv, const int* pairs,
                   int npairs, const int* singles, int nsingles, int rb, float* part, int nchunks, int chunk,
                   float* out, void* stream) {
  if (!windows_fit(npairs, nsingles) || (WR != 16 && WR != 32) || n < 1 || nv < 1 || nchunks < 1 ||
      chunk % (F_OPERAND / (4 * WR)) != 0 || (long long)nchunks * chunk < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t S2 = (size_t)nv * npairs * WR * WR;
  const size_t S = S2 + (size_t)nv * nsingles * WR;
  if (npairs > 0) {
    CUtensorMap map;
    if (!table_map(&map, tab, stride, WR, n, pairs, npairs, singles, nsingles)) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (WR == 16 && rb == 1) e = adjoint_pairs<16, 1>(map, alpha, n, nv, pairs, npairs, nchunks, chunk, part, S, st);
    else if (WR == 16 && rb == 2) e = adjoint_pairs<16, 2>(map, alpha, n, nv, pairs, npairs, nchunks, chunk, part, S, st);
    else if (WR == 16 && rb == 4) e = adjoint_pairs<16, 4>(map, alpha, n, nv, pairs, npairs, nchunks, chunk, part, S, st);
    else if (WR == 32 && rb == 1) e = adjoint_pairs<32, 1>(map, alpha, n, nv, pairs, npairs, nchunks, chunk, part, S, st);
    else if (WR == 32 && rb == 2) e = adjoint_pairs<32, 2>(map, alpha, n, nv, pairs, npairs, nchunks, chunk, part, S, st);
    else return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
  }
  if (nsingles > 0) {
    const Rows sg = make_rows(singles, nsingles);
    const float* t32 = static_cast<const float*>(tab);
    if (WR == 16) {
      dim3 grid(nchunks, nsingles, (nv + NT / 16 - 1) / (NT / 16));
      adjoint_singles_kernel<16, TableSrc<16>><<<grid, NT, 0, st>>>(TableSrc<16>{t32, n, stride}, alpha, n, nv, sg,
                                                                    nsingles, chunk, part, S, S2);
    } else {
      dim3 grid(nchunks, nsingles, (nv + NT / 32 - 1) / (NT / 32));
      adjoint_singles_kernel<32, TableSrc<32>><<<grid, NT, 0, st>>>(TableSrc<32>{t32, n, stride}, alpha, n, nv, sg,
                                                                    nsingles, chunk, part, S, S2);
    }
  }
  const cudaError_t e = reduce_after(part, nchunks, S, out, npairs > 0 && nsingles == 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The forward of one pass of nsets <= forward_max_sets(WR) weight sets: y
// (nsets, n) from G2 (nsets, npairs, WR, WR) and G1 (nsets, nsingles, WR),
// each 16-byte aligned, in blocks of `chunk` points (whole stages, at most
// forward_max_chunk(WR)).
int forward_launch(const void* tab, int stride, int WR, int n, const int* pairs, int npairs, const float* G2,
                   const int* singles, int nsingles, const float* G1, int nsets, int chunk, float* y, void* stream) {
  if (!windows_fit(npairs, nsingles) || npairs + nsingles < 1 || (WR != 16 && WR != 32) || n < 1 || nsets < 1 ||
      nsets > (WR == 16 ? FwdCfg<16>::SETS : FwdCfg<32>::SETS) || chunk < 1 ||
      chunk > (WR == 16 ? FwdCfg<16>::CHUNK : FwdCfg<32>::CHUNK) ||
      chunk % (F_OPERAND / (4 * WR)) != 0 ||
      (npairs > 0 && !aligned16(G2)) || (nsingles > 0 && !aligned16(G1)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!table_map(&map, tab, stride, WR, n, pairs, npairs, singles, nsingles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = WR == 16 ? f32_forward_kernel<16> : f32_forward_kernel<32>;
  const int bytes = WR == 16 ? FwdSmem<16>::BYTES : FwdSmem<32>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(n + chunk - 1) / chunk, F_THREADS, bytes, st>>>(map, n, make_rows(pairs, 2 * npairs), npairs, G2,
                                                            make_rows(singles, nsingles), nsingles, G1, nsets,
                                                            chunk, y);
  return (int)cudaGetLastError();
}

// the most weight sets of one forward pass, and points of one forward block
int forward_max_sets(int WR) { return WR == 16 ? FwdCfg<16>::SETS : FwdCfg<32>::SETS; }
int forward_max_chunk(int WR) { return WR == 16 ? FwdCfg<16>::CHUNK : FwdCfg<32>::CHUNK; }

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
