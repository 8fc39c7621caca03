// Fused dense Krylov kernels for Hopper (sm_90a), plain C interface.
//
// Replace the two TPU kernels of the JAX package's solvers/pallas_pcg.py:
// - pcg_kernel      <- `_pcg_kernel`: a whole unpreconditioned CG solve of
//                      K x = b, K (n, n) f32 dense SPD, in one launch;
// - lanczos_kernel  <- `_lanczos_kernel`: the Lanczos recursions of nv probes
//                      with two-pass classical Gram-Schmidt against the whole
//                      history, one (nv, n) x (n, n) product per step.
//
// What bounds them on an H100 SXM (published peaks at 700 W): CG does
// 2 n^2 flops a step against K's 4 n^2 bytes, so a solve that reads K once
// is bound by its flops (87 steps at n = 2048: 10.9 us at 67 TFLOP/s).  But
// a step also needs sums over the whole vector, a grid-wide exchange of
// about a microsecond (`barrier_probe_launch` times it), and a step that
// re-reads K from L2 or HBM is bound by those bytes.  So:
//
// Both kernels run as ONE persistent cooperative launch of at most one
// block an SM; the grid and every block's share of K come from the plan of
// solvers/fused_pcg.py, which the entry points check.  A block copies its
// share of K into shared memory once a launch by TMA (bulk copies or 2-D
// tensor boxes on an mbarrier, tma_common.cuh), as much as fits; the rest
// streams every step through a ring of stages that one producer warp keeps
// full while the consumer warps compute.  The grid barrier is one 32-bit
// counter a launch: a block adds one (red.release) after its writes, and
// barrier e is passed when the counter reaches e G (acquire loads).  Blocks
// exchange partial sums through arrays written before the barrier and read
// (from L2, __ldcg) after it; data alternates between two buffers by step
// or barrier parity, so a block that runs ahead never overwrites what a
// slower one still reads.  Every block adds what all need in the same fixed
// order, so all hold bitwise the same scalars and take the same branches;
// no float atomics, and a second launch is bitwise equal.
//
// CG (pcg_kernel): ONE grid barrier a step.  Block b owns rows [r0, r1) and
// keeps full copies of r (registers, CPT float4 a consumer thread) and p
// (shared memory; in registers during the matvec).  A step: q = K p on the
// block's rows, 16 rows a reduction (a thread's column chunks of each row,
// a shuffle transpose-reduction, the warps' sums in warp order), its q
// written; after the barrier every block reads all of q and recomputes
// p'q, alpha, r, r'r, beta and p over all n in the same order, so flags
// cannot diverge; x is updated on the block's own rows (in registers).
// The recurrence is the reference's Hestenes-Stiefel CG with its rho == 0 /
// pq <= 0 guards and its stop test on the recursion residual.  Where every
// row is resident there is no producer warp (512 threads, 128 registers a
// thread) and, at n <= 2048, a thread's chunk of the first 16 rows stays in
// registers; else one-row ring stages, the next step's first ones copied
// while the block waits at the barrier (K does not change).
//
// Lanczos (lanczos_kernel): THREE grid barriers a step (the two CGS passes
// and the norm; none after forming v_{it+1}: the next product reads the
// unnormalized w that every block wrote before the norm barrier and
// divides its sums by ||w||).  Block b owns panels of C
// columns; w = v_it K is column-local.  The ring's stage holds a chunk of
// JT rows of v_it transposed ([j][nv rounded up to 4], one bulk copy) and,
// where the chunk is not resident, the panel's JT x C box of K (a 2-D
// tensor map).  A consumer thread holds an nv x 4 register tile: its four
// columns, rows jg, jg + NJG, ... of the chunk; v_it[j][:] is a broadcast
// 16-byte load, K[j][4 columns] one 16-byte load.  The block's own columns
// of w and of the V history stay in shared memory where the plan holds
// them, so the CGS passes and the norm touch L2 only for the blocks'
// partial sums (one thread a (probe, step) pair over the block's columns;
// the blocks' partials added by lz_totals).  The product stays on the CUDA
// cores.
//
// The `// @phase:` comments mark the boundaries of a step's phases; the
// timed copy that scripts/torch_table_kernels_ab.py --kernels dense builds
// uncomments them (block 0 then writes the globaltimer at each).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <stdint.h>

#include "tma_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_N = 16384;
constexpr int MAX_NV = 16;
constexpr int MAX_M1 = 65;         // Lanczos maxits + 1
constexpr int MAX_BLOCKS = 256;    // a plan's per-block arrays
constexpr int SMEM_SLACK = 1024;   // dynamic shared memory aligned to 1024 inside
constexpr int MAX_STAGES = 8;

// CG
constexpr int CG_CONS = 512;              // consumer threads
constexpr int CG_CW = CG_CONS / 32;       // consumer warps
constexpr int CG_THREADS = CG_CONS + 32;  // and the producer warp
constexpr int CG_RG = 16;                 // rows a reduction
constexpr int CG_FIXED = 4096;            // bytes ahead of p

// Lanczos
constexpr int LZ_CONS = 256;
constexpr int LZ_CW = LZ_CONS / 32;
constexpr int LZ_THREADS = LZ_CONS + 32;
constexpr int LZ_FIXED = 18432;  // bytes ahead of the ring
constexpr int LZ_MAX_C = 128;

constexpr unsigned FULL = 0xffffffffu;

struct CgPlan {
  int G, ld, stages, res_max;  // a ring stage holds one row
  int start[MAX_BLOCKS + 1];
  int res[MAX_BLOCKS];
};

struct LzPlan {
  int G, C, JT, stages, held_max;  // held_max: most panels x resident chunks of a block
  int kpart;                       // a stage holds a chunk of K too (some chunk streams)
  int own;                         // the block's own columns of w and of the V history in shared memory
  int ppb_max;                     // most panels a block
  int pstart[MAX_BLOCKS + 1];
  int res[MAX_BLOCKS];  // resident chunks of each of the block's panels
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a contiguous global range into shared memory, its bytes counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :
               : "r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// a 2-D box of a tensor map (c0 columns in, c1 rows down)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
               :
               : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
               : "memory");
}

// --- the grid barrier -----------------------------------------------------------
// One 32-bit arrival counter a launch, zero at its start: a block adds one
// (red.release) after its writes; barrier e (e = 1, 2, ...) is passed when
// the counter reaches e G.  The partial sums travel in arrays written
// before the arrival and read after the wait.

// One thread, after the block's writes are ordered before it (a barrier of
// the threads that wrote).
__device__ __forceinline__ void grid_arrive(unsigned* counter) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");  // the block's writes, for other blocks' TMA reads
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

// One warp (every lane polls; acquire loads): until barrier e is passed.
__device__ __forceinline__ void grid_wait(const unsigned* counter, unsigned e, int G) {
  const unsigned target = e * (unsigned)G;
  unsigned seen;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
  } while (seen < target);
}

// --- CG -----------------------------------------------------------------------

// Consumers' sum of v (every consumer gets the same value): warp sums, then
// the warps' in warp order from a 16-float buffer the caller alternates.
__device__ __forceinline__ float cg_sum(float v, float* buf) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  named_sync(1, CG_CONS);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CG_CW; ++k) s += buf[k];
  return s;
}

// The transpose-reduction of 16 per-thread row sums over the consumers
// (lane l ends with row 8 b4 + 4 b3 + 2 b2 + b1 of its bits), then the
// warps' sums in warp order by threads t < cnt, which return their row's q.
template <int H>
__device__ __forceinline__ void fold(float (&acc)[CG_RG], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float send = up ? acc[h] : acc[h + H], keep = up ? acc[h + H] : acc[h];
    acc[h] = keep + __shfl_xor_sync(FULL, send, 2 * H);
  }
}

__device__ __forceinline__ float cg_reduce(float (&acc)[CG_RG], int cnt, float* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  fold<8>(acc, lane);
  fold<4>(acc, lane);
  fold<2>(acc, lane);
  fold<1>(acc, lane);
  acc[0] += __shfl_xor_sync(FULL, acc[0], 1);
  if ((lane & 1) == 0)
    red[warp * CG_RG + ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1)] =
        acc[0];
  named_sync(1, CG_CONS);
  float q = 0.f;
  if (t < cnt)
#pragma unroll
    for (int w = 0; w < CG_CW; ++w) q += red[w * CG_RG + t];
  return q;
}

// a row of K (shared memory) against p (registers: the thread's chunks)
template <int CPT>
__device__ __forceinline__ float cg_dot(const float* Krow, int ld4, const float4 (&pv)[CPT]) {
  const float4* K4 = reinterpret_cast<const float4*>(Krow);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c4 = threadIdx.x + k * CG_CONS;
    if (c4 < ld4) {
      const float4 kv = K4[c4];
      s += kv.x * pv[k].x + kv.y * pv[k].y + kv.z * pv[k].z + kv.w * pv[k].w;
    }
  }
  return s;
}

// THREADS: CG_THREADS with the producer warp (a ring), CG_CONS without it
// (every row resident): 16 warps leave a thread 128 registers, 17 only 96
// (an SM sub-partition holds 5 of them)
template <int CPT, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
    pcg_kernel(const __grid_constant__ CgPlan plan, const float* __restrict__ K, const float* __restrict__ b, int n,
               int maxits, float tol2, float* __restrict__ x, float* qbuf, unsigned* counter, float* relres,
               int* niter_out) {
  extern __shared__ __align__(16) unsigned char cg_smem[];
  unsigned char* base = cg_smem + ((1024 - (smem_u32(cg_smem) & 1023)) & 1023);
  const uint32_t bars = smem_u32(base);  // full[8], empty[8], resident
  const uint32_t full = bars, empty = bars + 8 * MAX_STAGES, resbar = bars + 16 * MAX_STAGES;
  float* red = reinterpret_cast<float*>(base + 256);  // [2][CG_CW][CG_RG]
  float* sums = red + 2 * CG_CW * CG_RG;              // [4][16] cg_sum buffers
  volatile int* go = reinterpret_cast<volatile int*>(sums + 64);                  // [2] by step parity
  volatile long long* issued = reinterpret_cast<volatile long long*>(sums + 66);  // by the producer
  const int ld = plan.ld, ld4 = ld >> 2;
  float* ps = reinterpret_cast<float*>(base + CG_FIXED);
  float* kres = ps + ld;
  float* ring = kres + (size_t)plan.res_max * ld;
  float4* ps4 = reinterpret_cast<float4*>(ps);

  const int G = plan.G, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = plan.start[blockIdx.x], r1 = plan.start[blockIdx.x + 1];
  const int nres = plan.res[blockIdx.x], nstr = r1 - r0 - nres;
  const int S = plan.stages;

  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CG_CW);
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (THREADS == CG_CONS && t == 0 && nres > 0) {  // no producer warp: thread 0 copies the resident rows
    mbar_arrive_tx(resbar, (uint32_t)nres * ld * 4u);
    for (int i = 0; i < nres; ++i)
      bulk_load(smem_u32(kres + (size_t)i * ld), K + (size_t)(r0 + i) * ld, (uint32_t)ld * 4u, resbar);
  }
  if (THREADS > CG_CONS && warp == CG_CW) {  // the producer warp
    if (lane == 0 && nres > 0) {
      mbar_arrive_tx(resbar, (uint32_t)nres * ld * 4u);
      for (int i = 0; i < nres; ++i)
        bulk_load(smem_u32(kres + (size_t)i * ld), K + (size_t)(r0 + i) * ld, (uint32_t)ld * 4u, resbar);
    }
    long long g = 0;
    for (int it = 0;; ++it) {
      if (lane == 0) *issued = g;
      __syncthreads();  // step start: the consumers' decision is in go[it & 1]
      if (!go[it & 1]) break;
      if (lane == 0 && nstr > 0) {
        // this step's stages, then the next step's first ones
        const long long limit = (long long)(it + 1) * nstr + (it + 1 < maxits ? (S < nstr ? S : nstr) : 0);
        for (; g < limit; ++g) {
          const int s = (int)(g % S);
          const long long u = g / S;
          if (u > 0) mbar_wait(empty + 8 * s, (uint32_t)((u - 1) & 1));
          const int row = r0 + nres + (int)(g % nstr);
          mbar_arrive_tx(full + 8 * s, (uint32_t)ld * 4u);
          bulk_load(smem_u32(ring + (size_t)s * ld), K + (size_t)row * ld, (uint32_t)ld * 4u, full + 8 * s);
        }
      }
      __syncwarp();
    }
    return;
  }

  // consumers: r = p = b (every block all of it), x = 0 on the block's rows
  float4 rv[CPT];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c4 = t + k * CG_CONS;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c4 < ld4) {
      const int i = 4 * c4;
      if (i < n) v.x = b[i];
      if (i + 1 < n) v.y = b[i + 1];
      if (i + 2 < n) v.z = b[i + 2];
      if (i + 3 < n) v.w = b[i + 3];
      ps4[c4] = v;
    }
    rv[k] = v;
    acc += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  float xr = 0.f;  // x of row r0 + t; rows past r0 + CG_CONS (small grids) in x itself
  for (int i = r0 + t + CG_CONS; i < r1; i += CG_CONS) x[i] = 0.f;
  // with one float4 chunk a thread (n <= 2048) its chunk of the first 16
  // resident rows stays in registers: the matvec reads them from there
  float4 kreg[CPT == 1 ? CG_RG : 1];
  if (nres > 0) mbar_wait(resbar, 0);
  if constexpr (CPT == 1) {
#pragma unroll
    for (int u = 0; u < CG_RG; ++u)
      kreg[u] = u < nres && t < ld4 ? reinterpret_cast<const float4*>(kres)[u * ld4 + t]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int sb = 0;  // rotates the cg_sum buffers
  const float nb2 = cg_sum(acc, sums + 16 * (sb++ & 3));
  const float safe = nb2 == 0.f ? 1.f : nb2;
  const float tolb = tol2 * safe;

  float rho = nb2, normr_sq = nb2;
  int niter = 0, it = 0;
  bool stop = nb2 <= tolb;
  long long gc = 0;  // ring stages consumed
  for (;; ++it) {
    const bool cont = !stop && it < maxits;
    if (t == 0) go[it & 1] = cont;
    __syncthreads();  // step start, with the producer
    if (!cont) break;
    // @phase: phase(0, it, 0);

    // q = K p on the block's rows, 16 rows a reduction: the resident rows
    // (shared memory), then the streamed ones (a ring stage each)
    float* qb = qbuf + (size_t)(it & 1) * ld;
    float4 pv[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c4 = t + k * CG_CONS;
      pv[k] = c4 < ld4 ? ps4[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    int gi = 0;
    for (int g0 = 0; g0 < nres; g0 += CG_RG, ++gi) {
      const int cnt = min(CG_RG, nres - g0);
      float a[CG_RG];
      if (CPT == 1 && g0 == 0) {
#pragma unroll
        for (int u = 0; u < CG_RG; ++u) {
          const float4 kv = kreg[CPT == 1 ? u : 0];
          a[u] = kv.x * pv[0].x + kv.y * pv[0].y + kv.z * pv[0].z + kv.w * pv[0].w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < CG_RG; ++u) a[u] = u < cnt ? cg_dot<CPT>(kres + (size_t)(g0 + u) * ld, ld4, pv) : 0.f;
      }
      const float q = cg_reduce(a, cnt, red + (gi & 1) * CG_CW * CG_RG);
      if (t < cnt) qb[r0 + g0 + t] = q;
    }
    // @phase: phase(0, it, 1);
    if constexpr (THREADS > CG_CONS) {
      for (int g0 = 0; g0 < nstr; g0 += CG_RG, ++gi) {
        const int cnt = min(CG_RG, nstr - g0);
        float a[CG_RG];
#pragma unroll
        for (int u = 0; u < CG_RG; ++u) {
          a[u] = 0.f;
          if (u < cnt) {
            const int s = (int)(gc % S);
            mbar_wait(full + 8 * s, (uint32_t)((gc / S) & 1));
            a[u] = cg_dot<CPT>(ring + (size_t)s * ld, ld4, pv);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * s);
            ++gc;
          }
        }
        const float q = cg_reduce(a, cnt, red + (gi & 1) * CG_CW * CG_RG);
        if (t < cnt) qb[r0 + nres + g0 + t] = q;
      }
    }
    named_sync(1, CG_CONS);  // every q of the block written
    // @phase: phase(0, it, 2);
    if (t == 0) grid_arrive(counter);
    if (warp == 0) grid_wait(counter, (unsigned)it + 1, G);
    named_sync(1, CG_CONS);
    // @phase: phase(0, it, 3);

    // every block: p'q, alpha, r -= alpha q and r'r over all n (all of q
    // from L2, the same order everywhere); x on the block's own rows
    const float4* qb4 = reinterpret_cast<const float4*>(qb);
    float4 qv[CPT];
    acc = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c4 = t + k * CG_CONS;
      qv[k] = c4 < ld4 ? __ldcg(qb4 + c4) : make_float4(0.f, 0.f, 0.f, 0.f);
      acc += pv[k].x * qv[k].x + pv[k].y * qv[k].y + pv[k].z * qv[k].z + pv[k].w * qv[k].w;
    }
    const float pq_all = cg_sum(acc, sums + 16 * (sb++ & 3));
    const bool breakdown = rho == 0.f || pq_all <= 0.f;
    const float alpha = breakdown ? 0.f : rho / (pq_all == 0.f ? 1.f : pq_all);
    if (t < r1 - r0) xr += alpha * ps[r0 + t];
    for (int i = r0 + t + CG_CONS; i < r1; i += CG_CONS) x[i] += alpha * ps[i];
    acc = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      rv[k].x -= alpha * qv[k].x;
      rv[k].y -= alpha * qv[k].y;
      rv[k].z -= alpha * qv[k].z;
      rv[k].w -= alpha * qv[k].w;
      acc += rv[k].x * rv[k].x + rv[k].y * rv[k].y + rv[k].z * rv[k].z + rv[k].w * rv[k].w;
    }
    const float rr = cg_sum(acc, sums + 16 * (sb++ & 3));
    // @phase: phase(0, it, 4);
    normr_sq = rr;
    ++niter;
    stop = breakdown || rr <= tolb;
    if (!stop && it + 1 < maxits) {
      const float beta = rr / (rho == 0.f ? 1.f : rho);
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c4 = t + k * CG_CONS;
        if (c4 < ld4) {
          float4 p;
          p.x = rv[k].x + beta * pv[k].x;
          p.y = rv[k].y + beta * pv[k].y;
          p.z = rv[k].z + beta * pv[k].z;
          p.w = rv[k].w + beta * pv[k].w;
          ps4[c4] = p;
        }
      }
    }
    rho = rr;
    // @phase: phase(0, it, 5);
  }
  // the stages the producer copied ahead and nobody consumed, and the
  // resident rows if no step ran, land before the block exits
  if (THREADS > CG_CONS) {
    const long long done = *issued;
    for (; gc < done; ++gc) mbar_wait(full + 8 * (int)(gc % S), (uint32_t)((gc / S) & 1));
  }
  if (t < r1 - r0) x[r0 + t] = xr;
  if (blockIdx.x == 0 && t == 0) {
    relres[0] = sqrtf(fmaxf(normr_sq, 0.f) / safe);
    niter_out[0] = niter;
  }
}

// --- Lanczos ------------------------------------------------------------------

// Sums over the G blocks of src[q G + k], q < count (the same in every
// block): warp w takes q = 8 w .. 8 w + 7, then 8 w + 64 ...; lane l adds
// blocks l, l + 32, ... in order, a fixed shuffle tree the rest; a warp's
// loads are issued together.  store(q, sum) by lane 0.
template <typename F>
__device__ __forceinline__ void lz_totals(const float* src, int G, int count, F store) {
  constexpr int QB = 8, PER_LANE = MAX_BLOCKS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q0 = warp * QB; q0 < count; q0 += LZ_CW * QB) {
    float v[QB][PER_LANE];
#pragma unroll
    for (int u = 0; u < QB; ++u)
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int k = lane + 32 * i;
        v[u][i] = q0 + u < count && k < G ? __ldcg(src + (size_t)(q0 + u) * G + k) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) s += v[u][i];
      s = warp_sum(s);
      if (lane == 0 && q0 + u < count) store(q0 + u, s);
    }
  }
}

// sum over j <= last of a(j) b(j), j ascending, the loads of 16 j at a time
// issued together
template <typename A, typename B>
__device__ __forceinline__ float batched_dot(int last, A a, B b) {
  constexpr int BATCH = 16;
  float s = 0.f;
  for (int j0 = 0; j0 <= last; j0 += BATCH) {
    float x[BATCH], y[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      x[u] = j0 + u <= last ? a(j0 + u) : 0.f;
      y[u] = j0 + u <= last ? b(j0 + u) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (j0 + u <= last) s += x[u] * y[u];
  }
  return s;
}

// The product w[:, panel] = v K[:, panel] of one panel (C columns at c0),
// reduced over the block into sw[c][nvp4] (shared memory).  The ring's
// stage k holds chunk k of v_it (JT rows) and, where the chunk is not
// resident, the panel's JT x C box of K.  Consumer thread (cg, jg):
// columns 4 cg .. 4 cg + 3, rows jg, jg + NJG, ... of each chunk.  The
// lanes of a column group add by shuffles; the warps' sums are added in
// warp order, in parallel through the ring's memory when `par` (the
// block's last panel: the ring is idle until the next step), else warp
// after warp into sw.
template <int NVT>
__device__ __forceinline__ void lz_panel(const LzPlan& plan, int n, int nvp4, int panel_local, int nres, float* ring,
                                         const float* kres, int stage_floats, uint32_t full, uint32_t empty,
                                         long long& gc, float* sw, bool par, int it) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int C = plan.C, JT = plan.JT, CGc = C >> 2, NJG = LZ_CONS / CGc, cgi = t % CGc, jg = t / CGc;
  const int S = plan.stages, nchunks = (n + JT - 1) / JT;
  float acc[NVT][4];
#pragma unroll
  for (int r = 0; r < NVT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  for (int k = 0; k < nchunks; ++k, ++gc) {
    const int s = (int)(gc % S);
    mbar_wait(full + 8 * s, (uint32_t)((gc / S) & 1));
    // @phase: if (k == 0 && panel_local == 0) phase(1, it, 8);
    const float* vst = ring + (size_t)s * stage_floats;
    const float* kst = k < nres ? kres + ((size_t)panel_local * nres + k) * JT * C : vst + JT * nvp4;
    for (int jj = jg; jj < JT; jj += NJG) {
      if (k * JT + jj >= n) break;
      const float4 kv = *reinterpret_cast<const float4*>(kst + jj * C + 4 * cgi);
      float vr[(NVT + 3) & ~3];
#pragma unroll
      for (int q = 0; q < (NVT + 3) / 4; ++q) {
        const float4 v4 = *reinterpret_cast<const float4*>(vst + jj * nvp4 + 4 * q);
        vr[4 * q] = v4.x;
        vr[4 * q + 1] = v4.y;
        vr[4 * q + 2] = v4.z;
        vr[4 * q + 3] = v4.w;
      }
#pragma unroll
      for (int r = 0; r < NVT; ++r) {
        acc[r][0] += vr[r] * kv.x;
        acc[r][1] += vr[r] * kv.y;
        acc[r][2] += vr[r] * kv.z;
        acc[r][3] += vr[r] * kv.w;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  // @phase: if (panel_local == 0) phase(1, it, 9);
  for (int o = CGc; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < NVT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], o);
  if (par) {
    float* red = ring;  // [LZ_CW][C][nvp4]
    named_sync(1, LZ_CONS);  // every warp has read its last stage
    if (lane < CGc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int r = 0; r < NVT; ++r) red[((size_t)warp * C + 4 * cgi + e) * nvp4 + r] = acc[r][e];
    named_sync(1, LZ_CONS);
    for (int idx = t; idx < C * nvp4; idx += LZ_CONS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < LZ_CW; ++w) s += red[(size_t)w * C * nvp4 + idx];
      sw[idx] = s;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the ring's next TMA writes
    named_sync(1, LZ_CONS);
  } else {
    for (int w = 0; w < LZ_CW; ++w) {
      if (warp == w && lane < CGc) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < NVT; ++r) {
            float* d = sw + (4 * cgi + e) * nvp4 + r;
            *d = (w == 0 ? 0.f : *d) + acc[r][e];
          }
      }
      named_sync(1, LZ_CONS);
    }
  }
}

// bytes ahead of the ring for a block's own columns of w and of the V
// history, when the plan keeps them in shared memory
__host__ __device__ inline int lz_own_bytes(int own, int ncol_max, int nvp4, int nv, int m1) {
  return own ? (4 * ncol_max * (nvp4 + nv * m1) + 1023) / 1024 * 1024 : 0;
}

template <int NVT>
__global__ void __launch_bounds__(LZ_THREADS, 1)
    lanczos_kernel(const __grid_constant__ LzPlan plan, const __grid_constant__ CUtensorMap kmap,
                   const float* __restrict__ Z, int n, int nv, int maxits, float* alpha, float* beta, float* V,
                   float* beta0, float* wbuf, float* part, unsigned* counter) {
  extern __shared__ __align__(16) unsigned char lz_smem[];
  unsigned char* base = lz_smem + ((1024 - (smem_u32(lz_smem) & 1023)) & 1023);
  const uint32_t bars = smem_u32(base);  // full[8], empty[8], resident
  const uint32_t full = bars, empty = bars + 8 * MAX_STAGES, resbar = bars + 16 * MAX_STAGES;
  volatile int* go = reinterpret_cast<volatile int*>(base + 192);  // [2] by step parity
  float* tn = reinterpret_cast<float*>(base + 256);               // [16] norms of w
  float* dv = tn + MAX_NV;                                        // [16] divisors of the next product
  float* bc = dv + MAX_NV;                                        // [32]
  int* stopf = reinterpret_cast<int*>(bc + 32);                   // [16]
  float* coef = reinterpret_cast<float*>(base + 1024);            // [2][MAX_NV][MAX_M1]
  float* sw = coef + 2 * MAX_NV * MAX_M1;                         // [LZ_MAX_C][16]
  const int nvp4 = (nv + 3) & ~3, m1 = maxits + 1;
  const int C = plan.C, JT = plan.JT, S = plan.stages, G = plan.G, ncmax = plan.ppb_max * C;
  const int stage_floats = JT * nvp4 + (plan.kpart ? JT * C : 0);
  // the block's own columns of w ([c][nvp4]) and of the V history
  // ([r m1 + j][c]) in shared memory, or in global memory (w, V) if not
  float* w_own = reinterpret_cast<float*>(base + LZ_FIXED);
  float* hist = w_own + (size_t)ncmax * nvp4;
  float* ring = reinterpret_cast<float*>(base + LZ_FIXED + lz_own_bytes(plan.own, ncmax, nvp4, nv, m1));
  float* kres = ring + (size_t)S * stage_floats;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int p0 = plan.pstart[blockIdx.x], p1 = plan.pstart[blockIdx.x + 1], nres = plan.res[blockIdx.x];
  const int cb = p0 * C, ce = min(n, p1 * C), ncol = ce - cb;
  const int nchunks = (n + JT - 1) / JT;
  const bool par_last = (long long)S * stage_floats >= (long long)LZ_CW * C * nvp4;
  // the history: hs[(r m1 + j) hrow + c] for an own column c
  float* hs = plan.own ? hist - cb : V;
  const size_t hrow = plan.own ? (size_t)ncmax : (size_t)n;

  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, LZ_CW);
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == LZ_CW) {  // the producer warp
    if (lane == 0 && nres > 0) {
      mbar_arrive_tx(resbar, (uint32_t)(p1 - p0) * nres * JT * C * 4u);
      for (int p = p0; p < p1; ++p)
        for (int k = 0; k < nres; ++k)
          tma_load_2d(smem_u32(kres + ((size_t)(p - p0) * nres + k) * JT * C), &kmap, resbar, p * C, k * JT);
    }
    long long g = 0;
    for (int it = 0;; ++it) {
      __syncthreads();  // step start: v_it is in wbuf[(it + 1) & 1] of every block
      if (!go[it & 1]) break;
      if (lane == 0) {
        asm volatile("fence.proxy.async.global;\n" ::: "memory");  // other blocks' generic writes, then TMA reads
        const float* vin = wbuf + (size_t)((it + 1) & 1) * n * nvp4;
        for (int p = p0; p < p1; ++p)
          for (int k = 0; k < nchunks; ++k, ++g) {
            const int s = (int)(g % S);
            const long long u = g / S;
            if (u > 0) mbar_wait(empty + 8 * s, (uint32_t)((u - 1) & 1));
            const int rows = min(JT, n - k * JT);
            const uint32_t vbytes = (uint32_t)rows * nvp4 * 4u;
            const uint32_t dst = smem_u32(ring + (size_t)s * stage_floats);
            mbar_arrive_tx(full + 8 * s, vbytes + (k < nres ? 0u : (uint32_t)JT * C * 4u));
            bulk_load(dst, vin + (size_t)k * JT * nvp4, vbytes, full + 8 * s);
            if (k >= nres) tma_load_2d(dst + JT * nvp4 * 4u, &kmap, full + 8 * s, p * C, k * JT);
          }
      }
      __syncwarp();
    }
    return;
  }

  // consumers.  beta0 = ||z|| over all n (every block, the same order)
  for (int r = warp; r < nv; r += LZ_CW) {
    float s = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float z = Z[(size_t)r * n + c];
      s += z * z;
    }
    s = warp_sum(s);
    if (lane == 0) bc[r] = sqrtf(s);
  }
  if (t < MAX_NV) {
    stopf[t] = 0;
    dv[t] = 1.f;
  }
  named_sync(1, LZ_CONS);
  // v_0 = z / beta0 on the block's columns: V[:, 0], the history and, transposed, wbuf[1]
  float* w1 = wbuf + (size_t)n * nvp4;
  for (int e = t; e < ncol * nvp4; e += LZ_CONS) {
    const int c = cb + e / nvp4, r = e % nvp4;
    float v = 0.f;
    if (r < nv) {
      const float b0 = bc[r];
      v = Z[(size_t)r * n + c] / (b0 == 0.f ? 1.f : b0);
      V[(size_t)r * m1 * n + c] = v;
      if (plan.own) hs[(size_t)r * m1 * hrow + c] = v;
    }
    w1[(size_t)c * nvp4 + r] = v;
  }
  if (blockIdx.x == 0 && t < nv) beta0[t] = bc[t];
  named_sync(1, LZ_CONS);
  unsigned epoch = 1;
  if (t == 0) grid_arrive(counter);
  if (warp == 0) grid_wait(counter, epoch, G);
  named_sync(1, LZ_CONS);

  long long gc = 0;
  const size_t pstride = (size_t)MAX_NV * MAX_M1 * G;  // part floats of one parity
  for (int it = 0;; ++it) {
    int all = 1;
    for (int r = 0; r < nv; ++r) all &= stopf[r];
    const bool cont = !all && it < maxits;
    if (t == 0) go[it & 1] = cont;
    __syncthreads();  // step start, with the producer
    if (!cont) break;

    // w = v_it K on the block's columns, divided by ||w_{it-1}|| (0: a stopped probe)
    // @phase: phase(1, it, 0);
    if (nres > 0) mbar_wait(resbar, 0);
    float* w = wbuf + (size_t)(it & 1) * n * nvp4;  // this step's w, every block's columns
    float* wo = plan.own ? w_own - (size_t)cb * nvp4 : w;  // the block's own: wo[c nvp4 + r]
    for (int p = p0; p < p1; ++p) {
      lz_panel<NVT>(plan, n, nvp4, p - p0, nres, ring, kres, stage_floats, full, empty, gc, sw,
                    par_last && p == p1 - 1, it);
      for (int e = t; e < C * nvp4; e += LZ_CONS) {
        const int c = p * C + e / nvp4, r = e % nvp4;
        if (c < n) {
          const float d = r < nv ? dv[r] : 0.f;
          wo[(size_t)c * nvp4 + r] = d == 0.f ? 0.f : sw[e] / d;
        }
      }
      named_sync(1, LZ_CONS);
    }
    // @phase: phase(1, it, 1);

    // two CGS passes against the whole history (its rows past `it` are
    // zero), on the block's own columns; one thread a (probe, step) pair
    // for the partial sums (over the block's columns, in order), pt:
    // [pair][block]; the blocks' partials added by lz_totals
    const int npairs = nv * (it + 1);
    for (int pass = 0; pass < 2; ++pass) {
      float* cf = coef + pass * MAX_NV * MAX_M1;
      float* pt = part + (size_t)((epoch + 1) & 1) * pstride;
      for (int q = t; q < npairs; q += LZ_CONS) {
        const int r = q / (it + 1), j = q % (it + 1);
        const float* vr = hs + (size_t)(r * m1 + j) * hrow + cb;
        const float* wr = wo + (size_t)cb * nvp4 + r;
        pt[(size_t)q * G + blockIdx.x] =
            batched_dot(ncol - 1, [&](int c) { return vr[c]; }, [&](int c) { return wr[(size_t)c * nvp4]; });
      }
      named_sync(1, LZ_CONS);
      ++epoch;
      if (t == 0) grid_arrive(counter);
      if (warp == 0) grid_wait(counter, epoch, G);
      named_sync(1, LZ_CONS);
      // @phase: phase(1, it, 2 + 2 * pass);
      lz_totals(pt, G, npairs, [&](int q, float v) { cf[(q / (it + 1)) * MAX_M1 + q % (it + 1)] = v; });
      named_sync(1, LZ_CONS);
      for (int e = t; e < nv * ncol; e += LZ_CONS) {
        const int r = e / ncol, c = cb + e % ncol;
        const float* hc = hs + (size_t)r * m1 * hrow + c;
        const float s = batched_dot(it, [&](int j) { return cf[r * MAX_M1 + j]; },
                                    [&](int j) { return hc[(size_t)j * hrow]; });
        wo[(size_t)c * nvp4 + r] -= s;
      }
      named_sync(1, LZ_CONS);
      // @phase: phase(1, it, 3 + 2 * pass);
    }

    // ||w||; w is final: the next product reads it (wbuf) after this barrier
    {
      if (plan.own)
        for (int e = t; e < ncol * nvp4; e += LZ_CONS) w[(size_t)cb * nvp4 + e] = w_own[e];
      float* pt = part + (size_t)((epoch + 1) & 1) * pstride;
      if (t < nv) {
        const float* wr = wo + (size_t)cb * nvp4 + t;
        pt[(size_t)t * G + blockIdx.x] = batched_dot(
            ncol - 1, [&](int c) { return wr[(size_t)c * nvp4]; }, [&](int c) { return wr[(size_t)c * nvp4]; });
      }
      named_sync(1, LZ_CONS);
      ++epoch;
      if (t == 0) grid_arrive(counter);
      if (warp == 0) grid_wait(counter, epoch, G);
      named_sync(1, LZ_CONS);
      // @phase: phase(1, it, 6);
      lz_totals(pt, G, nv, [&](int r, float v) { tn[r] = sqrtf(v); });
      named_sync(1, LZ_CONS);
    }

    // v_{it+1} = w / ||w|| while live; the tridiagonal entries; the stop flags
    for (int e = t; e < nv * ncol; e += LZ_CONS) {
      const int r = e / ncol, c = cb + e % ncol;
      const bool live = !stopf[r] && !(tn[r] < FLT_EPSILON);
      const float tt = tn[r] == 0.f ? 1.f : tn[r];
      const float v = live ? wo[(size_t)c * nvp4 + r] / tt : 0.f;
      V[((size_t)r * m1 + it + 1) * n + c] = v;
      if (plan.own) hs[((size_t)r * m1 + it + 1) * hrow + c] = v;
    }
    named_sync(1, LZ_CONS);
    if (t < nv) {
      const bool live = !stopf[t] && !(tn[t] < FLT_EPSILON);
      if (blockIdx.x == 0) {
        alpha[(size_t)t * maxits + it] = live ? coef[t * MAX_M1 + it] + coef[MAX_NV * MAX_M1 + t * MAX_M1 + it] : 1.f;
        if (it > 0)
          beta[(size_t)t * (maxits - 1) + it - 1] =
              live ? coef[t * MAX_M1 + it - 1] + coef[MAX_NV * MAX_M1 + t * MAX_M1 + it - 1] : 0.f;
      }
      dv[t] = live ? (tn[t] == 0.f ? 1.f : tn[t]) : 0.f;
      stopf[t] = stopf[t] || tn[t] < FLT_EPSILON;
    }
    named_sync(1, LZ_CONS);
    // @phase: phase(1, it, 7);
  }
  if (nres > 0) mbar_wait(resbar, 0);
}

// --- the barrier probe ----------------------------------------------------------

// `iters` grid-wide barriers: kind 0 cooperative groups' grid.sync(), kind 1
// the kernels' counter barrier; then one more, after which block 0 writes
// to check[0] the sum of every block's index + 1 (written before it).
__global__ void barrier_probe_kernel(int kind, int iters, unsigned* counter, int* check) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  for (int i = 0; i < iters; ++i) {
    if (kind == 0) {
      grid.sync();
    } else {
      __syncthreads();
      if (threadIdx.x == 0) grid_arrive(counter);
      if (threadIdx.x < 32) grid_wait(counter, (unsigned)(i + 1), G);
      __syncthreads();
    }
  }
  // every block writes its index + 1, then block 0 adds them after a barrier
  if (threadIdx.x == 0) check[1 + blockIdx.x] = blockIdx.x + 1;
  __syncthreads();
  if (kind == 0) {
    grid.sync();
  } else {
    if (threadIdx.x == 0) grid_arrive(counter);
    if (threadIdx.x < 32) grid_wait(counter, (unsigned)(iters + 1), G);
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < G; ++k) total += __ldcg(check + 1 + k);
    check[0] = total;
  }
}

int device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int coop = 0;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  return (int)e;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the plan's blocks fit the card: at most one an SM, and the shared memory
int check_grid(int G, int smem) {
  int sms = 0, optin = 0;
  const int e = device_limits(&sms, &optin);
  if (e) return e;
  if (G < 1 || G > sms || G > MAX_BLOCKS || smem > optin) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename F>
int launch(F kernel, int G, int threads, void** args, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(G), dim3(threads), args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// SMs and the opt-in shared memory a block of the current card (the plan's inputs)
int fused_device_limits(int* sms, int* smem_optin) { return device_limits(sms, smem_optin); }

// the layout constants the plans of solvers/fused_pcg.py mirror:
// {MAX_BLOCKS, SMEM_SLACK, CG_CONS, CG_FIXED, LZ_CONS, LZ_FIXED, LZ_MAX_C, MAX_STAGES}
void fused_constants(int* out) {
  const int v[8] = {MAX_BLOCKS, SMEM_SLACK, CG_CONS, CG_FIXED, LZ_CONS, LZ_FIXED, LZ_MAX_C, MAX_STAGES};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// CG on K (n x n, row stride ld: a multiple of 4, K 16-byte aligned) under
// a plan: G blocks, block b rows starts[b]:starts[b + 1] (each at least
// one, covering 0..n once), res[b] of them resident, the rest through a
// ring of `stages` one-row stages (2 to 8); smem the bytes the plan asked
// for.
// qbuf (2 ld floats) and the barrier counter zero on entry.  Refuses an
// inconsistent plan or one the card cannot hold (cudaErrorInvalidValue).
int fused_pcg_launch(const float* K, int ld, const float* b, int n, int maxits, float tol2, int G,
                     const int* starts, const int* res, int stages, int smem, float* x, float* qbuf,
                     unsigned* counter, float* relres, int* niter, void* stream) {
  if (n < 1 || n > MAX_N || ld < n || ld % 4 != 0 || !aligned16(K) || !aligned16(qbuf) || maxits < 0)
    return (int)cudaErrorInvalidValue;
  int e = check_grid(G, smem);
  if (e) return e;
  CgPlan plan{};
  plan.G = G;
  plan.ld = ld;
  plan.stages = stages;
  if (starts[0] != 0 || starts[G] != n) return (int)cudaErrorInvalidValue;
  bool streamed = false;
  for (int i = 0; i < G; ++i) {
    const int cnt = starts[i + 1] - starts[i];
    if (cnt < 1 || res[i] < 0 || res[i] > cnt) return (int)cudaErrorInvalidValue;
    streamed |= res[i] < cnt;
    plan.start[i] = starts[i];
    plan.res[i] = res[i];
    plan.res_max = res[i] > plan.res_max ? res[i] : plan.res_max;
  }
  plan.start[G] = n;
  if (streamed && (stages < 2 || stages > MAX_STAGES)) return (int)cudaErrorInvalidValue;
  if (!streamed) plan.stages = 0;
  const long long need = SMEM_SLACK + CG_FIXED + 4LL * ld * (1 + plan.res_max + plan.stages);
  if (need > smem) return (int)cudaErrorInvalidValue;
  void* args[] = {&plan, &K, &b, &n, &maxits, &tol2, &x, &qbuf, &counter, &relres, &niter};
  const int cpt = (ld / 4 + CG_CONS - 1) / CG_CONS;
  if (plan.stages > 0) {  // a ring: the producer warp
    if (cpt <= 1) return launch(pcg_kernel<1, CG_THREADS>, G, CG_THREADS, args, smem, stream);
    if (cpt <= 2) return launch(pcg_kernel<2, CG_THREADS>, G, CG_THREADS, args, smem, stream);
    if (cpt <= 4) return launch(pcg_kernel<4, CG_THREADS>, G, CG_THREADS, args, smem, stream);
    return launch(pcg_kernel<8, CG_THREADS>, G, CG_THREADS, args, smem, stream);
  }
  if (cpt <= 1) return launch(pcg_kernel<1, CG_CONS>, G, CG_CONS, args, smem, stream);
  if (cpt <= 2) return launch(pcg_kernel<2, CG_CONS>, G, CG_CONS, args, smem, stream);
  if (cpt <= 4) return launch(pcg_kernel<4, CG_CONS>, G, CG_CONS, args, smem, stream);
  return launch(pcg_kernel<8, CG_CONS>, G, CG_CONS, args, smem, stream);
}

// Lanczos on K (n x n, row stride ld, as CG) and Z (nv, n) under a plan:
// panels of C columns (C in 4..128, a power of two), chunks of JT rows (a
// multiple of the 1024 / C row groups, at most 256: one TMA box), block b
// panels pstart[b]:pstart[b + 1] (each at least one, covering all
// ceil(n / C) once), res[b] chunks of each resident, `stages` ring stages
// (2 to 8; a chunk of v_it, and of K where any chunk streams); own: the
// blocks' own columns of w and of the V history in shared memory
// (lz_own_bytes ahead of the ring).  alpha (nv, maxits) ones, beta
// (nv, maxits - 1) zeros and V (nv, maxits + 1, n) zeros on entry; wbuf
// 2 n (nv rounded up to 4) floats, 16-byte aligned; part 2 * 16 * 65 * G
// floats; the barrier counter zero.
int fused_lanczos_launch(const float* K, int ld, const float* Z, int n, int nv, int maxits, int G, int C, int JT,
                         int stages, const int* pstart, const int* res, int own, int smem, float* alpha, float* beta,
                         float* V, float* beta0, float* wbuf, float* part, unsigned* counter, void* stream) {
  if (n < 1 || n > MAX_N || ld < n || ld % 4 != 0 || !aligned16(K) || !aligned16(wbuf) || nv < 1 ||
      nv > MAX_NV || maxits < 1 || maxits + 1 > MAX_M1)
    return (int)cudaErrorInvalidValue;
  const int njg = LZ_CONS / (C > 0 ? C / 4 : 1);
  if (C < 4 || C > LZ_MAX_C || (C & (C - 1)) != 0 || JT < njg || JT > 256 || JT % njg != 0 || stages < 2 ||
      stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  int e = check_grid(G, smem);
  if (e) return e;
  const int panels = (n + C - 1) / C, nchunks = (n + JT - 1) / JT, nvp4 = (nv + 3) & ~3;
  LzPlan plan{};
  plan.G = G;
  plan.C = C;
  plan.JT = JT;
  plan.stages = stages;
  if (pstart[0] != 0 || pstart[G] != panels) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < G; ++i) {
    const int cnt = pstart[i + 1] - pstart[i];
    if (cnt < 1 || res[i] < 0 || res[i] > nchunks) return (int)cudaErrorInvalidValue;
    plan.pstart[i] = pstart[i];
    plan.res[i] = res[i];
    plan.held_max = cnt * res[i] > plan.held_max ? cnt * res[i] : plan.held_max;
    plan.ppb_max = cnt > plan.ppb_max ? cnt : plan.ppb_max;
    plan.kpart |= res[i] < nchunks;
  }
  plan.pstart[G] = panels;
  plan.own = own != 0;
  const long long stage = 4LL * JT * (nvp4 + (plan.kpart ? C : 0));
  const long long need = SMEM_SLACK + LZ_FIXED + lz_own_bytes(plan.own, plan.ppb_max * C, nvp4, nv, maxits + 1) +
                         stages * stage + 4LL * plan.held_max * JT * C;
  if (need > smem) return (int)cudaErrorInvalidValue;
  // K as a 2-D tensor map: columns (inner) x rows, boxes of C x JT, zeros past n
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap kmap;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)C, (cuuint32_t)JT};
  const cuuint32_t estr[2] = {1, 1};
  if (enc(&kmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(K), dims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&plan, &kmap, &Z, &n, &nv, &maxits, &alpha, &beta, &V, &beta0, &wbuf, &part, &counter};
  if (nv <= 2) return launch(lanczos_kernel<2>, G, LZ_THREADS, args, smem, stream);
  if (nv <= 4) return launch(lanczos_kernel<4>, G, LZ_THREADS, args, smem, stream);
  if (nv <= 8) return launch(lanczos_kernel<8>, G, LZ_THREADS, args, smem, stream);
  if (nv <= 10) return launch(lanczos_kernel<10>, G, LZ_THREADS, args, smem, stream);
  if (nv <= 12) return launch(lanczos_kernel<12>, G, LZ_THREADS, args, smem, stream);
  return launch(lanczos_kernel<16>, G, LZ_THREADS, args, smem, stream);
}

// `iters` grid-wide barriers (kind 0 grid.sync(), kind 1 the counter
// barrier) over `blocks` blocks (1 to the SMs: a plan's grid) of `threads`
// threads holding `smem` bytes of dynamic shared memory (enough to keep a
// second block off an SM), then the check (barrier_probe_kernel).
// counter: zero; check: 1 + blocks ints.  *per_sm gets the blocks an SM
// could hold at that size.
int barrier_probe_launch(int kind, int iters, int blocks, int threads, int smem, unsigned* counter, int* check,
                         int* per_sm, void* stream) {
  int sms = 0, optin = 0;
  int e = device_limits(&sms, &optin);
  if (e) return e;
  if ((kind != 0 && kind != 1) || iters < 0 || blocks < 1 || blocks > sms || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || smem < 0 || smem > optin)
    return (int)cudaErrorInvalidValue;
  e = (int)cudaFuncSetAttribute(barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, barrier_probe_kernel, threads, (size_t)smem);
  if (e) return e;
  void* args[] = {&kind, &iters, &counter, &check};
  e = (int)cudaLaunchCooperativeKernel((void*)barrier_probe_kernel, dim3(blocks), dim3(threads), args, (size_t)smem,
                                       static_cast<cudaStream_t>(stream));
  if (e) return e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
