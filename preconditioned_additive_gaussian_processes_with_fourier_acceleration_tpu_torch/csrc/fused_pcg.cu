// Fused dense Krylov kernels for Hopper (sm_90a), plain C interface.
//
// Replace the two TPU kernels of the JAX package's solvers/pallas_pcg.py:
// - pcg_kernel      <- `_pcg_kernel`: a whole unpreconditioned CG solve of
//                      K x = b, K (n, n) f32 dense SPD, in one launch;
// - lanczos_kernel  <- `_lanczos_kernel`: the Lanczos recursions of nv probes
//                      with two-pass classical Gram-Schmidt against the whole
//                      history, one (nv, n) x (n, n) product per step.
//
// Design.  A Krylov step needs sums over the whole vector several times
// (CG: p'q and r'r; Lanczos: the two CGS projections and ||w||), so both
// kernels run as ONE persistent cooperative launch (the TPU ran the whole
// solve in one kernel too): every block is resident, the grid is sized from
// the occupancy calculator, and grid.sync() separates the phases of a step.
// Each block owns a contiguous panel of rows (CG) or panels of 32 columns
// (Lanczos) and writes its partial sums to a scratch vector; after the
// grid.sync() every block adds all partials in the same fixed order, so all
// blocks reach the same alpha, beta and stop flags (a flag that differed
// would deadlock the next grid.sync()) and a second run is bitwise equal.
// No atomics.  Values written by other blocks are read with __ldcg (L2),
// since L1 is not coherent across SMs.
//
// CG: p (n floats, <= 64 KB at the n <= 16384 limit) is staged into shared
// memory every step; one warp per row of K reads the row in 16-byte loads
// (n % 4 == 0; else 4-byte loads) and reduces with shuffles.
// Lanczos: lane = column, warp = a stride of K's rows: thread (w, c) adds
// v_r[j] K[j, c] for its rows j into nv register accumulators, so K is read
// once per step for all probes, in 128-byte rows per warp; v_it is staged in
// shared memory 256 entries at a time; the eight warps' sums are combined in
// shared memory in warp order.  V (the output) is the history.
//
// What bounds them on an H100 SXM (published peaks at 700 W): CG does
// 2 n^2 flops per step against K's n^2 * 4 bytes; at n = 2048 a 200-step
// solve is 1.7e9 flops (25 us at the 67 TFLOP/s f32 peak) against 17 MB of
// K read once (5 us at 3.35 TB/s) -- the operation count bounds it.  This
// first version re-reads K every step (from L2 when K fits its 50 MB) and
// pays three grid-wide barriers per CG step and four per Lanczos step; the
// barriers and L2 re-reads, not the bound, set its time (PERF.md).  Keeping
// K resident in shared memory across the grid and tensor cores for the
// Lanczos product are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int MAX_N = 16384;     // CG: p in shared memory; both: the stated limit
constexpr int MAX_NV = 16;       // Lanczos probes (register accumulators)
constexpr int MAX_M1 = 65;       // Lanczos maxits + 1 (coefficients in shared memory)
constexpr int PANEL = 32;        // Lanczos columns per panel (one per lane)
constexpr int JT = 256;          // Lanczos: entries of v_it staged per chunk

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread 0 returns the block's sum of v over threads, warp by warp in order.
__device__ __forceinline__ float block_sum0(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int k = 0; k < NW; ++k) s += red[k];
  __syncthreads();
  return s;
}

// Every thread of every block gets the same sum of part[0..G) (fixed order).
__device__ __forceinline__ float grid_total(const float* part, int G, float* bcast) {
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int k = threadIdx.x; k < G; k += 32) s += __ldcg(part + k);
    s = warp_sum(s);
    if (threadIdx.x == 0) *bcast = s;
  }
  __syncthreads();
  const float v = *bcast;
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(NT) pcg_kernel(
    const float* __restrict__ K, const float* __restrict__ b, int n, int maxits, float tol2,
    int rows_per_block, float* x, float* r, float* p, float* q, float* part_pq, float* part_rr,
    float* relres, int* niter_out) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);
  __shared__ float red[NW];
  __shared__ float bcast;
  const int G = gridDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * rows_per_block, r1 = min(n, r0 + rows_per_block);
  const bool vec = (n & 3) == 0;

  // x = 0, r = p = b on the block's rows; ||b||^2
  float acc = 0.f;
  for (int i = r0 + t; i < r1; i += NT) {
    const float bi = b[i];
    x[i] = 0.f;
    r[i] = bi;
    p[i] = bi;
    acc += bi * bi;
  }
  acc = block_sum0(acc, red);
  if (t == 0) part_rr[blockIdx.x] = acc;
  grid.sync();
  const float nb2 = grid_total(part_rr, G, &bcast);
  const float safe = nb2 == 0.f ? 1.f : nb2;
  const float tolb = tol2 * safe;

  float rr = nb2, normr_sq = nb2, rho_prev = 0.f;
  int niter = 0;
  bool stop = nb2 <= tolb;
  for (int it = 0; it < maxits && !stop; ++it) {
    const float rho = rr;  // sum r^2 of the current r, reduced in the same order
    const float beta = it == 0 ? 0.f : rho / (rho_prev == 0.f ? 1.f : rho_prev);
    for (int i = r0 + t; i < r1; i += NT) p[i] = __ldcg(r + i) + beta * __ldcg(p + i);
    grid.sync();

    // q = K p on the block's rows, one warp per row
    for (int k = t; k < n; k += NT) ps[k] = __ldcg(p + k);
    __syncthreads();
    float pq = 0.f;
    for (int i = r0 + warp; i < r1; i += NW) {
      const float* Ki = K + (size_t)i * n;
      float s = 0.f;
      if (vec) {
        const float4* K4 = reinterpret_cast<const float4*>(Ki);
        for (int k = lane; k < (n >> 2); k += 32) {
          const float4 a = __ldg(K4 + k), c = smem4[k];
          s += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
        }
      } else {
        for (int k = lane; k < n; k += 32) s += __ldg(Ki + k) * ps[k];
      }
      s = warp_sum(s);
      if (lane == 0) {
        q[i] = s;
        pq += ps[i] * s;
      }
    }
    pq = block_sum0(pq, red);
    if (t == 0) part_pq[blockIdx.x] = pq;
    grid.sync();
    const float pq_all = grid_total(part_pq, G, &bcast);

    const bool breakdown = rho == 0.f || pq_all <= 0.f;
    const float alpha = breakdown ? 0.f : rho / (pq_all == 0.f ? 1.f : pq_all);
    acc = 0.f;
    for (int i = r0 + t; i < r1; i += NT) {
      x[i] = __ldcg(x + i) + alpha * ps[i];
      const float ri = __ldcg(r + i) - alpha * __ldcg(q + i);
      r[i] = ri;
      acc += ri * ri;
    }
    acc = block_sum0(acc, red);
    if (t == 0) part_rr[blockIdx.x] = acc;
    grid.sync();
    rr = grid_total(part_rr, G, &bcast);
    normr_sq = rr;
    ++niter;
    stop = breakdown || normr_sq <= tolb;
    rho_prev = rho;
  }
  if (blockIdx.x == 0 && t == 0) {
    relres[0] = sqrtf(fmaxf(normr_sq, 0.f) / safe);
    niter_out[0] = niter;
  }
}

// The block's columns: panels blockIdx.x, blockIdx.x + G, ... of 32 columns.
// Thread (warp w, lane l) handles column panel * 32 + l and probes w, w + 8.
__global__ void __launch_bounds__(NT) lanczos_kernel(
    const float* __restrict__ K, const float* __restrict__ Z, int n, int nv, int maxits,
    float* alpha, float* beta, float* V, float* beta0, float* w, float* part1, float* part2,
    float* part3) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float vs[MAX_NV][JT];
  __shared__ float red[NW][MAX_NV][PANEL];
  __shared__ float coef[MAX_NV][MAX_M1];
  __shared__ float csum[MAX_NV][MAX_M1];
  __shared__ float tn[MAX_NV];
  __shared__ int stop[MAX_NV];
  const int G = gridDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int m1 = maxits + 1, npanels = (n + PANEL - 1) / PANEL;
  auto vrow = [&](int r, int j) { return V + ((size_t)r * m1 + j) * n; };

  // per-probe partial sums over the block's columns of f(r, c), one per warp
  // row r: lane 0 of warp (r % NW) writes part[blockIdx.x * nv + r]
  auto probe_partials = [&](float* part, auto f) {
    for (int rr = warp; rr < nv; rr += NW) {
      float s = 0.f;
      for (int pn = blockIdx.x; pn < npanels; pn += G) {
        const int c = pn * PANEL + lane;
        if (c < n) s += f(rr, c);
      }
      s = warp_sum(s);
      if (lane == 0) part[blockIdx.x * nv + rr] = s;
    }
  };
  // totals over blocks of those partials, into tn[r] (same order in every block)
  auto probe_totals = [&](const float* part) {
    for (int rr = warp; rr < nv; rr += NW) {
      float s = 0.f;
      for (int k = lane; k < G; k += 32) s += __ldcg(part + k * nv + rr);
      s = warp_sum(s);
      if (lane == 0) tn[rr] = sqrtf(s);
    }
    __syncthreads();
  };
  // CGS projections of w on V[r, 0..it] over the block's columns -> part
  auto cgs_partials = [&](float* part, int it) {
    const int npairs = nv * (it + 1);
    for (int qq = warp; qq < npairs; qq += NW) {
      const int rr = qq / (it + 1), j = qq % (it + 1);
      const float* vr = vrow(rr, j);
      float s = 0.f;
      for (int pn = blockIdx.x; pn < npanels; pn += G) {
        const int c = pn * PANEL + lane;
        if (c < n) s += __ldcg(vr + c) * __ldcg(w + (size_t)rr * n + c);
      }
      s = warp_sum(s);
      if (lane == 0) part[((size_t)blockIdx.x * nv + rr) * m1 + j] = s;
    }
  };
  // coef = totals of part over blocks; w -= sum_j coef[r][j] V[r, j] on own columns
  auto cgs_update = [&](const float* part, int it, bool first) {
    for (int qq = t; qq < nv * (it + 1); qq += NT) {
      const int rr = qq / (it + 1), j = qq % (it + 1);
      float s = 0.f;
      for (int k = 0; k < G; ++k) s += __ldcg(part + ((size_t)k * nv + rr) * m1 + j);
      coef[rr][j] = s;
      csum[rr][j] = first ? s : csum[rr][j] + s;
    }
    __syncthreads();
    for (int pn = blockIdx.x; pn < npanels; pn += G) {
      const int c = pn * PANEL + lane;
      if (c >= n) continue;
      for (int rr = warp; rr < nv; rr += NW) {
        float s = 0.f;
        for (int j = 0; j <= it; ++j) s += coef[rr][j] * __ldcg(vrow(rr, j) + c);
        w[(size_t)rr * n + c] = __ldcg(w + (size_t)rr * n + c) - s;
      }
    }
    __syncthreads();
  };

  // beta0 = ||z||, v_0 = z / beta0
  probe_partials(part3, [&](int rr, int c) {
    const float z = Z[(size_t)rr * n + c];
    return z * z;
  });
  if (t < MAX_NV) stop[t] = 0;
  grid.sync();
  probe_totals(part3);
  for (int pn = blockIdx.x; pn < npanels; pn += G) {
    const int c = pn * PANEL + lane;
    if (c >= n) continue;
    for (int rr = warp; rr < nv; rr += NW) {
      const float b0 = tn[rr];
      vrow(rr, 0)[c] = Z[(size_t)rr * n + c] / (b0 == 0.f ? 1.f : b0);
    }
  }
  if (blockIdx.x == 0 && t < nv) beta0[t] = tn[t];
  grid.sync();

  for (int it = 0; it < maxits; ++it) {
    // w = v_it K on the block's columns
    for (int pn = blockIdx.x; pn < npanels; pn += G) {
      const int c = pn * PANEL + lane;
      float acc[MAX_NV];
#pragma unroll
      for (int rr = 0; rr < MAX_NV; ++rr) acc[rr] = 0.f;
      for (int jc = 0; jc < n; jc += JT) {
        const int jlen = min(JT, n - jc);
        __syncthreads();
        for (int e = t; e < nv * JT; e += NT) {
          const int rr = e / JT, jj = e % JT;
          if (jj < jlen) vs[rr][jj] = __ldcg(vrow(rr, it) + jc + jj);
        }
        __syncthreads();
        if (c < n) {
          // four rows of K per warp in flight: one warp per SM-quarter is
          // too few to cover the load latency one row at a time
          int jj = warp;
          for (; jj + 3 * NW < jlen; jj += 4 * NW) {
            const float* Kj = K + (size_t)(jc + jj) * n + c;
            const float k0 = __ldg(Kj), k1 = __ldg(Kj + (size_t)NW * n);
            const float k2 = __ldg(Kj + (size_t)2 * NW * n), k3 = __ldg(Kj + (size_t)3 * NW * n);
#pragma unroll
            for (int rr = 0; rr < MAX_NV; ++rr)
              if (rr < nv)
                acc[rr] += vs[rr][jj] * k0 + vs[rr][jj + NW] * k1 + vs[rr][jj + 2 * NW] * k2 +
                           vs[rr][jj + 3 * NW] * k3;
          }
          for (; jj < jlen; jj += NW) {
            const float kv = __ldg(K + (size_t)(jc + jj) * n + c);
#pragma unroll
            for (int rr = 0; rr < MAX_NV; ++rr)
              if (rr < nv) acc[rr] += vs[rr][jj] * kv;
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < MAX_NV; ++rr)
        if (rr < nv) red[warp][rr][lane] = acc[rr];
      __syncthreads();
      if (c < n) {
        for (int rr = warp; rr < nv; rr += NW) {
          float s = 0.f;
          for (int k = 0; k < NW; ++k) s += red[k][rr][lane];
          w[(size_t)rr * n + c] = s;
        }
      }
      __syncthreads();
    }

    // two CGS passes against the whole history (rows past `it` are zero)
    cgs_partials(part1, it);
    grid.sync();
    cgs_update(part1, it, true);
    cgs_partials(part2, it);
    grid.sync();
    cgs_update(part2, it, false);
    probe_partials(part3, [&](int rr, int c) {
      const float v = __ldcg(w + (size_t)rr * n + c);
      return v * v;
    });
    grid.sync();
    probe_totals(part3);

    // v_{it+1} = w / ||w|| while live; the tridiagonal entries
    for (int pn = blockIdx.x; pn < npanels; pn += G) {
      const int c = pn * PANEL + lane;
      if (c >= n) continue;
      for (int rr = warp; rr < nv; rr += NW) {
        const bool live = !stop[rr] && !(tn[rr] < FLT_EPSILON);
        const float tt = tn[rr] == 0.f ? 1.f : tn[rr];
        vrow(rr, it + 1)[c] = live ? __ldcg(w + (size_t)rr * n + c) / tt : 0.f;
      }
    }
    __syncthreads();
    if (t < nv) {
      const bool live = !stop[t] && !(tn[t] < FLT_EPSILON);
      if (blockIdx.x == 0) {
        alpha[(size_t)t * maxits + it] = live ? csum[t][it] : 1.f;
        if (it > 0) beta[(size_t)t * (maxits - 1) + it - 1] = live ? csum[t][it - 1] : 0.f;
      }
      stop[t] = stop[t] || tn[t] < FLT_EPSILON;
    }
    __syncthreads();
    int all = 1;
    for (int rr = 0; rr < nv; ++rr) all &= stop[rr];
    if (all) break;  // the same decision in every block: same totals, same order
    grid.sync();
  }
}

__global__ void grid_sync_probe_kernel(int* out) {
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) out[1 + blockIdx.x] = blockIdx.x + 1;
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int s = 0;
    for (int k = 0; k < (int)gridDim.x; ++k) s += __ldcg(out + 1 + k);
    out[0] = s;
  }
}

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  int coop = 0;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  return (int)e;
}

// resident blocks of `kernel` on the current card, at `smem` dynamic bytes;
// `max_smem` is the most any launch of it asks for (the opt-in above 48 KB
// is set to that, so a launch sized by an earlier query never exceeds it)
template <typename F>
int resident_blocks(F kernel, size_t smem, size_t max_smem, int* blocks) {
  int sms = 0, per_sm = 0;
  int e = device_sms(&sms);
  if (e) return e;
  if (max_smem > 48 * 1024) {
    e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)max_smem);
    if (e) return e;
  }
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (e) return e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return 0;
}

size_t pcg_smem(int n) { return (size_t)((n + 3) / 4) * sizeof(float4); }

}  // namespace

extern "C" {

// Blocks of the CG launch for n on the current card: all resident, at least
// one row per warp.  The caller keeps the answer per (n, card).
int fused_pcg_grid(int n, int* grid) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int e = resident_blocks(pcg_kernel, pcg_smem(n), pcg_smem(MAX_N), &blocks);
  if (e) return e;
  const int want = (n + NW - 1) / NW;
  const int G = blocks < want ? blocks : want;
  const int rows = (n + G - 1) / G;
  *grid = (n + rows - 1) / rows;  // no block without rows
  return 0;
}

// scratch: r, p, q (n each), part_pq, part_rr (G each).  Returns the
// cudaLaunchCooperativeKernel / cudaGetLastError code (0 = success).
int fused_pcg_launch(const float* K, const float* b, int n, int maxits, float tol2, int G,
                     float* x, float* scratch, float* relres, int* niter, void* stream) {
  if (n < 1 || n > MAX_N || G < 1) return (int)cudaErrorInvalidValue;
  int rows = (n + G - 1) / G;
  float* r = scratch;
  float* p = r + n;
  float* q = p + n;
  float* part_pq = q + n;
  float* part_rr = part_pq + G;
  void* args[] = {&K, &b, &n, &maxits, &tol2, &rows, &x, &r, &p, &q, &part_pq, &part_rr,
                  &relres, &niter};
  const cudaError_t e = cudaLaunchCooperativeKernel((void*)pcg_kernel, dim3(G), dim3(NT), args,
                                                    pcg_smem(n), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of the Lanczos launch for n on the current card: all resident, at
// most one per panel.  The caller keeps the answer per (n, card).
int fused_lanczos_grid(int n, int* grid) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int e = resident_blocks(lanczos_kernel, 0, 0, &blocks);
  if (e) return e;
  const int panels = (n + PANEL - 1) / PANEL;
  *grid = blocks < panels ? blocks : panels;
  return 0;
}

// alpha (nv, maxits) ones, beta (nv, maxits - 1) zeros and V (nv, maxits + 1, n)
// zeros on entry; scratch: w (nv n), part1, part2 (G nv (maxits + 1) each),
// part3 (G nv).
int fused_lanczos_launch(const float* K, const float* Z, int n, int nv, int maxits, int G,
                         float* alpha, float* beta, float* V, float* beta0, float* scratch,
                         void* stream) {
  if (n < 1 || n > MAX_N || nv < 1 || nv > MAX_NV || maxits < 1 || maxits + 1 > MAX_M1 || G < 1)
    return (int)cudaErrorInvalidValue;
  float* w = scratch;
  float* part1 = w + (size_t)nv * n;
  float* part2 = part1 + (size_t)G * nv * (maxits + 1);
  float* part3 = part2 + (size_t)G * nv * (maxits + 1);
  void* args[] = {&K, &Z, &n, &nv, &maxits, &alpha, &beta, &V, &beta0, &w, &part1, &part2,
                  &part3};
  const cudaError_t e = cudaLaunchCooperativeKernel((void*)lanczos_kernel, dim3(G), dim3(NT), args,
                                                    0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// A grid-wide barrier check: every resident block writes its index + 1, then
// after grid.sync() block 0 writes their sum to out[0].  out holds 1 + grid
// ints; *grid gets the block count.
int grid_sync_probe(int* out, int* grid, void* stream) {
  int blocks = 0;
  int e = resident_blocks(grid_sync_probe_kernel, 0, 0, &blocks);
  if (e) return e;
  *grid = blocks;
  void* args[] = {&out};
  e = (int)cudaLaunchCooperativeKernel((void*)grid_sync_probe_kernel, dim3(blocks), dim3(NT), args,
                                       0, static_cast<cudaStream_t>(stream));
  if (e) return e;
  return (int)cudaGetLastError();
}

int probe_grid_size(int* grid) {
  return resident_blocks(grid_sync_probe_kernel, 0, 0, grid);
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
