// Wide packed NDFT kernels for Hopper (sm_90a) on the CUDA cores, plain C
// interface: every even width 2P = WR from 2 to 1026, every phase source.
//
// Port of the two Pallas kernels of the JAX package's ops/pallas_ndft.py at
// the widths the narrow kernels (packed_ndft.cu, packed_ndft_tc.cu,
// packed_ndft_regen.cu: 2P in {16, 32} and {18, 34}) are not built for --
// matern12's accuracy widths, N = 64 to 1024:
//   _adjoint_kernel (pallas_call at :326) -> wide_adjoint_kernel
//                                            + reduce_slices_kernel (tc_common.cuh)
//   _forward_kernel (pallas_call at :508) -> wide_forward_kernel
// in all four of its phase sources.  The two GEMM kernels read a float32 or
// a bf16 table (`WideKind`, bf16 upcast on load).  The regenerating sources
// ("doubling", "direct") first write the phases of every coordinate row
// into a float32 slab (wide_phases_kernel, scratch the caller allocates),
// each by the formula of its plain version (ops/packed_ndft.py phase_slab):
//   DIRECT    cos/sin(pi * 2p x) per mode (cospif/sinpif: 2p is an integer);
//   DOUBLING  row p is row (p & 1) rotated, for every set bit k >= 1 of p
//             from the lowest up, by e^{i 2^k theta}; the rotators come from
//             sincospif(2x) by the double-angle identity.  That is the
//             recurrence of _build_T6_doubling (rows [have, 2 have) = rows
//             [0, have) rotated by the rotator of row have/2) evaluated per
//             row: the same operations in the same order.
// and the float32 GEMMs read the slab as a table.  Made once per call, a
// phase costs its up to log2(P) rotations once, not once per output tile
// and weight set that reads it; the slab's bytes (Dtot WR n float32) are
// written once and read as the table's are.
//
// What bounds them on an H100 SXM (published peaks at 700 W): the adjoint
// does 2 nv npairs WR^2 n flops and the forward 2 nsets npairs WR^2 n, as
// float32 FMAs on the CUDA cores (67 TFLOP/s).  At n = 1e5, one pair,
// WR = 256, nv = nsets = 1 that is 1.31e10 flops, 0.196 ms, against 0.061 ms
// for the 205 MB float32 table at 3.35 TB/s: operations bound both from
// WR ~ 64 up.  (3xTF32 through mma.sync issues at about a quarter of the
// TF32 peak on this card, about 41 TFLOP/s of float32 products, so the CUDA
// cores are no slower and exact float32; wgmma in 3xTF32 is the later
// redesign.)
//
// Design: each is a register-blocked float32 tile GEMM; the tiles run at WR
// rounded up to the tile, pad phase rows are zero and pad outputs are not
// written; warps whose rows or columns of a tile are all pad skip their
// FMAs, and the forward's last chunk of b runs only its live rows, so the
// widths 2P = 64k + 2 of the regenerating sources (130, 258) pay little
// for the padding of their last tile (the adjoint still pays it in rows at
// nv = 1, where M = 2P).
// - Adjoint, a split-K GEMM per window: C[(r, a), b] = sum_i (alpha_r[i]
//   L0[a, i]) L1[b, i], M = nv WR flattened (r, a) rows, N = WR, K = points.
//   A block owns one 64 x 64 output tile and one chunk of points; its 256
//   threads hold 4 x 4 register tiles and stage alpha * L0 and L1 for 32
//   points a step in shared memory.  The grid is (output tile, window,
//   chunk) with the tile fastest, so the blocks of one chunk run together
//   and read its table rows from L2.  A 1-D window is the same product with
//   M = nv rows and alpha alone as A.  Each chunk writes its own partial
//   slice; reduce_slices_kernel adds them in a fixed order: no atomics, a
//   second launch is bitwise equal.
// - Forward, one block per 128 points and up to 32 weight sets: per window,
//   per 64-row tile of a (L0 staged once), per set, Z[a, i] = sum_b G_s[a, b]
//   L1[b, i] accumulated in registers (4 a x 8 points a thread) over 32-row
//   chunks of b, G and L1 staged in shared memory (G is read from L2: about
//   26 MB at 20 sets, five windows, WR = 256); then y_s[i] += sum_a L0[a, i]
//   Z[a, i], summed over the 16 a-groups in a fixed order through shared
//   memory.  1-D windows add sum_a L[a, i] g_s[a], two threads a point.  y
//   is written once, no cross-block reduction.
// Shared memory: 17 KB (adjoint), 84 KB (forward, dynamic) at every width.

#include <cuda_bf16.h>

#include "packed_ndft.cuh"
#include "tc_common.cuh"

namespace {

enum WideKind { W_F32 = 0, W_BF16 = 1 };
enum PhaseGen { G_DOUBLING = 0, G_DIRECT = 1 };  // PHASE_GEN_CODES of ops/_cuda_build.py

constexpr int WIDE_MAX = 1026;  // widest 2P
constexpr int ROT = 10;         // rotators e^{i 2^k theta}, k < ROT: bits of p < 1024

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

// slab[(j WR + a) n + i] = phase row a of coordinate row j at point i:
// cos(2 pi p x) in rows a = p < P, sin in rows P + p.  One thread a point.
template <int GEN>
__global__ void __launch_bounds__(256) wide_phases_kernel(const float* __restrict__ x, int xstride, int P, int n,
                                                          float* __restrict__ slab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, j = blockIdx.y;
  if (i >= n) return;
  const float xi = x[(size_t)j * xstride + i];
  float* cs = slab + (size_t)j * 2 * P * n + i;
  float* sn = cs + (size_t)P * n;
  if constexpr (GEN == G_DIRECT) {
    for (int p = 0; p < P; ++p) {
      const float arg = 2.f * p * xi;
      cs[(size_t)p * n] = cospif(arg);
      sn[(size_t)p * n] = sinpif(arg);
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
        if ((p >> k) & 1) {
          const float nc = vc * rc[k] - vs * rs[k];
          const float ns = vs * rc[k] + vc * rs[k];
          vc = nc;
          vs = ns;
        }
      }
      cs[(size_t)p * n] = vc;
      sn[(size_t)p * n] = vs;
    }
  }
}

// --- adjoint ------------------------------------------------------------------------

constexpr int AT = 256;                      // threads
constexpr int ABM = 64, ABN = 64, ABK = 32;  // output tile, points per step
constexpr int ALD = ABM + 4;

// One chunk's partial C over one 64 x 64 output tile of one window.
// two_d: a 2-D window (rows = pairs, A = alpha_r * L0[a]) or a 1-D window
// (rows = singles, A = alpha_r).  Output (r, a, b) at part + c S + base +
// w wstride + r rstride + a WR + b.  Three blocks an SM (at most 85
// registers a thread): on an NVIDIA H100 80GB HBM3 (700 W) this was faster
// than a two-buffer pipeline of the table loads, and four blocks an SM
// spilled; the bf16 instance spills at 85 registers and runs two blocks an
// SM.  All sixteen staged loads of a thread stay in flight together (one
// half at a time, fewer registers, was slower).  A warp owns 8 columns of
// the tile (tn = 2 warp, 2 warp + 1) over all 64 rows, so in the last
// column tile of a width 2P = 64k + r only the warps of its r columns do
// FMAs (2 of 64 columns at 2P = 130).
template <int KIND>
__global__ void __launch_bounds__(AT, KIND == W_BF16 ? 2 : 3)
    wide_adjoint_kernel(WideSrc src, const float* __restrict__ alpha, int n, int nv, Rows rows, int two_d, int ntn,
                        int chunk, float* __restrict__ part, size_t S, size_t base, size_t wstride, size_t rstride) {
  __shared__ __align__(16) float sA[ABK][ALD];
  __shared__ __align__(16) float sB[ABK][ALD];
  const int WR = src.WR;
  const int arows = two_d ? WR : 1;
  const int M = nv * arows;
  const int m0 = (blockIdx.x / ntn) * ABM, n0 = (blockIdx.x % ntn) * ABN;
  const int w = blockIdx.y, c = blockIdx.z;
  const int ja = two_d ? rows.v[2 * w] : 0, jb = two_d ? rows.v[2 * w + 1] : rows.v[w];
  const int i_begin = c * chunk, i_end = min(n, i_begin + chunk);
  const int t = threadIdx.x, tm = t % 16, tn = t / 16;
  const bool idle = n0 + tn * 4 >= WR;
  // staging map: a thread stages points k8 + 8 q (q < 4) of tile rows
  // srow[h] (h < 2) of A and of B: a warp stages 8 consecutive points of 4
  // rows per instruction (whole 32-byte sectors) into 32 distinct banks
  const int lane = t % 32, k8 = lane % 8;
  const int srow[2] = {lane / 8 + 4 * (t / 32), lane / 8 + 4 * (t / 32 + 8)};
  bool okA[2], okB[2];
  int arow[2], brow[2];
  size_t aoff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + srow[h], r = m / arows;
    okA[h] = m < M;
    arow[h] = m - r * arows;
    aoff[h] = (size_t)r * n;
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
        float v = 0.f;
        if (live && okA[h]) {
          v = alpha[aoff[h] + i];
          if (two_d) v *= phase<KIND>(src, ja, arow[h], i);
        }
        sA[kk][srow[h]] = v;
        sB[kk][srow[h]] = (live && okB[h]) ? phase<KIND>(src, jb, brow[h], i) : 0.f;
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
    const int m = m0 + tm * 4 + p;
    if (m >= M) continue;
    const int r = m / arows, a = m - r * arows;
    float* out = part + (size_t)c * S + base + (size_t)w * wstride + (size_t)r * rstride + (size_t)a * WR;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = n0 + tn * 4 + q;
      if (b < WR) out[b] = acc[p][q];
    }
  }
}

template <int KIND>
void wide_adjoint(const WideSrc& src, const float* alpha, int n, int nv, const int* pairs, int npairs,
                  const int* singles, int nsingles, float* part, int nchunks, int chunk, float* out,
                  cudaStream_t st) {
  const size_t WR = src.WR;
  const size_t S2 = (size_t)nv * npairs * WR * WR;
  const size_t S = S2 + (size_t)nv * nsingles * WR;
  const int ntn = (src.WR + ABN - 1) / ABN;
  if (npairs > 0) {
    const int ntm = (int)(((size_t)nv * WR + ABM - 1) / ABM);
    dim3 grid(ntm * ntn, npairs, nchunks);
    wide_adjoint_kernel<KIND><<<grid, AT, 0, st>>>(src, alpha, n, nv, make_rows(pairs, 2 * npairs), 1, ntn, chunk,
                                                   part, S, 0, WR * WR, (size_t)npairs * WR * WR);
  }
  if (nsingles > 0) {
    const int ntm = (nv + ABM - 1) / ABM;
    dim3 grid(ntm * ntn, nsingles, nchunks);
    wide_adjoint_kernel<KIND><<<grid, AT, 0, st>>>(src, alpha, n, nv, make_rows(singles, nsingles), 0, ntn, chunk,
                                                   part, S, S2, WR, (size_t)nsingles * WR);
  }
  launch_reduce_slices(part, nchunks, S, out, st);
}

// --- forward ------------------------------------------------------------------------

constexpr int FT = 256;  // threads
constexpr int FP = 128;  // points per block
constexpr int FA = 64;   // rows of a per tile
constexpr int FK = 32;   // rows of b per staged chunk (of a for the 1-D windows)
constexpr int FS = 32;   // weight sets per block (the grid tiles more)
constexpr int FLD = FP + 4, GLD = FA + 4;

struct FwdSmem {
  float L0[FA][FLD];    // the a tile of L0 for the block's points
  float L1[FK][FLD];    // a chunk of L1 rows (1-D windows: of L rows)
  float G[FK][GLD];     // G_s[a tile, b chunk], transposed (1-D windows: g[a][s])
  float part[16][FP];   // per a-group sums of the epilogue
  float y[FS][FP];
};

template <int KIND>
__global__ void __launch_bounds__(FT, 2) wide_forward_kernel(WideSrc src, int n, Rows pairs, int npairs,
                                                          const float* __restrict__ G2, Rows singles, int nsingles,
                                                          const float* __restrict__ G1, int nsets,
                                                          float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int WR = src.WR;
  const int t = threadIdx.x, ag = t / 16, ig = t % 16;
  const int i0 = blockIdx.x * FP, s0 = blockIdx.y * FS;
  const int ns = min(FS, nsets - s0);
  for (int idx = t; idx < FS * FP; idx += FT) (&sm.y[0][0])[idx] = 0.f;

  for (int w = 0; w < npairs; ++w) {
    const int ja = pairs.v[2 * w], jb = pairs.v[2 * w + 1];
    __syncthreads();  // the previous window's readers of the tiles are done
    for (int a0 = 0; a0 < WR; a0 += FA) {
      // a warp's 8 rows of a: in the last tile of 2P = 64k + r only the
      // warps of its r rows do FMAs
      const bool idle = a0 + ag * 4 >= WR;
      // read only after the first barrier of the b loop below
      for (int idx = t; idx < FA * FP; idx += FT) {
        const int ii = idx % FP, aa = idx / FP, a = a0 + aa, i = i0 + ii;
        sm.L0[aa][ii] = (a < WR && i < n) ? phase<KIND>(src, ja, a, i) : 0.f;
      }
      for (int s = 0; s < ns; ++s) {
        const float* G = G2 + ((size_t)(s0 + s) * npairs + w) * WR * WR;
        float acc[4][8] = {};
        for (int b0 = 0; b0 < WR; b0 += FK) {
          // 8 consecutive b of 4 rows a warp per instruction: whole sectors,
          // 32 distinct banks
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int bb = t % 8 + 8 * q, aa = (t % 32) / 8 + 4 * (t / 32) + 32 * h, a = a0 + aa, b = b0 + bb;
              sm.G[bb][aa] = (a < WR && b < WR) ? G[(size_t)a * WR + b] : 0.f;
            }
          }
          for (int idx = t; idx < FK * FP; idx += FT) {
            const int ii = idx % FP, bb = idx / FP, b = b0 + bb, i = i0 + ii;
            sm.L1[bb][ii] = (b < WR && i < n) ? phase<KIND>(src, jb, b, i) : 0.f;
          }
          __syncthreads();
          // the live rows of b only: 2P = 130 runs 130, not 160
          const int kend = idle ? 0 : min(FK, WR - b0);
#pragma unroll 4
          for (int kk = 0; kk < kend; ++kk) {
            float g[4], la[4], lb[4];
            load_vec<4>(g, &sm.G[kk][ag * 4]);
            load_vec<4>(la, &sm.L1[kk][ig * 4]);
            load_vec<4>(lb, &sm.L1[kk][FP / 2 + ig * 4]);
#pragma unroll
            for (int p = 0; p < 4; ++p) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[p][q] = fmaf(g[p], la[q], acc[p][q]);
                acc[p][4 + q] = fmaf(g[p], lb[q], acc[p][4 + q]);
              }
            }
          }
          __syncthreads();
        }
        // y_s[i] += sum_a L0[a, i] Z[a, i]: this thread's 4 rows, then the
        // 16 a-groups in order
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = (q < 4 ? 0 : FP / 2) + ig * 4 + (q & 3);
          float v = 0.f;
#pragma unroll
          for (int p = 0; p < 4; ++p) v = fmaf(sm.L0[ag * 4 + p][col], acc[p][q], v);
          sm.part[ag][col] = v;
        }
        __syncthreads();
        if (t < FP) {
          float tot = sm.y[s][t];
#pragma unroll
          for (int g = 0; g < 16; ++g) tot += sm.part[g][t];
          sm.y[s][t] = tot;
        }
        // part is written again only after the next b loop's first barrier,
        // L0 only after this barrier's readers are past it
      }
    }
  }

  for (int k = 0; k < nsingles; ++k) {
    const int j = singles.v[k];
    __syncthreads();  // the previous window's readers of the tiles are done
    const int ii = t % FP, half = t / FP;
    float* gs = &sm.G[0][0];  // gs[aa * FS + s]
    float accs[FS / 2] = {};
    for (int a0 = 0; a0 < WR; a0 += FK) {
      __syncthreads();
      for (int idx = t; idx < FK * FP; idx += FT) {
        const int jj = idx % FP, aa = idx / FP, a = a0 + aa, i = i0 + jj;
        sm.L1[aa][jj] = (a < WR && i < n) ? phase<KIND>(src, j, a, i) : 0.f;
      }
      for (int idx = t; idx < FK * FS; idx += FT) {
        const int s = idx % FS, aa = idx / FS, a = a0 + aa;
        gs[idx] = (s < ns && a < WR) ? G1[((size_t)(s0 + s) * nsingles + k) * WR + a] : 0.f;
      }
      __syncthreads();
      for (int aa = 0; aa < FK; ++aa) {
        const float l = sm.L1[aa][ii];
#pragma unroll
        for (int q = 0; q < FS / 2; ++q) accs[q] = fmaf(l, gs[aa * FS + 2 * q + half], accs[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < FS / 2; ++q)
      if (2 * q + half < ns) sm.y[2 * q + half][ii] += accs[q];
  }

  __syncthreads();
  for (int idx = t; idx < FS * FP; idx += FT) {
    const int s = idx / FP, jj = idx % FP, i = i0 + jj;
    if (s < ns && i < n) y[(size_t)(s0 + s) * n + i] = sm.y[s][jj];
  }
}

template <int KIND>
cudaError_t wide_forward(const WideSrc& src, int n, const int* pairs, int npairs, const float* G2, const int* singles,
                         int nsingles, const float* G1, int nsets, float* y, cudaStream_t st) {
  const int smem = (int)sizeof(FwdSmem);
  const cudaError_t e =
      cudaFuncSetAttribute(wide_forward_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((n + FP - 1) / FP, (nsets + FS - 1) / FS);
  wide_forward_kernel<KIND><<<grid, FT, smem, st>>>(src, n, make_rows(pairs, 2 * npairs), npairs, G2,
                                                   make_rows(singles, nsingles), nsingles, G1, nsets, y);
  return cudaSuccess;
}

bool bad_args(int kind, int WR, int n, int npairs, int nsingles) {
  return kind < W_F32 || kind > W_BF16 || WR < 2 || WR > WIDE_MAX || WR % 2 != 0 || n < 1 || npairs < 0 ||
         npairs > 32 || nsingles < 0 || nsingles > 64 || npairs + nsingles == 0;
}

}  // namespace

extern "C" {

// Each returns the cudaGetLastError() code after its launches (0 = success).

// The phases of the regenerating sources: slab (Dtot, 2P, n) float32,
// contiguous, from the float32 coordinates x (Dtot rows, xstride apart).
// gen: 0 doubling, 1 direct.
int wide_phases_launch(int gen, const float* x, int xstride, int Dtot, int P, int n, float* slab, void* stream) {
  if (gen < G_DOUBLING || gen > G_DIRECT || Dtot < 1 || Dtot > 65535 || P < 1 || 2 * P > WIDE_MAX || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + 255) / 256, Dtot);
  if (gen == G_DOUBLING) {
    wide_phases_kernel<G_DOUBLING><<<grid, 256, 0, st>>>(x, xstride, P, n, slab);
  } else {
    wide_phases_kernel<G_DIRECT><<<grid, 256, 0, st>>>(x, xstride, P, n, slab);
  }
  return (int)cudaGetLastError();
}

// kind: 0 float32 table, 1 bf16 table; src: the table (Dtot, WR, .),
// stride: its row stride in elements.
int wide_adjoint_launch(int kind, const void* src, int stride, const float* alpha, int WR, int n, int nv,
                        const int* pairs, int npairs, const int* singles, int nsingles, float* part, int nchunks,
                        int chunk, float* out, void* stream) {
  if (bad_args(kind, WR, n, npairs, nsingles) || nv < 1 || nchunks < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WideSrc s{src, stride, WR};
  if (kind == W_F32) {
    wide_adjoint<W_F32>(s, alpha, n, nv, pairs, npairs, singles, nsingles, part, nchunks, chunk, out, st);
  } else {
    wide_adjoint<W_BF16>(s, alpha, n, nv, pairs, npairs, singles, nsingles, part, nchunks, chunk, out, st);
  }
  return (int)cudaGetLastError();
}

int wide_forward_launch(int kind, const void* src, int stride, int WR, int n, const int* pairs, int npairs,
                        const float* G2, const int* singles, int nsingles, const float* G1, int nsets, float* y,
                        void* stream) {
  if (bad_args(kind, WR, n, npairs, nsingles) || nsets < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WideSrc s{src, stride, WR};
  const cudaError_t e = kind == W_F32
                            ? wide_forward<W_F32>(s, n, pairs, npairs, G2, singles, nsingles, G1, nsets, y, st)
                            : wide_forward<W_BF16>(s, n, pairs, npairs, G2, singles, nsingles, G1, nsets, y, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
