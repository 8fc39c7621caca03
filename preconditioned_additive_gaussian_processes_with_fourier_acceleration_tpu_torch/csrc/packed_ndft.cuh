// Packed NDFT kernels for Hopper (sm_90a) on the CUDA cores, templated on
// the phase source.
//
// Port of the two Pallas kernels of the JAX package's ops/pallas_ndft.py
// (`_adjoint_kernel`, pallas_call at :326; `_forward_kernel`, at :508):
//   _adjoint_kernel  -> adjoint_pairs_kernel + adjoint_singles_kernel
//                       + reduce_chunks_kernel (the split-K second pass)
//   _forward_kernel  -> forward_kernel
//
// Phases: for a coordinate row j and a point i, WR = 2P values,
// cos(2 pi p x_j[i]) at a = p < P and sin at a = P + p.  A phase source
// (`Src`) hands them out in two ways:
//   column(j, i, live, out[W])  one point's WR values in registers (zero
//                               when the point is not live and for a >= WR);
//   stage_pair / stage_single   a tile of TP points into shared memory.
// Instances: packed_ndft.cu streams them from a float32 table (every kernel
// here); packed_ndft_tc.cu uses adjoint_singles_kernel for the 1-D windows
// of a bf16 table (its 2-D windows and its forward run on the tensor
// cores).  packed_ndft_regen.cu, which regenerates the phases from the raw
// coordinates (the "doubling" and "direct" modes), takes only Rows,
// make_rows and the tile size TP from here: both its kernels run on the
// tensor cores.  Each .cu
// file is its own shared library with a plain C interface; all are built
// side by side.
//
// What bounds them on an H100 SXM: the contraction is 2 nv npairs WR^2 n
// flops per pass (2e10 at n = 2e5, nv = 10, five windows of WR = 32), run as
// f32 FMAs on the CUDA cores (67 TFLOP/s), so beyond nv ~ 1 the FMA rate and
// shared-memory operand traffic bound them, not the bytes of the table or
// the coordinates.  For bf16 tables and for the regenerated phases the
// tensor cores took over (packed_ndft_tc.cu, packed_ndft_regen.cu).
//
// Design:
// - Blocks run in parallel in no order, so the TPU's accumulation across
//   grid steps becomes per-chunk partial sums plus a second kernel that adds
//   the chunks in a fixed order: no atomics, deterministic results.
// - The adjoint stages a 64-point tile of alpha * L0 and of L1 in shared
//   memory, point-major; each thread keeps a TA x TB register tile of one
//   right-hand side's output, so a point costs it two vector loads from
//   shared memory for TA * TB FMAs.  The tiling runs at WRP, WR rounded up
//   to a multiple of 4: the pad columns hold zeros and their outputs are
//   not written.
// - The forward keeps one point per thread: its L0/L1 columns live in
//   registers, the combined weights of a tile of weight sets in shared
//   memory (G for 20 sets does not fit 227 KB, so the grid tiles the sets);
//   a block loops only over the sets it holds.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// The coordinate rows of one launch's windows: at most MAX_PAIRS 2-D
// windows (two rows each) or MAX_SINGLES 1-D windows.  A call with more
// runs in several launches (ops/packed_ndft.py `window_groups`); every C
// entry point refuses a launch beyond these (`windows_fit`) before it makes
// its Rows.
constexpr int MAX_PAIRS = 32, MAX_SINGLES = 64;

struct Rows {
  int v[2 * MAX_PAIRS > MAX_SINGLES ? 2 * MAX_PAIRS : MAX_SINGLES];
};

inline bool windows_fit(int npairs, int nsingles) {
  return npairs >= 0 && nsingles >= 0 && npairs <= MAX_PAIRS && nsingles <= MAX_SINGLES;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

constexpr int NT = 256;   // adjoint threads per block
constexpr int TP = 64;    // points per shared-memory tile
constexpr int NTF = 128;  // forward threads (= points) per block

template <int WR>
struct AdjCfg {
  static constexpr int WRP = (WR + 3) / 4 * 4;   // padded width of the tiling
  static constexpr int TA = 4;
  static constexpr int TB = WRP == 16 ? 2 : 4;
  static constexpr int NTB = WRP / TB;           // tiles along b
  static constexpr int TILES = (WRP / TA) * NTB;  // tiles per right-hand side
  static constexpr int RB = NT / TILES < 8 ? NT / TILES : 8;  // rhs per block
  static constexpr int RBW = RB * WRP;
  static constexpr int LIVE = RB * TILES;        // threads that own a tile
  static_assert(RB >= 1, "unsupported WR");
};

template <int WR>
struct FwdCfg {
  static constexpr int ST = (8192 / (WR * WR)) < 16 ? (8192 / (WR * WR)) : 16;  // sets per block
};

template <int N>
struct Vec;
template <>
struct Vec<2> {
  using type = float2;
};
template <>
struct Vec<4> {
  using type = float4;
};

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  const typename Vec<N>::type v = *reinterpret_cast<const typename Vec<N>::type*>(src);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = f[k];
}

// A_w,r[a][b] partial over one chunk of points, for RB right-hand sides.
template <int WR, typename Src>
__global__ void __launch_bounds__(NT) adjoint_pairs_kernel(
    Src src, const float* __restrict__ alpha, int n, int nv, Rows pairs, int npairs, int chunk,
    float* __restrict__ part, size_t stride_c) {
  using C = AdjCfg<WR>;
  // point-major tiles; rows padded by 4 floats to keep 16-byte alignment
  __shared__ __align__(16) float sAL[TP][C::RBW + 4];  // alpha_r[i] * L0[a][i], column r*WRP + a
  __shared__ __align__(16) float sL1[TP][C::WRP + 4];
  const int c = blockIdx.x, w = blockIdx.y, r0 = blockIdx.z * C::RB;
  const int ja = pairs.v[2 * w], jb = pairs.v[2 * w + 1];
  const int i_begin = c * chunk;
  const int i_end = min(n, i_begin + chunk);
  const int t = threadIdx.x;
  const int rl = t / C::TILES;                 // right-hand side within the block
  const int a0 = (t % C::TILES) / C::NTB * C::TA;
  const int b0 = (t % C::TILES) % C::NTB * C::TB;
  const bool live_r = t < C::LIVE && r0 + rl < nv;
  float acc[C::TA][C::TB] = {};
  for (int i0 = i_begin; i0 < i_end; i0 += TP) {
    src.template stage_pair<C>(sAL, sL1, ja, jb, alpha, nv, r0, i0, i_end, t);
    __syncthreads();
    if (live_r) {
#pragma unroll 4
      for (int ii = 0; ii < TP; ++ii) {
        float av[C::TA], bv[C::TB];
        load_vec<C::TA>(av, &sAL[ii][rl * C::WRP + a0]);
        load_vec<C::TB>(bv, &sL1[ii][b0]);
#pragma unroll
        for (int p = 0; p < C::TA; ++p)
#pragma unroll
          for (int q = 0; q < C::TB; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
      }
    }
    __syncthreads();
  }
  if (live_r) {
    float* out = part + (size_t)c * stride_c + ((size_t)(r0 + rl) * npairs + w) * WR * WR;
#pragma unroll
    for (int p = 0; p < C::TA; ++p)
#pragma unroll
      for (int q = 0; q < C::TB; ++q)
        if (a0 + p < WR && b0 + q < WR) out[(a0 + p) * WR + b0 + q] = acc[p][q];
  }
}

// v_s,r[a] partial over one chunk of points (1-D windows).
template <int WR, typename Src>
__global__ void __launch_bounds__(NT) adjoint_singles_kernel(
    Src src, const float* __restrict__ alpha, int n, int nv, Rows singles, int nsingles, int chunk,
    float* __restrict__ part, size_t stride_c, size_t offset) {
  constexpr int RS = NT / WR;  // rhs per block
  __shared__ float sA[TP][RS + 1];
  __shared__ float sL[TP][WR + 1];
  const int c = blockIdx.x, s = blockIdx.y, r0 = blockIdx.z * RS;
  const int j = singles.v[s];
  const int i_begin = c * chunk;
  const int i_end = min(n, i_begin + chunk);
  const int t = threadIdx.x, a = t % WR, rl = t / WR;
  float acc = 0.f;
  for (int i0 = i_begin; i0 < i_end; i0 += TP) {
    src.template stage_single<WR + 1>(sL, j, i0, i_end, t);
    for (int idx = t; idx < RS * TP; idx += NT) {
      const int rr = idx / TP, ii = idx % TP, i = i0 + ii, r = r0 + rr;
      sA[ii][rr] = (i < i_end && r < nv) ? alpha[(size_t)r * n + i] : 0.f;
    }
    __syncthreads();
    if (rl < RS) {
#pragma unroll 8
      for (int ii = 0; ii < TP; ++ii) acc = fmaf(sA[ii][rl], sL[ii][a], acc);
    }
    __syncthreads();
  }
  const int r = r0 + rl;
  if (rl < RS && r < nv) part[(size_t)c * stride_c + offset + ((size_t)r * nsingles + s) * WR + a] = acc;
}

// out[o] = sum over chunks of part[c][o], chunks added in order.
__global__ void reduce_chunks_kernel(const float* __restrict__ part, int nchunks, size_t S,
                                     float* __restrict__ out) {
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= S) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += part[(size_t)c * S + o];
  out[o] = s;
}

// y_s[i] for ST weight sets per block; one point per thread.
template <int WR, typename Src>
__global__ void __launch_bounds__(NTF) forward_kernel(
    Src src, int n, Rows pairs, int npairs, const float* __restrict__ G2, Rows singles,
    int nsingles, const float* __restrict__ G1, int nsets, float* __restrict__ y) {
  constexpr int ST = FwdCfg<WR>::ST;
  __shared__ float sG[ST * WR * WR];
  __shared__ float sY[ST][NTF];
  const int t = threadIdx.x;
  const int i = blockIdx.x * NTF + t;
  const int s0 = blockIdx.y * ST;
  const int nlive = min(ST, nsets - s0);  // weight sets of this block
  const bool live = i < n;
#pragma unroll
  for (int s = 0; s < ST; ++s) sY[s][t] = 0.f;

  for (int w = 0; w < npairs; ++w) {
    float l0[WR], l1[WR];
    src.column(pairs.v[2 * w], i, live, l0);
    src.column(pairs.v[2 * w + 1], i, live, l1);
    __syncthreads();  // the previous window's readers are done with sG
    for (int idx = t; idx < ST * WR * WR; idx += NTF) {
      const int s = idx / (WR * WR), rem = idx % (WR * WR), gs = s0 + s;
      sG[idx] = gs < nsets ? G2[((size_t)gs * npairs + w) * WR * WR + rem] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < nlive; ++s) {
      const float* g = sG + s * WR * WR;
      float tot = 0.f;
#pragma unroll
      for (int a = 0; a < WR; ++a) {
        float z = 0.f;
#pragma unroll
        for (int b = 0; b < WR; ++b) z = fmaf(g[a * WR + b], l1[b], z);
        tot = fmaf(l0[a], z, tot);
      }
      sY[s][t] += tot;
    }
  }

  for (int k = 0; k < nsingles; ++k) {
    float ls[WR];
    src.column(singles.v[k], i, live, ls);
    __syncthreads();
    for (int idx = t; idx < ST * WR; idx += NTF) {
      const int s = idx / WR, a = idx % WR, gs = s0 + s;
      sG[idx] = gs < nsets ? G1[((size_t)gs * nsingles + k) * WR + a] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < nlive; ++s) {
      float tot = 0.f;
#pragma unroll
      for (int a = 0; a < WR; ++a) tot = fmaf(ls[a], sG[s * WR + a], tot);
      sY[s][t] += tot;
    }
  }

  if (live) {
    for (int s = 0; s < nlive; ++s) y[(size_t)(s0 + s) * n + i] = sY[s][t];
  }
}

// count <= 2 MAX_PAIRS or MAX_SINGLES: the entry points check windows_fit
Rows make_rows(const int* v, int count) {
  Rows r{};
  for (int k = 0; k < count; ++k) r.v[k] = v[k];
  return r;
}

template <int WR, typename Src>
void launch_adjoint(const Src& src, const float* alpha, int n, int nv, const int* pairs,
                    int npairs, const int* singles, int nsingles, float* part, int nchunks,
                    int chunk, float* out, cudaStream_t st) {
  using C = AdjCfg<WR>;
  const size_t S2 = (size_t)nv * npairs * WR * WR;
  const size_t S = S2 + (size_t)nv * nsingles * WR;
  if (npairs > 0) {
    dim3 grid(nchunks, npairs, (nv + C::RB - 1) / C::RB);
    adjoint_pairs_kernel<WR, Src><<<grid, NT, 0, st>>>(src, alpha, n, nv, make_rows(pairs, 2 * npairs),
                                                       npairs, chunk, part, S);
  }
  if (nsingles > 0) {
    constexpr int RS = NT / WR;
    dim3 grid(nchunks, nsingles, (nv + RS - 1) / RS);
    adjoint_singles_kernel<WR, Src><<<grid, NT, 0, st>>>(src, alpha, n, nv, make_rows(singles, nsingles),
                                                         nsingles, chunk, part, S, S2);
  }
  reduce_chunks_kernel<<<(unsigned)((S + 255) / 256), 256, 0, st>>>(part, nchunks, S, out);
}

template <int WR, typename Src>
void launch_forward(const Src& src, int n, const int* pairs, int npairs, const float* G2,
                    const int* singles, int nsingles, const float* G1, int nsets, float* y,
                    cudaStream_t st) {
  constexpr int ST = FwdCfg<WR>::ST;
  dim3 grid((n + NTF - 1) / NTF, (nsets + ST - 1) / ST);
  forward_kernel<WR, Src><<<grid, NTF, 0, st>>>(src, n, make_rows(pairs, 2 * npairs), npairs, G2,
                                                make_rows(singles, nsingles), nsingles, G1, nsets, y);
}

}  // namespace
