// Packed streamed-table NDFT kernels for Hopper (sm_90a), plain C interface.
//
// Port of the two Pallas kernels of the JAX package's ops/pallas_ndft.py in
// their table modes:
//   _adjoint_kernel  -> adjoint_pairs_kernel + adjoint_singles_kernel
//                       + reduce_chunks_kernel (the split-K second pass)
//   _forward_kernel  -> forward_kernel
//
// Table layout: tab[j][a][i], (Dtot, WR, n), WR = 2P rows per coordinate
// row j: cos(2 pi p x_j[i]) for a = p < P, sin for a = P + p.  bf16 or f32,
// always accumulated in f32.  alpha (nv, n) and the weights are f32.
//
// What bounds them on an H100 SXM (published peaks at its 700 W limit): at
// n = 2e5, 10 coordinate rows and WR = 32 one pass reads 128 MB of bf16
// table (about 40 us at the 3.35 TB/s peak), while the
// adjoint does 2 * nv * npairs * WR^2 * n flops (2e10 at nv = 10, five
// windows) and the forward the same per weight set.  These first versions
// run those flops as f32 FMAs on the CUDA cores, so beyond nv ~ 1 they are
// bounded by FMA issue and shared-memory operand traffic, not by the table
// bytes; tensor-core (wgmma) tiles are the next step.
//
// Design:
// - Blocks run in parallel in no order, so the TPU's accumulation across
//   grid steps becomes per-chunk partial sums plus a second kernel that adds
//   the chunks in a fixed order: no atomics, deterministic results.
// - A block stages a 64-point tile of the table (and alpha * L0) in shared
//   memory, point-major; each thread keeps a 4 x 4 (4 x 2 at 2P = 16) tile
//   of one right-hand side's output in registers, so a point costs it two
//   vector loads from shared memory for 16 FMAs.  Warps whose right-hand
//   side is past nv skip the arithmetic.
// - The forward keeps one point per thread: its L0/L1 columns live in
//   registers, the combined weights of a tile of weight sets in shared
//   memory (G for 20 sets does not fit 227 KB, so the grid tiles the sets);
//   a block loops only over the sets it holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

struct Rows {
  int v[64];
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

constexpr int NT = 256;   // adjoint threads per block
constexpr int TP = 64;    // points per shared-memory tile
constexpr int NTF = 128;  // forward threads (= points) per block

template <int WR>
struct AdjCfg {
  static constexpr int RB = (4096 / (WR * WR)) < 8 ? (4096 / (WR * WR)) : 8;  // rhs per block
  static constexpr int RBW = RB * WR;
  static constexpr int OPT = RB * WR * WR / NT;  // outputs per thread
  // each thread owns a TA x TB register tile of one (2P, 2P) output
  static constexpr int TA = 4;
  static constexpr int TB = OPT / TA;
  static constexpr int NTB = WR / TB;            // tiles along b
  static constexpr int TILES = (WR / TA) * NTB;  // tiles per right-hand side
  static_assert(NT % WR == 0 && (RB * WR * WR) % NT == 0, "unsupported WR");
  static_assert((TB == 2 || TB == 4) && RB * TILES == NT, "unsupported WR");
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

template <int WR>
struct FwdCfg {
  static constexpr int ST = (8192 / (WR * WR)) < 16 ? (8192 / (WR * WR)) : 16;  // sets per block
};

// A_w,r[a][b] partial over one chunk of points, for RB right-hand sides.
template <int WR, typename T>
__global__ void __launch_bounds__(NT) adjoint_pairs_kernel(
    const T* __restrict__ tab, const float* __restrict__ alpha, int n, int nv,
    Rows pairs, int npairs, int chunk, float* __restrict__ part, size_t stride_c) {
  using C = AdjCfg<WR>;
  // point-major tiles; rows padded by 4 floats to keep 16-byte alignment
  __shared__ __align__(16) float sAL[TP][C::RBW + 4];  // alpha_r[i] * L0[a][i], column r*WR + a
  __shared__ __align__(16) float sL1[TP][WR + 4];
  const int c = blockIdx.x, w = blockIdx.y, r0 = blockIdx.z * C::RB;
  const T* L0 = tab + (size_t)pairs.v[2 * w] * WR * n;
  const T* L1 = tab + (size_t)pairs.v[2 * w + 1] * WR * n;
  const int i_begin = c * chunk;
  const int i_end = min(n, i_begin + chunk);
  const int t = threadIdx.x;
  const int rl = t / C::TILES;                 // right-hand side within the block
  const int a0 = (t % C::TILES) / C::NTB * C::TA;
  const int b0 = (t % C::TILES) % C::NTB * C::TB;
  const bool live_r = r0 + rl < nv;            // whole warps share rl
  float acc[C::TA][C::TB] = {};
  for (int i0 = i_begin; i0 < i_end; i0 += TP) {
    for (int idx = t; idx < WR * TP; idx += NT) {
      const int a = idx / TP, ii = idx % TP, i = i0 + ii;
      sL1[ii][a] = i < i_end ? ld(L1 + (size_t)a * n + i) : 0.f;
    }
    for (int idx = t; idx < C::RBW * TP; idx += NT) {
      const int ra = idx / TP, ii = idx % TP, i = i0 + ii;
      const int r = r0 + ra / WR, a = ra % WR;
      sAL[ii][ra] = (i < i_end && r < nv) ? alpha[(size_t)r * n + i] * ld(L0 + (size_t)a * n + i) : 0.f;
    }
    __syncthreads();
    if (live_r) {
#pragma unroll 4
      for (int ii = 0; ii < TP; ++ii) {
        float av[C::TA], bv[C::TB];
        load_vec<C::TA>(av, &sAL[ii][rl * WR + a0]);
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
      for (int q = 0; q < C::TB; ++q) out[(a0 + p) * WR + b0 + q] = acc[p][q];
  }
}

// v_s,r[a] partial over one chunk of points (1-D windows).
template <int WR, typename T>
__global__ void __launch_bounds__(NT) adjoint_singles_kernel(
    const T* __restrict__ tab, const float* __restrict__ alpha, int n, int nv,
    Rows singles, int nsingles, int chunk, float* __restrict__ part, size_t stride_c,
    size_t offset) {
  constexpr int RS = NT / WR;  // rhs per block
  __shared__ float sA[TP][RS + 1];
  __shared__ float sL[TP][WR + 1];
  const int c = blockIdx.x, s = blockIdx.y, r0 = blockIdx.z * RS;
  const T* Ls = tab + (size_t)singles.v[s] * WR * n;
  const int i_begin = c * chunk;
  const int i_end = min(n, i_begin + chunk);
  const int t = threadIdx.x, a = t % WR, rl = t / WR;
  float acc = 0.f;
  for (int i0 = i_begin; i0 < i_end; i0 += TP) {
    for (int idx = t; idx < WR * TP; idx += NT) {
      const int aa = idx / TP, ii = idx % TP, i = i0 + ii;
      sL[ii][aa] = i < i_end ? ld(Ls + (size_t)aa * n + i) : 0.f;
    }
    for (int idx = t; idx < RS * TP; idx += NT) {
      const int rr = idx / TP, ii = idx % TP, i = i0 + ii, r = r0 + rr;
      sA[ii][rr] = (i < i_end && r < nv) ? alpha[(size_t)r * n + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int ii = 0; ii < TP; ++ii) acc = fmaf(sA[ii][rl], sL[ii][a], acc);
    __syncthreads();
  }
  const int r = r0 + rl;
  if (r < nv) part[(size_t)c * stride_c + offset + ((size_t)r * nsingles + s) * WR + a] = acc;
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
template <int WR, typename T>
__global__ void __launch_bounds__(NTF) forward_kernel(
    const T* __restrict__ tab, int n, Rows pairs, int npairs, const float* __restrict__ G2,
    Rows singles, int nsingles, const float* __restrict__ G1, int nsets, float* __restrict__ y) {
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
    const T* L0 = tab + (size_t)pairs.v[2 * w] * WR * n;
    const T* L1 = tab + (size_t)pairs.v[2 * w + 1] * WR * n;
    float l0[WR], l1[WR];
#pragma unroll
    for (int a = 0; a < WR; ++a) {
      l0[a] = live ? ld(L0 + (size_t)a * n + i) : 0.f;
      l1[a] = live ? ld(L1 + (size_t)a * n + i) : 0.f;
    }
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
    const T* Ls = tab + (size_t)singles.v[k] * WR * n;
    float ls[WR];
#pragma unroll
    for (int a = 0; a < WR; ++a) ls[a] = live ? ld(Ls + (size_t)a * n + i) : 0.f;
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

Rows make_rows(const int* v, int count) {
  Rows r{};
  for (int k = 0; k < count && k < 64; ++k) r.v[k] = v[k];
  return r;
}

template <int WR, typename T>
void launch_adjoint(const void* tab, const float* alpha, int n, int nv, const int* pairs,
                    int npairs, const int* singles, int nsingles, float* part, int nchunks,
                    int chunk, float* out, cudaStream_t st) {
  using C = AdjCfg<WR>;
  const size_t S2 = (size_t)nv * npairs * WR * WR;
  const size_t S = S2 + (size_t)nv * nsingles * WR;
  const T* tb = static_cast<const T*>(tab);
  if (npairs > 0) {
    dim3 grid(nchunks, npairs, (nv + C::RB - 1) / C::RB);
    adjoint_pairs_kernel<WR, T><<<grid, NT, 0, st>>>(tb, alpha, n, nv, make_rows(pairs, 2 * npairs),
                                                     npairs, chunk, part, S);
  }
  if (nsingles > 0) {
    constexpr int RS = NT / WR;
    dim3 grid(nchunks, nsingles, (nv + RS - 1) / RS);
    adjoint_singles_kernel<WR, T><<<grid, NT, 0, st>>>(tb, alpha, n, nv, make_rows(singles, nsingles),
                                                       nsingles, chunk, part, S, S2);
  }
  reduce_chunks_kernel<<<(unsigned)((S + 255) / 256), 256, 0, st>>>(part, nchunks, S, out);
}

template <int WR, typename T>
void launch_forward(const void* tab, int n, const int* pairs, int npairs, const float* G2,
                    const int* singles, int nsingles, const float* G1, int nsets, float* y,
                    cudaStream_t st) {
  constexpr int ST = FwdCfg<WR>::ST;
  dim3 grid((n + NTF - 1) / NTF, (nsets + ST - 1) / ST);
  forward_kernel<WR, T><<<grid, NTF, 0, st>>>(static_cast<const T*>(tab), n,
                                              make_rows(pairs, 2 * npairs), npairs, G2,
                                              make_rows(singles, nsingles), nsingles, G1, nsets, y);
}

}  // namespace

extern "C" {

// Returns the cudaGetLastError() code after the launches (0 = success).
int packed_adjoint_launch(const void* tab, int table_bf16, const float* alpha, int WR, int n,
                          int nv, const int* pairs, int npairs, const int* singles, int nsingles,
                          float* part, int nchunks, int chunk, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NDFT_ADJ(W, TT) launch_adjoint<W, TT>(tab, alpha, n, nv, pairs, npairs, singles, nsingles, \
                                              part, nchunks, chunk, out, st)
  if (table_bf16) {
    if (WR == 16) NDFT_ADJ(16, __nv_bfloat16);
    else if (WR == 32) NDFT_ADJ(32, __nv_bfloat16);
    else return (int)cudaErrorInvalidValue;
  } else {
    if (WR == 16) NDFT_ADJ(16, float);
    else if (WR == 32) NDFT_ADJ(32, float);
    else return (int)cudaErrorInvalidValue;
  }
#undef NDFT_ADJ
  return (int)cudaGetLastError();
}

int packed_forward_launch(const void* tab, int table_bf16, int WR, int n, const int* pairs,
                          int npairs, const float* G2, const int* singles, int nsingles,
                          const float* G1, int nsets, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NDFT_FWD(W, TT) launch_forward<W, TT>(tab, n, pairs, npairs, G2, singles, nsingles, G1, nsets, y, st)
  if (table_bf16) {
    if (WR == 16) NDFT_FWD(16, __nv_bfloat16);
    else if (WR == 32) NDFT_FWD(32, __nv_bfloat16);
    else return (int)cudaErrorInvalidValue;
  } else {
    if (WR == 16) NDFT_FWD(16, float);
    else if (WR == 32) NDFT_FWD(32, float);
    else return (int)cudaErrorInvalidValue;
  }
#undef NDFT_FWD
  return (int)cudaGetLastError();
}

const char* packed_ndft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
