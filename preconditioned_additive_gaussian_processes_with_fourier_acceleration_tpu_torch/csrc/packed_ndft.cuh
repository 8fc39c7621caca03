// Pieces of the packed NDFT kernels shared by every library of this
// directory: the coordinate rows of one launch's windows (`Rows`, at most
// MAX_PAIRS 2-D and MAX_SINGLES 1-D windows a launch), the tile of TP
// points, vector loads from shared memory, and the CUDA-core adjoint of the
// 1-D windows (`adjoint_singles_kernel`), templated on the phase source.
//
// Port of part of the JAX package's ops/pallas_ndft.py `_adjoint_kernel`
// (pallas_call at :326): its 1-D windows, sum_i alpha_r[i] Ls[:, i], whose
// per-chunk partial sums a second kernel adds in a fixed order
// (tc_common.cuh reduce_slices_kernel).  A phase source (`Src`) stages a
// tile of TP points of one coordinate row's WR = 2P phase rows
// (cos(2 pi p x_j[i]) at a = p < P, sin at a = P + p) into shared memory
// (`stage_single`).  Users: packed_ndft.cu (float32 tables) and
// packed_ndft_tc.cu (bf16 tables) for their 1-D windows; packed_ndft_regen.cu
// and packed_ndft_wide.cu take Rows, make_rows, TP and load_vec.  Each .cu
// file is its own shared library with a plain C interface; all are built
// side by side.
//
// What bounds the 1-D windows on an H100 SXM: 2 nv WR n flops a window
// against the WR n table values they read, so the table's bytes (3.35 TB/s).

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

constexpr int NT = 256;   // threads per block of adjoint_singles_kernel
constexpr int TP = 64;    // points per shared-memory tile

template <int N>
struct Vec;
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

// count <= 2 MAX_PAIRS or MAX_SINGLES: the entry points check windows_fit
Rows make_rows(const int* v, int count) {
  Rows r{};
  for (int k = 0; k < count; ++k) r.v[k] = v[k];
  return r;
}

}  // namespace
