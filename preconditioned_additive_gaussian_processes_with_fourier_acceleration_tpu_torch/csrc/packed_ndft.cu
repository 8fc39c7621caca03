// Packed streamed-table NDFT kernels for float32 tables on Hopper (sm_90a),
// plain C interface.
//
// The "table_f32" mode of the JAX package's ops/pallas_ndft.py
// `_adjoint_kernel` / `_forward_kernel` for a float32 table tab[j][a][i]
// (Dtot, WR, stride >= n), WR = 2P rows per coordinate row j (cos(2 pi p x_j[i])
// for a = p < P, sin for a = P + p), row stride `stride` (pack_phase_table pads
// it to a multiple of 64 points); alpha (nv, n) and the weights are float32.
// The kernels themselves are the CUDA-core templates of packed_ndft.cuh.
// bf16 tables, the training path's, go to the tensor-core kernels of
// packed_ndft_tc.cu.
//
// What bounds them on an H100 SXM (published peaks at its 700 W limit): at
// n = 2e5, 10 coordinate rows and WR = 32 one pass reads 256 MB of float32
// table (76 us at the 3.35 TB/s peak), while the adjoint does
// 2 * nv * npairs * WR^2 * n flops (2e10 at nv = 10, five windows) and the
// forward the same per weight set, as f32 FMAs on the CUDA cores (67 TFLOP/s).

#include "packed_ndft.cuh"

namespace {

template <int WR>
struct TableSrc {
  const float* tab;
  int n;       // points (alpha's row length)
  int stride;  // elements between two table rows (>= n)

  static_assert(WR % 4 == 0, "the table kernels tile WR without padding");

  // the WR table rows of coordinate row j
  __device__ __forceinline__ const float* rows(int j) const { return tab + (size_t)j * WR * stride; }

  template <int W>
  __device__ __forceinline__ void column(int j, int i, bool live, float (&out)[W]) const {
    const float* L = rows(j);
#pragma unroll
    for (int a = 0; a < W; ++a) out[a] = (live && a < WR) ? ld(L + (size_t)a * stride + i) : 0.f;
  }

  // alpha * L0 and L1 of TP points, loaded element-wise by all threads
  // (neighbouring threads read neighbouring points: coalesced)
  template <typename C>
  __device__ __forceinline__ void stage_pair(float (*sAL)[C::RBW + 4], float (*sL1)[C::WRP + 4],
                                             int ja, int jb, const float* __restrict__ alpha,
                                             int nv, int r0, int i0, int i_end, int t) const {
    const float* L0 = rows(ja);
    const float* L1 = rows(jb);
    for (int idx = t; idx < WR * TP; idx += NT) {
      const int a = idx / TP, ii = idx % TP, i = i0 + ii;
      sL1[ii][a] = i < i_end ? ld(L1 + (size_t)a * stride + i) : 0.f;
    }
    for (int idx = t; idx < C::RBW * TP; idx += NT) {
      const int ra = idx / TP, ii = idx % TP, i = i0 + ii;
      const int r = r0 + ra / WR, a = ra % WR;
      sAL[ii][ra] = (i < i_end && r < nv) ? alpha[(size_t)r * n + i] * ld(L0 + (size_t)a * stride + i) : 0.f;
    }
  }

  template <int LD>
  __device__ __forceinline__ void stage_single(float (*sL)[LD], int j, int i0, int i_end, int t) const {
    const float* Ls = rows(j);
    for (int idx = t; idx < WR * TP; idx += NT) {
      const int a = idx / TP, ii = idx % TP, i = i0 + ii;
      sL[ii][a] = i < i_end ? ld(Ls + (size_t)a * stride + i) : 0.f;
    }
  }
};

}  // namespace

extern "C" {

// Returns the cudaGetLastError() code after the launches (0 = success).
// tab: float32 table, row stride `stride` elements.
int adjoint_launch(const void* tab, int stride, const float* alpha, int WR, int n, int nv,
                   const int* pairs, int npairs, const int* singles, int nsingles, float* part,
                   int nchunks, int chunk, float* out, void* stream) {
  if (!windows_fit(npairs, nsingles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NDFT_ADJ(W)                                                                                   \
  launch_adjoint<W>(TableSrc<W>{static_cast<const float*>(tab), n, stride}, alpha, n, nv, pairs, \
                    npairs, singles, nsingles, part, nchunks, chunk, out, st)
  if (WR == 16) NDFT_ADJ(16);
  else if (WR == 32) NDFT_ADJ(32);
  else return (int)cudaErrorInvalidValue;
#undef NDFT_ADJ
  return (int)cudaGetLastError();
}

int forward_launch(const void* tab, int stride, int WR, int n, const int* pairs, int npairs,
                   const float* G2, const int* singles, int nsingles, const float* G1, int nsets,
                   float* y, void* stream) {
  if (!windows_fit(npairs, nsingles)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NDFT_FWD(W)                                                                                 \
  launch_forward<W>(TableSrc<W>{static_cast<const float*>(tab), n, stride}, n, pairs, npairs, G2, \
                    singles, nsingles, G1, nsets, y, st)
  if (WR == 16) NDFT_FWD(16);
  else if (WR == 32) NDFT_FWD(32);
  else return (int)cudaErrorInvalidValue;
#undef NDFT_FWD
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
