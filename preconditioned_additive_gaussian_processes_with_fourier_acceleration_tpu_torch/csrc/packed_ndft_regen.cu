// Phase-regenerating packed NDFT kernels for Hopper (sm_90a), plain C
// interface.
//
// The "doubling" and "direct" modes of the JAX package's ops/pallas_ndft.py
// `_adjoint_kernel` / `_forward_kernel` (phase sources `_build_T6_doubling`
// and `_build_T6`): a block reads the f32 coordinates x (Dtot, n) of its
// points and generates cos/sin(2 pi p x) for p < P itself, into the
// shared-memory tiles of the adjoint and into the registers of the forward,
// instead of reading them from a table.  The contraction and the
// deterministic two-stage chunk reduction are those of packed_ndft.cuh.
//
//   DIRECT    one sincospif(2 p x) per mode (exact argument: 2 p is an
//             integer, so sin/cos(pi * 2 p x) never forms 2 pi p x);
//   DOUBLING  one sincospif(2 x), then rows [have, 2 have) = rows
//             [0, have) rotated by e^{i have 2 pi x}, the rotator from row
//             have/2 by the double-angle identity -- the recurrence of
//             _build_T6_doubling, stopped at P.
//
// Widths: the fused path keeps the Nyquist mode, so WR = 2P = N + 2 (34 at
// N = 32, 18 at N = 16).  The adjoint tiles at WR rounded up to 36 / 20 with
// zero phases in the pad columns.
//
// What bounds them on an H100: the coordinates are Dtot * 4 bytes a point
// (8 MB at n = 2e5, ten rows) instead of a table of Dtot * WR * 2 bytes, so
// the traffic is negligible; the phases cost one sincospif per point and
// coordinate row (DOUBLING) or P of them (DIRECT), which each block pays
// again per window and right-hand-side tile, and the contraction the same
// f32 FMAs as the table kernels.  The FMA rate bounds them.

#include "packed_ndft.cuh"

namespace {

enum PhaseGen { DOUBLING = 0, DIRECT = 1 };

// Rows [HAVE, HAVE + TAKE) = rows [0, TAKE) rotated by e^{i HAVE theta}, the
// rotator from row HAVE/2 by the double-angle identity; then the next block.
// A template recursion, so every index is a compile-time constant and the
// rows stay in registers.
template <int P, int HAVE, int W>
__device__ __forceinline__ void grow_doubling(float (&o)[W]) {
  if constexpr (HAVE < P) {
    constexpr int TAKE = HAVE < P - HAVE ? HAVE : P - HAVE;
    const float ch = o[HAVE / 2], sh = o[P + HAVE / 2];
    const float ck = ch * ch - sh * sh, sk = 2.f * ch * sh;
#pragma unroll
    for (int k = 0; k < TAKE; ++k) {
      o[HAVE + k] = o[k] * ck - o[P + k] * sk;
      o[P + HAVE + k] = o[P + k] * ck + o[k] * sk;
    }
    grow_doubling<P, 2 * HAVE, W>(o);
  }
}

// o[0, P) = cos(2 pi p x), o[P, 2P) = sin(2 pi p x), o[2P, W) = 0.
template <int WR, int GEN, int W>
__device__ __forceinline__ void phases(float x, float (&o)[W]) {
  constexpr int P = WR / 2;
  static_assert(P >= 2 && W >= WR, "unsupported width");
  if constexpr (GEN == DIRECT) {
#pragma unroll
    for (int p = 0; p < P; ++p) sincospif(2.f * p * x, &o[P + p], &o[p]);
  } else {
    o[0] = 1.f;
    o[P] = 0.f;
    sincospif(2.f * x, &o[P + 1], &o[1]);
    grow_doubling<P, 2, W>(o);
  }
#pragma unroll
  for (int a = WR; a < W; ++a) o[a] = 0.f;
}

template <int WR, int GEN>
struct RegenSrc {
  const float* x;  // (Dtot, n) coordinates
  int n;

  template <int W>
  __device__ __forceinline__ void column(int j, int i, bool live, float (&out)[W]) const {
    phases<WR, GEN>(live ? __ldg(x + (size_t)j * n + i) : 0.f, out);
#pragma unroll
    for (int a = 0; a < W; ++a) out[a] = live ? out[a] : 0.f;
  }

  // One thread per point and coordinate row: threads [0, TP) generate L0
  // and write its alpha-scaled copies, threads [TP, 2 TP) generate L1.
  template <typename C>
  __device__ __forceinline__ void stage_pair(float (*sAL)[C::RBW + 4], float (*sL1)[C::WRP + 4],
                                             int ja, int jb, const float* __restrict__ alpha,
                                             int nv, int r0, int i0, int i_end, int t) const {
    static_assert(2 * TP <= NT, "one thread per point and row");
    if (t >= 2 * TP) return;
    const int ii = t % TP, i = i0 + ii;
    const bool live = i < i_end;
    float col[C::WRP];
    column(t < TP ? ja : jb, i, live, col);
    if (t < TP) {
#pragma unroll 1
      for (int r = 0; r < C::RB; ++r) {
        const float ar = (live && r0 + r < nv) ? alpha[(size_t)(r0 + r) * n + i] : 0.f;
#pragma unroll
        for (int a = 0; a < C::WRP; ++a) sAL[ii][r * C::WRP + a] = ar * col[a];
      }
    } else {
#pragma unroll
      for (int a = 0; a < C::WRP; ++a) sL1[ii][a] = col[a];
    }
  }

  template <int LD>
  __device__ __forceinline__ void stage_single(float (*sL)[LD], int j, int i0, int i_end, int t) const {
    if (t >= TP) return;
    const int i = i0 + t;
    float col[WR];
    column(j, i, i < i_end, col);
#pragma unroll
    for (int a = 0; a < WR; ++a) sL[t][a] = col[a];
  }
};

}  // namespace

extern "C" {

// Returns the cudaGetLastError() code after the launches (0 = success).
int adjoint_launch(const float* x, int phase_gen, const float* alpha, int WR, int n,
                   int nv, const int* pairs, int npairs, const int* singles,
                   int nsingles, float* part, int nchunks, int chunk, float* out,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NDFT_ADJ(W, G)                                                                        \
  launch_adjoint<W>(RegenSrc<W, G>{x, n}, alpha, n, nv, pairs, npairs, singles, nsingles, part, \
                    nchunks, chunk, out, st)
  if (phase_gen == DOUBLING) {
    if (WR == 18) NDFT_ADJ(18, DOUBLING);
    else if (WR == 34) NDFT_ADJ(34, DOUBLING);
    else return (int)cudaErrorInvalidValue;
  } else if (phase_gen == DIRECT) {
    if (WR == 18) NDFT_ADJ(18, DIRECT);
    else if (WR == 34) NDFT_ADJ(34, DIRECT);
    else return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef NDFT_ADJ
  return (int)cudaGetLastError();
}

int forward_launch(const float* x, int phase_gen, int WR, int n, const int* pairs,
                   int npairs, const float* G2, const int* singles, int nsingles,
                   const float* G1, int nsets, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NDFT_FWD(W, G) \
  launch_forward<W>(RegenSrc<W, G>{x, n}, n, pairs, npairs, G2, singles, nsingles, G1, nsets, y, st)
  if (phase_gen == DOUBLING) {
    if (WR == 18) NDFT_FWD(18, DOUBLING);
    else if (WR == 34) NDFT_FWD(34, DOUBLING);
    else return (int)cudaErrorInvalidValue;
  } else if (phase_gen == DIRECT) {
    if (WR == 18) NDFT_FWD(18, DIRECT);
    else if (WR == 34) NDFT_FWD(34, DIRECT);
    else return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef NDFT_FWD
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
