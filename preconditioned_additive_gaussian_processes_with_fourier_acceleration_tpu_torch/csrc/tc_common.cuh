// Pieces shared by the tensor-core NDFT kernels of packed_ndft_tc.cu (bf16
// tables) and packed_ndft_regen.cu (regenerated phases): asynchronous copies
// into shared memory, the fixed-order sum of the per-chunk partial slices
// (the split-K second pass of the adjoints), and the 3xTF32 primitives of
// the regenerating adjoint and forward (tf32 rounding, the two-part split,
// mma.sync.m16n8k8.tf32).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; bytes < 16 zero-fills the rest of the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int RED_X = 32, RED_Y = 16;  // outputs x slice groups per reduce block

// out[o] = sum over the nchunks slices of part[c][o] in a fixed order: slice
// group y adds slices y, y + RED_Y, ... and the groups are added in order
// (RED_Y independent load streams per output instead of one long one)
__global__ void __launch_bounds__(RED_X * RED_Y) reduce_slices_kernel(const float* __restrict__ part,
                                                                      int nchunks, size_t S,
                                                                      float* __restrict__ out) {
  __shared__ float red[RED_Y][RED_X];
  const size_t o = (size_t)blockIdx.x * RED_X + threadIdx.x;
  float s = 0.f;
  if (o < S)
    for (int c = threadIdx.y; c < nchunks; c += RED_Y) s += part[(size_t)c * S + o];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && o < S) {
    float tot = 0.f;
#pragma unroll
    for (int y = 0; y < RED_Y; ++y) tot += red[y][threadIdx.x];
    out[o] = tot;
  }
}

// u rounded to tf32 (to nearest, ties away from zero: cvt.rna.tf32.f32's
// value for a finite u, by an integer add and a mask -- the instruction
// spends three where this spends two) as a float32 bit pattern whose low 13
// bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float u) { return (__float_as_uint(u) + 0x1000u) & 0xffffe000u; }

// u = big + small to about 2^-22 |u|: small = tf32(u - big), from the
// rounded big (u - big is exact: both lie within a factor 2 of each other)
__device__ __forceinline__ void split_tf32(float u, uint32_t& big, uint32_t& small) {
  big = tf32_rna(u);
  small = tf32_rna(__fsub_rn(u, __uint_as_float(big)));
}

// D += A B, A 16x8 (row), B 8x8 (col), tf32 in, float32 accumulate
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

void launch_reduce_slices(const float* part, int nchunks, size_t S, float* out, cudaStream_t st) {
  reduce_slices_kernel<<<(unsigned)((S + RED_X - 1) / RED_X), dim3(RED_X, RED_Y), 0, st>>>(part, nchunks, S,
                                                                                         out);
}

}  // namespace
