// The warpgroup matrix multiply of Hopper (sm_90a) in TF32, A from
// registers and B from shared memory through a descriptor:
//   wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32  D, {a0..a3}, desc_b, scale_d, 1, 1
// D (64 x N float32, N / 2 registers a thread) = A (64 x 8) B (8 x N)
// + (scale_d ? D : 0), for N = 8, 16, 64, 128.  Each takes the
// accumulator as a register array of NA floats and writes its N / 2
// registers from the compile-time offset OFF, so one array holds several
// widths (wgmma_rows: a tile of N = 136 runs as 128 + 8).  Fragments (PTX
// ISA, wgmma register layouts; warp q of the warpgroup holds rows
// 16 q + lane / 4 and 16 q + lane / 4 + 8):
//   A: a0 (row, k = lane % 4), a1 (row + 8, k), a2 (row, k + 4), a3 (row + 8, k + 4),
//      tf32 bit patterns (float32 with the low 13 bits zero);
//   D: d[4 j + e] at row + 8 ((e / 2) % 2), column 8 j + 2 (lane % 4) + e % 2.
// B: N rows of 8 tf32 values (K-major: the PTX ISA allows no transpose for
// tf32), 128-byte swizzled rows, 8-row groups 1024 bytes apart (sw128_desc).
// Issue after wgmma_fence(); commit and wait with wgmma_commit() /
// wgmma_wait0().

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// a shared-memory operand of 128-byte swizzled, K-major rows: start address,
// leading offset 1 (unused by a K-major swizzled layout), 1024 bytes between
// 8-row groups, swizzle mode 1 (128 bytes); the operand 1024-byte aligned
// for the swizzle's phase, plus 32 bytes (2 units) per 8-deep k-step
// within the row and 128 bytes (8 units) per row
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

template <int OFF, int NA>
__device__ __forceinline__ void wgmma_n8(float (&d)[NA], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  static_assert(OFF + 4 <= NA, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int OFF, int NA>
__device__ __forceinline__ void wgmma_n16(float (&d)[NA], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  static_assert(OFF + 8 <= NA, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int OFF, int NA>
__device__ __forceinline__ void wgmma_n64(float (&d)[NA], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  static_assert(OFF + 32 <= NA, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int OFF, int NA>
__device__ __forceinline__ void wgmma_n128(float (&d)[NA], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  static_assert(OFF + 64 <= NA, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The widest B tile wgmma_rows takes, and its accumulator's registers
constexpr int WGMMA_ROWS_MAX = 144;
constexpr int WGMMA_ROWS_ACC = WGMMA_ROWS_MAX / 2;

// D = A B (+ D when scale_d) over the N = NT rows of B, NT one of 64, 72,
// 128, 136 and 144: one instruction per part, each at a fixed slice of d:
// NT >= 128 runs 128 at d[0, 64) and its 16 or 8 at [64, ..); 64 and 72
// run 64 at [0, 32) and their 8 at [56, 60).  A part's B rows follow
// those of the wider one (wgmma_cols: its first column).
__device__ __forceinline__ constexpr int wgmma_cols(int nt, int width) { return nt & ~(2 * width - 1); }

template <int NT, int NA>
__device__ __forceinline__ void wgmma_rows(float (&d)[NA], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  static_assert(NA >= WGMMA_ROWS_ACC, "accumulator narrower than the widest tile");
  static_assert(NT == 64 || NT == 72 || NT == 128 || NT == 136 || NT == 144, "no such N tile");
  if constexpr (NT >= 128) {  // 8 descriptor units (128 bytes) a B row
    wgmma_n128<0>(d, a, desc, scale_d);
    if constexpr ((NT & 16) != 0) wgmma_n16<64>(d, a, desc + 128 * 8, scale_d);
    if constexpr ((NT & 8) != 0) wgmma_n8<64>(d, a, desc + 128 * 8, scale_d);
  } else {
    wgmma_n64<0>(d, a, desc, scale_d);
    if constexpr ((NT & 8) != 0) wgmma_n8<56>(d, a, desc + 64 * 8, scale_d);
  }
}

}  // namespace
