// fp32-accurate products on Hopper's tensor cores (3xTF32) and the
// asynchronous global -> shared copies that feed them. Shared by the FLAME
// blendshape forward (blendshapes.cu) and backward (blendshapes_bwd.cu).
//
// 3xTF32. Each fp32 operand x is split once, when its fragment is read from
// shared memory: hi = x rounded to tf32 (to nearest, ties away from zero, 13
// bits dropped: what cvt.rna.tf32.f32 computes, here as an integer add and
// mask, without cvt's Inf/NaN guard, which the finite FLAME data does not
// need), lo = x - hi (exact in fp32), truncated to tf32 by clearing the same
// 13 bits, which is how the MMA reads it. A product is then
//   a*b ~= a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,
// issued small terms first into one fp32 accumulator with
// mma.sync.m16n8k8.tf32. Each tf32 x tf32 product is exact in fp32; what is
// dropped is a_lo*b_lo (at most 2^-22 |a*b|) and the bits that truncation
// clears from each lo (at most 2^-21 |a*b| each), so a product keeps about
// 20 of fp32's 24 bits in the worst case and the sum is accumulated in fp32
// (tests/test_torch_kernels.py emulates the scheme in numpy at the FLAME
// width and measures it against an fp64 product).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace d3d {

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d (16x8) += a (16x8, row-major fragment) * b (8x8, column fragment). Not
// volatile: the compiler may interleave independent MMAs.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += a * b[j] for the NT fragments of one row of a warp tile, in
// 3xTF32: the three terms of a product go into one accumulator, small terms
// first, and each term is issued for all NT fragments before the next, so
// that NT independent MMAs separate two that depend on each other.
template <int NT>
__device__ __forceinline__ void mma_3xtf32_row(float (&acc)[NT][4], const uint32_t (&a_hi)[4],
                                               const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[NT][2],
                                               const uint32_t (&b_lo)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], a_lo, b_hi[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], a_hi, b_lo[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], a_hi, b_hi[j]);
}

// The A fragment of m16n8k8 from a [m][k] tile with row stride ld, split:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), with g the
// lane's group (lane / 4) and t its index in the group (lane % 4). `p`
// points at element (g, t) of the 16x8 fragment.
__device__ __forceinline__ void load_a_frag(const float* p, int ld, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * ld], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * ld + 4], hi[3], lo[3]);
}

// copies `bytes` (0 to 16) and zero-fills the rest of the 16
__device__ __forceinline__ void cp_async_16(float* smem, const float* gmem, int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of a ROWS x COLS tile of a row-major fp32 matrix (leading
// dimension ld): rows r0.., columns c0.., into shared memory at row stride
// LDS. Elements at rows >= r_end or columns >= c_end land as zeros. VEC
// copies 16 bytes at a time and needs ld and c0 to be multiples of 4 and
// `src` 16-byte aligned; otherwise each element is copied on its own, which
// takes any row stride (a FLAME row is 15,069 floats: 60,276 bytes, 4 mod
// 16). VEC is a compile-time choice, so that a kernel carries one path.
template <int ROWS, int COLS, int LDS, int THREADS, bool VEC>
__device__ __forceinline__ void copy_tile_async(float* dst, const float* src, int ld, int r0, int r_end, int c0,
                                                int c_end) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int PER_ROW = COLS / 4, TOTAL = ROWS * PER_ROW;
#pragma unroll
    for (int i = 0; i < (TOTAL + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (TOTAL % THREADS == 0 || c < TOTAL) {
        const int r = c / PER_ROW, q = (c % PER_ROW) * 4;
        const int bytes = r0 + r < r_end ? 4 * max(0, min(4, c_end - c0 - q)) : 0;
        cp_async_16(dst + r * LDS + q, bytes > 0 ? src + static_cast<size_t>(r0 + r) * ld + c0 + q : src, bytes);
      }
    }
  } else {
    constexpr int TOTAL = ROWS * COLS;
#pragma unroll
    for (int i = 0; i < (TOTAL + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (TOTAL % THREADS == 0 || c < TOTAL) {
        const int r = c / COLS, q = c % COLS;
        const bool ok = r0 + r < r_end && c0 + q < c_end;
        cp_async_4(dst + r * LDS + q, ok ? src + static_cast<size_t>(r0 + r) * ld + c0 + q : src, ok);
      }
    }
  }
}

// Whether rows `ld` floats apart starting at `p` can be copied 16 bytes at a time.
inline bool rows_aligned16(const void* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && ld % 4 == 0;
}

}  // namespace d3d
