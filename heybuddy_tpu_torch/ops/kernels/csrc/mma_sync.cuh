// Warp-level tensor-core products for Hopper, sm_90a, shared by the trunk
// (trunk_pool.cuh: K2, K4) and the mel DFT (mel_common.cuh: K1, K3, K4).
//
// The product is mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}: a warp
// multiplies a 16 x 16 tile of A by a 16 x 8 tile of B, both of 16-bit
// floats (bf16 for the trunk and the bf16 DFT, fp16 for the split DFT), and
// adds the 16 x 8 float32 result into its accumulators. A product of two
// bf16 or two fp16 values is exact in float32, so a sum over k differs from a
// float32 FMA chain only in the order of its additions; a row of the result
// depends only on that row of A, on B and on the order of the k-steps, never
// on where the row sits in a tile. Two kernels that call `mma_k16` over the
// same k-steps in the same order therefore give the same bits for the same
// row.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane = 4 g + q:
//   A (16 x 16, row-major): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..), a2 = (g,
//     2q+8..), a3 = (g+8, 2q+8..), each a pair of bf16;
//   B (16 x 8, k-major): b0 = (k 2q..2q+1, n g), b1 = (k 2q+8.., n g);
//   C (16 x 8 float32): c0, c1 = (g, 2q..2q+1), c2, c3 = (g+8, 2q..2q+1).
// Both operands come from shared memory by ldmatrix: A row-major as it is,
// B from a row-major (k, n) tile with .trans. For either, lane l gives the
// address of row (l & 15), column (l >> 4) * 8 of the 16 x 16 block it loads;
// a row stride that is an odd multiple of 16 bytes modulo 128 keeps the eight
// rows of each 8 x 8 matrix on different banks.
//
// `cp_async16` stages 16-byte pieces of a tile from global into shared memory
// without passing through registers; `cp_async_commit` / `cp_async_wait`
// close and wait for a group of them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 x 16 A block of 16-bit values at `base` (row stride `ld` elements) -> a0..a3
template <typename T>
__device__ __forceinline__ void ldmatrix_a(const T* base, int ld, uint32_t (&a)[4]) {
  static_assert(sizeof(T) == 2, "16-bit operands");
  const int lane = threadIdx.x & 31;
  const uint32_t addr = smem_addr(base + (lane & 15) * ld + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// 16 (k) x 16 (n) block of a row-major (k, n) tile at `base` -> the B
// fragments of two n8 tiles: (b[0], b[1]) for columns 0..7, (b[2], b[3]) for 8..15
template <typename T>
__device__ __forceinline__ void ldmatrix_b2(const T* base, int ld, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr = smem_addr(base + (lane & 15) * ld + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// 16 (k) x 8 (n) block -> the B fragments of one n8 tile
template <typename T>
__device__ __forceinline__ void ldmatrix_b1(const T* base, int ld, uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr = smem_addr(base + (lane & 15) * ld);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// c += a (16 x 16) . b (16 x 8), bf16 operands, float32 accumulation
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with fp16 operands
__device__ __forceinline__ void mma_16816_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of NT consecutive n8 tiles from a 16-row k-slice of a
// row-major (k, n) tile: columns col0 .. col0 + 8 NT - 1.
template <int NT, typename T>
__device__ __forceinline__ void load_b(const T* tile, int ld, int col0, uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int j = 0; j + 1 < NT; j += 2) {
    uint32_t r[4];
    ldmatrix_b2(tile + col0 + 8 * j, ld, r);
    b[j][0] = r[0];
    b[j][1] = r[1];
    b[j + 1][0] = r[2];
    b[j + 1][1] = r[3];
  }
  if constexpr (NT % 2 == 1) ldmatrix_b1(tile + col0 + 8 * (NT - 1), ld, b[NT - 1]);
}

// One k-step of a warp's MT x NT tile of m16n8 products:
//   acc[i][j] += A[row0 + rstep i .. + 16, k-slice] . B[k-slice, col0 + 8 j .. + 8]
// `a_tile` points at column k0 of row 0 of A (row stride lda), `b_tile` at
// row k0 of B (row stride ldb). M-tiles at or past `m_active` are skipped
// (warp-uniform: their rows are padding).
template <int MT, int NT>
__device__ __forceinline__ void mma_k16(const bf16* a_tile, int lda, int row0, int rstep,
                                        int m_active, const bf16* b_tile, int ldb, int col0,
                                        float (&acc)[MT][NT][4]) {
  uint32_t b[NT][2];
  load_b<NT>(b_tile, ldb, col0, b);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= m_active) break;
    uint32_t a[4];
    ldmatrix_a(a_tile + (row0 + rstep * i) * lda, lda, a);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_16816(acc[i][j], a, b[j][0], b[j][1]);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// Accumulator element e of tile (i, j) sits at row (e >> 1) * 8 + g and
// column 2 q + (e & 1) of that tile.
__device__ __forceinline__ int frag_row(int e) { return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int frag_col(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma
