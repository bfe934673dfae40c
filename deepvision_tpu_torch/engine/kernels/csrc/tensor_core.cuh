// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_fwd.cu, flash_bwd.cu, paged_chunk.cu): shared-memory addresses,
// the XOR swizzle of a bf16 tile, cp.async copies, ldmatrix, mma.sync
// m16n8k16 (bf16 x bf16 -> fp32) and bf16 packing.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): lane l of a warp holds the
// accumulator elements of rows l / 4 and l / 4 + 8, columns 2 * (l % 4) and
// 2 * (l % 4) + 1 of each 8-column n-tile; packed to bf16 pairs, the
// accumulators of two neighbouring n-tiles are exactly the A fragment of a
// 16-deep k step, so a probability tile never leaves registers.
#pragma once

#include <math.h>

#include "common.cuh"

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte address of 16-byte chunk c of row r in a swizzled [rows][HD] bf16
// tile: chunk ^ (row & 7), or at HD 32 (4 chunks a row) chunk ^ ((row >> 1)
// & 3), so the 8 rows an ldmatrix reads fall in 8 different bank groups.
template <int HD>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  const int sw = HD >= 64 ? (r & 7) : ((r >> 1) & 3);
  return base + static_cast<uint32_t>(r * HD + ((c ^ sw) << 3)) * 2u;
}

// 16 bytes from global to shared memory; with valid false the copy reads
// nothing (src-size 0) and zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on the tensor cores (m16n8k16, bf16 operands, fp32 sums).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy ROWS rows of HD bf16 (contiguous from src) into a swizzled tile;
// rows at or past `valid` are zero-filled.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int valid, int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
  static_assert((ROWS * CPR) % NT == 0, "tile chunks must divide threads");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int i = tid + it * NT, r = i / CPR, c = i % CPR;
    const bool ok = r < valid;
    cp_async16(tile_addr<HD>(dst, r, c),
               ok ? src + static_cast<size_t>(r) * HD + c * 8 : src, ok);
  }
}
