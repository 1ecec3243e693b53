// Tile primitives of the scan kernels. mma_s8 (the int8 tensor-core
// product, mma.sync.m16n8k32 s8.s8 -> s32) and BIG_KEY serve every
// kernel, through split_tile.cuh. The rest (the block shape, load_tile,
// pick_kc, smem_bytes) is the first versions' loop, which only the long
// routes (L > 64) of compact.cu and min_count.cu still run: a block owns
// BM query rows, one 16-row slab per warp, and walks the whole db in
// tiles of BN rows, loaded then synced, K streamed in KC_STREAM-byte
// chunks when the query tile does not fit. min2.cu and kstats.cu run
// the K-chunked split tile there instead (split_tile.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_tile {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16;       // query rows per block
constexpr int BN = 64;               // db rows per shared-memory tile
constexpr int NT = BN / 8;           // mma n-tiles per db tile
constexpr int PAD = 16;              // bytes of padding per shared row
constexpr int KC_STREAM = 512;       // K chunk when the query tile streams
constexpr int SMEM_RESIDENT_MAX = 200 * 1024;
constexpr int BIG_KEY = 0x7fffffff;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [row0, row0 + nrows) x bytes [k0, k0 + kc) of a row-major
// int8 matrix (row length ep) into shared memory with row stride
// `stride`; rows at or past `valid` are zero-filled. 16-byte accesses.
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g,
                                          long row0, int nrows, int valid,
                                          int ep, int k0, int kc,
                                          int stride) {
  const int vec_per_row = kc / 16;
  const int total = nrows * vec_per_row;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / vec_per_row;
    const int v = i - r * vec_per_row;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < valid) {
      val = *reinterpret_cast<const int4*>(g + (row0 + r) * (long)ep + k0 +
                                           v * 16);
    }
    *reinterpret_cast<int4*>(s + r * stride + v * 16) = val;
  }
}

// Widest K chunk that keeps the query tile resident in shared memory
// (the whole row), or KC_STREAM when it does not fit.
inline int pick_kc(int ep) {
  const bool fits =
      (long)(BM + BN) * (ep + PAD) + BN * (long)sizeof(int) <= SMEM_RESIDENT_MAX;
  return fits ? ep : KC_STREAM;
}

inline size_t smem_bytes(int kc) {
  return (size_t)(BM + BN) * (kc + PAD) + BN * sizeof(int);
}

}  // namespace scan_tile
