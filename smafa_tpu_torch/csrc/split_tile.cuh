// The split-W tile of kstats.cu and min_count.cu up to 64 bp (EP <=
// S_KS * 32 bytes; min2.cu and compact.cu run theirs on the wgmma tiles
// of wg_scan.cuh and wg_long.cuh, and past 64 bp kstats.cu and
// min_count.cu run wg_long.cuh's too; dist_block.cu borrows its copy and
// mma helpers): a block of S_WARPS warps owns S_BM query rows (32 per
// warp) and walks a contiguous run of whole S_BN-row db tiles (one db
// split of a ceil(B / S_BM) x S grid); mma.sync fragments come from
// ldmatrix.x4 on shared rows padded by S_PAD bytes, so each B fragment
// feeds two products and each A fragment eight. The block's query rows,
// whole, stay in shared memory and whole db tiles arrive with their zc
// by cp.async in an S_STAGES ring (issue_tile, issue_queries, tile_mma,
// split_smem).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace split_tile {

constexpr int S_WARPS = 8;
constexpr int S_THREADS = S_WARPS * 32;
constexpr int S_BM = S_WARPS * 32;  // query rows per block, 32 per warp
constexpr int S_BN = 64;            // db rows per tile
constexpr int S_KS = 8;             // k-steps of 32 bytes: EP <= 256
constexpr int S_STAGES = 2;         // cp.async ring depth
constexpr int S_BLOCKS_PER_SM = 2;  // resident blocks an SM holds
constexpr int S_PAD = 16;           // bytes of padding per shared row
constexpr int BIG_KEY = 0x7fffffff;  // the empty packed key

// c += a . b: the int8 tensor-core product mma.sync.m16n8k32 s8.s8 -> s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of
// matrix j, and lane l receives 4 bytes of row l / 4 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__host__ __device__ constexpr int stage_bytes(int stride) {
  return S_BN * stride + S_BN * (int)sizeof(int);
}

// Start the copy of db rows [w0, w0 + 64) and their zc into one stage.
// Thread x copies 16-byte chunk x % 16 of rows x / 16 + 16 j.
__device__ __forceinline__ void issue_tile(int8_t* st, const int8_t* db,
                                           const int* zc, long w0, int ep,
                                           int stride) {
  const int v = threadIdx.x & 15;
  if (v * 16 < ep) {
#pragma unroll
    for (int r = threadIdx.x >> 4; r < S_BN; r += S_THREADS / 16) {
      cp_async16(st + r * stride + v * 16, db + (w0 + r) * (long)ep + v * 16);
    }
  }
  if (threadIdx.x < S_BN) {
    int* sz = reinterpret_cast<int*>(st + S_BN * stride);
    cp_async4(sz + threadIdx.x, zc + w0 + threadIdx.x);
  }
}

// Start the copy of the block's S_BM query rows from row b0 into sA,
// rows at or past B zero-filled; it joins the caller's next commit.
__device__ __forceinline__ void issue_queries(int8_t* sA, const int8_t* q,
                                              long b0, int B, int ep,
                                              int stride) {
  for (int i = threadIdx.x; i < S_BM * 16; i += S_THREADS) {
    const int r = i >> 4, v = i & 15;
    if (v * 16 >= ep) continue;
    if (b0 + r < B) {
      cp_async16(sA + r * stride + v * 16, q + (b0 + r) * ep + v * 16);
    } else {
      *reinterpret_cast<int4*>(sA + r * stride + v * 16) = make_int4(0, 0, 0, 0);
    }
  }
}

// A lane's ldmatrix.x4 row addresses. B: matrix j = lane / 8 is n-tile
// j / 2 of a pair, k half j % 2, so regs {0, 1} and {2, 3} are the
// pair's B fragments; the offset is into a db tile. A: matrix j is rows
// 8 (j % 2), k half j / 2 of an m16 tile of the warp's 32 query rows,
// regs 0..3 its A fragment.
__device__ __forceinline__ int b_frag_offset(int lane, int stride) {
  return ((lane >> 4) * 8 + (lane & 7)) * stride + ((lane >> 3) & 1) * 16;
}

__device__ __forceinline__ const int8_t* a_frag_row(const int8_t* sA, int warp,
                                                    int lane, int stride) {
  return sA + (warp * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride +
         (lane >> 4) * 16;
}

// acc[m][n][2h + c] += the dot of the warp's query row 16m + g + 8h with
// column 8n + 2t + c of a db tile, over nks k-steps of 32 bytes: a_row
// is this lane's a_frag_row in rows of a_stride bytes, sDb the db rows
// (b_stride bytes apart) plus this lane's b_frag_offset.
__device__ __forceinline__ void chunk_mma(int (&acc)[2][8][4],
                                          const int8_t* a_row, int a_stride,
                                          const int8_t* sDb, int b_stride,
                                          int nks) {
#pragma unroll
  for (int k = 0; k < S_KS; ++k) {
    if (k < nks) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) ldmatrix_x4(af[m], a_row + m * 16 * a_stride + k * 32);
      uint32_t p[4][4];
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) ldmatrix_x4(p[pr], sDb + pr * 16 * b_stride + k * 32);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t b[2] = {p[n >> 1][2 * (n & 1)], p[n >> 1][2 * (n & 1) + 1]};
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_s8(acc[m][n], af[m], b);
      }
    }
  }
}

// acc[m][n][2h + c] = the zc of tile column 8n + 2t + c (sZ the tile's
// 64 zc), so that after the products it holds the window's score.
__device__ __forceinline__ void acc_from_zc(int (&acc)[2][8][4],
                                            const int* sZ, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int2 z = *reinterpret_cast<const int2*>(sZ + n * 8 + 2 * t);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      acc[m][n][0] = acc[m][n][2] = z.x;
      acc[m][n][1] = acc[m][n][3] = z.y;
    }
  }
}

// The same with the query and db rows at one stride.
__device__ __forceinline__ void tile_mma(int (&acc)[2][8][4],
                                         const int8_t* a_row,
                                         const int8_t* sDb, int stride,
                                         int nks) {
  chunk_mma(acc, a_row, stride, sDb, stride, nks);
}

// Shared memory of a block: the query tile, then the ring of db tiles.
inline int split_smem(int ep) {
  return S_BM * (ep + S_PAD) + S_STAGES * stage_bytes(ep + S_PAD);
}

}  // namespace split_tile
