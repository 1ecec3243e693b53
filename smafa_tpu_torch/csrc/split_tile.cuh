// The split-W tile of kstats.cu and min_count.cu (min2.cu and compact.cu
// run theirs on the wgmma tiles of wg_scan.cuh and wg_long.cuh; dist_block.cu
// borrows its copy and mma helpers): a block of S_WARPS warps owns S_BM
// query rows (32 per warp) and walks a contiguous run of whole S_BN-row
// db tiles (one db split of a ceil(B / S_BM) x S grid); mma.sync
// fragments come from ldmatrix.x4 on shared rows padded by S_PAD bytes,
// so each B fragment feeds two products and each A fragment eight. Two
// forms:
//
// - The short route (EP <= S_KS * 32 bytes, L <= 64): the block's query
//   rows, whole, stay in shared memory and whole db tiles arrive with
//   their zc by cp.async in an S_STAGES ring (issue_tile,
//   issue_queries, tile_mma, split_smem).
// - The K-chunked route (EP > 256, L > 64): a row is walked
//   in chunks of K_CHUNK = 256 bytes (the last one may be partial: EP =
//   608 at 150 bp gives 8, 8 and 3 k-steps), the accumulators live
//   across the chunks of one db tile and the caller's epilogue runs
//   after its last chunk (kchunk_scan). What bounded the first
//   versions' loops there: ceil(B / 128) blocks with one db split (32
//   blocks on 132 SMs at B = 4096), 32-bit shared fragment loads, and
//   load-then-sync copies that never overlapped the products. A whole
//   row no longer fits beside a ring of whole tiles (256 x 624 B of
//   queries plus 2 x 40 KB at 150 bp is past the 227 KB a block can
//   use), hence the chunks, in two forms, both one block an SM
//   (K_BLOCKS_PER_SM):
//   (a) the query rows stay resident (S_BM x (EP + 16) B) and db
//       chunks stream through a KQ_STAGES ring; each db byte copied
//       feeds 512 operations, as on the short route. It serves
//       EP <= RESIDENT_EP_MAX (L <= 168): 212,736 B at 150 bp.
//   (b) each of KS_STAGES stages holds a query chunk (S_BM x 272 B)
//       beside the db chunk (S_BN x 272 B), so any EP fits (174,592 B);
//       each byte copied feeds ~102 operations.
//   A db tile's zc goes with its first chunk to a small ring of its
//   own, indexed by tile, so the epilogue finds it after the chunk's
//   stage has been reused.
//   Measured (tools/torch_long_route_probe.py --forms, one call; NVIDIA
//   H100 80GB HBM3, 700 W): at 150 bp form (a) ran min2 at 32768 x
//   2,621,440 in 260 ms and kstats at 4096 in 29.3 ms (the first loops
//   593 and 351 ms); form (b) forced there took 509 and 60.7 ms, twice
//   (a). Its copies hold it back: five times (a)'s bytes a chunk, ~87 KB
//   through one SM's L2 port for 8.4 M operations. So (b) serves only
//   the widths (a) cannot, at 11-15% of the bound (300 and 29,903 bp,
//   chip_smoke.py), and (a) at 22-28% (150 bp).

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
// The K-chunked route (EP > S_KS * 32); ops/min2.py mirrors the EP limit
// of form (a) and the blocks an SM.
constexpr int K_CHUNK = S_KS * 32;          // bytes of a row a chunk
constexpr int K_STRIDE = K_CHUNK + S_PAD;   // shared row stride of a chunk
constexpr int K_BLOCKS_PER_SM = 1;          // resident blocks, either form
constexpr int KQ_STAGES = 3;                // (a): db chunk ring depth
constexpr int KS_STAGES = 2;                // (b): query + db chunk ring
constexpr int RESIDENT_EP_MAX = 672;        // (a) fits 232,448 B up to here
constexpr int BIG_KEY = 0x7fffffff;         // the empty packed key

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

// 16 bytes, or 16 zero bytes where !valid (g is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* s, const void* g,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "r"(valid ? 16 : 0)
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

// acc[m][n][2h + c] = 0, or the zc of tile column 8n + 2t + c (sZ the
// tile's 64 zc), so that after the products it holds the window's score.
__device__ __forceinline__ void zero_acc(int (&acc)[2][8][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0;
    }
  }
}

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

// The same with the query and db rows at one stride (the short route).
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

// ---- The K-chunked route ----

// Start the copy of bytes [k0, k0 + K_CHUNK) of db rows [w0, w0 + 64)
// (bytes at or past ep skipped) into st at K_STRIDE, and with the first
// chunk (k0 == 0) the rows' zc into sz.
__device__ __forceinline__ void issue_db_chunk(int8_t* st, int* sz,
                                               const int8_t* db,
                                               const int* zc, long w0,
                                               long ep, int k0) {
  const int v = threadIdx.x & 15;
  if (k0 + v * 16 < ep) {
#pragma unroll
    for (int r = threadIdx.x >> 4; r < S_BN; r += S_THREADS / 16) {
      cp_async16(st + r * K_STRIDE + v * 16, db + (w0 + r) * ep + k0 + v * 16);
    }
  }
  if (k0 == 0 && threadIdx.x < S_BN) {
    cp_async4(sz + threadIdx.x, zc + w0 + threadIdx.x);
  }
}

// Start the copy of vpr 16-byte vectors from byte k0 of the S_BM query
// rows from row b0 into s (rows `stride` bytes apart); rows at or past B
// zero-filled, bytes at or past ep skipped.
__device__ __forceinline__ void issue_query_rows(int8_t* s, int stride,
                                                 const int8_t* q, long b0,
                                                 int B, long ep, int k0,
                                                 int vpr) {
  for (int i = threadIdx.x; i < S_BM * vpr; i += S_THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    const int k = k0 + v * 16;
    if (k >= ep) continue;
    const bool in = b0 + r < B;
    cp_async16_zfill(s + r * stride + v * 16, in ? q + (b0 + r) * ep + k : q,
                     in);
  }
}

// Shared memory of the K-chunked forms: (a) the resident query rows, a
// KQ_STAGES ring of db chunks; (b) a KS_STAGES ring of query and db
// chunks; then each form's ring of tiles' zc.
template <bool QRES>
__host__ __device__ constexpr int kchunk_stage_bytes() {
  return (QRES ? S_BN : S_BM + S_BN) * K_STRIDE;
}

template <bool QRES>
inline int kchunk_smem(int ep) {
  constexpr int stages = QRES ? KQ_STAGES : KS_STAGES;
  return (QRES ? S_BM * (ep + S_PAD) : 0) +
         stages * (kchunk_stage_bytes<QRES>() + S_BN * (int)sizeof(int));
}

// The K-chunked scan of db tiles [t_begin, t_begin + nt) against the
// block's S_BM query rows from row b0, in form (a) (QRES) or (b). Per
// db tile it calls init(acc, sZ) before the first chunk and epi(acc,
// sZ, it) after the last (it = 0..nt-1, sZ the tile's 64 zc), on warps
// with `live` set; every warp copies and syncs. Chunk j = it * nkc + c
// sits in stage j % stages, issued stages - 1 chunks ahead, one
// __syncthreads a chunk.
template <bool QRES, class Init, class Epi>
__device__ __forceinline__ void kchunk_scan(int8_t* smem, const int8_t* q,
                                            const int8_t* db, const int* zc,
                                            long b0, int B, int EP,
                                            int t_begin, int nt, bool live,
                                            Init init, Epi epi) {
  constexpr int stages = QRES ? KQ_STAGES : KS_STAGES;
  constexpr int sbytes = kchunk_stage_bytes<QRES>();
  const int qstride = QRES ? EP + S_PAD : K_STRIDE;
  int8_t* ring = smem + (QRES ? S_BM * qstride : 0);
  int* sZ = reinterpret_cast<int*>(ring + stages * sbytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nkc = (EP + K_CHUNK - 1) / K_CHUNK;
  const int J = nt * nkc;

  // A stage: the db chunk, then (b) the query chunk.
  auto issue = [&](int j) {
    const int it = j / nkc, k0 = (j - it * nkc) * K_CHUNK;
    int8_t* st = ring + (j % stages) * sbytes;
    if (!QRES) issue_query_rows(st + S_BN * K_STRIDE, K_STRIDE, q, b0, B, EP, k0, 16);
    issue_db_chunk(st, sZ + (it % stages) * S_BN, db, zc,
                   (long)(t_begin + it) * S_BN, EP, k0);
  };
  // (a): the whole query rows join the first chunk's copy group.
  if (QRES) issue_query_rows(smem, qstride, q, b0, B, EP, 0, EP / 16);
#pragma unroll
  for (int s = 0; s < stages - 1; ++s) {
    if (s < J) issue(s);
    cp_async_commit();
  }

  // ldmatrix.x4 row addresses (a: into the resident rows; b: into a
  // stage's query chunk).
  const int b_off = b_frag_offset(lane, K_STRIDE);
  const int8_t* a_res = a_frag_row(smem, warp, lane, qstride);
  const int a_off = a_frag_row(ring + S_BN * K_STRIDE, warp, lane, K_STRIDE) - ring;
  int acc[2][8][4];
  int it = 0, c = 0;
  for (int j = 0; j < J; ++j) {
    cp_async_wait<stages - 2>();
    __syncthreads();  // chunk j visible; stage (j - 1) % stages free
    {
      const int nx = j + stages - 1;
      if (nx < J) issue(nx);
      cp_async_commit();
    }
    if (live) {
      const int8_t* st = ring + (j % stages) * sbytes;
      const int* z = sZ + (it % stages) * S_BN;
      if (c == 0) init(acc, z);
      const int nks = min(S_KS, (EP - c * K_CHUNK) >> 5);
      if (QRES) {
        chunk_mma(acc, a_res + c * K_CHUNK, qstride, st + b_off, K_STRIDE, nks);
      } else {
        chunk_mma(acc, st + a_off, K_STRIDE, st + b_off, K_STRIDE, nks);
      }
      if (c == nkc - 1) epi(acc, z, it);
    }
    if (++c == nkc) {
      c = 0;
      ++it;
    }
  }
  cp_async_wait<0>();
}

}  // namespace split_tile
