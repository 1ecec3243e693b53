// The exact int32 distance block of the wide route on Hopper: windows of
// 2^25 - 1 bp or more, where not even one 64-row tile packs a 31-bit key
// (dist << shift) | index, so no packed-key kernel can serve them.
//
// Replaces the XLA block_distances that smafa_tpu runs at these widths
// inside topm_scan (smafa_tpu/ops/distance.py:226, the exact top-M
// sort-merge) and min_scan's pair carry (:1329); no Pallas kernel serves
// them. Contract: for query row b < B and db row w < W,
//
//   dist[b, w] = seq_len - (q_emb[b] . db_emb[w] + zc[w])   (int32 [B, W])
//
// with padding rows (zc = -1, zero embedding) at seq_len + 1.
//
// What bounds it on the H100: bytes. At 2^25 bp a row embeds to EP = 2^27
// bytes, a batch is tens of reads and the db a few hundred rows, so the
// int8 products (2 B W EP operations over 1,979 TOP/s) take a twentieth
// of the bytes ((B + W) EP over 3.35 TB/s): at 16 x 128 rows 0.28 ms of
// operations against 5.76 ms of bytes. A tile grid over B x W alone
// would give 2 blocks (one 64-row query tile x two 64-row db tiles) for
// the 132 SMs.
//
// What the design does about it: split-K. The grid is W / 64 db tiles x
// S splits of the contraction x ceil(B / 64) query tiles, db tiles
// fastest, so the blocks in flight at once share a K range and read its
// query bytes once from memory and again from L2. A block of 4 warps
// (2 x 2 of 32 query rows x 32 db rows) streams its K range in chunks of
// D_KC bytes of its 64 db rows and 64 query rows through a cp.async
// ring of D_STAGES stages, and takes the products with int8 mma.sync
// fed by ldmatrix, query rows at or past B neither copied nor stored. Its int32 partials go to dist with
// one atomicAdd each, onto seq_len - zc[w] written first by
// dist_init_kernel: integer adds are exact in any order, so the result
// does not depend on how the splits interleave. Every byte offset is 64
// bits wide (row * (long)EP); EP itself is an int, so EP < 2^31 (windows
// below 2^29 bp), which ops/dist_block.py checks and names.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

constexpr int D_WARPS = 4;
constexpr int D_THREADS = D_WARPS * 32;
constexpr int D_BM = 64;   // query rows a block (2 warps of 32)
constexpr int D_BN = 64;   // db rows a block (2 warps of 32)
constexpr int D_KC = 128;  // bytes of a row a chunk: 4 k-steps of 32
constexpr int D_PAD = 16;                                // bytes of padding a shared row
constexpr int D_STRIDE = D_KC + D_PAD;                   // 144 B a shared row
constexpr int D_STAGES = 4;                              // cp.async ring depth
constexpr int D_STAGE_BYTES = (D_BN + D_BM) * D_STRIDE;  // db rows, then queries
constexpr int D_SMEM = D_STAGES * D_STAGE_BYTES;         // 73,728 B
constexpr int D_BLOCKS_PER_SM = 3;                       // ops/dist_block.py

// dist[b, w] = seq_len - zc[w] over the whole [B, W] block.
__global__ void dist_init_kernel(int* __restrict__ dist,
                                 const int* __restrict__ zc, long total,
                                 int W, int seq_len) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    dist[i] = seq_len - zc[i % W];
  }
}

// Start the copy of bytes [k0, k0 + D_KC) (bytes at or past EP skipped)
// of db rows [w0, w0 + 64) and of query rows [b0, b0 + 64) below B into
// one stage. Thread x copies 16-byte vector x % 8 of rows x / 8 + 16 j.
__device__ __forceinline__ void issue_chunk(int8_t* st, const int8_t* q,
                                            const int8_t* db, long b0,
                                            long w0, int B, long EP,
                                            long k0) {
  const int v = threadIdx.x & 7;
  const long k = k0 + v * 16;
  if (k >= EP) return;
#pragma unroll
  for (int r = threadIdx.x >> 3; r < D_BN + D_BM; r += D_THREADS / 8) {
    if (r < D_BN) {
      cp_async16(st + r * D_STRIDE + v * 16, db + (w0 + r) * EP + k);
    } else if (b0 + r - D_BN < B) {
      cp_async16(st + r * D_STRIDE + v * 16, q + (b0 + r - D_BN) * EP + k);
    }
  }
}

// dist[b0 .. b0+63, w0 .. w0+63] -= the dots over chunks [c_begin,
// c_end) of D_KC bytes; block (x, y, z) = (db tile, K split, query tile).
__global__ void __launch_bounds__(D_THREADS, D_BLOCKS_PER_SM)
    dist_block_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ db,
                      int* __restrict__ dist, int B, int W, int EP) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // mma groupID: fragment row / db column
  const int t = lane & 3;    // mma threadID_in_group
  const int wm = warp & 1;   // the warp's 32 query rows of the 64
  const int wn = warp >> 1;  // and its 32 db rows
  const long w0 = (long)blockIdx.x * D_BN;
  const long b0 = (long)blockIdx.z * D_BM;
  const bool live = b0 + wm * 32 < B;
  const long nkc = ((long)EP + D_KC - 1) / D_KC;
  const long c_begin = nkc * blockIdx.y / gridDim.y;
  const int J = (int)(nkc * (blockIdx.y + 1) / gridDim.y - c_begin);

  auto issue = [&](int j) {
    issue_chunk(smem + (j % D_STAGES) * D_STAGE_BYTES, q, db, b0, w0, B, EP,
                (c_begin + j) * D_KC);
  };
#pragma unroll
  for (int s = 0; s < D_STAGES - 1; ++s) {
    if (s < J) issue(s);
    cp_async_commit();
  }

  // ldmatrix.x4 row addresses: the warp's B fragments
  // from its 32 db rows, its A fragments from its 32 query rows.
  const int b_off = b_frag_offset(lane, D_STRIDE) + wn * 32 * D_STRIDE;
  const int a_off =
      (int)(a_frag_row(smem + D_BN * D_STRIDE, wm, lane, D_STRIDE) - smem);
  int acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0;
    }
  }
  for (int j = 0; j < J; ++j) {
    cp_async_wait<D_STAGES - 2>();
    __syncthreads();  // chunk j visible; stage (j - 1) % D_STAGES free
    {
      const int nx = j + D_STAGES - 1;
      if (nx < J) issue(nx);
      cp_async_commit();
    }
    if (!live) continue;
    const int8_t* st = smem + (j % D_STAGES) * D_STAGE_BYTES;
    const long k0 = (c_begin + j) * D_KC;
    const int nks = EP - k0 >= D_KC ? D_KC / 32 : (int)((EP - k0) >> 5);
#pragma unroll
    for (int k = 0; k < D_KC / 32; ++k) {
      if (k < nks) {
        uint32_t af[2][4], p[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          ldmatrix_x4(af[m], st + a_off + m * 16 * D_STRIDE + k * 32);
        }
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          ldmatrix_x4(p[pr], st + b_off + pr * 16 * D_STRIDE + k * 32);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t b[2] = {p[n >> 1][2 * (n & 1)],
                                 p[n >> 1][2 * (n & 1) + 1]};
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_s8(acc[m][n], af[m], b);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!live || J <= 0) return;
  // acc[m][n][2h + c]: query row 16m + g + 8h, db row 8n + 2t + c of the
  // warp's 32 x 32.
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = b0 + wm * 32 + 16 * m + g + 8 * h;
      if (row >= B) continue;
      int* out = dist + row * W + w0 + wn * 32 + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          atomicAdd(out + 8 * n + c, -acc[m][n][2 * h + c]);
        }
      }
    }
  }
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// dist: int32 [B, W]. Requires B >= 1, EP % 32 == 0, W % 64 == 0, 16-byte
// aligned q and db, ceil(B / 64) <= 65535 and 1 <= splits <= min(65535,
// ceil(EP / D_KC)). Returns the cudaError_t of the launches.
extern "C" int smafa_dist_block(const void* q, const void* db, const void* zc,
                                void* dist, int B, int W, int EP,
                                int seq_len, int splits, void* stream) {
  const long nkc = ((long)EP + D_KC - 1) / D_KC;
  const long qtiles = ((long)B + D_BM - 1) / D_BM;
  if (B < 1 || W < D_BN || W % D_BN || EP < 32 || EP % 32 || splits < 1 ||
      splits > 65535 || splits > nkc || qtiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long total = (long)B * W;
  const long want = (total + 255) / 256;
  const int init_blocks = (int)(want < 132L * 32 ? want : 132L * 32);
  dist_init_kernel<<<init_blocks, 256, 0, s>>>(
      static_cast<int*>(dist), static_cast<const int*>(zc), total, W,
      seq_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dist_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             D_SMEM);
  if (err != cudaSuccess) return (int)err;
  dist_block_kernel<<<dim3(W / D_BN, splits, (unsigned)qtiles), D_THREADS,
                      D_SMEM, s>>>(static_cast<const int8_t*>(q),
                                   static_cast<const int8_t*>(db),
                                   static_cast<int*>(dist), B, W, EP);
  return (int)cudaGetLastError();
}
