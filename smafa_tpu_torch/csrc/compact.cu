// The hit bitmask of a compaction pass on Hopper (best-hit rows with more
// than two ties, and K-mode enumeration).
//
// Replaces smafa_tpu/ops/pallas_scan.py:_compact_kernel (entry
// compact_mask_pallas). Same contract: for query row r and db row w < W,
//
//   dist = seq_len - q_emb[r] . db_emb[w] - zc[w]
//   bit (w % 32) of mask[r, w / 32] is set  iff  dist <= thresh[r]
//
// with thresh = -1 turning a row off and padding rows (zc = -1, zero
// embedding) at distance seq_len + 1, above every legal threshold. The
// mask is stored as int32 words with the uint32 bit order of the TPU
// kernel.
//
// What bounds it on the H100: the int8 contraction, 2 * B * W * 4L
// operations over 1,979 TOP/s, which is 1.04 ms at 4096 x 2^20 and
// 2.08 ms at 8192 x 2^20 (L = 60). Its bytes (the db and its zc once,
// the mask B * W / 8 once) take 0.24 and 0.40 ms at 3.35 TB/s. The first
// version took the dot products with __dp4a on the CUDA cores and
// reached 2.35% of that bound.
//
// What the design does about it (compact_split_kernel): it runs min2's
// tensor-core tile and main loop (split_tile.cuh; see min2.cu, lever 3):
// ceil(B / 256) query tiles x S db splits, S from ops/min2.py's
// split_count, each split a contiguous run of whole 64-row db tiles.
// Each (row, window) bit belongs to one block, so there is no merge and
// no scratch. The mma.sync accumulators start from the columns' zc, so
// each ends as the window's score (matches), and a window is a hit iff
// score >= seq_len - thresh[r], a per-row bound kept in registers (rows
// at or past B get INT_MAX). The epilogue is a compare and a predicated
// OR per accumulator into the row's two words of the tile, an OR of the
// four lanes that share a row (two xor shuffles per word), and one 8-byte
// store per row and tile: a quarter of a 32-byte sector, which L2 merges
// with the next three tiles' stores before it writes the sector back.
// The store takes ~8% of the kernel's time; keeping four tiles' words
// in the quad and storing each row's 32 bytes at once saved 1-2% for 88
// bytes of spills, so the simple store stays (PERF.md, section 6).
//
// Longer windows (EP > 256, L > 64) take compact_chunk_kernel: the same
// grid, init and epilogue (MaskRows) on the K-chunked split tile
// (split_tile.cuh kchunk_scan), one block an SM, form (a) with the query
// rows resident up to EP = 672 (168 bp) and form (b) past it. It
// replaces the first version's loop there (__dp4a on the CUDA cores,
// one split; 2.5% of the bound at 150 bp).

#include <climits>

#include "split_tile.cuh"

namespace {

using namespace split_tile;

// w |= bit where s >= bound: a compare and a predicated OR.
__device__ __forceinline__ void set_if_ge(unsigned& w, int s, int bound,
                                          unsigned bit) {
  asm("{\n\t.reg .pred p;\n\tsetp.ge.s32 p, %1, %2;\n\t@p or.b32 %0, %0, %3;\n\t}"
      : "+r"(w)
      : "r"(s), "r"(bound), "r"(bit));
}

// A lane's rows i = 2m + h (row q0 + 16m + g + 8h = q0 + g + 8i) of the
// mask: their bounds and where their words start.
struct MaskRows {
  int bound[4];
  unsigned* out;  // row i's words at out + 8 * i * words
  long words;

  // dist <= thresh iff score >= seq_len - thresh (no int overflow: the
  // bound is clamped to INT_MAX, above every score; rows at or past B
  // get INT_MAX).
  __device__ __forceinline__ void init(const int* thresh, unsigned* mask,
                                       long q0, int g, int B, int W,
                                       int seq_len) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = q0 + g + 8 * i;
      bound[i] = row < B ? (int)min((long long)INT_MAX,
                                    (long long)seq_len - thresh[row])
                         : INT_MAX;
    }
    words = W >> 5;
    out = mask + (q0 + g) * words;
  }

  // The epilogue of db tile `tile` (acc[m][n][2h + c]: row i = 2m + h,
  // tile column 8n + 2t + c, started at the column's zc, so it holds the
  // window's score). Column 8n + 2t + c is bit 8(n % 4) + 2t + c of the
  // row's word lo (n < 4) or hi (n >= 4): set at 8(n % 4) + c here,
  // shifted by 2t below, then ORed over the four lanes t of the row, and
  // one 8-byte store a row.
  __device__ __forceinline__ void tile(const int (&acc)[2][8][4], int t,
                                       long tile, long q0g, int B) {
    unsigned lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          set_if_ge(n < 4 ? lo[i] : hi[i], acc[i >> 1][n][2 * (i & 1) + c],
                    bound[i], 1u << (8 * (n & 3) + c));
        }
      }
    }
    const long w32 = tile * (S_BN / 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned a = lo[i] << (2 * t), b = hi[i] << (2 * t);
      a |= __shfl_xor_sync(0xffffffffu, a, 1);
      b |= __shfl_xor_sync(0xffffffffu, b, 1);
      a |= __shfl_xor_sync(0xffffffffu, a, 2);
      b |= __shfl_xor_sync(0xffffffffu, b, 2);
      if (t == 0 && q0g + 8 * i < B) {
        *reinterpret_cast<uint2*>(out + 8 * i * words + w32) = make_uint2(a, b);
      }
    }
  }
};

// mask: [B, W / 32] words; split blockIdx.y of gridDim.y.
__global__ void __launch_bounds__(S_THREADS, S_BLOCKS_PER_SM)
    compact_split_kernel(const int8_t* __restrict__ q,
                         const int8_t* __restrict__ db,
                         const int* __restrict__ zc,
                         const int* __restrict__ thresh,
                         unsigned* __restrict__ mask, int B, int W, int EP,
                         int seq_len) {
  extern __shared__ __align__(16) int8_t smem[];
  const int stride = EP + S_PAD;
  const int sbytes = stage_bytes(stride);
  int8_t* sA = smem;  // the block's S_BM query rows
  int8_t* ring = smem + S_BM * stride;
  const int nks = EP >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID: fragment row / db column
  const int t = lane & 3;   // mma threadID_in_group
  const long q0 = (long)blockIdx.x * S_BM + warp * 32;
  const bool live = q0 < B;  // the warp has a row below B
  const int tiles = W / S_BN;
  const int t_begin = (int)((long)tiles * blockIdx.y / gridDim.y);
  const int nt = (int)((long)tiles * (blockIdx.y + 1) / gridDim.y) - t_begin;

  // The query tile, zero past B, joins the first tile's copy group.
  issue_queries(sA, q, (long)blockIdx.x * S_BM, B, EP, stride);
#pragma unroll
  for (int s = 0; s < S_STAGES - 1; ++s) {
    if (s < nt) {
      issue_tile(ring + s * sbytes, db, zc, (long)(t_begin + s) * S_BN, EP,
                 stride);
    }
    cp_async_commit();
  }

  MaskRows rows;
  rows.init(thresh, mask, q0, g, B, W, seq_len);
  // ldmatrix.x4 row addresses (split_tile.cuh).
  const int b_off = b_frag_offset(lane, stride);
  const int8_t* a_row = a_frag_row(sA, warp, lane, stride);

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<S_STAGES - 2>();
    __syncthreads();  // tile it visible; stage (it - 1) % S_STAGES free
    {
      const int nx = it + S_STAGES - 1;
      if (nx < nt) {
        issue_tile(ring + (nx % S_STAGES) * sbytes, db, zc,
                   (long)(t_begin + nx) * S_BN, EP, stride);
      }
      cp_async_commit();
    }
    if (!live) continue;  // the last query tile's rows past B
    const int8_t* sD = ring + (it % S_STAGES) * sbytes;
    int acc[2][8][4];
    acc_from_zc(acc, reinterpret_cast<const int*>(sD + S_BN * stride), t);
    tile_mma(acc, a_row, sD + b_off, stride, nks);
    rows.tile(acc, t, t_begin + it, q0 + g, B);
  }
  cp_async_wait<0>();
}

// Long windows (EP > S_KS * 32): the K-chunked split tile, form (a) with
// the query rows resident (QRES) or (b) streamed, on the split kernel's
// grid, init and epilogue. Every warp copies and syncs inside
// kchunk_scan; only warps with a row below B run the products.
template <bool QRES>
__global__ void __launch_bounds__(S_THREADS, K_BLOCKS_PER_SM)
    compact_chunk_kernel(const int8_t* __restrict__ q,
                         const int8_t* __restrict__ db,
                         const int* __restrict__ zc,
                         const int* __restrict__ thresh,
                         unsigned* __restrict__ mask, int B, int W, int EP,
                         int seq_len) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID: fragment row / db column
  const int t = lane & 3;   // mma threadID_in_group
  const long q0 = (long)blockIdx.x * S_BM + warp * 32;
  const int tiles = W / S_BN;
  const int t_begin = (int)((long)tiles * blockIdx.y / gridDim.y);
  const int nt = (int)((long)tiles * (blockIdx.y + 1) / gridDim.y) - t_begin;

  MaskRows rows;
  rows.init(thresh, mask, q0, g, B, W, seq_len);
  kchunk_scan<QRES>(
      smem, q, db, zc, (long)blockIdx.x * S_BM, B, EP, t_begin, nt, q0 < B,
      [&](int (&acc)[2][8][4], const int* sZ) { acc_from_zc(acc, sZ, t); },
      [&](const int (&acc)[2][8][4], const int*, int it) {
        rows.tile(acc, t, t_begin + it, q0 + g, B);
      });
}

template <class Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const void* q,
                   const void* db, const void* zc, const void* thresh,
                   void* mask, int B, int W, int EP, int seq_len,
                   cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, S_THREADS, smem, s>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(db),
      static_cast<const int*>(zc), static_cast<const int*>(thresh),
      static_cast<unsigned*>(mask), B, W, EP, seq_len);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// thresh: int32 [B], mask: int32 [B, W / 32]. Requires EP % 32 == 0,
// W % 64 == 0, 16-byte aligned q and db and 1 <= splits <= W / 64: the
// split kernel up to EP = S_KS * 32, the K-chunked one past it, in form
// (a) up to RESIDENT_EP_MAX. Returns the cudaError_t of the launch.
extern "C" int smafa_compact_mask(const void* q, const void* db,
                                  const void* zc, const void* thresh,
                                  void* mask, int B, int W, int EP,
                                  int seq_len, int splits, void* stream) {
  if (W % S_BN || splits < 1 || splits > W / S_BN) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + S_BM - 1) / S_BM, splits);
  if (EP <= S_KS * 32) {
    return (int)launch(compact_split_kernel, split_smem(EP), grid, q, db, zc,
                       thresh, mask, B, W, EP, seq_len, s);
  }
  return (int)(EP <= RESIDENT_EP_MAX
                   ? launch(compact_chunk_kernel<true>, kchunk_smem<true>(EP),
                            grid, q, db, zc, thresh, mask, B, W, EP, seq_len,
                            s)
                   : launch(compact_chunk_kernel<false>,
                            kchunk_smem<false>(EP), grid, q, db, zc, thresh,
                            mask, B, W, EP, seq_len, s));
}
