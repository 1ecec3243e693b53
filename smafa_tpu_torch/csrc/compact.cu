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
// What the design does about it. Each (row, window) bit belongs to one
// block, so there is no merge and no scratch; a window is a hit iff
// score >= seq_len - thresh[r], a per-row bound kept in registers (rows
// at or past B get INT_MAX), and the epilogue is a compare and a
// predicated OR per score into the row's words, then an OR of the four
// lanes that share a row (two xor shuffles per word).
//
// Up to 64 bp (EP <= 256, compact_wg_kernel, epilogue MaskWg): the
// warp-specialised wgmma tile of wg_scan.cuh (TMA copies into an
// mbarrier ring; two consumer warpgroups of 128 query rows running
// wgmma m64n64k32 s8 against each 64-row db step and the epilogue in
// turn; persistent blocks over query tiles x db splits from
// ops/min2.py's short_plan). Lane t of a quad stores row t of the
// quad's four, after both m64 tiles of a step: 16 bytes a row for two
// steps where rows are 16-byte aligned (Wp % 128 == 0), else 8 bytes a
// step; no word past Wp / 32 and no row past B is written.
//
// Longer windows (EP > 256, L > 64) take compact_chunk_kernel: ceil(B /
// 256) query tiles x S db splits (ops/min2.py launch_plan), the same
// compare and OR (MaskRows, accumulators started at the columns' zc,
// one 8-byte store a row and tile) on the K-chunked split tile
// (split_tile.cuh kchunk_scan), one block an SM, form (a) with the
// query rows resident up to EP = 672 (168 bp) and form (b) past it. It
// replaces the first version's loop there (__dp4a on the CUDA cores,
// one split; 2.5% of the bound at 150 bp).

#include <climits>

#include "split_tile.cuh"
#include "wg_scan.cuh"

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

// The short route's epilogue (wg_scan.cuh): a lane's rows i = 2M + h
// (row r0 + 64 M + 8 h) of the mask, and their bounds. Lane t stores
// row i = t of its quad: the two words of a step, or, where rows are
// 16-byte aligned (W % 128 == 0), the four words of steps 2k and 2k + 1
// in one store.
struct MaskWg {
  const int* thresh;
  unsigned* mask;
  int B, seq_len, t, s0, s1;
  long words;
  bool wide;
  int bound[4];
  unsigned* out;  // the words of the row lane t stores (null past B)
  uint2 cur, prev;

  // dist <= thresh iff score >= seq_len - thresh, as MaskRows::init.
  __device__ __forceinline__ void begin(long r0, const wg_scan::Item& im) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = r0 + 64 * (i >> 1) + 8 * (i & 1);
      bound[i] = row < B ? (int)min((long long)INT_MAX,
                                    (long long)seq_len - thresh[row])
                         : INT_MAX;
    }
    const long row = r0 + 64 * (t >> 1) + 8 * (t & 1);
    out = row < B ? mask + row * words : nullptr;
    s0 = im.s0;
    s1 = im.s1;
  }

  // Step s's two words of the tile's rows (acc[4j + 2h + c]: row h,
  // column 8j + 2t + c, bit 8(j % 4) + 2t + c of word j / 4): a compare
  // and a predicated OR an element, the quad's lanes ORed; after tile
  // 1, the stores.
  template <int M>
  __device__ __forceinline__ void tile(const int (&acc)[32], const int (&z)[16],
                                       int s) {
    unsigned lo[2] = {0u, 0u}, hi[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          set_if_ge(j < 4 ? lo[h] : hi[h], acc[4 * j + 2 * h + c] + z[2 * j + c],
                    bound[2 * M + h], 1u << (8 * (j & 3) + c));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned a = lo[h] << (2 * t), b = hi[h] << (2 * t);
      a |= __shfl_xor_sync(0xffffffffu, a, 1);
      b |= __shfl_xor_sync(0xffffffffu, b, 1);
      a |= __shfl_xor_sync(0xffffffffu, a, 2);
      b |= __shfl_xor_sync(0xffffffffu, b, 2);
      if (t == 2 * M + h) cur = make_uint2(a, b);
    }
    if (M == 1 && out != nullptr) {
      if (!wide) {
        *reinterpret_cast<uint2*>(out + 2L * s) = cur;
      } else if (s & 1) {
        if (s > s0) {
          *reinterpret_cast<uint4*>(out + 2L * (s - 1)) =
              make_uint4(prev.x, prev.y, cur.x, cur.y);
        } else {
          *reinterpret_cast<uint2*>(out + 2L * s) = cur;
        }
      } else if (s + 1 == s1) {
        *reinterpret_cast<uint2*>(out + 2L * s) = cur;
      } else {
        prev = cur;
      }
    }
  }

  __device__ __forceinline__ void end(const wg_scan::Item&) {}
};

// mask: [B, W / 32] words; S db splits.
template <int NKP>
__global__ void __launch_bounds__(wg_scan::THREADS, 1)
    compact_wg_kernel(const __grid_constant__ CUtensorMap tm_db,
                      const __grid_constant__ CUtensorMap tm_zc,
                      const int8_t* __restrict__ q,
                      const int* __restrict__ thresh,
                      unsigned* __restrict__ mask, int B, int W, int EP,
                      int seq_len, int S) {
  MaskWg epi;
  epi.thresh = thresh;
  epi.mask = mask;
  epi.B = B;
  epi.seq_len = seq_len;
  epi.t = threadIdx.x & 3;
  epi.words = W >> 5;
  epi.wide = (W & 127) == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  wg_scan::run<NKP>(&tm_db, &tm_zc, q, B, W / wg_scan::N, EP, S, epi);
}

// Long windows (EP > S_KS * 32): the K-chunked split tile, form (a) with
// the query rows resident (QRES) or (b) streamed, with MaskRows' init
// and epilogue. Every warp copies and syncs inside
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
// W % 64 == 0, 16-byte aligned q, db and zc and 1 <= splits <= W / 64:
// the wgmma kernel up to EP = wg_scan::EP_MAX, the K-chunked one past
// it, in form (a) up to RESIDENT_EP_MAX. Returns the cudaError_t of the
// launch.
extern "C" int smafa_compact_mask(const void* q, const void* db,
                                  const void* zc, const void* thresh,
                                  void* mask, int B, int W, int EP,
                                  int seq_len, int splits, void* stream) {
  if (W % S_BN || splits < 1 || splits > W / S_BN) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* tp = static_cast<const int*>(thresh);
  auto* mp = static_cast<unsigned*>(mask);
  if (EP <= wg_scan::EP_MAX) {
    return (int)(EP <= wg_tile::PANEL
                     ? wg_scan::launch<1>(compact_wg_kernel<1>, db, zc, B, W,
                                          EP, splits, s, qp, tp, mp, B, W, EP,
                                          seq_len, splits)
                     : wg_scan::launch<2>(compact_wg_kernel<2>, db, zc, B, W,
                                          EP, splits, s, qp, tp, mp, B, W, EP,
                                          seq_len, splits));
  }
  const dim3 grid((B + S_BM - 1) / S_BM, splits);
  return (int)(EP <= RESIDENT_EP_MAX
                   ? launch(compact_chunk_kernel<true>, kchunk_smem<true>(EP),
                            grid, q, db, zc, thresh, mask, B, W, EP, seq_len,
                            s)
                   : launch(compact_chunk_kernel<false>,
                            kchunk_smem<false>(EP), grid, q, db, zc, thresh,
                            mask, B, W, EP, seq_len, s));
}
