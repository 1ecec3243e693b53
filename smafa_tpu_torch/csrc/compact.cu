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
// version (compact_long_kernel below) took the dot products with __dp4a
// on the CUDA cores and reached 2.35% of that bound.
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
// Longer windows (EP > 256) take compact_long_kernel, the first
// version's loop, one split: each thread owns one window and
// accumulates 32 query rows' dot products while K streams through shared
// memory in 128-byte chunks; __ballot_sync packs 32 windows' compares
// into a word.

#include <climits>

#include "scan_tile.cuh"
#include "split_tile.cuh"

namespace {

using namespace split_tile;

constexpr int THREADS = 256;  // long route: windows per block, one per thread
constexpr int QT = 32;        // long route: query rows per block
constexpr int KW = 32;        // long route: K chunk in 32-bit words

// w |= bit where s >= bound: a compare and a predicated OR.
__device__ __forceinline__ void set_if_ge(unsigned& w, int s, int bound,
                                          unsigned bit) {
  asm("{\n\t.reg .pred p;\n\tsetp.ge.s32 p, %1, %2;\n\t@p or.b32 %0, %0, %3;\n\t}"
      : "+r"(w)
      : "r"(s), "r"(bound), "r"(bit));
}

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

  // This lane's rows i = 2m + h are q0 + 16m + g + 8h = q0 + g + 8i.
  // dist <= thresh iff score >= seq_len - thresh (no int overflow: the
  // bound is clamped to INT_MAX, above every score).
  int bound[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = q0 + g + 8 * i;
    bound[i] = row < B ? (int)min((long long)INT_MAX,
                                  (long long)seq_len - thresh[row])
                       : INT_MAX;
  }
  const long words = W >> 5;
  unsigned* out = mask + (q0 + g) * words;  // row i at + 8 * i * words

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
    const int* sZ = reinterpret_cast<const int*>(sD + S_BN * stride);
    // acc[m][n][2h + c]: row i = 2m + h, tile column 8n + 2t + c; it
    // starts at the column's zc and ends as the window's score.
    int acc[2][8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int2 z = *reinterpret_cast<const int2*>(sZ + n * 8 + 2 * t);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        acc[m][n][0] = acc[m][n][2] = z.x;
        acc[m][n][1] = acc[m][n][3] = z.y;
      }
    }
    tile_mma(acc, a_row, sD + b_off, stride, nks);
    // Column 8n + 2t + c is bit 8(n % 4) + 2t + c of the row's word lo
    // (n < 4) or hi (n >= 4): set at 8(n % 4) + c here, shifted by 2t
    // below, then ORed over the four lanes t of the row.
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
    const long w32 = (long)(t_begin + it) * (S_BN / 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned a = lo[i] << (2 * t), b = hi[i] << (2 * t);
      a |= __shfl_xor_sync(0xffffffffu, a, 1);
      b |= __shfl_xor_sync(0xffffffffu, b, 1);
      a |= __shfl_xor_sync(0xffffffffu, a, 2);
      b |= __shfl_xor_sync(0xffffffffu, b, 2);
      if (t == 0 && q0 + g + 8 * i < B) {
        *reinterpret_cast<uint2*>(out + 8 * i * words + w32) = make_uint2(a, b);
      }
    }
  }
  cp_async_wait<0>();
}

// Long windows (EP > S_KS * 32): the first version, one split. A grid
// over (db tile of 256 windows, query tile of 32 rows); db rows padded
// to 33 words in shared memory, so each thread reads its own row without
// bank conflicts, and query words are broadcast.
__global__ void __launch_bounds__(THREADS)
    compact_long_kernel(const int* __restrict__ q, const int* __restrict__ db,
                        const int* __restrict__ zc,
                        const int* __restrict__ thresh, int* __restrict__ mask,
                        int B, int W, int EP, int seq_len) {
  __shared__ int sD[THREADS][KW + 1];
  __shared__ int sQ[QT][KW];
  const int tid = threadIdx.x;
  const long w0 = (long)blockIdx.x * THREADS;
  const long r0 = (long)blockIdx.y * QT;
  const int q_valid = (int)min((long)QT, (long)B - r0);
  const int words = EP / 4;

  int acc[QT];
#pragma unroll
  for (int r = 0; r < QT; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < words; k0 += KW) {
    const int kw = min(KW, words - k0);
    __syncthreads();
    for (int i = tid; i < THREADS * kw; i += THREADS) {
      const int r = i / kw;
      const int c = i - r * kw;
      const long w = w0 + r;
      sD[r][c] = w < W ? db[w * words + k0 + c] : 0;
    }
    for (int i = tid; i < QT * kw; i += THREADS) {
      const int r = i / kw;
      const int c = i - r * kw;
      sQ[r][c] = r < q_valid ? q[(r0 + r) * words + k0 + c] : 0;
    }
    __syncthreads();
    for (int c = 0; c < kw; ++c) {
      const int d = sD[tid][c];
#pragma unroll
      for (int r = 0; r < QT; ++r) acc[r] = __dp4a(sQ[r][c], d, acc[r]);
    }
  }

  const long w = w0 + tid;
  const bool in_db = w < W;
  const int z = in_db ? zc[w] : 0;
  const long n_words = W >> 5;
  const long word = w >> 5;  // the same for the whole warp
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    if (r < q_valid) {  // uniform across the block
      const int dist = seq_len - acc[r] - z;
      const unsigned bits =
          __ballot_sync(0xffffffffu, in_db && dist <= thresh[r0 + r]);
      if ((tid & 31) == 0 && word < n_words) {
        mask[(r0 + r) * n_words + word] = (int)bits;
      }
    }
  }
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// thresh: int32 [B], mask: int32 [B, W / 32]. Requires EP % 32 == 0,
// W % 64 == 0, 16-byte aligned q and db, 1 <= splits <= W / 64 when
// EP <= 256, and splits == 1 and B <= 65535 * 32 when EP > 256. Returns
// the cudaError_t of the launch.
extern "C" int smafa_compact_mask(const void* q, const void* db,
                                  const void* zc, const void* thresh,
                                  void* mask, int B, int W, int EP,
                                  int seq_len, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (EP > S_KS * 32) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((W + THREADS - 1) / THREADS, (B + QT - 1) / QT);
    compact_long_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const int*>(q), static_cast<const int*>(db),
        static_cast<const int*>(zc), static_cast<const int*>(thresh),
        static_cast<int*>(mask), B, W, EP, seq_len);
    return (int)cudaGetLastError();
  }
  if (W % S_BN || splits < 1 || splits > W / S_BN) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = split_smem(EP);
  const cudaError_t err = cudaFuncSetAttribute(
      compact_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  compact_split_kernel<<<dim3((B + S_BM - 1) / S_BM, splits), S_THREADS, smem,
                         s>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(db),
      static_cast<const int*>(zc), static_cast<const int*>(thresh),
      static_cast<unsigned*>(mask), B, W, EP, seq_len);
  return (int)cudaGetLastError();
}
