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
// Longer windows (EP > 256, L > 64) take compact_wgchunk_kernel, the
// same epilogue on the long routes of wg_long.cuh (K chunks of 128 bytes,
// A and B from shared memory): form (a) up to EP = 640 (160 bp) with the
// block's 256 query rows resident and 64-row db steps; form (b) past it
// with query and db chunks streamed together, 256 x 128 a step. They
// replace the K-chunked split tile (mma.sync; 23.3% of the bound at 150
// bp, 14.2% at 29,903 bp; since gone), which replaced the first
// version's loop there (__dp4a on the CUDA cores, one split; 2.5%).

#include <climits>

#include "wg_long.cuh"
#include "wg_scan.cuh"

namespace {

// w |= bit where s >= bound: a compare and a predicated OR.
__device__ __forceinline__ void set_if_ge(unsigned& w, int s, int bound,
                                          unsigned bit) {
  asm("{\n\t.reg .pred p;\n\tsetp.ge.s32 p, %1, %2;\n\t@p or.b32 %0, %0, %3;\n\t}"
      : "+r"(w)
      : "r"(s), "r"(bound), "r"(bit));
}

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

  // dist <= thresh iff score >= seq_len - thresh (no int overflow: the
  // bound is clamped to INT_MAX, above every score; rows at or past B
  // get INT_MAX).
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

// The long routes (wg_long.cuh), NKP panels a row in form (a), 0 in
// form (b); mask as compact_wg_kernel's.
template <int NKP>
__global__ void __launch_bounds__(wg_long::THREADS, 1)
    compact_wgchunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_db,
                           const __grid_constant__ CUtensorMap tm_zc, int T,
                           int S, int R, int nkp,
                           const int* __restrict__ thresh,
                           unsigned* __restrict__ mask, int B, int W,
                           int seq_len) {
  MaskWg epi;
  epi.thresh = thresh;
  epi.mask = mask;
  epi.B = B;
  epi.seq_len = seq_len;
  epi.t = threadIdx.x & 3;
  epi.words = W >> 5;
  epi.wide = (W & 127) == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  wg_long::run<NKP>(&tm_q, &tm_db, &tm_zc, B, W, T, S, R, nkp, epi);
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// thresh: int32 [B], mask: int32 [B, W / 32]. Requires EP % 32 == 0,
// W % 64 == 0, 16-byte aligned q, db and zc and 1 <= splits <= W / 64:
// the short route's kernel (wg_scan.cuh) up to EP = wg_scan::EP_MAX, the
// long route's (wg_long.cuh) past it, in form (a) up to
// wg_long::EP_A_MAX. Returns the cudaError_t of the launch.
extern "C" int smafa_compact_mask(const void* q, const void* db,
                                  const void* zc, const void* thresh,
                                  void* mask, int B, int W, int EP,
                                  int seq_len, int splits, void* stream) {
  if (W % wg_scan::N || splits < 1 || splits > W / wg_scan::N) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* tp = static_cast<const int*>(thresh);
  auto* mp = static_cast<unsigned*>(mask);
  if (EP <= wg_scan::EP_MAX) {
    return (int)wg_scan::by_panels(EP, [&](auto panels) {
      constexpr int NKP = decltype(panels)::value;
      return wg_scan::launch<NKP>(compact_wg_kernel<NKP>, db, zc, B, W, EP,
                                  splits, s, qp, tp, mp, B, W, EP, seq_len,
                                  splits);
    });
  }
  return (int)wg_long::by_form(EP, [&](auto form) {
    constexpr int NKP = decltype(form)::value;
    return wg_long::launch<NKP>(compact_wgchunk_kernel<NKP>, q, db, zc, B, W,
                                EP, splits, s, tp, mp, B, W, seq_len);
  });
}
