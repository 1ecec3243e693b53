// One pass of the K-mode cutoff search on Hopper: per query row, the
// number of db rows within each of four per-row thresholds, and the
// row's max distance, over the first n_valid db rows.
//
// Replaces smafa_tpu/ops/distance.py:_statsN_pass, the XLA program (not
// a Pallas kernel) that smafa_tpu's kmode_phase1 runs kstats_steps(L)
// times per batch (3 at 60 bp). Per query row r over db rows
// w < n_valid:
//
//   dist      = seq_len - q_emb[r] . db_emb[w] - zc[w]
//   cnt[p][r] = #{w : dist <= ts[p][r]}        p = 0..3
//   mx[r]     = max_w dist                     (-1 if n_valid == 0)
//
// Rows at or past n_valid never count, even where they are live rows of
// the buffer: they are masked, not merely poisoned, because mx is the
// cutoff whenever K exceeds the window count.
//
// What bounds it on the H100: the int8 contraction, 2 * B * n_valid * 4L
// operations over 1,979 TOP/s (4.17 ms at 16384 x (2^20 + 37), L = 60).
// The first version reached 5.85% of that at 60 bp and 1.8% at 150 bp:
// its grid of ceil(B / 128) blocks each walked every row (32 blocks on
// 132 SMs at B = 4096, so its time was flat in B), it fed mma.sync from
// 32-bit shared loads behind load-then-sync copies, and its epilogue
// re-derived each distance and branched on n_valid in every tile.
//
// What the design does about it:
// 1. Db splits over the live rows only: ceil(B / 256) query tiles x S
//    db splits, S from ops/min2.py's live_plan over the ceil(n_valid /
//    64) live 64-row blocks. With S > 1 the splits write int32 partials
//    [5, S, B] (4 counts, then mx) to scratch the wrapper allocates, and
//    kstats_merge_kernel, launched right after on the same stream, sums
//    the counts and takes the max of mx; no atomics. Up to 64 bp (EP <=
//    256) kstats_split_kernel runs the split-W tile of split_tile.cuh
//    (mma.sync; the whole query rows in shared memory, two blocks an
//    SM), split y walking tiles tiles * y / S up to tiles * (y + 1) / S.
//    Past it kstats_wgchunk_kernel runs the warp-specialised wgmma tile
//    of wg_long.cuh (see min2.cu, lever 3; persistent blocks over query
//    tiles x splits, TMA copies into an mbarrier ring) over the live
//    blocks (its W is their rows): form (a), the block's 256 query rows
//    resident, up to EP = 640 (160 bp), form (b), query and db chunks
//    streamed, 256 x 128 a step, past it. They replace the K-chunked
//    split tile (mma.sync fed by ldmatrix, cp.async; 22.1% of the bound
//    at 4096 x 2,621,440, 150 bp, 11.7% at 1024 x 32,768, 300 bp, and
//    13.6% there at 29,903 bp; chip_smoke.py, NVIDIA H100 80GB HBM3,
//    700 W), which replaced the first loop (1.8% at 150 bp).
// 2. An epilogue in scores: each accumulator plus its column's zc (on
//    the split tile the mma.sync accumulators start at it) is the
//    window's score (matches, in [0, L] for the port's operands), and
//    dist <= ts iff score >= seq_len - ts, a per-row bound. The max
//    distance is seq_len minus the min score, folded two accumulators
//    per DPX __vimin3_s32. Only
//    the last live tile (64-row block) can be partial: its owner masks
//    its columns >= n_valid in a separate epilogue, and every other tile
//    runs branch-free. The four lanes that share a row merge by xor
//    shuffles.
// 3. Counting four probes at once below 64 bp (tally_bytes): the four
//    bounds of a row sit in the bytes of one register, one IMAD compares
//    a score with all four, and masked sums count three scores a step,
//    ~2.7 instructions an accumulator where a compare and a predicated
//    add per probe (tally_pairs, which windows of 64 bp and more take:
//    their scores reach past 63, and every long route) take 8. The
//    counts live as 16-bit pairs flushed every PAIR_TILES tiles. The
//    epilogue's instruction count, not the pipe it runs on nor where its
//    state lives, set the split tile's time at 60 bp:
//    tools/torch_kstats_variant_probe.py builds patched copies of this
//    file (int counts, one block per SM, bounds in shared memory) and
//    times them beside it (PERF.md, section 6).
//
#include <climits>

#include "split_tile.cuh"
#include "wg_long.cuh"

namespace {

using namespace split_tile;

constexpr int PROBES = 4;  // smafa_tpu_torch/ops/keys.py KSTATS_PROBES
constexpr int MERGE_THREADS = 256;
// 16 columns a lane per row and tile: 4095 tiles keep a 16-bit count
// below 65536.
constexpr int PAIR_TILES = 4095;

// A lane's counts of its 4 rows as 16-bit pairs: count p of row i is
// half p % 2 of cnt[i][p / 2].
using Pairs = int[4][2];

// c += inc where s >= bound: a compare and a predicated add.
__device__ __forceinline__ void add_if_ge(int& c, int s, int bound, int inc) {
  asm("{\n\t.reg .pred p;\n\tsetp.ge.s32 p, %1, %2;\n\t@p add.s32 %0, %0, %3;\n\t}"
      : "+r"(c)
      : "r"(s), "r"(bound), "r"(inc));
}

// Fold a tile's scores into a lane's counts and minima, a compare and a
// predicated add per probe. acc[m][n][2h + c] is row i = 2m + h, tile
// column 8n + 2t + c. MASKED: only columns below rem are real (the last
// live tile).
template <bool MASKED>
__device__ __forceinline__ void tally_pairs(const int (&acc)[2][8][4],
                                            const int (&bound)[4][PROBES],
                                            Pairs& cnt, int (&mn)[4], int t,
                                            int rem) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int s[2], sm[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[c] = sm[c] = acc[i >> 1][n][2 * (i & 1) + c];
        if (MASKED && n * 8 + 2 * t + c >= rem) {
          s[c] = INT_MIN;  // below every bound: no count
          sm[c] = INT_MAX;
        }
#pragma unroll
        for (int p = 0; p < PROBES; ++p) {
          add_if_ge(cnt[i][p >> 1], s[c], bound[i][p], p & 1 ? 0x10000 : 1);
        }
      }
      mn[i] = __vimin3_s32(mn[i], sm[0], sm[1]);
    }
  }
}

// The same in byte lanes (scores in [0, 63], so L <= 63): bound[i][0]
// packs row i's four probes as bytes 64 - b, b clamped to [0, 64], probe
// 0, 2, 1, 3 from the low byte. One IMAD, d = score * 0x01010101 +
// bound, puts score + 64 - b in [0, 127] into each byte with no carry
// between bytes, so bit 6 of a byte is set iff score >= b. Three masked
// d's add without carry (<= 192 a byte); >> 6 turns the sum into counts,
// folded into u (<= 16 a byte a tile), whose bytes 0, 2 and 1, 3 are
// the pairs cnt[i][0] and cnt[i][1].
template <bool MASKED>
__device__ __forceinline__ void tally_bytes(const int (&acc)[2][8][4],
                                            const int (&bound)[4][PROBES],
                                            Pairs& cnt, int (&mn)[4], int t,
                                            int rem) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned u = 0, sum = 0;
    int sm0 = INT_MAX;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = j >> 1, c = j & 1;
      const int s = acc[i >> 1][n][2 * (i & 1) + c];
      unsigned m = ((unsigned)s * 0x01010101u + (unsigned)bound[i][0]) & 0x40404040u;
      int sm = s;
      if (MASKED && n * 8 + 2 * t + c >= rem) {
        m = 0;
        sm = INT_MAX;
      }
      sum += m;
      if (j % 3 == 2 || j == 15) {
        u += sum >> 6;
        sum = 0;
      }
      if (c == 0) {
        sm0 = sm;
      } else {
        mn[i] = __vimin3_s32(mn[i], sm0, sm);
      }
    }
    cnt[i][0] += (int)(u & 0x00ff00ffu);
    cnt[i][1] += (int)((u >> 8) & 0x00ff00ffu);
  }
}

// Row `row`'s bound of probe p: dist <= ts iff score >= seq_len - ts,
// clamped to INT_MAX (above every score; rows at or past B) or, in byte
// lanes (BYTES), to [0, 64] and stored as 64 - b (tally_bytes packs it).
template <bool BYTES>
__device__ __forceinline__ int row_bound(const int* ts, long row, int B,
                                         int p, int seq_len) {
  const long long b = row < B ? (long long)seq_len - ts[(long)p * B + row]
                              : (long long)INT_MAX;
  return BYTES ? 64 - (int)max(0LL, min(64LL, b))
               : (int)min((long long)INT_MAX, b);
}

// Merge the 4 lanes (t = 0..3) that share each of the lane's rows q0 + g
// + 8i and write split y's partials: the first flush writes the counts,
// later ones add to them; mx from the running minimum score. The
// counts restart at 0.
__device__ __forceinline__ void flush_counts(Pairs& cnt, const int (&mn)[4],
                                             int* cnt_out, int* mx_out,
                                             long q0, int g, int t, int B,
                                             int S, int y, int seq_len,
                                             bool first) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int c[PROBES];
#pragma unroll
    for (int p = 0; p < PROBES; ++p) {
      c[p] = (cnt[i][p >> 1] >> (16 * (p & 1))) & 0xffff;
    }
    int m = mn[i];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
      for (int p = 0; p < PROBES; ++p) c[p] += __shfl_xor_sync(0xffffffffu, c[p], off);
      m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    for (int& x : cnt[i]) x = 0;
    const long row = q0 + g + 8 * i;
    if (t == 0 && row < B) {
#pragma unroll
      for (int p = 0; p < PROBES; ++p) {
        int* o = cnt_out + ((long)p * S + y) * B + row;
        *o = first ? c[p] : *o + c[p];
      }
      mx_out[(long)y * B + row] = seq_len - m;
    }
  }
}

// cnt_out: [4, S, B] count partials (count p of split y at (p * S + y) *
// B), mx_out: [S, B]; with S == 1 the final [4, B] and [B] outputs.
// Split blockIdx.y of gridDim.y = S. BYTES: count in byte lanes
// (tally_bytes), else tally_pairs.
template <bool BYTES>
__global__ void __launch_bounds__(S_THREADS, S_BLOCKS_PER_SM)
    kstats_split_kernel(const int8_t* __restrict__ q,
                        const int8_t* __restrict__ db,
                        const int* __restrict__ zc, const int* __restrict__ ts,
                        int* __restrict__ cnt_out, int* __restrict__ mx_out,
                        int B, int n_valid, int EP, int seq_len) {
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
  const int tiles = (n_valid + S_BN - 1) / S_BN;
  const int S = gridDim.y, y = blockIdx.y;
  const int t_begin = (int)((long)tiles * y / S);
  const int nt = (int)((long)tiles * (y + 1) / S) - t_begin;
  // The last live tile is partial unless n_valid fills it; the last
  // split owns it as its last tile.
  const int rem = n_valid - (tiles - 1) * S_BN;
  const int masked_it = (y == S - 1 && rem < S_BN) ? nt - 1 : -1;

  // The query tile, zero past B, joins the first tile's copy group.
  const long b0 = (long)blockIdx.x * S_BM;
  issue_queries(sA, q, b0, B, EP, stride);
#pragma unroll
  for (int s = 0; s < S_STAGES - 1; ++s) {
    if (s < nt) {
      issue_tile(ring + s * sbytes, db, zc, (long)(t_begin + s) * S_BN, EP,
                 stride);
    }
    cp_async_commit();
  }

  // The per-row bounds: dist <= ts iff score >= seq_len - ts, clamped to
  // INT_MAX (above every score) or, in byte lanes, to [0, 64] and packed
  // as tally_bytes takes them. This lane's rows i = 2m + h are q0 + 16m +
  // g + 8h = q0 + g + 8i.
  auto bound_of = [&](long row, int p) {
    return row_bound<BYTES>(ts, row, B, p, seq_len);
  };
  int bound[4][PROBES];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = q0 + g + 8 * i;
#pragma unroll
    for (int p = 0; p < PROBES; ++p) bound[i][p] = bound_of(row, p);
    if (BYTES) {
      bound[i][0] |= bound[i][2] << 8 | bound[i][1] << 16 | bound[i][3] << 24;
    }
  }
  Pairs cnt = {};
  int mn[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};

  // ldmatrix.x4 row addresses (split_tile.cuh).
  const int b_off = b_frag_offset(lane, stride);
  const int8_t* a_row = a_frag_row(sA, warp, lane, stride);

  for (int c0 = 0; c0 < nt; c0 += PAIR_TILES) {
    const int c1 = min(nt, c0 + PAIR_TILES);
    for (int it = c0; it < c1; ++it) {
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
      acc_from_zc(acc, sZ, t);
      tile_mma(acc, a_row, sD + b_off, stride, nks);
      if constexpr (BYTES) {
        if (it == masked_it) {
          tally_bytes<true>(acc, bound, cnt, mn, t, rem);
        } else {
          tally_bytes<false>(acc, bound, cnt, mn, t, rem);
        }
      } else if (it == masked_it) {
        tally_pairs<true>(acc, bound, cnt, mn, t, rem);
      } else {
        tally_pairs<false>(acc, bound, cnt, mn, t, rem);
      }
    }
    if (!live) continue;
    // The first chunk writes the split's partials, later ones add.
    flush_counts(cnt, mn, cnt_out, mx_out, q0, g, t, B, S, y, seq_len,
                 c0 == 0);
  }
  cp_async_wait<0>();
}

// part: int32 [5, S, B] (the 4 count partials, then mx, of the S splits).
__global__ void kstats_merge_kernel(const int* __restrict__ part,
                                    int* __restrict__ cnt, int* __restrict__ mx,
                                    int B, int S) {
  const int r = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (r >= B) return;
#pragma unroll
  for (int p = 0; p < PROBES; ++p) {
    int c = 0;
    for (int s = 0; s < S; ++s) c += part[((long)p * S + s) * B + r];
    cnt[(long)p * B + r] = c;
  }
  int m = -1;
  for (int s = 0; s < S; ++s) m = max(m, part[((long)PROBES * S + s) * B + r]);
  mx[r] = m;
}

// Long windows (EP > S_KS * 32; scores reach past 63, so counts in
// 16-bit pairs): the epilogue of wg_long.cuh's tile (its interface:
// begin, tile<M> a 64 x 64 block, end). A lane's rows i = 2M + h (row r0
// + 64 M + 8 h) keep their four bounds, their counts as pairs and their
// least score over the lane's columns (8j + 2t + c of every 64-row
// block). Only the last live block can be partial: its tile runs
// masked, columns at or past n_valid scored below every bound and above
// every minimum; every other block is branch-free. The pairs flush
// every PAIR_TILES blocks of an item (form (b)'s steps are two blocks)
// and at its end: the item's first flush writes split y's partials,
// later ones add; the last writes mx.
struct KstatsWg {
  int bound[4][PROBES];
  // 16-bit pairs: count p of row i is half p % 2 of cnt[i][p / 2]
  int cnt[4][2];
  int mn[4];
  const int* ts;
  int* cnt_out;
  int* mx_out;
  int B, S, seq_len, t, last, rem, blocks, y;
  bool flushed;
  long r0;

  __device__ __forceinline__ void begin(long r, const wg_scan::Item& im) {
    r0 = r;
    y = im.y;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = r0 + 64 * (i >> 1) + 8 * (i & 1);
#pragma unroll
      for (int p = 0; p < PROBES; ++p) {
        bound[i][p] = row_bound<false>(ts, row, B, p, seq_len);
      }
      cnt[i][0] = cnt[i][1] = 0;
      mn[i] = INT_MAX;
    }
    blocks = 0;
    flushed = false;
  }

  // Tile M's scores (acc[4j + 2h + c] + z[2j + c]: row 2M + h, column 8j
  // + 2t + c) into the counts and minima of its two rows, a compare and
  // a predicated add a probe; MASKED: only columns below rem count.
  template <int M, bool MASKED>
  __device__ __forceinline__ void tally(const int (&acc)[32],
                                        const int (&z)[16]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 2 * M + h;
        int s[2], sm[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[c] = sm[c] = acc[4 * j + 2 * h + c] + z[2 * j + c];
          if (MASKED && 8 * j + 2 * t + c >= rem) {
            s[c] = INT_MIN;  // below every bound: no count
            sm[c] = INT_MAX;
          }
#pragma unroll
          for (int p = 0; p < PROBES; ++p) {
            add_if_ge(cnt[i][p / 2], s[c], bound[i][p], p % 2 ? 0x10000 : 1);
          }
        }
        mn[i] = __vimin3_s32(mn[i], sm[0], sm[1]);
      }
    }
  }

  // Merge the 4 lanes that share each row; lane t writes row i = t if
  // below B: split y's counts (written by the item's first flush, added
  // by later ones) and, with `final`, its mx. The pairs restart at 0.
  __device__ __forceinline__ void flush(bool final) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int c[PROBES];
#pragma unroll
      for (int p = 0; p < PROBES; ++p) {
        c[p] = (cnt[i][p / 2] >> (p % 2 * 16)) & 0xffff;
      }
      int m = mn[i];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
        for (int p = 0; p < PROBES; ++p) c[p] += __shfl_xor_sync(0xffffffffu, c[p], off);
        m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      cnt[i][0] = cnt[i][1] = 0;
      const long row = r0 + 64 * (i >> 1) + 8 * (i & 1);
      if (t == i && row < B) {
#pragma unroll
        for (int p = 0; p < PROBES; ++p) {
          int* o = cnt_out + ((long)p * S + y) * B + row;
          *o = flushed ? *o + c[p] : c[p];
        }
        if (final) mx_out[(long)y * B + row] = seq_len - m;
      }
    }
    flushed = true;
  }

  template <int M>
  __device__ __forceinline__ void tile(const int (&acc)[32], const int (&z)[16],
                                       int s) {
    if (s == last) {
      tally<M, true>(acc, z);
    } else {
      tally<M, false>(acc, z);
    }
    if (M == 1 && ++blocks == PAIR_TILES) {
      flush(false);
      blocks = 0;
    }
  }

  __device__ __forceinline__ void end(const wg_scan::Item&) { flush(true); }
};

// The long routes (wg_long.cuh), NKP panels a row in form (a), 0 in
// form (b), over the live 64-row blocks: outputs as
// kstats_split_kernel's, split y's partials at y.
template <int NKP>
__global__ void __launch_bounds__(wg_long::THREADS, 1)
    kstats_wgchunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_db,
                          const __grid_constant__ CUtensorMap tm_zc, int T,
                          int S, int R, int nkp, const int* __restrict__ ts,
                          int* __restrict__ cnt_out, int* __restrict__ mx_out,
                          int B, int n_valid, int seq_len) {
  KstatsWg epi;
  epi.ts = ts;
  epi.cnt_out = cnt_out;
  epi.mx_out = mx_out;
  epi.B = B;
  epi.S = S;
  epi.seq_len = seq_len;
  epi.t = threadIdx.x & 3;
  const int live = (n_valid + wg_scan::N - 1) / wg_scan::N;
  epi.rem = n_valid - (live - 1) * wg_scan::N;
  epi.last = epi.rem < wg_scan::N ? live - 1 : -1;
  wg_long::run<NKP>(&tm_q, &tm_db, &tm_zc, B, live * wg_scan::N, T, S, R,
                    nkp, epi);
}

// The split kernel (EP <= S_KS * 32) or the long route's (wg_long.cuh)
// over the live rows, in form (a) up to wg_long::EP_A_MAX; with splits
// > 1 it writes part = [cnt x 4, mx] x [splits, B] and the merge
// follows.
cudaError_t launch_split(const int8_t* q, const int8_t* db, const int* zc,
                         const int* ts, int* cnt, int* mx, int* part, int B,
                         int n_valid, int EP, int seq_len, int splits,
                         cudaStream_t s) {
  const bool direct = splits == 1;
  int* cnt_o = direct ? cnt : part;
  int* mx_o = direct ? mx : part + (long)PROBES * splits * B;
  cudaError_t err;
  if (EP > S_KS * 32) {
    const int live = (n_valid + S_BN - 1) / S_BN * S_BN;
    err = wg_long::by_form(EP, [&](auto form) {
      constexpr int NKP = decltype(form)::value;
      return wg_long::launch<NKP>(kstats_wgchunk_kernel<NKP>, q, db, zc, B,
                                  live, EP, splits, s, ts, cnt_o, mx_o, B,
                                  n_valid, seq_len);
    });
  } else {
    const dim3 grid((B + S_BM - 1) / S_BM, splits);
    const bool bytes = seq_len < 64;  // byte lanes need scores below 64
    const auto kernel = bytes ? &kstats_split_kernel<true> : &kstats_split_kernel<false>;
    const int smem = split_smem(EP);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, S_THREADS, smem, s>>>(q, db, zc, ts, cnt_o, mx_o, B,
                                         n_valid, EP, seq_len);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || direct) return err;
  kstats_merge_kernel<<<(B + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                        0, s>>>(part, cnt, mx, B, splits);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// ts and cnt: int32 [4, B], mx: int32 [B]; part: int32 [5, splits, B]
// scratch when splits > 1 (else unused). Requires EP % 32 == 0,
// W % 64 == 0, 1 <= n_valid <= W, B >= 1, 16-byte aligned q and db
// (and zc past EP = 256, a TMA source),
// 1 <= splits <= ceil(n_valid / 64), and the port's operands
// (ops/distance.py), whose score q . db + zc of a db row below n_valid
// lies in [0, seq_len]. Returns the cudaError_t of the launches.
extern "C" int smafa_kstats(const void* q, const void* db, const void* zc,
                            const void* ts, void* cnt, void* mx, void* part,
                            int B, int n_valid, int EP, int seq_len,
                            int splits, void* stream) {
  if (B < 1 || n_valid < 1) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > (n_valid + S_BN - 1) / S_BN) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_split(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(db),
      static_cast<const int*>(zc), static_cast<const int*>(ts),
      static_cast<int*>(cnt), static_cast<int*>(mx), static_cast<int*>(part),
      B, n_valid, EP, seq_len, splits, static_cast<cudaStream_t>(stream));
}
