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
//    the counts and takes the max of mx; no atomics.
// 2. The warp-specialised wgmma tiles (see min2.cu, lever 3; persistent
//    blocks over query tiles x splits, TMA copies into an mbarrier ring)
//    over the live blocks (their W is the blocks' rows). Up to 64 bp
//    (EP <= 256) kstats_wg_kernel runs wg_scan.cuh's, the rows' A
//    fragments in registers, m64n64k32 against each 64-row db step.
//    Past it kstats_wgchunk_kernel runs wg_long.cuh's: form (a), the
//    block's 256 query rows resident, up to EP = 640 (160 bp), form
//    (b), query and db chunks streamed, 256 x 128 a step, past it. Both
//    replace the split tile (mma.sync fed by ldmatrix, cp.async; 24.5%
//    of the bound at 16384 x (2^20 + 37), 60 bp, 22.1% at 4096 x
//    2,621,440, 150 bp, and its K-chunked form 11.7% at 1024 x 32,768,
//    300 bp; chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W), which
//    replaced the first loop (1.8% at 150 bp).
// 3. An epilogue in scores: each accumulator plus its column's zc is the
//    window's score (matches, in [0, L] for the port's operands), and
//    dist <= ts iff score >= seq_len - ts, a per-row bound. The max
//    distance is seq_len minus the min score, folded two scores per DPX
//    __vimin3_s32. Only the last live block can be partial: its tile
//    runs masked, and every other block runs branch-free. The four lanes
//    that share a row merge by xor shuffles.
// 4. Counting four probes at once below 64 bp (KstatsWg<true>): the four
//    bounds of a row sit in the bytes of one register, one IMAD compares
//    a score with all four, and masked sums count three scores a step,
//    where a compare and a predicated add per probe (KstatsWg<false>,
//    which windows of 64 bp and more take: their scores reach past 63)
//    take 8 instructions a score. The counts live as 16-bit pairs
//    flushed every PAIR_TILES blocks. The epilogue sets the pace at 60
//    bp: at 16384 x (2^20 + 37) on an H100 the kernel took 8.0 ms, 11.1
//    ms with pairs forced, 4.5 ms with no epilogue
//    (tools/torch_wg_probe.py --probes; PERF.md, section 6).
//
#include <climits>

#include "wg_long.cuh"
#include "wg_scan.cuh"

namespace {

constexpr int PROBES = 4;  // smafa_tpu_torch/ops/keys.py KSTATS_PROBES
constexpr int MERGE_THREADS = 256;
// 16 columns a lane per row and block: 4095 blocks keep a 16-bit count
// below 65536.
constexpr int PAIR_TILES = 4095;

// c += inc where s >= bound: a compare and a predicated add.
__device__ __forceinline__ void add_if_ge(int& c, int s, int bound, int inc) {
  asm("{\n\t.reg .pred p;\n\tsetp.ge.s32 p, %1, %2;\n\t@p add.s32 %0, %0, %3;\n\t}"
      : "+r"(c)
      : "r"(s), "r"(bound), "r"(inc));
}

// Row `row`'s bound of probe p: dist <= ts iff score >= seq_len - ts,
// clamped to INT_MAX (above every score; rows at or past B) or, in byte
// lanes (BYTES), to [0, 64] and stored as 64 - b (KstatsWg<true> packs
// it).
template <bool BYTES>
__device__ __forceinline__ int row_bound(const int* ts, long row, int B,
                                         int p, int seq_len) {
  const long long b = row < B ? (long long)seq_len - ts[(long)p * B + row]
                              : (long long)INT_MAX;
  return BYTES ? 64 - (int)max(0LL, min(64LL, b))
               : (int)min((long long)INT_MAX, b);
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

// The epilogue of both wgmma tiles (wg_scan.cuh, wg_long.cuh; their
// interface: begin, tile<M> a 64 x 64 block, end). A lane's rows i = 2M
// + h (row r0 + 64 M + 8 h) keep their four bounds, their counts as
// 16-bit pairs and their least score over the lane's columns (8j + 2t +
// c of every 64-row block). BYTES (windows below 64 bp, scores in [0,
// 63]): the bounds packed in byte lanes, four probes an IMAD; else a
// compare and a predicated add a probe. Only the last live block can be
// partial: its tile runs masked, columns at or past n_valid scored
// below every bound and above every minimum; every other block is
// branch-free. The pairs flush every PAIR_TILES blocks of an item (form
// (b)'s steps are two blocks) and at its end: the item's first flush
// writes split y's partials, later ones add; the last writes mx.
template <bool BYTES>
struct KstatsWg {
  // BYTES: bound[i][0] packs row i's four probes as bytes 64 - b, probe
  // 0, 2, 1, 3 from the low byte
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

  // The launch's fields; the live 64-row blocks are ceil(n_valid / 64),
  // the last one partial (`last`, its live columns `rem`) unless n_valid
  // fills it. Returns the live blocks' rows.
  __device__ __forceinline__ int init(const int* ts_, int* cnt_out_,
                                      int* mx_out_, int B_, int S_,
                                      int n_valid, int seq_len_) {
    ts = ts_;
    cnt_out = cnt_out_;
    mx_out = mx_out_;
    B = B_;
    S = S_;
    seq_len = seq_len_;
    t = threadIdx.x & 3;
    const int live = (n_valid + wg_scan::N - 1) / wg_scan::N;
    rem = n_valid - (live - 1) * wg_scan::N;
    last = rem < wg_scan::N ? live - 1 : -1;
    return live * wg_scan::N;
  }

  __device__ __forceinline__ void begin(long r, const wg_scan::Item& im) {
    r0 = r;
    y = im.y;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = r0 + 64 * (i >> 1) + 8 * (i & 1);
#pragma unroll
      for (int p = 0; p < PROBES; ++p) {
        bound[i][p] = row_bound<BYTES>(ts, row, B, p, seq_len);
      }
      if (BYTES) {
        bound[i][0] |= bound[i][2] << 8 | bound[i][1] << 16 | bound[i][3] << 24;
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
  __device__ __forceinline__ void tally_pairs(const int (&acc)[32],
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

  // The same in byte lanes. One IMAD, d = score * 0x01010101 + bound,
  // puts score + 64 - b in [0, 127] into each byte with no carry between
  // bytes, so bit 6 of a byte is set iff score >= b. Three masked d's
  // add without carry (<= 192 a byte); >> 6 turns the sum into counts,
  // folded into u (<= 16 a byte a block: the lane's 16 columns), whose
  // bytes 0, 2 and 1, 3 are the pairs cnt[i][0] and cnt[i][1].
  template <int M, bool MASKED>
  __device__ __forceinline__ void tally_bytes(const int (&acc)[32],
                                              const int (&z)[16]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * M + h;
      unsigned u = 0, sum = 0;
      int sm0 = INT_MAX;
#pragma unroll
      for (int k = 0; k < 16; ++k) {  // column 8 (k / 2) + 2t + k % 2
        const int s = acc[4 * (k >> 1) + 2 * h + (k & 1)] + z[k];
        unsigned m = ((unsigned)s * 0x01010101u + (unsigned)bound[i][0]) & 0x40404040u;
        int sm = s;
        if (MASKED && 8 * (k >> 1) + 2 * t + (k & 1) >= rem) {
          m = 0;
          sm = INT_MAX;
        }
        sum += m;
        if (k % 3 == 2 || k == 15) {
          u += sum >> 6;
          sum = 0;
        }
        if (k % 2 == 0) {
          sm0 = sm;
        } else {
          mn[i] = __vimin3_s32(mn[i], sm0, sm);
        }
      }
      cnt[i][0] += (int)(u & 0x00ff00ffu);
      cnt[i][1] += (int)((u >> 8) & 0x00ff00ffu);
    }
  }

  template <int M, bool MASKED>
  __device__ __forceinline__ void tally(const int (&acc)[32],
                                        const int (&z)[16]) {
    if constexpr (BYTES) {
      tally_bytes<M, MASKED>(acc, z);
    } else {
      tally_pairs<M, MASKED>(acc, z);
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

// The short route (wg_scan.cuh), NKP panels a row, over the live 64-row
// blocks; BYTES: counts in byte lanes (windows below 64 bp). cnt_out:
// [4, S, B] count partials (count p of split y at (p * S + y) * B),
// mx_out: [S, B]; with S == 1 the final [4, B] and [B] outputs.
template <int NKP, bool BYTES>
__global__ void __launch_bounds__(wg_scan::THREADS, 1)
    kstats_wg_kernel(const __grid_constant__ CUtensorMap tm_db,
                     const __grid_constant__ CUtensorMap tm_zc,
                     const int8_t* __restrict__ q, const int* __restrict__ ts,
                     int* __restrict__ cnt_out, int* __restrict__ mx_out,
                     int B, int n_valid, int EP, int seq_len, int S) {
  KstatsWg<BYTES> epi;
  const int W = epi.init(ts, cnt_out, mx_out, B, S, n_valid, seq_len);
  wg_scan::run<NKP>(&tm_db, &tm_zc, q, B, W / wg_scan::N, EP, S, epi);
}

// The long routes (wg_long.cuh), NKP panels a row in form (a), 0 in
// form (b), over the live 64-row blocks, counts in pairs; outputs as
// kstats_wg_kernel's.
template <int NKP>
__global__ void __launch_bounds__(wg_long::THREADS, 1)
    kstats_wgchunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_db,
                          const __grid_constant__ CUtensorMap tm_zc, int T,
                          int S, int R, int nkp, const int* __restrict__ ts,
                          int* __restrict__ cnt_out, int* __restrict__ mx_out,
                          int B, int n_valid, int seq_len) {
  KstatsWg<false> epi;
  const int W = epi.init(ts, cnt_out, mx_out, B, S, n_valid, seq_len);
  wg_long::run<NKP>(&tm_q, &tm_db, &tm_zc, B, W, T, S, R, nkp, epi);
}

// The short route up to wg_scan::EP_MAX (byte lanes below 64 bp: their
// scores stay below 64), the long route's past it, in form (a) up to
// wg_long::EP_A_MAX, each over the live rows; with splits > 1 the kernel
// writes part = [cnt x 4, mx] x [splits, B] and the merge follows.
cudaError_t launch_split(const int8_t* q, const int8_t* db, const int* zc,
                         const int* ts, int* cnt, int* mx, int* part, int B,
                         int n_valid, int EP, int seq_len, int splits,
                         cudaStream_t s) {
  const bool direct = splits == 1;
  int* cnt_o = direct ? cnt : part;
  int* mx_o = direct ? mx : part + (long)PROBES * splits * B;
  const int live = (n_valid + wg_scan::N - 1) / wg_scan::N * wg_scan::N;
  cudaError_t err;
  if (EP <= wg_scan::EP_MAX) {
    const bool bytes = seq_len < 64;
    err = wg_scan::by_panels(EP, [&](auto panels) {
      constexpr int NKP = decltype(panels)::value;
      return bytes ? wg_scan::launch<NKP>(kstats_wg_kernel<NKP, true>, db, zc,
                                          B, live, EP, splits, s, q, ts, cnt_o,
                                          mx_o, B, n_valid, EP, seq_len, splits)
                   : wg_scan::launch<NKP>(kstats_wg_kernel<NKP, false>, db, zc,
                                          B, live, EP, splits, s, q, ts, cnt_o,
                                          mx_o, B, n_valid, EP, seq_len, splits);
    });
  } else {
    err = wg_long::by_form(EP, [&](auto form) {
      constexpr int NKP = decltype(form)::value;
      return wg_long::launch<NKP>(kstats_wgchunk_kernel<NKP>, q, db, zc, B,
                                  live, EP, splits, s, ts, cnt_o, mx_o, B,
                                  n_valid, seq_len);
    });
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
// W % 64 == 0, 1 <= n_valid <= W, B >= 1, 16-byte aligned q, db and zc
// (TMA sources), 1 <= splits <= ceil(n_valid / 64), and the port's
// operands (ops/distance.py), whose score q . db + zc of a db row below
// n_valid lies in [0, seq_len]. Returns the cudaError_t of the launches.
extern "C" int smafa_kstats(const void* q, const void* db, const void* zc,
                            const void* ts, void* cnt, void* mx, void* part,
                            int B, int n_valid, int EP, int seq_len,
                            int splits, void* stream) {
  if (B < 1 || n_valid < 1) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > (n_valid + wg_scan::N - 1) / wg_scan::N) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_split(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(db),
      static_cast<const int*>(zc), static_cast<const int*>(ts),
      static_cast<int*>(cnt), static_cast<int*>(mx), static_cast<int*>(part),
      B, n_valid, EP, seq_len, splits, static_cast<cudaStream_t>(stream));
}
