// The cluster op's centroid scan on Hopper: one packed-key minimum (and
// optionally the tie count) per query row over the first n_valid db
// rows.
//
// Replaces smafa_tpu/ops/pallas_scan.py:_min_kernel (entry
// min_count_scan), which the JAX cluster op reaches as min_scan /
// min1_scan. Per query row r over db rows w < n_valid:
//
//   dist   = seq_len - q_emb[r] . db_emb[w] - zc[w]
//   key[r] = min_w (dist << shift) | w         (BIG_KEY if n_valid == 0)
//   cnt[r] = #{w : dist == key[r] >> shift}    (with_count only; 0 if empty)
//
// The lowest index wins among equal distances because the index sits
// in the key's low bits. The TPU kernel took one-hot operands and the
// real-row count in SMEM; this one takes the port's rank-4 operands
// (the same distances) and n_valid as an argument. The centroid buffer
// holds live rows past n_valid (centroids appended after the snapshot a
// scan was launched on, which can match better than any row the scan
// may see), so rows at or past n_valid are masked, not merely padded.
// shift is a runtime argument because it grows with the buffer.
//
// What bounds it on the H100: the int8 contraction, 2 * B * n_valid * 4L
// operations over 1,979 TOP/s (0.260 ms at 32768 x 32768 and 2 us at
// 2048 x 4096, L = 60). The first version reached 12.9% and 0.9% of
// that: its grid of ceil(B / 128) blocks each walked every live row (16
// blocks on 132 SMs at the cluster's first batches of 2048 rows), it fed
// mma.sync from 32-bit shared loads behind load-then-sync copies, and
// its epilogue built and compared a key per column, behind a branch on
// n_valid, in every tile.
//
// What the design does about it:
// 1. Db splits over the live rows only: ceil(B / 256) query tiles x S
//    db splits, S from ops/min2.py's live_plan over the ceil(n_valid /
//    64) live 64-row blocks. With S > 1 the splits write int32 key
//    partials [S, B] (and, with the count, count partials [S, B] after
//    them) to scratch the wrapper allocates, and min_count_merge_kernel,
//    launched right after on the same stream, takes the min of the keys
//    and sums the counts of the splits whose partial distance key >>
//    shift is the row's minimum; no atomics.
// 2. The warp-specialised wgmma tiles (see min2.cu, lever 3) over the
//    live blocks (their W is the blocks' rows). Up to 64 bp (EP <= 256)
//    min_count_wg_kernel runs wg_scan.cuh's, the rows' A fragments in
//    registers, m64n64k32 against each 64-row db step. Past it
//    min_count_wgchunk_kernel runs wg_long.cuh's: form (a), the block's
//    256 query rows resident, up to EP = 640 (160 bp), form (b), query
//    and db chunks streamed, 256 x 128 a step, past it. Both replace the
//    split tile (mma.sync fed by ldmatrix, cp.async; 29% of the bound at
//    32768 x 32768, 60 bp, 25.8% at 150 bp, and its K-chunked form 13.8%
//    at 32768 x 2^22, 300 bp; chip_smoke.py, NVIDIA H100 80GB HBM3, 700
//    W), which replaced the first version's loop (one split; 8.3% at 300
//    bp).
// 3. min2.cu's max-first epilogue with one key (MinCountWg): each lane
//    folds its 16 scores (acc + zc) per row of a block into the block's
//    best with __viaddmax_s32, the quad shares it by two xor shuffles,
//    and one branch a block runs the exact update for the rows whose
//    block best reaches their running best. Without the count only a
//    strictly better best enters it: a split's later blocks hold higher
//    indices, so an equal distance cannot lower the key.
// 4. Only the last live block can be partial: its tile runs masked,
//    columns at or past n_valid neither fold nor hit; every other block
//    runs without the branch.

#include <climits>

#include "wg_long.cuh"
#include "wg_scan.cuh"

namespace {

using wg_tile::set_if_eq;

constexpr int MERGE_THREADS = 256;
constexpr int BIG_KEY = 0x7fffffff;  // the empty packed key

// The epilogue of both wgmma tiles (wg_scan.cuh, wg_long.cuh; their
// interface: begin, tile<M> a 64 x 64 block, end), min2.cu's max-first
// fold with one key. A lane's rows i = 2M + h (row r0 + 64 M + 8 h) keep
// the row's best score (the same in the 4 lanes of the quad), the key
// and (WITH_COUNT) the count at it over the columns the lane owns (8j +
// 2t + c of every 64-row block). Without the count only a strictly
// better best enters the update: an item walks its blocks in index
// order, so an equal distance cannot lower the key. Only the last live
// block can be partial: its tile runs masked, columns at or past
// n_valid (live rows, which may match better) neither fold nor hit;
// every other block is branch-free.
template <bool WITH_COUNT>
struct MinCountWg {
  int best[4], key[4], cnt[4];
  int* key_out;
  int* cnt_out;
  int B, seq_len, shift, t, last, rem, y;
  long r0;

  // The launch's fields; the live 64-row blocks are ceil(n_valid / 64),
  // the last one partial (`last`, its live columns `rem`) unless n_valid
  // fills it. Returns the live blocks' rows.
  __device__ __forceinline__ int init(int* key_out_, int* cnt_out_, int B_,
                                      int n_valid, int seq_len_, int shift_) {
    key_out = key_out_;
    cnt_out = cnt_out_;
    B = B_;
    seq_len = seq_len_;
    shift = shift_;
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
      best[i] = INT_MIN;
      key[i] = BIG_KEY;
      cnt[i] = 0;
    }
  }

  // Block s of tile M (acc[4j + 2h + c] + z[2j + c]: the score of row 2M
  // + h and db row 64 s + 8j + 2t + c): each row's best over the lane's
  // columns (add and max in one DPX instruction), then over the quad's;
  // one branch into the exact update of the rows whose best it reaches.
  // MASKED: only columns below rem are live.
  template <int M, bool MASKED>
  __device__ __forceinline__ void fold(const int (&acc)[32], const int (&z)[16],
                                       int s) {
    unsigned live = 0xffffu;  // bit 2j + c: column 8j + 2t + c
    if (MASKED) {
      live = 0;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (8 * (b >> 1) + 2 * t + (b & 1) < rem) live |= 1u << b;
      }
    }
    int tb[2] = {INT_MIN, INT_MIN};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (!MASKED || ((live >> (2 * j + c)) & 1)) {
            tb[h] = __viaddmax_s32(acc[4 * j + 2 * h + c], z[2 * j + c], tb[h]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tb[h] = max(tb[h], __shfl_xor_sync(0xffffffffu, tb[h], 1));
      tb[h] = max(tb[h], __shfl_xor_sync(0xffffffffu, tb[h], 2));
    }
    // (column 0 of every block is live, so a quad's best is a score)
    bool up[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      up[h] = WITH_COUNT ? tb[h] >= best[2 * M + h] : tb[h] > best[2 * M + h];
    }
    if (up[0] | up[1]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 2 * M + h;
        if (!up[h]) continue;
        if (tb[h] > best[i]) {
          best[i] = tb[h];
          key[i] = BIG_KEY;
          cnt[i] = 0;
        }
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            set_if_eq(m, acc[4 * j + 2 * h + c] + z[2 * j + c], tb[h],
                      1u << (2 * j + c));
          }
        }
        if (MASKED) m &= live;
        if (m) {  // the lowest column hit: the lane's least index
          const int bl = __ffs(m) - 1;
          const int w = s * wg_scan::N + 8 * (bl >> 1) + 2 * t + (bl & 1);
          key[i] = min(key[i], ((seq_len - tb[h]) << shift) | w);
          if (WITH_COUNT) cnt[i] += __popc(m);
        }
      }
    }
  }

  template <int M>
  __device__ __forceinline__ void tile(const int (&acc)[32], const int (&z)[16],
                                       int s) {
    if (s == last) {
      fold<M, true>(acc, z, s);
    } else {
      fold<M, false>(acc, z, s);
    }
  }

  // Merge the 4 lanes that share each row (a better best takes its
  // count, an equal one adds it); lane t writes row i = t if below B,
  // into split y's partials (or the outputs when S == 1).
  __device__ __forceinline__ void end(const wg_scan::Item&) {
    const long out0 = (long)y * B;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const int okey = __shfl_xor_sync(0xffffffffu, key[i], off);
        if (WITH_COUNT) {
          const int ob = __shfl_xor_sync(0xffffffffu, best[i], off);
          const int ocnt = __shfl_xor_sync(0xffffffffu, cnt[i], off);
          cnt[i] = ob > best[i] ? ocnt : (ob == best[i] ? cnt[i] + ocnt : cnt[i]);
          best[i] = max(best[i], ob);
        }
        key[i] = min(key[i], okey);
      }
      const long row = r0 + 64 * (i >> 1) + 8 * (i & 1);
      if (t == i && row < B) {
        key_out[out0 + row] = key[i];
        if (WITH_COUNT) cnt_out[out0 + row] = cnt[i];
      }
    }
  }
};

// The short route (wg_scan.cuh), NKP panels a row, over the live 64-row
// blocks. key_out (and with the count cnt_out): [S, B] partials, split
// y at y * B, or the final [B] outputs when S == 1.
template <int NKP, bool WITH_COUNT>
__global__ void __launch_bounds__(wg_scan::THREADS, 1)
    min_count_wg_kernel(const __grid_constant__ CUtensorMap tm_db,
                        const __grid_constant__ CUtensorMap tm_zc,
                        const int8_t* __restrict__ q,
                        int* __restrict__ key_out, int* __restrict__ cnt_out,
                        int B, int n_valid, int EP, int seq_len, int shift,
                        int S) {
  MinCountWg<WITH_COUNT> epi;
  const int W = epi.init(key_out, cnt_out, B, n_valid, seq_len, shift);
  wg_scan::run<NKP>(&tm_db, &tm_zc, q, B, W / wg_scan::N, EP, S, epi);
}

// The long routes (wg_long.cuh), NKP panels a row in form (a), 0 in
// form (b), over the live 64-row blocks: outputs as
// min_count_wg_kernel's.
template <int NKP, bool WITH_COUNT>
__global__ void __launch_bounds__(wg_long::THREADS, 1)
    min_count_wgchunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_db,
                             const __grid_constant__ CUtensorMap tm_zc, int T,
                             int S, int R, int nkp, int* __restrict__ key_out,
                             int* __restrict__ cnt_out, int B, int n_valid,
                             int seq_len, int shift) {
  MinCountWg<WITH_COUNT> epi;
  const int W = epi.init(key_out, cnt_out, B, n_valid, seq_len, shift);
  wg_long::run<NKP>(&tm_q, &tm_db, &tm_zc, B, W, T, S, R, nkp, epi);
}

// part: int32 [S, B] key partials of the S splits, then, with the
// count, their [S, B] count partials.
__global__ void min_count_merge_kernel(const int* __restrict__ part,
                                       int* __restrict__ key,
                                       int* __restrict__ cnt, int B, int S,
                                       int shift, int with_count) {
  const int r = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (r >= B) return;
  int k = BIG_KEY;
  for (int s = 0; s < S; ++s) k = min(k, part[(long)s * B + r]);
  key[r] = k;
  if (with_count) {
    const int d = k >> shift;
    const long sb = (long)S * B;
    int c = 0;
    for (int s = 0; s < S; ++s) {
      if ((part[(long)s * B + r] >> shift) == d) c += part[sb + (long)s * B + r];
    }
    cnt[r] = c;
  }
}

// The short route up to wg_scan::EP_MAX, the long route's past it, in
// form (a) up to wg_long::EP_A_MAX, each over the live rows; with
// splits > 1 the kernel writes part = key [, cnt] x [splits, B] and the
// merge follows.
template <bool WITH_COUNT>
cudaError_t launch_split(const int8_t* q, const int8_t* db, const int* zc,
                         int* key, int* cnt, int* part, int B, int n_valid,
                         int EP, int seq_len, int shift, int splits,
                         cudaStream_t s) {
  const bool direct = splits == 1;
  int* key_o = direct ? key : part;
  int* cnt_o = direct ? cnt : part + (long)splits * B;
  const int live = (n_valid + wg_scan::N - 1) / wg_scan::N * wg_scan::N;
  const cudaError_t err =
      EP <= wg_scan::EP_MAX
          ? wg_scan::by_panels(EP, [&](auto panels) {
              constexpr int NKP = decltype(panels)::value;
              return wg_scan::launch<NKP>(
                  min_count_wg_kernel<NKP, WITH_COUNT>, db, zc, B, live, EP,
                  splits, s, q, key_o, cnt_o, B, n_valid, EP, seq_len, shift,
                  splits);
            })
          : wg_long::by_form(EP, [&](auto form) {
              constexpr int NKP = decltype(form)::value;
              return wg_long::launch<NKP>(
                  min_count_wgchunk_kernel<NKP, WITH_COUNT>, q, db, zc, B,
                  live, EP, splits, s, key_o, cnt_o, B, n_valid, seq_len,
                  shift);
            });
  if (err != cudaSuccess || direct) return err;
  min_count_merge_kernel<<<(B + MERGE_THREADS - 1) / MERGE_THREADS,
                           MERGE_THREADS, 0, s>>>(part, key, cnt, B, splits,
                                                  shift, WITH_COUNT);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// key and cnt: int32 [B], cnt written (and read as a pointer) only when
// with_count; part: int32 [with_count ? 2 : 1, splits, B] scratch when
// splits > 1 (else unused). Requires EP % 32 == 0, W % 64 == 0,
// B >= 1, 1 <= n_valid <= W, 16-byte aligned q, db and zc (TMA
// sources) and 1 <= splits <= ceil(n_valid / 64). Returns the
// cudaError_t of the launches.
extern "C" int smafa_min_count(const void* q, const void* db, const void* zc,
                               void* key, void* cnt, void* part, int B,
                               int n_valid, int EP, int seq_len, int shift,
                               int with_count, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* dp = static_cast<const int8_t*>(db);
  const int* zp = static_cast<const int*>(zc);
  int* kp = static_cast<int*>(key);
  int* cp = static_cast<int*>(cnt);
  int* pp = static_cast<int*>(part);
  if (B < 1 || n_valid < 1) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > (n_valid + wg_scan::N - 1) / wg_scan::N) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(with_count
                   ? launch_split<true>(qp, dp, zp, kp, cp, pp, B, n_valid, EP,
                                        seq_len, shift, splits, s)
                   : launch_split<false>(qp, dp, zp, kp, cp, pp, B, n_valid,
                                         EP, seq_len, shift, splits, s));
}
