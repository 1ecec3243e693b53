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
// What the design does about it (min_count_split_kernel):
// 1. The split tile (split_tile.cuh; see min2.cu, lever 3) over the live
//    tiles only: ceil(B / 256) query tiles x S db splits, S from
//    ops/min2.py's live_plan over tiles = ceil(n_valid / 64), split y
//    walking tiles tiles * y / S up to tiles * (y + 1) / S. Db tiles and
//    their zc arrive by cp.async in a 2-stage ring, fragments by
//    ldmatrix.x4, two blocks per SM. With S > 1 the splits write int32
//    key partials [S, B] (and, with the count, count partials [S, B]
//    after them) to scratch the wrapper allocates, and
//    min_count_merge_kernel, launched right after on the same stream,
//    takes the min of the keys and sums the counts of the splits whose
//    partial distance key >> shift is the row's minimum; no atomics.
// 2. min2's max-first epilogue with one key: each lane folds its 16
//    scores (acc + zc) per row of a tile into the tile's best with
//    __viaddmax_s32, and one branch per tile runs the exact update for
//    the rows whose tile best reaches their running best. Without the
//    count only a strictly better best enters it: a split's later tiles
//    hold higher indices, so an equal distance cannot lower the key.
// 3. Only the last live tile can be partial. The split that owns it runs
//    it through a masked epilogue of its own, columns at or past n_valid
//    scored INT_MIN (below every real score); every other tile runs
//    without the branch.
//
// Longer windows (EP > 256, L > 64) take min_count_chunk_kernel: the
// same grid, epilogue (MinCountState), masked last tile and merge on the
// K-chunked split tile (split_tile.cuh kchunk_scan), one block an SM,
// form (a) with the query rows resident up to EP = 672 (168 bp) and form
// (b) past it. It replaces the first version's loop there (one split;
// 8.3% of the bound at 300 bp).

#include <climits>

#include "split_tile.cuh"

namespace {

using namespace split_tile;  // the tile's constants and helpers

constexpr int MERGE_THREADS = 256;

// A lane's running state of its rows i = 2m + h (row q0 + g + 8i) over
// the db columns it owns (2t, 2t + 1 of every n-tile): the best score,
// the key and (WITH_COUNT) the count at the best score.
template <bool WITH_COUNT>
struct MinCountState {
  int best[4], key[4], cnt[4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = INT_MIN;
      key[i] = BIG_KEY;
      cnt[i] = 0;
    }
  }

  // Fold one tile: acc[m][n][2h + c] is row i's dot with tile column 8n
  // + 2t + c, sZ the tile's zc, w0 its first db row. MASKED: only
  // columns below rem are live.
  template <bool MASKED>
  __device__ __forceinline__ void fold(const int (&acc)[2][8][4],
                                       const int* sZ, int w0, int t, int rem,
                                       int seq_len, int shift) {
    int tb[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int2 z = *reinterpret_cast<const int2*>(sZ + n * 8 + 2 * t);
      const bool live0 = !MASKED || n * 8 + 2 * t < rem;
      const bool live1 = !MASKED || n * 8 + 2 * t + 1 < rem;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (live0) tb[i] = __viaddmax_s32(acc[i >> 1][n][2 * (i & 1)], z.x, tb[i]);
        if (live1) tb[i] = __viaddmax_s32(acc[i >> 1][n][2 * (i & 1) + 1], z.y, tb[i]);
      }
    }
    auto reaches = [&](int i) {
      return WITH_COUNT ? tb[i] >= best[i] : tb[i] > best[i];
    };
    if (reaches(0) | reaches(1) | reaches(2) | reaches(3)) {  // rare after the first tiles
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a masked tile may hold no live column of this lane
        if (!reaches(i) || (MASKED && tb[i] == INT_MIN)) continue;
        if (tb[i] > best[i]) {
          best[i] = tb[i];
          key[i] = BIG_KEY;
          cnt[i] = 0;
        }
        const int kd = (seq_len - tb[i]) << shift;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n * 8 + 2 * t + c;
            if ((!MASKED || col < rem) &&
                acc[i >> 1][n][2 * (i & 1) + c] + sZ[col] == tb[i]) {
              key[i] = min(key[i], kd | (w0 + col));
              if (WITH_COUNT) ++cnt[i];
            }
          }
        }
      }
    }
  }

  // The tile from db row w0; `masked`: the last live tile, partial.
  __device__ __forceinline__ void tile(const int (&acc)[2][8][4],
                                       const int* sZ, int w0, int t,
                                       bool masked, int rem, int seq_len,
                                       int shift) {
    if (masked) {
      fold<true>(acc, sZ, w0, t, rem, seq_len, shift);
    } else {
      fold<false>(acc, sZ, w0, t, rem, seq_len, shift);
    }
  }

  // Merge the 4 lanes (t = 0..3) that share each row (a better best
  // takes its count, an equal one adds it) and write the rows below B of
  // the warp from q0 at out0 (split y's partials, or the outputs).
  __device__ __forceinline__ void store(int* key_out, int* cnt_out,
                                        long out0, long q0, int g, int t,
                                        int B) {
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
      const long row = q0 + g + 8 * i;
      if (t == 0 && row < B) {
        key_out[out0 + row] = key[i];
        if (WITH_COUNT) cnt_out[out0 + row] = cnt[i];
      }
    }
  }
};

// Split y's run of the live tiles (tiles = ceil(n_valid / 64)): tiles
// [t_begin, t_begin + nt), and the index in it of the last live tile,
// partial unless n_valid fills it (the last split owns it as its last
// tile), or -1.
struct LiveRun {
  int t_begin, nt, rem, masked_it;
  __device__ __forceinline__ LiveRun(int n_valid) {
    const int tiles = (n_valid + S_BN - 1) / S_BN;
    const int S = gridDim.y, y = blockIdx.y;
    t_begin = (int)((long)tiles * y / S);
    nt = (int)((long)tiles * (y + 1) / S) - t_begin;
    rem = n_valid - (tiles - 1) * S_BN;
    masked_it = (y == S - 1 && rem < S_BN) ? nt - 1 : -1;
  }
};

// key_out (and with the count cnt_out): [S, B] partials, split y at
// y * B, or the final [B] outputs when S == 1. Split blockIdx.y of
// gridDim.y = S.
template <bool WITH_COUNT>
__global__ void __launch_bounds__(S_THREADS, S_BLOCKS_PER_SM)
    min_count_split_kernel(const int8_t* __restrict__ q,
                           const int8_t* __restrict__ db,
                           const int* __restrict__ zc,
                           int* __restrict__ key_out,
                           int* __restrict__ cnt_out, int B, int n_valid,
                           int EP, int seq_len, int shift) {
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
  const LiveRun run(n_valid);
  const int t_begin = run.t_begin, nt = run.nt;

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

  MinCountState<WITH_COUNT> st;
  st.init();
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
    int acc[2][8][4] = {};
    tile_mma(acc, a_row, sD + b_off, stride, nks);
    st.tile(acc, reinterpret_cast<const int*>(sD + S_BN * stride),
            (t_begin + it) * S_BN, t, it == run.masked_it, run.rem, seq_len,
            shift);
  }
  cp_async_wait<0>();
  if (!live) return;
  st.store(key_out, cnt_out, (long)blockIdx.y * B, q0, g, t, B);
}

// Long windows (EP > S_KS * 32): the K-chunked split tile, form (a) with
// the query rows resident (QRES) or (b) streamed, on the split kernel's
// grid over the live tiles, epilogue, masked last tile and outputs.
// Every warp copies and syncs inside kchunk_scan; only warps with a row
// below B run the products.
template <bool QRES, bool WITH_COUNT>
__global__ void __launch_bounds__(S_THREADS, K_BLOCKS_PER_SM)
    min_count_chunk_kernel(const int8_t* __restrict__ q,
                           const int8_t* __restrict__ db,
                           const int* __restrict__ zc,
                           int* __restrict__ key_out,
                           int* __restrict__ cnt_out, int B, int n_valid,
                           int EP, int seq_len, int shift) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID: fragment row / db column
  const int t = lane & 3;   // mma threadID_in_group
  const long q0 = (long)blockIdx.x * S_BM + warp * 32;
  const bool live = q0 < B;  // the warp has a row below B
  const LiveRun run(n_valid);

  MinCountState<WITH_COUNT> st;
  st.init();
  kchunk_scan<QRES>(
      smem, q, db, zc, (long)blockIdx.x * S_BM, B, EP, run.t_begin, run.nt,
      live, [](int (&acc)[2][8][4], const int*) { zero_acc(acc); },
      [&](const int (&acc)[2][8][4], const int* sZ, int it) {
        st.tile(acc, sZ, (run.t_begin + it) * S_BN, t, it == run.masked_it,
                run.rem, seq_len, shift);
      });
  if (!live) return;
  st.store(key_out, cnt_out, (long)blockIdx.y * B, q0, g, t, B);
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

template <class Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const int8_t* q,
                   const int8_t* db, const int* zc, int* key, int* cnt,
                   int B, int n_valid, int EP, int seq_len, int shift,
                   cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, S_THREADS, smem, s>>>(q, db, zc, key, cnt, B, n_valid, EP,
                                       seq_len, shift);
  return cudaGetLastError();
}

// The split kernel up to EP = S_KS * 32, the K-chunked one past it, in
// form (a) up to RESIDENT_EP_MAX; with splits > 1 it writes part = key
// [, cnt] x [splits, B] and the merge follows.
template <bool WITH_COUNT>
cudaError_t launch_split(const int8_t* q, const int8_t* db, const int* zc,
                         int* key, int* cnt, int* part, int B, int n_valid,
                         int EP, int seq_len, int shift, int splits,
                         cudaStream_t s) {
  const bool direct = splits == 1;
  int* key_o = direct ? key : part;
  int* cnt_o = direct ? cnt : part + (long)splits * B;
  const dim3 grid((B + S_BM - 1) / S_BM, splits);
  const cudaError_t err =
      EP <= S_KS * 32
          ? launch(min_count_split_kernel<WITH_COUNT>, split_smem(EP), grid, q,
                   db, zc, key_o, cnt_o, B, n_valid, EP, seq_len, shift, s)
      : EP <= RESIDENT_EP_MAX
          ? launch(min_count_chunk_kernel<true, WITH_COUNT>,
                   kchunk_smem<true>(EP), grid, q, db, zc, key_o, cnt_o, B,
                   n_valid, EP, seq_len, shift, s)
          : launch(min_count_chunk_kernel<false, WITH_COUNT>,
                   kchunk_smem<false>(EP), grid, q, db, zc, key_o, cnt_o, B,
                   n_valid, EP, seq_len, shift, s);
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
// B >= 1, 1 <= n_valid <= W, 16-byte aligned q and db and
// 1 <= splits <= ceil(n_valid / 64). Returns the cudaError_t of the
// launches.
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
  if (splits < 1 || splits > (n_valid + S_BN - 1) / S_BN) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(with_count
                   ? launch_split<true>(qp, dp, zp, kp, cp, pp, B, n_valid, EP,
                                        seq_len, shift, splits, s)
                   : launch_split<false>(qp, dp, zp, kp, cp, pp, B, n_valid,
                                         EP, seq_len, shift, splits, s));
}
