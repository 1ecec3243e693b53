// The K-mode distance histogram on Hopper: per query row r, the number
// of db rows w < n_valid at each distance d in [0, seq_len].
//
// Replaces smafa_tpu/ops/distance.py:hist_scan, the XLA program (not a
// Pallas kernel) that smafa_tpu's K-mode runs once per batch under
// SMAFA_TPU_KMODE_HIST=1 for windows below HIST_MAX = 1024 bp; the
// cutoff rule reads the K-th distance, the row's largest and the hit
// count off the row's cumulative sum (ops/distance.py
// kmode_cutoffs_from_hist). Per query row r over db rows w < n_valid:
//
//   dist          = seq_len - q_emb[r] . db_emb[w] - zc[w]
//   hist[r][dist] += 1
//
// Rows at or past n_valid never count: they are masked by index, not
// poisoned, as in kstats.cu.
//
// What bounds it on the H100: the int8 contraction, 2 * B * n_valid * 4L
// operations over 1,979 TOP/s, as one pass of kstats.cu (4.17 ms at
// 16384 x (2^20 + 37), L = 60), beside one shared-memory atomic add an
// element in the epilogue. The TPU paid ~L + 1 compare-adds an element
// for the same histogram, which is why smafa_tpu keeps it off by
// default; here it is one increment.
//
// What the design does about it:
// 1. The bins live in shared memory, one int32 (or one 16-bit half) per
//    (query row, distance) of the block's rows, and each accumulator
//    adds one to its row's bin with a shared atomic; a block adds its
//    nonzero bins onto the zeroed output with integer atomics once at
//    the end, so the db splits of a row merge exactly in any order,
//    with no partials buffer and no merge pass (dist_block.cu's answer
//    to the same split).
// 2. Bins take room the other kernels give to query rows, so each
//    route fixes its own rows a block, one block an SM:
//    - "split" (EP <= 256, L <= 64): split_tile.cuh's short route as
//      it is (256 query rows resident, whole db tiles in a cp.async
//      ring), int32 bins [256][L + 1]: 171,520 B at 64 bp;
//    - "kchunk" (L <= 168): a tile of 128 query rows x 128 db rows (8
//      warps as 4 row groups x 2 db tiles), query and db rows streamed
//      in K chunks of 256 bytes through a 2-stage ring, int32 bins
//      [128][L + 1]: 226,816 B at 168 bp;
//    - "kchunk_stream" (L <= 1023): 64 query rows x 256 db rows (2 x 4
//      warps), K chunks of 128 bytes, and 16-bit bins, two to an int32
//      word, flushed to the output every FLUSH_STEPS steps of 256 db
//      rows (65,280 increments at most, below 65,536): 225,280 B at
//      1023 bp.
//    Both K-chunked forms stream the query rows beside the db rows
//    (split_tile.cuh's form (b)): no resident copy fits beside the
//    bins. ops/hist.py mirrors the rows a block and a step.
// 3. The last live db tile is the only partial one: its columns >=
//    n_valid are skipped in a separate epilogue, and every other tile
//    runs branch-free. The four lanes of a quad hold the same rows, so
//    a db of one repeated row sends every increment of a row to one
//    bin; same-address atomics serialise but stay exact.
//
#include "split_tile.cuh"

namespace {

using namespace split_tile;

constexpr int HIST_MAX = 1024;  // smafa_tpu_torch/ops/keys.py HIST_MAX
constexpr int HIST_BLOCKS_PER_SM = 1;
constexpr int CHUNK_STAGES = 2;  // the K-chunked forms' ring depth

// The bin of a score: seq_len - score, clamped to [0, seq_len] (scores
// of the port's operands already lie there; the clamp keeps an
// out-of-contract operand inside the shared bins).
__device__ __forceinline__ int bin_of(int score, int seq_len) {
  return (int)min((unsigned)(seq_len - score), (unsigned)seq_len);
}

// Add one tile's scores to the bins of the warp's 32 rows (wb: row
// g + 8i at wb + (g + 8i) * nw words). acc[m][n][2h + c] is row
// i = 2m + h, tile column 8n + 2t + c. MASKED: only columns below rem
// are real. PAIRS: bin d is half d % 2 of word d / 2.
template <bool MASKED, bool PAIRS>
__device__ __forceinline__ void tally(const int (&acc)[2][8][4], int* wb,
                                      int nw, int seq_len, int g, int t,
                                      int rem) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int* rb = wb + (g + 8 * i) * nw;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (MASKED && n * 8 + 2 * t + c >= rem) continue;
        const int d = bin_of(acc[i >> 1][n][2 * (i & 1) + c], seq_len);
        if (PAIRS) {
          atomicAdd(rb + (d >> 1), 1 << ((d & 1) << 4));
        } else {
          atomicAdd(rb + d, 1);
        }
      }
    }
  }
}

// Add the block's nonzero bins of rows [0, rows) onto hist rows b0 + r
// below B, and zero them. nb = seq_len + 1 bins a row, nw words.
template <bool PAIRS>
__device__ void flush_bins(int* bins, int* __restrict__ hist, long b0,
                           int rows, int B, int nb, int nw) {
  for (int i = threadIdx.x; i < rows * nw; i += S_THREADS) {
    const int r = i / nw, w = i - r * nw;
    const int v = bins[i];
    bins[i] = 0;
    if (v == 0 || b0 + r >= B) continue;
    int* out = hist + (b0 + r) * nb;
    if (PAIRS) {
      // the high half of a last odd word is bin nb, which never counts
      if (v & 0xffff) atomicAdd(out + 2 * w, v & 0xffff);
      if ((unsigned)v >> 16) atomicAdd(out + 2 * w + 1, (int)((unsigned)v >> 16));
    } else {
      atomicAdd(out + w, v);
    }
  }
}

// The short route (EP <= S_KS * 32): split_tile.cuh's split tile over
// the live db tiles, tiles * y / S up to tiles * (y + 1) / S for split
// y of S = gridDim.y, int32 bins of the block's S_BM rows after the
// ring.
__global__ void __launch_bounds__(S_THREADS, HIST_BLOCKS_PER_SM)
    hist_split_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ db,
                      const int* __restrict__ zc, int* __restrict__ hist,
                      int B, int n_valid, int EP, int seq_len) {
  extern __shared__ __align__(16) int8_t smem[];
  const int stride = EP + S_PAD;
  const int sbytes = stage_bytes(stride);
  int8_t* sA = smem;  // the block's S_BM query rows
  int8_t* ring = smem + S_BM * stride;
  int* bins = reinterpret_cast<int*>(ring + S_STAGES * sbytes);
  const int nb = seq_len + 1;
  const int nks = EP >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID: fragment row / db column
  const int t = lane & 3;   // mma threadID_in_group
  const long b0 = (long)blockIdx.x * S_BM;
  const bool live = b0 + warp * 32 < B;  // the warp has a row below B
  const int tiles = (n_valid + S_BN - 1) / S_BN;
  const int S = gridDim.y, y = blockIdx.y;
  const int t_begin = (int)((long)tiles * y / S);
  const int nt = (int)((long)tiles * (y + 1) / S) - t_begin;
  // The last live tile is partial unless n_valid fills it; the last
  // split owns it as its last tile.
  const int rem = n_valid - (tiles - 1) * S_BN;
  const int masked_it = (y == S - 1 && rem < S_BN) ? nt - 1 : -1;

  for (int i = threadIdx.x; i < S_BM * nb; i += S_THREADS) bins[i] = 0;
  // The query tile, zero past B, joins the first tile's copy group.
  issue_queries(sA, q, b0, B, EP, stride);
#pragma unroll
  for (int s = 0; s < S_STAGES - 1; ++s) {
    if (s < nt) {
      issue_tile(ring + s * sbytes, db, zc, (long)(t_begin + s) * S_BN, EP,
                 stride);
    }
    cp_async_commit();
  }
  const int b_off = b_frag_offset(lane, stride);
  const int8_t* a_row = a_frag_row(sA, warp, lane, stride);
  int* wb = bins + warp * 32 * nb;

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<S_STAGES - 2>();
    __syncthreads();  // tile it visible (the bins zeroed before it 0)
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
    int acc[2][8][4];
    acc_from_zc(acc, sZ, t);
    tile_mma(acc, a_row, sD + b_off, stride, nks);
    if (it == masked_it) {
      tally<true, false>(acc, wb, nb, seq_len, g, t, rem);
    } else {
      tally<false, false>(acc, wb, nb, seq_len, g, t, rem);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  flush_bins<false>(bins, hist, b0, S_BM, B, nb, nb);
}

// The K-chunked forms: RG row groups of 32 query rows x S_WARPS / RG db
// tiles of 64 rows a step (warp w: row group w % RG, db tile w / RG),
// query and db rows streamed in chunks of KC bytes through a
// CHUNK_STAGES ring, one __syncthreads a chunk. A step's zc goes with
// its first chunk to a ring of its own, indexed by step, so the
// epilogue finds it after the chunk's stage has been reused.
template <int RG, int KC, bool PAIRS>
struct Chunked {
  static constexpr int CG = S_WARPS / RG;  // db tiles a step
  static constexpr int QR = 32 * RG;       // query rows a block
  static constexpr int DC = S_BN * CG;     // db rows a step
  static constexpr int KSTR = KC + S_PAD;  // shared row stride
  static constexpr int VPR = KC / 16;      // 16-byte vectors a chunk row
  static constexpr int STAGE = (QR + DC) * KSTR;
  // 16-bit bins: at most DC increments a bin a step
  static constexpr int FLUSH_STEPS = 65535 / DC;

  __host__ __device__ static int words(int seq_len) {
    return PAIRS ? (seq_len + 2) / 2 : seq_len + 1;
  }
  static int smem(int seq_len) {
    return CHUNK_STAGES * (STAGE + DC * (int)sizeof(int)) +
           QR * words(seq_len) * (int)sizeof(int);
  }
};

template <int RG, int KC, bool PAIRS>
__global__ void __launch_bounds__(S_THREADS, HIST_BLOCKS_PER_SM)
    hist_chunk_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ db,
                      const int* __restrict__ zc, int* __restrict__ hist,
                      int B, int n_valid, int EP, int seq_len) {
  using C = Chunked<RG, KC, PAIRS>;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* ring = smem;
  int* sZ = reinterpret_cast<int*>(ring + CHUNK_STAGES * C::STAGE);
  int* bins = sZ + CHUNK_STAGES * C::DC;
  const int nb = seq_len + 1;
  const int nw = C::words(seq_len);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID: fragment row / db column
  const int t = lane & 3;   // mma threadID_in_group
  const int rg = warp % RG, cg = warp / RG;
  const long b0 = (long)blockIdx.x * C::QR;
  const bool live = b0 + rg * 32 < B;
  const int steps = (n_valid + C::DC - 1) / C::DC;
  const int S = gridDim.y, y = blockIdx.y;
  const int s_begin = (int)((long)steps * y / S);
  const int ns = (int)((long)steps * (y + 1) / S) - s_begin;
  const int nkc = (EP + KC - 1) / KC;
  const int J = ns * nkc;

  for (int i = threadIdx.x; i < C::QR * nw; i += S_THREADS) bins[i] = 0;

  // Chunk j = it * nkc + c: bytes [c KC, c KC + KC) of the block's query
  // rows, then of step it's db rows (rows at or past n_valid, and query
  // rows at or past B, zero-filled and never read); with c == 0 the
  // step's zc.
  auto issue = [&](int j) {
    const int it = j / nkc, k0 = (j - it * nkc) * KC;
    int8_t* st = ring + (j % CHUNK_STAGES) * C::STAGE;
    const long w0 = (long)(s_begin + it) * C::DC;
    for (int i = threadIdx.x; i < (C::QR + C::DC) * C::VPR; i += S_THREADS) {
      const int r = i / C::VPR, v = i - r * C::VPR;
      const int k = k0 + v * 16;
      if (k >= EP) continue;
      const long row = r < C::QR ? b0 + r : w0 + (r - C::QR);
      const bool in = r < C::QR ? row < B : row < n_valid;
      const int8_t* src = (r < C::QR ? q : db) + row * EP + k;
      cp_async16_zfill(st + r * C::KSTR + v * 16, in ? src : q, in);
    }
    if (k0 == 0) {
      int* z = sZ + (it % CHUNK_STAGES) * C::DC;
      for (int i = threadIdx.x; i < C::DC; i += S_THREADS) {
        if (w0 + i < n_valid) cp_async4(z + i, zc + w0 + i);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < CHUNK_STAGES - 1; ++s) {
    if (s < J) issue(s);
    cp_async_commit();
  }

  // ldmatrix.x4 row addresses within a stage: the warp's row group of
  // the query chunk, its db tile of the db chunk.
  const int a_off = (int)(a_frag_row(ring, rg, lane, C::KSTR) - ring);
  const int b_off = (C::QR + cg * S_BN) * C::KSTR + b_frag_offset(lane, C::KSTR);
  int* wb = bins + rg * 32 * nw;
  int acc[2][8][4];
  int it = 0, c = 0;
  for (int j = 0; j < J; ++j) {
    cp_async_wait<CHUNK_STAGES - 2>();
    __syncthreads();  // chunk j visible; stage (j - 1) % stages free
    {
      const int nx = j + CHUNK_STAGES - 1;
      if (nx < J) issue(nx);
      cp_async_commit();
    }
    // this warp's db tile of step it: its live columns (<= 0: none)
    const long tile0 = (long)(s_begin + it) * C::DC + cg * S_BN;
    const int rem = (int)min((long)S_BN, n_valid - tile0);
    if (live && rem > 0) {
      const int8_t* st = ring + (j % CHUNK_STAGES) * C::STAGE;
      if (c == 0) acc_from_zc(acc, sZ + (it % CHUNK_STAGES) * C::DC + cg * S_BN, t);
      const int nks = min(KC / 32, (EP - c * KC) >> 5);
      chunk_mma(acc, st + a_off, C::KSTR, st + b_off, C::KSTR, nks);
      if (c == nkc - 1) {
        if (rem < S_BN) {
          tally<true, PAIRS>(acc, wb, nw, seq_len, g, t, rem);
        } else {
          tally<false, PAIRS>(acc, wb, nw, seq_len, g, t, rem);
        }
      }
    }
    if (++c == nkc) {
      c = 0;
      ++it;
      if (PAIRS && it % C::FLUSH_STEPS == 0 && it < ns) {
        __syncthreads();
        flush_bins<PAIRS>(bins, hist, b0, C::QR, B, nb, nw);
        __syncthreads();
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  flush_bins<PAIRS>(bins, hist, b0, C::QR, B, nb, nw);
}

template <int RG, int KC, bool PAIRS>
cudaError_t launch_chunked(const int8_t* q, const int8_t* db, const int* zc,
                           int* hist, int B, int n_valid, int EP,
                           int seq_len, int splits, cudaStream_t s) {
  using C = Chunked<RG, KC, PAIRS>;
  if (splits > (n_valid + C::DC - 1) / C::DC) return cudaErrorInvalidValue;
  const int smem = C::smem(seq_len);
  const auto kernel = &hist_chunk_kernel<RG, KC, PAIRS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + C::QR - 1) / C::QR, splits);
  kernel<<<grid, S_THREADS, smem, s>>>(q, db, zc, hist, B, n_valid, EP,
                                       seq_len);
  return cudaGetLastError();
}

cudaError_t launch_split(const int8_t* q, const int8_t* db, const int* zc,
                         int* hist, int B, int n_valid, int EP, int seq_len,
                         int splits, cudaStream_t s) {
  if (splits > (n_valid + S_BN - 1) / S_BN) return cudaErrorInvalidValue;
  const int smem = split_smem(EP) + S_BM * (seq_len + 1) * (int)sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      hist_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + S_BM - 1) / S_BM, splits);
  hist_split_kernel<<<grid, S_THREADS, smem, s>>>(q, db, zc, hist, B, n_valid,
                                                  EP, seq_len);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`: zero hist, then scan. q: int8 [B, EP], db: int8
// [W, EP], zc: int32 [W], hist: int32 [B, seq_len + 1]. The route
// follows EP: the split tile up to S_KS * 32 bytes (L <= 64), "kchunk"
// up to RESIDENT_EP_MAX (L <= 168), "kchunk_stream" past it; splits
// db splits, 1 <= splits <= the route's steps over n_valid (64, 128 and
// 256 db rows a step). Requires EP % 32 == 0, 4 * seq_len <= EP,
// seq_len < HIST_MAX, W % 64 == 0, 1 <= n_valid <= W, B >= 1, 16-byte
// aligned q and db, and the port's operands (ops/distance.py), whose
// score q . db + zc of a db row below n_valid lies in [0, seq_len].
// Returns the cudaError_t of the launches.
extern "C" int smafa_hist(const void* q, const void* db, const void* zc,
                          void* hist, int B, int n_valid, int EP, int seq_len,
                          int splits, void* stream) {
  if (B < 1 || n_valid < 1 || splits < 1 || seq_len < 1 ||
      seq_len >= HIST_MAX || EP % 32 || 4 * seq_len > EP) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      hist, 0, (size_t)B * (seq_len + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* dp = static_cast<const int8_t*>(db);
  const auto* zp = static_cast<const int*>(zc);
  auto* hp = static_cast<int*>(hist);
  if (EP <= S_KS * 32) {
    err = launch_split(qp, dp, zp, hp, B, n_valid, EP, seq_len, splits, s);
  } else if (EP <= RESIDENT_EP_MAX) {
    err = launch_chunked<4, 256, false>(qp, dp, zp, hp, B, n_valid, EP,
                                        seq_len, splits, s);
  } else {
    err = launch_chunked<2, 128, true>(qp, dp, zp, hp, B, n_valid, EP,
                                       seq_len, splits, s);
  }
  return (int)err;
}
