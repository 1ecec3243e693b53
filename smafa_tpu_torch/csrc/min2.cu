// Best-hit phase A on Hopper: dual packed-key minima (+ tie count) per
// query row, in one pass over the embedded db.
//
// Replaces smafa_tpu/ops/pallas_scan.py:_min2_kernel (entry
// min2_scan_pallas). Same contract, per query row r over db rows w < W:
//
//   dist   = seq_len - q_emb[r] . db_emb[w] - zc[w]
//   lo[r]  = min_w (dist << shift) | w
//   hi[r]  = min_w (dist << shift) | (W - 1 - w)
//   cnt[r] = #{w : dist == min_w dist}                 (with_count only)
//
// The TPU kernel folded zc into an int8 column; here zc is an int32
// vector added in the epilogue, so neither seq_len <= 127 nor a spare
// padded column is needed. Padding rows carry zc = -1 and an all-zero
// embedding, so their distance is exactly seq_len + 1 and never wins.
//
// What bounds it on the H100: the int8 contraction, 2 * B * W * 4L
// operations against 1,979 TOP/s; bytes never do (the db is 256 B a row
// at 60 bp and is read from L2 by every block). The first version's
// loop reached ~10% of that bound at 60 bp and 8.7% at 150 bp: its
// per-pair key epilogue on the CUDA cores, its 32-bit shared-memory
// fragment loads and its load-then-sync tile copies cost more than the
// mma.sync work, and B / 128 blocks with one db split left most SMs
// idle at small batches. What is left is the issue rate of mma.sync and
// the ldmatrix traffic that feeds it (wgmma and TMA are later work).
// The levers:
//
// 1. Max-first epilogue (Min2State::tile, both routes). A row's score
//    in a column is acc + zc, its distance seq_len - score. Each lane
//    folds its 16 scores per row in a 64-row tile into the tile's best
//    with __viaddmax_s32 (add and max in one DPX instruction on sm_90);
//    one branch per tile then runs the exact key and count update for
//    the rows whose tile best reaches their running best, ties
//    included. No other tile can change lo, hi or cnt, because a key's
//    distance sits above its index bits.
// 2. Split-W grid (both routes): ceil(B / 256) query tiles x S db
//    splits, each split a contiguous run of whole 64-row tiles (S from
//    ops/min2.py's launch_plan over the route's resident block slots, 1
//    when the query tiles fill them). With S > 1 the splits write lo,
//    hi and cnt partials to int32 scratch [3, S, B] (the wrapper
//    allocates it) and min2_merge_kernel, launched right after on the
//    same stream, takes the min of lo and hi and sums the counts of the
//    splits whose partial distance (lo >> shift) is the row's minimum.
// 3. Feeding the tensor cores (split_tile.cuh): each warp owns 32 query
//    rows (two m16 tiles) against all 64 columns of a tile, so each B
//    fragment feeds two mma.sync.m16n8k32 s8 products and each A
//    fragment eight; all fragments come from ldmatrix.x4 on shared rows
//    padded by 16 bytes (the eight 16-byte rows of every ldmatrix on
//    distinct banks); copies are cp.async (16 B, .cg) in a ring, one
//    __syncthreads a stage.
//    - Up to 64 bp (EP <= 256, min2_split_kernel): the block's 256
//      query rows stay in shared memory and whole db tiles arrive in a
//      2-stage ring. At 126 registers two blocks (16 warps) share an
//      SM; the variant that kept the A fragments in registers (190
//      registers, one block per SM, 4 stages) was 10-18% slower
//      (PERF.md, section 6).
//    - Past 64 bp (min2_chunk_kernel): the K-chunked tile, one block an
//      SM; each db tile's products run over chunks of 256 bytes of the
//      row, the accumulators held across them, and the epilogue runs
//      after the last. Form (a), query rows resident and a 3-stage ring
//      of db chunks, up to EP = 672 (168 bp); form (b), query and db
//      chunks streamed together in a 2-stage ring, past it. Measured
//      (chip_smoke.py, phase 9, against the first loop in one call;
//      NVIDIA H100 80GB HBM3, 700 W): 32768 x 2,621,440 at 150 bp, form
//      (a), 189 ms against 593 ms (27.5% of the bound); 4096 x 32,768 at
//      300 bp, form (b), 1.34 ms (12.1%; the first loop 10.0 ms,
//      tools/torch_long_route_probe.py), at 29,903 bp 108 ms (15.0%;
//      1,192 ms).
//
#include <climits>

#include "split_tile.cuh"

namespace {

using namespace split_tile;  // the tile's constants and copy helpers

constexpr int MERGE_THREADS = 256;

// A lane's running state of its rows i = 2m + h (row q0 + 16m + g + 8h)
// over the db columns it owns (2t, 2t + 1 of every n-tile): the best
// score, lo, hi and the count at the best.
struct Min2State {
  int best[4], lo[4], hi[4], cnt[4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = INT_MIN;
      lo[i] = hi[i] = BIG_KEY;
      cnt[i] = 0;
    }
  }

  // Max-first epilogue of the 64-row tile from db row w0 (acc[m][n][2h +
  // c]: row i = 2m + h, tile column 8n + 2t + c; sZ the tile's zc): the
  // tile's best score per row, then one branch per tile into the exact
  // update of the rows that reach their best.
  __device__ __forceinline__ void tile(const int (&acc)[2][8][4],
                                       const int* sZ, int t, int w0, int W,
                                       int seq_len, int shift) {
    int tb[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int2 z = *reinterpret_cast<const int2*>(sZ + n * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tb[i] = __viaddmax_s32(acc[i >> 1][n][2 * (i & 1)], z.x, tb[i]);
        tb[i] = __viaddmax_s32(acc[i >> 1][n][2 * (i & 1) + 1], z.y, tb[i]);
      }
    }
    if ((tb[0] >= best[0]) | (tb[1] >= best[1]) | (tb[2] >= best[2]) |
        (tb[3] >= best[3])) {  // rare after the first tiles
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (tb[i] < best[i]) continue;
        if (tb[i] > best[i]) {
          best[i] = tb[i];
          cnt[i] = 0;
          lo[i] = hi[i] = BIG_KEY;
        }
        const int kd = (seq_len - tb[i]) << shift;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = n * 8 + 2 * t + c;
            if (acc[i >> 1][n][2 * (i & 1) + c] + sZ[col] == tb[i]) {
              const int w = w0 + col;
              ++cnt[i];
              lo[i] = min(lo[i], kd | w);
              hi[i] = min(hi[i], kd | (W - 1 - w));
            }
          }
        }
      }
    }
  }

  // Merge the 4 lanes (t = 0..3) that share each row and write the rows
  // below B of the warp from q0 at out0 (split y's partials, or the
  // outputs).
  __device__ __forceinline__ void store(int* lo_out, int* hi_out,
                                        int* cnt_out, long out0, long q0,
                                        int g, int t, int B,
                                        int with_count) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const int ob = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int olo = __shfl_xor_sync(0xffffffffu, lo[i], off);
        const int ohi = __shfl_xor_sync(0xffffffffu, hi[i], off);
        const int ocnt = __shfl_xor_sync(0xffffffffu, cnt[i], off);
        cnt[i] = ob > best[i] ? ocnt : (ob == best[i] ? cnt[i] + ocnt : cnt[i]);
        best[i] = max(best[i], ob);
        lo[i] = min(lo[i], olo);
        hi[i] = min(hi[i], ohi);
      }
      const long row = q0 + (i >> 1) * 16 + g + 8 * (i & 1);
      if (t == 0 && row < B) {
        lo_out[out0 + row] = lo[i];
        hi_out[out0 + row] = hi[i];
        if (with_count) cnt_out[out0 + row] = cnt[i];
      }
    }
  }
};

// lo/hi/cnt_out hold [S, B] partials (split s at s * B), or the final
// outputs when S == 1.
__global__ void __launch_bounds__(S_THREADS, S_BLOCKS_PER_SM)
    min2_split_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ db,
                      const int* __restrict__ zc, int* __restrict__ lo_out,
                      int* __restrict__ hi_out, int* __restrict__ cnt_out,
                      int B, int W, int EP, int seq_len, int shift,
                      int with_count) {
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

  Min2State st;
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
    const int8_t* sD = ring + (it % S_STAGES) * sbytes;
    const int* sZ = reinterpret_cast<const int*>(sD + S_BN * stride);
    const int w0 = (t_begin + it) * S_BN;
    // acc[m][n][2h + c]: row i = 2m + h, tile column 8n + 2t + c.
    int acc[2][8][4];
    zero_acc(acc);
    tile_mma(acc, a_row, sD + b_off, stride, nks);
    st.tile(acc, sZ, t, w0, W, seq_len, shift);
  }
  cp_async_wait<0>();

  st.store(lo_out, hi_out, cnt_out, (long)blockIdx.y * B, q0, g, t, B,
           with_count);
}

// part: int32 [3, S, B] (lo, hi, cnt partials of the S splits).
__global__ void min2_merge_kernel(const int* __restrict__ part,
                                  int* __restrict__ lo, int* __restrict__ hi,
                                  int* __restrict__ cnt, int B, int S,
                                  int shift, int with_count) {
  const int r = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (r >= B) return;
  const long sb = (long)S * B;
  int l = BIG_KEY, h = BIG_KEY;
  for (int s = 0; s < S; ++s) {
    l = min(l, part[(long)s * B + r]);
    h = min(h, part[sb + (long)s * B + r]);
  }
  lo[r] = l;
  hi[r] = h;
  if (with_count) {
    const int d = l >> shift;
    int c = 0;
    for (int s = 0; s < S; ++s) {
      if ((part[(long)s * B + r] >> shift) == d) c += part[2 * sb + (long)s * B + r];
    }
    cnt[r] = c;
  }
}

// Long windows (EP > S_KS * 32): the K-chunked split tile
// (split_tile.cuh kchunk_scan), form (a) with the query rows resident
// (QRES) or (b) streamed, on the split kernel's grid and epilogue;
// outputs as min2_split_kernel's.
template <bool QRES>
__global__ void __launch_bounds__(S_THREADS, K_BLOCKS_PER_SM)
    min2_chunk_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ db,
                      const int* __restrict__ zc, int* __restrict__ lo_out,
                      int* __restrict__ hi_out, int* __restrict__ cnt_out,
                      int B, int W, int EP, int seq_len, int shift,
                      int with_count) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID: fragment row / db column
  const int t = lane & 3;   // mma threadID_in_group
  const long q0 = (long)blockIdx.x * S_BM + warp * 32;
  const int tiles = W / S_BN;
  const int t_begin = (int)((long)tiles * blockIdx.y / gridDim.y);
  const int nt = (int)((long)tiles * (blockIdx.y + 1) / gridDim.y) - t_begin;

  Min2State m2;
  m2.init();
  kchunk_scan<QRES>(
      smem, q, db, zc, (long)blockIdx.x * S_BM, B, EP, t_begin, nt, q0 < B,
      [](int (&acc)[2][8][4], const int*) { zero_acc(acc); },
      [&](const int (&acc)[2][8][4], const int* sZ, int it) {
        m2.tile(acc, sZ, t, (t_begin + it) * S_BN, W, seq_len, shift);
      });
  m2.store(lo_out, hi_out, cnt_out, (long)blockIdx.y * B, q0, g, t, B,
           with_count);
}

template <bool QRES>
cudaError_t launch_chunked(const int8_t* q, const int8_t* db, const int* zc,
                           int* lo, int* hi, int* cnt, int B, int W, int EP,
                           int seq_len, int shift, int with_count,
                           dim3 grid, cudaStream_t s) {
  const int smem = kchunk_smem<QRES>(EP);
  const cudaError_t err = cudaFuncSetAttribute(
      min2_chunk_kernel<QRES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  min2_chunk_kernel<QRES><<<grid, S_THREADS, smem, s>>>(
      q, db, zc, lo, hi, cnt, B, W, EP, seq_len, shift, with_count);
  return cudaGetLastError();
}

// With splits > 1 the kernel writes part = [lo, hi, cnt] x [splits, B]:
// the short route's kernel up to EP = S_KS * 32, the K-chunked one past
// it, in form (a) up to RESIDENT_EP_MAX.
cudaError_t launch_split(const int8_t* q, const int8_t* db, const int* zc,
                         int* lo, int* hi, int* cnt, int* part, int B, int W,
                         int EP, int seq_len, int shift, int with_count,
                         int splits, cudaStream_t s) {
  const long sb = (long)splits * B;
  const bool direct = splits == 1;
  int* lo_o = direct ? lo : part;
  int* hi_o = direct ? hi : part + sb;
  int* cnt_o = direct ? cnt : part + 2 * sb;
  const dim3 grid((B + S_BM - 1) / S_BM, splits);
  if (EP > S_KS * 32) {
    return EP <= RESIDENT_EP_MAX
               ? launch_chunked<true>(q, db, zc, lo_o, hi_o, cnt_o, B, W, EP,
                                      seq_len, shift, with_count, grid, s)
               : launch_chunked<false>(q, db, zc, lo_o, hi_o, cnt_o, B, W, EP,
                                       seq_len, shift, with_count, grid, s);
  }
  const int smem = split_smem(EP);
  const cudaError_t err = cudaFuncSetAttribute(
      min2_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  min2_split_kernel<<<grid, S_THREADS, smem, s>>>(
      q, db, zc, lo_o, hi_o, cnt_o, B, W, EP, seq_len, shift, with_count);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// outputs int32 [B]; part: int32 [3, splits, B] scratch when splits > 1
// (else unused). Requires EP % 32 == 0, W % 64 == 0, W >= 64,
// 1 <= splits <= W / 64 and 16-byte aligned q and db. Returns the
// cudaError_t of the launches.
extern "C" int smafa_min2(const void* q, const void* db, const void* zc,
                          void* lo, void* hi, void* cnt, void* part, int B,
                          int W, int EP, int seq_len, int shift,
                          int with_count, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* lp = static_cast<int*>(lo);
  int* hp = static_cast<int*>(hi);
  int* cp = static_cast<int*>(cnt);
  if (splits < 1 || splits > W / S_BN) return (int)cudaErrorInvalidValue;
  int* pp = static_cast<int*>(part);
  const cudaError_t err = launch_split(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(db),
      static_cast<const int*>(zc), lp, hp, cp, pp, B, W, EP, seq_len, shift,
      with_count, splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  min2_merge_kernel<<<(B + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                      0, s>>>(pp, lp, hp, cp, B, splits, shift, with_count);
  return (int)cudaGetLastError();
}
