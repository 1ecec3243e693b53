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
// tensor-core work, and B / 128 blocks with one db split left most SMs
// idle at small batches. The levers:
//
// 1. Max-first epilogue (both routes). A row's score in a column is
//    acc + zc, its distance seq_len - score. Each lane folds its 16
//    scores per row in a 64-row tile into the tile's best with
//    __viaddmax_s32 (add and max in one DPX instruction on sm_90); one
//    branch per tile then runs the exact key and count update for the
//    rows whose tile best reaches their running best, ties included. No
//    other tile can change lo, hi or cnt, because a key's distance sits
//    above its index bits. On the short route (Min2Wg) the quad's four
//    lanes share a row's running best (two xor shuffles a row a tile),
//    so the branch runs at the row's records and ties, not at each
//    lane's, and the update takes the lane's hits as a bit mask: their
//    count by popc, lo and hi from its lowest and highest bit.
// 2. Db splits (both routes): query tiles x S db splits, each split a
//    contiguous run of whole 64-row tiles. With S > 1 the splits write
//    lo, hi and cnt partials to int32 scratch [3, S, B] (the wrapper
//    allocates it) and min2_merge_kernel, launched right after on the
//    same stream, takes the min of lo and hi and sums the counts of the
//    splits whose partial distance (lo >> shift) is the row's minimum.
// 3. Feeding the tensor cores.
//    - Up to 64 bp (EP <= 256, min2_wg_kernel): the warp-specialised
//      wgmma tile of wg_scan.cuh: TMA copies into an mbarrier ring, two
//      consumer warpgroups of 128 query rows (A fragments in registers)
//      running wgmma m64n64k32 s8 against each 64-row db step and the
//      epilogue in turn, persistent blocks over query tiles x splits
//      (ops/min2.py short_plan: every split restarts its rows' running
//      best, so min2 takes the fewest splits that fill the card).
//    - Past 64 bp (min2_chunk_kernel): the K-chunked split tile
//      (split_tile.cuh), one block an SM, ceil(B / 256) x S blocks (S
//      from ops/min2.py's launch_plan); each warp owns 32 query rows
//      against a 64-row db tile's columns, mma.sync.m16n8k32 s8 fed by
//      ldmatrix.x4, cp.async copies; each db tile's products run over
//      chunks of 256 bytes of the row, the accumulators held across
//      them, and the epilogue runs after the last. Form (a), query rows
//      resident and a 3-stage ring of db chunks, up to EP = 672 (168
//      bp); form (b), query and db chunks streamed together in a 2-stage
//      ring, past it. Measured (chip_smoke.py, phase 9, against the
//      first loop in one call; NVIDIA H100 80GB HBM3, 700 W): 32768 x
//      2,621,440 at 150 bp, form (a), 189 ms against 593 ms (27.5% of
//      the bound); 4096 x 32,768 at 300 bp, form (b), 1.34 ms (12.1%;
//      the first loop 10.0 ms, tools/torch_long_route_probe.py), at
//      29,903 bp 108 ms (15.0%; 1,192 ms).
//
#include <climits>

#include "split_tile.cuh"
#include "wg_scan.cuh"

namespace {

using namespace split_tile;  // the tile's constants and copy helpers
using wg_tile::PANEL;

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

  // Merge row i's state over the 4 lanes (t = 0..3) of the quad that
  // share the row: the best, the counts at it summed, lo and hi the
  // least.
  __device__ __forceinline__ void merge_quad(int i) {
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
      merge_quad(i);
      const long row = q0 + (i >> 1) * 16 + g + 8 * (i & 1);
      if (t == 0 && row < B) {
        lo_out[out0 + row] = lo[i];
        hi_out[out0 + row] = hi[i];
        if (with_count) cnt_out[out0 + row] = cnt[i];
      }
    }
  }
};

// w |= bit where s == v: a compare and a predicated OR.
__device__ __forceinline__ void set_if_eq(unsigned& w, int s, int v,
                                          unsigned bit) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t@p or.b32 %0, %0, %3;\n\t}"
      : "+r"(w)
      : "r"(s), "r"(v), "r"(bit));
}

// The short route's epilogue (wg_scan.cuh): a lane's running state of
// its rows i = 2M + h (row r0 + 64 M + 8 h): the row's best score, the
// same in the 4 lanes of the quad, and lo, hi and the count at it over
// the db columns the lane owns (8j + 2t + c of every step).
struct Min2Wg : Min2State {
  int* lo_out;
  int* hi_out;
  int* cnt_out;
  int B, W, seq_len, shift, with_count, t;
  long r0;

  __device__ __forceinline__ void begin(long r, const wg_scan::Item&) {
    r0 = r;
    init();
  }

  // Max-first: the step's best score of each of the tile's two rows
  // over the lane's columns (add and max in one DPX instruction), then
  // over the quad's (two xor shuffles), so the quad shares the row's
  // running best; then one branch into the exact update of the rows
  // that reach it. A lane's own best would reach it far more often:
  // ties of random columns at a lane's own maximum.
  template <int M>
  __device__ __forceinline__ void tile(const int (&acc)[32], const int (&z)[16],
                                       int s) {
    int tb[2] = {INT_MIN, INT_MIN};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tb[h] = __viaddmax_s32(acc[4 * j + 2 * h + c], z[2 * j + c], tb[h]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tb[h] = max(tb[h], __shfl_xor_sync(0xffffffffu, tb[h], 1));
      tb[h] = max(tb[h], __shfl_xor_sync(0xffffffffu, tb[h], 2));
    }
    if ((tb[0] >= best[2 * M]) | (tb[1] >= best[2 * M + 1])) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 2 * M + h;
        if (tb[h] < best[i]) continue;
        if (tb[h] > best[i]) {
          best[i] = tb[h];
          cnt[i] = 0;
          lo[i] = hi[i] = BIG_KEY;
        }
        // bit 2j + c: the lane's column 8j + 2t + c scores the best
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            set_if_eq(m, acc[4 * j + 2 * h + c] + z[2 * j + c], tb[h],
                      1u << (2 * j + c));
          }
        }
        if (m) {
          // one key a side: the lowest and the highest column hit
          const int kd = (seq_len - tb[h]) << shift;
          const int bl = __ffs(m) - 1, bh = 31 - __clz(m);
          const int w0 = s * wg_scan::N + 2 * t;
          cnt[i] += __popc(m);
          lo[i] = min(lo[i], kd | (w0 + 8 * (bl >> 1) + (bl & 1)));
          hi[i] = min(hi[i], kd | (W - 1 - (w0 + 8 * (bh >> 1) + (bh & 1))));
        }
      }
    }
  }

  // Merge the 4 lanes that share each row; lane t writes row i = t if
  // below B, into split y's partials (or the outputs when S == 1).
  __device__ __forceinline__ void end(const wg_scan::Item& im) {
    const long out0 = (long)im.y * B;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      merge_quad(i);
      const long row = r0 + 64 * (i >> 1) + 8 * (i & 1);
      if (t == i && row < B) {
        lo_out[out0 + row] = lo[i];
        hi_out[out0 + row] = hi[i];
        if (with_count) cnt_out[out0 + row] = cnt[i];
      }
    }
  }
};

// lo/hi/cnt_out hold [S, B] partials (split y at y * B), or the final
// outputs when S == 1.
template <int NKP>
__global__ void __launch_bounds__(wg_scan::THREADS, 1)
    min2_wg_kernel(const __grid_constant__ CUtensorMap tm_db,
                   const __grid_constant__ CUtensorMap tm_zc,
                   const int8_t* __restrict__ q, int* __restrict__ lo_out,
                   int* __restrict__ hi_out, int* __restrict__ cnt_out, int B,
                   int W, int EP, int seq_len, int shift, int with_count,
                   int S) {
  Min2Wg epi;
  epi.lo_out = lo_out;
  epi.hi_out = hi_out;
  epi.cnt_out = cnt_out;
  epi.B = B;
  epi.W = W;
  epi.seq_len = seq_len;
  epi.shift = shift;
  epi.with_count = with_count;
  epi.t = threadIdx.x & 3;
  wg_scan::run<NKP>(&tm_db, &tm_zc, q, B, W / wg_scan::N, EP, S, epi);
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
// (QRES) or (b) streamed, with Min2State's epilogue; outputs as
// min2_wg_kernel's.
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
// the short route's kernel (wg_scan.cuh) up to EP = wg_scan::EP_MAX, the
// K-chunked one past it, in form (a) up to RESIDENT_EP_MAX.
cudaError_t launch_split(const int8_t* q, const int8_t* db, const int* zc,
                         int* lo, int* hi, int* cnt, int* part, int B, int W,
                         int EP, int seq_len, int shift, int with_count,
                         int splits, cudaStream_t s) {
  const long sb = (long)splits * B;
  const bool direct = splits == 1;
  int* lo_o = direct ? lo : part;
  int* hi_o = direct ? hi : part + sb;
  int* cnt_o = direct ? cnt : part + 2 * sb;
  if (EP <= wg_scan::EP_MAX) {
    return EP <= PANEL
               ? wg_scan::launch<1>(min2_wg_kernel<1>, db, zc, B, W, EP,
                                    splits, s, q, lo_o, hi_o, cnt_o, B, W,
                                    EP, seq_len, shift, with_count, splits)
               : wg_scan::launch<2>(min2_wg_kernel<2>, db, zc, B, W, EP,
                                    splits, s, q, lo_o, hi_o, cnt_o, B, W,
                                    EP, seq_len, shift, with_count, splits);
  }
  const dim3 grid((B + S_BM - 1) / S_BM, splits);
  return EP <= RESIDENT_EP_MAX
             ? launch_chunked<true>(q, db, zc, lo_o, hi_o, cnt_o, B, W, EP,
                                    seq_len, shift, with_count, grid, s)
             : launch_chunked<false>(q, db, zc, lo_o, hi_o, cnt_o, B, W, EP,
                                     seq_len, shift, with_count, grid, s);
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// outputs int32 [B]; part: int32 [3, splits, B] scratch when splits > 1
// (else unused). Requires EP % 32 == 0, W % 64 == 0, W >= 64,
// 1 <= splits <= W / 64 and 16-byte aligned q, db and zc. Returns the
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
