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
// 1. Max-first epilogue (Min2Wg, every route). A row's score in a
//    column is acc + zc, its distance seq_len - score. Each lane folds
//    its 16 scores per row in a 64-row block into the block's best with
//    __viaddmax_s32 (add and max in one DPX instruction on sm_90), the
//    quad's four lanes share a row's running best (two xor shuffles a
//    row a block), and one branch a block runs the exact key and count
//    update for the rows whose block best reaches their running best,
//    ties included, at the row's records and ties only; the update
//    takes the lane's hits as a bit mask: their count by popc, lo and hi
//    from its lowest and highest bit. No other block can change lo, hi
//    or cnt, because a key's distance sits above its index bits.
// 2. Db splits: query tiles x S db splits, each split a contiguous run
//    of whole db steps. With S > 1 the splits write lo, hi and cnt
//    partials to int32 scratch [3, S, B] (the wrapper allocates it) and
//    min2_merge_kernel, launched right after on the same stream, takes
//    the min of lo and hi and sums the counts of the splits whose
//    partial distance (lo >> shift) is the row's minimum. Every split
//    restarts its rows' running best, so min2 takes the fewest splits
//    that fill the card (ops/min2.py short_plan, long_plan).
// 3. Feeding the tensor cores: persistent warp-specialised blocks, one
//    producer thread issuing TMA copies into an mbarrier ring, two
//    consumer warpgroups of 128 query rows running wgmma s8 and the
//    epilogue, one m64 tile's epilogue beside the other's product.
//    - Up to 64 bp (EP <= 256, min2_wg_kernel): wg_scan.cuh, the rows'
//      A fragments in registers, m64n64k32 against each 64-row db step.
//    - Past 64 bp (min2_wgchunk_kernel): wg_long.cuh, K chunks of 128
//      bytes with A and B from shared memory: form (a) up to EP = 640
//      (160 bp) with the block's 256 query rows resident and 64-row db
//      steps; form (b) past it with query and db chunks streamed
//      together, 256 x 128 a step. They replace the K-chunked split
//      tile (mma.sync fed by ldmatrix, cp.async; 27.3% of the bound at
//      150 bp, 14.9% at 29,903 bp; since gone).
//
#include <climits>

#include "wg_long.cuh"
#include "wg_scan.cuh"

namespace {

using wg_tile::set_if_eq;

constexpr int MERGE_THREADS = 256;
constexpr int BIG_KEY = 0x7fffffff;  // the empty packed key

// The epilogue of every route (wg_scan.cuh, wg_long.cuh): a lane's
// running state of its rows i = 2M + h (row r0 + 64 M + 8 h): the row's
// best score, the same in the 4 lanes of the quad, and lo, hi and the
// count at it over the db columns the lane owns (8j + 2t + c of every
// 64-row block).
struct Min2Wg {
  int best[4], lo[4], hi[4], cnt[4];
  int* lo_out;
  int* hi_out;
  int* cnt_out;
  int B, W, seq_len, shift, with_count, t;
  long r0;

  __device__ __forceinline__ void begin(long r, const wg_scan::Item&) {
    r0 = r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = INT_MIN;
      lo[i] = hi[i] = BIG_KEY;
      cnt[i] = 0;
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

// The long routes (wg_long.cuh), NKP panels a row in form (a), 0 in
// form (b); outputs as min2_wg_kernel's.
template <int NKP>
__global__ void __launch_bounds__(wg_long::THREADS, 1)
    min2_wgchunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_db,
                        const __grid_constant__ CUtensorMap tm_zc, int T,
                        int S, int R, int nkp, int* __restrict__ lo_out,
                        int* __restrict__ hi_out, int* __restrict__ cnt_out,
                        int B, int W, int seq_len, int shift,
                        int with_count) {
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
  wg_long::run<NKP>(&tm_q, &tm_db, &tm_zc, B, W, T, S, R, nkp, epi);
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

// With splits > 1 the kernel writes part = [lo, hi, cnt] x [splits, B]:
// the short route's kernel (wg_scan.cuh) up to EP = wg_scan::EP_MAX, the
// long route's (wg_long.cuh) past it, in form (a) up to
// wg_long::EP_A_MAX.
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
    return wg_scan::by_panels(EP, [&](auto panels) {
      constexpr int NKP = decltype(panels)::value;
      return wg_scan::launch<NKP>(min2_wg_kernel<NKP>, db, zc, B, W, EP,
                                  splits, s, q, lo_o, hi_o, cnt_o, B, W, EP,
                                  seq_len, shift, with_count, splits);
    });
  }
  return wg_long::by_form(EP, [&](auto form) {
    constexpr int NKP = decltype(form)::value;
    return wg_long::launch<NKP>(min2_wgchunk_kernel<NKP>, q, db, zc, B, W, EP,
                                splits, s, lo_o, hi_o, cnt_o, B, W, seq_len,
                                shift, with_count);
  });
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
  if (splits < 1 || splits > W / wg_scan::N) return (int)cudaErrorInvalidValue;
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
