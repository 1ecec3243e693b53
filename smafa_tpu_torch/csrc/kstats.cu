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
// The first version (kstats_kernel below) reached 5.85% of that: its
// grid of ceil(B / 128) blocks each walked every row (32 blocks on 132
// SMs at B = 4096, so its time was flat in B), it fed mma.sync from
// 32-bit shared loads behind load-then-sync copies, and its epilogue
// re-derived each distance and branched on n_valid in every tile.
//
// What the design does about it (kstats_split_kernel):
// 1. compact.cu's split-W tensor-core tile (split_tile.cuh; see min2.cu,
//    lever 3) over the live tiles only: ceil(B / 256) query tiles x S db
//    splits, S from ops/kstats.py's launch_plan over tiles =
//    ceil(n_valid / 64), split y walking tiles tiles * y / S up to
//    tiles * (y + 1) / S. With S > 1 the splits write int32 partials
//    [5, S, B] (4 counts, then mx) to scratch the wrapper allocates, and
//    kstats_merge_kernel, launched right after on the same stream, sums
//    the counts and takes the max of mx; no atomics.
// 2. An epilogue in scores: the mma.sync accumulators start at the
//    columns' zc, so each ends as the window's score (matches, in
//    [0, L] for the port's operands), and dist <= ts iff score >=
//    seq_len - ts, a per-row bound. The max distance is seq_len minus
//    the min score, folded two accumulators per DPX __vimin3_s32. Only
//    the last live tile can be partial: the split that owns it masks its
//    columns >= n_valid in a separate epilogue, and every other tile runs
//    branch-free. The four lanes that share a row merge by xor shuffles.
// 3. Counting four probes at once below 64 bp (tally_bytes): the four
//    bounds of a row sit in the bytes of one register, one IMAD compares
//    a score with all four, and masked sums count three scores a step,
//    ~2.7 instructions an accumulator where a compare and a predicated
//    add per probe (tally_pairs, which 64 bp windows take) take 8. The
//    counts live as 16-bit pairs flushed every PAIR_TILES tiles. The
//    epilogue's instruction count, not the pipe it runs on nor where its
//    state lives, set the time: tools/torch_kstats_variant_probe.py
//    builds patched copies of this file (int counts, one block per SM,
//    bounds in shared memory) and times them beside it (PERF.md,
//    section 6).
//
// Longer windows (EP > 256) take kstats_kernel, the first version's loop
// on scan_tile.cuh, one split.

#include <climits>

#include "scan_tile.cuh"
#include "split_tile.cuh"

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
    const long long b = row < B ? (long long)seq_len - ts[(long)p * B + row]
                                : (long long)INT_MAX;
    return BYTES ? 64 - (int)max(0LL, min(64LL, b))
                 : (int)min((long long)INT_MAX, b);
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
    // Merge the 4 lanes (t = 0..3) that share each row; the first chunk
    // writes the split's partials, later ones add to them.
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
          *o = c0 == 0 ? c[p] : *o + c[p];
        }
        mx_out[(long)y * B + row] = seq_len - m;
      }
    }
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

// Long windows (EP > S_KS * 32): the first version, one split. A block
// of scan_tile::BM rows walks every live db tile; outputs final.
__global__ void __launch_bounds__(scan_tile::THREADS)
    kstats_kernel(const int8_t* __restrict__ q,
                  const int8_t* __restrict__ db, const int* __restrict__ zc,
                  const int* __restrict__ ts, int* __restrict__ cnt_out,
                  int* __restrict__ mx_out, int B, int n_valid, int EP,
                  int seq_len, int kc_max) {
  using namespace scan_tile;
  extern __shared__ __align__(16) int8_t smem[];
  const bool resident = kc_max == EP;
  const int stride = kc_max + PAD;
  int8_t* sQ = smem;
  int8_t* sD = smem + BM * stride;
  int* sZ = reinterpret_cast<int*>(sD + BN * stride);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID: fragment row / db column
  const int t = lane & 3;   // mma threadID_in_group
  const long q0 = (long)blockIdx.x * BM;
  const int q_valid = min((long)BM, (long)B - q0);

  // This lane's two rows (warp*16 + g and + 8): thresholds, counts over
  // the db columns it owns (2t, 2t+1 of every n-tile), and max distance.
  int th[2][PROBES];
  int cnt[2][PROBES];
  int mx[2] = {-1, -1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g + 8 * i;
#pragma unroll
    for (int p = 0; p < PROBES; ++p) {
      th[i][p] = row < q_valid ? ts[(long)p * B + q0 + row] : -1;
      cnt[i][p] = 0;
    }
  }

  if (resident) load_tile(sQ, q, q0, BM, q_valid, EP, 0, EP, stride);

  // The last tile may reach past n_valid but stays inside the buffer,
  // whose row count is a multiple of BN.
  for (int w0 = 0; w0 < n_valid; w0 += BN) {
    int acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
    }
    for (int k0 = 0; k0 < EP; k0 += kc_max) {
      const int kc = min(kc_max, EP - k0);
      __syncthreads();  // the previous tile's readers are done
      if (!resident) load_tile(sQ, q, q0, BM, q_valid, EP, k0, kc, stride);
      load_tile(sD, db, w0, BN, BN, EP, k0, kc, stride);
      if (k0 == 0 && threadIdx.x < BN) sZ[threadIdx.x] = zc[w0 + threadIdx.x];
      __syncthreads();
      const int8_t* qa = sQ + (warp * 16 + g) * stride + (resident ? k0 : 0);
      const int8_t* qb = qa + 8 * stride;
      for (int kk = 0; kk < kc; kk += 32) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(qa + kk + t * 4);
        a[1] = *reinterpret_cast<const uint32_t*>(qb + kk + t * 4);
        a[2] = *reinterpret_cast<const uint32_t*>(qa + kk + 16 + t * 4);
        a[3] = *reinterpret_cast<const uint32_t*>(qb + kk + 16 + t * 4);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int8_t* bp = sD + (n * 8 + g) * stride + kk + t * 4;
          uint32_t b[2];
          b[0] = *reinterpret_cast<const uint32_t*>(bp);
          b[1] = *reinterpret_cast<const uint32_t*>(bp + 16);
          mma_s8(acc[n], a, b);
        }
      }
    }
    // Epilogue. Accumulator r of n-tile n holds row g + 8 * (r >> 1),
    // db column n * 8 + 2t + (r & 1). Only the last tile can be partial.
    const bool whole = w0 + BN <= n_valid;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = n * 8 + 2 * t + (r & 1);
        if (whole || w0 + col < n_valid) {
          const int i = r >> 1;
          const int dist = seq_len - acc[n][r] - sZ[col];
#pragma unroll
          for (int p = 0; p < PROBES; ++p) cnt[i][p] += dist <= th[i][p];
          mx[i] = max(mx[i], dist);
        }
      }
    }
  }

  // Merge the 4 lanes (t = 0..3) that share each row.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
      for (int p = 0; p < PROBES; ++p) {
        cnt[i][p] += __shfl_xor_sync(0xffffffffu, cnt[i][p], off);
      }
      mx[i] = max(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }
    const int row = warp * 16 + g + 8 * i;
    if (t == 0 && row < q_valid) {
#pragma unroll
      for (int p = 0; p < PROBES; ++p) cnt_out[(long)p * B + q0 + row] = cnt[i][p];
      mx_out[q0 + row] = mx[i];
    }
  }
}

// The split kernel; with splits > 1 it writes part = [cnt x 4, mx] x
// [splits, B] and the merge follows.
cudaError_t launch_split(const int8_t* q, const int8_t* db, const int* zc,
                         const int* ts, int* cnt, int* mx, int* part, int B,
                         int n_valid, int EP, int seq_len, int splits,
                         cudaStream_t s) {
  const bool direct = splits == 1;
  const bool bytes = seq_len < 64;  // byte lanes need scores below 64
  const auto kernel = bytes ? &kstats_split_kernel<true> : &kstats_split_kernel<false>;
  const int smem = split_smem(EP);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((B + S_BM - 1) / S_BM, splits), S_THREADS, smem, s>>>(
      q, db, zc, ts, direct ? cnt : part,
      direct ? mx : part + (long)PROBES * splits * B, B, n_valid, EP, seq_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  kstats_merge_kernel<<<(B + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                        0, s>>>(part, cnt, mx, B, splits);
  return cudaGetLastError();
}

cudaError_t launch_long(const int8_t* q, const int8_t* db, const int* zc,
                        const int* ts, int* cnt, int* mx, int B, int n_valid,
                        int EP, int seq_len, cudaStream_t s) {
  const int kc_max = scan_tile::pick_kc(EP);
  const size_t smem = scan_tile::smem_bytes(kc_max);
  const cudaError_t err = cudaFuncSetAttribute(
      kstats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kstats_kernel<<<(B + scan_tile::BM - 1) / scan_tile::BM, scan_tile::THREADS,
                  smem, s>>>(q, db, zc, ts, cnt, mx, B, n_valid, EP, seq_len,
                             kc_max);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// ts and cnt: int32 [4, B], mx: int32 [B]; part: int32 [5, splits, B]
// scratch when splits > 1 (else unused). Requires EP % 32 == 0,
// W % 64 == 0, 1 <= n_valid <= W, B >= 1, 16-byte aligned q and db,
// 1 <= splits <= ceil(n_valid / 64) when EP <= 256, splits == 1 when
// EP > 256, and the port's operands (ops/distance.py), whose score
// q . db + zc of a db row below n_valid lies in [0, seq_len]. Returns
// the cudaError_t of the launches.
extern "C" int smafa_kstats(const void* q, const void* db, const void* zc,
                            const void* ts, void* cnt, void* mx, void* part,
                            int B, int n_valid, int EP, int seq_len,
                            int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* dp = static_cast<const int8_t*>(db);
  const int* zp = static_cast<const int*>(zc);
  const int* tp = static_cast<const int*>(ts);
  int* cp = static_cast<int*>(cnt);
  int* mp = static_cast<int*>(mx);
  if (B < 1 || n_valid < 1) return (int)cudaErrorInvalidValue;
  if (EP > S_KS * 32) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_long(qp, dp, zp, tp, cp, mp, B, n_valid, EP, seq_len, s);
  }
  if (splits < 1 || splits > (n_valid + S_BN - 1) / S_BN) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_split(qp, dp, zp, tp, cp, mp, static_cast<int*>(part), B,
                           n_valid, EP, seq_len, splits, s);
}
