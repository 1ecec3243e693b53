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
// operations over 1,979 TOP/s (4.17 ms at 16384 x (2^20 + 37), L = 60),
// beside one shared-memory increment an element (the tally), which at
// 60 bp costs about what the product costs at its peak, and shares the
// shared-memory port with the product's operand reads.
//
// The design (wg_tile.cuh holds the Hopper building blocks):
// 1. Warp specialisation: one thread of a producer warpgroup issues
//    every copy by TMA (128-byte swizzled boxes completing on an
//    mbarrier ring of R stages, R from the shared memory left; a step's
//    zc rides with its first chunk into a ring of its own); two consumer
//    warpgroups run wgmma m64n128k32 s8 and tally. setmaxnreg moves the
//    producer's registers to the consumers (232 a thread, no spills).
//    The tally reads a step's zc by plain loads, and TMA (the async
//    proxy) then refills its slot: each consumer fences the two proxies
//    before it releases the slot (see wg_long.cuh).
// 2. A step (NSTEP db rows against the block's query rows) is K chunks
//    of 128 bytes, one commit group each. Each warpgroup double-buffers
//    its accumulators and tallies step s - 1 in pieces, one after each
//    chunk of step s is issued, so the tally runs while the product is
//    in flight. The chunks a step are a template argument on the routes
//    that overlap: in straight-line code ptxas sees that a tally reads
//    only retired accumulators, where a runtime chunk loop made it
//    serialise every wgmma. The streamed route (up to 32 chunks a step)
//    tallies after a step's last chunk instead.
// 3. Bins are 16-bit, flushed before 65,536 increments, and incremented
//    by red.shared on 32-bit shared addresses (generic atomics cost
//    several times more). On the split route each lane owns copies of
//    its rows' bins ([d][32 lanes] words a warp, a word's halves rows g
//    and g + 8), so a warp's 32 increments fall on 32 banks and never
//    collide; to 168 bp there is room for a copy a lane pair only;
//    past it one copy a row, two bins a word, flushed by all consumers
//    between named barriers.
// 4. Persistent blocks: grid = min(items, SMs), items = query tiles x
//    db splits, query tile fastest (blocks in flight share a db split in
//    L2); ops/hist.py's launch_plan picks the splits so the items fill
//    the SMs.
// 5. Splits merge exactly, as before: each item adds its nonzero bins
//    onto the zeroed output with integer atomics.
//
// Routes (ops/hist.py ROUTES mirrors them), one block an SM, 128 db
// columns a warpgroup's wgmma:
//    - "split" (EP <= 256, L <= 64): 128 query rows (64 a warpgroup),
//      their A fragments in registers for an item (wgmma reads only the
//      db tile from shared memory), db steps of 128 rows, a copy of the
//      bins a lane;
//    - "kchunk" (EP <= 672, L <= 168): the same tile with the query rows
//      resident in shared memory (loaded by TMA once an item), a copy a
//      lane pair;
//    - "kchunk_stream" (L <= 1023): 64 query rows x 256 db rows a step
//      (128 a warpgroup), query and db K chunks streamed together, one
//      copy a row.
//
// Probe builds (tools/torch_hist_probe.py; the library never sets
// them): HIST_PROBE_PRODUCT_ONLY replaces the tally by a register sum,
// HIST_PROBE_TALLY_ONLY the product by scores made from zc and the
// indices, HIST_PROBE_COPIES_ONLY drops both (the copies and the ring).
//
#include <algorithm>

#include "wg_tile.cuh"

namespace {

using namespace wg_tile;

constexpr int HIST_MAX = 1024;  // smafa_tpu_torch/ops/keys.py HIST_MAX
constexpr int SMEM_LIMIT = 232448;  // shared bytes a block can use
constexpr int CONSUMER_WARPS = 8;   // two consumer warpgroups
// and a producer warpgroup, one thread of which issues the copies. With
// setmaxnreg it hands its registers to the consumers: 384 threads alone
// cap a thread at 168 registers, and so does a lone producer warp beside
// 8 consumer warps (3 warps on one SM sub-partition's register file).
constexpr int THREADS = (CONSUMER_WARPS + 4) * 32;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int RING_MAX = 6;   // stages of the TMA ring at most
constexpr int ZS = 4;         // steps' zc in flight (a ring of its own)
constexpr int SLACK = 1024;   // aligning the dynamic shared base
constexpr int BAR_BYTES = 256;

// The routes: query rows a block (QR), db rows a step (NSTEP), the
// copies of a row's bins (COPIES), where the query rows live for an
// item: A fragments in registers (AREG, EP <= 256: wgmma reads only B
// from shared memory, whose port the tally's increments share), K
// chunks streamed beside the db's (ASTR), else resident in shared memory;
// warpgroup u's first query row and db column within the block's tile.
// Every warpgroup runs m64n128 (N). Bins are 16-bit. COPIES = 4 or 2:
// the quad's lanes t (or lane pairs t / 2) own copies of their rows'
// bins, [d][8 COPIES] words a warp, a word's halves rows g and g + 8, so
// a warp's increments fall on distinct banks (4: all 32; 2: a pair's two
// lanes share a word column); 0: one copy a row, two bins a word.
template <int R>
struct Route;
template <>
struct Route<0> {  // "split"
  static constexpr int QR = 128, NSTEP = 128, COPIES = 4;
  static constexpr bool AREG = true, ASTR = false;
  __device__ static int row_off(int u) { return 64 * u; }
  __device__ static int col_off(int) { return 0; }
};
template <>
struct Route<1> {  // "kchunk": no room for four copies beside the rows
  static constexpr int QR = 128, NSTEP = 128, COPIES = 2;
  static constexpr bool AREG = false, ASTR = false;
  __device__ static int row_off(int u) { return 64 * u; }
  __device__ static int col_off(int) { return 0; }
};
template <>
struct Route<2> {  // "kchunk_stream": nor for two beside the bins
  static constexpr int QR = 64, NSTEP = 256, COPIES = 0;
  static constexpr bool AREG = false, ASTR = true;
  __device__ static int row_off(int) { return 0; }
  __device__ static int col_off(int u) { return 128 * u; }
};
constexpr int N = 128;  // db columns of a warpgroup's wgmma

// The query rows resident in shared memory for an item.
template <class C>
__host__ __device__ constexpr bool a_resident() {
  return !C::AREG && !C::ASTR;
}

__host__ __device__ inline int panels(int ep) { return (ep + PANEL - 1) / PANEL; }

// Words a bin row takes (COPIES == 0): odd, so rows start on spread
// banks.
__host__ __device__ inline int row_words(int seq_len) {
  return ((seq_len + 2) / 2) | 1;
}

// Bytes of a ring stage: a db K chunk, and the query K chunk beside it
// when streamed.
template <class C>
__host__ __device__ int stage_bytes() {
  return ((C::ASTR ? C::QR : 0) + C::NSTEP) * PANEL;
}

template <class C>
__host__ __device__ int bins_bytes(int seq_len) {
  return C::COPIES ? CONSUMER_WARPS * (seq_len + 1) * 8 * C::COPIES * 4
                  : C::QR * row_words(seq_len) * 4;
}

// Shared bytes of everything but the ring: the resident query rows, the
// zc ring, the bins, the barriers and the alignment slack.
template <class C>
__host__ __device__ int fixed_bytes(int seq_len, int ep) {
  return (a_resident<C>() ? panels(ep) * C::QR * PANEL : 0) + ZS * C::NSTEP * 4 +
         bins_bytes<C>(seq_len) + BAR_BYTES + SLACK;
}

// Steps between flushes of the 16-bit bins, from the most increments a
// bin takes a step: N / COPIES columns of a row (the lanes sharing a
// copy), or every column of the step (one copy).
template <class C>
__host__ __device__ constexpr int flush_steps() {
  return 65535 / (C::COPIES ? N / C::COPIES : C::NSTEP);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
}

// One arrival of this warp on bar, after all its lanes are done.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

#ifdef HIST_PROBE_TALLY_ONLY
// Probe build: a score about L/4 made from an index, a row part plus a
// column part, each uniform in [-a, a) with a = 1.22 sd, sd ~
// sqrt(3L/16) (a random read's scores against random windows).
__device__ __forceinline__ int probe_dev(uint32_t x, int a) {
  const uint32_t h = x * 0x9E3779B1u;
  return (int)(((h >> 24) * (uint32_t)(2 * a)) >> 8) - a;
}
#endif

// Add the scores of accumulator acc (a warpgroup's m64 x N fragment:
// acc[4j + 2h + c] is row g + 8h, column 8j + 2t + c) to the bins, for
// 8-column groups j in [jlo, jhi). z: the zc of the fragment's columns;
// MASKED: only columns below rem count. r0, r1: shared byte addresses;
// COPIES > 0: the lane's column of its warp's bins, bin d of half h at
// r0 + 32 COPIES d; else the bin rows of rows g and g + 8.
template <int COPIES, bool MASKED, int K>
__device__ __forceinline__ void tally(const int (&acc)[K], uint32_t r0,
                                      uint32_t r1, const int* z, int seq_len,
                                      int t, int rem, int jlo, int jhi,
                                      long row0, long col0) {
#ifdef HIST_PROBE_COPIES_ONLY
  return;
#endif
#ifdef HIST_PROBE_PRODUCT_ONLY
  int probe_sum = 0;
#endif
#ifdef HIST_PROBE_TALLY_ONLY
  const int a = max(1, (int)(1.22f * sqrtf(3.f * seq_len / 16.f)));
  const int rp[2] = {seq_len / 4 + probe_dev((uint32_t)row0, a),
                     seq_len / 4 + probe_dev((uint32_t)(row0 + 8), a)};
#endif
#pragma unroll
  for (int j = 0; j < K / 4; ++j) {
    if (j < jlo || j >= jhi) continue;
    const int2 zz = *reinterpret_cast<const int2*>(z + 8 * j + 2 * t);
    const int lz[2] = {seq_len - zz.x, seq_len - zz.y};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (MASKED && 8 * j + 2 * t + c >= rem) continue;
#ifdef HIST_PROBE_TALLY_ONLY
      const int cp = probe_dev((uint32_t)(col0 + 8 * j + 2 * t + c) ^ 0x5bd1e995u, a);
#endif
      int d[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#ifdef HIST_PROBE_TALLY_ONLY
        const int v = rp[h] + cp;
#else
        const int v = acc[4 * j + 2 * h + c];
#endif
        d[h] = (int)min((unsigned)(lz[c] - v), (unsigned)seq_len);
      }
#ifdef HIST_PROBE_PRODUCT_ONLY
      probe_sum += d[0] + d[1];
#else
      if (COPIES) {
        red_add_shared(r0 + 32 * COPIES * d[0], 1u);
        red_add_shared(r0 + 32 * COPIES * d[1], 1u << 16);
      } else {
        red_add_shared(r0 + ((d[0] >> 1) << 2), 1u << ((d[0] & 1) << 4));
        red_add_shared(r1 + ((d[1] >> 1) << 2), 1u << ((d[1] & 1) << 4));
      }
#endif
    }
  }
#ifdef HIST_PROBE_PRODUCT_ONLY
  if (probe_sum == 0x7fffffff) red_add_shared(r0, 1u);  // never: keeps the sum
#endif
}

// COPIES > 0: one warp's flush of its own bins (wreg: (L + 1) bins x
// 8 COPIES words): the copies of a row's bin added and put onto the
// output, rows at or past B dropped; the bins zeroed. row0: the warp's
// row at g = 0, h = 0.
template <int COPIES>
__device__ void flush_lanes(uint32_t* wreg, int* __restrict__ hist, long row0,
                            int B, int nb, int lane) {
  __syncwarp();
  for (int i = lane; i < nb * 8; i += 32) {
    const int d = i >> 3, gg = i & 7;
    uint32_t* p = wreg + (d * 8 + gg) * COPIES;
    uint32_t v[COPIES];
#pragma unroll
    for (int c = 0; c < COPIES; ++c) v[c] = p[c];
    int lo = 0, hi = 0;
#pragma unroll
    for (int c = 0; c < COPIES; ++c) {
      lo += (int)(v[c] & 0xffff);
      hi += (int)(v[c] >> 16);
      p[c] = 0;
    }
    const long row = row0 + gg;
    if (lo && row < B) atomicAdd(hist + row * nb + d, lo);
    if (hi && row + 8 < B) atomicAdd(hist + (row + 8) * nb + d, hi);
  }
  __syncwarp();
}

// COPIES == 0: the flush by all consumers: each nonzero word of the
// block's bin rows (rs words a row) onto the output, rows at or past B
// dropped; the bins zeroed. The high half of a last odd word is bin nb,
// never incremented.
__device__ void flush_rows(uint32_t* bins, int* __restrict__ hist, long b0,
                           int rows, int rs, int B, int nb) {
  consumer_sync();
  for (int i = threadIdx.x; i < rows * rs; i += CONSUMER_WARPS * 32) {
    const uint32_t v = bins[i];
    if (v == 0) continue;
    bins[i] = 0;
    const int r = i / rs, w = i - r * rs;
    if (b0 + r >= B) continue;
    int* out = hist + (b0 + r) * nb + 2 * w;
    if (v & 0xffff) atomicAdd(out, (int)(v & 0xffff));
    if (v >> 16) atomicAdd(out + 1, (int)(v >> 16));
  }
  consumer_sync();
}

struct Ring {
  uint8_t* stages;
  int* zring;
  uint64_t* full;    // [R] a stage's copies landed
  uint64_t* empty;   // [R] a stage read by every consumer warp
  uint64_t* zempty;  // [ZS] a step's zc read by every consumer warp
  uint64_t* afull;   // the resident query rows landed (kchunk)
  uint64_t* aempty;  // ... and no longer read
  int R, stage;
};

// An item's query tile and db steps [s0, s1).
struct Item {
  long b0;
  int s0, s1;
};

template <class C>
__device__ __forceinline__ Item item_of(int it, int qtiles, int T, int S) {
  const int qt = it % qtiles, y = it / qtiles;
  return {(long)qt * C::QR, (int)((long)T * y / S),
          (int)((long)T * (y + 1) / S)};
}

// The producer (one thread): every copy of every item of this block, in
// the order the consumers take them. Chunk p of a step is bytes [128p,
// 128p + 128) of its db rows (and, streamed, of the block's query rows).
template <class C>
__device__ void produce(const CUtensorMap* tq, const CUtensorMap* tdb,
                        const CUtensorMap* tzc, Ring rg, uint8_t* sA,
                        int qtiles, int T, int S, int EP) {
  const int nkp = panels(EP);
  uint32_t J = 0, Z = 0, n = 0;
  for (int it = blockIdx.x; it < qtiles * S; it += gridDim.x, ++n) {
    const Item im = item_of<C>(it, qtiles, T, S);
    if (a_resident<C>()) {
      mbar_wait(rg.aempty, (n & 1) ^ 1);
      mbar_expect_tx(rg.afull, nkp * C::QR * PANEL);
      for (int p = 0; p < nkp; ++p) {
        tma_load_2d(sA + p * C::QR * PANEL, tq, p * PANEL, (int)im.b0, rg.afull);
      }
    }
    for (int s = im.s0; s < im.s1; ++s) {
      const int w0 = s * C::NSTEP;
      for (int p = 0; p < nkp; ++p, ++J) {
        const int st = J % rg.R;
        mbar_wait(rg.empty + st, ((J / rg.R) & 1) ^ 1);
        uint8_t* dst = rg.stages + st * rg.stage;
        uint64_t* bar = rg.full + st;
        if (p == 0) {  // the step's zc rides with its first chunk
          const int z = Z % ZS;
          mbar_wait(rg.zempty + z, ((Z / ZS) & 1) ^ 1);
          mbar_expect_tx(bar, rg.stage + C::NSTEP * 4);
          tma_load_1d(rg.zring + z * C::NSTEP, tzc, w0, bar);
          ++Z;
        } else {
          mbar_expect_tx(bar, rg.stage);
        }
        if (C::ASTR) {
          tma_load_2d(dst, tq, p * PANEL, (int)im.b0, bar);
          dst += C::QR * PANEL;
        }
        tma_load_2d(dst, tdb, p * PANEL, w0, bar);
      }
    }
  }
}

// The consumers (two warpgroups). NKP > 0: the K chunks a step, known
// at compile time, so the chunk loop unrolls into straight-line code in
// which ptxas can see that a tally reads only retired accumulators;
// double-buffered accumulators, step s - 1 tallied in pieces, one after
// each K chunk of step s is issued (see the header). NKP == 0 (the
// streamed route, up to 32 chunks a step): one accumulator, each step
// tallied after its last chunk.
template <int RT, int NKP>
__device__ void consume(const int8_t* __restrict__ q,
                        int* __restrict__ hist, Ring rg, uint8_t* sA,
                        uint32_t* bins, int qtiles, int T, int S, int B,
                        int n_valid, int EP, int seq_len) {
  using C = Route<RT>;
  constexpr int NG = N / 8;  // 8-column groups of a fragment
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int nkp = NKP ? NKP : panels(EP);
  const int nb = seq_len + 1, rs = row_words(seq_len);
  const int rloc = C::row_off(u) + 16 * w + g;  // the lane's row, h = 0
  uint32_t* wreg = bins + warp * nb * 8 * C::COPIES;  // COPIES > 0
  const uint32_t r0 = smem_u32(C::COPIES ? wreg + lane * C::COPIES / 4
                                         : bins + rloc * rs);
  const uint32_t r1 = C::COPIES ? r0 : r0 + 32 * rs;
  const int coff = C::col_off(u);
  const int* zbase = rg.zring + coff;
  const bool partial = n_valid % C::NSTEP != 0;
  uint32_t J = 0, Z = 0, n = 0;
  int since = 0;
  int accA[N / 2] = {}, accB[N / 2] = {};
  for (int it = blockIdx.x; it < qtiles * S; it += gridDim.x, ++n) {
    const Item im = item_of<C>(it, qtiles, T, S);
    const long row0 = im.b0 + rloc;
    auto flush = [&]() {
      if constexpr (C::COPIES > 0) {
        flush_lanes<C::COPIES>(wreg, hist, row0 - g, B, nb, lane);
      } else {
        flush_rows(bins, hist, im.b0, C::QR, rs, B, nb);
      }
    };
    if (a_resident<C>()) mbar_wait(rg.afull, n & 1);
    // AREG: the m16n8k32 A fragments of rows row0 and row0 + 8, zero
    // past B and past EP, for the item
    uint32_t af[C::AREG ? 8 : 1][4];
    if constexpr (C::AREG) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long r = row0 + 8 * (i & 1);
          af[k][i] = (32 * k < EP && r < B)
              ? __ldg(reinterpret_cast<const uint32_t*>(
                    q + r * EP + 32 * k + 16 * (i >> 1) + 4 * t))
              : 0u;
        }
      }
    }
    int prev_st = -1, prev_z = 0;
    long prev_w0 = 0;
    // Chunk p of a step into acc, committed; then the chunk before it is
    // waited for and its stage released. Returns the step's zc slot at
    // p == 0.
    auto chunk = [&](int (&acc)[N / 2], int p) {
      const int st = J % rg.R;
      mbar_wait(rg.full + st, (J / rg.R) & 1);
      const uint8_t* tile = rg.stages + st * rg.stage;
      const uint8_t* a = C::ASTR ? tile : sA + (p * C::QR + C::row_off(u)) * PANEL;
      const uint8_t* b = tile + ((C::ASTR ? C::QR : 0) + coff) * PANEL;
      wgmma_fence();
#if !defined(HIST_PROBE_TALLY_ONLY) && !defined(HIST_PROBE_COPIES_ONLY)
      // all four k-steps: bytes past EP are zero (the boxes' fill, or
      // the fragments')
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (C::AREG) {
          wgmma_rs_n128(acc, af[(4 * p + k) & 7], desc_sw128(b + 32 * k),
                        p | k);
        } else {
          wgmma_ss_n128(acc, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k),
                        p | k);
        }
      }
#endif
      wgmma_commit();
      wgmma_wait<1>();  // the chunk before this one done
      if (prev_st >= 0) warp_arrive(rg.empty + prev_st, lane);
      prev_st = st;
      ++J;
    };
    // One step: its K chunks into cur, each followed by a piece of step
    // s - 1's tally from prev.
    auto step = [&](int (&cur)[N / 2], int (&prev)[N / 2], int s) {
      const int zs = Z++ % ZS;
#pragma unroll
      for (int p = 0; p < (NKP ? NKP : 1); ++p) {
        chunk(cur, p);
        fence_regs(prev);
        if (s > im.s0) {
          tally<C::COPIES, false>(prev, r0, r1, zbase + prev_z * C::NSTEP,
                                seq_len, t, 0, NG * p / nkp, NG * (p + 1) / nkp,
                                row0, prev_w0 + coff);
        }
      }
      if (s > im.s0) {
        fence_proxy_async();  // the zc read before TMA may refill the slot
        warp_arrive(rg.zempty + prev_z, lane);
        if (++since == flush_steps<C>()) {
          flush();
          since = 0;
        }
      }
      prev_z = zs;
      prev_w0 = (long)s * C::NSTEP;
    };
    auto last = [&](int (&acc)[N / 2]) {
      fence_regs(acc);
      const int* z = zbase + prev_z * C::NSTEP;
      if (partial && prev_w0 / C::NSTEP == T - 1) {
        tally<C::COPIES, true>(acc, r0, r1, z, seq_len, t,
                             (int)(n_valid - prev_w0 - coff), 0, NG, row0,
                             prev_w0 + coff);
      } else {
        tally<C::COPIES, false>(acc, r0, r1, z, seq_len, t, 0, 0, NG, row0,
                              prev_w0 + coff);
      }
    };
    if constexpr (NKP > 0) {
      // the last step's accumulator retired and tallied in each branch,
      // so no value of one in flight merges from two paths
      auto finish = [&](int (&acc)[N / 2]) {
        wgmma_wait<0>();
        warp_arrive(rg.empty + prev_st, lane);
        if (a_resident<C>()) warp_arrive(rg.aempty, lane);
        last(acc);
      };
      int s = im.s0;
      for (; s + 1 < im.s1; s += 2) {
        step(accA, accB, s);
        step(accB, accA, s + 1);
      }
      if (s < im.s1) {
        step(accA, accB, s);
        finish(accA);
      } else {
        finish(accB);
      }
      fence_proxy_async();
      warp_arrive(rg.zempty + prev_z, lane);
    } else {
      for (int s = im.s0; s < im.s1; ++s) {
        prev_z = Z++ % ZS;
        prev_w0 = (long)s * C::NSTEP;
        for (int p = 0; p < nkp; ++p) chunk(accA, p);
        wgmma_wait<0>();
        warp_arrive(rg.empty + prev_st, lane);
        prev_st = -1;
        last(accA);
        fence_proxy_async();  // the zc read before TMA may refill the slot
        warp_arrive(rg.zempty + prev_z, lane);
        if (s + 1 < im.s1 && ++since == flush_steps<C>()) {
          flush();
          since = 0;
        }
      }
      if (a_resident<C>()) warp_arrive(rg.aempty, lane);
    }
    flush();
    since = 0;
  }
}

template <int RT, int NKP>
__global__ void __launch_bounds__(THREADS, 1)
    hist_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_db,
                const __grid_constant__ CUtensorMap tm_zc,
                const int8_t* __restrict__ q, int* __restrict__ hist, int B,
                int n_valid, int EP, int seq_len, int S, int R) {
  using C = Route<RT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Ring rg;
  rg.R = R;
  rg.stage = stage_bytes<C>();
  rg.stages = base;
  uint8_t* sA = base + R * rg.stage;
  rg.zring = reinterpret_cast<int*>(
      sA + (a_resident<C>() ? panels(EP) * C::QR * PANEL : 0));
  uint32_t* bins = reinterpret_cast<uint32_t*>(rg.zring + ZS * C::NSTEP);
  const int nbins = bins_bytes<C>(seq_len) / 4;
  rg.full = reinterpret_cast<uint64_t*>(bins + nbins);
  rg.empty = rg.full + R;
  rg.zempty = rg.empty + R;
  rg.afull = rg.zempty + ZS;
  rg.aempty = rg.afull + 1;
  for (int i = threadIdx.x; i < nbins; i += THREADS) bins[i] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(rg.full + s, 1);
      mbar_init(rg.empty + s, CONSUMER_WARPS);
    }
    for (int z = 0; z < ZS; ++z) mbar_init(rg.zempty + z, CONSUMER_WARPS);
    mbar_init(rg.afull, 1);
    mbar_init(rg.aempty, CONSUMER_WARPS);
    fence_barrier_init();
  }
  __syncthreads();
  const int qtiles = (B + C::QR - 1) / C::QR;
  const int T = (n_valid + C::NSTEP - 1) / C::NSTEP;
  if (threadIdx.x >= CONSUMER_WARPS * 32) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WARPS * 32) {
      produce<C>(&tm_q, &tm_db, &tm_zc, rg, sA, qtiles, T, S, EP);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<RT, NKP>(q, hist, rg, sA, bins, qtiles, T, S, B, n_valid, EP,
                     seq_len);
  }
}

template <int RT, int NKP>
cudaError_t launch(const int8_t* q, const int8_t* db, const int* zc, int* hist,
                   int B, int n_valid, int EP, int seq_len, int splits,
                   cudaStream_t s) {
  using C = Route<RT>;
  const int T = (n_valid + C::NSTEP - 1) / C::NSTEP;
  if (splits > T) return cudaErrorInvalidValue;
  const int stage = stage_bytes<C>();
  const int fixed = fixed_bytes<C>(seq_len, EP);
  const int R = std::min(RING_MAX, (SMEM_LIMIT - fixed) / stage);
  if (R < 2) return cudaErrorInvalidValue;
  const int smem = fixed + R * stage;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorInvalidValue;
  // db rows to the 64-row tile holding n_valid (the db has that many)
  const int wt = (n_valid + 63) / 64 * 64;
  CUtensorMap tq, tdb, tzc;
  if (!map_rows(enc, &tq, q, EP, B, C::QR) ||
      !map_rows(enc, &tdb, db, EP, wt, C::NSTEP) ||
      !map_ints(enc, &tzc, zc, wt, C::NSTEP)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = &hist_kernel<RT, NKP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidValue;
  const int items = (B + C::QR - 1) / C::QR * splits;
  kernel<<<std::min(items, sms), THREADS, smem, s>>>(
      tq, tdb, tzc, q, hist, B, n_valid, EP, seq_len, splits, R);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`: zero hist, then scan. q: int8 [B, EP], db: int8
// [W, EP], zc: int32 [W], hist: int32 [B, seq_len + 1]. The route
// follows EP: "split" up to 256 bytes (L <= 64), "kchunk" up to 672 (L
// <= 168), "kchunk_stream" past it; splits db splits, 1 <= splits <= the
// route's steps over n_valid (128, 128 and 256 db rows a step); the grid
// is min(query tiles x splits, SMs) persistent blocks. Requires EP % 32
// == 0, 4 * seq_len <= EP, seq_len < HIST_MAX, W % 64 == 0, 1 <= n_valid
// <= W, B >= 1, 16-byte aligned q, db and zc, and the port's operands
// (ops/distance.py), whose score q . db + zc of a db row below n_valid
// lies in [0, seq_len]. Returns the cudaError_t of the launches.
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
  // split and kchunk take their K chunks a step (panels of 128 bytes)
  // at compile time
  switch (EP > 672 ? 0 : panels(EP)) {
    case 1: err = launch<0, 1>(qp, dp, zp, hp, B, n_valid, EP, seq_len, splits, s); break;
    case 2: err = launch<0, 2>(qp, dp, zp, hp, B, n_valid, EP, seq_len, splits, s); break;
    case 3: err = launch<1, 3>(qp, dp, zp, hp, B, n_valid, EP, seq_len, splits, s); break;
    case 4: err = launch<1, 4>(qp, dp, zp, hp, B, n_valid, EP, seq_len, splits, s); break;
    case 5: err = launch<1, 5>(qp, dp, zp, hp, B, n_valid, EP, seq_len, splits, s); break;
    case 6: err = launch<1, 6>(qp, dp, zp, hp, B, n_valid, EP, seq_len, splits, s); break;
    default: err = launch<2, 0>(qp, dp, zp, hp, B, n_valid, EP, seq_len, splits, s);
  }
  return (int)err;
}
