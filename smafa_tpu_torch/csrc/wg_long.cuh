// The long routes (EP > 256 bytes, L > 64) of min2.cu, compact.cu,
// kstats.cu and min_count.cu on Hopper: a warp-specialised, persistent
// scan of query tiles against the db in K chunks of 128 bytes, whose
// caller supplies the epilogue of each 64 x 64 block of scores
// (wg_scan.cuh's interface). Built from wg_tile.cuh.
//
// What bounds the kernels: the int8 contraction, 2 * B * W * 4L
// operations over 1,979 TOP/s (52.1 ms for min2 at 32768 x 2,621,440,
// L = 150; 16.2 ms at 4096 x 32,768, L = 29,903). What held back the
// K-chunked split tile they ran before (mma.sync fed by ldmatrix,
// cp.async; gone): the copies issued and waited for by every warp, one
// __syncthreads a chunk, and in form (b) ~87 KB copied through the SM's
// L2 port for every 8.4 M operations. kstats and min_count scan only
// the first n_valid db rows: their W is the live 64-row blocks' rows,
// and their epilogues mask the last block past n_valid.
//
// The design (one producer thread issues every copy by TMA into
// 128-byte swizzled boxes on an mbarrier ring; two consumer warpgroups
// of 128 query rows, two m64 tiles each, run wgmma s8 with A and B from
// shared memory and the epilogue; setmaxnreg moves the producer's
// registers to them; persistent blocks over query tiles x db splits,
// ordered so that blocks in flight share their operands in L2 (see
// split_fastest_b); ops/min2.py's long_plan picks the splits):
//
// (a) "wg_kchunk", EP <= EP_A_MAX (L <= 160): the block's ROWS query
//     rows stay resident for an item (NKP panels of ROWS x 128 bytes,
//     one TMA load each); a step is NA = 64 db rows in NKP chunks of
//     64 x 128 bytes, each a ring stage, its zc riding with the first
//     chunk into a ring of its own. The two warpgroups take turns
//     (named barriers) issuing a step's products, both their m64 tiles
//     a chunk as one commit group, so that one warpgroup's epilogue runs
//     beside the other's products; each releases a chunk's stage as its
//     group retires. Every group retires within its step and the chunks
//     a step are a template argument (straight-line code), or ptxas
//     serialises the wgmma (C7514 / C7520). A db byte copied feeds 512
//     operations. The ring holds RING_A stages or what shared memory
//     leaves beside the rows (8 at 5 panels), at least a step's chunks.
// (b) "wg_kchunk_stream", any wider EP: a step is ROWS query rows x NB
//     = 128 db rows; each chunk's stage holds the query rows' 128 bytes
//     beside the db rows' (48 KB), RING_B stages. Each warpgroup runs
//     m64n128k32 for both its tiles a chunk (one commit group) and
//     releases the chunk before, in a runtime loop over the chunks (up
//     to 935 a step at 29,903 bp) that reads no accumulator; after the
//     step's last group retires, the epilogue of its two 64-column
//     halves. A byte copied feeds ~171 operations. W need not be a
//     multiple of 128: the boxes zero-fill past W and the epilogue
//     skips the half past it.
//
// The epilogue (class Epi) gets begin(r0, item), tile<M>(acc, z, s) for
// each 64 x 64 block (acc[4j + 2h + c]: the score less zc of row r0 +
// 64 M + 8 h and db row 64 s + 8 j + 2 t + c; z[2j + c] that db row's
// zc), and end(item), as on the short route; the item's steps s0, s1
// it gets are in 64-row blocks.
//
// A step's zc is read by plain loads and its slot then refilled by TMA
// (the async proxy): each consumer fences the two proxies before it
// releases the slot. Without the fence, form (a) at 3 panels (65-96 bp,
// whose 16-stage ring runs 5 steps ahead of the 4 zc slots) read a later
// step's zc now and then: min_count's distances came out a few off in
// a different few rows each run on an H100
// (tests/test_torch_gpu_min_count_long.py runs that shape 40 times). The
// fence also waits for the thread's stores in flight, so it comes
// before an epilogue, not after one: after compact_mask's mask stores
// it cost 4% at 300 bp (chip_smoke.py).
//
// Probe builds (tools/torch_long_route_probe.py --probes; the library
// never sets them): WG_LONG_PROBE_COPIES_ONLY keeps the copies and the
// ring and drops the products and the epilogue; WG_LONG_PROBE_PRODUCTS_ONLY
// keeps the products on whatever shared memory holds, with no copy
// (the producer only arrives) and no epilogue; WG_LONG_PROBE_NO_EPILOGUE
// keeps the copies and the products and drops the epilogue (the three
// keep an accumulator element a step, or ptxas would drop the products).

#pragma once

#include <algorithm>
#include <type_traits>

#include "wg_scan.cuh"

#if defined(WG_LONG_PROBE_COPIES_ONLY) || defined(WG_LONG_PROBE_PRODUCTS_ONLY)
#define WG_LONG_PROBE_NO_EPILOGUE
#endif

namespace wg_long {

using namespace wg_tile;
using wg_scan::Item;
using wg_scan::warp_arrive;

constexpr int CONSUMER_WARPS = 8;  // two consumer warpgroups
// and a producer warpgroup, one thread of which issues the copies
constexpr int THREADS = (CONSUMER_WARPS + 4) * 32;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROWS = 256;          // query rows a block (ops/min2.py WG_ROWS)
constexpr int SMEM_LIMIT = 232448;  // shared bytes a block can use
constexpr int SLACK = 1024;        // aligning the dynamic shared base
constexpr int BAR_BYTES = 512;
constexpr int ZS = 4;              // steps' zc in flight (a ring of its own)
// form (a), ops/min2.py mirrors NA (WG_KCHUNK_STEP) and EP_A_MAX
// (WG_RESIDENT_EP_MAX)
constexpr int NA = 64;             // db rows a step
constexpr int RING_A = 16;         // ring stages at most
constexpr int NKP_MAX = 5;         // panels a row
constexpr int EP_A_MAX = 640;      // NKP_MAX * PANEL
// form (b), ops/min2.py mirrors NB (WG_STREAM_STEP)
constexpr int NB = 128;            // db rows a step
constexpr int RING_B = 4;          // ring stages

__host__ __device__ constexpr int panels(int ep) { return (ep + PANEL - 1) / PANEL; }

// Form (a): the resident rows, the zc ring, the barriers and the slack;
// the ring's stages; the whole block.
__host__ __device__ constexpr int fixed_a(int nkp) {
  return nkp * ROWS * PANEL + ZS * NA * 4 + BAR_BYTES + SLACK;
}
__host__ __device__ constexpr int ring_a(int nkp) {
  return (SMEM_LIMIT - fixed_a(nkp)) / (NA * PANEL) < RING_A
             ? (SMEM_LIMIT - fixed_a(nkp)) / (NA * PANEL)
             : RING_A;
}
__host__ __device__ constexpr int smem_a(int nkp) {
  return fixed_a(nkp) + ring_a(nkp) * NA * PANEL;
}
// Form (b): a stage holds a chunk of the query rows and of the db rows.
__host__ __device__ constexpr int stage_b() { return (ROWS + NB) * PANEL; }
__host__ __device__ constexpr int smem_b() {
  return RING_B * stage_b() + ZS * NB * 4 + BAR_BYTES + SLACK;
}

static_assert(NKP_MAX * PANEL == EP_A_MAX, "form (a)'s widest row");
static_assert(ring_a(NKP_MAX) >= NKP_MAX, "form (a) holds a whole step");
static_assert(smem_a(NKP_MAX) <= SMEM_LIMIT && smem_b() <= SMEM_LIMIT,
              "shared memory");

// Item it of qtiles query tiles x S db splits: query tile fastest (as
// on the short route), or with split_fastest db split fastest.
__device__ __forceinline__ Item item_of(int it, int qtiles, int T, int S,
                                        bool split_fastest) {
  const int qt = split_fastest ? it / S : it % qtiles;
  const int y = split_fastest ? it % S : it / qtiles;
  return {(long)qt * ROWS, (int)((long)T * y / S),
          (int)((long)T * (y + 1) / S), y};
}

// Form (b)'s order. When every item runs at once (query tiles x S
// within the grid): db split fastest if S <= 2 x the query tiles, else
// query tile fastest. With more items than blocks: query tile fastest
// (the blocks in flight then walk few db splits, each db chunk read
// from DRAM about once), unless the query rows of the tiles in flight,
// which every step reads again, outgrow L2_QUERY_MB: then db split
// fastest, which keeps few query tiles in flight. Measured on an H100
// with both orders built (tools/torch_long_route_probe.py; ms split
// fastest vs query tile fastest; tiles x splits): at 29,903 bp x 32,768
// rows, min2 19.3-19.6 vs 40.9-42.2 (16 x 8), 17.3-18.3 vs 28.4-29.5
// (12 x 11), 17.2-18.7 vs 24.4-25.2 (10 x 13), 11.9-12.1 vs 13.7-15.1
// (8 x 16); compact_mask 11.9-12.1 vs 13.5 (8 x 16), 7.2-7.3 vs 6.0-6.2
// (4 x 33), kstats 6.87-7.08 vs 5.98-6.27 (4 x 33); kstats at 300 bp
// 0.086-0.087 vs 0.084 (4 x 33); at 164 bp x 2,621,440 rows, min2
// 13.3-13.6 vs 13.8-14.2 (16 x 8), compact_mask (more items than the
// grid; 1.4 to 5.5 MB of query rows) 8.2 vs 7.4 (8 x 33), 16.9-17.6 vs
// 15.3 (16 x 33), 34.4-34.8 vs 30.9-31.1 (32 x 33); min_count at 300 bp
// x 2^22 rows (40 MB of query rows) 283-295 vs 414-418 (128 x 33).
constexpr int L2_QUERY_MB = 32;  // of an H100's 50 MB L2

__device__ __forceinline__ bool split_fastest_b(int qtiles, int S, int nkp) {
  if (qtiles * S <= (int)gridDim.x) return S <= 2 * qtiles;
  return (long)min(qtiles, (int)gridDim.x) * ROWS * nkp * PANEL >
         ((long)L2_QUERY_MB << 20);
}

struct Ring {
  uint8_t* rows;     // (a) the resident query rows, [NKP][ROWS x PANEL]
  uint8_t* stages;   // [R] stages
  int* zc;           // [ZS][step rows]
  uint64_t* full;    // [R] a stage's copies landed
  uint64_t* empty;   // [R] a stage read by every consumer warp
  uint64_t* zempty;  // [ZS] a step's zc read by every consumer warp
  uint64_t* afull;   // (a) the resident rows landed
  uint64_t* aempty;  // (a) ... and no longer read
  int R;
};

// The producer (one thread): every copy of every item of this block, in
// the order the consumers take them. NKP > 0: form (a); 0: form (b),
// nkp chunks a step.
template <int NKP>
__device__ void produce(const CUtensorMap* tq, const CUtensorMap* tdb,
                        const CUtensorMap* tzc, Ring rg, int qtiles, int T,
                        int S, int nkp) {
  constexpr int step = NKP ? NA : NB;
  constexpr int stage = NKP ? NA * PANEL : stage_b();
  const bool order = !NKP && split_fastest_b(qtiles, S, nkp);
  uint32_t J = 0, Z = 0, n = 0;
  for (int it = blockIdx.x; it < qtiles * S; it += gridDim.x, ++n) {
    const Item im = item_of(it, qtiles, T, S, order);
    if (NKP) {
      mbar_wait(rg.aempty, (n & 1) ^ 1);
#ifdef WG_LONG_PROBE_PRODUCTS_ONLY
      mbar_arrive(rg.afull);
#else
      mbar_expect_tx(rg.afull, NKP * ROWS * PANEL);
#pragma unroll
      for (int p = 0; p < NKP; ++p) {
        tma_load_2d(rg.rows + p * ROWS * PANEL, tq, p * PANEL, (int)im.b0,
                    rg.afull);
      }
#endif
    }
    for (int s = im.s0; s < im.s1; ++s) {
      for (int p = 0; p < nkp; ++p, ++J) {
        const int st = J % rg.R;
        mbar_wait(rg.empty + st, ((J / rg.R) & 1) ^ 1);
        uint8_t* dst = rg.stages + st * stage;
        uint64_t* bar = rg.full + st;
        if (p == 0) {  // the step's zc rides with its first chunk
          const int z = Z % ZS;
          mbar_wait(rg.zempty + z, ((Z / ZS) & 1) ^ 1);
#ifdef WG_LONG_PROBE_PRODUCTS_ONLY
          mbar_arrive(bar);
#else
          mbar_expect_tx(bar, stage + step * 4);
          tma_load_1d(rg.zc + z * step, tzc, s * step, bar);
#endif
          ++Z;
        } else {
#ifdef WG_LONG_PROBE_PRODUCTS_ONLY
          mbar_arrive(bar);
#else
          mbar_expect_tx(bar, stage);
#endif
        }
#ifndef WG_LONG_PROBE_PRODUCTS_ONLY
        if (!NKP) {
          tma_load_2d(dst, tq, p * PANEL, (int)im.b0, bar);
          dst += ROWS * PANEL;
        }
        tma_load_2d(dst, tdb, p * PANEL, s * step, bar);
#endif
      }
    }
  }
}

// z[2j + c] = zs[8j + 2t + c]: the zc of the lane's columns of a
// 64-row block.
__device__ __forceinline__ void zload(int (&z)[16], const int* zs, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int2 v = *reinterpret_cast<const int2*>(zs + 8 * i + 2 * t);
    z[2 * i] = v.x;
    z[2 * i + 1] = v.y;
  }
}

// Wait for this warpgroup's step groups, one a chunk, in order, and
// release each chunk's stage as its group retires: N groups pending.
template <int N, int NKP>
__device__ __forceinline__ void retire_chunks(const Ring& rg, uint32_t J,
                                              int lane) {
  wgmma_wait<N>();
  warp_arrive(rg.empty + (J + NKP - 1 - N) % rg.R, lane);
  if constexpr (N > 0) retire_chunks<N - 1, NKP>(rg, J, lane);
}

// Form (a)'s consumers: see the header.
template <int NKP, class Epi>
__device__ void consume_a(Ring rg, int qtiles, int T, int S, Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, u = warp >> 2;
  // the lane's row of tile 0, half 0, within the block's query tile
  const int rloc = 128 * u + 16 * (warp & 3) + (lane >> 2);
  uint32_t J = 0, Z = 0, n = 0;
  int acc0[NA / 2] = {}, acc1[NA / 2] = {}, z[NA / 4];
#ifdef WG_LONG_PROBE_NO_EPILOGUE
  int sink = 0;
#endif
  // the warpgroups take turns issuing a step's products (named barrier
  // 1 + u is u's turn), so that one's epilogue runs beside the other's
  // products
  if (u == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  for (int it = blockIdx.x; it < qtiles * S; it += gridDim.x, ++n) {
    const Item im = item_of(it, qtiles, T, S, false);
    mbar_wait(rg.afull, n & 1);
    epi.begin(im.b0 + rloc, im);
    for (int s = im.s0; s < im.s1; ++s) {
      const int zs = Z++ % ZS;
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + u) : "memory");
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < NKP; ++p) {  // both tiles a chunk, one group
        const uint32_t j = J + p;
        mbar_wait(rg.full + j % rg.R, (j / rg.R) & 1);
#ifndef WG_LONG_PROBE_COPIES_ONLY
        const uint8_t* a = rg.rows + (p * ROWS + 128 * u) * PANEL;
        const uint8_t* b = rg.stages + (j % rg.R) * NA * PANEL;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_ss_n64(acc0, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k),
                       p | k);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_ss_n64(acc1, desc_sw128(a + 64 * PANEL + 32 * k),
                       desc_sw128(b + 32 * k), p | k);
        }
#endif
        wgmma_commit();
      }
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - u) : "memory");
      retire_chunks<NKP - 1, NKP>(rg, J, lane);
      J += NKP;
      fence_regs(acc0);
      fence_regs(acc1);
      zload(z, rg.zc + zs * NA, t);
      fence_proxy_async();  // the zc read before TMA may refill the slot
      warp_arrive(rg.zempty + zs, lane);
#ifndef WG_LONG_PROBE_NO_EPILOGUE
      epi.template tile<0>(acc0, z, s);
      epi.template tile<1>(acc1, z, s);
#else
      sink += acc0[0] + acc1[0];
#endif
    }
    warp_arrive(rg.aempty, lane);
    epi.end(im);
  }
  if (u == 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");
#ifdef WG_LONG_PROBE_NO_EPILOGUE
  if (sink == 0x12345678) rg.zc[0] = sink;
#endif
}

// Form (b)'s consumers: see the header. W64: the db's 64-row blocks.
template <class Epi>
__device__ void consume_b(Ring rg, int qtiles, int T, int S, int nkp,
                          int W64, Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, u = warp >> 2;
  const int rloc = 128 * u + 16 * (warp & 3) + (lane >> 2);
  uint32_t J = 0, Z = 0;
  int acc0[NB / 2] = {}, acc1[NB / 2] = {}, z[2][16], h[32];
#ifdef WG_LONG_PROBE_NO_EPILOGUE
  int sink = 0;
#endif
  const bool order = split_fastest_b(qtiles, S, nkp);
  for (int it = blockIdx.x; it < qtiles * S; it += gridDim.x) {
    const Item im = item_of(it, qtiles, T, S, order);
    // the item's steps in 64-row blocks, as the epilogue counts them
    const Item ie = {im.b0, 2 * im.s0, min(2 * im.s1, W64), im.y};
    epi.begin(im.b0 + rloc, ie);
    for (int s = im.s0; s < im.s1; ++s) {
      const int zs = Z++ % ZS;
      int prev = -1;
      for (int p = 0; p < nkp; ++p, ++J) {
        const int st = J % rg.R;
        mbar_wait(rg.full + st, (J / rg.R) & 1);
        const uint8_t* a = rg.stages + st * stage_b() + 128 * u * PANEL;
        const uint8_t* b = rg.stages + st * stage_b() + ROWS * PANEL;
        wgmma_fence();
#ifndef WG_LONG_PROBE_COPIES_ONLY
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_ss_n128(acc0, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k),
                        p | k);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_ss_n128(acc1, desc_sw128(a + 64 * PANEL + 32 * k),
                        desc_sw128(b + 32 * k), p | k);
        }
#endif
        wgmma_commit();
        wgmma_wait<1>();  // the chunk before this one done
        if (prev >= 0) warp_arrive(rg.empty + prev, lane);
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      warp_arrive(rg.empty + prev, lane);
      // both halves' zc (zero past W), released before the epilogue
      zload(z[0], rg.zc + zs * NB, t);
      zload(z[1], rg.zc + zs * NB + 64, t);
      fence_proxy_async();
      warp_arrive(rg.zempty + zs, lane);
#ifndef WG_LONG_PROBE_NO_EPILOGUE
      // each 64-column half below W: tile 0's rows, then tile 1's
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 0 || 2 * s + 1 < W64) {
#pragma unroll
          for (int i = 0; i < 32; ++i) h[i] = acc0[32 * q + i];
          epi.template tile<0>(h, z[q], 2 * s + q);
#pragma unroll
          for (int i = 0; i < 32; ++i) h[i] = acc1[32 * q + i];
          epi.template tile<1>(h, z[q], 2 * s + q);
        }
      }
#else
      sink += acc0[0] + acc1[0];
#endif
    }
    epi.end(ie);
  }
#ifdef WG_LONG_PROBE_NO_EPILOGUE
  if (sink == 0x12345678) rg.zc[0] = sink;
#endif
}

// The whole block: shared memory carved, barriers set, then the roles.
// T db steps (of NA rows in form (a), NB in (b)), S splits, R ring
// stages, nkp chunks a row.
template <int NKP, class Epi>
__device__ __forceinline__ void run(const CUtensorMap* tq,
                                    const CUtensorMap* tdb,
                                    const CUtensorMap* tzc, int B, int W,
                                    int T, int S, int R, int nkp, Epi& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Ring rg;
  rg.R = R;
  rg.rows = base;
  rg.stages = base + (NKP ? NKP * ROWS * PANEL : 0);
  rg.zc = reinterpret_cast<int*>(rg.stages + R * (NKP ? NA * PANEL : stage_b()));
  rg.full = reinterpret_cast<uint64_t*>(rg.zc + ZS * (NKP ? NA : NB));
  rg.empty = rg.full + R;
  rg.zempty = rg.empty + R;
  rg.afull = rg.zempty + ZS;
  rg.aempty = rg.afull + 1;
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
  const int qtiles = (B + ROWS - 1) / ROWS;
  if (threadIdx.x >= CONSUMER_WARPS * 32) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WARPS * 32) {
      produce<NKP>(tq, tdb, tzc, rg, qtiles, T, S, NKP ? NKP : nkp);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    if constexpr (NKP > 0) {
      consume_a<NKP>(rg, qtiles, T, S, epi);
    } else {
      consume_b(rg, qtiles, T, S, nkp, W / 64, epi);
    }
  }
}

// Host: launch a long-route kernel, form (a) with NKP panels a row or
// (b) (NKP == 0), whose parameters are the tensor maps of the query
// rows (boxes of 128 bytes x ROWS rows), the db's (x the step's rows)
// and its zc's (the step's entries), then T, S, R and the chunks a row,
// then args; on min(query tiles x splits, SMs) persistent blocks. W db
// rows, a multiple of 64; 1 <= splits <= W / 64 (splits past the steps
// walk none).
template <int NKP, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const void* q, const void* db,
                   const void* zc, int B, int W, int EP, int splits,
                   cudaStream_t s, Args... args) {
  constexpr int step = NKP ? NA : NB;
  const EncodeTiled enc = encode_tiled();
  CUtensorMap tq, tdb, tzc;
  if (enc == nullptr || !map_rows(enc, &tq, q, EP, B, ROWS) ||
      !map_rows(enc, &tdb, db, EP, W, step) ||
      !map_ints(enc, &tzc, zc, W, step)) {
    return cudaErrorInvalidValue;
  }
  const int smem = NKP ? smem_a(NKP) : smem_b();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long items = (long)((B + ROWS - 1) / ROWS) * splits;
  const int grid = (int)std::min<long>(items, sm_count());
  if (grid < 1) return cudaErrorInvalidValue;
  const int T = (W + step - 1) / step, R = NKP ? ring_a(NKP) : RING_B;
  kernel<<<grid, THREADS, smem, s>>>(tq, tdb, tzc, T, splits, R, panels(EP),
                                     args...);
  return cudaGetLastError();
}

// The form of a row of EP > wg_scan::EP_MAX bytes: f(the NKP of
// launch<NKP>, as std::integral_constant<int, NKP>), which launches the
// caller's kernel<NKP>: form (a) with its panels up to EP_A_MAX, else
// form (b) (0).
template <class F>
cudaError_t by_form(int EP, F f) {
  static_assert(NKP_MAX == 5, "a case for each panel count of form (a)");
  switch (EP > EP_A_MAX ? 0 : panels(EP)) {
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    default: return f(std::integral_constant<int, 0>());
  }
}

}  // namespace wg_long
