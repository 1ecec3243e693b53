// The short route (EP <= 256 bytes, L <= 64) of min2.cu, compact.cu,
// kstats.cu and min_count.cu on Hopper: a warp-specialised, persistent
// scan of query tiles against the db, whose caller supplies the epilogue
// of each 64 x 64 block of scores. Built from wg_tile.cuh. kstats and
// min_count scan only the first n_valid db rows: their W is the live
// 64-row blocks' rows, and their epilogues mask the last block past
// n_valid.
//
// What bounds the kernels: the int8 contraction, 2 * B * W * 4L
// operations over 1,979 TOP/s (8.33 ms at 32768 x 2^20, L = 60). The
// design:
//
// 1. Warp specialisation: one thread of a producer warpgroup issues
//    every copy by TMA (a db step of 64 rows x EP bytes as 128-byte
//    swizzled boxes, and its 64 zc) into a RING-stage mbarrier ring; two
//    consumer warpgroups run wgmma m64n64k32 s8 and the epilogue.
//    setmaxnreg moves the producer's registers to the consumers.
// 2. ROWS = 256 query rows a block, 128 a consumer warpgroup as two m64
//    tiles, so each db byte that crosses from L2 feeds 256 rows. The
//    rows' A fragments stay in registers for an item (loaded once, zero
//    past B and past EP); wgmma reads only the db step from shared
//    memory.
// 3. N = 64 db rows a step, the db's own tile (Wp is a multiple of 64):
//    every column of a step is a db row below Wp, so no column needs a
//    mask, and padding rows (zc = -1, zero embedding) sit at distance
//    seq_len + 1 as on every route.
// 4. Overlap: each warpgroup issues a step's two products (two commit
//    groups, 8 k-steps each at EP = 256; NKP panels a template argument
//    so the k-steps are unconditional), runs tile 0's epilogue while
//    tile 1's product is in flight, and tile 1's once it retires, while
//    the other warpgroup's products occupy the tensor cores. Tile 1's
//    epilogue holds the stores to memory (compact_mask's mask words, one
//    store a step instead of one a tile). No group stays in flight
//    across the step loop's back edge: where one did (tile 1's epilogue
//    beside the next step's product), ptxas serialised every wgmma
//    (C7514, "non wgmma instructions reading accumulator registers").
//    tools/torch_wg_probe.py times the products alone, the epilogues'
//    parts and these choices.
// 5. Persistent blocks: grid = min(items, SMs), items = query tiles x
//    db splits, query tile fastest, so blocks in flight share a db split
//    in L2; ops/min2.py's short_plan picks the splits.
// 6. A step's zc is read by plain loads and its stage then refilled by
//    TMA (the async proxy): each consumer fences the two proxies after
//    its zc read, before tile 0's epilogue (the fence also waits for the
//    thread's stores in flight, and there only the step before's tile 1
//    stores can be), and so before it releases the stage (see
//    wg_long.cuh, whose form (a) read a later step's zc without it).
//
// The epilogue (class Epi) gets, per item, begin(r0, item) (r0: the
// lane's row of tile 0, half 0) and end(item); per step s, tile<0> and
// then tile<1>(acc, z, s) for m64 tile M, whose acc[4j + 2h + c] is the
// score less zc of row r0 + 64 M + 8 h and db row 64 s + 8 j + 2 t + c,
// and z[2j + c] that db row's zc.

#pragma once

#include <algorithm>
#include <type_traits>

#include "wg_tile.cuh"

namespace wg_scan {

using namespace wg_tile;

constexpr int CONSUMER_WARPS = 8;  // two consumer warpgroups
// and a producer warpgroup, one thread of which issues the copies
constexpr int THREADS = (CONSUMER_WARPS + 4) * 32;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROWS = 256;  // query rows a block (ops/min2.py WG_ROWS)
constexpr int N = 64;      // db rows a step (ops/min2.py WG_STEP)
constexpr int RING = 8;    // stages of the TMA ring
constexpr int EP_MAX = 2 * PANEL;  // the route's widest embedding
constexpr int SLACK = 1024;        // aligning the dynamic shared base

// Dynamic shared bytes of a block at NKP panels a row: the ring's db
// panels, its zc, its full and empty barriers, the alignment slack.
__host__ __device__ constexpr int smem_bytes(int nkp) {
  return RING * (nkp * N * PANEL + N * 4 + 16) + SLACK;
}

// An item: query tile from row b0 against db steps [s0, s1), split y.
struct Item {
  long b0;
  int s0, s1, y;
};

__device__ __forceinline__ Item item_of(int it, int qtiles, int T, int S) {
  const int qt = it % qtiles, y = it / qtiles;
  return {(long)qt * ROWS, (int)((long)T * y / S),
          (int)((long)T * (y + 1) / S), y};
}

struct Ring {
  uint8_t* panels;  // [RING][NKP][N rows x PANEL bytes]
  int* zc;          // [RING][N]
  uint64_t* full;   // [RING] a stage's copies landed
  uint64_t* empty;  // [RING] a stage read by every consumer warp
};

// One arrival of this warp on bar, after all its lanes are done.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The producer (one thread): the db steps of every item of this block,
// in the order the consumers take them.
template <int NKP>
__device__ void produce(const CUtensorMap* tdb, const CUtensorMap* tzc,
                        Ring rg, int qtiles, int T, int S) {
  uint32_t J = 0;
  for (int it = blockIdx.x; it < qtiles * S; it += gridDim.x) {
    const Item im = item_of(it, qtiles, T, S);
    for (int s = im.s0; s < im.s1; ++s, ++J) {
      const int st = J % RING;
      mbar_wait(rg.empty + st, ((J / RING) & 1) ^ 1);
      uint64_t* bar = rg.full + st;
      mbar_expect_tx(bar, NKP * N * PANEL + N * 4);
#pragma unroll
      for (int p = 0; p < NKP; ++p) {
        tma_load_2d(rg.panels + (st * NKP + p) * N * PANEL, tdb, p * PANEL,
                    s * N, bar);
      }
      tma_load_1d(rg.zc + st * N, tzc, s * N, bar);
    }
  }
}

// The consumers (two warpgroups): see the header, points 2 and 4. Both
// walk the block's items and steps in the producer's order.
template <int NKP, class Epi>
__device__ void consume(const int8_t* __restrict__ q, Ring rg, int qtiles,
                        int T, int S, int B, int EP, Epi& epi) {
  constexpr int KS = 4 * NKP;  // k-steps of 32 bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  // the lane's row of tile 0, half 0, within the block's query tile
  const int rloc = 128 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
  const int items = qtiles * S;
  uint32_t J = 0;
  int acc0[N / 2] = {}, acc1[N / 2] = {}, z[N / 4];
  // Tile M's product of stage j into acc, one commit group.
  auto issue = [&](int (&acc)[N / 2], const uint32_t (&a)[KS][4],
                   uint32_t j) {
    const uint8_t* b = rg.panels + (j % RING) * NKP * N * PANEL;
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NKP; ++p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_rs_n64(acc, a[4 * p + k], desc_sw128(b + p * N * PANEL + 32 * k),
                     p | k);
      }
    }
    wgmma_commit();
  };
  auto zload = [&](uint32_t j) {
    const int* zs = rg.zc + (j % RING) * N + 2 * t;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int2 v = *reinterpret_cast<const int2*>(zs + 8 * i);
      z[2 * i] = v.x;
      z[2 * i + 1] = v.y;
    }
  };
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item im = item_of(it, qtiles, T, S);
    const long r0 = im.b0 + rloc;
    // the m16n8k32 A fragments of rows r0 + 64 m (+ 8), zero past B and
    // past EP, for the item
    uint32_t af[2][KS][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long r = r0 + 64 * m + 8 * (i & 1);
          af[m][k][i] = (32 * k < EP && r < B)
              ? __ldg(reinterpret_cast<const uint32_t*>(
                    q + r * EP + 32 * k + 16 * (i >> 1) + 4 * t))
              : 0u;
        }
      }
    }
    fence_regs(af);  // loaded before the first product is issued
    epi.begin(r0, im);
    for (int s = im.s0; s < im.s1; ++s, ++J) {
      mbar_wait(rg.full + J % RING, (J / RING) & 1);
      issue(acc0, af[0], J);
      issue(acc1, af[1], J);
      wgmma_wait<1>();  // tile 0 done; tile 1's product runs on
      fence_regs(acc0);
      zload(J);
      fence_proxy_async();  // the zc read before TMA may refill the stage
      epi.template tile<0>(acc0, z, s);
      wgmma_wait<0>();
      fence_regs(acc1);
      warp_arrive(rg.empty + J % RING, lane);
      epi.template tile<1>(acc1, z, s);
    }
    epi.end(im);
  }
}

// The whole block: shared memory carved, barriers set, then the roles.
// T db steps of N rows (W / N), S splits.
template <int NKP, class Epi>
__device__ __forceinline__ void run(const CUtensorMap* tdb,
                                    const CUtensorMap* tzc,
                                    const int8_t* __restrict__ q, int B,
                                    int T, int EP, int S, Epi& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Ring rg;
  rg.panels = base;
  rg.zc = reinterpret_cast<int*>(base + RING * NKP * N * PANEL);
  rg.full = reinterpret_cast<uint64_t*>(rg.zc + RING * N);
  rg.empty = rg.full + RING;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(rg.full + s, 1);
      mbar_init(rg.empty + s, CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int qtiles = (B + ROWS - 1) / ROWS;
  if (threadIdx.x >= CONSUMER_WARPS * 32) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WARPS * 32) {
      produce<NKP>(tdb, tzc, rg, qtiles, T, S);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<NKP>(q, rg, qtiles, T, S, B, EP, epi);
  }
}

// The panels of a row of EP <= EP_MAX bytes: f(std::integral_constant<
// int, NKP>), which launches the caller's kernel<NKP>.
template <class F>
cudaError_t by_panels(int EP, F f) {
  static_assert(EP_MAX == 2 * PANEL, "a case for each panel count");
  return EP <= PANEL ? f(std::integral_constant<int, 1>())
                     : f(std::integral_constant<int, 2>());
}

// Host: launch a short-route kernel of NKP panels a row, whose
// parameters are the db's tensor map (boxes of 128 bytes x N rows), its
// zc's (N entries), then args, on min(query tiles x splits, SMs)
// persistent blocks. W db rows.
template <int NKP, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const void* db, const void* zc, int B,
                   int W, int EP, int splits, cudaStream_t s, Args... args) {
  const EncodeTiled enc = encode_tiled();
  CUtensorMap tdb, tzc;
  if (enc == nullptr || !map_rows(enc, &tdb, db, EP, W, N) ||
      !map_ints(enc, &tzc, zc, W, N)) {
    return cudaErrorInvalidValue;
  }
  const int smem = smem_bytes(NKP);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long items = (long)(B + ROWS - 1) / ROWS * splits;
  const int grid = (int)std::min<long>(items, sm_count());
  if (grid < 1) return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, s>>>(tdb, tzc, args...);
  return cudaGetLastError();
}

}  // namespace wg_scan
