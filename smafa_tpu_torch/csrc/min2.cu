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
// What bounds it on the H100: int8 tensor-core throughput for the
// contraction (K = embed width, 256 bytes at 60 bp) against ~8 integer
// ops per (row, window) for the key epilogue, which runs on the CUDA
// cores and is the larger cost at small K. The db (256 B/row) is re-read
// once per block of BM query rows, mostly from L2.
//
// Design: each block owns BM = 128 query rows (one 16-row slab per warp)
// and loops over ALL db rows in tiles of BN = 64, so every row's result
// is final inside one block and nothing is merged across blocks (the
// TPU's sequential W grid axis with its VMEM carry becomes this loop).
// The query tile stays resident in shared memory when it fits; longer
// windows stream K in 512-byte chunks. Products use
// mma.sync.m16n8k32 s8.s8 -> s32; the epilogue keeps the running keys
// and count in registers and merges the 4 lanes sharing a row with warp
// shuffles at the end. Shared-memory rows are padded by 16 bytes so the
// fragment loads are free of bank conflicts. The grid has B / 128
// blocks, so small batches underfill the 132 SMs; a split-W variant is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16;       // query rows per block
constexpr int BN = 64;               // db rows per shared-memory tile
constexpr int NT = BN / 8;           // mma n-tiles per db tile
constexpr int PAD = 16;              // bytes of padding per shared row
constexpr int KC_STREAM = 512;       // K chunk when the query tile streams
constexpr int SMEM_RESIDENT_MAX = 200 * 1024;
constexpr int BIG_KEY = 0x7fffffff;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [row0, row0 + nrows) x bytes [k0, k0 + kc) of a row-major
// int8 matrix (row length ep) into shared memory with row stride
// `stride`; rows at or past `valid` are zero-filled. 16-byte accesses.
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g,
                                          long row0, int nrows, int valid,
                                          int ep, int k0, int kc,
                                          int stride) {
  const int vec_per_row = kc / 16;
  const int total = nrows * vec_per_row;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / vec_per_row;
    const int v = i - r * vec_per_row;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < valid) {
      val = *reinterpret_cast<const int4*>(g + (row0 + r) * (long)ep + k0 +
                                           v * 16);
    }
    *reinterpret_cast<int4*>(s + r * stride + v * 16) = val;
  }
}

template <bool WITH_COUNT>
__global__ void __launch_bounds__(THREADS)
    min2_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ db,
                const int* __restrict__ zc, int* __restrict__ lo_out,
                int* __restrict__ hi_out, int* __restrict__ cnt_out, int B,
                int W, int EP, int seq_len, int shift, int kc_max) {
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

  // Running state for this lane's two rows (warp*16 + g and + 8) over
  // the db columns it owns (2t, 2t+1 of every n-tile).
  int lo[2] = {BIG_KEY, BIG_KEY};
  int hi[2] = {BIG_KEY, BIG_KEY};
  int cnt[2] = {0, 0};
  int curd[2] = {0x7fffffff, 0x7fffffff};

  if (resident) load_tile(sQ, q, q0, BM, q_valid, EP, 0, EP, stride);

  for (int w0 = 0; w0 < W; w0 += BN) {
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
    // db column n * 8 + 2t + (r & 1).
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = n * 8 + 2 * t + (r & 1);
        const int w = w0 + col;
        const int i = r >> 1;
        const int dist = seq_len - acc[n][r] - sZ[col];
        const int sh = dist << shift;
        lo[i] = min(lo[i], sh | w);
        hi[i] = min(hi[i], sh | (W - 1 - w));
        if (WITH_COUNT) {
          cnt[i] = dist < curd[i] ? 1 : cnt[i] + (dist == curd[i] ? 1 : 0);
          curd[i] = min(curd[i], dist);
        }
      }
    }
  }

  // Merge the 4 lanes (t = 0..3) that share each row.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int olo = __shfl_xor_sync(0xffffffffu, lo[i], off);
      const int ohi = __shfl_xor_sync(0xffffffffu, hi[i], off);
      if (WITH_COUNT) {
        const int ocnt = __shfl_xor_sync(0xffffffffu, cnt[i], off);
        const int ocurd = __shfl_xor_sync(0xffffffffu, curd[i], off);
        cnt[i] = ocurd < curd[i] ? ocnt
                                 : (ocurd == curd[i] ? cnt[i] + ocnt : cnt[i]);
        curd[i] = min(curd[i], ocurd);
      }
      lo[i] = min(lo[i], olo);
      hi[i] = min(hi[i], ohi);
    }
    const int row = warp * 16 + g + 8 * i;
    if (t == 0 && row < q_valid) {
      lo_out[q0 + row] = lo[i];
      hi_out[q0 + row] = hi[i];
      if (WITH_COUNT) cnt_out[q0 + row] = cnt[i];
    }
  }
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// outputs int32 [B]. Requires EP % 32 == 0, W % 64 == 0, W >= 64,
// 16-byte aligned q and db. Returns the cudaError_t of the launch.
extern "C" int smafa_min2(const void* q, const void* db, const void* zc,
                          void* lo, void* hi, void* cnt, int B, int W, int EP,
                          int seq_len, int shift, int with_count,
                          void* stream) {
  const bool fits =
      (long)(BM + BN) * (EP + PAD) + BN * (long)sizeof(int) <= SMEM_RESIDENT_MAX;
  const int kc_max = fits ? EP : KC_STREAM;
  const size_t smem = (size_t)(BM + BN) * (kc_max + PAD) + BN * sizeof(int);
  const dim3 grid((B + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* dp = static_cast<const int8_t*>(db);
  const int* zp = static_cast<const int*>(zc);
  int* lp = static_cast<int*>(lo);
  int* hp = static_cast<int*>(hi);
  int* cp = static_cast<int*>(cnt);
  cudaError_t err;
  if (with_count) {
    err = cudaFuncSetAttribute(min2_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    min2_kernel<true><<<grid, THREADS, smem, s>>>(qp, dp, zp, lp, hp, cp, B, W,
                                                  EP, seq_len, shift, kc_max);
  } else {
    err = cudaFuncSetAttribute(min2_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    min2_kernel<false><<<grid, THREADS, smem, s>>>(qp, dp, zp, lp, hp, cp, B,
                                                   W, EP, seq_len, shift,
                                                   kc_max);
  }
  return (int)cudaGetLastError();
}
