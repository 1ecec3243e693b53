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
// (the same distances) and n_valid as an argument. Rows at or past
// n_valid are masked in the epilogue and the db loop stops at the tile
// holding row n_valid - 1: the centroid buffer holds live rows past the
// snapshot a scan was launched on, so padding cannot be relied on.
// shift is a runtime argument because it grows with the buffer.
//
// What bounds it on the H100: as min2.cu, int8 tensor-core products
// (K = 256 bytes at 60 bp) against the key epilogue on the CUDA cores,
// here one key min, one compare for the mask and, with the count, two
// more. The grid has ceil(B / 128) blocks, each looping over every
// live row, so batches below ~17k rows leave SMs idle (cluster batches
// are 2048 to 32768 rows); a split-W variant is later work.
//
// Design: min2.cu's block (scan_tile.cuh), one key instead of two.

#include "scan_tile.cuh"

namespace {

using namespace scan_tile;

template <bool WITH_COUNT>
__global__ void __launch_bounds__(THREADS)
    min_count_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ db,
                     const int* __restrict__ zc, int* __restrict__ key_out,
                     int* __restrict__ cnt_out, int B, int n_valid, int EP,
                     int seq_len, int shift, int kc_max) {
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
  int key[2] = {BIG_KEY, BIG_KEY};
  int cnt[2] = {0, 0};
  int curd[2] = {0x7fffffff, 0x7fffffff};

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
    // db column n * 8 + 2t + (r & 1).
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = n * 8 + 2 * t + (r & 1);
        const int w = w0 + col;
        if (w < n_valid) {
          const int i = r >> 1;
          const int dist = seq_len - acc[n][r] - sZ[col];
          key[i] = min(key[i], (dist << shift) | w);
          if (WITH_COUNT) {
            cnt[i] = dist < curd[i] ? 1 : cnt[i] + (dist == curd[i] ? 1 : 0);
            curd[i] = min(curd[i], dist);
          }
        }
      }
    }
  }

  // Merge the 4 lanes (t = 0..3) that share each row: the smaller
  // distance keeps its count, equal distances add theirs.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int okey = __shfl_xor_sync(0xffffffffu, key[i], off);
      if (WITH_COUNT) {
        const int ocnt = __shfl_xor_sync(0xffffffffu, cnt[i], off);
        const int ocurd = __shfl_xor_sync(0xffffffffu, curd[i], off);
        cnt[i] = ocurd < curd[i] ? ocnt
                                 : (ocurd == curd[i] ? cnt[i] + ocnt : cnt[i]);
        curd[i] = min(curd[i], ocurd);
      }
      key[i] = min(key[i], okey);
    }
    const int row = warp * 16 + g + 8 * i;
    if (t == 0 && row < q_valid) {
      key_out[q0 + row] = key[i];
      if (WITH_COUNT) cnt_out[q0 + row] = cnt[i];
    }
  }
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// outputs int32 [B]; cnt is written only when with_count. Requires
// EP % 32 == 0, W % 64 == 0, 0 <= n_valid <= W, 16-byte aligned q and
// db. Returns the cudaError_t of the launch.
extern "C" int smafa_min_count(const void* q, const void* db, const void* zc,
                               void* key, void* cnt, int B, int n_valid,
                               int EP, int seq_len, int shift, int with_count,
                               void* stream) {
  const int kc_max = pick_kc(EP);
  const size_t smem = smem_bytes(kc_max);
  const dim3 grid((B + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* dp = static_cast<const int8_t*>(db);
  const int* zp = static_cast<const int*>(zc);
  int* kp = static_cast<int*>(key);
  int* cp = static_cast<int*>(cnt);
  cudaError_t err;
  if (with_count) {
    err = cudaFuncSetAttribute(min_count_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    min_count_kernel<true><<<grid, THREADS, smem, s>>>(
        qp, dp, zp, kp, cp, B, n_valid, EP, seq_len, shift, kc_max);
  } else {
    err = cudaFuncSetAttribute(min_count_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    min_count_kernel<false><<<grid, THREADS, smem, s>>>(
        qp, dp, zp, kp, cp, B, n_valid, EP, seq_len, shift, kc_max);
  }
  return (int)cudaGetLastError();
}
