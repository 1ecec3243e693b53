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
// Padding rows are poisoned to distance seq_len + 1, which no threshold
// reaches, but mx is the cutoff whenever K exceeds the window count, so
// the db loop stops at the tile holding row n_valid - 1 and the epilogue
// masks the rest of that tile (as min_count.cu does).
//
// What bounds it on the H100: the int8 tensor-core products are
// min2.cu's; the epilogue on the CUDA cores is heavier, four compares
// and adds and one max per distance. The thresholds of a lane's two rows
// are loaded into registers once per block. The grid has ceil(B / 128)
// blocks, each looping over every live row, so B = 16384 fills 128 of
// the 132 SMs; a split-W variant is later work.
//
// Design: min2.cu's block (scan_tile.cuh) with this epilogue; the four
// lanes that share a row merge by warp shuffles, adding the counts and
// taking the max.

#include "scan_tile.cuh"

namespace {

using namespace scan_tile;

constexpr int PROBES = 4;  // smafa_tpu_torch/ops/keys.py KSTATS_PROBES

__global__ void __launch_bounds__(THREADS)
    kstats_kernel(const int8_t* __restrict__ q,
                  const int8_t* __restrict__ db, const int* __restrict__ zc,
                  const int* __restrict__ ts, int* __restrict__ cnt_out,
                  int* __restrict__ mx_out, int B, int n_valid, int EP,
                  int seq_len, int kc_max) {
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

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// ts and cnt: int32 [4, B], mx: int32 [B]. Requires EP % 32 == 0,
// W % 64 == 0, 0 <= n_valid <= W, 16-byte aligned q and db. Returns the
// cudaError_t of the launch.
extern "C" int smafa_kstats(const void* q, const void* db, const void* zc,
                            const void* ts, void* cnt, void* mx, int B,
                            int n_valid, int EP, int seq_len, void* stream) {
  const int kc_max = pick_kc(EP);
  const size_t smem = smem_bytes(kc_max);
  const dim3 grid((B + BM - 1) / BM);
  const cudaError_t err = cudaFuncSetAttribute(
      kstats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kstats_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(db),
      static_cast<const int*>(zc), static_cast<const int*>(ts),
      static_cast<int*>(cnt), static_cast<int*>(mx), B, n_valid, EP, seq_len,
      kc_max);
  return (int)cudaGetLastError();
}
