// Best-hit tie enumeration on Hopper: the hit bitmask of a compaction pass.
//
// Replaces smafa_tpu/ops/pallas_scan.py:_compact_kernel (entry
// compact_mask_pallas). Same contract: for query row r and db row w,
//
//   dist = seq_len - q_emb[r] . db_emb[w] - zc[w]
//   bit (w % 32) of mask[r, w / 32] is set  iff  dist <= thresh[r]
//
// with thresh = -1 turning a row off and padding rows (zc = -1, zero
// embedding) at distance seq_len + 1, above every legal threshold. The
// mask is stored as int32 words with the uint32 bit order of the TPU
// kernel.
//
// What bounds it on the H100: the dp4a contraction, K / 4 dp4a plus
// K / 4 shared loads per (row, window) on the CUDA cores. The pass runs
// only for the few query rows whose minimum has more than two ties, so
// it is small next to phase A; its output (B * W / 8 bytes) is the
// other cost.
//
// Design: a fully parallel grid over (db tile of 256 windows, query
// tile of 32 rows), with no carried state. Each thread owns one window
// and accumulates its 32 dot products in registers while K streams
// through shared memory in 128-byte chunks (db rows padded to 33 words,
// so each thread reads its own row without bank conflicts; query words
// are broadcast). The compare result of 32 adjacent windows is packed by
// one __ballot_sync per warp and lane 0 writes the word; this replaces
// the TPU's powers-of-two matmul bit pack.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // windows per block, one per thread
constexpr int QT = 32;        // query rows per block
constexpr int KW = 32;        // K chunk in 32-bit words

__global__ void __launch_bounds__(THREADS)
    compact_kernel(const int* __restrict__ q, const int* __restrict__ db,
                   const int* __restrict__ zc, const int* __restrict__ thresh,
                   int* __restrict__ mask, int B, int W, int EP, int seq_len) {
  __shared__ int sD[THREADS][KW + 1];
  __shared__ int sQ[QT][KW];
  const int tid = threadIdx.x;
  const long w0 = (long)blockIdx.x * THREADS;
  const long r0 = (long)blockIdx.y * QT;
  const int q_valid = (int)min((long)QT, (long)B - r0);
  const int words = EP / 4;

  int acc[QT];
#pragma unroll
  for (int r = 0; r < QT; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < words; k0 += KW) {
    const int kw = min(KW, words - k0);
    __syncthreads();
    for (int i = tid; i < THREADS * kw; i += THREADS) {
      const int r = i / kw;
      const int c = i - r * kw;
      const long w = w0 + r;
      sD[r][c] = w < W ? db[w * words + k0 + c] : 0;
    }
    for (int i = tid; i < QT * kw; i += THREADS) {
      const int r = i / kw;
      const int c = i - r * kw;
      sQ[r][c] = r < q_valid ? q[(r0 + r) * words + k0 + c] : 0;
    }
    __syncthreads();
    for (int c = 0; c < kw; ++c) {
      const int d = sD[tid][c];
#pragma unroll
      for (int r = 0; r < QT; ++r) acc[r] = __dp4a(sQ[r][c], d, acc[r]);
    }
  }

  const long w = w0 + tid;
  const bool in_db = w < W;
  const int z = in_db ? zc[w] : 0;
  const long n_words = W >> 5;
  const long word = w >> 5;  // the same for the whole warp
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    if (r < q_valid) {  // uniform across the block
      const int dist = seq_len - acc[r] - z;
      const unsigned bits =
          __ballot_sync(0xffffffffu, in_db && dist <= thresh[r0 + r]);
      if ((tid & 31) == 0 && word < n_words) {
        mask[(r0 + r) * n_words + word] = (int)bits;
      }
    }
  }
}

}  // namespace

// Launch on `stream`. q: int8 [B, EP], db: int8 [W, EP], zc: int32 [W],
// thresh: int32 [B], mask: int32 [B, W / 32]. Requires EP % 32 == 0,
// W % 32 == 0, B <= 65535 * 32 and 4-byte aligned q and db. Returns the
// cudaError_t of the launch.
extern "C" int smafa_compact_mask(const void* q, const void* db,
                                  const void* zc, const void* thresh,
                                  void* mask, int B, int W, int EP,
                                  int seq_len, void* stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, (B + QT - 1) / QT);
  compact_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const int*>(db),
      static_cast<const int*>(zc), static_cast<const int*>(thresh),
      static_cast<int*>(mask), B, W, EP, seq_len);
  return (int)cudaGetLastError();
}
