// Hopper (sm_90a) kernel of the heartbeat's peer selection, with a plain C
// interface (bound from Python through ctypes by
// go_libp2p_pubsub_tpu_torch/ops/select_topk.py).
//
// It replaces the TPU Pallas kernel of the JAX package:
//   select_topk_launch <- go_libp2p_pubsub_tpu/ops/pallas_csr.py
//                          select_topk_pallas / _topk_kernel
//
// Per row r of [R, K] (R = N*S peer-topic slots, K the padded neighbor axis):
//   p[i]    = mask[r, i] ? values[r, i] : -inf
//   rank[i] = #{ j : p[j] > p[i]
//                    or (p[j] == p[i] and noise[j] > noise[i])
//                    or (p[j] == p[i] and noise[j] == noise[i] and j < i) }
//   out[r, i] = rank[i] < k_rows[r]  and  mask[r, i]
// i.e. the (up to) k_rows[r] masked slots first in the strict (value, noise,
// index)-descending order. The compares are IEEE float compares, the same as
// the plain pairwise form's, so -0.0 == +0.0 here exactly as there, and the
// kernel equals the plain version bit for bit on any input.
//
// What bounds it on the card: at K=16 bytes, at K=64 operations. It reads
// 10 bytes per slot (value, noise f32, mask byte) and 4 per row and writes
// one byte per slot; it does about 8 compare-and-count operations per
// (i, j) pair. At R=100k that is 16.4 MB and 0.2 G operations at K=16
// (about 5 us at 3.35 TB/s against 3 us at 67 T non-tensor ops/s), 64 MB
// and 3.3 G at K=64 (about 19 us against 49 us).
// The simple design below: one thread per (row, slot i), K threads per
// row, 256 / K rows per block. The block stages its rows' masked values and
// noise in shared memory (coalesced loads), then each thread walks the K
// slots of its row (a warp reads one address at a time, a broadcast) and
// writes one byte. The [R, K, K] compare planes of the plain form never
// exist. Each launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void select_topk_kernel(
    const float* __restrict__ values,    // [R, K]
    const uint8_t* __restrict__ mask,    // [R, K] bool
    const int* __restrict__ k_rows,      // [R]
    const float* __restrict__ noise,     // [R, K]
    uint8_t* __restrict__ out,           // [R, K] bool
    int r, int k) {
  extern __shared__ float smem[];
  const int rows_pb = blockDim.x / k;
  float* sp = smem;                      // [rows_pb * K] masked values
  float* sn = smem + rows_pb * k;        // [rows_pb * K] noise
  const int lr = threadIdx.x / k;
  const int i = threadIdx.x - lr * k;
  const long long row = (long long)blockIdx.x * rows_pb + lr;
  const bool live = lr < rows_pb && row < r;
  const long long off = row * k + i;
  uint8_t mi = 0;
  if (live) {
    mi = mask[off];
    sp[threadIdx.x] = mi ? values[off] : __int_as_float(0xff800000);  // -inf
    sn[threadIdx.x] = noise[off];
  }
  __syncthreads();
  if (!live) return;
  const float* p = sp + lr * k;
  const float* q = sn + lr * k;
  const float pi = p[i];
  const float ni = q[i];
  int rank = 0;
  for (int j = 0; j < k; ++j) {
    const float pj = p[j];
    const float nj = q[j];
    const bool ties = pj == pi;
    rank += (pj > pi) || (ties && nj > ni) || (ties && nj == ni && j < i);
  }
  out[off] = (rank < k_rows[row] && mi) ? 1 : 0;
}

}  // namespace

extern "C" int select_topk_launch(const void* values, const void* mask,
                                  const void* k_rows, const void* noise,
                                  void* out, int r, int k, void* stream) {
  if (r <= 0 || k <= 0 || k > kThreads) return (int)cudaErrorInvalidValue;
  const int rows_pb = kThreads / k;
  const unsigned int blocks = (unsigned int)((r + rows_pb - 1) / rows_pb);
  const size_t smem = 2 * (size_t)rows_pb * k * sizeof(float);
  select_topk_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)values, (const uint8_t*)mask, (const int*)k_rows,
      (const float*)noise, (uint8_t*)out, r, k);
  return (int)cudaGetLastError();
}
