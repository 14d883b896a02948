// Hopper (sm_90a) kernels of the shared delivery round (the propagation
// round every router runs), with a plain C interface (bound from Python
// through ctypes by go_libp2p_pubsub_tpu_torch/ops/delivery_banded.py and
// go_libp2p_pubsub_tpu_torch/ops/csr_delivery.py).
//
// They replace the TPU Pallas kernels of the JAX package:
//   delivery_banded_launch <- go_libp2p_pubsub_tpu/ops/pallas_delivery.py
//                              delivery_round_banded / _kernel
//   csr_delivery_launch    <- go_libp2p_pubsub_tpu/ops/pallas_csr.py
//                              csr_delivery: _edge_phase_kernel,
//                              _row_phase_kernel, _edge_commit_kernel
//                              (three calls there, one kernel here)
//
// Both compute one synchronous round over packed 32-bit message words, for
// receiver j and each of its edges e (sender s):
//   trans[e] = fwd[s] & ~echo[e] & mask[e] & not_mine[j]
//   new      = OR over j's edges of trans  &  ~have[j]
//   fa[e]    = trans[e] & ~(OR of j's earlier edges) & new  (lowest edge wins)
//   fe'[e]   = (fe[e] & ~new) | fa[e];  have' = have | new;  fwd' = new & valid
//   first_round'[j, m] = tick where bit m of new is set
// where echo[e] is the sender's first-arrival word on the reverse edge: s
// never sends a message back on the edge it first arrived on.
//
// Banded topology: receiver j's edge k talks to sender (j + off[k]) mod N,
// which holds the edge in its slot rev[k]; `offrev` is a device int32
// array [2K]: off[0..K) (each in [0, N)) then rev[0..K). The first-arrival
// plane stays packed ([N, K*W]), not the TPU kernel's int8 [N, M] form.
// CSR: receiver j's edges are [row_ptr[j], row_ptr[j+1]) of the flat edge
// space, sender col[e], reverse edge eperm[e]. Every row has at most K
// edges, so one thread walks its row; the TPU kernels' capacity-bounded
// segmented scan, which needed a block halo, disappears.
//
// What bounds them on the card: bytes. Each is a few integer ops per loaded
// word. The floor is the bytes each must move once over HBM at 3.35 TB/s:
// at N=100k, K=16, M=64 delivery_banded moves about 107 MB (about 32 us),
// at N=1M, E=5.0M, M=64 csr_delivery about 810 MB (about 0.24 ms). The
// [N, M] first_round plane, read and written whole, is half of the first
// and 63% of the second.
// The simple design below does nothing clever about it: one thread per
// (peer, word); the sender words are 4-byte gathers from scattered rows
// (L2 serves the banded halo); `fe'` goes to a fresh buffer because other
// receivers read this round's `fe` of their senders; each thread writes
// its edges' `trans` first and reads them back for the first-arrival pass,
// so no per-edge registers bound K; the first_round row segment of the
// word is copied with the stamp applied. Power-law rows run from 2 to 64
// edges, so the CSR warps diverge. Each launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWord = 32;

// first_round row segment of word wi, copied with `tick` where `nw` has a
// bit (slots past m, the padding of the last word, do not exist)
__device__ __forceinline__ void stamp_first_round(
    const int* __restrict__ first_round, int* __restrict__ fr_out,
    long long row, int wi, int m, uint32_t nw, int tick) {
  int base = wi * kWord;
  int lim = m - base < kWord ? m - base : kWord;
  const int* src = first_round + row * m + base;
  int* dst = fr_out + row * m + base;
  for (int b = 0; b < lim; ++b) dst[b] = ((nw >> b) & 1u) ? tick : src[b];
}

__global__ void delivery_banded_kernel(
    const uint32_t* __restrict__ fwd,       // [N, W]
    const uint32_t* __restrict__ fe,        // [N, K*W] first-arrival edges
    const uint32_t* __restrict__ emask,     // [N, K*W] (live edges only)
    const uint32_t* __restrict__ not_mine,  // [N, W]
    const uint32_t* __restrict__ have,      // [N, W]
    const int* __restrict__ first_round,    // [N, M]
    const uint32_t* __restrict__ valid,     // [W]
    const int* __restrict__ tick,           // [1]
    const int* __restrict__ offrev,         // [2K]
    uint32_t* __restrict__ trans_out,       // [N, K*W]
    uint32_t* __restrict__ fe_out,          // [N, K*W] (never aliases fe)
    uint32_t* __restrict__ new_out,         // [N, W]
    uint32_t* __restrict__ have_out,        // [N, W]
    uint32_t* __restrict__ fwd_out,         // [N, W]
    int* __restrict__ fr_out,               // [N, M]
    int n, int k, int w, int m) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * w) return;
  int wi = (int)(t % w);
  int j = (int)(t / w);
  uint32_t nm = not_mine[t];
  long long row_kw = (long long)j * k * w;
  uint32_t acc = 0u;
  for (int kk = 0; kk < k; ++kk) {
    int s = j + offrev[kk];
    if (s >= n) s -= n;
    int rk = offrev[k + kk];
    long long e = row_kw + (long long)kk * w + wi;
    uint32_t echo = fe[(long long)s * k * w + (long long)rk * w + wi];
    uint32_t tk = fwd[(long long)s * w + wi] & ~echo & emask[e] & nm;
    trans_out[e] = tk;
    acc |= tk;
  }
  uint32_t h = have[t];
  uint32_t nw = acc & ~h;
  new_out[t] = nw;
  have_out[t] = h | nw;
  fwd_out[t] = nw & valid[wi];
  uint32_t seen = 0u;
  for (int kk = 0; kk < k; ++kk) {
    long long e = row_kw + (long long)kk * w + wi;
    uint32_t tk = trans_out[e];
    fe_out[e] = (fe[e] & ~nw) | (tk & ~seen & nw);
    seen |= tk;
  }
  stamp_first_round(first_round, fr_out, j, wi, m, nw, *tick);
}

__global__ void csr_delivery_kernel(
    const uint32_t* __restrict__ fwd,       // [N, W]
    const uint32_t* __restrict__ fe,        // [E, W] first-arrival edges
    const uint32_t* __restrict__ mask,      // [E, W] edge mask
    const uint32_t* __restrict__ not_mine,  // [N, W]
    const uint32_t* __restrict__ have,      // [N, W]
    const int* __restrict__ first_round,    // [N, M]
    const uint32_t* __restrict__ valid,     // [W]
    const int* __restrict__ tick,           // [1]
    const int* __restrict__ col,            // [E]
    const int* __restrict__ eperm,          // [E]
    const int* __restrict__ row_ptr,        // [N+1]
    const uint8_t* __restrict__ link_ok,    // [E] bool, or null
    uint32_t* __restrict__ trans_out,       // [E, W]
    uint32_t* __restrict__ recv_out,        // [N, W]
    uint32_t* __restrict__ new_out,         // [N, W]
    uint32_t* __restrict__ have_out,        // [N, W]
    uint32_t* __restrict__ fwd_out,         // [N, W]
    int* __restrict__ fr_out,               // [N, M]
    uint32_t* __restrict__ fe_out,          // [E, W] (never aliases fe)
    uint32_t* __restrict__ fa_out,          // [E, W]
    int n, int w, int m) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * w) return;
  int wi = (int)(t % w);
  int j = (int)(t / w);
  int e0 = row_ptr[j];
  int e1 = row_ptr[j + 1];
  uint32_t nm = not_mine[t];
  uint32_t acc = 0u;
  for (int e = e0; e < e1; ++e) {
    long long ew = (long long)e * w + wi;
    uint32_t echo = fe[(long long)eperm[e] * w + wi];
    uint32_t tk = fwd[(long long)col[e] * w + wi] & ~echo & mask[ew] & nm;
    if (link_ok != nullptr && link_ok[e] == 0) tk = 0u;
    trans_out[ew] = tk;
    acc |= tk;
  }
  uint32_t h = have[t];
  uint32_t nw = acc & ~h;
  recv_out[t] = acc;  // 0 on an empty row
  new_out[t] = nw;
  have_out[t] = h | nw;
  fwd_out[t] = nw & valid[wi];
  uint32_t exc = 0u;
  for (int e = e0; e < e1; ++e) {
    long long ew = (long long)e * w + wi;
    uint32_t tk = trans_out[ew];
    uint32_t fa = tk & ~exc & nw;
    fa_out[ew] = fa;
    fe_out[ew] = (fe[ew] & ~nw) | fa;
    exc |= tk;
  }
  stamp_first_round(first_round, fr_out, j, wi, m, nw, *tick);
}

unsigned int blocks_for(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

bool bad_words(int n, int w, int m) {
  return n <= 0 || w <= 0 || m <= 0 || m > w * kWord || m <= (w - 1) * kWord;
}

}  // namespace

extern "C" int delivery_banded_launch(
    const void* fwd, const void* fe, const void* emask, const void* not_mine,
    const void* have, const void* first_round, const void* valid,
    const void* tick, const void* offrev, void* trans_out, void* fe_out,
    void* new_out, void* have_out, void* fwd_out, void* fr_out, int n, int k,
    int w, int m, void* stream) {
  if (k <= 0 || bad_words(n, w, m)) return (int)cudaErrorInvalidValue;
  delivery_banded_kernel<<<blocks_for((long long)n * w), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)fwd, (const uint32_t*)fe, (const uint32_t*)emask,
      (const uint32_t*)not_mine, (const uint32_t*)have,
      (const int*)first_round, (const uint32_t*)valid, (const int*)tick,
      (const int*)offrev, (uint32_t*)trans_out, (uint32_t*)fe_out,
      (uint32_t*)new_out, (uint32_t*)have_out, (uint32_t*)fwd_out,
      (int*)fr_out, n, k, w, m);
  return (int)cudaGetLastError();
}

extern "C" int csr_delivery_launch(
    const void* fwd, const void* fe, const void* mask, const void* not_mine,
    const void* have, const void* first_round, const void* valid,
    const void* tick, const void* col, const void* eperm, const void* row_ptr,
    const void* link_ok, void* trans_out, void* recv_out, void* new_out,
    void* have_out, void* fwd_out, void* fr_out, void* fe_out, void* fa_out,
    int n, int w, int m, void* stream) {
  if (bad_words(n, w, m)) return (int)cudaErrorInvalidValue;
  csr_delivery_kernel<<<blocks_for((long long)n * w), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)fwd, (const uint32_t*)fe, (const uint32_t*)mask,
      (const uint32_t*)not_mine, (const uint32_t*)have,
      (const int*)first_round, (const uint32_t*)valid, (const int*)tick,
      (const int*)col, (const int*)eperm, (const int*)row_ptr,
      (const uint8_t*)link_ok, (uint32_t*)trans_out, (uint32_t*)recv_out,
      (uint32_t*)new_out, (uint32_t*)have_out, (uint32_t*)fwd_out,
      (int*)fr_out, (uint32_t*)fe_out, (uint32_t*)fa_out, n, w, m);
  return (int)cudaGetLastError();
}
