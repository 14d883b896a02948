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
// space (rows sorted, row_ptr monotone), sender col[e], reverse edge
// eperm[e]; an optional [E] bool link_ok folds a link-deny mask into trans.
//
// What bounds them on the card: bytes. Each is a few integer ops per loaded
// word. The floor is the bytes each must move once over HBM at 3.35 TB/s:
// at N=100k, K=16, M=64 delivery_banded moves about 107 MB (about 32 us),
// at N=1M, E=5.0M, M=64 csr_delivery about 810 MB (about 0.24 ms). The
// [N, M] first_round plane, read and written whole, is half of the first
// and 63% of the second.
//
// delivery_banded is the simple first design: one thread per (peer, word);
// the sender words are 4-byte gathers (L2 serves the banded halo); each
// thread writes its edges' `trans` and reads them back for the
// first-arrival pass; the first_round row segment of the word is copied with
// the stamp applied.
//
// csr_delivery is laid out for the card. A warp owns 32 consecutive rows,
// and so the contiguous edge range [row_ptr[r0], row_ptr[r0+32]); it takes
// that range in batches of whole rows that fit 384 (edge, word) elements of
// shared memory. Lanes walk a batch's flat (edge, word) elements, so the
// [E, W] planes, col and eperm are read and written contiguously and the
// fwd[col] / fe[eperm] gathers of one edge's W words fall in one sector.
// The transmit words stay in shared memory. A segmented inclusive OR along
// each row (shuffles within a chunk of 32 lanes, a carry across chunks)
// gives the receive word at the row's last edge and, one edge back, the
// exclusive OR that lets the lowest edge win each first arrival. Rows of
// any length are taken: one longer than a batch is walked by one lane per
// word. The first_round stamp, 63% of the bytes, runs last over the warp's
// 32 rows, one contiguous stretch of the plane, as 16-byte vectors with
// neighbouring lanes on neighbouring addresses; only slots below M are
// stamped, never the padding bits of the last word. Words go 32 at a time
// (grid.y), since every word is independent. `fe'` goes to a fresh buffer
// in both kernels because other receivers read this round's `fe` of their
// senders. Each launch returns cudaGetLastError().

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

// --- csr_delivery: a warp owns 32 consecutive rows and their edge range ---

constexpr int kCsrWarps = 2;     // warps a block; each warp works alone
constexpr int kCsrRows = 32;     // rows a warp
constexpr int kCsrElems = 384;   // (edge, word) elements a batch holds in shared memory
constexpr unsigned kFull = 0xffffffffu;

// words of one grid.y group (the kernel takes the W words 32 at a time)
constexpr __host__ __device__ int group_words(int w) { return w < kWord ? w : kWord; }
constexpr __host__ __device__ int batch_edges(int wg) { return kCsrElems / wg; }

// 32-bit words of one warp's shared memory: row pointers, not_mine and new
// words of its rows, then a batch's row ids, transmit and inclusive-OR words
constexpr __host__ __device__ int csr_warp_words(int w) {
  const int wg = group_words(w);
  return (kCsrRows + 1) + 2 * kCsrRows * wg + batch_edges(wg) * (1 + 2 * wg);
}

// the largest group (32 words) stays under the 48 KB of dynamic shared
// memory a block takes without an opt-in
static_assert(kCsrWarps * csr_warp_words(kWord) * 4 <= 48 * 1024, "shared memory");

__global__ void __launch_bounds__(32 * kCsrWarps) csr_delivery_kernel(
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
    int n, int w, int m, int vec_stamp) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wmax = group_words(w);
  const int cap_e = batch_edges(wmax);
  int* rp = smem + warp * csr_warp_words(w);           // [33] row_ptr[r0 ..]
  uint32_t* nm_s = (uint32_t*)(rp + kCsrRows + 1);     // [32, wg] not_mine
  uint32_t* new_s = nm_s + kCsrRows * wmax;            // [32, wg] new
  int* rid = (int*)(new_s + kCsrRows * wmax);          // [cap_e] row of each edge
  uint32_t* tr = (uint32_t*)(rid + cap_e);             // [cap_e, wg] transmit
  uint32_t* inc = tr + cap_e * wmax;                   // [cap_e, wg] inclusive OR

  const int w0 = blockIdx.y * kWord;                   // first word of this group
  const int wg = group_words(w - w0);
  const long long r0 = ((long long)blockIdx.x * kCsrWarps + warp) * kCsrRows;
  if (r0 >= n) return;
  const int nrows = n - r0 < kCsrRows ? (int)(n - r0) : kCsrRows;

  const int my_start = lane < nrows ? row_ptr[r0 + lane] : 0;
  const int my_end = lane < nrows ? row_ptr[r0 + lane + 1] : 0;
  if (lane == 0) rp[0] = my_start;
  if (lane < nrows) rp[lane + 1] = my_end;
  for (int t = lane; t < nrows * wg; t += 32) {
    const int r = t / wg;
    nm_s[t] = not_mine[(r0 + r) * w + w0 + (t - r * wg)];
  }
  __syncwarp();

  // a lane's fixed place in a chunk of epc edges x wg words
  const int epc = kWord / wg;
  const int chunk = epc * wg;
  const int le = lane / wg;
  const int wi = lane - le * wg;
  const bool lane_on = lane < chunk;
  const long long wcol = w0 + wi;

  int rb = 0;
  while (rb < nrows) {
    const int ea = rp[rb];
    // the batch: rows rb.. whose edges fit cap_e (row_ptr is monotone, so
    // the fitting lanes are one run from rb)
    const unsigned fit = __ballot_sync(kFull, lane >= rb && lane < nrows && my_end - ea <= cap_e);
    const int re = rb + __popc(fit);
    if (re == rb) {
      // one row longer than a batch: one lane per word walks it twice,
      // reading its transmit words back (rows this long are off the
      // capacity-bounded main path)
      const int a = ea, b = rp[rb + 1];
      if (lane < wg) {
        const uint32_t nmw = nm_s[rb * wg + lane];
        const long long c0 = w0 + lane;
        uint32_t acc = 0u;
        for (int e = a; e < b; ++e) {
          const long long gi = (long long)e * w + c0;
          uint32_t t = fwd[(long long)col[e] * w + c0] & ~fe[(long long)eperm[e] * w + c0] &
                       mask[gi] & nmw;
          if (link_ok != nullptr && link_ok[e] == 0) t = 0u;
          trans_out[gi] = t;
          acc |= t;
        }
        const long long gr = (r0 + rb) * w + c0;
        const uint32_t h = have[gr];
        const uint32_t nw = acc & ~h;
        recv_out[gr] = acc;
        new_out[gr] = nw;
        have_out[gr] = h | nw;
        fwd_out[gr] = nw & valid[c0];
        new_s[rb * wg + lane] = nw;
        uint32_t exc = 0u;
        for (int e = a; e < b; ++e) {
          const long long gi = (long long)e * w + c0;
          const uint32_t t = trans_out[gi];
          const uint32_t fa = t & ~exc & nw;
          fa_out[gi] = fa;
          fe_out[gi] = (fe[gi] & ~nw) | fa;
          exc |= t;
        }
      }
      __syncwarp();
      rb += 1;
      continue;
    }
    const int ne = rp[re] - ea;
    const int nch = (ne + epc - 1) / epc;
    if (lane >= rb && lane < re)
      for (int e = my_start; e < my_end; ++e) rid[e - ea] = lane;
    __syncwarp();

    // edge phase: the transmit words, contiguous over the batch's edges
#pragma unroll 4
    for (int c = 0; c < nch; ++c) {
      const int x = c * epc + le;
      if (lane_on && x < ne) {
        const long long e = ea + x;
        const long long gi = e * w + wcol;
        uint32_t t = fwd[(long long)col[e] * w + wcol] & ~fe[(long long)eperm[e] * w + wcol] &
                     mask[gi] & nm_s[rid[x] * wg + wi];
        if (link_ok != nullptr && link_ok[e] == 0) t = 0u;
        trans_out[gi] = t;
        tr[x * wg + wi] = t;
      }
    }
    __syncwarp();

    // segmented inclusive OR along each row, word by word: shuffles within
    // a chunk, the carry across chunks
    uint32_t carry = 0u;
    for (int c = 0; c < nch; ++c) {
      const int x = c * epc + le;
      const bool on = lane_on && x < ne;
      uint32_t v = on ? tr[x * wg + wi] : 0u;
      int start = !on || x == 0 || rid[x] != rid[x - 1];
      for (int d = wg; d < chunk; d <<= 1) {
        const uint32_t vu = __shfl_up_sync(kFull, v, d);
        const int su = __shfl_up_sync(kFull, start, d);
        if (lane >= d && !start) {
          v |= vu;
          start = su;
        }
      }
      if (!start) v |= carry;
      carry = __shfl_sync(kFull, v, (epc - 1) * wg + wi);
      if (on) inc[x * wg + wi] = v;
    }
    __syncwarp();

    // row phase: the receive word is the inclusive OR at the row's last edge
    for (int t = lane; t < (re - rb) * wg; t += 32) {
      const int r = rb + t / wg;
      const int wj = t - (r - rb) * wg;
      const int a = rp[r], b = rp[r + 1];
      const uint32_t recv = b > a ? inc[(b - 1 - ea) * wg + wj] : 0u;
      const long long gr = (r0 + r) * w + w0 + wj;
      const uint32_t h = have[gr];
      const uint32_t nw = recv & ~h;
      recv_out[gr] = recv;
      new_out[gr] = nw;
      have_out[gr] = h | nw;
      fwd_out[gr] = nw & valid[w0 + wj];
      new_s[r * wg + wj] = nw;
    }
    __syncwarp();

    // edge commit: the lowest edge of a row wins each new message
#pragma unroll 4
    for (int c = 0; c < nch; ++c) {
      const int x = c * epc + le;
      if (lane_on && x < ne) {
        const long long gi = (long long)(ea + x) * w + wcol;
        const int r = rid[x];
        const uint32_t exc = (x == 0 || rid[x - 1] != r) ? 0u : inc[(x - 1) * wg + wi];
        const uint32_t nw = new_s[r * wg + wi];
        const uint32_t fa = tr[x * wg + wi] & ~exc & nw;
        fa_out[gi] = fa;
        fe_out[gi] = (fe[gi] & ~nw) | fa;
      }
    }
    __syncwarp();
    rb = re;
  }

  // the first_round stamp of the warp's rows, slots [32*w0, 32*(w0+wg))
  const int tk = *tick;
  const int s0 = w0 * kWord;
  const int s1 = m < s0 + wg * kWord ? m : s0 + wg * kWord;
  if (s0 == 0 && s1 == m) {
    // every slot: rows [r0, r0+nrows) are one contiguous run of the plane
    const long long base = r0 * m;
    const int total = nrows * m;
    int done = 0;
    if (vec_stamp && base % 4 == 0) {
      const int nv = total / 4;
      const int4* src = reinterpret_cast<const int4*>(first_round + base);
      int4* dst = reinterpret_cast<int4*>(fr_out + base);
      // (row, slot) of a lane's vector, advanced by 128 slots a step
      const int step_r = 128 / m, step_s = 128 - step_r * m;
      int rl = (4 * lane) / m;
      int sl = 4 * lane - rl * m;
#pragma unroll 4
      for (int q = lane; q < nv; q += 32) {
        const int rq = rl, sq = sl;
        rl += step_r;
        sl += step_s;
        if (sl >= m) {
          sl -= m;
          ++rl;
        }
        int4 f = src[q];
        int o[4] = {f.x, f.y, f.z, f.w};
        int r4 = rq, s4 = sq;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if ((new_s[r4 * wg + (s4 >> 5)] >> (s4 & 31)) & 1u) o[u] = tk;
          if (++s4 == m) {
            s4 = 0;
            ++r4;
          }
        }
        dst[q] = make_int4(o[0], o[1], o[2], o[3]);
      }
      done = 4 * nv;
    }
    for (int x = done + lane; x < total; x += 32) {
      const int rl = x / m, sl = x - rl * m;
      const int f = first_round[base + x];
      fr_out[base + x] = ((new_s[rl * wg + (sl >> 5)] >> (sl & 31)) & 1u) ? tk : f;
    }
  } else {
    const int span = s1 - s0;
    for (int x = lane; x < nrows * span; x += 32) {
      const int rl = x / span, sl = x - rl * span;
      const long long at = (r0 + rl) * m + s0 + sl;
      fr_out[at] = ((new_s[rl * wg + (sl >> 5)] >> (sl & 31)) & 1u) ? tk : first_round[at];
    }
  }
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
  const size_t smem = (size_t)kCsrWarps * csr_warp_words(w) * sizeof(int);
  const long long warps = ((long long)n + kCsrRows - 1) / kCsrRows;
  const dim3 grid((unsigned int)((warps + kCsrWarps - 1) / kCsrWarps),
                  (unsigned int)((w + kWord - 1) / kWord));
  const int vec_stamp = (uintptr_t)first_round % 16 == 0 && (uintptr_t)fr_out % 16 == 0;
  csr_delivery_kernel<<<grid, 32 * kCsrWarps, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)fwd, (const uint32_t*)fe, (const uint32_t*)mask,
      (const uint32_t*)not_mine, (const uint32_t*)have,
      (const int*)first_round, (const uint32_t*)valid, (const int*)tick,
      (const int*)col, (const int*)eperm, (const int*)row_ptr,
      (const uint8_t*)link_ok, (uint32_t*)trans_out, (uint32_t*)recv_out,
      (uint32_t*)new_out, (uint32_t*)have_out, (uint32_t*)fwd_out,
      (int*)fr_out, (uint32_t*)fe_out, (uint32_t*)fa_out, n, w, m, vec_stamp);
  return (int)cudaGetLastError();
}
