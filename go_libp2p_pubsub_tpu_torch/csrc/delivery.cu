// Hopper (sm_90a) kernels of the shared delivery round (the propagation
// round every router runs), with a plain C interface (bound from Python
// through ctypes by go_libp2p_pubsub_tpu_torch/ops/delivery_banded.py and
// go_libp2p_pubsub_tpu_torch/ops/csr_delivery.py).
//
// They replace the TPU Pallas kernels of the JAX package:
//   delivery_banded_sims <- go_libp2p_pubsub_tpu/ops/pallas_delivery.py
//                              delivery_round_banded / _kernel
//   csr_delivery_sims    <- go_libp2p_pubsub_tpu/ops/pallas_csr.py
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
// delivery_banded is laid out for the card as banded.cuh sets out: a block
// owns 64 consecutive receivers (fewer when W is wide) and loads, all at
// once with 16-byte vectors, the sender rows of fe and fwd its band needs
// and its own rows' emask, not_mine and have into shared memory; a row's
// (edge, word) elements sit on neighbouring lanes, so trans and fe' are
// written as whole 128-byte rows at the bench shape. The OR over a row's
// edges and the lowest-edge-wins prefix are shuffle scans; trans stays in
// registers (K above a chunk of 32 edges recomputes its words for the
// commit pass rather than reading them back). An offset beyond the block's
// halo reads its sender words from global memory. The first_round stamp
// runs last over the block's contiguous [rows, M] stretch as 16-byte
// vectors through the read-only path (stamp_rows, shared with
// csr_delivery).
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
// senders.
//
// The sim axis (sims.cuh): delivery_banded_sims and csr_delivery_sims run S
// simulations in one launch, sim z on grid.z, each pointer moved by its sim
// stride (0: shared by the sims, as offrev, col, eperm and row_ptr are when
// the sims share a topology). The one-sim entry points are the S = 1 call.
// Each launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "banded.cuh"
#include "sims.cuh"

namespace {

constexpr int kWord = 32;

// The first_round stamp of nrows rows, slots [s0, s1): dst = src with `tk`
// where the row's new bit is set, bit s - s0 of the row's words in new_s
// (ws words a row). src and dst point at the first row ([nrows, m]); src
// is read through __ldg (the read-only path); thread t of nt. Whole rows (s0 == 0, s1 == m)
// are one contiguous stretch, taken as 16-byte vectors with neighbouring
// threads on neighbouring addresses when both pointers allow; only slots
// below m exist, never the padding bits of the last word.
__device__ __forceinline__ void stamp_rows(const int* __restrict__ src, int* __restrict__ dst,
                                           int nrows,
                                           int m, int s0, int s1,
                                           const uint32_t* __restrict__ new_s, int ws, int tk,
                                           int t, int nt) {
  if (s0 == 0 && s1 == m) {
    const int total = nrows * m;
    int done = 0;
    if ((((uintptr_t)src | (uintptr_t)dst) & 15u) == 0u) {
      const int nv = total / 4;
      const int4* src4 = reinterpret_cast<const int4*>(src);
      int4* dst4 = reinterpret_cast<int4*>(dst);
      // (row, slot) of a thread's vector, advanced by 4 * nt slots a step
      const int step_r = 4 * nt / m, step_s = 4 * nt - step_r * m;
      int rl = (4 * t) / m;
      int sl = 4 * t - rl * m;
#pragma unroll 4
      for (int q = t; q < nv; q += nt) {
        const int rq = rl, sq = sl;
        rl += step_r;
        sl += step_s;
        if (sl >= m) {
          sl -= m;
          ++rl;
        }
        const int4 f = __ldg(src4 + q);
        int o[4] = {f.x, f.y, f.z, f.w};
        int r4 = rq, s4 = sq;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if ((new_s[r4 * ws + (s4 >> 5)] >> (s4 & 31)) & 1u) o[u] = tk;
          if (++s4 == m) {
            s4 = 0;
            ++r4;
          }
        }
        dst4[q] = make_int4(o[0], o[1], o[2], o[3]);
      }
      done = 4 * nv;
    }
    for (int x = done + t; x < total; x += nt) {
      const int rl = x / m, sl = x - rl * m;
      dst[x] = ((new_s[rl * ws + (sl >> 5)] >> (sl & 31)) & 1u) ? tk : __ldg(src + x);
    }
  } else {
    const int span = s1 - s0;
    for (int x = t; x < nrows * span; x += nt) {
      const int rl = x / span, sl = x - rl * span;
      const long long at = (long long)rl * m + s0 + sl;
      dst[at] = ((new_s[rl * ws + (sl >> 5)] >> (sl & 31)) & 1u) ? tk : __ldg(src + at);
    }
  }
}

// --- delivery_banded: a block owns a run of rows and stages its band ---

// words a staged sender row takes per block word (fe's K edges, fwd), and
// an own row (emask's K edges, not_mine, have, new)
constexpr int banded_staged(int k) { return k + 1; }
constexpr int banded_own(int k) { return k + 3; }

// kSims: sim blockIdx.z of a batched launch, its pointers moved by the
// strides (in elements, in the order of the parameters)
template <bool kSims>
__global__ void __launch_bounds__(banded::kThreads) delivery_banded_kernel(
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
    const banded::Layout L, int m, const sims::Strides<kSims> ss) {
  using namespace banded;
  extern __shared__ uint4 smem_v[];
  if constexpr (kSims) {
    const long long z = blockIdx.z;
    fwd = sims::at(fwd, ss.e[0], z);
    fe = sims::at(fe, ss.e[1], z);
    emask = sims::at(emask, ss.e[2], z);
    not_mine = sims::at(not_mine, ss.e[3], z);
    have = sims::at(have, ss.e[4], z);
    first_round = sims::at(first_round, ss.e[5], z);
    valid = sims::at(valid, ss.e[6], z);
    tick = sims::at(tick, ss.e[7], z);
    offrev = sims::at(offrev, ss.e[8], z);
    trans_out = sims::at(trans_out, ss.e[9], z);
    fe_out = sims::at(fe_out, ss.e[10], z);
    new_out = sims::at(new_out, ss.e[11], z);
    have_out = sims::at(have_out, ss.e[12], z);
    fwd_out = sims::at(fwd_out, ss.e[13], z);
    fr_out = sims::at(fr_out, ss.e[14], z);
  }
  const int n = L.n, nk = L.k, w = L.w;
  const long long r0 = (long long)blockIdx.x * L.rows;
  const int nrows = n - r0 < L.rows ? (int)(n - r0) : L.rows;
  const int w0 = blockIdx.y * L.wb;
  const int wb = w - w0 < L.wb ? w - w0 : L.wb;
  uint32_t* st_fe = reinterpret_cast<uint32_t*>(smem_v);   // [stage_rows, K, wb]
  uint32_t* st_fwd = st_fe + L.stage_rows * nk * L.wb;     // [stage_rows, wb]
  uint32_t* own_em = st_fwd + L.stage_rows * L.wb;         // [rows, K, wb]
  uint32_t* own_nm = own_em + L.rows * nk * L.wb;          // [rows, wb]
  uint32_t* own_have = own_nm + L.rows * L.wb;
  uint32_t* own_new = own_have + L.rows * L.wb;

  // the block's reads in flight at once: the band's sender rows and the
  // own rows' edge masks and words
  int lo, hi;
  window(offrev, nk, n, L.halo, lo, hi);
  const int ns = nrows + hi - lo;
  stage(st_fe, fe, r0 + lo, ns, n, nk, w, w0, wb);
  stage(st_fwd, fwd, r0 + lo, ns, n, 1, w, w0, wb);
  stage(own_em, emask, r0, nrows, n, nk, w, w0, wb);
  stage(own_nm, not_mine, r0, nrows, n, 1, w, w0, wb);
  stage(own_have, have, r0, nrows, n, 1, w, w0, wb);
  __syncthreads();

  const Lane p = lane_of(L);
  const Edge e0 = edge_of(offrev, p.ke, nk, n, L.halo);   // the lane's edge in chunk 0
  const int groups = (wb + L.wg - 1) / L.wg;
  const int units = nrows * groups;
  for (int ub = (threadIdx.x >> 5) * L.upw; ub < units; ub += kWarps * L.upw) {
    const int u = ub + p.unit;
    const bool on_u = p.on && u < units;
    const int rl = !on_u ? 0 : (groups == 1 ? u : u / groups);
    const int wl = (u - rl * groups) * L.wg + p.wi;
    const bool on_w = on_u && wl < wb;
    const long long j = r0 + rl;
    const long long wcol = w0 + wl;
    const uint32_t h = on_w ? own_have[rl * wb + wl] : 0u;
    const uint32_t nm = on_w ? own_nm[rl * wb + wl] : 0u;
    // the transmit word of edge k: the sender's fwd, less its echo on the
    // reverse edge, under the edge mask and not_mine
    const auto trans = [=](const Edge ed, int k) -> uint32_t {
      uint32_t echo, fs;
      if (ed.near) {
        const int sl = rl + ed.so - lo;
        echo = st_fe[(sl * nk + ed.rev) * wb + wl];
        fs = st_fwd[sl * wb + wl];
      } else {
        long long s = j + ed.off;
        if (s >= n) s -= n;
        echo = fe[(s * nk + ed.rev) * w + wcol];
        fs = fwd[s * w + wcol];
      }
      return fs & ~echo & own_em[(rl * nk + k) * wb + wl] & nm;
    };

    // receive pass: trans out, the OR over the row's edges
    uint32_t t0 = 0u, inc0 = 0u, acc = 0u;
    for (int c = 0; c < L.nch; ++c) {
      const int k = c * L.epc + p.ke;
      const bool on = on_w && k < nk;
      uint32_t t = 0u;
      if (on) {
        t = c == 0 ? trans(e0, k) : trans(edge_of(offrev, k, nk, n, L.halo), k);
        trans_out[(j * nk + k) * w + wcol] = t;
      }
      const uint32_t inc = scan_or(t, p, L);
      if (c == 0) {
        t0 = t;
        inc0 = inc;
      }
      acc |= __shfl_sync(kFull, inc, p.last);
    }
    const uint32_t nw = acc & ~h;

    // commit pass: the lowest edge wins each new message
    uint32_t carry = 0u;
    for (int c = 0; c < L.nch; ++c) {
      const int k = c * L.epc + p.ke;
      const bool on = on_w && k < nk;
      uint32_t t = t0, inc = inc0;
      if (c > 0) {
        t = on ? trans(edge_of(offrev, k, nk, n, L.halo), k) : 0u;
        inc = scan_or(t, p, L);
      }
      const uint32_t exc = carry | exclusive(inc, p, L);
      if (on) {
        const uint32_t own = st_fe[((rl - lo) * nk + k) * wb + wl];
        fe_out[(j * nk + k) * w + wcol] = (own & ~nw) | (t & ~exc & nw);
      }
      carry |= __shfl_sync(kFull, inc, p.last);
    }
    if (on_w && p.ke == 0) own_new[rl * wb + wl] = nw;
  }
  __syncthreads();

  const int s0 = w0 * kWord;
  const int s1 = m < s0 + wb * kWord ? m : s0 + wb * kWord;
  stamp_rows(first_round + r0 * m, fr_out + r0 * m, nrows, m, s0, s1, own_new, wb, *tick,
             threadIdx.x, kThreads);
  for (int x = threadIdx.x; x < nrows * wb; x += kThreads) {
    const int rl = x / wb, wl = x - rl * wb;
    const long long gi = (r0 + rl) * w + w0 + wl;
    const uint32_t nw = own_new[x];
    new_out[gi] = nw;
    have_out[gi] = own_have[x] | nw;
    fwd_out[gi] = nw & valid[w0 + wl];
  }
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

// kSims: sim blockIdx.z of a batched launch (as delivery_banded_kernel)
template <bool kSims>
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
    int n, int w, int m, const sims::Strides<kSims> ss) {
  extern __shared__ int smem[];
  if constexpr (kSims) {
    const long long z = blockIdx.z;
    fwd = sims::at(fwd, ss.e[0], z);
    fe = sims::at(fe, ss.e[1], z);
    mask = sims::at(mask, ss.e[2], z);
    not_mine = sims::at(not_mine, ss.e[3], z);
    have = sims::at(have, ss.e[4], z);
    first_round = sims::at(first_round, ss.e[5], z);
    valid = sims::at(valid, ss.e[6], z);
    tick = sims::at(tick, ss.e[7], z);
    col = sims::at(col, ss.e[8], z);
    eperm = sims::at(eperm, ss.e[9], z);
    row_ptr = sims::at(row_ptr, ss.e[10], z);
    link_ok = sims::at(link_ok, ss.e[11], z);
    trans_out = sims::at(trans_out, ss.e[12], z);
    recv_out = sims::at(recv_out, ss.e[13], z);
    new_out = sims::at(new_out, ss.e[14], z);
    have_out = sims::at(have_out, ss.e[15], z);
    fwd_out = sims::at(fwd_out, ss.e[16], z);
    fr_out = sims::at(fr_out, ss.e[17], z);
    fe_out = sims::at(fe_out, ss.e[18], z);
    fa_out = sims::at(fa_out, ss.e[19], z);
  }
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
  const int s0 = w0 * kWord;
  const int s1 = m < s0 + wg * kWord ? m : s0 + wg * kWord;
  stamp_rows(first_round + r0 * m, fr_out + r0 * m, nrows, m, s0, s1, new_s, wg, *tick,
             lane, 32);
}

bool bad_words(int n, int w, int m) {
  return n <= 0 || w <= 0 || m <= 0 || m > w * kWord || m <= (w - 1) * kWord;
}

}  // namespace

// delivery_banded over S sims: the strides of its 15 pointers, in their order
extern "C" int delivery_banded_sims(
    const void* fwd, const void* fe, const void* emask, const void* not_mine,
    const void* have, const void* first_round, const void* valid,
    const void* tick, const void* offrev, void* trans_out, void* fe_out,
    void* new_out, void* have_out, void* fwd_out, void* fr_out, int n, int k,
    int w, int m, int s, const long long* strides, void* stream) {
  if (k <= 0 || bad_words(n, w, m) || s <= 0 || s > 65535) return (int)cudaErrorInvalidValue;
  const banded::Layout L = banded::make_layout(n, k, w, banded_staged(k), banded_own(k));
  if (L.rows == 0) return (int)cudaErrorInvalidValue;   // K too wide to stage one row
  const sims::Batched ss = sims::load(strides, 15);
  const dim3 grid((unsigned int)((n + L.rows - 1) / L.rows),
                  (unsigned int)((w + L.wb - 1) / L.wb), (unsigned int)s);
#define BANDED_ARGS                                                                  \
  (const uint32_t*)fwd, (const uint32_t*)fe, (const uint32_t*)emask,                \
      (const uint32_t*)not_mine, (const uint32_t*)have, (const int*)first_round,    \
      (const uint32_t*)valid, (const int*)tick, (const int*)offrev,                 \
      (uint32_t*)trans_out, (uint32_t*)fe_out, (uint32_t*)new_out,                  \
      (uint32_t*)have_out, (uint32_t*)fwd_out, (int*)fr_out, L, m
  if (s == 1)
    delivery_banded_kernel<false><<<grid, banded::kThreads, L.smem_bytes,
                                    (cudaStream_t)stream>>>(BANDED_ARGS, sims::Strides<false>{});
  else
    delivery_banded_kernel<true><<<grid, banded::kThreads, L.smem_bytes,
                                   (cudaStream_t)stream>>>(BANDED_ARGS, ss);
#undef BANDED_ARGS
  return (int)cudaGetLastError();
}

// csr_delivery over S sims: the strides of its 20 pointers, in their order
extern "C" int csr_delivery_sims(
    const void* fwd, const void* fe, const void* mask, const void* not_mine,
    const void* have, const void* first_round, const void* valid,
    const void* tick, const void* col, const void* eperm, const void* row_ptr,
    const void* link_ok, void* trans_out, void* recv_out, void* new_out,
    void* have_out, void* fwd_out, void* fr_out, void* fe_out, void* fa_out,
    int n, int w, int m, int s, const long long* strides, void* stream) {
  if (bad_words(n, w, m) || s <= 0 || s > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kCsrWarps * csr_warp_words(w) * sizeof(int);
  const long long warps = ((long long)n + kCsrRows - 1) / kCsrRows;
  const sims::Batched ss = sims::load(strides, 20);
  const dim3 grid((unsigned int)((warps + kCsrWarps - 1) / kCsrWarps),
                  (unsigned int)((w + kWord - 1) / kWord), (unsigned int)s);
#define CSR_ARGS                                                                     \
  (const uint32_t*)fwd, (const uint32_t*)fe, (const uint32_t*)mask,                 \
      (const uint32_t*)not_mine, (const uint32_t*)have, (const int*)first_round,    \
      (const uint32_t*)valid, (const int*)tick, (const int*)col, (const int*)eperm, \
      (const int*)row_ptr, (const uint8_t*)link_ok, (uint32_t*)trans_out,           \
      (uint32_t*)recv_out, (uint32_t*)new_out, (uint32_t*)have_out,                 \
      (uint32_t*)fwd_out, (int*)fr_out, (uint32_t*)fe_out, (uint32_t*)fa_out, n, w, \
      m
  if (s == 1)
    csr_delivery_kernel<false><<<grid, 32 * kCsrWarps, smem, (cudaStream_t)stream>>>(
        CSR_ARGS, sims::Strides<false>{});
  else
    csr_delivery_kernel<true><<<grid, 32 * kCsrWarps, smem, (cudaStream_t)stream>>>(
        CSR_ARGS, ss);
#undef CSR_ARGS
  return (int)cudaGetLastError();
}
