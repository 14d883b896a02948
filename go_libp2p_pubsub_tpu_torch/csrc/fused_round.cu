// Hopper (sm_90a) kernels of the per-round GossipSub data plane on a banded
// topology, with a plain C interface (bound from Python through ctypes by
// go_libp2p_pubsub_tpu_torch/ops/fused_round.py).
//
// They replace the TPU Pallas kernels of the JAX package:
//   edge_exchange_sims   <- go_libp2p_pubsub_tpu/ops/fused_round.py
//                              edge_exchange / _exchange_kernel
//   fused_delivery_sims  <- go_libp2p_pubsub_tpu/ops/fused_round.py
//                              fused_delivery / _delivery_kernel
//
// Banded topology: receiver j's edge k talks to sender (j + off[k]) mod N,
// which holds the edge in its slot rev[k]. `offrev` is a device int32 array
// [2K]: off[0..K) (each in [0, N)) then rev[0..K).
//
// What bounds them on the card: bytes. Both are pure word algebra (a few
// integer ops per loaded word), so the floor is the bytes each must move
// once over HBM at 3.35 TB/s — edge_exchange about 70 MB at N=100k, K=16,
// C=4 (about 21 us), fused_delivery about 134 MB with W=2 and no cohort
// planes (about 40 us).
//
// edge_exchange moves 16 + 2 * 4 * C bytes a (receiver, edge) slot and
// does no arithmetic: it copies words and score bits, a subnormal score as
// it is. Its block is (vectors of a slot, K edges, rows): lane (x, k, r)
// copies vectors x, x + bx, .. of receiver row r's slot k, so the index
// math is 32-bit with no division and a warp writes a run of whole output
// rows. A slot's C words move as 16-byte vectors when C is a multiple of 4
// and both wire pointers are 16-byte aligned, as 8-byte vectors when C is
// even and both are 8-byte aligned (the phase engine's C = 6 control head
// and C = 2 data words), as 4-byte words otherwise.
// Each receiver slot reads its live flag once, from a coalesced run, and
// its sender's vectors and score through the read-only path: the sender
// rows of a band are read by their 2K neighbours within a few rows, so L2
// (50 MB, a 25.6 MB wire plane at the bench) serves all but the first.
//
// fused_delivery is laid out for the card as banded.cuh sets out: a block
// owns 64 consecutive receivers and stages the sender rows of carry, fe,
// fwd and the mcache window its band needs in shared memory with 16-byte
// loads; a row's (edge, word) elements sit on neighbouring lanes (one
// 128-byte row a warp instruction at K=16, W=2), so asked, served_lo/hi,
// flags, nbr_score and every output plane move coalesced. The OR over a
// row's edges of each cohort (mesh push, IWANT response) is a shuffle scan
// over the lanes of one word, and its exclusive prefix lets the lowest edge
// win, in place of per-thread first-arrival arrays. Its score gates read a
// subnormal neighbour score or threshold as a zero of its sign (fnum.cuh),
// as XLA does.
//
// The sim axis (sims.cuh): edge_exchange_sims and fused_delivery_sims run S
// simulations in one launch, sim z on grid.y (edge_exchange) or grid.z
// (fused_delivery), each pointer moved by its sim stride (0: shared by the
// sims, as offrev always is). The one-sim entry points are the S = 1 call.
// Each launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "banded.cuh"
#include "fnum.cuh"
#include "sims.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kExchangeThreads = 256;   // edge_exchange's block, at most
constexpr int kMaxBlockRows = 64;       // blockDim.z's limit
constexpr uint32_t kAll = 0xFFFFFFFFu;

// flag bits (ops/fused_round.make_flags)
constexpr int F_ACC_MSG = 0;
constexpr int F_FLOOD_FROM = 1;
constexpr int F_I_AM_FLOODSUB = 2;
constexpr int F_SENDER_FWD = 3;
constexpr int F_LIVE = 4;

__device__ __forceinline__ uint32_t gate(bool c) { return c ? kAll : 0u; }

__device__ __forceinline__ bool bit(uint32_t f, int b) { return (f >> b) & 1u; }

// word-mask of slots whose 2-bit served count reached the retransmission
// cap (ops/fused_round.served_capped_mask); cap is clamped to [0, 3]
__device__ __forceinline__ uint32_t served_capped(int cap, uint32_t lo,
                                                  uint32_t hi) {
  if (cap >= 3) return hi & lo;
  if (cap == 2) return hi;
  if (cap == 1) return hi | lo;
  return kAll;
}

// kSims: sim blockIdx.y of a batched launch (strides in elements, wire's
// and wire_out's in vectors V)
template <typename V, bool kSims>
__global__ void __launch_bounds__(kExchangeThreads) edge_exchange_kernel(
    const V* __restrict__ wire,           // [N, K, nv] vectors of a slot's C words
    const float* __restrict__ scores,     // [N, K] or null
    const uint32_t* __restrict__ live,    // [N, K]
    const int* __restrict__ offrev,       // [2K]
    V* __restrict__ wire_out,             // [N, K, nv]
    float* __restrict__ score_out,        // [N, K] or null
    int n, int k, int nv, int score_enabled, const sims::Strides<kSims> ss) {
  if constexpr (kSims) {
    const long long z = blockIdx.y;
    wire = sims::at(wire, ss.e[0], z);
    scores = sims::at(scores, ss.e[1], z);
    live = sims::at(live, ss.e[2], z);
    offrev = sims::at(offrev, ss.e[3], z);
    wire_out = sims::at(wire_out, ss.e[4], z);
    score_out = sims::at(score_out, ss.e[5], z);
  }
  const int kk = threadIdx.y;
  const int j = blockIdx.x * blockDim.z + threadIdx.z;
  if (j >= n) return;
  int s = j + __ldg(offrev + kk);   // off in [0, N)
  if (s >= n) s -= n;
  const unsigned jk = (unsigned)j * k + kk;
  const unsigned sk = (unsigned)s * k + __ldg(offrev + k + kk);
  const bool lv = __ldg(live + jk) != 0u;
  const V* src = wire + (size_t)sk * nv;
  V* dst = wire_out + (size_t)jk * nv;
  for (int x = threadIdx.x; x < nv; x += blockDim.x) dst[x] = lv ? __ldg(src + x) : V{};
  if (score_enabled && threadIdx.x == 0) score_out[jk] = lv ? __ldg(scores + sk) : 0.0f;
}

// words a staged sender row takes per block word (carry and fe over K
// edges, fwd, the mcache window), and an own row (have, origin, joined, new)
constexpr int fused_staged(int k) { return 2 * k + 2; }
constexpr int kFusedOwn = 4;

// kSims: sim blockIdx.z of a batched launch, its pointers moved by the
// strides (in elements, in the order of the parameters)
template <bool kSims>
__global__ void __launch_bounds__(banded::kThreads) fused_delivery_kernel(
    const uint32_t* __restrict__ carry,   // [N, K*W] sender push outboxes
    const uint32_t* __restrict__ fe,      // [N, K*W] first-arrival edges
    const uint32_t* __restrict__ fwd,     // [N, W]
    const uint32_t* __restrict__ mcw,     // [N, W] mcache window
    const float* __restrict__ nbrsc,      // [N, K] or null
    const uint32_t* __restrict__ asked,   // [N, K*W]
    const uint32_t* __restrict__ slo,     // [N, K*W]
    const uint32_t* __restrict__ shi,     // [N, K*W]
    const uint32_t* __restrict__ flags,   // [N, K]
    const uint32_t* __restrict__ have,    // [N, W]
    const uint32_t* __restrict__ origin,  // [N, W]
    const uint32_t* __restrict__ joined,  // [N, W]
    const uint32_t* __restrict__ valid,   // [W]
    const float* __restrict__ thr,        // [2]: gossip, publish
    const int* __restrict__ offrev,       // [2K]
    uint32_t* __restrict__ trans_out,     // [N, K*W]
    uint32_t* __restrict__ fe_out,        // [N, K*W] (never aliases fe)
    uint32_t* __restrict__ slo_out,       // [N, K*W]
    uint32_t* __restrict__ shi_out,       // [N, K*W]
    uint32_t* __restrict__ new_out,       // [N, W]
    uint32_t* __restrict__ have_out,      // [N, W]
    uint32_t* __restrict__ fwd_out,       // [N, W]
    uint32_t* __restrict__ mesh_t_out,    // [N, K*W] or null
    uint32_t* __restrict__ extra_out,     // [N, K*W] or null
    const banded::Layout L, int score_enabled, int want_cohorts, int retrans_cap,
    const sims::Strides<kSims> ss) {
  using namespace banded;
  extern __shared__ uint4 smem_v[];
  if constexpr (kSims) {
    const long long z = blockIdx.z;
    carry = sims::at(carry, ss.e[0], z);
    fe = sims::at(fe, ss.e[1], z);
    fwd = sims::at(fwd, ss.e[2], z);
    mcw = sims::at(mcw, ss.e[3], z);
    nbrsc = sims::at(nbrsc, ss.e[4], z);
    asked = sims::at(asked, ss.e[5], z);
    slo = sims::at(slo, ss.e[6], z);
    shi = sims::at(shi, ss.e[7], z);
    flags = sims::at(flags, ss.e[8], z);
    have = sims::at(have, ss.e[9], z);
    origin = sims::at(origin, ss.e[10], z);
    joined = sims::at(joined, ss.e[11], z);
    valid = sims::at(valid, ss.e[12], z);
    thr = sims::at(thr, ss.e[13], z);
    offrev = sims::at(offrev, ss.e[14], z);
    trans_out = sims::at(trans_out, ss.e[15], z);
    fe_out = sims::at(fe_out, ss.e[16], z);
    slo_out = sims::at(slo_out, ss.e[17], z);
    shi_out = sims::at(shi_out, ss.e[18], z);
    new_out = sims::at(new_out, ss.e[19], z);
    have_out = sims::at(have_out, ss.e[20], z);
    fwd_out = sims::at(fwd_out, ss.e[21], z);
    mesh_t_out = sims::at(mesh_t_out, ss.e[22], z);
    extra_out = sims::at(extra_out, ss.e[23], z);
  }
  const int n = L.n, nk = L.k, w = L.w;
  const long long r0 = (long long)blockIdx.x * L.rows;
  const int nrows = n - r0 < L.rows ? (int)(n - r0) : L.rows;
  const int w0 = blockIdx.y * L.wb;
  const int wb = w - w0 < L.wb ? w - w0 : L.wb;
  const int plane = L.stage_rows * nk * L.wb;
  uint32_t* st_carry = reinterpret_cast<uint32_t*>(smem_v);   // [stage_rows, K, wb]
  uint32_t* st_fe = st_carry + plane;                          // [stage_rows, K, wb]
  uint32_t* st_fwd = st_fe + plane;                            // [stage_rows, wb]
  uint32_t* st_mcw = st_fwd + L.stage_rows * L.wb;             // [stage_rows, wb]
  uint32_t* own_have = st_mcw + L.stage_rows * L.wb;           // [rows, wb]
  uint32_t* own_org = own_have + L.rows * L.wb;
  uint32_t* own_join = own_org + L.rows * L.wb;
  uint32_t* own_new = own_join + L.rows * L.wb;

  // the band's sender rows; the own-row [N, K, W] planes are read in the
  // loop below, a whole row a warp instruction
  int lo, hi;
  window(offrev, nk, n, L.halo, lo, hi);
  const int ns = nrows + hi - lo;
  stage(st_carry, carry, r0 + lo, ns, n, nk, w, w0, wb);
  stage(st_fe, fe, r0 + lo, ns, n, nk, w, w0, wb);
  stage(st_fwd, fwd, r0 + lo, ns, n, 1, w, w0, wb);
  stage(st_mcw, mcw, r0 + lo, ns, n, 1, w, w0, wb);
  stage(own_have, have, r0, nrows, n, 1, w, w0, wb);
  stage(own_org, origin, r0, nrows, n, 1, w, w0, wb);
  stage(own_join, joined, r0, nrows, n, 1, w, w0, wb);
  __syncthreads();

  // K <= 16 fits one chunk (epc == K): a lane keeps one edge throughout
  const Lane p = lane_of(L);
  const Edge ed = edge_of(offrev, p.ke, nk, n, L.halo);
  const float thr_gossip = thr[0];
  const float thr_publish = thr[1];
  const int groups = (wb + L.wg - 1) / L.wg;
  const int units = nrows * groups;
  for (int ub = (threadIdx.x >> 5) * L.upw; ub < units; ub += kWarps * L.upw) {
    const int u = ub + p.unit;
    const bool on_u = p.on && u < units;
    const int rl = !on_u ? 0 : (groups == 1 ? u : u / groups);
    const int wl = (u - rl * groups) * L.wg + p.wi;
    const bool on = on_u && wl < wb && p.ke < nk;
    const long long j = r0 + rl;
    const long long e = (j * nk + p.ke) * w + w0 + wl;   // the lane's own-row word
    uint32_t t_k = 0u, extra_k = 0u, own_fe = 0u, have_j = 0u;
    if (on) {
      uint32_t carry_k, echo_k, fwd_s, mcw_s;
      if (ed.near) {
        const int sl = rl + ed.so - lo;
        carry_k = st_carry[(sl * nk + ed.rev) * wb + wl];
        echo_k = st_fe[(sl * nk + ed.rev) * wb + wl];
        fwd_s = st_fwd[sl * wb + wl];
        mcw_s = st_mcw[sl * wb + wl];
      } else {
        long long s = j + ed.off;
        if (s >= n) s -= n;
        const long long se = (s * nk + ed.rev) * w + w0 + wl;
        carry_k = carry[se];
        echo_k = fe[se];
        fwd_s = fwd[s * w + w0 + wl];
        mcw_s = mcw[s * w + w0 + wl];
      }
      own_fe = st_fe[((rl - lo) * nk + p.ke) * wb + wl];
      have_j = own_have[rl * wb + wl];
      const uint32_t not_mine = ~own_org[rl * wb + wl];
      const uint32_t joined_j = own_join[rl * wb + wl];

      const uint32_t f = flags[j * nk + p.ke];
      const bool live = bit(f, F_LIVE);
      const uint32_t live_g = gate(live);
      const uint32_t accmsg_g = gate(bit(f, F_ACC_MSG));
      const uint32_t sfo_g = gate(bit(f, F_SENDER_FWD));
      float s_k = 0.0f;
      bool recv_ok = live;
      if (score_enabled) {   // a subnormal score gates as a zero, as XLA reads it
        s_k = nbrsc[j * nk + p.ke];
        recv_ok = fnum::ge_ftz(s_k, thr_publish);
      }
      const uint32_t flood = gate(bit(f, F_FLOOD_FROM)) |
                             (gate(bit(f, F_I_AM_FLOODSUB)) & gate(recv_ok));
      const uint32_t emask = (carry_k | flood) & accmsg_g & joined_j;
      t_k = fwd_s & ~echo_k & emask & live_g & sfo_g & not_mine;

      // IWANT service: what I asked edge k last round, served from the
      // neighbour's mcache window, capped per (edge, msg)
      const uint32_t asked_k = asked[e];
      const uint32_t slo_k = slo[e];
      const uint32_t shi_k = shi[e];
      uint32_t resp = asked_k & mcw_s & ~served_capped(retrans_cap, slo_k, shi_k) & live_g;
      if (score_enabled) resp &= gate(fnum::ge_ftz(s_k, thr_gossip));
      const uint32_t inc = resp & ~(shi_k & slo_k);
      slo_out[e] = slo_k ^ inc;
      shi_out[e] = shi_k | (slo_k & inc);

      extra_k = resp & accmsg_g & sfo_g & not_mine;
      trans_out[e] = t_k | extra_k;
      if (want_cohorts) {
        mesh_t_out[e] = t_k;
        extra_out[e] = extra_k;
      }
    }
    // mesh-push arrivals take precedence over IWANT responses; within each
    // cohort the lowest edge slot wins: the OR of the earlier edges
    const uint32_t inc_t = scan_or(t_k, p, L);
    const uint32_t inc_e = scan_or(extra_k, p, L);
    const uint32_t acc_t = __shfl_sync(kFull, inc_t, p.last);
    const uint32_t acc_e = __shfl_sync(kFull, inc_e, p.last);
    const uint32_t first_t = t_k & ~exclusive(inc_t, p, L);
    const uint32_t first_e = extra_k & ~exclusive(inc_e, p, L);
    const uint32_t new_t = acc_t & ~have_j;
    const uint32_t new_e = acc_e & ~(have_j | new_t);
    const uint32_t nw = new_t | new_e;
    if (on) {
      fe_out[e] = (own_fe & ~nw) | (first_t & new_t) | (first_e & new_e);
      if (p.ke == 0) own_new[rl * wb + wl] = nw;
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < nrows * wb; x += kThreads) {
    const int rl = x / wb, wl = x - rl * wb;
    const long long gi = (r0 + rl) * w + w0 + wl;
    const uint32_t nw = own_new[x];
    new_out[gi] = nw;
    have_out[gi] = own_have[x] | nw;
    fwd_out[gi] = nw & valid[w0 + wl];
  }
}

template <typename V>
void launch_exchange(const void* wire, const void* scores, const void* live,
                     const void* offrev, void* wire_out, void* score_out, int n,
                     int k, int nv, int score_enabled, int s, sims::Batched ss,
                     cudaStream_t stream) {
  const int bx = nv < kExchangeThreads / k ? nv : kExchangeThreads / k;
  int bz = kExchangeThreads / (bx * k);
  bz = bz > kMaxBlockRows ? kMaxBlockRows : bz;
  const dim3 block((unsigned)bx, (unsigned)k, (unsigned)bz);
  const unsigned gx = (unsigned)((n + bz - 1) / bz);
  if (s == 1) {
    edge_exchange_kernel<V, false><<<gx, block, 0, stream>>>(
        (const V*)wire, (const float*)scores, (const uint32_t*)live, (const int*)offrev,
        (V*)wire_out, (float*)score_out, n, k, nv, score_enabled, sims::Strides<false>{});
    return;
  }
  // the wire strides in vectors
  const long long per = (long long)(sizeof(V) / sizeof(uint32_t));
  ss.e[0] /= per;
  ss.e[4] /= per;
  edge_exchange_kernel<V, true><<<dim3(gx, (unsigned)s), block, 0, stream>>>(
      (const V*)wire, (const float*)scores, (const uint32_t*)live, (const int*)offrev,
      (V*)wire_out, (float*)score_out, n, k, nv, score_enabled, ss);
}

}  // namespace

// edge_exchange over S sims: the strides of its 6 pointers (wire, scores,
// live, offrev, wire_out, score_out)
extern "C" int edge_exchange_sims(
    const void* wire, const void* scores, const void* live, const void* offrev,
    void* wire_out, void* score_out, int n, int k, int c, int score_enabled, int s,
    const long long* strides, void* stream) {
  if (k > kMaxK || k <= 0 || c <= 0 || n <= 0 || s <= 0 || s > 65535)
    return (int)cudaErrorInvalidValue;
  const sims::Batched ss = sims::load(strides, 6);
  // the widest vectors a slot's C words, both wire pointers and (in a
  // batched launch) both wire strides allow
  const uintptr_t at = (uintptr_t)wire | (uintptr_t)wire_out;
  const bool s4 = s == 1 || (ss.e[0] % 4 == 0 && ss.e[4] % 4 == 0);
  const bool s2 = s == 1 || (ss.e[0] % 2 == 0 && ss.e[4] % 2 == 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (c % 4 == 0 && at % 16 == 0 && s4)
    launch_exchange<uint4>(wire, scores, live, offrev, wire_out, score_out, n, k, c / 4,
                           score_enabled, s, ss, st);
  else if (c % 2 == 0 && at % 8 == 0 && s2)
    launch_exchange<uint2>(wire, scores, live, offrev, wire_out, score_out, n, k, c / 2,
                           score_enabled, s, ss, st);
  else
    launch_exchange<uint32_t>(wire, scores, live, offrev, wire_out, score_out, n, k, c,
                              score_enabled, s, ss, st);
  return (int)cudaGetLastError();
}

// fused_delivery over S sims: the strides of its 24 pointers, in their order
extern "C" int fused_delivery_sims(
    const void* carry, const void* fe, const void* fwd, const void* mcw,
    const void* nbrsc, const void* asked, const void* slo, const void* shi,
    const void* flags, const void* have, const void* origin,
    const void* joined, const void* valid, const void* thr,
    const void* offrev, void* trans_out, void* fe_out, void* slo_out,
    void* shi_out, void* new_out, void* have_out, void* fwd_out,
    void* mesh_t_out, void* extra_out, int n, int k, int w,
    int score_enabled, int want_cohorts, int retrans_cap, int s,
    const long long* strides, void* stream) {
  if (k > kMaxK || k <= 0 || w <= 0 || n <= 0 || s <= 0 || s > 65535)
    return (int)cudaErrorInvalidValue;
  int cap = retrans_cap < 0 ? 0 : (retrans_cap > 3 ? 3 : retrans_cap);
  const banded::Layout L = banded::make_layout(n, k, w, fused_staged(k), kFusedOwn);
  const sims::Batched ss = sims::load(strides, 24);
  const dim3 grid((unsigned int)((n + L.rows - 1) / L.rows),
                  (unsigned int)((w + L.wb - 1) / L.wb), (unsigned int)s);
#define FUSED_ARGS                                                              \
  (const uint32_t*)carry, (const uint32_t*)fe, (const uint32_t*)fwd,           \
      (const uint32_t*)mcw, (const float*)nbrsc, (const uint32_t*)asked,       \
      (const uint32_t*)slo, (const uint32_t*)shi, (const uint32_t*)flags,      \
      (const uint32_t*)have, (const uint32_t*)origin, (const uint32_t*)joined, \
      (const uint32_t*)valid, (const float*)thr, (const int*)offrev,           \
      (uint32_t*)trans_out, (uint32_t*)fe_out, (uint32_t*)slo_out,             \
      (uint32_t*)shi_out, (uint32_t*)new_out, (uint32_t*)have_out,             \
      (uint32_t*)fwd_out, (uint32_t*)mesh_t_out, (uint32_t*)extra_out, L,      \
      score_enabled, want_cohorts, cap
  if (s == 1)
    fused_delivery_kernel<false><<<grid, banded::kThreads, L.smem_bytes,
                                   (cudaStream_t)stream>>>(FUSED_ARGS, sims::Strides<false>{});
  else
    fused_delivery_kernel<true><<<grid, banded::kThreads, L.smem_bytes,
                                  (cudaStream_t)stream>>>(FUSED_ARGS, ss);
#undef FUSED_ARGS
  return (int)cudaGetLastError();
}
