// Hopper (sm_90a) kernels of the per-round GossipSub data plane on a banded
// topology, with a plain C interface (bound from Python through ctypes by
// go_libp2p_pubsub_tpu_torch/ops/fused_round.py).
//
// They replace the TPU Pallas kernels of the JAX package:
//   edge_exchange_launch   <- go_libp2p_pubsub_tpu/ops/fused_round.py
//                              edge_exchange / _exchange_kernel
//   fused_delivery_launch  <- go_libp2p_pubsub_tpu/ops/fused_round.py
//                              fused_delivery / _delivery_kernel
//
// Banded topology: receiver j's edge k talks to sender (j + off[k]) mod N,
// which holds the edge in its slot rev[k]. The TPU kernels read that halo
// through three VMEM block views; here a banded roll is a static index
// offset and L2 serves the halo. `offrev` is a device int32 array [2K]:
// off[0..K) (each in [0, N)) then rev[0..K).
//
// What bounds them on the card: bytes. Both are pure word algebra (a few
// integer ops per loaded word), so the floor is the bytes each must move
// once over HBM at 3.35 TB/s — edge_exchange about 70 MB at N=100k, K=16,
// C=4 (about 21 us), fused_delivery about 134 MB with W=2 and the cohort
// planes (about 40 us). The simple design below does nothing clever about
// it: one thread per output element, neighbouring threads on neighbouring
// output words, the sender rows read strided (one 16-byte row of a
// neighbour per thread); a warp-per-peer layout with coalesced 128-byte
// rows is later work. Each launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kThreads = 256;
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

__global__ void edge_exchange_kernel(
    const uint32_t* __restrict__ wire,    // [N, K*C]
    const float* __restrict__ scores,     // [N, K] or null
    const uint32_t* __restrict__ live,    // [N, K]
    const int* __restrict__ offrev,       // [2K]
    uint32_t* __restrict__ wire_out,      // [N, K*C]
    float* __restrict__ score_out,        // [N, K] or null
    int n, int k, int c, int score_enabled) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)n * k * c;
  if (t >= total) return;
  int cc = (int)(t % c);
  long long jk = t / c;
  int kk = (int)(jk % k);
  int j = (int)(jk / k);
  int s = j + offrev[kk];
  if (s >= n) s -= n;
  int rk = offrev[k + kk];
  bool lv = live[jk] != 0u;
  uint32_t v = wire[(long long)s * k * c + (long long)rk * c + cc];
  wire_out[t] = lv ? v : 0u;
  if (score_enabled && cc == 0) {
    float sc = scores[(long long)s * k + rk];
    score_out[jk] = lv ? sc : 0.0f;
  }
}

__global__ void fused_delivery_kernel(
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
    int n, int k, int w, int score_enabled, int want_cohorts,
    int retrans_cap) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * w) return;
  int wi = (int)(t % w);
  int j = (int)(t / w);
  uint32_t have_j = have[t];
  uint32_t not_mine = ~origin[t];
  uint32_t joined_j = joined[t];
  float thr_gossip = thr[0];
  float thr_publish = thr[1];
  uint32_t acc_t = 0u, acc_e = 0u;
  // per-edge first-arrival words of the two cohorts, kept in registers
  uint32_t first_t[kMaxK];
  uint32_t first_e[kMaxK];
  long long row_kw = (long long)j * k * w;

#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) {
    if (kk < k) {
      int s = j + offrev[kk];
      if (s >= n) s -= n;
      int rk = offrev[k + kk];
      long long sp = (long long)s * w + wi;
      long long se = (long long)s * k * w + (long long)rk * w + wi;
      uint32_t fwd_s = fwd[sp];
      uint32_t mcw_s = mcw[sp];
      uint32_t carry_k = carry[se];
      uint32_t echo_k = fe[se];

      uint32_t f = flags[(long long)j * k + kk];
      bool live = bit(f, F_LIVE);
      uint32_t live_g = gate(live);
      uint32_t accmsg_g = gate(bit(f, F_ACC_MSG));
      uint32_t sfo_g = gate(bit(f, F_SENDER_FWD));
      float s_k = 0.0f;
      bool recv_ok = live;
      if (score_enabled) {
        s_k = nbrsc[(long long)j * k + kk];
        recv_ok = s_k >= thr_publish;
      }
      uint32_t flood = gate(bit(f, F_FLOOD_FROM)) |
                       (gate(bit(f, F_I_AM_FLOODSUB)) & gate(recv_ok));
      uint32_t emask = (carry_k | flood) & accmsg_g & joined_j;
      uint32_t t_k = fwd_s & ~echo_k & emask & live_g & sfo_g & not_mine;

      // IWANT service: what I asked edge k last round, served from the
      // neighbour's mcache window, capped per (edge, msg)
      long long e = row_kw + (long long)kk * w + wi;
      uint32_t asked_k = asked[e];
      uint32_t slo_k = slo[e];
      uint32_t shi_k = shi[e];
      uint32_t resp = asked_k & mcw_s &
                      ~served_capped(retrans_cap, slo_k, shi_k) & live_g;
      if (score_enabled) resp &= gate(s_k >= thr_gossip);
      uint32_t inc = resp & ~(shi_k & slo_k);
      slo_out[e] = slo_k ^ inc;
      shi_out[e] = shi_k | (slo_k & inc);

      uint32_t extra_k = resp & accmsg_g & sfo_g & not_mine;
      trans_out[e] = t_k | extra_k;
      if (want_cohorts) {
        mesh_t_out[e] = t_k;
        extra_out[e] = extra_k;
      }
      // mesh-push arrivals take precedence over IWANT responses; within
      // each cohort the lowest edge slot wins
      first_t[kk] = t_k & ~acc_t;
      acc_t |= t_k;
      first_e[kk] = extra_k & ~acc_e;
      acc_e |= extra_k;
    }
  }

  uint32_t new_t = acc_t & ~have_j;
  uint32_t new_e = acc_e & ~(have_j | new_t);
  uint32_t nw = new_t | new_e;
  new_out[t] = nw;
  have_out[t] = have_j | nw;
  fwd_out[t] = nw & valid[wi];

#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) {
    if (kk < k) {
      long long e = row_kw + (long long)kk * w + wi;
      fe_out[e] = (fe[e] & ~nw) | (first_t[kk] & new_t) | (first_e[kk] & new_e);
    }
  }
}

unsigned int blocks_for(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int edge_exchange_launch(
    const void* wire, const void* scores, const void* live, const void* offrev,
    void* wire_out, void* score_out, int n, int k, int c, int score_enabled,
    void* stream) {
  if (k > kMaxK || k <= 0 || c <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  long long total = (long long)n * k * c;
  edge_exchange_kernel<<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)wire, (const float*)scores, (const uint32_t*)live,
      (const int*)offrev, (uint32_t*)wire_out, (float*)score_out, n, k, c,
      score_enabled);
  return (int)cudaGetLastError();
}

extern "C" int fused_delivery_launch(
    const void* carry, const void* fe, const void* fwd, const void* mcw,
    const void* nbrsc, const void* asked, const void* slo, const void* shi,
    const void* flags, const void* have, const void* origin,
    const void* joined, const void* valid, const void* thr,
    const void* offrev, void* trans_out, void* fe_out, void* slo_out,
    void* shi_out, void* new_out, void* have_out, void* fwd_out,
    void* mesh_t_out, void* extra_out, int n, int k, int w,
    int score_enabled, int want_cohorts, int retrans_cap, void* stream) {
  if (k > kMaxK || k <= 0 || w <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  int cap = retrans_cap < 0 ? 0 : (retrans_cap > 3 ? 3 : retrans_cap);
  long long total = (long long)n * w;
  fused_delivery_kernel<<<blocks_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)carry, (const uint32_t*)fe, (const uint32_t*)fwd,
      (const uint32_t*)mcw, (const float*)nbrsc, (const uint32_t*)asked,
      (const uint32_t*)slo, (const uint32_t*)shi, (const uint32_t*)flags,
      (const uint32_t*)have, (const uint32_t*)origin,
      (const uint32_t*)joined, (const uint32_t*)valid, (const float*)thr,
      (const int*)offrev, (uint32_t*)trans_out, (uint32_t*)fe_out,
      (uint32_t*)slo_out, (uint32_t*)shi_out, (uint32_t*)new_out,
      (uint32_t*)have_out, (uint32_t*)fwd_out, (uint32_t*)mesh_t_out,
      (uint32_t*)extra_out, n, k, w, score_enabled, want_cohorts, cap);
  return (int)cudaGetLastError();
}
