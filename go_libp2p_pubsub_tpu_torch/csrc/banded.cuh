// The layout the two banded-topology kernels share on Hopper (sm_90a):
// fused_delivery (fused_round.cu) and delivery_banded (delivery.cu).
//
// Banded topology: receiver j's edge k talks to sender (j + off[k]) mod N,
// which holds the edge in its slot rev[k]. `offrev` is a device int32 array
// [2K]: off[0..K) (each in [0, N)) then rev[0..K). A per-edge plane is
// [N, K, W] 32-bit words (W words a row of messages), a per-peer plane
// [N, W].
//
// A block owns `rows` consecutive peers and `wb` consecutive words of them
// (grid.y takes the W words wb at a time; at the bench's W=2 one block
// holds whole rows). Lanes work in units: a unit is one peer row's epc
// edges x wg words, lane = (edge, word), so the warp's loads and stores of a
// [N, K, W] plane are neighbouring lanes on neighbouring words (at K=16,
// W=2 one unit is a warp and one 128-byte row). The OR over a row's edges
// is a shuffle scan over the lanes of one word (stride wg); the exclusive
// prefix of that scan lets the lowest edge win each first arrival. K above
// one chunk (epc edges) is taken in chunks with a carry between them.
//
// The sender words are read from shared memory: the block stages the
// sender rows it needs, [r0 + lo, r0 + rows + hi) mod N, where [lo, hi]
// spans the signed offsets within the block's halo, with coalesced 16-byte
// loads. The receivers' own rows lie inside that window (lo <= 0 <= hi),
// so a staged plane also serves the own-row reads of the same plane. An
// edge whose offset lies beyond the halo (a circulant with an offset near
// N/2, say) reads its sender words from global memory instead, in the same
// kernel. Every block computes its window from offrev itself, so the host
// never reads the offsets.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace banded {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;          // rows a block
constexpr int kMaxBlockWords = 8;     // words a block
constexpr int kSmemBytes = 48 * 1024; // dynamic shared memory without an opt-in
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  int n, k, w;       // peers, edges a peer, words a row
  int wb;            // words a block
  int wg;            // words a unit
  int epc;           // edges a chunk of a unit
  int nch;           // chunks a row: ceil(K / epc)
  int lanes;         // lanes a unit: epc * wg
  int upw;           // units a warp: 32 / lanes
  int rows;          // rows a block
  int halo;          // the widest |offset| a block stages
  int stage_rows;    // rows a staging buffer holds: rows + 2 * halo
  int smem_bytes;    // dynamic shared memory a block takes
};

// The layout of a launch whose block stages `staged` words a sender row
// and keeps `own` words an own row, each per block word. Rows halve (down
// to 16) and then words halve until the block fits kSmemBytes; rows == 0
// when nothing fits.
inline Layout make_layout(int n, int k, int w, int staged, int own) {
  Layout L{};
  L.n = n;
  L.k = k;
  L.w = w;
  int wb = w < kMaxBlockWords ? w : kMaxBlockWords;
  int rows = kMaxRows;
  auto bytes = [&](int r, int b) {
    return ((long long)(r + 2 * (r / 2)) * staged + (long long)r * own) * b * 4;
  };
  while (bytes(rows, wb) > kSmemBytes) {
    if (rows > 16) rows /= 2;
    else if (wb > 1) wb = (wb + 1) / 2;
    else if (rows > 1) rows /= 2;
    else return L;   // rows == 0: nothing fits
  }
  L.wb = wb;
  L.rows = rows;
  L.halo = rows / 2;
  L.stage_rows = rows + 2 * L.halo;
  L.smem_bytes = (int)bytes(rows, wb);
  const int per = k < 32 ? 32 / k : 1;
  L.wg = wb < per ? wb : per;
  L.epc = k < 32 / L.wg ? k : 32 / L.wg;
  L.nch = (k + L.epc - 1) / L.epc;
  L.lanes = L.epc * L.wg;
  L.upw = 32 / L.lanes;
  return L;
}

__device__ __forceinline__ long long wrap(long long x, int n) {
  x %= n;
  return x < 0 ? x + n : x;
}

// the ring offset off in [0, N) as a signed step (the JAX package's rule)
__device__ __forceinline__ int signed_offset(int off, int n) {
  return off <= n / 2 ? off : off - n;
}

// One edge slot as a lane sees it: its ring offset, the sender's reverse
// slot, and whether the sender row is staged (|signed offset| <= halo).
struct Edge {
  int off, so, rev;
  bool near;
};

__device__ __forceinline__ Edge edge_of(const int* __restrict__ offrev, int k, int nk,
                                        int n, int halo) {
  Edge e{0, 0, 0, true};
  if (k < nk) {
    e.off = offrev[k];
    e.rev = offrev[nk + k];
    e.so = signed_offset(e.off, n);
    e.near = e.so >= -halo && e.so <= halo;
  }
  return e;
}

// The staging window [lo, hi] (lo <= 0 <= hi): the span of the signed
// offsets within the halo. Every warp computes it for itself.
__device__ __forceinline__ void window(const int* __restrict__ offrev, int k, int n,
                                       int halo, int& lo, int& hi) {
  int a = 0, b = 0;
  for (int i = threadIdx.x & 31; i < k; i += 32) {
    const int so = signed_offset(offrev[i], n);
    if (so >= -halo && so <= halo) {
      a = so < a ? so : a;
      b = so > b ? so : b;
    }
  }
  lo = __reduce_min_sync(kFull, a);
  hi = __reduce_max_sync(kFull, b);
}

// dst[0, cnt) = src[0, cnt) by the block, as 16-byte vectors where both
// addresses allow (plain loads: the read-only path measured slower here for
// fused_delivery's four staged planes)
__device__ __forceinline__ void block_copy(uint32_t* dst, const uint32_t* __restrict__ src,
                                           long long cnt) {
  long long done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15u) == 0u) {
    const long long nv = cnt >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < nv; i += kThreads) d4[i] = s4[i];
    done = nv << 2;
  }
  for (long long i = done + threadIdx.x; i < cnt; i += kThreads) dst[i] = src[i];
}

// Rows [a, a + cnt) (mod N) of an [N, E, W] plane, words [w0, w0 + wb) of
// each of a row's E groups, into dst[(row * E + e) * wb + word]. Whole rows
// (wb == W) are contiguous runs between the wraps.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* __restrict__ src,
                                      long long a, int cnt, int n, int e, int w, int w0,
                                      int wb) {
  if (wb == w) {
    const long long row = (long long)e * w;
    int i = 0;
    while (i < cnt) {
      const long long g = wrap(a + i, n);
      const int len = (long long)(cnt - i) < n - g ? cnt - i : (int)(n - g);
      block_copy(dst + i * row, src + g * row, len * row);
      i += len;
    }
    return;
  }
  const int per = e * wb;
  for (int x = threadIdx.x; x < cnt * per; x += kThreads) {
    const int r = x / per, rem = x - r * per;
    const int ei = rem / wb, wi = rem - ei * wb;
    dst[x] = src[(wrap(a + r, n) * e + ei) * w + w0 + wi];
  }
}

// A lane's place: unit `unit` of its warp (unit == upw: no unit), edge ke
// of a chunk and word wi of a group; `last` is the lane of the chunk's last
// edge at the same word.
struct Lane {
  int unit, ke, wi, last;
  bool on;
};

__device__ __forceinline__ Lane lane_of(const Layout& L) {
  Lane p;
  const int lane = threadIdx.x & 31;
  p.unit = lane / L.lanes;
  const int ul = lane - p.unit * L.lanes;
  p.ke = ul / L.wg;
  p.wi = ul - p.ke * L.wg;
  p.on = p.unit < L.upw;
  p.last = (p.unit * L.lanes + (L.epc - 1) * L.wg + p.wi) & 31;
  return p;
}

// inclusive OR of v over the edges of a unit's word, in edge order
__device__ __forceinline__ uint32_t scan_or(uint32_t v, const Lane& p, const Layout& L) {
  for (int d = 1; d < L.epc; d <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, d * L.wg);
    if (p.ke >= d) v |= u;
  }
  return v;
}

// the same scan shifted one edge: the OR of the unit's earlier edges
__device__ __forceinline__ uint32_t exclusive(uint32_t inc, const Lane& p, const Layout& L) {
  const uint32_t u = __shfl_up_sync(kFull, inc, L.wg);
  return p.ke > 0 ? u : 0u;
}

}  // namespace banded
