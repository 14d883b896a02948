// Hopper (sm_90a) kernel of the heartbeat's peer selection, with a plain C
// interface (bound from Python through ctypes by
// go_libp2p_pubsub_tpu_torch/ops/select_topk.py).
//
// It replaces the TPU Pallas kernel of the JAX package:
//   select_topk_sims <- go_libp2p_pubsub_tpu/ops/pallas_csr.py
//                          select_topk_pallas / _topk_kernel
//
// Per row r of [R, K] (R = N*S peer-topic slots, K the padded neighbor axis):
//   p[i]    = mask[r, i] ? values[r, i] : -inf
//   rank[i] = #{ j : p[j] > p[i]
//                    or (p[j] == p[i] and noise[j] > noise[i])
//                    or (p[j] == p[i] and noise[j] == noise[i] and j < i) }
//   out[r, i] = rank[i] < k_rows[r]  and  mask[r, i]
// i.e. the (up to) k_rows[r] masked slots first in the strict (value, noise,
// index)-descending order. The kernel equals the plain pairwise form bit for
// bit on any input, because it keeps the meaning of its IEEE compares:
// -0.0 == +0.0; a subnormal value or noise ranks as a zero of its sign (the
// plain version flushes them, as XLA on the CPU and a TPU do, so 1e-45 ties
// with 0.0; flushed here in the code, not by a compiler flag); a masked NaN
// value (or NaN noise at a tie) compares false both ways, so a masked NaN
// slot has rank 0 and outranks nothing.
//
// What bounds it on the card: bytes. It must read 10 bytes a slot (value
// and noise f32, mask byte) and 4 a row, and write one byte a slot: at
// R=100k that is 16.4 MB at K=16 (about 5 us at 3.35 TB/s) and 64.4 MB at
// K=64 (about 19 us). Sorting each row, the least work, is R*K*log2(K)
// compares, well under the bytes time at the non-tensor rate.
//
// The design: a row belongs to a group of P lanes (4 slots a lane for K a
// power of two up to 32, so 8 rows share a warp at K=16; a warp of 32 lanes
// above, 2 slots a lane at K=64). A lane's slots are loaded as one vector of
// values, one of noise and one word of mask bytes where the pointers allow
// (neighbouring lanes on neighbouring addresses), and its output bytes are
// stored the same way. Most rows are decided without ranking: a ballot
// counts the row's masked slots c; k_rows <= 0 selects nothing and
// k_rows >= c selects every masked slot, since an unmasked slot (-inf)
// never outranks a masked one. That covers the padding-heavy rows of a
// sparse graph (about 5 live slots of 64 on the power-law net) and most
// heartbeat selections. The other rows rank among their masked slots only:
// the ballot compacts them into a per-row list in shared memory, so a slot
// counts its outrankers over c entries instead of K. An entry is the slot's
// 96-bit key (order key of the value, of the noise, ~index), in which the
// pairwise order is plain unsigned order; a compare is one subtract chain.
// A row holding a NaN has no such key and takes the float compares
// themselves. The trap is a masked slot whose value is -inf: it ties with
// every unmasked slot, which then outranks it on noise or index, so such a
// row (one ballot finds it) takes a list of all K slots — the pairwise
// count itself. Any K up to 256; above, cudaErrorInvalidValue.
//
// The sim axis (sims.cuh): select_topk_sims runs S simulations in one
// launch, as S*R rows of the one-sim launch when every tensor is batched,
// else with sim z on grid.y and each pointer moved by its sim stride. The
// one-sim entry point is the S = 1 call. Each launch returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "fnum.cuh"
#include "sims.cuh"

namespace {

using fnum::flush_subnormal;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 256;
constexpr unsigned kFull = 0xffffffffu;

// An unsigned key in the order of a float's IEEE compares with subnormals
// flushed, for any float but NaN: -0.0, +0.0 and every subnormal share the
// key of zero.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7f800000u) == 0u) return 0x80000000u;   // +-0 and every subnormal: zero's key
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// n += 1 unless the 96-bit key (x, y, z) of entry e is above slot i's: the
// carry out of key_i - key_e (one subtract chain, set when nothing is
// borrowed) added with the carry. The loop below turns the count of
// entries at or below a slot into the count above it.
__device__ __forceinline__ void count_at_or_below(int& n, const uint4& i, const uint4& e) {
#if defined(__CUDA_ARCH__)
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %4;\n\t"
      "subc.cc.u32 t, %2, %5;\n\t"
      "subc.cc.u32 t, %3, %6;\n\t"
      "addc.u32 %0, %0, 0;\n\t}"
      : "+r"(n)
      : "r"(i.z), "r"(i.y), "r"(i.x), "r"(e.z), "r"(e.y), "r"(e.x));
#else
  const uint64_t a = ((uint64_t)i.x << 32) | i.y, b = ((uint64_t)e.x << 32) | e.y;
  n += !((b > a) || (b == a && e.z > i.z));
#endif
}

// P lanes a row, S slots a lane (K <= P*S). VEC: K == P*S and lane g holds
// slots [g*S, g*S + S), loaded and stored as vectors (S = 2, 4 or 8);
// otherwise slot s*P + g, one element a load.
// kSims: sim blockIdx.y of a batched launch, its pointers moved by the
// strides (in elements: values, mask, k_rows, noise, out).
template <int P, int S, bool VEC, bool kSims>
__global__ void __launch_bounds__(kThreads) select_topk_kernel(
    const float* __restrict__ values,    // [R, K]
    const uint8_t* __restrict__ mask,    // [R, K] bool
    const int* __restrict__ k_rows,      // [R]
    const float* __restrict__ noise,     // [R, K]
    uint8_t* __restrict__ out,           // [R, K] bool
    int r, int k, const sims::Strides<kSims> ss) {
  if constexpr (kSims) {
    const long long z = blockIdx.y;
    values = sims::at(values, ss.e[0], z);
    mask = sims::at(mask, ss.e[1], z);
    k_rows = sims::at(k_rows, ss.e[2], z);
    noise = sims::at(noise, ss.e[3], z);
    out = sims::at(out, ss.e[4], z);
  }
  constexpr int kGroups = 32 / P;      // rows a warp
  constexpr int kStride = P * S + 1;   // list entries a row; +1 keeps rows on other banks
  __shared__ uint4 list[kWarps][kGroups * kStride];   // one 16-byte entry a slot
  static_assert(32 % P == 0 && S * P <= kMaxK, "bad shape");
  const float neg_inf = __int_as_float(0xff800000);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / P;
  const int g = lane - grp * P;
  const long long row = ((long long)blockIdx.x * kWarps + warp) * kGroups + grp;
  const bool live = row < r;
  const unsigned gmask = P == 32 ? kFull : ((1u << P) - 1u) << (grp * P);
  const long long off = row * k;

  int slot[S];
  float v[S], q[S];
  bool mk[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    slot[s] = VEC ? g * S + s : s * P + g;
    v[s] = 0.0f;
    q[s] = 0.0f;
    mk[s] = false;
  }
  if (live) {
    if constexpr (VEC && S == 2) {
      const float2 a = *reinterpret_cast<const float2*>(values + off + g * 2);
      const float2 b = *reinterpret_cast<const float2*>(noise + off + g * 2);
      const uint32_t mw = *reinterpret_cast<const uint16_t*>(mask + off + g * 2);
      v[0] = a.x; v[1] = a.y;
      q[0] = b.x; q[1] = b.y;
      mk[0] = (mw & 0xffu) != 0u;
      mk[1] = (mw >> 8) != 0u;
    } else if constexpr (VEC) {
#pragma unroll
      for (int h = 0; h < S / 4; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(values + off + g * S + 4 * h);
        const float4 b = *reinterpret_cast<const float4*>(noise + off + g * S + 4 * h);
        const uint32_t mw = *reinterpret_cast<const uint32_t*>(mask + off + g * S + 4 * h);
        v[4 * h] = a.x; v[4 * h + 1] = a.y; v[4 * h + 2] = a.z; v[4 * h + 3] = a.w;
        q[4 * h] = b.x; q[4 * h + 1] = b.y; q[4 * h + 2] = b.z; q[4 * h + 3] = b.w;
#pragma unroll
        for (int t = 0; t < 4; ++t) mk[4 * h + t] = ((mw >> (8 * t)) & 0xffu) != 0u;
      }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (slot[s] < k) {
          v[s] = values[off + slot[s]];
          q[s] = noise[off + slot[s]];
          mk[s] = mask[off + slot[s]] != 0;
        }
      }
    }
  }
  float p[S];
#pragma unroll
  for (int s = 0; s < S; ++s) p[s] = mk[s] ? v[s] : neg_inf;

  // one ballot per slot column: the row's masked slots and the -inf hazard
  unsigned bal[S];
  int c = 0;
  bool my_hazard = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    bal[s] = __ballot_sync(kFull, mk[s]) & gmask;
    c += __popc(bal[s]);
    my_hazard |= mk[s] && p[s] == neg_inf;
  }
  const bool hazard = (__ballot_sync(kFull, my_hazard) & gmask) != 0u;
  const int kr = live ? k_rows[row] : 0;

  bool sel[S];
  if (kr <= 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) sel[s] = false;
  } else if (!hazard && kr >= c) {
#pragma unroll
    for (int s = 0; s < S; ++s) sel[s] = mk[s];
  } else {
    // the slots that can outrank a masked slot, as a list: the masked ones,
    // or all K when a masked slot is -inf. Without a NaN an entry is the
    // slot's 96-bit key (value, noise, ~index), which orders the slots
    // exactly as the pairwise compares do; a row with a NaN keeps the
    // floats and takes the compares themselves.
    bool my_nan = false;
#pragma unroll
    for (int s = 0; s < S; ++s) my_nan |= slot[s] < k && (q[s] != q[s] || (mk[s] && v[s] != v[s]));
    const bool nan_row = (__ballot_sync(gmask, my_nan) & gmask) != 0u;
    // a NaN row compares the floats with subnormals flushed, as order_key
    // ranks them (the rows decided by the ballot above never rank)
    if (nan_row) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        p[s] = flush_subnormal(p[s]);
        q[s] = flush_subnormal(q[s]);
      }
    }
    uint4 mine[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      mine[s] = nan_row ? make_uint4(__float_as_uint(p[s]), __float_as_uint(q[s]), slot[s], 0u)
                        : make_uint4(order_key(p[s]), order_key(q[s]), ~(uint32_t)slot[s], 0u);
    uint4* lst = &list[warp][grp * kStride];
    int len;
    if (hazard) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (slot[s] < k) lst[slot[s]] = mine[s];
      len = k;
    } else {
      const unsigned below = (1u << lane) - 1u;
      int base = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (mk[s]) lst[base + __popc(bal[s] & below)] = mine[s];
        base += __popc(bal[s]);
      }
      len = c;
    }
    __syncwarp(gmask);
    int rank[S];
#pragma unroll
    for (int s = 0; s < S; ++s) rank[s] = 0;
    if (!nan_row) {
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const uint4 e = lst[j];
#pragma unroll
        for (int s = 0; s < S; ++s) count_at_or_below(rank[s], mine[s], e);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) rank[s] = len - rank[s];
    } else {
      for (int j = 0; j < len; ++j) {
        const uint4 e = lst[j];
        const float pj = __uint_as_float(e.x);
        const float nj = __uint_as_float(e.y);
        const int ij = (int)e.z;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const bool ties = pj == p[s];
          rank[s] += (pj > p[s]) || (ties && nj > q[s]) || (ties && nj == q[s] && ij < slot[s]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) sel[s] = mk[s] && rank[s] < kr;
  }

  if (!live) return;
  if constexpr (VEC && S == 2) {
    *reinterpret_cast<uint16_t*>(out + off + g * 2) =
        (uint16_t)((uint32_t)sel[0] | ((uint32_t)sel[1] << 8));
  } else if constexpr (VEC) {
#pragma unroll
    for (int h = 0; h < S / 4; ++h) {
      uint32_t ow = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) ow |= (uint32_t)sel[4 * h + t] << (8 * t);
      *reinterpret_cast<uint32_t*>(out + off + g * S + 4 * h) = ow;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (slot[s] < k) out[off + slot[s]] = sel[s] ? 1 : 0;
  }
}

template <int P, int S, bool VEC>
int launch(const void* values, const void* mask, const void* k_rows,
           const void* noise, void* out, int r, int k, int s, const sims::Batched& ss,
           cudaStream_t stream) {
  constexpr int rows_pb = kWarps * (32 / P);
  const unsigned int blocks = (unsigned int)((r + rows_pb - 1) / rows_pb);
  if (s == 1)
    select_topk_kernel<P, S, VEC, false><<<blocks, kThreads, 0, stream>>>(
        (const float*)values, (const uint8_t*)mask, (const int*)k_rows,
        (const float*)noise, (uint8_t*)out, r, k, sims::Strides<false>{});
  else
    select_topk_kernel<P, S, VEC, true><<<dim3(blocks, (unsigned)s), kThreads, 0, stream>>>(
        (const float*)values, (const uint8_t*)mask, (const int*)k_rows,
        (const float*)noise, (uint8_t*)out, r, k, ss);
  return (int)cudaGetLastError();
}

// K a power of two from 4 to 256 (the layouts of the switch below), vector
// loads when the pointers allow them
template <int P, int S>
int launch_pow2(bool vec, const void* values, const void* mask,
                const void* k_rows, const void* noise, void* out, int r, int k, int s,
                const sims::Batched& ss, cudaStream_t stream) {
  return vec ? launch<P, S, true>(values, mask, k_rows, noise, out, r, k, s, ss, stream)
             : launch<P, S, false>(values, mask, k_rows, noise, out, r, k, s, ss, stream);
}

int dispatch(const void* values, const void* mask, const void* k_rows, const void* noise,
             void* out, int r, int k, int s, const sims::Batched& ss, cudaStream_t st) {
  // 16-byte vectors of values and noise, 4-byte words of mask and out, in
  // every sim
  const bool vec = ((uintptr_t)values % 16 == 0) && ((uintptr_t)noise % 16 == 0) &&
                   ((uintptr_t)mask % 4 == 0) && ((uintptr_t)out % 4 == 0) &&
                   (s == 1 || (ss.e[0] % 4 == 0 && ss.e[3] % 4 == 0 && ss.e[1] % 4 == 0 &&
                               ss.e[4] % 4 == 0));
#define ARGS values, mask, k_rows, noise, out, r, k, s, ss, st
  switch (k) {
    case 4: return launch_pow2<1, 4>(vec, ARGS);
    case 8: return launch_pow2<2, 4>(vec, ARGS);
    case 16: return launch_pow2<4, 4>(vec, ARGS);
    case 32: return launch_pow2<8, 4>(vec, ARGS);
    case 64: return launch_pow2<32, 2>(vec, ARGS);
    case 128: return launch_pow2<32, 4>(vec, ARGS);
    case 256: return launch_pow2<32, 8>(vec, ARGS);
    default: break;
  }
  // any other K: one slot a lane up to 32 (the row's group the next power
  // of two), S = ceil(K/32) slots a lane of a whole warp above
  if (k <= 1) return launch<1, 1, false>(ARGS);
  if (k <= 2) return launch<2, 1, false>(ARGS);
  if (k <= 4) return launch<4, 1, false>(ARGS);
  if (k <= 8) return launch<8, 1, false>(ARGS);
  if (k <= 16) return launch<16, 1, false>(ARGS);
  if (k <= 32) return launch<32, 1, false>(ARGS);
  switch ((k + 31) / 32) {
    case 2: return launch<32, 2, false>(ARGS);
    case 3: return launch<32, 3, false>(ARGS);
    case 4: return launch<32, 4, false>(ARGS);
    case 5: return launch<32, 5, false>(ARGS);
    case 6: return launch<32, 6, false>(ARGS);
    case 7: return launch<32, 7, false>(ARGS);
    default: return launch<32, 8, false>(ARGS);
  }
#undef ARGS
}

}  // namespace

// select_topk over S sims of R rows each: the strides of its 5 pointers
// (values, mask, k_rows, noise, out). Rows are independent, so when every
// tensor is batched with its natural stride the S sims are S*R rows of the
// one-sim launch (4.5% faster than grid.y at S=8, R=100k, K=16 on an H100:
// chip_smoke.py phase 44 (b)); otherwise (a shared k_rows, say) sim z takes
// grid.y.
extern "C" int select_topk_sims(const void* values, const void* mask,
                                const void* k_rows, const void* noise,
                                void* out, int r, int k, int s,
                                const long long* strides, void* stream) {
  if (r <= 0 || k <= 0 || k > kMaxK || s <= 0 || s > 65535) return (int)cudaErrorInvalidValue;
  const sims::Batched ss = sims::load(strides, 5);
  const long long rk = (long long)r * k;
  if (s > 1 && ss.e[0] == rk && ss.e[1] == rk && ss.e[2] == r && ss.e[3] == rk &&
      ss.e[4] == rk && rk * s < (1LL << 31))
    return dispatch(values, mask, k_rows, noise, out, r * s, k, 1, ss, (cudaStream_t)stream);
  return dispatch(values, mask, k_rows, noise, out, r, k, s, ss, (cudaStream_t)stream);
}

