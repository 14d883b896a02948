// The sim axis every kernel of the port takes (the ensemble plane,
// go_libp2p_pubsub_tpu_torch/ensemble/): one launch runs S independent
// simulations over a grid with a sim dimension.
//
// Each `*_sims` entry point takes S and a host array of sim strides, one a
// pointer argument in the order of its pointers, in elements of that
// argument: sim z reads and writes its tensor at `p + z * stride`. A
// stride of 0 shares the tensor among the sims (a topology constant, a
// threshold row, an argument the vmap left unbatched); a null strides array
// shares every tensor. At S == 1 an entry point launches the one-sim
// instantiation of its kernel (kSims false), whose code takes no sim
// offset at all: a one-sim launch is `*_sims` with S = 1 and null strides.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sims {

constexpr int kMaxArgs = 24;   // fused_delivery's 24 pointers, the most

// A batched launch's strides; the one-sim instantiation takes an empty
// struct, so its parameters are the ones it took before the sim axis.
template <bool kSims>
struct Strides {
  long long e[kMaxArgs];
};
template <>
struct Strides<false> {};
using Batched = Strides<true>;

// The strides array of an entry point's `n` pointers (null: all shared).
inline Batched load(const long long* host, int n) {
  Batched st{};
  for (int i = 0; host != nullptr && i < n && i < kMaxArgs; ++i) st.e[i] = host[i];
  return st;
}

// p moved to sim z's tensor (unchanged when the stride is 0, a null
// pointer included)
template <typename T>
__device__ __forceinline__ T* at(T* p, long long stride, long long z) {
  return stride != 0 ? p + z * stride : p;
}

}  // namespace sims
