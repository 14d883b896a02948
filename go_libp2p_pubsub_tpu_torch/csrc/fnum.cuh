// float32 subnormals as the JAX package's platforms treat them (the port's
// ops/fnum.py): XLA on the CPU and a TPU read a subnormal operand as a zero
// of its sign. The kernels flush in code, not by a compiler flag, so their
// other float work keeps IEEE semantics.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fnum {

// A float32 subnormal as a zero of its sign; any other float as it is.
__device__ __forceinline__ float flush_subnormal(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x7f800000u) == 0u ? __uint_as_float(u & 0x80000000u) : f;
}

// a >= b with a subnormal operand read as a zero of its sign: one PTX
// compare with .ftz, which flushes its inputs in the same instruction
__device__ __forceinline__ bool ge_ftz(float a, float b) {
#if defined(__CUDA_ARCH__)
  unsigned r;
  asm("{\n\t.reg .pred p;\n\tsetp.ge.ftz.f32 p, %1, %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "f"(a), "f"(b));
  return r != 0u;
#else
  return flush_subnormal(a) >= flush_subnormal(b);
#endif
}

}  // namespace fnum
