"""float32 subnormals as the JAX package's platforms treat them.

XLA on the CPU and a TPU flush every subnormal float32 result of arithmetic
to a zero of its sign and read every subnormal operand as zero: under
``jax.jit`` on XLA:CPU ``-1e-30 * 1e-10`` is -0.0, ``1.5e-38 - 1.6e-38``
is -0.0, ``-1e-45 >= 0.0`` is True, and a sum reduction flushes each
partial sum in index order. A select (``where``) passes its operand's bits
unchanged. Torch keeps subnormals, on the CPU and on the card alike, so
the port flushes the results of its float arithmetic itself, the same way
on both: ``flush_subnormals`` on tensors, ``flush_f32`` on constants once,
where they are built. Whatever only moves or selects float bits (the edge
exchange, ``where``, sorts) is left as it is.

XLA:CPU also contracts a multiply into the add that consumes it, inside
one fused loop, to a fused multiply-add: one rounding where the written
order has two. ``fma_f32`` computes that exactly, and the score path uses
it where the JAX package's compiled score loop fuses (``score/engine.py``).

``bitcast`` reinterprets a tensor's bits as another dtype of the same
width, also on a tensor ``torch.func.vmap`` batched (the ensemble plane),
which some PyTorch releases refuse for ``view(dtype)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TINY = float(np.finfo(np.float32).tiny)
#: the largest float32 subnormal: ``hardshrink`` zeroes what lies within it
_LARGEST_SUBNORMAL = float(np.nextafter(np.float32(TINY), np.float32(0.0)))


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with every subnormal replaced by a zero of its sign;
    normal values, zeros, infinities and NaN keep their bits. Two launches:
    ``hardshrink`` zeroes every value within the largest subnormal, and
    ``copysign`` gives each zero back the sign of ``x``."""
    return torch.copysign(x.hardshrink(_LARGEST_SUBNORMAL), x)


def flush_f32(v):
    """A float constant, or a float32 numpy array, as XLA reads it: a value
    whose float32 is subnormal becomes a zero of its sign; any other value
    is returned as it is."""
    if isinstance(v, np.ndarray):
        return np.where(np.abs(v) < TINY, np.copysign(np.float32(0.0), v), v).astype(v.dtype)
    f = abs(float(np.float32(v)))
    return math.copysign(0.0, v) if 0.0 < f < TINY else v


def fma_f32(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, the float64 sum is made round-to-odd from
    its exact error (so its rounding to float32 is the single correct
    rounding), then rounded to float32. ``b`` may be a Python float, which
    is read as its float32 value and stays on the host (no copy to the
    device). Subnormal results are left for the caller's flush."""
    if isinstance(b, torch.Tensor):
        a, b, c = torch.broadcast_tensors(a, b, c)
        p = a.double() * b.double()
    else:
        a, c = torch.broadcast_tensors(a, c)
        p = a.double() * float(np.float32(b))
    c64 = c.double()
    s = p + c64
    t = s - p
    err = (p - (s - t)) + (c64 - t)          # s + err == p + c exactly
    even = (bitcast(s, torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


class _Bitcast(torch.autograd.Function):
    """``x.view(dtype)`` with a batching rule: the bits of a batched tensor
    reinterpreted in place of its batch dimension, which stays where it is
    (the dtypes have one width, so no dimension changes)."""

    @staticmethod
    def forward(x, dtype):
        return x.view(dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, dtype):
        return x.view(dtype), in_dims[0]


def bitcast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x``'s bits as ``dtype``, which has the same element width: a plain
    ``view(dtype)``, through a batching rule when vmap batched ``x``."""
    if x.element_size() != dtype.itemsize:
        raise ValueError(f"bitcast: {x.dtype} and {dtype} differ in width")
    if torch._C._functorch.is_batchedtensor(x):
        return _Bitcast.apply(x, dtype)
    return x.view(dtype)
