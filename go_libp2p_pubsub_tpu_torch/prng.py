"""Threefry-2x32 counter-based PRNG, bit-equal to ``jax.random``'s default
implementation with ``jax_threefry_partitionable=True``.

The JAX engine's only random draws on the per-round step are the heartbeat
selections (``fold_in(key, tick)`` then ``split(key, 6)`` then uniform
noise planes), so carrying the same generator lets the port be held against
the reference bit for bit, heartbeat included.

A key is an int64 tensor of shape ``[2]`` holding two u32 words (the
``key_data`` view). All arithmetic runs in int64 masked to 32 bits, which
is exact on every device and never relies on unsigned tensor support.
"""

from __future__ import annotations

import torch

from .ops.fnum import bitcast

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round Threefry-2x32 block on broadcastable int64 words in
    [0, 2^32): returns the two output words (jax's ``threefry2x32_p``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``: the 32-bit seed fills the low word."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The two u32 words of a key (int64 tensor ``[2]``)."""
    return k


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the scalar ``data`` (a Python int or a
    0-dim integer tensor, read as u32) into the key."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=k.device, dtype=torch.int64).reshape(()) & _M32
    else:
        # a fill on the key's device, not a copy from the host
        d = torch.full((), int(data) & _M32, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.stack([y0, y1])


def _counter_bits(k: torch.Tensor, n: int):
    lo = torch.arange(n, dtype=torch.int64, device=k.device)
    return threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)


def split(k: torch.Tensor, num: int = 2) -> list[torch.Tensor]:
    """``jax.random.split`` (the partitionable fold-like form): key i is
    the block of counter (0, i)."""
    b1, b2 = _counter_bits(k, num)
    return list(torch.stack([b1, b2], dim=-1).unbind(0))


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)): the block of the
    row-major flat index, its two words XORed."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    b1, b2 = _counter_bits(k, n)
    return (b1 ^ b2).reshape(shape)


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) float32: the top 23 bits
    as the mantissa of a float in [1, 2), minus one."""
    bits = random_bits(k, shape)
    f = bitcast(((bits >> 9) | 0x3F800000).to(torch.int32), torch.float32)
    return f - 1.0


def fold_in_rows(k: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` over rows at once: ``k`` one key ``[2]`` or R keys
    ``[R, 2]``, ``data`` an integer tensor ``[R]`` or one Python int.
    Returns the R keys ``[R, 2]``, row i equal to ``fold_in(k_i, data_i)``."""
    k = k.reshape(-1, 2)
    if isinstance(data, torch.Tensor):
        d = data.to(device=k.device, dtype=torch.int64).reshape(-1) & _M32
    else:
        d = torch.full((k.shape[0],), int(data) & _M32, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[:, 0], k[:, 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def uniform_rows(keys: torch.Tensor, shape) -> torch.Tensor:
    """``[R, *shape]``: row i is ``uniform(keys[i], shape)``, all rows in
    one pass."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    bits = (b1 ^ b2).reshape((keys.shape[0],) + shape)
    f = bitcast(((bits >> 9) | 0x3F800000).to(torch.int32), torch.float32)
    return f - 1.0
