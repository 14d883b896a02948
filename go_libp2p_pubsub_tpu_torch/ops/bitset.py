"""Packed-bitset algebra over 32-bit words.

Message sets (seen-cache, mcache windows, per-edge transmit sets) are bool
vectors over the M message slots, packed 32 per word so the delivery plane
is word-wide AND/OR traffic.

Words are stored as ``torch.int32`` with the same bit patterns as the JAX
package's ``uint32`` planes: torch has no ``~``, ``>>``, ``<<`` or ``max``
for ``uint32`` on every device. A right shift of an int32 word is
arithmetic, so every logical shift below either masks after the shift or
runs in int64. All functions treat the *last* axis as the word axis.
"""

from __future__ import annotations

import torch

WORD = 32
_M32 = 0xFFFFFFFF
ALL = -1  # the all-ones word as int32


def n_words(n_bits: int) -> int:
    return (n_bits + WORD - 1) // WORD


def to_word(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    x = x & _M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int64, device=device)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., M] -> int32[..., ceil(M/32)] (bit i of word w = slot 32w+i)."""
    m = bits.shape[-1]
    w = n_words(m)
    pad = w * WORD - m
    if pad:
        bits = torch.cat(
            [bits, bits.new_zeros(bits.shape[:-1] + (pad,))], dim=-1)
    b = bits.reshape(bits.shape[:-1] + (w, WORD)).to(torch.int64)
    return to_word((b << _shifts(bits.device)).sum(-1))


def unpack(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int32[..., W] -> bool[..., n_bits]."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    return bits[..., :n_bits].bool()


def take_word(words: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """words[..., W], w int[...] -> words[..., w]; 0 where w is outside
    [0, W) (a one-hot sum, as the JAX package computes it)."""
    w_dim = words.shape[-1]
    onehot = torch.arange(w_dim, device=words.device) == w[..., None]
    return torch.where(onehot, words, torch.zeros((), dtype=words.dtype,
                                                  device=words.device)
                       ).sum(-1, dtype=words.dtype)


def bit_get(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather single bits: words int32[..., W], idx int[...] -> bool[...]
    (floor division and Python-style modulo, as ``jnp`` computes them)."""
    w = torch.div(idx, WORD, rounding_mode="floor")
    s = torch.remainder(idx, WORD).to(torch.int32)
    return ((take_word(words, w) >> s) & 1).bool()


def word_or_reduce(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR along ``dim`` (a static loop: the reduced axes here are a
    handful of topic slots, history windows or edges)."""
    parts = words.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out | p
    return out


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (SWAR; the masks drop the sign bits an
    arithmetic shift drags in)."""
    x = words.to(torch.int32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def popcount(words: torch.Tensor, axis=None) -> torch.Tensor:
    """Set bits summed over ``axis`` (the word axis when None, as in the
    JAX package) as int32."""
    if axis is None:
        axis = -1
    return popcount_words(words).sum(axis, dtype=torch.int32)


def lowest_bit(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index, any): index of the lowest set bit along the packed last axis
    (0 when empty — check ``any``)."""
    nonzero = words != 0
    any_set = nonzero.any(-1)
    # first nonzero word by an unrolled prefix OR over the few words (a
    # cumsum here is an int64 scan of millions of length-W rows)
    seen = [torch.zeros_like(nonzero[..., 0])]
    for i in range(words.shape[-1] - 1):
        seen.append(seen[-1] | nonzero[..., i])
    firstmask = nonzero & ~torch.stack(seen, dim=-1)
    zero = torch.zeros((), dtype=words.dtype, device=words.device)
    word = torch.where(firstmask, words, zero).sum(-1, dtype=torch.int64) & _M32
    widx = torch.where(
        firstmask, torch.arange(words.shape[-1], device=words.device), 0
    ).sum(-1, dtype=torch.int32)
    lsb = popcount_words(to_word((word - 1) & ~word))
    idx = widx * WORD + lsb
    return torch.where(any_set, idx, 0), any_set


def prefix_cap_bits(words: torch.Tensor, cap: torch.Tensor,
                    m: int) -> torch.Tensor:
    """Keep only the first ``cap`` set bits (lowest slots) of each packed
    row; ``cap`` broadcasts over the leading dims."""
    bits = unpack(words, m)
    csum = torch.cumsum(bits.to(torch.int32), dim=-1, dtype=torch.int32)
    keep = bits & (csum <= cap[..., None])
    return pack(keep)


def keep_lowest_bits(words: torch.Tensor, cap: int, m: int | None = None,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """Keep only the first ``cap`` set bits (lowest slots) of each packed
    row, for a STATIC cap: ``cap`` steps of the clear-lowest-bit chain
    (``w & (w - 1)`` on each row's lowest nonzero word) — word-sized
    elementwise ops, no ``[.., m]`` unpack and no cumsum. After ``cap``
    clears the remainder is exactly the overflow, and keep = words & ~rem.
    Equal to ``prefix_cap_bits`` with a full(cap) plane; above 64 steps it
    is that form. ``m`` (the valid bit count) clears the padding bits of
    the last word first, which the chain would otherwise count.

    ``rows`` (int32, the leading dims' shape, each in [0, cap]) lowers the
    cap row by row: a row takes only its first ``rows`` steps, so it keeps
    its first ``rows`` set bits — ``prefix_cap_bits(words, rows, m)`` for
    a per-row budget the static ``cap`` bounds (the IWANT responses' share
    of a link's queue), without its ``[.., m]`` planes."""
    w_dim = words.shape[-1]
    if m is not None and m % WORD != 0:
        words = words & pack(torch.arange(w_dim * WORD, device=words.device) < m)
    if cap <= 0:
        return torch.zeros_like(words)
    if cap >= w_dim * WORD and rows is None:
        return words
    if cap > 64 or cap >= w_dim * WORD:
        caps = (torch.full(words.shape[:-1], cap, dtype=torch.int32, device=words.device)
                if rows is None else rows)
        return prefix_cap_bits(words, caps, w_dim * WORD)

    def step(i, cleared, kept):
        return cleared if rows is None else torch.where(
            (rows > i).reshape(rows.shape + (1,) * (cleared.dim() - rows.dim())), cleared, kept)

    if w_dim <= 2:
        # a row of one or two words is one 64-bit number whose lowest set
        # bit is the lowest nonzero word's: x & (x - 1) clears it
        x = words[..., 0].to(torch.int64) & _M32
        if w_dim == 2:
            x = x | (words[..., 1].to(torch.int64) << 32)
        for i in range(cap):
            x = step(i, x & (x - 1), x)
        rem = [to_word(x)] + ([to_word(x >> 32)] if w_dim == 2 else [])
        return words & ~torch.stack(rem, dim=-1)
    rem = words
    for i in range(cap):
        nz = rem != 0
        # the row's lowest nonzero word: nonzero, and no nonzero word below
        first = nz
        if w_dim > 1:
            below = torch.cat([torch.zeros_like(nz[..., :1]),
                               torch.cumsum(nz, -1, dtype=torch.int32)[..., :-1] > 0], -1)
            first = nz & ~below
        rem = step(i, torch.where(first, rem & (rem - 1), rem), rem)
    return words & ~rem


def first_set_per_bit(words: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Keep, per bit, only its lowest index along ``dim`` (the lowest edge
    slot carrying each message) — a static accumulator chain."""
    parts = words.unbind(dim)
    acc = torch.zeros_like(parts[0])
    outs = []
    for wk in parts:
        outs.append(wk & ~acc)
        acc = acc | wk
    return torch.stack(outs, dim=dim)


def edge_eq_words(first_edge: torch.Tensor, k_dim: int) -> torch.Tensor:
    """first_edge[N, M] int8 -> [N, K, W] packed: bit m of row (n, k) set
    iff first_edge[n, m] == k (the packed form of the int8 first-edge
    plane)."""
    ks = torch.arange(k_dim, dtype=torch.int8, device=first_edge.device)
    return pack(first_edge[:, None, :] == ks[None, :, None])


def first_edge_of(trans: torch.Tensor, n_bits: int) -> torch.Tensor:
    """trans int32[N, K, W] -> int8[N, n_bits]: lowest edge slot k whose
    packed row carries each bit, -1 where no edge carries it."""
    k_dim = trans.shape[-2]
    if k_dim > 128:
        raise ValueError(f"edge slot index must fit int8, got K={k_dim}")
    bits = unpack(trans, n_bits)  # [N, K, M] bool
    ks = torch.arange(k_dim, dtype=torch.int8, device=trans.device)[None, :, None]
    first = torch.where(bits, ks, torch.tensor(127, dtype=torch.int8)).amin(dim=-2)
    return torch.where(bits.any(dim=-2), first, torch.tensor(-1, dtype=torch.int8))


def masked_keep(planes: list, keep: torch.Tensor) -> list:
    """AND the same ``[W]`` keep mask into several ``[N, ..., W]`` planes
    (the recycled-slot clear around ``allocate_publishes``); ``None``
    entries pass through."""
    return [None if p is None else p & keep for p in planes]
