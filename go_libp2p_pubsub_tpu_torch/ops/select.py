"""Masked ranking and selection over the padded neighbor axis.

Every peer selection of the reference is either a score-ordered keep/drop
with random tie-break (gossipsub.go:1389-1399) or a uniform random-k over an
eligibility filter (getPeers/shufflePeers, gossipsub.go:1852-1909). Both
reduce to ``rank_desc`` — a dense descending rank with masked slots pushed
to the end and ties broken by uniform noise — and "top k" is ``rank < k``.

``rank_desc`` is the pairwise count of the JAX package's ``fused=False``
form; its ``fused=True`` sort form gives the same ranks on NaN-free inputs,
so the port keeps one form for both builds. On the card
``select_topk_mask`` is one launch of the ``select_topk`` kernel
(``ops/select_topk.py``); on the CPU it ranks with the kernel's plain
version.
"""

from __future__ import annotations

import torch

from .. import prng
from . import bitset
from . import select_topk as sk
from .select_topk import rank_desc_pairwise as _rank_desc_pairwise


def _noise(key, shape, device) -> torch.Tensor:
    if key is not None:
        return prng.uniform(key, shape)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def rank_desc(values: torch.Tensor, mask: torch.Tensor, key=None) -> torch.Tensor:
    """Dense descending rank along the last axis: the highest masked value
    gets 0, unmasked slots rank after all masked ones, ties break by
    uniform noise drawn from ``key`` (by slot index without one)."""
    noise = _noise(key, values.shape, values.device)
    primary = torch.where(mask, values.to(torch.float32), float("-inf"))
    return _rank_desc_pairwise(primary, noise)


def kernel_rows(values, mask, k, key=None):
    """The ``[R, K]`` arguments of one ``select_topk`` call for
    ``[..., K]`` inputs: float32 values and the mask made contiguous (the
    heartbeat's score plane is a broadcast view), ``k`` broadcast to one
    int32 width per row, the tie-break noise drawn from ``key``."""
    k_dim = values.shape[-1]
    rows = values.shape[:-1]
    if isinstance(k, torch.Tensor):
        k_rows = k.to(torch.int32).expand(rows).reshape(-1).contiguous()
    else:
        # a Python width is a fill on the device, never a copy from the host
        k_rows = torch.full((rows.numel(),), int(k), dtype=torch.int32, device=values.device)
    return (values.to(torch.float32).contiguous().reshape(-1, k_dim),
            mask.contiguous().reshape(-1, k_dim), k_rows,
            _noise(key, values.shape, values.device).reshape(-1, k_dim))


def select_topk_mask(values, mask, k, key=None):
    """Bool mask choosing the (up to) k highest masked values per row; ``k``
    is a scalar or a tensor broadcastable to ``values.shape[:-1]``."""
    if values.is_cuda:
        return sk.select_topk(*kernel_rows(values, mask, k, key)).reshape(values.shape)
    ranks = rank_desc(values, mask, key)
    k_arr = torch.as_tensor(k, device=values.device)[..., None]
    return (ranks < k_arr) & mask


def select_random_mask(key, mask, k):
    """Bool mask choosing (up to) k uniform-random masked slots per row."""
    noise = prng.uniform(key, mask.shape)
    return select_topk_mask(noise, mask, k)


def _clip_width(width, width_max: int, device):
    """``width`` clipped into [0, width_max]: a tensor stays one, a Python
    width stays a Python int."""
    if not isinstance(width, torch.Tensor):
        return min(max(int(width), 0), int(width_max))
    return width.to(device=device, dtype=torch.int32).clamp(0, int(width_max))


def masked_width_topk(values, mask, width, width_max: int, key=None):
    """Top-k at a width clipped into [0, width_max]."""
    w = _clip_width(width, width_max, values.device)
    return select_topk_mask(values, mask, w, key)


def masked_width_random(key, mask, width, width_max: int):
    """Random-k at a width clipped into [0, width_max]."""
    w = _clip_width(width, width_max, mask.device)
    return select_random_mask(key, mask, w)


def count_true(mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return mask.sum(axis, dtype=torch.int32)


def median_masked(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Upper median over masked slots per row (sort ascending, element
    len/2 — gossipsub.go:1488-1493); +inf for rows with no masked slot.
    It only sorts and selects, so it needs no subnormal flush of its own:
    the step's scores are flushed where they are computed."""
    big = float("inf")
    v = torch.where(mask, values.to(torch.float32), big)
    v_sorted = torch.sort(v, dim=-1).values
    n = count_true(mask)
    idx = (n // 2).clamp(0, values.shape[-1] - 1)
    med = bitset.take_word(v_sorted, idx)
    return torch.where(n > 0, med, big)
