"""The heartbeat's per-row top-k selection as one Hopper kernel
(``csrc/select_topk.cu``).

``select_topk`` replaces ``go_libp2p_pubsub_tpu/ops/pallas_csr.py``
``select_topk_pallas``: over rows ``[R, K]`` it returns
``(rank < k_rows[:, None]) & mask``, where ``rank`` counts the slots that
outrank each slot in the strict (value, noise, slot index)-descending order
and masked-out slots carry ``-inf``. The GossipSub heartbeat makes eight such
selections over its ``[N, S, K]`` rows; ``ops/select.py`` routes every one of
them here on the card.

What bounds the kernel on the card is bytes: 10 read and 1 written a slot.
A row belongs to a group of lanes (8 rows share a warp at K=16), each lane
holding a few slots loaded as vectors. One ballot counts the row's masked
slots ``c`` and decides most rows with no ranking: ``k_rows <= 0`` selects
nothing and ``k_rows >= c`` every masked slot. The other rows rank their
masked slots among the masked slots only, compacted by the ballot into a
shared-memory list, so a sparse row costs ``c`` compares a slot, not ``K``;
a compare is one unsigned compare of 96-bit keys that order the slots as
the plain version's IEEE compares do (-0.0 equals +0.0). Values and noise
are ranked with float32 subnormals flushed to a zero of the same sign, as
the JAX package's platforms (XLA on the CPU, a TPU) flush them, so 1e-45
ties with 0.0. A row with a NaN takes those float compares themselves: a
masked NaN value ranks 0 and outranks nothing. A masked ``-inf`` value ties with
the unmasked slots (``-inf`` too), which then outrank it on noise and
index; a row holding one ranks over all K slots, the pairwise count itself.
So the kernel equals ``select_topk_plain`` bit for bit on any input. It
takes any K up to ``MAX_K`` and raises above.

The wrapper launches the kernel for a CUDA tensor — or raises — and takes the
plain version only for a CPU tensor. Under ``torch.func.vmap`` (the
ensemble plane) the S sims take one launch: S*R rows when every argument
is batched, else a grid with a sim dimension (``kernels.sim_launch``).
``LAUNCHES`` counts kernel launches, a batched one once.
"""

from __future__ import annotations

import functools

import torch

from . import kernels
from .fnum import flush_subnormals

LAUNCHES = {"select_topk": 0}

#: the widest row the kernel takes
MAX_K = 256


def reset_launch_counts() -> None:
    LAUNCHES["select_topk"] = 0


def rank_desc_pairwise(primary: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """O(K^2) pairwise count of slots that outrank each slot in the strict
    (value, noise, index)-descending order, subnormals ranked as zeros."""
    primary, noise = flush_subnormals(primary), flush_subnormals(noise)
    k = primary.shape[-1]
    idx = torch.arange(k, dtype=torch.int32, device=primary.device)
    pi, pj = primary[..., :, None], primary[..., None, :]
    ni, nj = noise[..., :, None], noise[..., None, :]
    ties = pj == pi
    nties = nj == ni
    outranks = (pj > pi) | (ties & (nj > ni)) | (
        ties & nties & (idx[None, :] < idx[:, None]))
    return outranks.sum(-1, dtype=torch.int32)


def select_topk_plain(values, mask, k_rows, noise):
    """The pairwise form: ``values``/``noise`` ``[R, K]``, ``mask`` ``[R, K]``
    bool, ``k_rows`` ``[R]`` int32 -> ``[R, K]`` bool."""
    primary = torch.where(mask, values.to(torch.float32), float("-inf"))
    rank = rank_desc_pairwise(primary, noise)
    return (rank < k_rows[:, None]) & mask


def _lib():
    lib = kernels.load("select_topk")
    if not getattr(lib, "_bound", False):
        kernels.bind_sims(lib, "select_topk_sims", 5, 2)
        lib._bound = True
    return lib


def _run(args, dims, s, *, r, k):
    """One launch of the kernel (``kernels.sim_launch``'s ``run``): the one
    sim, or the S sims of a vmapped call at once."""
    x, flags, strides = kernels.sim_views(args, dims, s)
    dev = x[0].device
    specs = (("values", torch.float32, (r, k)), ("mask", torch.bool, (r, k)),
             ("k_rows", torch.int32, (r,)), ("noise", torch.float32, (r, k)))
    for (name, dtype, shape), t, b in zip(specs, x, flags):
        kernels.check(t, name, dtype, kernels.sim_shape(b, s, shape), dev)
    batched = dims is not None
    out = torch.empty(kernels.sim_shape(batched, s, (r, k)), dtype=torch.bool, device=dev)
    kernels.launch(_lib(), "select_topk", (*x, out), (r, k), s=s, batched=batched,
                   strides=strides + kernels.out_strides([out], batched), device=dev)
    LAUNCHES["select_topk"] += 1
    return (out,)


def select_topk(values, mask, k_rows, noise):
    """Per-row top-k mask over ``[R, K]`` rows. ``values`` is any float
    dtype (ranked as float32, as the TPU kernel does), ``mask`` bool,
    ``k_rows`` ``[R]`` int32 (any value: at or below 0 selects nothing,
    K or more every masked slot), ``noise`` float32, all contiguous on one
    device. Returns a fresh ``[R, K]`` bool tensor. The arguments are
    checked on either device, so the CPU takes what the card takes (on the
    card inside the launch, on the tensors it is given: under
    ``torch.func.vmap`` the S sims take one launch, ``kernels.sim_launch``)."""
    if values.dim() != 2 or not values.dtype.is_floating_point:
        raise ValueError(f"select_topk: values must be a 2-D float tensor, got "
                         f"{values.dtype} of shape {tuple(values.shape)}")
    r, k = values.shape
    if r == 0 or not 0 < k <= MAX_K:
        raise ValueError(f"select_topk: needs R > 0 rows and 1 <= K <= {MAX_K}, "
                         f"got R={r}, K={k}")
    values = values.to(torch.float32)
    if values.is_cuda:
        return kernels.sim_launch(functools.partial(_run, r=r, k=k), values, mask, k_rows,
                                  noise)[0]
    dev = values.device
    kernels.check(values, "values", torch.float32, (r, k), dev)
    kernels.check(mask, "mask", torch.bool, (r, k), dev)
    kernels.check(k_rows, "k_rows", torch.int32, (r,), dev)
    kernels.check(noise, "noise", torch.float32, (r, k), dev)
    return select_topk_plain(values, mask, k_rows, noise)
