"""The shared delivery round on a banded topology, as one Hopper kernel
(``csrc/delivery.cu``).

``delivery_banded`` replaces the TPU kernel
``go_libp2p_pubsub_tpu/ops/pallas_delivery.py`` ``delivery_round_banded``
(``_kernel``): per receiver j and edge k (sender ``(j + off[k]) % N``, which
holds the edge in slot ``rev[k]``),

    trans = fwd[s] & ~fe[s, rev[k]] & emask[j, k] & not_mine[j]

then the OR over edges deduplicated against the seen-cache, the lowest
edge carrying each new bit as its first arrival, and the have / fwd /
first_round / fe commit. It works on the packed ``[N, K, W]`` first-arrival
plane that ``Delivery`` holds, not the TPU kernel's int8 ``[N, M]`` form
(which only the TPU compiler needed), and its ``fe'`` is the composite's
``(fe & ~new) | fa``. It is bounded by bytes; the source says what it
moves. Its layout is the one ``fused_delivery`` uses (``csrc/banded.cuh``):
a block stages the sender rows of its band in shared memory, a row's
(edge, word) words sit on neighbouring lanes, the OR over edges and the
lowest-edge-wins prefix are shuffle scans, ``trans`` is never read back,
and first_round is stamped over the block's rows as 16-byte vectors. It
takes any K (up to the about 12,000 edges whose words one block can stage),
any W and any N.

The wrapper launches the kernel for a CUDA tensor — or raises — and takes
the plain PyTorch version (``delivery_banded_plain``) only for a CPU
tensor. Under ``torch.func.vmap`` (the ensemble plane) the S sims take
one launch, sim z on grid.z (``kernels.sim_launch``). ``LAUNCHES`` counts
kernel launches, a batched one once. Reference semantics:
floodsub.go:76-100 (forward to every topic peer except the source and the
origin), pubsub.go:1076-1081 (seen-cache dedup).
"""

from __future__ import annotations

import functools

import torch

from . import bitset, kernels
from .edges import edge_permute_banded, peer_gather_banded

LAUNCHES = {"delivery_banded": 0}


def reset_launch_counts() -> None:
    LAUNCHES["delivery_banded"] = 0


def delivery_banded_plain(fwd, fe, emask, not_mine, have, first_round,
                          valid_row, tick, *, offsets, revs, w):
    n = fwd.shape[0]
    k = len(offsets)
    m = first_round.shape[1]
    v3 = lambda x: x.reshape(n, k, w)
    t = (peer_gather_banded(fwd, offsets) & ~edge_permute_banded(v3(fe), offsets, revs)
         & v3(emask) & not_mine[:, None, :])
    new = bitset.word_or_reduce(t, 1) & ~have
    fa = bitset.first_set_per_bit(t, 1) & new[:, None, :]
    return {
        "trans": t.reshape(n, k * w),
        "fe": ((v3(fe) & ~new[:, None, :]) | fa).reshape(n, k * w),
        "new": new,
        "have": have | new,
        "fwd": new & valid_row,
        "first_round": torch.where(bitset.unpack(new, m), tick, first_round),
    }


#: the outputs of a round, in the kernel's order
OUTPUTS = ("trans", "fe", "new", "have", "fwd", "first_round")


def _lib():
    lib = kernels.load("delivery")
    if not getattr(lib, "_banded_bound", False):
        kernels.bind_sims(lib, "delivery_banded_sims", 15, 4)
        lib._banded_bound = True
    return lib


def _run(args, dims, s, *, n, k, w, m):
    """One launch of the kernel (``kernels.sim_launch``'s ``run``): the one
    sim, or the S sims of a vmapped call at once."""
    x, flags, strides = kernels.sim_views(args, dims, s)
    dev = x[0].device
    i32 = torch.int32
    shapes = ((n, w), (n, k * w), (n, k * w), (n, w), (n, w), (n, m), (1, w), ())
    for name, t, b, shape in zip(("fwd", "fe", "emask", "not_mine", "have", "first_round",
                                  "valid_row", "tick"), x, flags, shapes):
        kernels.check(t, name, i32, kernels.sim_shape(b, s, shape), dev)
    batched = dims is not None
    outs = [torch.empty(kernels.sim_shape(batched, s, shape), dtype=i32, device=dev)
            for shape in ((n, k * w), (n, k * w), (n, w), (n, w), (n, w), (n, m))]
    kernels.launch(_lib(), "delivery_banded", (*x, *outs), (n, k, w, m), s=s,
                   batched=batched, strides=strides + kernels.out_strides(outs, batched),
                   device=dev)
    LAUNCHES["delivery_banded"] += 1
    return tuple(outs)


def delivery_banded(fwd, fe, emask, not_mine, have, first_round, valid_row,
                    tick, *, offsets, revs, w):
    """One delivery round on a banded topology. ``fe``/``emask`` are the
    ``[N, K*W]`` first-arrival and edge-mask planes (the mask already
    zero on dead edges), ``not_mine`` the ``[N, W]`` words of messages a
    peer did not originate, ``valid_row`` ``[1, W]``, ``tick`` a 0-dim
    int32. Returns a dict of fresh tensors: trans, fe ``[N, K*W]``; new,
    have, fwd ``[N, W]``; first_round ``[N, M]``. Under ``torch.func.vmap``
    the S sims take one launch (``kernels.sim_launch``)."""
    if not fwd.is_cuda:
        return delivery_banded_plain(fwd, fe, emask, not_mine, have, first_round,
                                     valid_row, tick, offsets=offsets, revs=revs, w=w)
    n, k, m = fwd.shape[0], len(offsets), first_round.shape[1]
    if k == 0 or n == 0 or bitset.n_words(m) != w:
        raise ValueError(f"delivery_banded: needs K > 0, N > 0 and W = ceil(M/32), "
                         f"got K={k}, N={n}, M={m}, W={w}")
    offrev = kernels.offrev(offsets, revs, fwd.device)
    outs = kernels.sim_launch(functools.partial(_run, n=n, k=k, w=w, m=m), fwd, fe, emask,
                              not_mine, have, first_round, valid_row, tick, offrev)
    return dict(zip(OUTPUTS, outs))
