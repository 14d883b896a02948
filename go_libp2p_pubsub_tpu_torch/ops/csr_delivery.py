"""The shared delivery round on a CSR-resident state (flat ``[E, W]``
first-arrival plane), as one Hopper kernel (``csrc/delivery.cu``).

``csr_delivery`` replaces the three ``pallas_call``s of
``go_libp2p_pubsub_tpu/ops/pallas_csr.py`` ``csr_delivery``:

* the edge phase (``_edge_phase_kernel``): the flat transmit plane
  ``trans_e = fwd[col] & ~fe[eperm] & mask_e & not_mine[row]``, with the
  optional chaos link-deny fold ``& link_ok_e``, then a capacity-bounded
  segmented prefix OR and its exclusive shift;
* the row phase (``_row_phase_kernel``): ``recv = inc[row_last]`` on
  non-empty rows, new / have / fwd and the first_round stamp;
* the edge commit (``_edge_commit_kernel``): ``fa = trans & ~exc &
  new[row]``, ``fe' = (fe & ~new[row]) | fa``.

What bounds the kernel on the card is bytes, and 63% of them are the
``[N, M]`` first_round plane, read and written whole (about 810 MB a round
at N=1M, E=5M, M=64). Rows are sorted, so a warp owns 32 consecutive rows
and their contiguous edge range: its lanes walk the flat ``(edge, word)``
elements, reading and writing the ``[E, W]`` planes contiguously, keep the
transmit words in shared memory, and reduce each row with a segmented
inclusive OR (shuffles with the segment starts, a carry across chunks).
The receive word comes from the row's last edge and the lowest edge wins
each first arrival, as in the TPU kernels' scan. The warp then stamps its
32 rows of first_round, one contiguous stretch, as 16-byte vectors. Rows
of any length, any W and the deny mask are taken; the source says how.

The wrapper launches the kernel for a CUDA tensor — or raises — and takes
the plain PyTorch version (``csr_delivery_plain``, the reference's
composite: flat gathers plus ``ops/csr.segment_or_scan`` with ``cap``)
only for a CPU tensor. Under ``torch.func.vmap`` (the ensemble plane) the
S sims take one launch, sim z on grid.z, the shared ``row_ptr``/``col``/
``eperm`` at sim stride 0 (``kernels.sim_launch``). ``LAUNCHES`` counts
kernel launches, a batched one once.
"""

from __future__ import annotations

import functools

import torch

from . import bitset, csr, kernels

LAUNCHES = {"csr_delivery": 0}

#: the dict keys of a round's outputs (pallas_csr.csr_delivery's)
OUTPUTS = ("trans_e", "recv", "new", "have", "fwd", "first_round", "fe", "fa_e")


def reset_launch_counts() -> None:
    LAUNCHES["csr_delivery"] = 0


def commit_flat(trans_e, fe_e, have, first_round, valid_row, tick, row,
                seg_start, row_last, row_nonempty, *, cap):
    """The flat commit of a computed transmit plane: the per-row receive OR
    and first-arrival isolation from one segmented prefix OR, then the
    have / fwd / first_round / fe update. Returns the ``OUTPUTS`` dict."""
    m = first_round.shape[1]
    inc, exc = csr.segment_or_scan(trans_e, seg_start, cap=cap)
    recv = torch.where(row_nonempty[:, None], inc[row_last.clamp(min=0)],
                       torch.zeros((), dtype=inc.dtype, device=inc.device))
    new = recv & ~have
    new_e = new[row]
    fa_e = trans_e & ~exc & new_e
    return {
        "trans_e": trans_e,
        "recv": recv,
        "new": new,
        "have": have | new,
        "fwd": new & valid_row,
        "first_round": torch.where(bitset.unpack(new, m), tick, first_round),
        "fe": (fe_e & ~new_e) | fa_e,
        "fa_e": fa_e,
    }


def csr_delivery_plain(fwd, fe_e, mask_e, not_mine, have, first_round,
                       valid_row, tick, col, row, eperm, seg_start, row_last,
                       row_nonempty, row_ptr=None, *, cap, link_ok_e=None):
    # row_ptr is the kernel's; this version reduces with the segment planes
    trans_e = fwd[col] & ~fe_e[eperm] & mask_e & not_mine[row]
    if link_ok_e is not None:
        trans_e = torch.where(link_ok_e[:, None], trans_e, torch.zeros_like(trans_e))
    return commit_flat(trans_e, fe_e, have, first_round, valid_row, tick, row,
                       seg_start, row_last, row_nonempty, cap=cap)


def _lib():
    lib = kernels.load("delivery")
    if not getattr(lib, "_csr_bound", False):
        kernels.bind_sims(lib, "csr_delivery_sims", 20, 3)
        lib._csr_bound = True
    return lib


def _run(args, dims, s, *, n, e, w, m):
    """One launch of the kernel (``kernels.sim_launch``'s ``run``): the one
    sim, or the S sims of a vmapped call at once."""
    x, flags, strides = kernels.sim_views(args, dims, s)
    dev = x[0].device
    i32 = torch.int32
    specs = (("fwd", i32, (n, w)), ("fe_e", i32, (e, w)), ("mask_e", i32, (e, w)),
             ("not_mine", i32, (n, w)), ("have", i32, (n, w)), ("first_round", i32, (n, m)),
             ("valid_row", i32, (1, w)), ("tick", i32, ()), ("col", i32, (e,)),
             ("eperm", i32, (e,)), ("row_ptr", i32, (n + 1,)),
             ("link_ok_e", torch.bool, (e,)))
    for (name, dtype, shape), t, b in zip(specs, x, flags):
        if t is not None:
            kernels.check(t, name, dtype, kernels.sim_shape(b, s, shape), dev)
    batched = dims is not None
    outs = [torch.empty(kernels.sim_shape(batched, s, shape), dtype=i32, device=dev)
            for shape in ((e, w), (n, w), (n, w), (n, w), (n, w), (n, m), (e, w), (e, w))]
    kernels.launch(_lib(), "csr_delivery", (*x, *outs), (n, w, m), s=s, batched=batched,
                   strides=strides + kernels.out_strides(outs, batched), device=dev)
    LAUNCHES["csr_delivery"] += 1
    return tuple(outs)


def csr_delivery(fwd, fe_e, mask_e, not_mine, have, first_round, valid_row,
                 tick, col, row, eperm, seg_start, row_last, row_nonempty,
                 row_ptr, *, cap, link_ok_e=None):
    """One delivery round over the flat edge space. ``fe_e``/``mask_e`` are
    ``[E, W]``, the peer planes ``[N, W]``, ``valid_row`` ``[1, W]``,
    ``tick`` a 0-dim int32, ``col``/``row``/``eperm`` ``[E]`` and
    ``row_ptr`` ``[N+1]`` int32 (the kernel walks rows with ``row_ptr``;
    the plain version reduces with ``seg_start``/``row_last``/
    ``row_nonempty`` and the segment bound ``cap``). ``link_ok_e`` is an
    optional ``[E]`` bool deny mask. Returns the ``OUTPUTS`` dict of fresh
    tensors. Under ``torch.func.vmap`` the S sims take one launch
    (``kernels.sim_launch``)."""
    if not fwd.is_cuda:
        return csr_delivery_plain(fwd, fe_e, mask_e, not_mine, have, first_round,
                                  valid_row, tick, col, row, eperm, seg_start,
                                  row_last, row_nonempty, row_ptr, cap=cap,
                                  link_ok_e=link_ok_e)
    n, w = fwd.shape
    e, m = fe_e.shape[0], first_round.shape[1]
    if n == 0 or bitset.n_words(m) != w:
        raise ValueError(f"csr_delivery: needs N > 0 and W = ceil(M/32), got "
                         f"N={n}, M={m}, W={w}")
    outs = kernels.sim_launch(functools.partial(_run, n=n, e=e, w=w, m=m), fwd, fe_e, mask_e,
                              not_mine, have, first_round, valid_row, tick, col, eperm,
                              row_ptr, link_ok_e)
    return dict(zip(OUTPUTS, outs))
