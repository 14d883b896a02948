"""The per-round step's whole edge-crossing data plane on a banded
topology, as two Hopper kernels (``csrc/fused_round.cu``).

* ``edge_exchange`` — the merged control-wire gather across the edge
  involution, ``wire_in[j,k] = wire[(j+off[k]) % N, rev[k]]`` zeroed on dead
  edges, plus the neighbor-score exchange. Replaces the TPU kernel
  ``go_libp2p_pubsub_tpu/ops/fused_round.py`` ``edge_exchange``
  (``_exchange_kernel``).
* ``fused_delivery`` — the delivery plane: mesh/flood push with echo and
  origin exclusion, flag and score gates, the IWANT service with 2-bit
  saturating retransmission counters, seen-cache dedup, first-arrival
  cohorts (push before IWANT, lowest edge slot wins) and the new/have/fwd
  commit. Replaces ``fused_delivery`` (``_delivery_kernel``) of the same
  file.

Both are bounded by bytes (word algebra, a few integer ops per word): the
source notes what each must move. ``edge_exchange`` is a copy: a thread
a (receiver, edge) slot, or a few for a wide slot, moves the slot's C
words as 16-byte vectors where C and the pointers allow, with 32-bit
index math and no division, reading each sender row through L2, where its
2K neighbours find it; score bits are copied as they are, a subnormal
too. ``fused_delivery`` is laid out for the card (``csrc/banded.cuh``): a
block stages the sender rows of its band in shared memory, a row's (edge,
word) words sit on neighbouring lanes, and the first-arrival cohorts are
shuffle scans over a row's edges; an offset beyond the block's halo reads
its sender words from global memory. Its score gates read a subnormal
neighbour score or threshold as a zero of its sign, as the JAX package's
platforms do (``ops/fnum.py``), in the kernel and the plain version
alike. Both take any K <= 16; ``edge_exchange`` any C, ``fused_delivery``
any W.

Each wrapper launches its kernel for a CUDA tensor — or raises — and takes
the plain PyTorch version (``*_plain``, built from rolls and bitwise ops)
only for a CPU tensor. Under ``torch.func.vmap`` (the ensemble plane) the
S sims take one launch of each kernel (``kernels.sim_launch``).
``LAUNCHES`` counts kernel launches per wrapper, a batched one once.
Reference semantics: gossipsub.go:943-1013 (push), floodsub.go:85-88 (echo
and origin exclusion), pubsub.go:1076-1081 (dedup), gossipsub.go:679-716
(IWANT service and retransmission cap), gossipsub.go:1096-1141 (control
piggyback).
"""

from __future__ import annotations

import functools

import torch

from . import bitset, kernels
from .edges import edge_permute_banded, peer_gather_banded
from .fnum import flush_f32, flush_subnormals

MAX_K = 16
LAUNCHES = {"edge_exchange": 0, "fused_delivery": 0}

# flags bit assignments (built by make_flags)
F_ACC_MSG = 0        # AcceptFrom message plane (score graylist)
F_FLOOD_FROM = 1     # far end is a floodsub-only peer
F_I_AM_FLOODSUB = 2  # this peer is floodsub-only
F_SENDER_FWD = 3     # edge's sender transmits data
F_LIVE = 4           # edge alive


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def make_flags(acc_msg, flood_from, i_am_floodsub, sender_fwd_ok, live):
    """[N,K] int32 per-edge flag words from the round's bool masks."""
    i32 = torch.int32
    f = acc_msg.to(i32) << F_ACC_MSG
    f = f | (flood_from.to(i32) << F_FLOOD_FROM)
    f = f | (i_am_floodsub.to(i32)[:, None] << F_I_AM_FLOODSUB)
    f = f | (sender_fwd_ok.to(i32) << F_SENDER_FWD)
    return f | (live.to(i32) << F_LIVE)


def served_capped_mask(retrans_cap: int, lo, hi):
    """Word-mask of slots whose 2-bit served count reached the
    retransmission cap (static in the cap, clamped to the counter range)."""
    cap = min(max(retrans_cap, 0), 3)
    if cap >= 3:
        return hi & lo
    if cap == 2:
        return hi
    if cap == 1:
        return hi | lo
    return torch.full_like(lo, bitset.ALL)


def _bit(flags: torch.Tensor, b: int) -> torch.Tensor:
    return ((flags >> b) & 1) != 0


def _gate(cond: torch.Tensor) -> torch.Tensor:
    """bool [N,K] -> int32 word gate [N,K,1]."""
    return torch.where(cond, bitset.ALL, 0).to(torch.int32)[..., None]


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the card-side comparison in chip_smoke.py)


def edge_exchange_plain(wire_pack, scores, live_u32, *, offsets, revs, c,
                        score_enabled):
    n = wire_pack.shape[0]
    k = len(offsets)
    live = live_u32 != 0
    g = edge_permute_banded(wire_pack.reshape(n, k, c), offsets, revs)
    wire_in = torch.where(live[..., None], g, 0).reshape(n, k * c)
    if not score_enabled:
        return wire_in, None
    sc = edge_permute_banded(scores[..., None], offsets, revs)[..., 0]
    return wire_in, torch.where(live, sc, 0.0)


def fused_delivery_plain(carry_out, fe_words, fwd, mcache_win, nbr_score,
                         asked, served_lo, served_hi, flags, have, origin_w,
                         joined_w, valid_row, gossip_thr=0.0, publish_thr=0.0,
                         *, offsets, revs, w, score_enabled, want_cohorts,
                         retrans_cap, thr_row=None):
    n = fwd.shape[0]
    k = len(offsets)
    v3 = lambda x: x.reshape(n, k, w)
    fwd_s = peer_gather_banded(fwd, offsets)
    mcw_s = peer_gather_banded(mcache_win, offsets)
    carry_k = edge_permute_banded(v3(carry_out), offsets, revs)
    echo_k = edge_permute_banded(v3(fe_words), offsets, revs)
    not_mine = (~origin_w)[:, None, :]

    live = _bit(flags, F_LIVE)
    live_g = _gate(live)
    accmsg_g = _gate(_bit(flags, F_ACC_MSG))
    sfo_g = _gate(_bit(flags, F_SENDER_FWD))
    if score_enabled:   # the score gates read subnormals as zeros, as XLA does
        nbr_score = flush_subnormals(nbr_score)
        if thr_row is not None:
            gossip_thr, publish_thr = flush_subnormals(thr_row.reshape(2)).unbind()
        else:
            gossip_thr, publish_thr = flush_f32(gossip_thr), flush_f32(publish_thr)
    recv_ok = (nbr_score >= publish_thr) if score_enabled else live
    flood = _gate(_bit(flags, F_FLOOD_FROM)) | (
        _gate(_bit(flags, F_I_AM_FLOODSUB)) & _gate(recv_ok))
    emask = (carry_k | flood) & accmsg_g & joined_w[:, None, :]
    t = fwd_s & ~echo_k & emask & live_g & sfo_g & not_mine

    slo, shi = v3(served_lo), v3(served_hi)
    resp = v3(asked) & mcw_s & ~served_capped_mask(retrans_cap, slo, shi) & live_g
    if score_enabled:
        resp = resp & _gate(nbr_score >= gossip_thr)
    inc = resp & ~(shi & slo)
    extra = resp & accmsg_g & sfo_g & not_mine

    new_t = bitset.word_or_reduce(t, 1) & ~have
    new_e = bitset.word_or_reduce(extra, 1) & ~(have | new_t)
    new = new_t | new_e
    fe2 = ((v3(fe_words) & ~new[:, None, :])
           | (bitset.first_set_per_bit(t, 1) & new_t[:, None, :])
           | (bitset.first_set_per_bit(extra, 1) & new_e[:, None, :]))
    res = {
        "trans": (t | extra).reshape(n, k * w),
        "fe": fe2.reshape(n, k * w),
        "served_lo": (slo ^ inc).reshape(n, k * w),
        "served_hi": (shi | (slo & inc)).reshape(n, k * w),
        "new": new,
        "have": have | new,
        "fwd": new & valid_row,
    }
    if want_cohorts:
        res["mesh_trans"] = t.reshape(n, k * w)
        res["extra"] = extra.reshape(n, k * w)
    return res


# ---------------------------------------------------------------------------
# kernel wrappers

def _lib():
    lib = kernels.load("fused_round")
    if not getattr(lib, "_pubsub_bound", False):
        kernels.bind_sims(lib, "edge_exchange_sims", 6, 4)
        kernels.bind_sims(lib, "fused_delivery_sims", 24, 6)
        lib._pubsub_bound = True
    return lib


def _thr_row(gossip_thr, publish_thr, device) -> torch.Tensor:
    """The [1, 2] threshold row of host floats, made once per value."""
    g, p = float(gossip_thr), float(publish_thr)
    return kernels.const(("thr", g, p, str(device)),
                         lambda: torch.tensor([[g, p]], dtype=torch.float32, device=device))


def _check_k(k: int, n: int):
    if not 0 < k <= MAX_K:
        raise ValueError(f"the fused kernels take 1 <= K <= {MAX_K} edges, got {k}")
    if n <= 0:
        raise ValueError("empty peer axis")


def _exchange_run(args, dims, s, *, n, k, c, score_enabled):
    """One ``edge_exchange`` launch (``kernels.sim_launch``'s ``run``): the
    one sim, or the S sims of a vmapped call at once."""
    x, flags, strides = kernels.sim_views(args, dims, s)
    wire_pack, scores, live_u32, offrev = x
    dev = wire_pack.device
    sh = lambda i, shape: kernels.sim_shape(flags[i], s, shape)
    kernels.check(wire_pack, "wire_pack", torch.int32, sh(0, (n, k * c)), dev)
    kernels.check(live_u32, "live_u32", torch.int32, sh(2, (n, k)), dev)
    if score_enabled:
        kernels.check(scores, "scores", torch.float32, sh(1, (n, k)), dev)
    batched = dims is not None
    wire_out = torch.empty(kernels.sim_shape(batched, s, (n, k * c)), dtype=torch.int32,
                           device=dev)
    outs = [wire_out]
    if score_enabled:
        outs.append(torch.empty(kernels.sim_shape(batched, s, (n, k)), dtype=torch.float32,
                                device=dev))
    score_out = outs[1] if score_enabled else None
    kernels.launch(_lib(), "edge_exchange", (*x, wire_out, score_out),
                   (n, k, c, int(score_enabled)), s=s, batched=batched,
                   strides=strides + kernels.out_strides([wire_out, score_out], batched),
                   device=dev)
    LAUNCHES["edge_exchange"] += 1
    return tuple(outs)


def edge_exchange(wire_pack, scores, live_u32, *, offsets, revs, c,
                  score_enabled):
    """Merged control-wire gather + neighbor-score exchange (see module
    docstring). Returns (wire_in [N, K*C] int32, nbr_score [N, K] f32 or
    None)."""
    if not wire_pack.is_cuda:
        return edge_exchange_plain(wire_pack, scores, live_u32, offsets=offsets,
                                   revs=revs, c=c, score_enabled=score_enabled)
    n, k = wire_pack.shape[0], len(offsets)
    _check_k(k, n)
    outs = kernels.sim_launch(
        functools.partial(_exchange_run, n=n, k=k, c=c, score_enabled=score_enabled),
        wire_pack, scores if score_enabled else None, live_u32,
        kernels.offrev(offsets, revs, wire_pack.device))
    return outs[0], (outs[1] if score_enabled else None)


#: fused_delivery's outputs, in the kernel's order (the cohorts last)
FUSED_OUTPUTS = ("trans", "fe", "served_lo", "served_hi", "new", "have", "fwd",
                 "mesh_trans", "extra")


def _delivery_run(args, dims, s, *, n, k, w, score_enabled, want_cohorts, retrans_cap):
    """One ``fused_delivery`` launch (``kernels.sim_launch``'s ``run``):
    the one sim, or the S sims of a vmapped call at once."""
    x, flags, strides = kernels.sim_views(args, dims, s)
    dev = x[0].device
    i32 = torch.int32
    kw = k * w
    specs = (("carry_out", i32, (n, kw)), ("fe_words", i32, (n, kw)), ("fwd", i32, (n, w)),
             ("mcache_win", i32, (n, w)), ("nbr_score", torch.float32, (n, k)),
             ("asked", i32, (n, kw)), ("served_lo", i32, (n, kw)),
             ("served_hi", i32, (n, kw)), ("flags", i32, (n, k)), ("have", i32, (n, w)),
             ("origin_w", i32, (n, w)), ("joined_w", i32, (n, w)),
             ("valid_row", i32, (1, w)), ("thr_row", torch.float32, (1, 2)))
    for (name, dtype, shape), t, b in zip(specs, x, flags):
        if t is not None:
            kernels.check(t, name, dtype, kernels.sim_shape(b, s, shape), dev)
    batched = dims is not None
    shapes = [(n, kw)] * 4 + [(n, w)] * 3 + ([(n, kw)] * 2 if want_cohorts else [])
    outs = [torch.empty(kernels.sim_shape(batched, s, shape), dtype=i32, device=dev)
            for shape in shapes]
    ptr_outs = outs + [None] * (len(FUSED_OUTPUTS) - len(outs))
    kernels.launch(_lib(), "fused_delivery", (*x, *ptr_outs),
                   (n, k, w, int(score_enabled), int(want_cohorts), int(retrans_cap)), s=s,
                   batched=batched, strides=strides + kernels.out_strides(ptr_outs, batched),
                   device=dev)
    LAUNCHES["fused_delivery"] += 1
    return tuple(outs)


def fused_delivery(carry_out, fe_words, fwd, mcache_win, nbr_score, asked,
                   served_lo, served_hi, flags, have, origin_w, joined_w,
                   valid_row, gossip_thr=0.0, publish_thr=0.0, *, offsets,
                   revs, w, score_enabled, want_cohorts, retrans_cap, thr_row=None):
    """The full delivery plane of one round. Returns a dict with trans, fe,
    served_lo, served_hi ([N, K*W]) and new, have, fwd ([N, W]), all
    post-round and freshly allocated, plus the mesh_trans/extra cohorts
    when ``want_cohorts``. The score gates' (gossip, publish) thresholds are
    host floats (``gossip_thr``, ``publish_thr``: a constant row kept per
    value) or, from a lifted plane, ``thr_row``, a float32 ``[1, 2]`` row
    on the device, which the kernel reads as it stands: no host read, so a
    captured window replays any plane's thresholds. Under
    ``torch.func.vmap`` the S sims take one launch (``kernels.sim_launch``),
    a stacked plane's ``thr_row`` one row a sim."""
    kw_args = dict(offsets=offsets, revs=revs, w=w, score_enabled=score_enabled,
                   want_cohorts=want_cohorts, retrans_cap=retrans_cap, thr_row=thr_row)
    if not fwd.is_cuda:
        return fused_delivery_plain(
            carry_out, fe_words, fwd, mcache_win, nbr_score, asked, served_lo,
            served_hi, flags, have, origin_w, joined_w, valid_row, gossip_thr,
            publish_thr, **kw_args)
    dev = fwd.device
    n, k = fwd.shape[0], len(offsets)
    _check_k(k, n)
    if thr_row is None:
        thr_row = _thr_row(gossip_thr, publish_thr, dev)
    else:
        thr_row = thr_row.contiguous()
    run = functools.partial(_delivery_run, n=n, k=k, w=w, score_enabled=score_enabled,
                            want_cohorts=want_cohorts, retrans_cap=retrans_cap)
    outs = kernels.sim_launch(
        run, carry_out, fe_words, fwd, mcache_win, nbr_score if score_enabled else None,
        asked, served_lo, served_hi, flags, have, origin_w, joined_w, valid_row, thr_row,
        kernels.offrev(offsets, revs, dev))
    return dict(zip(FUSED_OUTPUTS, outs))
