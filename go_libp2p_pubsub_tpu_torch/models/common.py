"""Shared delivery engine: one synchronous message-propagation round, and
the delivery observables every router reports.

All routers share ``delivery_round``; they differ only in *which edges
carry* a message (flood: every topic edge, floodsub.go:76-100; gossipsub:
mesh/fanout edges; randomsub: a random subset chosen at publish). Each
receiver j reads its senders' forward sets and applies edge/topic masks;
the transmit tensor ``trans[N, K, W]`` (packed words) *is* the round's wire
traffic, and popcounts of it give the SendRPC/RecvRPC trace counters.

``delivery_round`` takes one of four forms, by the Net and the state:

* banded dense (``net.band_off`` set): the ``delivery_banded`` kernel;
* any other dense topology: the plain composite below;
* CSR with a dense-resident ``[N, K, W]`` first-arrival plane: the flat
  gathers, unpacked to the dense transmit tensor, then ``finish_delivery``;
* CSR-resident (flat ``[E, W]`` plane): the ``csr_delivery`` kernel, whose
  ``RoundInfo.trans`` is the flat ``[E, W]`` plane (popcount-equal to the
  dense form: absent slots carry nothing either way).

A table with the transmit-block plane (``MsgTable.wire_block``, behind
``api.Network(max_message_size=)``) folds the blocked messages into every
receiver's exclusion mask (``not_mine``) before any route is chosen: both
kernels take that mask as an argument, so a blocked message crosses no edge
on any route (the JAX package's ``common.py:217-222``), and the route is the
one the state would take without the block.

The core's two options leave both kernels, as the JAX package routes them
(its ``common.py:204-206, 238-240``): with an outbound-queue cap
(``queue_cap``) or an async-validation pipeline (a state with
``dlv.pending``) a banded net takes the dense composite and a CSR-resident
state the flat composite (``finish_delivery_flat``). A ``forward_mask``
(``[N, W]``, an extra gate on what each receiver re-forwards) takes a
banded net off ``delivery_banded`` too, as the JAX package's banded route
refuses it; on a CSR-resident state ``csr_delivery`` still runs and the
mask is ANDed into the forward set it returns.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import bitset
from ..ops import csr_delivery as cd
from ..ops import delivery_banded as db
from ..state import Delivery, MsgTable, Net, replace, wire_block_words
from ..trace.events import EV, add_event


@dataclasses.dataclass
class RoundInfo:
    """Per-round delivery observables consumed by tracing and scoring.

    With inline validation the entry and validated cohorts coincide:
    ``recv_new_words`` is ``new_words``. With the async-validation pipeline
    ``recv_new_words`` is this round's fresh receipts (queue admission, the
    throttle's cohort) and ``new_words`` the receipts whose verdict landed
    this round (delivery, forwarding and scoring)."""

    trans: torch.Tensor        # [N, K, W] words transmitted to j on edge k
                               # (flat [E, W] on a CSR-resident round)
    new_words: torch.Tensor    # [N, W] receipts validated this round
    n_deliver: torch.Tensor    # i32 receipts of valid messages
    n_reject: torch.Tensor     # i32 receipts of invalid messages
    n_duplicate: torch.Tensor  # i32 arrivals beyond the first
    n_rpc: torch.Tensor        # i32 total (edge, msg) transmissions
    recv_new_words: torch.Tensor | None = None  # [N, W] first receipts
    n_drop: torch.Tensor | int = 0  # transmissions lost to the queue cap
    msg_slots: int | None = None    # M, the width new_bits unpacks to

    def __post_init__(self):
        if self.recv_new_words is None:
            self.recv_new_words = self.new_words

    @property
    def new_bits(self) -> torch.Tensor:
        """[N, M] bool: ``new_words`` unpacked. Derived on demand rather
        than stored: the unpack writes an [N, W, 32] plane each round that
        few consumers read."""
        m = self.msg_slots
        if m is None:
            m = self.new_words.shape[-1] * bitset.WORD
        return bitset.unpack(self.new_words, m)


def member_msg_words(member: torch.Tensor, msg_topic: torch.Tensor) -> torch.Tensor:
    """[N, W] packed mask: messages whose topic satisfies member[n, topic]
    (padding topics (-1) match nothing) — a masked OR over the topics'
    message words. A message has one topic, so the topics' words hold
    disjoint bits and their OR is their sum, which no carry and no int32
    overflow can reach: one reduction for any universe (eth2's 64 topics)
    instead of a chain of ORs. One topic needs no reduction: its words are
    the answer, and the reduction's launch cost the default bench line
    0.07% (469.32-469.49 against 469.78-469.82 delivery-rounds/s, three
    runs each in turns on an H100 at 700 W)."""
    topics = torch.arange(member.shape[1], dtype=torch.int32, device=msg_topic.device)
    tw = bitset.pack(msg_topic[None, :] == topics[:, None])  # [T, W]
    contrib = torch.where(member[:, :, None], tw[None, :, :], 0)
    if member.shape[1] == 1:
        return contrib[:, 0]
    return contrib.sum(1, dtype=torch.int32)


def subscribed_msg_words(net: Net, msgs: MsgTable) -> torch.Tensor:
    """[N, W] packed mask: messages whose topic peer n subscribes to."""
    return member_msg_words(net.subscribed, msgs.topic)


def origin_msg_words(net: Net, msgs: MsgTable) -> torch.Tensor:
    """[N, W] packed mask: messages peer n originated (never sent back to
    the origin, floodsub.go:87, gossipsub.go:1007) — an M-element scatter
    of single-bit words (distinct bits per (row, word), so add == or)."""
    n = net.n_peers
    m = msgs.capacity
    w = bitset.n_words(m)
    slot = torch.arange(m, dtype=torch.int64, device=msgs.origin.device)
    upd = torch.ones_like(slot) << (slot % 32)
    row = torch.where(msgs.origin >= 0, msgs.origin.long(), n)
    flat = torch.zeros(((n + 1) * w,), dtype=torch.int64, device=slot.device)
    flat = flat.index_add(0, row * w + slot // 32, upd)
    return bitset.to_word(flat[: n * w]).reshape(n, w)


def pipeline_entry_masks(msg_topic: torch.Tensor, delay_topic: tuple, v: int) -> torch.Tensor:
    """[V, W] stage-entry masks of the per-topic validation pipeline: a
    receipt of a topic with delay d enters shift stage V - d, so its
    verdict lands d rounds after arrival (validation.go:391-438). Padding
    topics (-1) match no stage."""
    dt = torch.as_tensor(delay_topic, dtype=torch.int32,
                         device=msg_topic.device)[msg_topic.clamp(min=0).long()]
    stage = torch.where(msg_topic >= 0, v - dt, -1)
    stages = torch.arange(v, dtype=torch.int32, device=msg_topic.device)
    return bitset.pack(stage[None, :] == stages[:, None])


def pipeline_insert(pending_shifted: torch.Tensor, new_words: torch.Tensor,
                    msg_topic: torch.Tensor, delay_topic: tuple | None) -> torch.Tensor:
    """Insert this round's fresh receipts into the (already shifted)
    pipeline at their per-topic entry stage (stage 0 when uniform)."""
    if delay_topic is None:
        return torch.cat([pending_shifted[:, :1] | new_words[:, None],
                          pending_shifted[:, 1:]], dim=1)
    masks = pipeline_entry_masks(msg_topic, delay_topic, pending_shifted.shape[1])
    return pending_shifted | (new_words[:, None, :] & masks[None, :, :])


def _pipeline_step(dlv: Delivery, new_words, msg_topic, delay_topic):
    """(validated, pending): with a pipeline, the cohort leaving its last
    stage and the stages shifted with ``new_words`` entered; inline,
    ``new_words`` and None."""
    if dlv.pending is None:
        return new_words, None
    shifted = torch.cat([torch.zeros_like(dlv.pending[:, :1]), dlv.pending[:, :-1]], dim=1)
    return dlv.pending[:, -1], pipeline_insert(shifted, new_words, msg_topic, delay_topic)


def _cap(trans: torch.Tensor, queue_cap: int, m: int):
    """(trans, n_drop): each directed link carries at most ``queue_cap``
    messages a round, the lowest slots first; the overflow is lost and
    counted (doDropRPC, gossipsub.go:1155-1160; comm.go:139-170)."""
    if queue_cap <= 0:
        return trans, 0
    kept = bitset.keep_lowest_bits(trans, queue_cap, m)
    return kept, bitset.popcount(trans & ~kept).sum(dtype=torch.int32)


def _gate_forward(fwd: torch.Tensor, forward_mask: torch.Tensor | None) -> torch.Tensor:
    return fwd if forward_mask is None else fwd & forward_mask


def delivery_round(net: Net, msgs: MsgTable, dlv: Delivery,
                   edge_mask: torch.Tensor, tick: torch.Tensor,
                   forward_mask: torch.Tensor | None = None,
                   count_events: bool = True, queue_cap: int = 0,
                   val_delay_topic: tuple | None = None):
    """Advance one propagation round: transmit every sender's ``fwd`` set
    along permitted edges (``edge_mask[N, K, W]``: words edge (j, k) may
    carry j-ward), dedup against the seen-cache, record first receipts.

    Per receiver j, edge k (sender s = nbr[j, k]):
      trans = fwd[s] & not-echo(s->j) & edge_mask & not-mine(j)
    where echo excludes the edge a message first arrived on at s (the
    source exclusion, floodsub.go:85-86) and not-mine the origin. Messages
    are marked seen whether valid or not (validation.go:285-293); only
    valid ones are re-forwarded (validation.go:309-351).

    ``queue_cap`` > 0 caps each directed link's messages a round (the
    overflow is dropped and counted); a state with ``dlv.pending`` runs the
    async-validation pipeline: receipts are seen on arrival, and
    forwarding, the verdict and ``first_round`` land at pipeline exit
    (``val_delay_topic`` the per-topic delays, None uniform).
    ``forward_mask`` [N, W] gates what each receiver re-forwards (its next
    ``fwd``). Returns (Delivery, RoundInfo)."""
    n, k = net.nbr.shape
    if dlv.fe_words.dim() == 2:
        if net.edge_layout != "csr" or dlv.fe_words.shape[0] != net.n_edges:
            raise ValueError(
                "flat fe_words needs a matching edge_layout='csr' Net "
                f"({dlv.fe_words.shape[0]} != E={net.n_edges})")
    elif dlv.fe_words.shape[1] != k:
        raise ValueError(
            "Delivery.fe_words edge axis does not match the topology's "
            f"max_degree ({dlv.fe_words.shape[1]} != {k}) — construct the "
            "state with SimState.init(..., k=net.max_degree)")
    m = msgs.capacity
    w = bitset.n_words(m)
    valid_words = bitset.pack(msgs.valid)
    not_mine = ~origin_msg_words(net, msgs)  # [N, W]
    block_w = wire_block_words(msgs)
    if block_w is not None:
        # oversized messages never cross any edge (sendRPC's fragmentRPC
        # drop, gossipsub.go:1126-1140); they still live in mcache and are
        # IHAVE-advertised, as in the reference
        not_mine = not_mine & ~block_w[None, :]
    # the kernels commit inline and uncapped; the options take the composites
    plain_core = queue_cap == 0 and dlv.pending is None
    opts = dict(forward_mask=forward_mask, count_events=count_events, queue_cap=queue_cap,
                val_delay_topic=val_delay_topic)

    if net.band_off is not None and plain_core and forward_mask is None:
        ok = torch.where(net.nbr_ok[..., None], bitset.ALL, 0).to(torch.int32)
        res = db.delivery_banded(
            dlv.fwd, dlv.fe_words.reshape(n, k * w),
            (edge_mask & ok).reshape(n, k * w), not_mine, dlv.have,
            dlv.first_round, valid_words[None, :], tick,
            offsets=net.band_off, revs=net.band_rev, w=w)
        dlv = replace(dlv, have=res["have"], fwd=res["fwd"],
                      first_round=res["first_round"],
                      fe_words=res["fe"].reshape(n, k, w))
        return dlv, _round_info(res["trans"].reshape(n, k, w), res["new"], m,
                                valid_words, count_events)

    if net.edge_layout == "csr":
        mask_e = net.pack_edges(edge_mask)
        if dlv.fe_words.dim() == 2 and plain_core:
            # CSR-resident: the whole round over the flat edge space; the
            # dense [N, K, W] transmit tensor never exists. Every row segment
            # is bounded by K in both the fused and the unfused build.
            res = cd.csr_delivery(
                dlv.fwd, dlv.fe_words, mask_e, not_mine, dlv.have,
                dlv.first_round, valid_words[None, :], tick, net.csr_col,
                net.csr_row, net.csr_eperm, net.csr_seg_start,
                net.csr_row_last, net.csr_row_nonempty, net.csr_row_ptr,
                cap=k)
            res["fwd"] = _gate_forward(res["fwd"], forward_mask)
            return _commit_flat_result(dlv, res, m, valid_words, count_events)
        resident = dlv.fe_words.dim() == 2
        trans_e = (net.peer_gather_flat(dlv.fwd)
                   & ~net.edge_gather_flat(dlv.fe_words if resident
                                           else net.pack_edges(dlv.fe_words))
                   & mask_e & net.owner_gather(not_mine))
        if resident:
            return finish_delivery_flat(net, msgs, dlv, trans_e, tick, **opts)
        return finish_delivery(net, msgs, dlv, net.unpack_edges(trans_e), tick, **opts)

    ok = torch.where(net.nbr_ok[..., None], bitset.ALL, 0).to(torch.int32)
    trans = (net.peer_gather(dlv.fwd) & ~net.edge_gather(dlv.fe_words)
             & edge_mask & ok & not_mine[:, None, :])
    return finish_delivery(net, msgs, dlv, trans, tick, **opts)


def finish_delivery(net: Net, msgs: MsgTable, dlv: Delivery,
                    trans: torch.Tensor, tick: torch.Tensor,
                    forward_mask: torch.Tensor | None = None,
                    count_events: bool = True, queue_cap: int = 0,
                    val_delay_topic: tuple | None = None):
    """Commit a computed ``[N, K, W]`` transmit tensor: the queue cap,
    seen-cache dedup, first-arrival attribution (lowest edge slot carrying
    each new bit), the validation pipeline, forward-set update. The shared
    tail of ``delivery_round``'s composite forms and the phase engine's;
    ``forward_mask`` [N, W] gates the next ``fwd``."""
    m = msgs.capacity
    trans, n_drop = _cap(trans, queue_cap, m)
    new = bitset.word_or_reduce(trans, 1) & ~dlv.have
    fa = bitset.first_set_per_bit(trans, 1) & new[:, None, :]
    valid_words = bitset.pack(msgs.valid)
    validated, pending = _pipeline_step(dlv, new, msgs.topic, val_delay_topic)
    dlv = replace(
        dlv,
        have=dlv.have | new,
        fwd=_gate_forward(validated & valid_words[None, :], forward_mask),
        first_round=torch.where(bitset.unpack(validated, m), tick, dlv.first_round),
        # overwrite (not OR) on new receipts, so stale bits cannot survive
        # a slot whose message is received again after a recycle
        fe_words=(dlv.fe_words & ~new[:, None, :]) | fa,
        pending=pending,
    )
    return dlv, _finish_info(trans, validated, new, m, valid_words, count_events, n_drop,
                             pending is not None)


def finish_delivery_flat(net: Net, msgs: MsgTable, dlv: Delivery,
                         trans_e: torch.Tensor, tick: torch.Tensor,
                         forward_mask: torch.Tensor | None = None,
                         count_events: bool = True, queue_cap: int = 0,
                         val_delay_topic: tuple | None = None):
    """The CSR-resident commit of a computed flat ``[E, W]`` transmit
    plane: the per-peer receive OR and the first-arrival isolation fall
    out of one segmented prefix OR over the row segments, and the
    first-arrival plane commits flat. Equal to ``finish_delivery`` on the
    unpacked tensor; ``RoundInfo.trans`` is the flat plane. The queue cap
    applies per flat row, one directed link each, as in the dense form."""
    m = msgs.capacity
    trans_e, n_drop = _cap(trans_e, queue_cap, m)
    valid_words = bitset.pack(msgs.valid)
    res = cd.commit_flat(
        trans_e, dlv.fe_words, dlv.have, dlv.first_round, valid_words[None, :],
        tick, net.csr_row, net.csr_seg_start, net.csr_row_last,
        net.csr_row_nonempty, cap=net.max_degree if net.fused else None)
    validated, pending = _pipeline_step(dlv, res["new"], msgs.topic, val_delay_topic)
    if pending is not None:
        res["fwd"] = validated & valid_words[None, :]
        res["first_round"] = torch.where(bitset.unpack(validated, m), tick, dlv.first_round)
    res["fwd"] = _gate_forward(res["fwd"], forward_mask)
    dlv = replace(dlv, have=res["have"], fwd=res["fwd"], first_round=res["first_round"],
                  fe_words=res["fe"], pending=pending)
    return dlv, _finish_info(trans_e, validated, res["new"], m, valid_words, count_events,
                             n_drop, pending is not None)


def _finish_info(trans, validated, new, m, valid_words, count_events, n_drop,
                 pipelined: bool) -> RoundInfo:
    """The composite commits' RoundInfo: the verdict cohort's counters,
    the fresh receipts as ``recv_new_words`` and the cap's drops; with the
    pipeline, duplicates counted against the fresh receipts."""
    info = _round_info(trans, validated, m, valid_words, count_events)
    info = replace(info, recv_new_words=new, n_drop=n_drop)
    if count_events and pipelined:
        info = replace(info, n_duplicate=info.n_rpc - bitset.popcount(new).sum(
            dtype=torch.int32))
    return info


def _commit_flat_result(dlv: Delivery, res: dict, m: int,
                        valid_words: torch.Tensor, count_events: bool):
    dlv = replace(dlv, have=res["have"], fwd=res["fwd"],
                  first_round=res["first_round"], fe_words=res["fe"])
    return dlv, _round_info(res["trans_e"], res["new"], m, valid_words, count_events)


def _round_info(trans, new_words, m, valid_words, count_events=True) -> RoundInfo:
    """Delivery observables from a round's transmit/new sets. Without
    event counting (no tracer attached) the popcount reductions are
    skipped and the counters read 0."""
    if not count_events:
        z = torch.zeros((), dtype=torch.int32, device=new_words.device)
        return RoundInfo(trans=trans, new_words=new_words, n_deliver=z,
                         n_reject=z, n_duplicate=z, n_rpc=z, msg_slots=m)
    n_rpc = bitset.popcount(trans).sum(dtype=torch.int32)
    n_new = bitset.popcount(new_words).sum(dtype=torch.int32)
    n_deliver = bitset.popcount(new_words & valid_words[None, :]).sum(dtype=torch.int32)
    return RoundInfo(trans=trans, new_words=new_words, n_deliver=n_deliver,
                     n_reject=n_new - n_deliver, n_duplicate=n_rpc - n_new,
                     n_rpc=n_rpc, msg_slots=m)


def accumulate_round_events(events: torch.Tensor, info: RoundInfo,
                            n_publish) -> torch.Tensor:
    """Fold a round's delivery observables into the cumulative counters
    (the EventTracer accounting, trace_test.go:26-195)."""
    ev = add_event(events, EV.PUBLISH_MESSAGE, n_publish)
    ev = add_event(ev, EV.DELIVER_MESSAGE, info.n_deliver)
    ev = add_event(ev, EV.REJECT_MESSAGE, info.n_reject)
    ev = add_event(ev, EV.DUPLICATE_MESSAGE, info.n_duplicate)
    ev = add_event(ev, EV.SEND_RPC, info.n_rpc)
    ev = add_event(ev, EV.RECV_RPC, info.n_rpc)
    return add_event(ev, EV.DROP_RPC, info.n_drop)
