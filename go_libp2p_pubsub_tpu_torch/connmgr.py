"""Connection-manager protection + decaying delivery tags (tag_tracer.go).

The reference's tagTracer is a RawTracer that drives the libp2p connection
manager: direct peers are protected ("pubsub:<direct>",
tag_tracer.go:81-90), mesh peers are protected per topic on Graft and
unprotected on Prune (:93-101, :204-210), and every first (or near-first)
delivery bumps a decaying per-topic tag by 1, capped at 15, decaying 1 per
10 minutes (:13-31, :107-151). The connection manager uses tag totals to
pick victims when trimming connections over the high-water mark; protected
peers are never trimmed.

Formulation: tags are a dense [N, S, K] i32 array (peer × topic-slot ×
edge), protection is derived per round from mesh/direct state, and decay is
a tick-counted elementwise pass — the same decay-loop shape as the score
engine. `TagTracer` is the host-side session that consumes the trace
drain's per-round snapshots (first deliveries are exact there) and bumps
tags; `trim` computes the connection-manager's victim set as a keep-mask
that can be fed into the engine's churn plane (up/edge masks).

Time base: 1 round = 1 heartbeat = 1s, so the 10-minute decay interval is
600 ticks (documented time-base conversion per SURVEY §7 hard-part (e)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# tag_tracer.go:20 (bump), :23 (decay interval), :26 (decay amount), :30 (cap)
TAG_BUMP = 1
TAG_DECAY_INTERVAL_TICKS = 600
TAG_DECAY_AMOUNT = 1
TAG_CAP = 15
# gossipsub.go connmgr tag values (doc comment tag_tracer.go:36-39)
DIRECT_PEER_TAG_VALUE = 1000
MESH_PEER_TAG_VALUE = 20


def _host(x) -> np.ndarray:
    """A host array of a tensor on any device, or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class ConnManager:
    """Vectorized connection-manager model over the simulation's N peers.

    Holds, per directed edge (peer, k):
      tags      [N, S, K] — decaying delivery tags per topic slot
      last_decay — tick of the last decay pass
    Protection and tag totals are computed on demand from the router state.
    """

    n_peers: int
    n_slots: int
    max_degree: int

    def __post_init__(self):
        self.tags = np.zeros((self.n_peers, self.n_slots, self.max_degree), np.int32)
        self.last_decay = 0

    # -- decay (DecayFixed(1) every 10min, tag_tracer.go:115-119) ----------

    def maybe_decay(self, tick: int) -> None:
        while tick - self.last_decay >= TAG_DECAY_INTERVAL_TICKS:
            self.tags = np.maximum(self.tags - TAG_DECAY_AMOUNT, 0)
            self.last_decay += TAG_DECAY_INTERVAL_TICKS

    # -- bumps (BumpSumBounded(0, cap), tag_tracer.go:119,141-150) ---------

    def bump(self, peer: int, slot: int, edge: int, amount: int = TAG_BUMP) -> None:
        t = self.tags[peer, slot, edge] + amount
        self.tags[peer, slot, edge] = min(t, TAG_CAP)

    # -- valuation + trimming ---------------------------------------------

    def protected(self, net, mesh: np.ndarray | None) -> np.ndarray:
        """[N, K] bool — edges the connection manager must not trim:
        direct peers (tag_tracer.go:81-90) and peers in any topic mesh
        (:93-101)."""
        prot = _host(net.direct).copy()
        if mesh is not None:
            prot |= mesh.any(axis=1)  # [N,S,K] -> any topic
        return prot

    def edge_value(self, net, mesh: np.ndarray | None) -> np.ndarray:
        """[N, K] int — connmgr tag total per connection: delivery tags
        summed over topics + the fixed direct/mesh tag values."""
        val = self.tags.sum(axis=1)
        if mesh is not None:
            val = val + MESH_PEER_TAG_VALUE * mesh.sum(axis=1)
        val = val + DIRECT_PEER_TAG_VALUE * _host(net.direct)
        return val

    def trim(self, net, mesh: np.ndarray | None, max_conns: int) -> np.ndarray:
        """Keep-mask [N, K]: each peer over the high-water mark drops its
        lowest-valued unprotected connections down to `max_conns` (the
        BasicConnMgr TrimOpenConns contract the reference relies on in
        gossipsub_connmgr_test.go). Protected edges always survive."""
        nbr_ok = _host(net.nbr_ok)
        prot = self.protected(net, mesh) & nbr_ok
        val = self.edge_value(net, mesh)
        keep = prot.copy()
        budget = np.maximum(max_conns - prot.sum(axis=1), 0)
        # rank unprotected live edges by value, descending; keep top-budget
        cand = nbr_ok & ~prot
        order = np.argsort(np.where(cand, -val, np.iinfo(np.int32).max), axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, np.arange(order.shape[1])[None, :], axis=1)
        keep |= cand & (rank < budget[:, None])
        return keep


class TagTracer:
    """Host-side session bridging the trace drain to the ConnManager —
    the vectorized counterpart of tagTracer's RawTracer hooks.

    Per round (from consecutive Snapshots):
      DeliverMessage — every (peer, msg) first-received this round bumps
        the arrival edge's tag for the message's topic
        (tag_tracer.go:186-197). The reference additionally bumps
        "near-first" deliverers — duplicates arriving while validation was
        in flight (:161-183, :225-232); the synchronous engine validates
        within the round, so that window collapses to the first edge and
        same-round duplicates are tracked only in the aggregate duplicate
        counters (trace/events.py).
      validity — rejected messages don't bump (RejectMessage clears the
        near-first state, :234-247): filtered via msg_valid.
    """

    def __init__(self, net):
        # the neighbour planes are read on the host once, here, not once
        # per event (the net's tensors may live on the card)
        self.net = net
        n, k = net.nbr.shape
        self.cm = ConnManager(n, net.n_slots, k)
        self.slot_of = _host(net.slot_of)

    def observe(self, prev, new) -> None:
        """Consume one step transition (Snapshot pair from trace.drain).
        Range check, not ==: a phase step (rounds_per_phase > 1) advances
        several ticks at once and stamps first_round per sub-round — all
        of a phase's first deliveries bump at the boundary."""
        first = (new.first_round >= prev.tick) \
            & (new.first_round < new.tick) & (new.first_edge >= 0) \
            & new.msg_valid[None, :]
        peers, msgs = np.nonzero(first)
        if peers.size:
            topics = new.msg_topic[msgs]
            slots = self.slot_of[peers, topics]
            edges = new.first_edge[peers, msgs].astype(np.int64)
            ok = slots >= 0
            idx = (peers[ok], slots[ok], edges[ok])
            # in-place scatter + cap only the touched entries: O(deliveries),
            # not O(N*S*K), per round
            np.add.at(self.cm.tags, idx, TAG_BUMP)
            self.cm.tags[idx] = np.minimum(self.cm.tags[idx], TAG_CAP)
        self.cm.maybe_decay(new.tick)

    def tags_for(self, peer: int) -> np.ndarray:
        return self.cm.tags[peer]
