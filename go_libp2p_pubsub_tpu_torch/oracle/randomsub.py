"""Scalar RandomSub oracle with the simulator's synchronous-round timing.

Per-node behavior from randomsub.go:99-160: each sender forwards every
in-flight message to a random sample of *gossip-capable* subscribed
neighbors, while neighbors speaking only /floodsub/1.0.0 always receive
(the peer-list split at randomsub.go:107-131); a floodsub-only sender
runs the floodsub router and forwards to every subscribed neighbor.

Sample-size note (scoping the parity claim): the reference sizes the
sample as max(RandomSubD, ceil(sqrt(size))) where `size` is the static
network-size estimate passed to NewRandomSub (randomsub.go:61-67,
124-127) — NOT the topic's subscriber count. This oracle and the engine
default to the per-topic gossip-capable subscriber count (a refinement
the reference cannot compute locally) and match each other by
construction; pass `size_estimate` to both to reproduce the reference's
exact sizing.

Everything but the transmit selection — seen-cache dedup, source/origin
exclusion, validation gating, event accounting — is inherited from the
floodsub oracle (the same shared-delivery semantics the vectorized
engine shares across routers).

RNG streams cannot match the batched engine, so parity is distributional
(propagation-latency CDFs), like the gossipsub oracle.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from .floodsub import OracleFloodSub


@dataclass
class OracleRandomSub(OracleFloodSub):
    d: int = 6                      # RandomSubD, randomsub.go:17
    protocol: np.ndarray = None     # [N] i8; None = all gossip-capable
    seed: int = 0
    size_estimate: int | None = None  # NewRandomSub's `size` (see module doc)

    def __post_init__(self):
        super().__post_init__()
        n = self.topo.n_peers
        if self.protocol is None:
            self.protocol = np.full((n,), 2, np.int8)
        self.rng = random.Random(self.seed)
        if self.size_estimate is not None:
            # the reference's static estimate (randomsub.go:124-127)
            gs_size = np.full(
                (np.asarray(self.subs.subscribed).shape[1],),
                self.size_estimate, np.int64,
            )
        else:
            # per-topic target over gossip-capable subscribers only
            gs_size = (
                np.asarray(self.subs.subscribed) & (self.protocol >= 1)[:, None]
            ).sum(axis=0)
        self.target_t = np.maximum(self.d, np.ceil(np.sqrt(gs_size))).astype(int)

    def _sender_targets(self, s: int, topic: int):
        """Edge slots of s chosen to carry `topic` this round (fresh random
        draw per sender/topic/round, as in the vectorized step)."""
        topo = self.topo
        gossip, flood = [], []
        for k in range(topo.max_degree):
            if not topo.nbr_ok[s, k]:
                continue
            j = int(topo.nbr[s, k])
            if not self.subs.subscribed[j, topic]:
                continue
            (flood if self.protocol[j] == 0 else gossip).append(k)
        if self.protocol[s] == 0:
            return gossip + flood  # floodsub-only sender floods
        t = min(self.target_t[topic], len(gossip))
        return self.rng.sample(gossip, t) + flood

    def _transmits(self):
        """Sender-centric selection; yields the same (receiver j, receiver
        edge k, slot) triples the floodsub oracle's step() consumes."""
        topo = self.topo
        for s in range(topo.n_peers):
            if not self.fwd[s]:
                continue
            chosen_by_topic: dict = {}
            for slot in sorted(self.fwd[s]):
                msg = self.msgs.get(slot)
                if msg is None:
                    continue
                if msg.topic not in chosen_by_topic:
                    chosen_by_topic[msg.topic] = self._sender_targets(s, msg.topic)
                for k in chosen_by_topic[msg.topic]:
                    j = int(topo.nbr[s, k])
                    # source exclusion: never echo on the arrival edge
                    if self.first_edge.get((s, slot)) == k:
                        continue
                    if msg.origin == j:
                        continue
                    yield j, int(topo.rev[s, k]), slot
