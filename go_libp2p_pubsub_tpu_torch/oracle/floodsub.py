"""Scalar FloodSub oracle with the simulator's synchronous-round timing.

Per-node behavior transcribed from floodsub.go:76-100 (forward to every
topic peer except source and origin) + the seen-cache dedup of
pubsub.go:1076-1081 + validation gating (invalid => mark seen, trace
Reject, do not forward — validation.go:309-351).

Deterministic (floodsub has no randomness), so the vectorized engine must
match it bit-for-bit: seen sets, first_round, first_edge (lowest arriving
edge slot wins a same-round tie), and all event counters.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..graph import Subscriptions, Topology
from ..trace.events import EV, N_EVENTS


@dataclass
class OracleMsg:
    slot: int
    topic: int
    origin: int
    birth: int
    valid: bool


@dataclass
class OracleFloodSub:
    topo: Topology
    subs: Subscriptions
    msg_slots: int = 128

    tick: int = 0
    msgs: dict = field(default_factory=dict)          # slot -> OracleMsg
    cursor: int = 0
    seen: list = None                                  # per node: set of slots
    fwd: list = None                                   # per node: set of slots to send this round
    first_round: dict = field(default_factory=dict)    # (node, slot) -> round
    first_edge: dict = field(default_factory=dict)     # (node, slot) -> edge k or -1
    events: list = None

    def __post_init__(self):
        n = self.topo.n_peers
        self.seen = [set() for _ in range(n)]
        self.fwd = [set() for _ in range(n)]
        self.events = [0] * N_EVENTS

    # -- publishing ---------------------------------------------------------

    def _recycle(self, slot: int) -> None:
        if slot in self.msgs:
            del self.msgs[slot]
        for i in range(self.topo.n_peers):
            self.seen[i].discard(slot)
            self.fwd[i].discard(slot)
            self.first_round.pop((i, slot), None)
            self.first_edge.pop((i, slot), None)

    def publish(self, origin: int, topic: int, valid: bool = True) -> int:
        """Intern a publish; it starts transmitting next round (same timing
        as allocate_publishes after the delivery phase)."""
        slot = self.cursor % self.msg_slots
        self.cursor += 1
        self._recycle(slot)
        self.msgs[slot] = OracleMsg(slot, topic, origin, self.tick, valid)
        self.seen[origin].add(slot)
        self.fwd[origin].add(slot)
        self.first_round[(origin, slot)] = self.tick
        self.first_edge[(origin, slot)] = -1
        self.events[EV.PUBLISH_MESSAGE] += 1
        return slot

    # -- rounds -------------------------------------------------------------

    def _transmits(self):
        """Yield (receiver j, edge k, slot) for every wire transmission this
        round — mirrors delivery_round's trans tensor."""
        topo, subs = self.topo, self.subs
        for j in range(topo.n_peers):
            for k in range(topo.max_degree):
                if not topo.nbr_ok[j, k]:
                    continue
                s = int(topo.nbr[j, k])
                for slot in self.fwd[s]:
                    msg = self.msgs.get(slot)
                    if msg is None:
                        continue
                    # receiver must subscribe the topic (floodsub.go:77-84)
                    if not subs.subscribed[j, msg.topic]:
                        continue
                    # source exclusion: s never echoes on its arrival edge
                    if self.first_edge.get((s, slot)) == int(self.topo.rev[j, k]):
                        continue
                    # origin exclusion (floodsub.go:87)
                    if msg.origin == j:
                        continue
                    yield j, k, slot

    def step(self, publishes=()) -> None:
        """One round: deliver in-flight, then intern publishes.
        `publishes` is an iterable of (origin, topic, valid)."""
        arrivals: dict = {}  # (j, slot) -> [edge k...]
        n_rpc = 0
        for j, k, slot in self._transmits():
            arrivals.setdefault((j, slot), []).append(k)
            n_rpc += 1

        new_fwd = [set() for _ in range(self.topo.n_peers)]
        n_new = n_deliver = 0
        for (j, slot), edges in sorted(arrivals.items()):
            if slot in self.seen[j]:
                continue
            n_new += 1
            msg = self.msgs[slot]
            self.seen[j].add(slot)
            self.first_round[(j, slot)] = self.tick
            self.first_edge[(j, slot)] = min(edges)
            if msg.valid:
                n_deliver += 1
                new_fwd[j].add(slot)

        self.events[EV.DELIVER_MESSAGE] += n_deliver
        self.events[EV.REJECT_MESSAGE] += n_new - n_deliver
        self.events[EV.DUPLICATE_MESSAGE] += n_rpc - n_new
        self.events[EV.SEND_RPC] += n_rpc
        self.events[EV.RECV_RPC] += n_rpc

        self.fwd = new_fwd
        for origin, topic, valid in publishes:
            self.publish(origin, topic, valid)
        self.tick += 1

    def hops(self) -> dict:
        """(node, slot) -> propagation hops of the first receipt."""
        out = {}
        for (i, slot), r in self.first_round.items():
            msg = self.msgs.get(slot)
            if msg is not None:
                out[(i, slot)] = r - msg.birth
        return out
