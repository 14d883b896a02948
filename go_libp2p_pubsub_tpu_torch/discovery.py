"""Discovery pipeline: advertise / find / bootstrap (reference discovery.go).

The reference's discovery subsystem is pure control plane: it advertises
joined topics to an external discovery service under the "floodsub:"-prefixed
namespace (discovery.go:318-328), polls every DiscoveryPollInterval asking
the router `EnoughPeers(topic, 0)` and kicks off FindPeers+connect for
starving topics (discovery.go:105-144), and `Bootstrap` spins
check-ready/discover/100ms-wait until a `RouterReady` predicate — usually
`MinTopicSize` (discovery.go:76-82) — says the router can publish
(discovery.go:239-295). Connections go through a cached exponential-backoff
connector (min 10s, max 1h, multiplier 5, full jitter — discovery.go:34-47).

Framing: none of this belongs on-device — exactly as in the reference it
is host-side orchestration around the (compiled) router. Here the session
drives topology *assembly*: it runs before `Network.start()` freezes the
adjacency into build constants, repeatedly connecting starving topics; time is
quantized to poll ticks (1 tick = DiscoveryPollInterval = 1s). After start()
`enough_peers` evaluates against live device state (mesh occupancy), so
publish-readiness gating keeps working, but new edges require a rebuild —
`Network.restart()` re-freezes with the grown topology.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np

# discovery.go:21 — poll cadence; our unit of discovery time
POLL_INTERVAL_TICKS = 1
# floodsub.go:13
FLOODSUB_TOPIC_SEARCH_SIZE = 5
# randomsub.go:17
RANDOMSUB_D = 6
# discovery.go:36 (10s..1h in seconds ≡ ticks), multiplier discovery.go:40
BACKOFF_MIN_TICKS = 10
BACKOFF_MAX_TICKS = 3600
BACKOFF_MULTIPLIER = 5.0
# default advertisement TTL (libp2p discovery convention: 3h) in ticks
DEFAULT_ADVERTISE_TTL = 3 * 3600


def namespace(topic: str) -> str:
    """Rendezvous namespace for a topic (discovery.go:322, 326)."""
    return "floodsub:" + topic


class Discovery:
    """Service interface (libp2p discovery.Discovery shape): subclass or
    duck-type with `advertise(ns, peer_id, ttl) -> ttl` and
    `find_peers(ns, limit) -> iterable of peer ids`."""

    def advertise(self, ns: str, peer_id: bytes, ttl: int = DEFAULT_ADVERTISE_TTL) -> int:
        raise NotImplementedError

    def find_peers(self, ns: str, limit: int = 0) -> Iterable[bytes]:
        raise NotImplementedError


@dataclasses.dataclass
class _Registration:
    peer_id: bytes
    expire_tick: int


class MemoryDiscovery(Discovery):
    """In-memory rendezvous service with TTL records — the test-harness
    discovery server of the reference (discovery_test.go:27-73), promoted to
    a first-class single-process implementation. Time = discovery ticks,
    advanced by the session (or manually via `advance`)."""

    def __init__(self):
        self._db: dict[str, dict[bytes, _Registration]] = {}
        self.tick = 0

    def advertise(self, ns: str, peer_id: bytes, ttl: int = DEFAULT_ADVERTISE_TTL) -> int:
        self._db.setdefault(ns, {})[peer_id] = _Registration(peer_id, self.tick + ttl)
        return ttl

    def find_peers(self, ns: str, limit: int = 0) -> list[bytes]:
        regs = self._db.get(ns, {})
        alive = [r.peer_id for r in regs.values() if r.expire_tick > self.tick]
        if limit and len(alive) > limit:
            alive = alive[:limit]
        return alive

    def has_peer_record(self, ns: str, peer_id: bytes) -> bool:
        r = self._db.get(ns, {}).get(peer_id)
        return r is not None and r.expire_tick > self.tick

    def unregister(self, ns: str, peer_id: bytes) -> None:
        self._db.get(ns, {}).pop(peer_id, None)

    def advance(self, ticks: int = 1) -> None:
        self.tick += ticks


class BackoffConnector:
    """Per-candidate exponential backoff for discovery dials
    (discovery.go:34-47: 10s → 1h, ×5, full jitter)."""

    def __init__(self, seed: int = 0,
                 min_ticks: int = BACKOFF_MIN_TICKS,
                 max_ticks: int = BACKOFF_MAX_TICKS,
                 multiplier: float = BACKOFF_MULTIPLIER):
        self._rng = np.random.default_rng(seed)
        self._min, self._max, self._mult = min_ticks, max_ticks, multiplier
        # (src, dst) -> (attempt_count, earliest_next_tick)
        self._state: dict[tuple[int, int], tuple[int, int]] = {}

    def may_dial(self, src: int, dst: int, tick: int) -> bool:
        _, next_ok = self._state.get((src, dst), (0, 0))
        return tick >= next_ok

    def record_dial(self, src: int, dst: int, tick: int) -> None:
        attempts, _ = self._state.get((src, dst), (0, 0))
        base = min(self._min * (self._mult ** attempts), self._max)
        delay = int(self._rng.uniform(0, base))  # full jitter
        self._state[(src, dst)] = (attempts + 1, tick + max(1, delay))

    def reset(self, src: int, dst: int) -> None:
        self._state.pop((src, dst), None)


RouterReady = Callable[["DiscoverySession", str], bool]


def min_topic_size(size: int) -> RouterReady:
    """RouterReady predicate: ready when the router has `size` usable topic
    peers — the suggestion is forwarded to EnoughPeers (discovery.go:76-82)."""

    def ready(sess: "DiscoverySession", topic: str) -> bool:
        return any(
            sess.enough_peers(node, topic, size)
            for node in sess.net.nodes
            if topic in node.topics
        )

    return ready


class DiscoverySession:
    """Binds a Discovery service to a Network (WithDiscovery,
    pubsub.go option + discovery.go Start).

    Lifecycle: `Network(discovery=service)` constructs one; `node.join`
    advertises (topic.go relies on disc.Advertise at discovery.go:175-216);
    `bootstrap()` / `poll()` grow the topology pre-start; after start,
    `enough_peers` reads live mesh state for publish gating."""

    def __init__(self, net, service: Discovery, seed: int = 0):
        self.net = net            # the api.Network (weak protocol coupling)
        self.service = service
        self.connector = BackoffConnector(seed=seed)
        self.tick = 0
        self._advertising: set[tuple[int, str]] = set()

    # -- advertising (discovery.go:175-228) --------------------------------

    def advertise(self, node, topic: str) -> None:
        key = (node.idx, topic)
        if key in self._advertising:
            return
        self._advertising.add(key)
        self.service.advertise(namespace(topic), node.identity.peer_id)

    def stop_advertise(self, node, topic: str) -> None:
        self._advertising.discard((node.idx, topic))
        unreg = getattr(self.service, "unregister", None)
        if unreg is not None:
            unreg(namespace(topic), node.identity.peer_id)

    def _readvertise(self) -> None:
        for idx, topic in self._advertising:
            self.service.advertise(namespace(topic), self.net.nodes[idx].peer_id)

    # -- EnoughPeers (per-router) ------------------------------------------

    def _topic_peer_protocols(self, node, topic: str) -> list[int]:
        """Protocol codes of peers this node is connected to that it knows
        are subscribed to `topic` (the reference's `p.topics[topic]` map
        filtered to the router's peer set)."""
        tid = self.net.topic_ids.get(topic)
        if tid is None:
            return []
        out = []
        for other in self.net.nodes:
            if other is node or not self.net.are_connected(node, other):
                continue
            if not getattr(other, "up", True):
                continue
            if any(t.tid == tid for t in other.topics.values()):
                out.append({"/floodsub/1.0.0": 0, "/meshsub/1.0.0": 1,
                            "/meshsub/1.1.0": 2}[other.protocol])
        return out

    def enough_peers(self, node, topic: str, suggested: int = 0) -> bool:
        protos = self._topic_peer_protocols(node, topic)
        if not protos:
            return False
        router = self.net.router
        if router == "floodsub":
            # floodsub.go:52-68
            need = suggested or FLOODSUB_TOPIC_SEARCH_SIZE
            return len(protos) >= need
        if router == "randomsub":
            # randomsub.go:58-90: fs+rs >= suggested(D) or rs >= D
            fs = sum(1 for p in protos if p == 0)
            rs = len(protos) - fs
            need = suggested or RANDOMSUB_D
            return fs + rs >= need or rs >= RANDOMSUB_D
        # gossipsub.go:554-581: fsPeers + |mesh[topic]| >= suggested(Dlo),
        # or |mesh| >= Dhi
        fs = sum(1 for p in protos if p == 0)
        gs = self._mesh_size(node, topic)
        if gs is None:  # pre-start: all mesh-capable connected topic peers
            gs = sum(1 for p in protos if p != 0)
        need = suggested or self.net.params.Dlo
        return fs + gs >= need or gs >= self.net.params.Dhi

    def _mesh_size(self, node, topic: str) -> int | None:
        """Live |mesh[topic]| once the engine is running; None pre-start."""
        if not self.net.started or not hasattr(self.net.state, "mesh"):
            return None
        tid = self.net.topic_ids.get(topic)
        slot = int(self.net.net.slot_of[node.idx, tid])
        if slot < 0:
            return 0
        # one row of each plane crosses to the host, not the whole plane
        mesh = self.net.state.mesh[node.idx, slot]  # [K] bool
        nbr_ok = self.net.net.nbr_ok[node.idx]
        return int((mesh & nbr_ok).sum())

    # -- polling / bootstrap (discovery.go:105-144, 239-295) ---------------

    def poll_once(self) -> int:
        """One DiscoveryPollInterval tick: for every joined (node, topic)
        where the router is starving, FindPeers and dial new candidates
        through the backoff connector. Returns number of new connections."""
        self.tick += 1
        if hasattr(self.service, "advance"):
            self.service.advance(POLL_INTERVAL_TICKS)
        made = 0
        by_pid = {n.identity.peer_id: n for n in self.net.nodes}
        for node in self.net.nodes:
            for topic in list(node.topics):
                if self.enough_peers(node, topic, 0):
                    continue
                for pid in self.service.find_peers(namespace(topic)):
                    cand = by_pid.get(pid)
                    if cand is None or cand is node:
                        continue
                    if self.net.are_connected(node, cand):
                        continue
                    if not self.connector.may_dial(node.idx, cand.idx, self.tick):
                        continue
                    self.connector.record_dial(node.idx, cand.idx, self.tick)
                    if self.net.started:
                        continue  # frozen topology: needs restart() to apply
                    self.net.connect(node, cand)
                    made += 1
        return made

    def bootstrap(self, topic: str, ready: RouterReady | None = None,
                  max_polls: int = 100) -> bool:
        """Discover until `ready` (default: any subscriber has EnoughPeers
        with suggestion 0). Mirrors discover.Bootstrap's
        check-ready → discover → wait loop (discovery.go:239-295)."""
        if ready is None:
            ready = min_topic_size(0)
        for _ in range(max_polls):
            if ready(self, topic):
                return True
            self._readvertise()
            self.poll_once()
        return ready(self, topic)
