"""Static topology builders (the port's own copy of the JAX package's
``graph.py``).

The reference wires real libp2p hosts with topology helpers `connect` /
`sparseConnect` (3 random links) / `denseConnect` (10) / `connectAll`
(floodsub_test.go:57-99). Here a topology is a padded adjacency structure —
the "peerstore + network" (survey L0) collapsed into arrays:

  nbr[N, K]   int32  neighbor peer id per slot, -1 = empty
  nbr_ok[N,K] bool   slot occupied (and peer connected)
  rev[N, K]   int32  reverse-edge slot: nbr[nbr[n,k], rev[n,k]] == n
  outbound[N,K] bool True where *we* dialed the connection (comm direction;
                     gossipsub.go's `outbound` map, used for the Dout quota
                     gossipsub.go:1401-1441)

`rev` is what lets every kernel be *gather-only*: a receiver reads its
senders' outboxes at [nbr[j,k], rev[j,k]] instead of senders scattering into
receiver inboxes. The graph is symmetric (libp2p connections are
bidirectional streams); direction is retained only in `outbound`.

Subscriptions use topic-slot compression so the 64-subnet Eth2 config
doesn't dense out: my_topics[N, S] holds each peer's subscribed topic ids
(-1 pad) and slot_of[N, T] inverts it; subscribed[N, T] is the global
bool view (the steady-state of the reference's SubOpts announcements,
pubsub.go:842-859 — announcements are modeled as instantaneous).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Topology:
    nbr: np.ndarray        # [N, K] int32, -1 pad
    nbr_ok: np.ndarray     # [N, K] bool
    rev: np.ndarray        # [N, K] int32 (undefined where ~nbr_ok)
    outbound: np.ndarray   # [N, K] bool
    degree: np.ndarray     # [N] int32

    @property
    def n_peers(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]


@dataclass(frozen=True)
class Subscriptions:
    subscribed: np.ndarray  # [N, T] bool — global steady-state view
    my_topics: np.ndarray   # [N, S] int32, -1 pad
    slot_of: np.ndarray     # [N, T] int32, -1 if not subscribed

    @property
    def n_topics(self) -> int:
        return self.subscribed.shape[1]

    @property
    def max_slots(self) -> int:
        return self.my_topics.shape[1]


# ---------------------------------------------------------------------------
# adjacency construction


def _from_edge_lists(n: int, dialed: "list[set[int]]", max_degree: int | None) -> Topology:
    """Build padded arrays from per-node dialed-edge sets (dialed[i] = peers i
    dialed). The symmetric closure defines connectivity; `outbound[i,k]` is
    True iff i dialed nbr[i,k]."""
    adj: list[list[int]] = [[] for _ in range(n)]
    out: list[list[bool]] = [[] for _ in range(n)]
    seen = [set() for _ in range(n)]
    for i in range(n):
        for j in sorted(dialed[i]):
            if j == i or j in seen[i]:
                continue
            seen[i].add(j)
            seen[j].add(i)
            adj[i].append(j)
            out[i].append(True)
            adj[j].append(i)
            out[j].append(False)

    deg = np.array([len(a) for a in adj], dtype=np.int32)
    K = int(deg.max()) if max_degree is None else max_degree
    if int(deg.max()) > K:
        raise ValueError(f"max degree {int(deg.max())} exceeds K={K}")

    nbr = np.full((n, K), -1, dtype=np.int32)
    outb = np.zeros((n, K), dtype=bool)
    for i in range(n):
        d = len(adj[i])
        nbr[i, :d] = adj[i]
        outb[i, :d] = out[i]
    nbr_ok = nbr >= 0

    # reverse-edge slots: rev[i,k] = slot of i in nbr[j]'s list
    slot_lookup = [{j: k for k, j in enumerate(adj[i])} for i in range(n)]
    rev = np.zeros((n, K), dtype=np.int32)
    for i in range(n):
        for k, j in enumerate(adj[i]):
            rev[i, k] = slot_lookup[j][i]

    return Topology(nbr=nbr, nbr_ok=nbr_ok, rev=rev, outbound=outb, degree=deg)


def connect_all(n: int, max_degree: int | None = None) -> Topology:
    """Complete graph (floodsub_test.go:94-99 connectAll). Each i<j edge is
    dialed by i."""
    dialed = [set(range(i + 1, n)) for i in range(n)]
    return _from_edge_lists(n, dialed, max_degree)


def random_connect(n: int, d: int, seed: int = 0, max_degree: int | None = None) -> Topology:
    """Each host dials d random others (sparseConnect d=3 / denseConnect d=10,
    floodsub_test.go:57-92). Degree after symmetrization is ~2d, bounded by
    construction at d + incoming."""
    rng = np.random.default_rng(seed)
    dialed: list[set[int]] = [set() for _ in range(n)]
    for i in range(n):
        picks = rng.choice(n - 1, size=min(d, n - 1), replace=False)
        for p in picks:
            dialed[i].add(int(p) + (int(p) >= i))
    return _from_edge_lists(n, dialed, max_degree)


def ring_lattice(n: int, d: int, max_degree: int | None = None) -> Topology:
    """Deterministic ring lattice (each node dials its next d ring
    neighbors); used for reproducible small tests and the scale bench.

    Built in *offset-canonical* slot order — slot k holds ring offset
    +1..+d then -1..-d for every node — so the topology is detectable as
    banded-regular (ops/edges.detect_banded): every cross-peer exchange
    then compiles to static rolls instead of gathers, which profiled ~9x
    faster on TPU. Requires 2d < n (otherwise offsets collide and we fall
    back to the generic builder)."""
    if n <= 2 * d:
        dialed = [set(((i + 1 + o) % n) for o in range(d)) for i in range(n)]
        return _from_edge_lists(n, dialed, max_degree)
    k = 2 * d
    if max_degree is not None:
        if max_degree < k:
            raise ValueError(f"max degree {k} exceeds K={max_degree}")
        # padding slots beyond 2d breaks detect_banded (absent edges), so
        # the extra capacity costs the roll fast path — callers wanting
        # banded speed should leave max_degree unset
        k = max_degree
    offs = np.array([i + 1 for i in range(d)] + [-(i + 1) for i in range(d)],
                    np.int64)
    nbr = np.full((n, k), -1, np.int32)
    rev = np.zeros((n, k), np.int32)
    outb = np.zeros((n, k), bool)
    nbr[:, : 2 * d] = (np.arange(n)[:, None] + offs[None, :]) % n
    # the reverse of offset +i (slot i-1) is offset -i (slot d+i-1)
    rev[:, : 2 * d] = np.array(
        [kk + d for kk in range(d)] + [kk for kk in range(d)], np.int32
    )[None, :]
    outb[:, :d] = True  # the d dialed (+offset) edges
    return Topology(
        nbr=nbr, nbr_ok=nbr >= 0, rev=rev, outbound=outb,
        degree=np.full((n,), 2 * d, np.int32),
    )


def dormant_edges(topo: Topology, frac: float, seed: int = 0) -> np.ndarray:
    """[N, K] bool, symmetric over the edge involution: a random ``frac`` of
    the undirected edges marked *dormant* — provisioned slots of the padded
    adjacency that start disconnected and that PX can activate at runtime
    (pxConnect, gossipsub.go:861-941). One ``rng.random()`` draw per
    undirected edge, taken from its low end in row-major (j, k) order, as
    the JAX package's loop draws them; drawn here in one call."""
    rng = np.random.default_rng(seed)
    own = topo.nbr_ok & (topo.nbr >= np.arange(topo.n_peers)[:, None])
    rows, cols = np.nonzero(own)                  # row-major order
    hit = rng.random(rows.size) < frac
    rows, cols = rows[hit], cols[hit]
    dormant = np.zeros(topo.nbr.shape, bool)
    dormant[rows, cols] = True
    dormant[topo.nbr[rows, cols], topo.rev[rows, cols]] = True
    return dormant


def from_edges(n: int, edges, max_degree: int | None = None) -> Topology:
    """Explicit dialed-edge list [(dialer, dialee), ...] — the analogue of
    the reference tests' hand-wired `connect(t, hosts[a], hosts[b])`
    sequences (e.g. gossipsub_test.go:903-911)."""
    dialed: list[set[int]] = [set() for _ in range(n)]
    for a, b in edges:
        dialed[a].add(b)
    return _from_edge_lists(n, dialed, max_degree)


def line(n: int, max_degree: int | None = None) -> Topology:
    """Path graph: i dials i+1 (TestGossipsubMultihops,
    gossipsub_test.go:853-894 — a 6-host chain). Propagation hop count
    equals graph distance."""
    dialed = [({i + 1} if i + 1 < n else set()) for i in range(n)]
    return _from_edge_lists(n, dialed, max_degree)


def tree(n: int, branching: int = 3, max_degree: int | None = None) -> Topology:
    """Rooted b-ary tree: each parent dials its children
    (TestGossipsubTreeTopology, gossipsub_test.go:896-941 uses a hand-built
    10-node tree; this is the generalized shape). Degree <= branching+1, so
    with default Dlo the mesh retains every tree edge and hop counts equal
    tree distance."""
    dialed: list[set[int]] = [set() for _ in range(n)]
    for i in range(1, n):
        dialed[(i - 1) // branching].add(i)
    return _from_edge_lists(n, dialed, max_degree)


def star(n: int, max_degree: int | None = None) -> Topology:
    """Hub-and-spoke: every leaf dials node 0 (TestGossipsubStarTopology,
    gossipsub_test.go:945-1024 — overlay bootstrapping through PRUNE-with-PX
    from a star)."""
    dialed = [set() for _ in range(n)]
    for i in range(1, n):
        dialed[i].add(0)
    return _from_edge_lists(n, dialed, max_degree)


# ---------------------------------------------------------------------------
# subscription construction


def subscribe_all(n: int, n_topics: int, max_slots: int | None = None) -> Subscriptions:
    """Every peer subscribes every topic (the common integration-test setup)."""
    if max_slots is None:
        max_slots = n_topics
    assert max_slots >= n_topics
    subscribed = np.ones((n, n_topics), dtype=bool)
    my_topics = np.full((n, max_slots), -1, dtype=np.int32)
    my_topics[:, :n_topics] = np.arange(n_topics, dtype=np.int32)[None, :]
    slot_of = np.tile(np.arange(n_topics, dtype=np.int32)[None, :], (n, 1))
    return Subscriptions(subscribed=subscribed, my_topics=my_topics, slot_of=slot_of)


def subscribe_random(n: int, n_topics: int, topics_per_peer: int, seed: int = 0,
                     max_slots: int | None = None) -> Subscriptions:
    """Each peer subscribes ``topics_per_peer`` uniform-random topics — the
    Eth2 attestation-subnet shape (BASELINE.json config 5: 64 subnets, a
    few per validator). The draws are numpy's ``default_rng(seed)``, peer by
    peer."""
    if max_slots is None:
        max_slots = topics_per_peer
    assert max_slots >= topics_per_peer
    rng = np.random.default_rng(seed)
    subscribed = np.zeros((n, n_topics), dtype=bool)
    my_topics = np.full((n, max_slots), -1, dtype=np.int32)
    slot_of = np.full((n, n_topics), -1, dtype=np.int32)
    for i in range(n):
        picks = rng.choice(n_topics, size=min(topics_per_peer, n_topics), replace=False)
        picks = np.sort(picks).astype(np.int32)
        my_topics[i, : len(picks)] = picks
        subscribed[i, picks] = True
        slot_of[i, picks] = np.arange(len(picks), dtype=np.int32)
    return Subscriptions(subscribed=subscribed, my_topics=my_topics, slot_of=slot_of)


def subscribe_mask(mask: np.ndarray, max_slots: int | None = None) -> Subscriptions:
    """Subscriptions from an explicit [N, T] bool mask: each peer's topics
    fill its slots in ascending topic order."""
    mask = np.asarray(mask, dtype=bool)
    n, n_topics = mask.shape
    deg = mask.sum(axis=1).astype(np.int32)
    if max_slots is None:
        max_slots = int(deg.max()) if n else 1
    over = np.flatnonzero(deg > max_slots)
    if over.size:
        i = int(over[0])
        raise ValueError(f"peer {i} subscribes {int(deg[i])} topics > max_slots={max_slots}")
    slot = np.cumsum(mask, axis=1, dtype=np.int32) - 1
    slot_of = np.where(mask, slot, -1).astype(np.int32)
    my_topics = np.full((n, max_slots), -1, dtype=np.int32)
    rows, tids = np.nonzero(mask)
    my_topics[rows, slot[rows, tids]] = tids.astype(np.int32)
    return Subscriptions(subscribed=mask.copy(), my_topics=my_topics, slot_of=slot_of)


def ip_groups_with_sybils(n: int, n_sybil_groups: int, sybil_frac: float,
                          seed: int = 0) -> np.ndarray:
    """Assign each peer an ip-group id (the P6 colocation key; the sim's
    analogue of the per-IP tracking at score.go:977-1074). Honest peers get
    unique groups; a `sybil_frac` tail shares `n_sybil_groups` groups."""
    rng = np.random.default_rng(seed)
    groups = np.arange(n, dtype=np.int32)
    n_sybil = int(n * sybil_frac)
    if n_sybil and n_sybil_groups:
        groups[n - n_sybil:] = (n - n_sybil) + rng.integers(0, n_sybil_groups, size=n_sybil)
    return groups
