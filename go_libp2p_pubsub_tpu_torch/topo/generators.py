"""Topology generators: one canonical edge list, two emissions (the port's
own copy of the JAX package's ``topo/generators.py``).

A generator produces an :class:`EdgeList` — a deterministic,
seed-reproducible array of undirected ``(a, b)`` pairs (``a < b``,
lexicographically sorted), with optional per-edge link classes — and the
emission helpers turn ONE edge list into both layouts:

  * :func:`to_topology` -> the dense-padded ``graph.Topology``;
  * :func:`build_nets` -> the ``(dense, csr)`` Net pair built from the
    SAME Topology object, so dense-vs-CSR runs see the byte-identical
    graph.

  powerlaw      capacity-bounded power-law: degrees drawn from a
                truncated zipf pmf ``P(d) ∝ d^-exponent`` on
                ``[d_min, max_degree]``, wired by seeded stub matching
                with self/multi-edge rejection. The max-degree cap IS
                the padded K.
  small_world   Watts–Strogatz ring rewiring: a d-regular ring lattice
                whose far endpoints rewire with probability ``beta``,
                under the same capacity cap.
  geo_clusters  geographically clustered links with latency classes:
                peers in clusters, each dialing local / regional / global
                edges tagged class 0/1/2 with a per-class latency in
                rounds; every edge has exactly one class.

``attach_latency_classes`` gives a class-less edge list (a power-law
graph) the same classes from contiguous id-block clusters, and
``link_class_planes`` / ``link_delay_plane`` turn the classes into the
per-slot planes the router's latency ring reads.

``powerlaw``, ``to_topology`` and ``link_class_planes`` are vectorised
numpy that reproduce the JAX package's per-element Python loops exactly
(same random draws, same accept order, same slot order), so a
million-peer graph builds in seconds; ``small_world`` and ``geo_clusters``
keep the reference's loops, whose random draws interleave (a draw per
edge and bounded retries; a sample without replacement per peer). The
edge lists, the Topology and the planes are byte-identical to the
reference's (tests/test_torch_floodsub.py, tests/test_torch_topo_gen.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import graph as graphlib

#: default per-class latency in rounds of the geo link classes (local
#: intra-cluster, regional neighbour-cluster, global long-haul)
GEO_CLASS_LATENCY = (1, 2, 8)


@dataclass(frozen=True)
class EdgeList:
    """Canonical undirected edge list (see module docstring)."""

    n: int
    edges: np.ndarray                     # [E_u, 2] i32, a < b, sorted
    link_class: np.ndarray | None = None  # [E_u] i8 (geo classes)
    class_latency: tuple | None = None    # rounds per class

    @property
    def n_undirected(self) -> int:
        return int(self.edges.shape[0])

    @property
    def degree(self) -> np.ndarray:
        """[N] i64 undirected degree."""
        return np.bincount(self.edges.reshape(-1), minlength=self.n)

    @property
    def max_degree(self) -> int:
        return int(self.degree.max()) if self.n_undirected else 0

    @property
    def mean_degree(self) -> float:
        return 2.0 * self.n_undirected / self.n

    def canonical_bytes(self) -> bytes:
        """The determinism pin: the byte-identical canonical form both
        emissions are built from."""
        return np.ascontiguousarray(self.edges, np.int32).tobytes()


def _canonical(n: int, pairs) -> np.ndarray:
    """Sorted [E_u, 2] i32 canonical form of a set of (a, b) pairs."""
    if not len(pairs):
        return np.zeros((0, 2), np.int32)
    return np.asarray(sorted({(min(a, b), max(a, b)) for a, b in pairs}), np.int32)


def _degree_sequence(rng, n: int, exponent: float, d_min: int,
                     d_max: int) -> np.ndarray:
    """Truncated-zipf degree sequence with an even stub total."""
    ds = np.arange(d_min, d_max + 1, dtype=np.float64)
    pmf = ds ** (-float(exponent))
    pmf /= pmf.sum()
    deg = rng.choice(ds.astype(np.int64), size=n, p=pmf)
    if deg.sum() % 2:  # stub matching needs an even total
        below = np.flatnonzero(deg < d_max)
        if below.size:
            deg[below[0]] += 1
        else:  # every node at the cap — the cap is hard, so shrink one
            deg[0] -= 1
    return deg


def _member(sorted_keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Which entries of ``q`` occur in the sorted array ``sorted_keys``."""
    if not sorted_keys.shape[0]:
        return np.zeros(q.shape, bool)
    pos = np.minimum(np.searchsorted(sorted_keys, q), sorted_keys.shape[0] - 1)
    return sorted_keys[pos] == q


def powerlaw(n: int, exponent: float = 2.2, d_min: int = 2,
             max_degree: int = 64, seed: int = 0,
             match_rounds: int = 64) -> EdgeList:
    """Capacity-bounded power-law graph (module docstring). Stub
    matching with rejection: unmatched conflicting stubs are re-shuffled
    ``match_rounds`` times, then dropped — degrees can only shrink, so
    the cap holds at every node by construction.

    Within a round the reference accepts pairs in index order, rejecting
    self pairs and pairs already wired (earlier rounds, or earlier in
    this round). So a pair is accepted iff it is not a self pair, its key
    was not wired before the round, and it is the first pair of the round
    with that key — which is what the vectorised form below computes."""
    if not 0 < d_min <= max_degree:
        raise ValueError(f"need 0 < d_min <= max_degree, got "
                         f"{d_min}/{max_degree}")
    rng = np.random.default_rng(seed)
    deg = _degree_sequence(rng, n, exponent, d_min, max_degree)
    stubs = np.repeat(np.arange(n, dtype=np.int64), deg)
    have = np.zeros(0, np.int64)   # sorted keys min * n + max
    for _ in range(match_rounds):
        if stubs.shape[0] < 2:
            break
        rng.shuffle(stubs)
        half = stubs.shape[0] // 2
        a, b = stubs[:half], stubs[half:2 * half]
        key = np.minimum(a, b) * n + np.maximum(a, b)
        cand = np.flatnonzero((a != b) & ~_member(have, key))
        new_keys, first = np.unique(key[cand], return_index=True)
        keep = np.ones(half, bool)
        keep[cand[first]] = False
        have = np.insert(have, np.searchsorted(have, new_keys), new_keys)
        # unmatched stubs (self/multi conflicts + the odd tail) retry
        leftovers = [a[keep], b[keep]]
        if stubs.shape[0] > 2 * half:
            leftovers.append(stubs[2 * half:])
        stubs = np.concatenate(leftovers)
    edges = np.stack([have // n, have % n], axis=1).astype(np.int32)
    return EdgeList(n=n, edges=edges.reshape(-1, 2))


def small_world(n: int, d: int = 4, beta: float = 0.1, seed: int = 0,
                max_degree: int | None = None) -> EdgeList:
    """Watts–Strogatz rewiring of a d-regular ring under a degree cap
    (default cap 2d + 4 slack: rewiring concentrates a few hubs). Each
    edge of the sorted ring draws once and a rewired one up to 8 retries,
    in the reference's order (one numpy stream)."""
    cap = max_degree if max_degree is not None else 2 * d + 4
    if cap < 2 * d:
        raise ValueError(f"max_degree {cap} is below the seed ring "
                         f"degree {2 * d} — the ring itself would "
                         f"violate the cap before any rewiring")
    rng = np.random.default_rng(seed)
    have = {(i, (i + o) % n) if i < (i + o) % n else ((i + o) % n, i)
            for i in range(n) for o in range(1, d + 1)}
    deg = np.bincount(np.asarray(sorted(have), np.int64).reshape(-1), minlength=n)
    for a, b in sorted(have):
        if rng.random() >= beta:
            continue
        # rewire the far endpoint b -> uniform c with spare capacity
        for _ in range(8):  # bounded retries, then keep the edge
            c = int(rng.integers(0, n))
            key = (min(a, c), max(a, c))
            if c == a or key in have or deg[c] >= cap:
                continue
            have.discard((a, b))
            deg[b] -= 1
            have.add(key)
            deg[c] += 1
            break
    return EdgeList(n=n, edges=_canonical(n, have))


def _cluster_classes(n: int, n_clusters: int, edges: np.ndarray) -> np.ndarray:
    """[E_u] i8 geo class of each edge under contiguous id-block clusters:
    0 in one cluster, 1 between adjacent clusters, 2 otherwise."""
    cluster = (np.arange(n, dtype=np.int64) * n_clusters) // n
    ca, cb = cluster[edges[:, 0]], cluster[edges[:, 1]]
    adj = np.minimum((ca - cb) % n_clusters, (cb - ca) % n_clusters) == 1
    return np.where(ca == cb, np.int8(0), np.where(adj, np.int8(1), np.int8(2))).astype(np.int8)


def geo_clusters(n: int, n_clusters: int = 8, d_local: int = 6,
                 d_regional: int = 2, d_global: int = 1, seed: int = 0,
                 class_latency: tuple = GEO_CLASS_LATENCY) -> EdgeList:
    """Geographically clustered topology with latency link classes
    (module docstring): class 0 (local) within a cluster, class 1
    (regional) between adjacent clusters, class 2 (global) the rest, so
    the per-class counts sum to E. Clusters are contiguous id blocks; each
    peer samples its local, regional and global dials without replacement,
    in the reference's order."""
    if n_clusters < 2:
        raise ValueError("geo_clusters needs >= 2 clusters")
    rng = np.random.default_rng(seed)
    cluster = (np.arange(n, dtype=np.int64) * n_clusters) // n
    members = [np.flatnonzero(cluster == c) for c in range(n_clusters)]
    have: set = set()

    def dial(i: int, pool: np.ndarray, count: int):
        pool = pool[pool != i]
        if pool.shape[0] == 0 or count <= 0:
            return
        picks = rng.choice(pool, size=min(count, pool.shape[0]), replace=False)
        for j in picks:
            have.add((min(i, int(j)), max(i, int(j))))

    all_ids = np.arange(n, dtype=np.int64)
    for i in range(n):
        c = int(cluster[i])
        dial(i, members[c], d_local)
        dial(i, np.concatenate([members[(c + 1) % n_clusters],
                                members[(c - 1) % n_clusters]]), d_regional)
        dial(i, all_ids, d_global)
    edges = _canonical(n, have)
    return EdgeList(n=n, edges=edges, link_class=_cluster_classes(n, n_clusters, edges),
                    class_latency=tuple(class_latency))


# ---------------------------------------------------------------------------
# emission: one canonical edge list -> both layouts


def to_topology(el: EdgeList, max_degree: int | None = None
                ) -> graphlib.Topology:
    """The dense-padded adjacency of an edge list: the same Topology as
    ``graph.from_edges`` on the canonical pairs. There, peer x's slots
    fill in the order the pairs are visited — first every (a, x) with
    a < x, then every (x, b) — so each row is its neighbours in ascending
    order, and x dialed (``outbound``) exactly those above it."""
    n = el.n
    e = np.asarray(el.edges, np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n).astype(np.int32)
    top = int(deg.max()) if n else 0
    k = top if max_degree is None else max_degree
    if top > k:
        raise ValueError(f"max degree {top} exceeds K={k}")
    start = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=start[1:])
    slot = np.arange(src.shape[0], dtype=np.int64) - start[src]
    nbr = np.full((n, k), -1, np.int32)
    nbr[src, slot] = dst
    outb = np.zeros((n, k), bool)
    outb[src, slot] = dst > src
    # rev: the slot of the reverse directed edge (dst, src) in dst's row
    key = src * n + dst
    back = np.searchsorted(key, dst * n + src)
    rev = np.zeros((n, k), np.int32)
    rev[src, slot] = slot[back]
    return graphlib.Topology(nbr=nbr, nbr_ok=nbr >= 0, rev=rev, outbound=outb,
                             degree=deg)


def build_nets(el: EdgeList, subs, max_degree: int | None = None, **net_kw):
    """(topology, dense, csr): the Net pair from ONE Topology built off
    the canonical edge list, so both layouts run the byte-identical graph
    (``net_kw`` goes to both builds, ``device=`` included)."""
    from ..state import Net

    topo = to_topology(el, max_degree=max_degree)
    dense = Net.build(topo, subs, **net_kw)
    csr = Net.build(topo, subs, edge_layout="csr", **net_kw)
    return topo, dense, csr


def link_class_planes(el: EdgeList, topo: graphlib.Topology) -> tuple[np.ndarray, np.ndarray]:
    """Per-directed-slot views of the geo link classes: ``(edge_class[N, K]
    i8, latency_rounds[N, K] i32)`` with -1 / 0 on absent slots. Each
    present slot (i, k) looks its undirected edge up in the sorted
    canonical list (one search for all N x K slots)."""
    if el.link_class is None:
        raise ValueError("edge list carries no link classes "
                         "(geo_clusters builds them)")
    n = el.n
    nbr = np.asarray(topo.nbr, np.int64)
    ok = np.asarray(topo.nbr_ok, bool)
    rows = np.broadcast_to(np.arange(nbr.shape[0], dtype=np.int64)[:, None], nbr.shape)
    e = np.asarray(el.edges, np.int64).reshape(-1, 2)
    keys = e[:, 0] * n + e[:, 1]          # ascending: the list is sorted
    q = np.minimum(rows, nbr)[ok] * n + np.maximum(rows, nbr)[ok]
    pos = np.searchsorted(keys, q)
    found = pos < keys.shape[0]
    found[found] = keys[pos[found]] == q[found]
    if not found.all():
        i, s = (int(v) for v in np.argwhere(ok)[np.flatnonzero(~found)[0]])
        raise KeyError((i, int(nbr[i, s])))
    cls = np.full(nbr.shape, -1, np.int8)
    cls[ok] = np.asarray(el.link_class, np.int8)[pos]
    lat = np.zeros(nbr.shape, np.int32)
    for c, rounds in enumerate(el.class_latency or GEO_CLASS_LATENCY):
        lat[cls == c] = rounds
    return cls, lat


def attach_latency_classes(el: EdgeList, n_clusters: int = 8,
                           class_latency: tuple = GEO_CLASS_LATENCY) -> EdgeList:
    """Geo latency classes for a class-less edge list (powerlaw,
    small_world): contiguous id-block clusters, the relabeling
    ``geo_clusters`` bakes, each edge classed by cluster adjacency (0
    local, 1 adjacent cluster, 2 long haul). No random draw: the graph is
    untouched, and the router plane's cells put power-law graphs on a
    geo-latency floor this way."""
    if n_clusters < 2:
        raise ValueError("attach_latency_classes needs >= 2 clusters")
    return EdgeList(n=el.n, edges=el.edges,
                    link_class=_cluster_classes(el.n, n_clusters, el.edges),
                    class_latency=tuple(class_latency))


def link_delay_plane(el: EdgeList, topo: graphlib.Topology) -> tuple[np.ndarray, int]:
    """The router plane's delay plane: ``(delay[N, K] i32, L)``, the
    per-slot latency normalised so the fastest class is delay 0 (the v1.1
    one-round hop; the ring models delay as extra rounds on top of it),
    absent slots 0, and ``L = delay.max()``, the ring depth of
    ``RouterConfig(latency_rounds=L)``."""
    _, lat = link_class_planes(el, topo)
    present = np.asarray(topo.nbr_ok, bool)
    base = int(lat[present].min()) if present.any() else 0
    delay = np.where(present, lat - base, 0).astype(np.int32)
    return delay, int(delay.max()) if present.any() else 0
