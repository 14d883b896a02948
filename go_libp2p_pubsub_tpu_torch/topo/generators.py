"""Topology generators: one canonical edge list, two emissions (the port's
own copy of the JAX package's ``topo/generators.py``, with the power-law
generator and the emission helpers).

A generator produces an :class:`EdgeList` — a deterministic,
seed-reproducible array of undirected ``(a, b)`` pairs (``a < b``,
lexicographically sorted) — and the emission helpers turn ONE edge list
into both layouts:

  * :func:`to_topology` -> the dense-padded ``graph.Topology``;
  * :func:`build_nets` -> the ``(dense, csr)`` Net pair built from the
    SAME Topology object, so dense-vs-CSR runs see the byte-identical
    graph.

  powerlaw      capacity-bounded power-law: degrees drawn from a
                truncated zipf pmf ``P(d) ∝ d^-exponent`` on
                ``[d_min, max_degree]``, wired by seeded stub matching
                with self/multi-edge rejection. The max-degree cap IS
                the padded K.

Both helpers are vectorised numpy that reproduce the JAX package's
per-element Python loops exactly (same random draws, same accept order,
same slot order), so a million-peer graph builds in seconds; the edge
list and the Topology are byte-identical to the reference's
(tests/test_torch_floodsub.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import graph as graphlib


@dataclass(frozen=True)
class EdgeList:
    """Canonical undirected edge list (see module docstring)."""

    n: int
    edges: np.ndarray   # [E_u, 2] i32, a < b, sorted

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
