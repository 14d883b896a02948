"""The port's topology generators, graph shapes and publish-burst workloads
against the JAX package's, byte for byte.

Twins of ``tests/test_topo.py``'s generator, link-class and workload cases
(determinism and the degree cap of ``powerlaw``, ``small_world`` and
``geo_clusters``, one edge list emitted as both layouts, the sparse
regime, sum-preserving link classes with their per-slot planes,
``publish_bursts``' patterns), of ``tests/test_topology.py``'s line and
tree hop laws and tree shape (the port's GossipSub step on the port's
``graph.line`` / ``graph.from_edges`` / ``graph.tree``) and of
``tests/test_graph.py``'s ``ip_groups_with_sybils``. Every edge list,
class plane, delay plane, topology and workload is also compared with the
JAX package's output for the same arguments.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.topo import workloads as jworkloads
from go_libp2p_pubsub_tpu_torch import graph, state, topo
from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
    GossipSubConfig,
    GossipSubState,
    make_gossipsub_step,
)
from go_libp2p_pubsub_tpu_torch.state import Net
from go_libp2p_pubsub_tpu_torch.topo import workloads
from go_libp2p_pubsub_tpu_torch.topo.generators import GEO_CLASS_LATENCY, link_class_planes

N = 128
CAP = 16

GENERATORS = [
    ("powerlaw", dict(exponent=2.2, d_min=2, max_degree=CAP)),
    ("small_world", dict(d=4, beta=0.2, max_degree=CAP)),
    ("geo", dict(n_clusters=4, d_local=4, d_regional=1, d_global=1)),
]
_NAME = {"geo": "geo_clusters"}


def gen(side, name: str, kw: dict, seed: int, n: int = N):
    mod = topo if side == "port" else jtopo
    return getattr(mod, _NAME.get(name, name))(n, seed=seed, **kw)


def same_edge_list(a, b):
    assert a.n == b.n and a.canonical_bytes() == b.canonical_bytes()
    assert a.edges.dtype == b.edges.dtype and a.edges.shape == b.edges.shape
    assert (a.link_class is None) == (b.link_class is None)
    if a.link_class is not None:
        assert a.link_class.dtype == b.link_class.dtype
        assert a.link_class.tobytes() == b.link_class.tobytes()
    assert a.class_latency == b.class_latency


def same_topology(a, b):
    for f in ("nbr", "nbr_ok", "rev", "outbound", "degree"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


# ---------------------------------------------------------------------------
# generator determinism and capacity bounds


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generator_deterministic_and_capped(name, kw):
    a, b = gen("port", name, kw, 7), gen("port", name, kw, 7)
    # same seed: byte-identical canonical edge list, and the JAX package's
    assert a.canonical_bytes() == b.canonical_bytes()
    same_edge_list(a, gen("jax", name, kw, 7))
    # a different seed moves it (the rng is consulted)
    assert a.canonical_bytes() != gen("port", name, kw, 8).canonical_bytes()
    # the degree cap at every node; no self or duplicate edges
    deg = a.degree
    cap = CAP if name != "geo" else a.max_degree
    assert deg.max() <= cap
    assert (a.edges[:, 0] < a.edges[:, 1]).all()
    assert len({tuple(e) for e in a.edges}) == a.n_undirected
    # the graph is usable: nobody isolated, edges exist
    assert a.n_undirected > 0
    assert deg.min() >= 1
    # both emissions of the same list are the JAX package's
    same_topology(topo.to_topology(a), jtopo.to_topology(gen("jax", name, kw, 7)))


def test_generators_equal_reference_across_seeds_and_shapes():
    for seed in range(3):
        for n, kw in ((33, dict(d=2, beta=0.5)), (64, dict(d=3, beta=1.0, max_degree=6))):
            same_edge_list(topo.small_world(n, seed=seed, **kw),
                           jtopo.small_world(n, seed=seed, **kw))
        for n, kw in ((20, dict(n_clusters=2, d_local=3)), (50, dict(n_clusters=5)),
                      (40, dict(n_clusters=3, d_local=0, d_regional=4, d_global=2,
                                class_latency=(2, 3, 5)))):
            same_edge_list(topo.geo_clusters(n, seed=seed, **kw),
                           jtopo.geo_clusters(n, seed=seed, **kw))
    with pytest.raises(ValueError, match="below the seed ring"):
        topo.small_world(32, d=4, max_degree=6)
    with pytest.raises(ValueError, match="2 clusters"):
        topo.geo_clusters(32, n_clusters=1)
    with pytest.raises(ValueError, match="2 clusters"):
        topo.attach_latency_classes(topo.powerlaw(32, seed=0), n_clusters=1)


def test_one_edge_list_two_emissions_identical_graph():
    """Both layouts are built from ONE Topology whose adjacency is a
    deterministic function of the canonical edge list."""
    el = topo.powerlaw(N, exponent=2.2, d_min=2, max_degree=CAP, seed=3)
    t1, net_d, net_c = topo.build_nets(el, graph.subscribe_all(N, 1), max_degree=CAP,
                                       device="cpu")
    t2 = topo.to_topology(el, max_degree=CAP)
    assert t1.nbr.tobytes() == t2.nbr.tobytes()
    assert t1.rev.tobytes() == t2.rev.tobytes()
    assert torch.equal(net_d.nbr, net_c.nbr)
    assert net_d.edge_layout == "dense" and net_c.edge_layout == "csr"
    assert int(net_c.n_edges) == int(t1.nbr_ok.sum()) == 2 * el.n_undirected


def test_powerlaw_is_the_sparse_regime():
    """mean degree << K: the density the sparse plane wins on."""
    el = topo.powerlaw(2048, exponent=2.2, d_min=2, max_degree=64, seed=0)
    assert el.max_degree <= 64
    assert el.mean_degree < 64 * 0.25
    assert el.degree.max() >= 4 * el.mean_degree


# ---------------------------------------------------------------------------
# geo link classes


def test_geo_link_classes_sum_preserving():
    kw = dict(n_clusters=4, d_local=4, d_regional=2, d_global=1, seed=5)
    el = topo.geo_clusters(N, **kw)
    jel = jtopo.geo_clusters(N, **kw)
    same_edge_list(el, jel)
    counts = np.bincount(el.link_class, minlength=3)
    # every edge in exactly one class, all three at this shape
    assert counts.sum() == el.n_undirected
    assert (el.link_class >= 0).all() and (el.link_class <= 2).all()
    assert (counts > 0).all()

    t = topo.to_topology(el)
    cls, lat = link_class_planes(el, t)
    # the class plane covers exactly the present slots, symmetric over the
    # involution, the latency plane mapped through class_latency
    assert ((cls >= 0) == t.nbr_ok).all()
    j, k = np.nonzero(t.nbr_ok)
    assert (cls[j, k] == cls[t.nbr[j, k], t.rev[j, k]]).all()
    for c, rounds in enumerate(el.class_latency):
        assert (lat[cls == c] == rounds).all()
    assert (lat[~t.nbr_ok] == 0).all()
    np.testing.assert_array_equal(np.bincount(cls[cls >= 0], minlength=3), counts * 2)
    # the vectorised planes are the reference loop's, byte for byte
    for got, want in zip((cls, lat), jtopo.generators.link_class_planes(jel, jtopo.to_topology(jel))):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for got, want in zip(topo.link_delay_plane(el, t),
                         jtopo.link_delay_plane(jel, jtopo.to_topology(jel))):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def test_latency_classes_on_classless_graphs_equal_reference():
    for name, kw in GENERATORS[:2]:
        for n_clusters in (2, 3, 8):
            el = topo.attach_latency_classes(gen("port", name, kw, 1), n_clusters=n_clusters)
            jel = jtopo.attach_latency_classes(gen("jax", name, kw, 1), n_clusters=n_clusters)
            same_edge_list(el, jel)
            t, jt = topo.to_topology(el, max_degree=CAP), jtopo.to_topology(jel, max_degree=CAP)
            for got, want in zip(topo.link_delay_plane(el, t), jtopo.link_delay_plane(jel, jt)):
                assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    with pytest.raises(ValueError, match="no link classes"):
        link_class_planes(topo.powerlaw(32, seed=0), topo.to_topology(topo.powerlaw(32, seed=0)))
    assert GEO_CLASS_LATENCY == jtopo.generators.GEO_CLASS_LATENCY


# ---------------------------------------------------------------------------
# the workload plane


def test_publish_bursts_patterns_and_determinism():
    assert workloads.PATTERNS == jworkloads.PATTERNS
    for pat in workloads.PATTERNS:
        a = topo.publish_bursts(pat, 32, 8, N, seed=3)
        b = topo.publish_bursts(pat, 32, 8, N, seed=3)
        for x, y, z in zip(a, b, jtopo.publish_bursts(pat, 32, 8, N, seed=3)):
            assert x.tobytes() == y.tobytes() == z.tobytes() and x.dtype == z.dtype
        po, pt, pv = a
        assert po.shape == (32, 8) and pv.all()
        assert ((po >= -1) & (po < N)).all()
        for kw in (dict(n_topics=4, base_rate=3), dict(period=5, burst_len=3, onset=4,
                                                     duration=9, seed=9)):
            for x, z in zip(topo.publish_bursts(pat, 24, 6, N, **kw),
                            jtopo.publish_bursts(pat, 24, 6, N, **kw)):
                assert x.tobytes() == z.tobytes()

    po, _, _ = topo.publish_bursts("attestation_storm", 32, 8, N, seed=1, period=8,
                                   burst_len=2, base_rate=1)
    width = (po >= 0).sum(axis=1)
    assert (width[(np.arange(32) % 8) < 2] == 8).all()
    assert (width[(np.arange(32) % 8) >= 2] == 1).all()

    po, pt, _ = topo.publish_bursts("flash_crowd", 30, 6, N, seed=1, onset=10, duration=5,
                                    base_rate=2)
    width = (po >= 0).sum(axis=1)
    assert (width[10:15] == 6).all()
    assert (pt[10:15][po[10:15] >= 0] == 0).all()
    assert (width[:10] == 2).all() and (width[15:] == 2).all()

    for bad, match in ((dict(pattern="nope"), "unknown pattern"),
                       (dict(pattern="steady", base_rate=5), "base_rate")):
        kw = dict(dict(rounds=8, width=4, n_peers=N), **bad)
        with pytest.raises(ValueError, match=match):
            topo.publish_bursts(**kw)


# ---------------------------------------------------------------------------
# the structural shapes: line, tree, star (tests/test_topology.py)


def _build(t, msg_slots=32, seed=0):
    net = Net.build(t, graph.subscribe_all(t.n_peers, 1), device="cpu")
    cfg = GossipSubConfig.build()
    return GossipSubState.init(net, msg_slots, cfg, seed=seed), make_gossipsub_step(cfg, net)


def _rows(origins=()):
    po = torch.full((4,), -1, dtype=torch.int32)
    pt = torch.full((4,), -1, dtype=torch.int32)
    pv = torch.zeros(4, dtype=torch.bool)
    for i, o in enumerate(origins):
        po[i], pt[i], pv[i] = o, 0, True
    return po, pt, pv


def _run(step, st, rounds, rows=None):
    for _ in range(rounds):
        st = step(st, *(rows or _rows()))
    return st


def _bfs_dist(t, src):
    dist = np.full(t.n_peers, -1, np.int64)
    dist[src] = 0
    frontier = [src]
    while frontier:
        nxt = []
        for i in frontier:
            for j in t.nbr[i][t.nbr_ok[i]]:
                if dist[j] < 0:
                    dist[j] = dist[i] + 1
                    nxt.append(int(j))
        frontier = nxt
    return dist


def test_multihop_line_hop_law():
    # the 6-host chain (gossipsub_test.go:853-894): each node's arrival
    # round is its distance from the origin
    t = graph.line(6)
    same_topology(t, jgraph.line(6))
    st, step = _build(t)
    st = _run(step, st, 8)   # mesh warm-up: degree <= 2 grafts every edge
    assert (st.mesh[:, 0, :].sum(1).numpy() == t.degree).all(), "line mesh must be the line"
    st = _run(step, step(st, *_rows([0])), 8)
    h = state.hops(st.core.msgs, st.core.dlv).numpy()[:, 0]
    assert (h == _bfs_dist(t, 0)).all()


def test_tree_topology_hop_law():
    # the reference's hand-built 10-node tree (gossipsub_test.go:903-921)
    edges = [(0, 1), (1, 2), (1, 4), (2, 3), (0, 5), (5, 6), (5, 8), (6, 7), (8, 9)]
    t = graph.from_edges(10, edges)
    same_topology(t, jgraph.from_edges(10, edges))
    st, step = _build(t)
    st = _run(step, st, 8)
    assert int(st.mesh[:, 0, :].sum()) == 2 * len(edges), "tree mesh must be the whole tree"
    # checkMessageRouting publishes from 9 and 3 (gossipsub_test.go:940)
    for origin, slot in ((9, 0), (3, 1)):
        st = _run(step, step(st, *_rows([origin])), 8)
        h = state.hops(st.core.msgs, st.core.dlv).numpy()[:, slot]
        assert (h == _bfs_dist(t, origin)).all()


def test_tree_generator_shape():
    t = graph.tree(13, branching=3)
    same_topology(t, jgraph.tree(13, branching=3))
    deg = t.degree
    assert deg[0] == 3            # root: 3 children
    assert deg.max() == 4         # internal: parent + 3 children
    assert (deg >= 1).all()
    d = _bfs_dist(t, 0)
    assert d.max() == 2 and (d >= 0).all()
    for n, kw in ((1, {}), (2, {}), (30, dict(branching=2)), (7, dict(max_degree=8))):
        same_topology(graph.tree(n, **kw), jgraph.tree(n, **kw))
        kw.pop("branching", None)
        same_topology(graph.line(n, **kw), jgraph.line(n, **kw))
    # the star: every leaf dials the hub
    s = graph.star(9)
    same_topology(s, jgraph.star(9))
    assert s.degree[0] == 8 and (s.degree[1:] == 1).all() and not s.outbound[0].any()


def test_ip_groups_with_sybils():
    g = graph.ip_groups_with_sybils(100, n_sybil_groups=2, sybil_frac=0.2, seed=0)
    honest, sybil = g[:80], g[80:]
    assert len(np.unique(honest)) == 80
    assert len(np.unique(sybil)) <= 2
    for args in ((100, 2, 0.2, 0), (64, 3, 0.5, 7), (10, 0, 0.3, 1), (50, 4, 0.0, 2)):
        got, want = graph.ip_groups_with_sybils(*args), jgraph.ip_groups_with_sybils(*args)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
