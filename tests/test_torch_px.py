"""Peer exchange (PX) and edge liveness in both GossipSub engines of the
port, against the JAX package's, leaf by leaf, every round or phase.

A PRUNE carries PX (makePrune gossipsub.go:1814-1850) unless the pruner
rejects a graft for its score or prunes a negative score; a peer pruned
with PX by a pruner it scores at or above AcceptPXThreshold activates its
dormant provisioned edges to the pruner's mesh peers (handlePrune
:834-841, pxConnect :861-941), and direct edges are redialed every
DirectConnectTicks (:1606-1628). The nets start with 30% of their edges
dormant (``graph.dormant_edges``) and small mesh degrees (D = 3, Dhi = 4),
so over-subscription prunes carry PX from the first heartbeats. The
threshold, 0.5, sits inside the pruners' scores (0 to 1.5 at these
sizes): every PX run sees edges activated and PX refused. Cells: the
banded lattice (the kernels' plain versions), a random dense net and the
random net CSR-resident, in the per-round step and the phase engine;
``edge_liveness`` without PX; the direct redial; a PX window against its
eager loop. The port runs with ``device="cpu"``; no tolerance on any
leaf."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    phase_schedule,
    phases_against_reference,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step

N = 96
#: small mesh degrees: over-subscription prunes (which carry PX) every heartbeat
SMALL = dict(D=3, Dlo=2, Dhi=4, Dscore=2, Dout=1, Dlazy=3)
ACCEPT_PX = 0.5
DORMANT = 0.3


def topologies(kind: str):
    """(JAX Topology, port Topology) of one graph."""
    if kind == "lattice":
        return jgraph.ring_lattice(N, d=4), tgraph.ring_lattice(N, d=4)
    return jgraph.random_connect(N, 5, seed=1), tgraph.random_connect(N, 5, seed=1)


def px_builds(kind: str, layout: str = "dense", heartbeat_every: int = 1, **kw):
    """bench_builds with PX, the small degrees and AcceptPXThreshold 0.5 on
    ``kind``'s graph, and its dormant edges."""
    topos = topologies(kind)
    builds = bench_builds(n=N, topologies=topos, params=dict(do_px=True, **SMALL),
                          thresholds=dict(accept_px_threshold=ACCEPT_PX),
                          edge_layout=layout, fused=layout == "csr",
                          heartbeat_every=heartbeat_every, **kw)
    return builds, jgraph.dormant_edges(topos[0], DORMANT, seed=5)


class PxLog:
    """An ``observe`` callback: live edges after every round or phase, and
    the PX flags that arrived on a live edge from a pruner scored at or
    above the threshold (``accepted``) and below it (``refused``)."""

    def __init__(self, net):
        self.net = net
        self.prev = None
        self.live = []
        self.accepted = self.refused = 0

    def __call__(self, st):
        self.live.append(int(st.edge_live.sum()))
        p = self.prev
        if p is not None:
            sent = p.prune_px_out.any(1)
            came = torch.where(self.net.nbr_ok, self.net.edge_gather(sent), False) & p.edge_live
            self.accepted += int((came & (p.scores >= ACCEPT_PX)).sum())
            self.refused += int((came & (p.scores < ACCEPT_PX)).sum())
        self.prev = st

    def check(self, dormant):
        assert self.live[-1] > int((~dormant & self.net.nbr_ok.numpy()).sum()), self.live
        assert self.accepted > 0 and self.refused > 0, (self.accepted, self.refused)


@pytest.mark.parametrize("kind,layout,gater", [
    ("lattice", "dense", False), ("random", "dense", False), ("random", "csr", False),
    ("random", "dense", True),
], ids=["lattice-dense", "random-dense", "random-csr", "random-dense-gater"])
def test_px_rounds_equal_reference(kind, layout, gater):
    """The per-round step; the lattice takes ``edge_exchange`` (C = 5 with
    the px lane at one topic, M = 64) and ``fused_delivery`` with the live
    view as their live words. With the peer gater over shared ip groups
    (3 a group) its per-source share sums over the live edges only."""
    kw = {}
    if gater:
        kw = dict(gater={}, validation_capacity=2,
                  ip_group=(np.arange(N) // 3).astype(np.int32))
    builds, dormant = px_builds(kind, layout, **kw)
    log = PxLog(builds[4])
    # the CSR-resident case replays the dense case's JAX run (densified)
    rounds_against_reference(builds, 20, observe=log, dormant=dormant,
                             share=("px rounds", kind, gater))
    log.check(dormant)


@pytest.mark.parametrize("kind,layout,r", [
    ("lattice", "dense", 8), ("random", "dense", 2), ("random", "csr", 2),
])
def test_px_phases_equal_reference(kind, layout, r):
    """The phase engine with a heartbeat every phase: PX at the head, the
    px lane in the coalesced control exchange (C = 7 on the lattice), the
    data crossings under the live view."""
    builds, dormant = px_builds(kind, layout, heartbeat_every=r)
    log = PxLog(builds[4])
    phases_against_reference(builds, r, r, 24 if r == 8 else 20, observe=log,
                             dormant=dormant, share=("px phases", kind, r))
    log.check(dormant)


def test_edge_liveness_without_px():
    """``edge_liveness`` alone: dormant edges carry nothing and never
    activate, and no mesh forms across one (tests/test_px.py:116)."""
    topos = topologies("random")
    dormant = jgraph.dormant_edges(topos[0], 0.4, seed=2)
    builds = bench_builds(n=N, topologies=topos, options=dict(edge_liveness=True))
    st = rounds_against_reference(builds, 12, dormant=dormant)
    assert torch.equal(st.edge_live, builds[4].nbr_ok & ~torch.from_numpy(dormant))
    assert not (st.mesh.any(1) & torch.from_numpy(dormant)).any()
    assert int(st.mesh.sum()) > 0


def test_direct_redial_equals_reference():
    """The direct-peer redial every ``direct_connect_ticks`` = 5 wakes a
    dormant direct edge, both ways, at tick 5 and not before (tick 0 is
    skipped; tests/test_px.py:203)."""
    n = 16
    jt, tt = jgraph.random_connect(n, 4, seed=2), tgraph.random_connect(n, 4, seed=2)
    dormant = jgraph.dormant_edges(jt, 0.9, seed=3)
    i, k = np.argwhere(dormant & jt.nbr_ok)[0]
    j, rk = jt.nbr[i, k], jt.rev[i, k]
    direct = np.zeros(jt.nbr.shape, bool)
    direct[i, k] = direct[j, rk] = True
    builds = bench_builds(n=n, topologies=(jt, tt), direct=direct,
                          params=dict(do_px=True, direct_connect_ticks=5))
    seen = []
    st = rounds_against_reference(
        builds, 10, dormant=dormant,
        observe=lambda s: seen.append(bool(s.edge_live[i, k]) and bool(s.edge_live[j, rk])))
    # the heartbeat of tick 5 (the sixth round) redials
    assert seen == [False] * 5 + [True] * 5, seen
    assert int(st.core.tick) == 10


def test_px_window_equals_eager():
    """A PX phase run through ``driver.make_scan`` equals its eager loop,
    every leaf (on the card the window is a captured CUDA graph:
    chip_smoke.py)."""
    builds, dormant = px_builds("lattice", heartbeat_every=2)
    _j, _jn, _js, tcfg, tnet, tsp = builds
    tcfg = dataclasses.replace(tcfg, trace_exact=True, narrow_counters=True)
    step = make_gossipsub_phase_step(tcfg, tnet, 2, score_params=tsp)
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(N, 16))

    def fresh():
        return TState.init(tnet, 64, tcfg, score_params=tsp, seed=0, dormant=dormant)

    eager = fresh()
    for p in range(8):
        sl = slice(2 * p, 2 * p + 2)
        eager = step(eager, po[sl], pt[sl], pv[sl], do_heartbeat=True)
    got = driver.make_scan(step, heartbeat_every=2, rounds_per_phase=2)(fresh(), po, pt, pv)
    diff_leaves(convert.state_leaves(eager), convert.state_leaves(got), "PX window")
    assert int(got.edge_live.sum()) > int(fresh().edge_live.sum())
    assert got.dup_trans is not None and got.peerhave.dtype == torch.int16


@pytest.mark.parametrize("kind,frac,seed", [
    ("lattice", 0.3, 5), ("lattice", 0.9, 0), ("random", 0.3, 1), ("random", 0.5, 7),
    ("powerlaw", 0.3, 2),
])
def test_dormant_edges_equal_reference(kind, frac, seed):
    """The port's vectorised ``dormant_edges`` draws the JAX loop's plane
    bit for bit: one draw per undirected edge, from its low end, in
    row-major order; the plane is symmetric over the involution."""
    if kind == "powerlaw":
        from go_libp2p_pubsub_tpu import topo as jtopo

        from go_libp2p_pubsub_tpu_torch import topo as ttopo

        jt = jtopo.to_topology(jtopo.powerlaw(300, 2.2, 2, 64, seed=seed), max_degree=64)
        tt = ttopo.to_topology(ttopo.powerlaw(300, 2.2, 2, 64, seed=seed), max_degree=64)
    elif kind == "lattice":
        jt, tt = jgraph.ring_lattice(200, d=8), tgraph.ring_lattice(200, d=8)
    else:
        jt, tt = jgraph.random_connect(150, 6, seed=seed), tgraph.random_connect(150, 6,
                                                                               seed=seed)
    want = jgraph.dormant_edges(jt, frac, seed=seed)
    got = tgraph.dormant_edges(tt, frac, seed=seed)
    np.testing.assert_array_equal(got, want)
    rows, cols = np.nonzero(got)
    assert got[tt.nbr[rows, cols], tt.rev[rows, cols]].all()
    assert 0 < got.sum() < tt.nbr_ok.sum()


def test_state_init_equals_reference():
    """``GossipSubState.init`` with dormant edges, int16 counters and the
    duplicate plane builds the JAX package's initial state, dense and
    CSR-resident."""
    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
    from torch_parity import reference_leaves

    for layout in ("dense", "csr"):
        builds, dormant = px_builds("random", layout, options=dict(
            trace_exact=True, narrow_counters=True))
        jcfg, jnet, jsp, tcfg, tnet, tsp = builds
        want = reference_leaves(jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=3,
                                            dormant=dormant))
        got = convert.state_leaves(TState.init(tnet, 64, tcfg, score_params=tsp, seed=3,
                                               dormant=dormant))
        diff_leaves(want, got, f"init {layout}")
        assert got[".peerhave"].dtype == np.int16 and ".dup_trans" in got
