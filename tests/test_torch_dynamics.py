"""The mutable overlay (``dynamic_topo``) in the port, against the JAX
package: the host compiler (``topo/dynamics.MutationSchedule``,
``churn_storm``), the device writes (``apply_mutation``,
``written_edge_mask``), the dynamic builds (``Net.build(...,
dynamic=True)``, ``TopoState``, ``Net.with_overlay``) and the per-round
step under a churn storm, dense and on the full-capacity CSR layout, every
leaf every round. The cells are the JAX package's own
(``tests/test_dynamics.py``: a power-law net at N = 32 with capacity
K = 10, four free slots a row for joins). The port runs with
``device="cpu"``; no tolerance on any leaf."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    phase_schedule,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import TopoState as JTopo
from go_libp2p_pubsub_tpu.topo import dynamics as jdyn
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import TopoState as TTopo
from go_libp2p_pubsub_tpu_torch.topo import dynamics as tdyn

N = 32
DEGREE = 10
ROUNDS = 16


def topologies(seed: int = 0, n: int = N, degree: int = DEGREE):
    """(JAX Topology, port Topology) of the power-law cell: tail degree
    ``degree - 4``, capacity ``degree``."""
    return (jtopo.to_topology(jtopo.powerlaw(n, max_degree=degree - 4, seed=seed),
                              max_degree=degree),
            ttopo.to_topology(ttopo.powerlaw(n, max_degree=degree - 4, seed=seed),
                              max_degree=degree))


def storms(seed: int, d: int = ROUNDS, **kw):
    """Both packages' churn_storm over the cell (the JAX test's settings)."""
    jt, tt = topologies(seed)
    kw = dict(n_dispatches=d, kill_frac=0.2, rewires=4, joins=1, join_links=2,
              seed=seed, **kw)
    return jdyn.churn_storm(jt, **kw), tdyn.churn_storm(tt, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_storm_compiles_as_the_reference(seed):
    """The same writes, up rows, hash and op tallies, at the JAX cell and
    at a larger storm (N = 64, capacity 12, more rewires and joins)."""
    for js, ts in (storms(seed),
                   (jdyn.churn_storm(jtopo.to_topology(jtopo.powerlaw(64, max_degree=8,
                                                                      seed=seed + 7),
                                                       max_degree=12),
                                     n_dispatches=24, kill_frac=0.3, rewires=12, joins=4,
                                     join_links=3, seed=seed),
                    tdyn.churn_storm(ttopo.to_topology(ttopo.powerlaw(64, max_degree=8,
                                                                      seed=seed + 7),
                                                       max_degree=12),
                                     n_dispatches=24, kill_frac=0.3, rewires=12, joins=4,
                                     join_links=3, seed=seed))):
        (jw, ju), (tw, tu) = js.build(), ts.build()
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tu, ju)
        assert ts.schedule_hash() == js.schedule_hash()
        assert (ts.n_kills, ts.n_joins, ts.n_rewires) == (js.n_kills, js.n_joins,
                                                           js.n_rewires)
        assert ts.n_kills > 0 and ts.n_joins > 0 and ts.n_rewires > 0
        np.testing.assert_array_equal(ts.nbr, js.nbr)
        np.testing.assert_array_equal(ts.degree(), js.degree())
        assert ts.mutation_dispatches == js.mutation_dispatches


def test_schedule_rejects_malformed_programs():
    """The programs the JAX package rejects raise ``ScheduleError`` here
    too (its tests/test_dynamics.py:120-136); a slot written twice in one
    dispatch too. ``due_fn`` gives due rows (``tests/
    test_torch_invariants_dynamics.py`` holds them to the JAX rows)."""
    _jt, tt = topologies()
    s = tdyn.MutationSchedule(tt.nbr, tt.nbr_ok, tt.rev, 4)
    with pytest.raises(tdyn.ScheduleError):
        s.add_edge(0, 3, 3)                  # self-edge
    u = int(np.argwhere(tt.nbr_ok)[0][0])
    v = int(tt.nbr[u][tt.nbr_ok[u]][0])
    with pytest.raises(tdyn.ScheduleError):
        s.add_edge(0, u, v)                  # duplicate edge
    s.remove_edge(2, u, v)
    with pytest.raises(tdyn.ScheduleError):
        s.add_edge(1, u, v)                  # out-of-order dispatch
    with pytest.raises(tdyn.ScheduleError):
        s.build(batch=1)                     # batch < widest dispatch
    with pytest.raises(tdyn.ScheduleError):
        s._write(2, u * s.k, 1, 0, 1)        # slot already written in dispatch 2
    with pytest.raises(tdyn.ScheduleError):
        s.remove_edge(3, u, v)               # no such edge any more
    row = s.due_fn(4)(4)
    assert row.shape == (7,) and row[6] == 1     # the dispatch-2 mutation is in its window
    assert tdyn.PAD_SLOT == jdyn.PAD_SLOT


def test_device_writes_equal_the_reference():
    """``apply_mutation`` and ``written_edge_mask`` on every batch of a storm,
    padding rows included, plus a batch with a malformed row (an in-range
    slot with out-of-range peer and rev, clamped as the JAX function
    clamps) and rows past the slot space: equal to the JAX functions, and
    the device planes equal the host mirror at the end."""
    js, ts = storms(0)
    jw, _ = js.build()
    jt, tt = topologies(0)
    jtopo_ = JTopo.from_net(JNet.build(jt, jgraph.subscribe_all(N, 1), dynamic=True))
    ttopo_ = TTopo.from_net(TNet.build(tt, tgraph.subscribe_all(N, 1), device="cpu",
                                       dynamic=True))
    bad = np.array([[5, 10_000, 99, 1], [N * DEGREE, 3, 1, 1], [tdyn.PAD_SLOT, 0, 0, 0],
                    [N * DEGREE + 7, 2, 2, 0]], np.int32)
    assert (jw[:, :, 0] == tdyn.PAD_SLOT).any()
    for batch in list(jw) + [bad]:
        jtopo_ = jdyn.apply_mutation(jtopo_, jnp.asarray(batch))
        ttopo_ = tdyn.apply_mutation(ttopo_, torch.from_numpy(batch))
        for f in ("nbr", "nbr_ok", "rev", "edge_perm", "epoch"):
            want, got = np.asarray(getattr(jtopo_, f)), getattr(ttopo_, f).numpy()
            assert want.dtype == got.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(
            tdyn.written_edge_mask(torch.from_numpy(batch), N, DEGREE).numpy(),
            np.asarray(jdyn.written_edge_mask(jnp.asarray(batch), N, DEGREE)))
    assert int(ttopo_.epoch.sum()) == int((jw[:, :, 0] != tdyn.PAD_SLOT).sum()) + 1


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_dynamic_net_and_state_equal_the_reference(layout):
    """``Net.build(..., dynamic=True)``: no banded structure on the ring
    either, the full-capacity identity layout on CSR (E = N·K, ``e_valid``
    the present slots); the initial state with its overlay, and the
    overlay-rebound net's flat faces."""
    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState

    ring = TNet.build(tgraph.ring_lattice(N, d=4), tgraph.subscribe_all(N, 1), device="cpu",
                      dynamic=True)
    assert ring.band_off is None
    builds = bench_builds(n=N, topologies=topologies(0), edge_layout=layout, dynamic=True)
    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    assert tnet.n_edges == (N * DEGREE if layout == "csr" else None)
    if layout == "csr":
        assert tnet.csr_identity and jnet.csr_identity
        np.testing.assert_array_equal(tnet.csr_e_valid.numpy(), np.asarray(jnet.csr_e_valid))
        np.testing.assert_array_equal(tnet.csr_eperm.numpy(), np.asarray(jnet.csr_eperm))
    want = reference_leaves(jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=1,
                                        dynamic_topo=True))
    got = convert.state_leaves(TState.init(tnet, 64, tcfg, score_params=tsp, seed=1,
                                           dynamic_topo=True))
    diff_leaves(want, got, f"init {layout}")
    assert got[".core.topo.edge_perm"].dtype == np.int32
    # the overlay rebinds the flat faces and the neighbour view
    js, ts = storms(0)
    jw, _ = js.build()
    t1 = TTopo.from_net(tnet)
    j1 = JTopo.from_net(jnet)
    for batch in jw[:8]:
        t1 = tdyn.apply_mutation(t1, torch.from_numpy(batch))
        j1 = jdyn.apply_mutation(j1, jnp.asarray(batch))
    tn, jn = tnet.with_overlay(t1), jnet.with_overlay(j1)
    v = np.arange(N, dtype=np.int32) * 3 + 1
    np.testing.assert_array_equal(tn.peer_gather(torch.from_numpy(v)).numpy(),
                                  np.asarray(jn.peer_gather(jnp.asarray(v))))
    x = np.arange(N * DEGREE, dtype=np.int32).reshape(N, DEGREE)
    np.testing.assert_array_equal(tn.edge_gather(torch.from_numpy(x)).numpy(),
                                  np.asarray(jn.edge_gather(jnp.asarray(x))))


@pytest.mark.parametrize("layout,gater", [("dense", False), ("csr", False), ("dense", True)],
                         ids=["dense", "csr", "dense-gater"])
def test_storm_rounds_equal_reference(layout, gater):
    """The per-round step with ``dynamic_peers`` and ``dynamic_topo`` under
    a churn storm (kills at round 4, replacement and joins at 8, rewires
    between): every leaf every round, the overlay included; with the peer
    gater over shared ip groups (3 a group) its per-source share follows
    the rewired edges. The flat planes of the full-capacity state are zero
    on absent slots."""
    js, ts = storms(0)
    writes, up = ts.build()
    kw = {}
    if gater:
        kw = dict(gater={}, validation_capacity=2, ip_group=(np.arange(N) // 3).astype(np.int32))
    builds = bench_builds(n=N, topologies=topologies(0), edge_layout=layout, dynamic=True, **kw)
    # the full-capacity CSR case replays the dense case's JAX run (densified)
    st = rounds_against_reference(builds, ROUNDS, up=up, writes=writes,
                                  step_kw=dict(dynamic_peers=True, dynamic_topo=True),
                                  dynamic_topo=True, share=("storm rounds", gater))
    np.testing.assert_array_equal(st.core.topo.nbr.numpy(), ts.nbr)
    assert int(st.core.topo.epoch.sum()) == int((writes[:, :, 0] != tdyn.PAD_SLOT).sum())
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    assert int(st.core.events[EV.REMOVE_PEER]) == ts.n_kills
    assert int(st.core.events[EV.ADD_PEER]) == ts.n_kills
    absent = ~st.core.topo.nbr_ok
    if layout == "csr":
        flat = absent.reshape(-1)
        assert not st.served_lo[flat].any() and not st.peerhave[flat].any()
        assert not st.core.dlv.fe_words[flat].any()
    assert not st.mesh[absent[:, None, :].expand_as(st.mesh)].any()


def test_storm_window_equals_eager():
    """A ``dynamic_topo`` step through ``driver.make_window`` with the
    liveness rows and write batches as per-dispatch ``xs`` equals its eager
    loop, every leaf."""
    js, ts = storms(1)
    writes, up = ts.build()
    _j, _jn, _js, tcfg, tnet, tsp = bench_builds(n=N, topologies=topologies(1), dynamic=True)
    step = make_gossipsub_step(tcfg, tnet, score_params=tsp, dynamic_peers=True,
                               dynamic_topo=True)
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(N, ROUNDS))
    up_t, wr_t = torch.from_numpy(up), torch.from_numpy(writes)

    def fresh():
        return TState.init(tnet, 64, tcfg, score_params=tsp, seed=0, dynamic_topo=True)

    eager = fresh()
    for t in range(ROUNDS):
        eager = step(eager, po[t], pt[t], pv[t], up_t[t], wr_t[t])
    got, _ = driver.make_window(step)(fresh(), (po, pt, pv, up_t, wr_t))
    diff_leaves(convert.state_leaves(eager), convert.state_leaves(got), "storm window")
    assert int(got.core.topo.epoch.sum()) > 0


def test_dynamic_topo_refusals():
    """The builds the JAX package refuses (its tests/test_dynamics.py:380),
    each a ValueError as there."""
    _j, _jn, _js, tcfg, tnet, tsp = bench_builds(n=N, topologies=topologies(0), dynamic=True)
    with pytest.raises(ValueError, match="dynamic_peers"):
        make_gossipsub_step(tcfg, tnet, score_params=tsp, dynamic_topo=True)
    banded = TNet.build(tgraph.ring_lattice(N, d=4), tgraph.subscribe_all(N, 1),
                        device="cpu")
    assert banded.band_off is not None
    with pytest.raises(ValueError, match="unbanded"):
        make_gossipsub_step(tcfg, banded, score_params=tsp, dynamic_peers=True,
                            dynamic_topo=True)
    static_csr = TNet.build(topologies(0)[1], tgraph.subscribe_all(N, 1), device="cpu",
                            edge_layout="csr")
    with pytest.raises(ValueError, match="full-capacity"):
        make_gossipsub_step(dataclasses.replace(tcfg, edge_layout="csr"), static_csr,
                            score_params=tsp, dynamic_peers=True, dynamic_topo=True)
    for bad, match in (({"adversary_no_forward": np.zeros(N, bool)}, "adversary"),
                       ({"sub_knowledge_holes": np.zeros((N, DEGREE, 1), bool)},
                        "sub_knowledge_holes")):
        with pytest.raises(ValueError, match=match):
            make_gossipsub_step(tcfg, tnet, score_params=tsp, dynamic_peers=True,
                                dynamic_topo=True, **bad)
    for field in ("do_px", "edge_liveness"):
        with pytest.raises(ValueError, match="do_px"):
            make_gossipsub_step(dataclasses.replace(tcfg, **{field: True}), tnet,
                                score_params=tsp, dynamic_peers=True, dynamic_topo=True)
    with pytest.raises(ValueError, match="fused"):
        TNet.build(topologies(0)[1], tgraph.subscribe_all(N, 1), device="cpu",
                   fused=True, dynamic=True)
    with pytest.raises(ValueError, match="banded"):
        banded.with_overlay(TTopo.from_net(banded))
