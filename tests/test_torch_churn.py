"""Dynamic peers (the notify plane), the blacklist and announce holes in
both GossipSub engines of the port, against the JAX package's, leaf by
leaf, every round or phase.

A peer that goes down, or is blacklisted, is disconnected with the whole
dead-peer cleanup (handleDeadPeers pubsub.go:648-689, RemovePeer
gossipsub.go:545-562, score retention score.go:604-689); every edge
touching it dies both ways and every gate, gather and kernel argument reads
the round's live edges, so a stale mask would differ only after a
transition: every schedule here takes peers down and brings them back, and
each cell asserts both transitions happened (``EV.REMOVE_PEER`` and
``EV.ADD_PEER``). Cells: the banded lattice (the kernel route's plain
versions), a random dense net, the random net CSR-resident and PX on the
lattice in the per-round step; the phase engine at r = 8 on the lattice;
``set_blacklist``; the JAX package's churn semantics (tests/test_churn.py:
score retention across a reconnect, the retained deficit's conversion, the
soft-state loss of a restart); announce holes in both engines; windows
with the liveness rows. Each reference run is built once a cell. The port
runs with ``device="cpu"``; no tolerance on any leaf."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    phase_schedule,
    phases_against_reference,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.ops import bitset
from go_libp2p_pubsub_tpu_torch.trace.events import EV

N = 64
ROUNDS = 18
DYN = dict(dynamic_peers=True)


def up_schedule(rounds: int, n: int, down: tuple = (4, 10), second: tuple = (12, 15),
                seed: int = 0) -> np.ndarray:
    """[rounds, n] bool: a fifth of the peers down over ``down`` and back,
    then three more down over ``second`` and back."""
    rng = np.random.default_rng(seed)
    up = np.ones((rounds, n), bool)
    up[down[0]:down[1], rng.choice(n, n // 5, replace=False)] = False
    up[second[0]:second[1], rng.choice(n, 3, replace=False)] = False
    return up


def assert_churned(st, up: np.ndarray):
    """Both transitions happened, as many as the schedule holds."""
    downs = int((up[:-1] & ~up[1:]).sum()) + int((~up[0]).sum())
    ups = int((~up[:-1] & up[1:]).sum())
    assert downs > 0 and ups > 0
    assert int(st.core.events[EV.REMOVE_PEER]) == downs
    assert int(st.core.events[EV.ADD_PEER]) == ups


def topologies(kind: str):
    if kind == "lattice":
        return jgraph.ring_lattice(N, d=4), tgraph.ring_lattice(N, d=4)
    return jgraph.random_connect(N, 5, seed=1), tgraph.random_connect(N, 5, seed=1)


@pytest.mark.parametrize("kind,layout,gater", [
    ("lattice", "dense", False), ("random", "dense", False), ("random", "csr", False),
    ("random", "dense", True),
], ids=["lattice", "random-dense", "random-csr", "random-dense-gater"])
def test_churn_rounds_equal_reference(kind, layout, gater):
    """The per-round step under churn; on the lattice the kernel route
    (``edge_exchange``, ``fused_delivery``) with the transitions' live
    mask as their live words and F_LIVE. With the peer gater over shared
    ip groups (3 a group) its per-source share sums over live edges."""
    up = up_schedule(ROUNDS, N)
    kw = {}
    if gater:
        kw = dict(gater={}, validation_capacity=2, ip_group=(np.arange(N) // 3).astype(np.int32))
    builds = bench_builds(n=N, topologies=topologies(kind), edge_layout=layout,
                          fused=layout == "csr", **kw)
    # the CSR-resident case replays the dense case's JAX run (densified)
    st = rounds_against_reference(builds, ROUNDS, up=up, step_kw=DYN,
                                  share=("churn rounds", kind, gater))
    assert_churned(st, up)
    assert builds[4].band_off is not None or kind != "lattice"


def test_churn_px_rounds_equal_reference():
    """PX on the lattice under churn: the live view is the transitions'
    mask and ``edge_live``, and PX connects only edges whose two ends are
    up."""
    from test_torch_px import ACCEPT_PX, SMALL

    up = up_schedule(ROUNDS, N, seed=3)
    builds = bench_builds(n=N, topologies=topologies("lattice"),
                          params=dict(do_px=True, **SMALL),
                          thresholds=dict(accept_px_threshold=ACCEPT_PX))
    dormant = jgraph.dormant_edges(topologies("lattice")[0], 0.3, seed=5)
    st = rounds_against_reference(builds, ROUNDS, up=up, step_kw=DYN, dormant=dormant)
    assert_churned(st, up)
    assert int(st.edge_live.sum()) > int((~dormant & np.asarray(builds[4].nbr_ok)).sum())


def test_churn_phases_equal_reference():
    """The phase engine at r = 8 on the lattice: one liveness row a phase,
    the transitions at the head, ``edge_exchange``'s head and data
    crossings under that phase's live edges. A fifth of the peers are
    down for phase 1 and back for phase 2."""
    r, rounds = 8, 32
    up = np.ones((rounds, N), bool)
    up[8:16, np.random.default_rng(1).choice(N, N // 5, replace=False)] = False
    builds = bench_builds(n=N, topologies=topologies("lattice"), heartbeat_every=r)
    st = phases_against_reference(builds, r, r, rounds, up=up, **DYN)
    assert_churned(st, up[::r])


def test_blacklist_equals_reference():
    """``set_blacklist`` on both states: a blacklisted peer is cut off with
    the whole cleanup while its flag is set (its up row stays True), and
    comes back when the flag clears."""
    up = np.ones((ROUNDS, N), bool)
    bl = np.zeros(N, bool)
    bl[[3, 17, 40]] = True
    builds = bench_builds(n=N, topologies=topologies("random"))
    seen = []
    st = rounds_against_reference(
        builds, ROUNDS, up=up, step_kw=DYN, blacklist={5: bl, 11: np.zeros(N, bool)},
        observe=lambda s: seen.append(s.up.clone()))
    assert not seen[5][bl].any() and seen[4][bl].all() and seen[11][bl].all()
    assert int(st.core.events[EV.REMOVE_PEER]) == 3 == int(st.core.events[EV.ADD_PEER])


# ---------------------------------------------------------------------------
# the JAX package's churn semantics (its tests/test_churn.py), one run


def churn_cell_builds():
    """Both packages' build of the JAX churn tests' scored cell:
    random_connect(30, 6), benign scores (P2 and P4 weighted, P7), no flood
    publish."""
    from go_libp2p_pubsub_tpu import config as jconfig
    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
    from go_libp2p_pubsub_tpu.state import Net as JNet

    from go_libp2p_pubsub_tpu_torch import config as tconfig
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg
    from go_libp2p_pubsub_tpu_torch.state import Net as TNet

    n = 30
    out = []
    for cm, cfg_cls, net_cls, g, kw in ((jconfig, JCfg, JNet, jgraph, {}),
                                        (tconfig, TCfg, TNet, tgraph, {"device": "cpu"})):
        tp = cm.TopicScoreParams(
            topic_weight=1.0, time_in_mesh_weight=0.0, first_message_deliveries_weight=1.0,
            first_message_deliveries_cap=50.0, first_message_deliveries_decay=0.9,
            mesh_message_deliveries_weight=0.0, mesh_failure_penalty_weight=0.0,
            invalid_message_deliveries_weight=-10.0, invalid_message_deliveries_decay=0.95)
        sp = cm.PeerScoreParams(topics={0: tp}, skip_app_specific=True,
                                behaviour_penalty_weight=-10.0,
                                behaviour_penalty_threshold=0.0,
                                behaviour_penalty_decay=0.9, ip_colocation_factor_weight=0.0)
        thr = cm.PeerScoreThresholds(gossip_threshold=-2.0, publish_threshold=-4.0,
                                     graylist_threshold=-8.0, accept_px_threshold=10.0,
                                     opportunistic_graft_threshold=1.0)
        cfg = cfg_cls.build(dataclasses.replace(cm.GossipSubParams(), flood_publish=False),
                            thr, score_enabled=True)
        net = net_cls.build(g.random_connect(n, 6, seed=0), g.subscribe_all(n, 1), **kw)
        out += [cfg, net, sp]
    return out


CELL_ROUNDS = 24


@pytest.fixture(scope="module")
def churn_cell():
    """One scored run of both packages, every leaf every round: peer 5
    publishes valid messages in rounds 1-4 and peer 7 invalid ones in
    rounds 5-10; n-1 publishes at rounds 0 and 14; peers 0, 5 and 7 go
    down at round 11 and come back at round 12. Returns the port's state
    after every round."""
    jcfg, jnet, jsp, tcfg, tnet, tsp = churn_cell_builds()
    n = tnet.n_peers
    po = np.full((CELL_ROUNDS, 4), -1, np.int32)
    pt = np.zeros((CELL_ROUNDS, 4), np.int32)
    pv = np.ones((CELL_ROUNDS, 4), bool)
    po[0, 0] = po[14, 0] = n - 1
    po[1:5, 0] = 5
    po[5:11, 0] = 7
    pv[5:11, 0] = False
    up = np.ones((CELL_ROUNDS, n), bool)
    up[11, [0, 5, 7]] = False
    states = []
    from torch_parity import Builds

    builds = Builds((jcfg, jnet, jsp, tcfg, tnet, tsp))
    rounds_against_reference(builds, CELL_ROUNDS, schedule=(po, pt, pv), up=up,
                             step_kw=DYN, observe=states.append)
    return tnet, states


def _received(st, peer):
    have = bitset.unpack(st.core.dlv.have, st.core.msgs.capacity)[peer]
    return set(torch.nonzero(have).flatten().tolist())


def _viewers(net, p):
    return [(j, k) for j, k in torch.nonzero(net.nbr == p).tolist() if bool(net.nbr_ok[j, k])]


def test_score_retention_across_reconnect(churn_cell):
    """Neighbours that scored peer 7 negative (its invalid publishes, P4)
    keep most of those opinions across its disconnect and return; peer 5's
    positive stats are deleted at its disconnect (tests/test_churn.py:183,
    :209)."""
    net, states = churn_cell
    v7, v5 = _viewers(net, 7), _viewers(net, 5)
    neg = [(j, k) for j, k in v7 if float(states[10].scores[j, k]) < 0]
    assert neg
    still = [(j, k) for j, k in neg if float(states[14].scores[j, k]) < 0]
    assert len(still) >= 0.8 * len(neg)
    assert max(float(states[10].scores[j, k]) for j, k in v5) > 0
    assert all(float(states[11].score.fmd[j, :, k].sum()) == 0 for j, k in v5)
    assert int(states[11].core.events[EV.REMOVE_PEER]) == 3
    assert int(states[12].core.events[EV.ADD_PEER]) == 3


def test_restart_loses_soft_state(churn_cell):
    """Peer 0's seen-cache and mcache are wiped by the crash, and it
    receives traffic again after it returns (tests/test_churn.py:315)."""
    _net, states = churn_cell
    assert len(_received(states[10], 0)) > 0
    assert _received(states[11], 0) == set()
    assert int(states[11].mcache[0].abs().sum()) == 0
    assert not bool(states[11].mesh[0].any())
    assert len(_received(states[-1], 0)) > 0


def test_retained_deficit_converts_once():
    """removePeer's composition on a retained mesh edge with a standing P3
    deficit (tests/test_churn.py:229): the deficit converts to the P3b
    penalty once and the latch drops; the port's clears and score equal
    the JAX package's (jitted) bit for bit, before and through the
    decay."""
    from go_libp2p_pubsub_tpu import config as jconfig
    from go_libp2p_pubsub_tpu.score import engine as je
    from go_libp2p_pubsub_tpu.state import Net as JNet

    from go_libp2p_pubsub_tpu_torch import config as tconfig
    from go_libp2p_pubsub_tpu_torch.score import engine as te
    from go_libp2p_pubsub_tpu_torch.state import Net as TNet

    def params(cm):
        tp = cm.TopicScoreParams(
            topic_weight=1.0, time_in_mesh_weight=0.0, first_message_deliveries_weight=0.0,
            mesh_message_deliveries_weight=-1.0, mesh_message_deliveries_decay=0.9,
            mesh_message_deliveries_cap=100.0, mesh_message_deliveries_threshold=10.0,
            mesh_message_deliveries_activation=1.0, mesh_failure_penalty_weight=-1.0,
            mesh_failure_penalty_decay=0.5, invalid_message_deliveries_weight=-10.0,
            invalid_message_deliveries_decay=0.95)
        return cm.PeerScoreParams(topics={0: tp}, skip_app_specific=True,
                                  behaviour_penalty_weight=-10.0,
                                  behaviour_penalty_threshold=0.0,
                                  behaviour_penalty_decay=0.9,
                                  ip_colocation_factor_weight=0.0)

    jsp, tsp = params(jconfig), params(tconfig)
    jnet = JNet.build(jgraph.ring_lattice(6, d=2), jgraph.subscribe_all(6, 1))
    tnet = TNet.build(tgraph.ring_lattice(6, d=2), tgraph.subscribe_all(6, 1), device="cpu")
    n, k, s = 6, tnet.max_degree, 1
    jtp = je.TopicParamsArrays.build(jsp, 1, 1.0).gather(jnet.my_topics)
    ttp = te.TopicParamsArrays.build(tsp, 1, 1.0).gather(tnet.my_topics)
    scal = te.ScoreScalars.build(tsp)
    in_mesh = np.zeros((n, s, k), bool)
    in_mesh[0, 0, 0] = True
    down = np.zeros((n, k), bool)
    down[0, 0] = True
    retained = np.zeros((n, k), bool)
    no_mesh = np.zeros((n, s, k), bool)
    zk, zn = np.zeros((n, k), np.float32), np.zeros((n,), np.float32)

    jst = je.ScoreState.empty(n, s, k).replace(mmd_active=jnp.asarray(in_mesh))
    tst = dataclasses.replace(te.ScoreState.empty(n, s, k, "cpu"),
                              mmd_active=torch.from_numpy(in_mesh))

    @jax.jit
    def jclear(st):
        st = je.on_prune(st, jnp.asarray(in_mesh) & jnp.asarray(down)[:, None, :], jtp)
        return je.clear_edges(je.clear_mesh_status(st, jnp.asarray(down)),
                              jnp.asarray(retained))

    jscore = jax.jit(lambda st: je.compute_scores(st, jnp.asarray(no_mesh), jtp, jsp,
                                                  jnp.asarray(zk), jnp.asarray(zn), jnet))
    jrefresh = jax.jit(lambda st, t: je.refresh_scores(st, jnp.asarray(no_mesh), t, jtp, jsp))

    def same(j, t, where):
        for f in dataclasses.fields(t):
            a, b = np.asarray(getattr(j, f.name)), getattr(t, f.name).numpy()
            if a.dtype.kind == "f":
                a, b = a.view(np.uint32), b.view(np.uint32)
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {f.name}")

    jst = jclear(jst)
    tst = te.on_prune(tst, torch.from_numpy(in_mesh & down[:, None, :]), ttp)
    tst = te.clear_edges(te.clear_mesh_status(tst, torch.from_numpy(down)),
                         torch.from_numpy(retained))
    same(jst, tst, "clears")
    thr = float(ttp["thr3"][0, 0])
    assert not bool(tst.mmd_active[0, 0, 0]) and float(tst.mfp[0, 0, 0]) == thr * thr
    tscore = lambda st: te.compute_scores(st, torch.from_numpy(no_mesh), ttp, scal,
                                          torch.from_numpy(zk), torch.from_numpy(zn), tnet)
    sc = tscore(tst)
    np.testing.assert_array_equal(sc.numpy().view(np.uint32),
                                  np.asarray(jscore(jst)).view(np.uint32))
    assert float(sc[0, 0]) == -thr * thr
    for t in range(20):
        jst = jrefresh(jst, t)
        tst = te.refresh_scores(tst, torch.from_numpy(no_mesh), torch.tensor(t), ttp, scal)
    same(jst, tst, "decayed")
    assert abs(float(tscore(tst)[0, 0])) < 1e-3


# ---------------------------------------------------------------------------
# announce holes


def holes_plane(net, seed: int = 4) -> np.ndarray:
    """[N, K, T] bool: a third of the present (receiver, edge) pairs have
    not seen their neighbour's announcement of topic 0."""
    rng = np.random.default_rng(seed)
    ok = net.nbr_ok.numpy()
    return (ok & (rng.random(ok.shape) < 0.33))[:, :, None]


@pytest.mark.parametrize("engine", ["rounds", "phases"])
def test_announce_holes_equal_reference(engine):
    """``sub_knowledge_holes`` in both engines on the lattice (the kernel
    route: the holes change no kernel argument, only the mesh and gossip
    candidates): fewer mesh edges than without them."""
    builds = bench_builds(n=N, topologies=topologies("lattice"),
                          heartbeat_every=8 if engine == "phases" else 1)
    holes = holes_plane(builds[4])
    if engine == "rounds":
        st = rounds_against_reference(builds, 12, step_kw=dict(sub_knowledge_holes=holes))
    else:
        st = phases_against_reference(builds, 8, 8, 24, sub_knowledge_holes=holes)
    hidden = torch.from_numpy(holes[:, :, 0])
    assert int(st.mesh.sum()) > 0
    # a hole never starts a graft from its receiver's side: a mesh edge
    # across one was grafted by the far end
    assert int((st.mesh[:, 0] & hidden).sum()) < int(hidden.sum())


# ---------------------------------------------------------------------------
# windows


@pytest.mark.parametrize("r", [1, 4])
def test_churn_window_equals_eager(r):
    """``driver.make_scan(..., up=...)``: the per-round step takes a row a
    round, the phase step the first row of each phase; equal to the eager
    loop, every leaf (a captured CUDA graph on the card: chip_smoke.py).
    ``form_mesh`` takes a liveness row too."""
    _j, _jn, _js, tcfg, tnet, tsp = bench_builds(n=N, topologies=topologies("lattice"),
                                                 heartbeat_every=r)
    rounds = 16
    up = torch.from_numpy(up_schedule(rounds, N, down=(4, 8), second=(8, 12), seed=2))
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(N, rounds))
    if r == 1:
        step = make_gossipsub_step(tcfg, tnet, score_params=tsp, **DYN)
    else:
        step = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp, **DYN)

    def fresh():
        st = TState.init(tnet, 64, tcfg, score_params=tsp, seed=0)
        if r > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=r, up=torch.ones(N, dtype=bool))
        return st

    eager = fresh()
    for d in range(rounds // r):
        sl = slice(d * r, (d + 1) * r)
        if r == 1:
            eager = step(eager, po[d], pt[d], pv[d], up[d])
        else:
            eager = step(eager, po[sl], pt[sl], pv[sl], up[d * r], do_heartbeat=True)
    got = driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r)(fresh(), po, pt, pv,
                                                                         up)
    diff_leaves(convert.state_leaves(eager), convert.state_leaves(got), f"window r={r}")
    assert int(got.core.events[EV.REMOVE_PEER]) > 0 and int(got.core.events[EV.ADD_PEER]) > 0


def test_state_with_blacklist_converts():
    """A churned state (peers down, one blacklisted) round-trips through
    ``convert`` both ways."""
    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState

    b = bench_builds(n=N, topologies=topologies("random"))
    jst = jinit(JState.init, b[1], 64, b[0], score_params=b[2], seed=2)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import set_blacklist

    bl = torch.zeros(N, dtype=torch.bool)
    bl[9] = True
    tst = set_blacklist(tst, bl)
    back = convert.state_from_reference(convert.state_leaves(tst), device="cpu")
    diff_leaves(convert.state_leaves(tst), convert.state_leaves(back), "round trip")
    assert bool(back.blacklist[9]) and back.core.topo is None
