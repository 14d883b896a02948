"""The port's router plane (``routers/``: v1.2 IDONTWANT, episub lazy
choking, the per-edge latency ring) against the JAX package's, leaf for
leaf.

Every case of ``tests/test_router.py`` has its twin here, run on both
packages from the same state: the JAX step and the port's (on the CPU) go
round by round side by side on ``powerlaw(48, d_min=4, max_degree=16)``
(with ``attach_latency_classes(n_clusters=4)`` for the ring, L = 7), and
every leaf is compared bit for bit after every round, the f32
``choke_ema`` included (no tolerance). A CSR-resident port run is held to
the JAX dense run densified (``state.densify_edge_planes``: the ring goes
``[E, L, W] -> [N, K, L, W]``), as the JAX package holds its CSR run to its
dense one. One JAX step is compiled a router config and shared by the
schedules that config runs. Beyond the reference's cases: the EMA's float
form and the choke and ring primitives on random planes against the
jitted and eager JAX ops; a run past the slot recycle (M = 32, 48
publishes) with the ring in flight; choke with dynamic peers and peer
churn on the scored bench lattice (the banded net whose delivery round
takes ``delivery_banded`` on the card) with the ring from the lattice's
latency classes; the checkpoint read by the JAX package; a window against
its eager loop; the oracle's two choke properties on a lived-in choke
state (``tests/test_invariants.py``'s choke cases, both checkers).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    reference_leaves,
    rounds_against_reference,
    seeded_violation,
)

from go_libp2p_pubsub_tpu import checkpoint as jcheckpoint
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import routers as jrouters
from go_libp2p_pubsub_tpu.config import GossipSubParams as JParams
from go_libp2p_pubsub_tpu.config import PeerScoreThresholds as JThr
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake_phase
from go_libp2p_pubsub_tpu.oracle import invariants as jinv
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.topo import generators as jtopo
from go_libp2p_pubsub_tpu_torch import checkpoint, convert, driver, graph, routers
from go_libp2p_pubsub_tpu_torch.config import GossipSubParams, PeerScoreThresholds
from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
    GossipSubConfig,
    GossipSubState,
    make_gossipsub_step,
)
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.oracle import invariants as tinv
from go_libp2p_pubsub_tpu_torch.routers import RouterConfig, RouterConfigError
from go_libp2p_pubsub_tpu_torch.state import Net, densify_edge_planes
from go_libp2p_pubsub_tpu_torch.topo import generators as topogen
from go_libp2p_pubsub_tpu_torch.trace.events import EV

N, M, P = 48, 32, 4
PUBS = ((5, 3), (12, 9), (20, 17))
CHOKE = dict(choke=True, choke_threshold=0.35, unchoke_threshold=0.1)
# the reference cases' configs by name (L filled in from the class graph)
CONFIGS = {
    "v11": None,
    "idontwant": dict(idontwant=True),
    "ring0": dict(latency_rounds=3),
    "ring": dict(latency_rounds="L"),
    "choke": dict(CHOKE, latency_rounds="L"),
    "full": dict(CHOKE, idontwant=True, latency_rounds="L"),
}


@functools.cache
def graph_of(classes: bool):
    """(port EdgeList, port Topology, JAX Topology, delay plane, L) of the
    reference cases' graph, the edge lists byte-identical."""
    el = topogen.powerlaw(N, d_min=4, max_degree=16, seed=0)
    jel = jtopo.powerlaw(N, d_min=4, max_degree=16, seed=0)
    if classes:
        el = topogen.attach_latency_classes(el, n_clusters=4)
        jel = jtopo.attach_latency_classes(jel, n_clusters=4)
    assert el.canonical_bytes() == jel.canonical_bytes()
    topo, jtopology = topogen.to_topology(el), jtopo.to_topology(jel)
    if not classes:
        return el, topo, jtopology, None, 0
    delay, L = topogen.link_delay_plane(el, topo)
    jdelay, jL = jtopo.link_delay_plane(jel, jtopology)
    assert L == jL and delay.tobytes() == jdelay.tobytes()
    return el, topo, jtopology, delay, L


def router_kw(name: str, L: int):
    kw = CONFIGS[name]
    if kw is None:
        return None
    return {k: (L if v == "L" else v) for k, v in kw.items()}


def link_delay_of(name: str, classes: bool, n_k):
    kw = CONFIGS[name]
    if kw is None or not kw.get("latency_rounds"):
        return None
    if kw["latency_rounds"] == "L":
        return graph_of(classes)[3]
    return np.zeros(n_k, np.int32)


@functools.cache
def jax_build(name: str, classes: bool):
    """The JAX net, config and step of a reference case (one compile a
    config, shared by every schedule it runs)."""
    _el, _topo, jtopology, _d, L = graph_of(classes)
    jnet = JNet.build(jtopology, jgraph.subscribe_all(N, 1))
    rk = router_kw(name, L)
    jcfg = JCfg.build(JParams(), JThr(), score_enabled=False,
                      router=None if rk is None else jrouters.RouterConfig(**rk))
    step = jmake(jcfg, jnet, link_delay=link_delay_of(name, classes, jnet.nbr.shape))
    return jnet, jcfg, step


def port_build(name: str, classes: bool, layout: str = "dense"):
    """The port's net, config, state and step of a reference case."""
    _el, topo, _j, _d, L = graph_of(classes)
    net = Net.build(topo, graph.subscribe_all(N, 1), edge_layout=layout, device="cpu")
    rk = router_kw(name, L)
    cfg = GossipSubConfig.build(GossipSubParams(), PeerScoreThresholds(), score_enabled=False,
                                router=None if rk is None else RouterConfig(**rk),
                                edge_layout=layout)
    st = GossipSubState.init(net, M, cfg, seed=0)
    step = make_gossipsub_step(cfg, net,
                               link_delay=link_delay_of(name, classes, tuple(net.nbr.shape)))
    return net, cfg, st, step


def pub_rows(pubs, rounds: int):
    """[rounds, P] publish rows: one valid publish of origin o in round r
    for each (o, r) of ``pubs``, nothing else."""
    po = np.full((rounds, P), -1, np.int32)
    pt = np.full((rounds, P), -1, np.int32)
    pv = np.zeros((rounds, P), bool)
    for o, r in pubs:
        if r < rounds:
            po[r, 0], pt[r, 0], pv[r, 0] = o, 0, True
    return po, pt, pv


def every_round(rounds: int, start: int = 3):
    """One publish a round from round ``start``, origins cycling the peers."""
    return tuple(((3 * r) % N, r) for r in range(start, rounds))


def drive(step, st, rows, observe=None):
    po, pt, pv = rows
    for r in range(po.shape[0]):
        st = step(st, torch.from_numpy(po[r]), torch.from_numpy(pt[r]), torch.from_numpy(pv[r]))
        if observe is not None:
            observe(r, st)
    return st


@functools.cache
def paired(name: str, classes: bool, pubs, rounds: int):
    """Both packages' runs of a reference case side by side from the same
    state, every leaf equal after every round. Returns (the JAX leaves
    after every round, the port's final state)."""
    jnet, jcfg, jstep = jax_build(name, classes)
    jst = jinit(JState.init, jnet, M, jcfg, seed=0)
    tnet, tcfg, _st, tstep = port_build(name, classes)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    po, pt, pv = pub_rows(pubs, rounds)
    trail = []
    for r in range(rounds):
        jst = jstep(jst, jnp.asarray(po[r]), jnp.asarray(pt[r]), jnp.asarray(pv[r]))
        tst = tstep(tst, torch.from_numpy(po[r]), torch.from_numpy(pt[r]),
                    torch.from_numpy(pv[r]))
        trail.append(reference_leaves(jst))
        diff_leaves(trail[-1], convert.state_leaves(tst), f"{name} round {r}")
    return trail, tst


@functools.cache
def port_run(name: str, classes: bool, pubs, rounds: int, layout: str = "dense"):
    """The port's run of a reference case alone: (leaves after every round
    (densified on CSR), final state)."""
    net, _cfg, st, step = port_build(name, classes, layout)
    trail = []
    st = drive(step, st, pub_rows(pubs, rounds),
               lambda r, s: trail.append(convert.state_leaves(densify_edge_planes(net, s))))
    return trail, st


def events(st) -> np.ndarray:
    return st.core.events.numpy()


# ---------------------------------------------------------------------------
# config validation, the phase engine's refusal, the link_delay checks


def test_config_validation():
    cases = [(dict(), "all-off"), (dict(latency_rounds=-1), "latency_rounds"),
             (dict(choke=True, choke_threshold=0.2, unchoke_threshold=0.3), "hysteresis"),
             (dict(choke=True, choke_ema_alpha=0.0), "choke_ema_alpha"),
             (dict(choke=True, choke_max_per_hb=0), "choke_max_per_hb")]
    for kw, match in cases:
        with pytest.raises(RouterConfigError, match=match) as terr:
            RouterConfig(**kw).validate()
        with pytest.raises(jrouters.RouterConfigError) as jerr:
            jrouters.RouterConfig(**kw).validate()
        assert str(terr.value) == str(jerr.value)
    RouterConfig(idontwant=True).validate()
    assert issubclass(RouterConfigError, ValueError)
    # the v1.2 size gate: unit-size messages are eligible iff <= 1.0
    assert RouterConfig(idontwant=True).idontwant_eligible
    assert not RouterConfig(idontwant=True, idontwant_threshold=1.5).idontwant_eligible
    assert ([f.name for f in dataclasses.fields(RouterConfig)]
            == [f.name for f in dataclasses.fields(jrouters.RouterConfig)])
    assert RouterConfig() == RouterConfig(**dataclasses.asdict(jrouters.RouterConfig()))
    # build() validates the block, as the reference's does
    with pytest.raises(RouterConfigError, match="all-off"):
        GossipSubConfig.build(router=RouterConfig())


def test_phase_engine_rejects_router():
    net, cfg, _st, _step = port_build("v11", False)
    cfg = dataclasses.replace(cfg, router=RouterConfig(idontwant=True))
    with pytest.raises(ValueError, match="phase engine predates") as terr:
        make_gossipsub_phase_step(cfg, net, 4)
    jnet, jcfg, _ = jax_build("v11", False)
    with pytest.raises(ValueError) as jerr:
        jmake_phase(dataclasses.replace(jcfg, router=jrouters.RouterConfig(idontwant=True)),
                    jnet, 4)
    assert type(terr.value) is type(jerr.value)


def test_link_delay_validation():
    _el, topo, _j, _d, _L = graph_of(False)
    net = Net.build(topo, graph.subscribe_all(N, 1), device="cpu")
    cfg = GossipSubConfig.build(GossipSubParams(), PeerScoreThresholds(), score_enabled=False,
                                router=RouterConfig(latency_rounds=3))
    # required iff latency_rounds > 0, shaped [N, K], within [0, L]
    with pytest.raises(ValueError, match="link_delay"):
        make_gossipsub_step(cfg, net)
    with pytest.raises(ValueError, match="link_delay"):
        make_gossipsub_step(cfg, net, link_delay=np.zeros((3, 3), np.int32))
    with pytest.raises(ValueError, match="link_delay"):
        make_gossipsub_step(cfg, net, link_delay=np.full(net.nbr.shape, 9, np.int32))
    with pytest.raises(ValueError, match="link_delay"):
        make_gossipsub_step(cfg, net, link_delay=np.full(net.nbr.shape, -1, np.int32))
    cfg11 = GossipSubConfig.build(GossipSubParams(), PeerScoreThresholds(), score_enabled=False)
    with pytest.raises(ValueError, match="link_delay"):
        make_gossipsub_step(cfg11, net, link_delay=np.zeros(net.nbr.shape, np.int32))
    # the router's edge views are static: no mutable overlay
    dnet = Net.build(topo, graph.subscribe_all(N, 1), device="cpu", dynamic=True)
    with pytest.raises(ValueError, match="dynamic_topo"):
        make_gossipsub_step(dataclasses.replace(cfg, router=RouterConfig(idontwant=True)),
                            dnet, dynamic_peers=True, dynamic_topo=True)
    # a valid plane builds; the refusal the port had is gone
    make_gossipsub_step(cfg, net, link_delay=np.zeros(net.nbr.shape, np.int32))


# ---------------------------------------------------------------------------
# topo: the latency plane generators


def test_latency_classes_and_delay_plane():
    el, topo, jtopology, delay, L = graph_of(True)
    assert el.link_class is not None and el.link_class.shape[0] == len(el.edges)
    assert set(np.unique(el.link_class)) <= {0, 1, 2}
    ok = np.asarray(topo.nbr_ok)
    # normalised: the fastest class sits at 0, L is the max over real edges
    assert delay[ok].min() == 0
    assert delay[ok].max() == L and L > 0
    assert not delay[~ok].any()
    # deterministic (no RNG), and the JAX package's planes byte for byte
    d2, L2 = topogen.link_delay_plane(el, topo)
    assert L2 == L and (d2 == delay).all()
    jel = jtopo.attach_latency_classes(jtopo.powerlaw(N, d_min=4, max_degree=16, seed=0),
                                       n_clusters=4)
    assert el.link_class.tobytes() == jel.link_class.tobytes()
    assert el.class_latency == jel.class_latency
    for got, want in zip(topogen.link_class_planes(el, topo),
                         jtopo.link_class_planes(jel, jtopology)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# elision and exactness anchors


def test_router_off_adds_no_state_leaves():
    _net, _cfg, st, _step = port_build("v11", False)
    for f in ("dontwant", "choked", "choke_ema", "inflight"):
        assert getattr(st, f) is None
    jnet, jcfg, _ = jax_build("v11", False)
    assert list(convert.state_leaves(st)) == list(reference_leaves(
        jinit(JState.init, jnet, M, jcfg, seed=0)))
    # each switch adds exactly its own leaves, at the JAX tree's places
    for name, want in (("idontwant", {".dontwant"}), ("choke", {".choked", ".choke_ema",
                                                              ".inflight"})):
        _n, _c, rst, _s = port_build(name, name != "idontwant")
        assert set(convert.state_leaves(rst)) - set(convert.state_leaves(st)) == want


def test_idontwant_exactness_anchor():
    trail, st_b = paired("idontwant", False, PUBS, 30)
    _t, st_a = port_run("v11", False, PUBS, 30)
    ev_a, ev_b = events(st_a), events(st_b)
    # the delivery plane untouched, bit for bit
    assert ev_b[EV.DELIVER_MESSAGE] == ev_a[EV.DELIVER_MESSAGE]
    assert torch.equal(st_b.core.dlv.first_round, st_a.core.dlv.first_round)
    assert torch.equal(st_b.core.dlv.have, st_a.core.dlv.have)
    # the suppressed traffic was exactly the duplicate traffic
    assert ev_b[EV.IDONTWANT_SENT] > 0 and ev_b[EV.DUP_SUPPRESSED] > 0
    assert ev_b[EV.SEND_RPC] < ev_a[EV.SEND_RPC]
    assert (ev_a[EV.SEND_RPC] - ev_b[EV.SEND_RPC]
            == ev_a[EV.DUPLICATE_MESSAGE] - ev_b[EV.DUPLICATE_MESSAGE])
    assert (trail[-1][".core.events"] == ev_b.astype(np.int32)).all()


def test_delay_zero_ring_is_v11_bit_exact():
    """A depth-L ring fed an all-zero delay plane commits every edge at
    once: without its ring leaf the state is the v1.1 run's, every round."""
    trail_a, _st = port_run("v11", False, PUBS, 30)
    trail_z, st_z = port_run("ring0", False, PUBS, 30)
    assert not st_z.inflight.any()
    for r, (a, z) in enumerate(zip(trail_a, trail_z)):
        assert z[".inflight"].shape[-2:] == (3, 1) and not z[".inflight"].any()
        diff_leaves(a, {p: v for p, v in z.items() if p != ".inflight"}, f"round {r}")


def test_latency_ring_delays_delivery():
    # one early publish and a horizon long enough that both runs reach
    # everyone: censoring a slow run's tail would bias the means
    pubs = ((5, 3),)
    _trail, st_b = paired("ring", True, pubs, 45)
    _t, st_a = port_run("v11", True, pubs, 45)
    fr_a = st_a.core.dlv.first_round.numpy()
    fr_b = st_b.core.dlv.first_round.numpy()
    # the plane is load-bearing: the same full coverage, later arrivals
    assert (fr_b >= 0).sum() == (fr_a >= 0).sum() > 0
    assert fr_b[fr_b >= 0].mean() > fr_a[fr_a >= 0].mean()


# ---------------------------------------------------------------------------
# choke well-formedness on a lived-in run

CHOKE_PUBS = tuple((o, r) for r, o in enumerate(range(3, 43, 2), 3))


def test_choke_run_well_formed():
    _trail, st = paired("choke", True, CHOKE_PUBS, 60)
    ev = events(st)
    assert ev[EV.CHOKE] > 0 and ev[EV.UNCHOKE] >= 0
    mesh, chk = st.mesh.numpy(), st.choked.numpy()
    assert not (chk & ~mesh).any()
    # the Dlo floor: any slot with chokes keeps >= Dlo unchoked links
    unchoked = (mesh & ~chk).sum(axis=-1)
    assert (unchoked[chk.any(axis=-1)] >= GossipSubConfig().Dlo).all()
    ema = st.choke_ema.numpy()
    assert (ema >= 0.0).all() and (ema <= 1.0).all()


# ---------------------------------------------------------------------------
# layout parity, the slot recycle and resume determinism


def test_csr_parity_idontwant_and_ring():
    trail_d, st_d = paired("idontwant", False, PUBS, 30)
    trail_c, st_c = port_run("idontwant", False, PUBS, 30, "csr")
    assert (events(st_c) == events(st_d)).all()
    for r, (d, c) in enumerate(zip(trail_d, trail_c)):
        diff_leaves(d, c, f"CSR idontwant round {r}")

    pubs = tuple((o, r) for r, o in enumerate(range(3, 23, 2), 3))
    _t, st_d = port_run("choke", True, pubs, 40)
    _t, st_c = port_run("choke", True, pubs, 40, "csr")
    assert (events(st_c) == events(st_d)).all()
    # the ring rides the CSR-resident tier flat: [E, L, W]
    assert st_c.inflight.dim() == 3 and st_d.inflight.dim() == 4
    # and against the JAX run of the choke case, every round densified
    jtrail, _st = paired("choke", True, CHOKE_PUBS, 60)
    ctrail, cst = port_run("choke", True, CHOKE_PUBS, 60, "csr")
    for r, (j, c) in enumerate(zip(jtrail, ctrail)):
        diff_leaves(j, c, f"CSR choke round {r}")
    assert any(c[".inflight"].any() for c in ctrail) and cst.inflight.dim() == 3


def test_ring_recycles_with_its_slots():
    """M = 32 slots and a publish every round for 45 rounds: every slot is
    recycled while the ring holds words of the slot's old message, which
    the keep-words mask drops (a stale ride would resurrect as the slot's
    next message); every leaf equal to the JAX run's every round."""
    pubs = every_round(48)
    seen = []
    trail, st = paired("full", True, pubs, 48)
    assert len(pubs) > M
    for leaves in trail:
        seen.append(int(np.count_nonzero(leaves[".inflight"])))
    assert min(seen[8:]) > 0     # in flight through the recycles
    # every slot holds a message: the table wrapped
    assert (st.core.msgs.birth >= 0).all() and int(st.core.msgs.birth.min()) >= 48 - M


def test_ring_resumes_bit_exact_from_checkpoint(tmp_path):
    pubs = tuple((o, r) for r, o in enumerate(range(3, 33, 2), 3))
    tail = tuple((o, r - 20) for o, r in pubs if r >= 20)
    net, _cfg, st, step = port_build("full", True)
    st_mid = drive(step, st, pub_rows(pubs, 20))
    assert st_mid.inflight.any()      # the ring is mid-flight at the save
    path = os.path.join(str(tmp_path), "ring.ckpt")
    checkpoint.save(path, st_mid)
    gold = drive(step, st_mid, pub_rows(tail, 20))
    # resume: a fresh template, restored, the same tail
    _n, _c, st0, step2 = port_build("full", True)
    back = checkpoint.restore(path, st0)
    diff_leaves(convert.state_leaves(st_mid), convert.state_leaves(back), "restored")
    res = drive(step2, back, pub_rows(tail, 20))
    diff_leaves(convert.state_leaves(gold), convert.state_leaves(res), "ring resume")
    # the JAX package reads the port's file and resumes to the same tail
    jnet, jcfg, jstep = jax_build("full", True)
    jst = jcheckpoint.restore(path, jinit(JState.init, jnet, M, jcfg, seed=0))
    po, pt, pv = pub_rows(tail, 20)
    for r in range(20):
        jst = jstep(jst, jnp.asarray(po[r]), jnp.asarray(pt[r]), jnp.asarray(pv[r]))
    diff_leaves(reference_leaves(jst), convert.state_leaves(res), "JAX resume")


def test_router_window_equals_eager():
    pubs = every_round(16, start=1)
    _trail, want = port_run("full", True, pubs, 16)
    net, _cfg, st, step = port_build("full", True, "csr")
    run = driver.make_scan(step)
    got = run(st, *(torch.from_numpy(a) for a in pub_rows(pubs, 16)))
    diff_leaves(convert.state_leaves(want), convert.state_leaves(densify_edge_planes(net, got)),
                "window")


# ---------------------------------------------------------------------------
# the primitives on random planes


def _u32(rng, *shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _w(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.mark.parametrize("alpha", [0.25, 0.1, 0.3, 0.7, 1.0])
def test_lateness_ema_float_form_equals_jitted_reference(alpha):
    """The EMA's float form on random counters (sparse and dense traffic,
    quiet edges, EMAs near the subnormal range) against the jitted JAX
    update: XLA:CPU contracts ``(1 - a) * ema`` into the add."""
    rng = np.random.default_rng(int(alpha * 100))
    n, k, w = 512, 16, 2
    ema = rng.random((n, k)).astype(np.float32)
    ema[:16] = np.float32(1e-37)
    trans = _u32(rng, n, k, w) & _u32(rng, n, k, w)
    trans[::3] &= np.uint32(0x11)
    trans[::7] = 0
    fe, new = _u32(rng, n, k, w), _u32(rng, n, w)
    jr = jrouters.RouterConfig(choke=True, choke_ema_alpha=alpha)
    want = np.asarray(jax.jit(lambda *a: jrouters.choke_lateness_update(jr, *a))(
        jnp.asarray(ema), jnp.asarray(trans), jnp.asarray(fe), jnp.asarray(new)))
    got = routers.choke_lateness_update(RouterConfig(choke=True, choke_ema_alpha=alpha),
                                        torch.from_numpy(ema), _w(trans), _w(fe), _w(new))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_choke_and_ring_primitives_equal_reference():
    rng = np.random.default_rng(5)
    n, s, k, w, L = 64, 2, 16, 3, 5
    rc = dict(choke=True, choke_threshold=0.6, unchoke_threshold=0.2, choke_max_per_hb=2)
    jr, tr = jrouters.RouterConfig(**rc), RouterConfig(**rc)
    mesh = rng.random((n, s, k)) < 0.5
    choked = (rng.random((n, s, k)) < 0.3) & mesh
    # EMAs on a coarse grid (ties) and on the thresholds' float32 values
    ema = (rng.integers(0, 9, (n, k)) / 8).astype(np.float32)
    ema[0, :4] = np.float32(0.6)
    ema[1, :4] = np.float32(0.2)
    # the reference's ops jitted (compares, counts and selections: the same
    # bits as eager), one compile each instead of one an op
    decide = jax.jit(lambda *a, dlo: jrouters.choke_decide(jr, dlo, *a), static_argnames="dlo")
    guard = jax.jit(jrouters.choke_guard, static_argnums=0)
    for dlo in (0, 3, 5):
        got = routers.choke_decide(tr, dlo, torch.from_numpy(mesh), torch.from_numpy(choked),
                                   torch.from_numpy(ema))
        want = decide(jnp.asarray(mesh), jnp.asarray(choked), jnp.asarray(ema), dlo=dlo)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(
            routers.choke_guard(dlo, torch.from_numpy(mesh), torch.from_numpy(choked)).numpy(),
            np.asarray(guard(dlo, jnp.asarray(mesh), jnp.asarray(choked))))
    np.testing.assert_array_equal(routers.choke_suppression(torch.from_numpy(choked)).numpy(),
                                  np.asarray(jrouters.choke_suppression(jnp.asarray(choked))))
    # the ring: commit (delays 0..L), keep; IDONTWANT's three
    inflight, mask = _u32(rng, n, k, L, w), _u32(rng, n, k, w)
    delay = rng.integers(0, L + 1, (n, k)).astype(np.int32)
    keep = _u32(rng, w)
    arr, nxt = routers.ring_commit(_w(inflight), _w(mask), torch.from_numpy(delay))
    jarr, jnxt = jax.jit(jrouters.ring_commit)(jnp.asarray(inflight), jnp.asarray(mask),
                                               jnp.asarray(delay))
    for g, x in ((arr, jarr), (nxt, jnxt),
                 (routers.ring_keep(_w(inflight), _w(keep)),
                  jrouters.ring_keep(jnp.asarray(inflight), jnp.asarray(keep)))):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(x))
    assert routers.ring_init((n, k, w), L).shape == jrouters.ring_init((n, k, w), L).shape
    assert routers.ring_init((40, w), L).shape == (40, L, w)
    recv, joined, dw = _u32(rng, n, w), _u32(rng, n, w), _u32(rng, n, w)
    mesh_edge = mesh.any(1)
    for thr in (1.0, 1.5):
        jr2 = jrouters.RouterConfig(idontwant=True, idontwant_threshold=thr)
        tr2 = RouterConfig(idontwant=True, idontwant_threshold=thr)
        ann = routers.dontwant_announcements(tr2, _w(recv), _w(joined))
        jann = jrouters.dontwant_announcements(jr2, jnp.asarray(recv), jnp.asarray(joined))
        np.testing.assert_array_equal(ann.numpy().view(np.uint32), np.asarray(jann))
        cnt = routers.idontwant_sent_count(ann, torch.from_numpy(mesh_edge))
        assert cnt.dtype == torch.int32
        assert int(cnt) == int(jrouters.idontwant_sent_count(jann, jnp.asarray(mesh_edge)))
    np.testing.assert_array_equal(
        routers.dontwant_suppression(_w(dw), torch.from_numpy(mesh_edge)).numpy().view(np.uint32),
        np.asarray(jrouters.dontwant_suppression(jnp.asarray(dw), jnp.asarray(mesh_edge))))


# ---------------------------------------------------------------------------
# choke under churn and link loss on the scored bench lattice


def test_choke_with_dynamic_peers_and_loss_on_the_scored_lattice():
    """The scored bench config on ring_lattice(64, 4) (banded, K = 8) with
    every router switch on, the ring from the lattice's latency classes,
    i.i.d. link loss 0.05 (the router smoke's) and a quarter of the peers
    down in rounds 8-15: the peer transitions
    forget a down peer's IDONTWANT set, clear the EMA and the ring on dead
    edges and re-run the choke guard on the post-churn mesh; every leaf
    equal to the JAX run's every round."""
    n, rounds = 64, 24
    jt, tt = jgraph.ring_lattice(n, d=4), graph.ring_lattice(n, d=4)
    nbr, ok = np.asarray(tt.nbr), np.asarray(tt.nbr_ok)
    rows = np.broadcast_to(np.arange(n)[:, None], nbr.shape)
    pairs = np.unique(np.stack([np.minimum(rows, nbr)[ok], np.maximum(rows, nbr)[ok]], 1), axis=0)
    el = topogen.attach_latency_classes(topogen.EdgeList(n=n, edges=pairs.astype(np.int32)),
                                        n_clusters=4)
    delay, L = topogen.link_delay_plane(el, tt)
    jdelay, _jl = jtopo.link_delay_plane(jtopo.attach_latency_classes(
        jtopo.EdgeList(n=n, edges=pairs.astype(np.int32)), n_clusters=4), jt)
    assert delay.tobytes() == jdelay.tobytes() and L > 0
    builds = bench_builds(n=n, d=4, topologies=(jt, tt), chaos=dict(loss_rate=0.05),
                          router=dict(idontwant=True, choke_threshold=0.3,
                                      unchoke_threshold=0.1, choke=True, latency_rounds=L))
    up = np.ones((rounds, n), bool)
    up[8:16, ::4] = False
    seen = dict(choke=0, ring=0)

    def observe(st):
        seen["choke"] = max(seen["choke"], int(st.choked.sum()))
        seen["ring"] = max(seen["ring"], int(st.inflight.count_nonzero()))

    st = rounds_against_reference(builds, rounds, up=up, observe=observe,
                                  step_kw=dict(dynamic_peers=True, link_delay=delay))
    ev = events(st)
    assert ev[EV.REMOVE_PEER] == ev[EV.ADD_PEER] == 16
    assert ev[EV.IDONTWANT_SENT] > 0 and ev[EV.DUP_SUPPRESSED] > 0
    assert seen["ring"] > 0 and ev[EV.CHOKE] > 0


# ---------------------------------------------------------------------------
# the oracle's choke properties on a lived-in choke state


@functools.cache
def choke_lived_in():
    """The lived-in choke state (the port's, equal to the JAX run's) with
    both nets and configs and the due row its clean check passes."""
    trail, st = paired("choke", True, CHOKE_PUBS, 60)
    jnet, jcfg, _ = jax_build("choke", True)
    tnet, tcfg, _s, _t = port_build("choke", True)
    return trail[-1], jnet, jcfg, tnet, tcfg, jinv.due_vector(quiet=(0, 60))


def choke_verdicts(leaves, due) -> dict:
    """Both checkers on the state of ``leaves``: the verdict vectors equal;
    {name: verdict}."""
    from test_torch_invariants import jax_state

    _l, jnet, jcfg, tnet, tcfg, _due = choke_lived_in()
    jst = jax_state(jinit(JState.init, jnet, M, jcfg, seed=0), leaves)
    icfg = dict(delivery_window=12)
    # the JAX checker jitted: one compile, not one an op (its predicates
    # compare and count; no float arithmetic to fuse)
    want = np.asarray(jax.jit(lambda s: jinv.check_state(
        "gossipsub", jnet, s, jcfg, jinv.InvariantConfig(**icfg), due=due))(jst))
    got = tinv.check_state("gossipsub", tnet, convert.state_from_reference(leaves, "cpu"),
                           tcfg, tinv.InvariantConfig(**icfg), due=due)
    np.testing.assert_array_equal(got.numpy(), want)
    return dict(zip(tinv.invariant_names("gossipsub"), want.tolist()))


def test_clean_choke_run_passes_all():
    leaves, *_rest, due = choke_lived_in()
    assert leaves[".choked"].any()
    res = choke_verdicts(leaves, due)
    assert "choke-wf" in res and "no-choke-below-dlo" in res
    assert all(res.values()), [k for k, v in res.items() if not v]


@pytest.mark.parametrize("name", ["choke-wf", "no-choke-below-dlo"])
def test_seeded_choke_violation_trips_its_property(name):
    leaves, jnet, *_rest, due = choke_lived_in()
    c = dataclasses.make_dataclass("C", ["nbr", "protocol", "dlo", "quiet"])(
        np.asarray(jnet.nbr), np.asarray(jnet.protocol), GossipSubConfig().Dlo, due)
    bad, net_over, kw = seeded_violation(name, c, leaves)
    assert not net_over and not kw
    # the corruption edits the run's own choke plane
    assert (bad[".choked"] != leaves[".choked"]).any() and leaves[".choked"].any()
    failed = {k for k, v in choke_verdicts(bad, due).items() if not v}
    assert failed == {name}, sorted(failed)
