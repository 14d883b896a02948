"""The telemetry panel (``telemetry/``) in the port against the JAX
package's: the catalogs and the host helpers equal, and every engine's
panel (and flight recorder) equal leaf for leaf every round or phase — the
per-round GossipSub step under chaos and churn on the lattice, the phase
engine at r = 1 on the lattice and r = 8 on a random dense net, FloodSub
CSR-resident and RandomSub on the lattice under chaos, FloodSub past the
panel's capacity — and ``reconcile`` empty on each; the twins of the JAX
package's tests/test_telemetry.py:113-409 and :445 (no leaves when off,
bitwise additivity, the flight recorder, the checkpoint round trip, which
both packages read, ``timeline_block`` without the artifact writer); and a
recording window against its eager loop. The panel under attack is
``tests/test_torch_adversary.py``'s (lattice, r = 8).

No column takes a tolerance: the float columns follow the JAX package's
float forms on XLA:CPU (``telemetry/panel.py``), mapped on random planes
against its compiled recorder before these runs — the row sums left to
right, a division by a build constant as a reciprocal multiply, the
quantile's fused multiply-add, each keyed on whether the JAX program holds
the live edges as build constants (the churn cell holds the other form) —
and the port's FloodSub records with its net's planes as run-time values,
as the JAX step takes its net."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_randomsub import nets, schedule
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    phases_against_reference,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import checkpoint as jcheckpoint
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import telemetry as jtel
from go_libp2p_pubsub_tpu.chaos import ChaosConfig as JChaos
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models import randomsub as jrs
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import checkpoint, convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import telemetry as ttel
from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig as TChaos
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim
from go_libp2p_pubsub_tpu_torch.telemetry.panel import TelemetryConfigError
from go_libp2p_pubsub_tpu_torch.trace.events import EV, N_EVENTS

N, M = 64, 64
IID = dict(loss_rate=0.35)


def pair(rows, tracked=()):
    """(JAX, port) TelemetryConfigs of one shape."""
    return jtel.TelemetryConfig(rows=rows, tracked=tracked), ttel.TelemetryConfig(
        rows=rows, tracked=tracked)


def test_catalogs_equal_reference():
    for name in ("EV_METRICS", "RECONCILED", "METRICS", "FLIGHT_METRICS", "N_METRICS",
                 "N_FLIGHT"):
        assert getattr(ttel, name) == getattr(jtel, name), name
    assert ttel.STATE_METRICS == jtel.panel.STATE_METRICS
    assert list(ttel.EV_METRICS) == [f"ev_{e.name.lower()}" for e in EV]
    assert ttel.N_METRICS == 1 + N_EVENTS + 7
    assert ttel.metric_index("ev_deliver_message") == 1 + int(EV.DELIVER_MESSAGE)
    with pytest.raises(TelemetryConfigError):
        ttel.TelemetryConfig(rows=0).validate()
    with pytest.raises(TelemetryConfigError):
        ttel.TelemetryConfig(rows=4, tracked=[0, 1]).validate()     # not hashable
    with pytest.raises(TelemetryConfigError):
        TSim.init(8, 32, device="cpu", telemetry=ttel.TelemetryConfig(rows=4, tracked=(-1,)))


def test_host_helpers_equal_reference():
    """``panel_ev_totals``, ``reconcile`` (with a planted mismatch),
    ``reconcile_batched``, ``rows_used`` and ``timeline_block`` (the JAX
    test's artifact block, without the artifact writer) on random panels."""
    rng = np.random.default_rng(0)
    panels = rng.random((3, 6, ttel.N_METRICS)).astype(np.float32)
    panels[..., 1:1 + N_EVENTS] = rng.integers(0, 50, (3, 6, N_EVENTS))
    events = panels[..., 1:1 + N_EVENTS].sum(1).astype(np.int32)
    events[1, int(EV.GRAFT)] += 1
    assert (ttel.panel_ev_totals(panels[0]) == jtel.panel_ev_totals(panels[0])).all()
    assert ttel.reconcile(panels[1], events[1]) == jtel.reconcile(panels[1], events[1]) != []
    assert ttel.reconcile(torch.from_numpy(panels[0]), torch.from_numpy(events[0])) == []
    assert ttel.reconcile_batched(panels, events) == jtel.reconcile_batched(panels, events)
    assert ttel.rows_used(panels[0], 8, 2) == jtel.rows_used(panels[0], 8, 2) == 4
    for args in ((panels, 2), (panels[0],)):
        assert ttel.timeline_block(*args) == jtel.timeline_block(*args)
    tl = ttel.timeline_block(panels, rounds_per_row=2, rows=5)
    assert tl["n_sims"] == 3 and tl["rows"] == 5 and set(tl["series"]) == set(ttel.METRICS)
    with pytest.raises(ValueError):
        ttel.panel_ev_totals(panels)


@pytest.mark.parametrize("kind", ["random", "lattice", "powerlaw64", "powerlaw33",
                                  "powerlaw40", "powerlaw48", "powerlaw63", "powerlaw65",
                                  "powerlaw100"])
def test_panel_float_forms_on_random_planes(kind):
    """The recorder's float map against the JAX package's compiled
    ``record_step`` on random planes (scores over 12 binades, zeros of
    both signs, dead edges), with the live edges a build constant (the
    per-round, phase and RandomSub steps on a static net) and a traced
    argument (the live view under dynamic peers or PX): every column and
    flight column bit for bit, on a random net, the lattice (K = 16) and
    power-law graphs padded to K = 33, 40, 48, 63, 64, 65 and 100 (the
    row sum's tree-reduction windows: two at 33-64, three at 65, four at
    100, no tolerance)."""
    import jax

    from go_libp2p_pubsub_tpu import topo as jtopo
    from go_libp2p_pubsub_tpu.state import Net as JNet
    from go_libp2p_pubsub_tpu_torch import topo as ttopo
    from go_libp2p_pubsub_tpu_torch.state import Delivery, MsgTable
    from go_libp2p_pubsub_tpu_torch.state import Net as TNet
    from go_libp2p_pubsub_tpu_torch.state import replace

    n, m = 160, 64
    if kind == "random":
        topos = jgraph.random_connect(n, 3, seed=4), tgraph.random_connect(n, 3, seed=4)
    elif kind == "lattice":
        topos = jgraph.ring_lattice(n, d=8), tgraph.ring_lattice(n, d=8)
    else:
        kmax = int(kind[len("powerlaw"):])
        topos = tuple(t.to_topology(t.powerlaw(n, 2.2, d_min=2, max_degree=kmax, seed=0),
                                    max_degree=kmax) for t in (jtopo, ttopo))
    jnet = JNet.build(topos[0], jgraph.subscribe_all(n, 1))
    tnet = TNet.build(topos[1], tgraph.subscribe_all(n, 1), device="cpu")
    k = tnet.max_degree
    assert kind[:8] != "powerlaw" or k == int(kind[8:])
    rng = np.random.default_rng(k)
    # a live view: dead edges, and three peers with no live edge
    live = tnet.nbr_ok.numpy() & (rng.random((n, k)) < 0.85)
    live[:3] = False
    jnet = jnet.replace(nbr_ok=jnp.asarray(live))
    tnet = replace(tnet, nbr_ok=torch.from_numpy(live))
    birth = rng.integers(-1, 10, m).astype(np.int32)
    planes = dict(
        birth=birth, origin=rng.integers(0, n, m).astype(np.int32),
        topic=np.where(birth >= 0, 0, -1).astype(np.int32),
        fr=np.where(rng.random((n, m)) < 0.6, rng.integers(0, 10, (n, m)), -1).astype(np.int32),
        mesh=rng.random((n, 1, k)) < 0.4, bo=rng.random((n, 1, k)) < 0.2,
        have=rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32),
        ev0=rng.integers(0, 1000, N_EVENTS).astype(np.int32))
    planes["ev1"] = planes["ev0"] + rng.integers(0, 1000, N_EVENTS).astype(np.int32)
    sc = (rng.standard_normal((n, k)) * np.exp(rng.standard_normal((n, k)) * 3)).astype(np.float32)
    sc[rng.random((n, k)) < 0.1] = 0.0
    sc[rng.random((n, k)) < 0.05] = -0.0
    # every peer tracked: the flight recorder's score_mean holds each
    # peer's row sum, not only the three order statistics the panel reads
    jcfg, tcfg = pair(4, tuple(range(n)))
    jst = jinit(JSim.init, n, m, k=k, telemetry=jcfg)
    jmsgs = jst.msgs.replace(**{f: jnp.asarray(planes[f]) for f in ("birth", "origin", "topic")})
    jdlv = jst.dlv.replace(first_round=jnp.asarray(planes["fr"]), have=jnp.asarray(planes["have"]))
    tmsgs = MsgTable.empty(m, "cpu")
    for f in ("birth", "origin", "topic"):
        setattr(tmsgs, f, torch.from_numpy(planes[f]))
    tdlv = Delivery.empty(n, m, k, "cpu")
    tdlv.first_round = torch.from_numpy(planes["fr"])
    tdlv.have = torch.from_numpy(planes["have"].view(np.int32))
    args = [jnp.asarray(planes[f]) for f in ("ev0", "ev1", "mesh")] + [
        jnp.asarray(sc), jnp.asarray(planes["bo"])]
    for static in (True, False):
        rec = lambda net, telem, msgs, dlv, e0, e1, mesh, scores, bo: jtel.record_step(
            jcfg, telem, jnp.int32(2), e0, e1, net, msgs, dlv, mesh=mesh,
            my_topics=net.my_topics, scores=scores, backoff_active=bo)
        if static:
            want = jax.jit(lambda *a: rec(jnet, *a))(jst.telem, jmsgs, jdlv, *args)
        else:
            want = jax.jit(lambda live, *a: rec(jnet.replace(nbr_ok=live), *a))(
                jnet.nbr_ok, jst.telem, jmsgs, jdlv, *args)
        got = ttel.record_step(
            tcfg, ttel.TelemetryState.empty(tcfg, "cpu"), torch.tensor(2, dtype=torch.int32),
            *(torch.from_numpy(planes[f]) for f in ("ev0", "ev1")), tnet, tmsgs, tdlv,
            mesh=torch.from_numpy(planes["mesh"]), my_topics=tnet.my_topics,
            scores=torch.from_numpy(sc), backoff_active=torch.from_numpy(planes["bo"]),
            static_live=static)
        for leaf in ("panel", "flight"):
            a = np.asarray(getattr(want, leaf)).view(np.uint32)
            b = getattr(got, leaf).numpy().view(np.uint32)
            assert np.array_equal(a, b), (k, static, leaf, np.argwhere(a != b)[:4].tolist())


# ---------------------------------------------------------------------------
# every engine's panel, leaf for leaf, reconciled


def test_per_round_step_under_chaos_and_churn_equals_reference():
    """Peer 5 leaves and returns and peer 11 leaves for good, under i.i.d.
    flaps: ADD/REMOVE_PEER and LINK_DOWN move and the live view's counts
    divide as run-time values."""
    rounds = 12
    up = np.ones((rounds, N), bool)
    up[4:8, 5] = False
    up[6:, 11] = False
    st = rounds_against_reference(bench_builds(n=N, d=4, chaos=IID), rounds, up=up,
                                  step_kw={"dynamic_peers": True},
                                  telemetry=pair(rounds, (0, 5, 40)))
    panel, events = st.core.telem.panel.numpy(), st.core.events
    assert ttel.reconcile(panel, events) == []
    totals = ttel.panel_ev_totals(panel)
    assert totals[EV.DELIVER_MESSAGE] > 0 and totals[EV.LINK_DOWN] > 0
    assert totals[EV.REMOVE_PEER] >= 2 and totals[EV.ADD_PEER] >= 1
    dr = panel[:, ttel.metric_index("delivery_ratio")]
    assert 0.0 <= dr.min() and dr.max() <= 1.0
    assert panel[-1, ttel.metric_index("mesh_deg_mean")] > 0.0


def test_scored_engine_on_powerlaw48_equals_reference():
    """A scored per-round run with the panel on a power-law graph padded to
    K = 48, whose per-peer score sum takes the two-window order: every
    leaf, the panel's score quantile columns included, bit for bit every
    round."""
    from go_libp2p_pubsub_tpu import topo as jtopo
    from go_libp2p_pubsub_tpu_torch import topo as ttopo

    topos = tuple(t.to_topology(t.powerlaw(N, 2.2, d_min=3, max_degree=48, seed=2),
                                max_degree=48) for t in (jtopo, ttopo))
    builds = bench_builds(n=N, d=4, topologies=topos)
    assert builds[4].max_degree == 48
    rounds = 10
    st = rounds_against_reference(builds, rounds, telemetry=pair(rounds, (0, 7)))
    panel = st.core.telem.panel.numpy()
    assert ttel.reconcile(panel, st.core.events) == []
    q = panel[:, [ttel.metric_index(c) for c in ("score_p5", "score_p50", "score_p95")]]
    assert (q != 0.0).any()


@pytest.mark.parametrize("r,net", [(1, "lattice"), (8, "random")])
def test_phase_engine_equals_reference(r, net):
    """One row a phase, its deltas over the head, every sub-round and the
    tail heartbeat; r = 8 under i.i.d. flaps on a random dense net."""
    kw = {}
    if net == "random":
        kw = dict(topologies=(jgraph.random_connect(N, 5, seed=3),
                              tgraph.random_connect(N, 5, seed=3)), chaos=IID)
    rounds = 16 if r > 1 else 10
    st = phases_against_reference(bench_builds(n=N, d=4, heartbeat_every=r, **kw), r, r,
                                  rounds, telemetry=pair(rounds // r, (1, 33)))
    panel = st.core.telem.panel.numpy()
    assert ttel.reconcile(panel, st.core.events) == []
    assert ttel.panel_ev_totals(panel)[EV.DELIVER_MESSAGE] > 0
    assert ttel.rows_used(panel, rounds, rounds_per_row=r) == rounds // r


def _sim_run(router, layout, rows, rounds, chaos=None):
    """FloodSub or RandomSub of both packages with the panel, every leaf every
    round; returns the port's final state."""
    jnet, tnet = nets("lattice" if layout == "dense" else "powerlaw", layout, n=N)
    jt, tt = pair(rows)
    jc, tc = (JChaos(**chaos), TChaos(**chaos)) if chaos else (None, None)
    jst = jinit(JSim.init, N, M, seed=2, k=jnet.max_degree, n_edges=jnet.n_edges, telemetry=jt)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    if router == "floodsub":
        jstep = lambda s, *a: jflood.floodsub_step(jnet, s, *a, chaos=jc, telemetry=jt)
        tstep = lambda s, *a: tflood.floodsub_step(tnet, s, *a, chaos=tc, telemetry=tt)
    else:
        jstep = jrs.make_randomsub_step(jnet, chaos=jc, telemetry=jt)
        tstep = trs.make_randomsub_step(tnet, chaos=tc, telemetry=tt)
    po, pt, pv = schedule(N, rounds)
    for r in range(rounds):
        jst = jstep(jst, *(jnp.asarray(x[r]) for x in (po, pt, pv)))
        tst = tstep(tst, *(torch.from_numpy(x[r]) for x in (po, pt, pv)))
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"{router} round {r}")
    return tst


@pytest.mark.parametrize("router,layout", [("floodsub", "csr"), ("randomsub", "dense")])
def test_sim_engines_under_chaos_equal_reference(router, layout):
    st = _sim_run(router, layout, 10, 10, IID)
    panel = st.telem.panel.numpy()
    assert ttel.reconcile(panel, st.events) == []
    totals = ttel.panel_ev_totals(panel)
    assert totals[EV.DELIVER_MESSAGE] > 0 and totals[EV.LINK_DOWN] > 0
    # a mesh-less engine records zeros in the mesh and score columns
    for name in ("mesh_deg_mean", "score_p50"):
        assert not panel[:, ttel.metric_index(name)].any()


def test_rows_past_capacity_drop_without_wrap():
    """Observations past the capacity drop on the device (no wrap): the
    panel after 8 rounds is the panel after 4."""
    st = _sim_run("floodsub", "dense", 4, 8)
    panel = st.telem.panel.numpy()
    assert ttel.rows_used(panel, 8) == 4
    assert (panel[:, 1:1 + N_EVENTS].sum(0) < st.events.numpy()).any()
    tnet = nets("lattice", n=N)[1]
    short = TSim.init(N, M, seed=2, k=tnet.max_degree, device="cpu",
                      telemetry=ttel.TelemetryConfig(rows=4))
    po, pt, pv = (torch.from_numpy(a) for a in schedule(N, 8))
    for r in range(4):
        short = tflood.floodsub_step(tnet, short, po[r], pt[r], pv[r],
                                     telemetry=ttel.TelemetryConfig(rows=4))
    assert torch.equal(short.telem.panel, st.telem.panel)
    assert ttel.reconcile(short.telem.panel, short.events) == []


# ---------------------------------------------------------------------------
# the JAX tests' twins


def _gossip(telemetry, rounds=8, r=1, tracked=()):
    """The port's per-round step (r = 1) or phase engine on the lattice with
    or without the panel; returns the final state."""
    _j, _jn, _js, tcfg, tnet, tsp = bench_builds(n=N, d=4, heartbeat_every=r)
    tel = ttel.TelemetryConfig(rows=rounds, tracked=tracked) if telemetry else None
    st = TState.init(tnet, M, tcfg, score_params=tsp, seed=6, telemetry=tel)
    po, pt, pv = (torch.from_numpy(a) for a in schedule(N, rounds))
    if r == 1:
        step = make_gossipsub_step(tcfg, tnet, score_params=tsp, telemetry=tel)
        for i in range(rounds):
            st = step(st, po[i], pt[i], pv[i])
        return st
    step = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp, telemetry=tel)
    for p in range(rounds // r):
        sl = slice(p * r, (p + 1) * r)
        st = step(st, po[sl], pt[sl], pv[sl], do_heartbeat=True)
    return st


def test_telemetry_off_adds_no_state_leaves():
    off = TSim.init(N, M, seed=0, k=16, device="cpu")
    assert off.telem is None and not any("telem" in p for p in convert.leaf_specs(off))
    assert _gossip(False).core.telem is None


@pytest.mark.parametrize("r", [1, 4])
def test_telemetry_on_is_bitwise_additive(r):
    """Stripping the panel from a recording run leaves the run without it,
    bit for bit, in the per-round step and the phase engine."""
    off = convert.state_leaves(_gossip(False, r=r))
    on = convert.state_leaves(_gossip(True, r=r, tracked=(0, 3)))
    assert {p for p in on if "telem" in p} == {".core.telem.panel", ".core.telem.flight"}
    diff_leaves(off, {p: v for p, v in on.items() if "telem" not in p}, f"additive r{r}")


def test_flight_recorder_tracks_peer_trajectories():
    rounds, tracked = 10, (0, 9, 17)
    st = _gossip(True, rounds=rounds, tracked=tracked)
    flight = st.core.telem.flight.numpy()
    assert flight.shape == (rounds, len(tracked), ttel.N_FLIGHT)
    fi = {m: i for i, m in enumerate(ttel.FLIGHT_METRICS)}
    for k, peer in enumerate(tracked):
        assert flight[-1, k, fi["mesh_degree"]] == st.mesh[peer].sum()
        held = int(torch.stack([(st.core.dlv.have[peer] >> b) & 1 for b in range(32)]).sum())
        assert flight[-1, k, fi["msgs_held"]] == held
    assert flight[:, :, fi["mesh_degree"]].max() > 0
    assert ttel.TelemetryState.empty(ttel.TelemetryConfig(rows=4)).flight is None


def test_checkpoint_roundtrip_telemetry_carry(tmp_path):
    """The panel rides v6 with no format bump: a recording state round-trips
    and resumes the uninterrupted run, the JAX package restores the port's
    file and the port the JAX package's, and a template without the panel
    refuses the file."""
    rounds = 6
    jt, tt = pair(rounds, (2,))
    jcfg, jnet, jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4)
    step = make_gossipsub_step(tcfg, tnet, score_params=tsp, telemetry=tt)
    po, pt, pv = (torch.from_numpy(a) for a in schedule(N, rounds))
    template = lambda: TState.init(tnet, M, tcfg, score_params=tsp, seed=9, telemetry=tt)
    st = template()
    for i in range(4):
        st = step(st, po[i], pt[i], pv[i])
    path = str(tmp_path / "telem.npz")
    checkpoint.save(path, st)
    resumed = checkpoint.restore(path, template())
    diff_leaves(convert.state_leaves(st), convert.state_leaves(resumed), "restore")
    for i in range(4, rounds):
        st, resumed = (step(s, po[i], pt[i], pv[i]) for s in (st, resumed))
    diff_leaves(convert.state_leaves(st), convert.state_leaves(resumed), "resume")
    assert ttel.reconcile(resumed.core.telem.panel, resumed.core.events) == []
    # both packages read each other's files
    jtemplate = jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=9, telemetry=jt)
    jst = jcheckpoint.restore(path, jtemplate)
    diff_leaves(reference_leaves(jst), convert.state_leaves(checkpoint.restore(path, template())),
                "JAX restore of the port's file")
    jpath = str(tmp_path / "telem_jax.npz")
    jcheckpoint.save(jpath, jst)
    diff_leaves(reference_leaves(jst), convert.state_leaves(checkpoint.restore(jpath, template())),
                "port restore of the JAX file")
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, TState.init(tnet, M, tcfg, score_params=tsp, seed=9))


def test_recording_window_equals_eager():
    """A recording per-round step through ``make_scan`` equals its eager
    loop, panel and flight recorder included (the panel is a state leaf: a
    window needs no new row)."""
    _j, _jn, _js, tcfg, tnet, tsp = bench_builds(n=N, d=4)
    tel = ttel.TelemetryConfig(rows=8, tracked=(4,))
    step = make_gossipsub_step(tcfg, tnet, score_params=tsp, telemetry=tel)
    po, pt, pv = (torch.from_numpy(a) for a in schedule(N, 8))
    st0 = TState.init(tnet, M, tcfg, score_params=tsp, seed=1, telemetry=tel)
    eager = st0
    for i in range(8):
        eager = step(eager, po[i], pt[i], pv[i])
    win = driver.make_scan(step)(st0, po, pt, pv)
    diff_leaves(convert.state_leaves(eager), convert.state_leaves(win), "recording window")
    assert ttel.reconcile(win.core.telem.panel, win.core.events) == []
    assert dataclasses.is_dataclass(win.core.telem)
