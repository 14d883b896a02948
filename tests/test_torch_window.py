"""The port's run windows (``driver.make_window``/``make_scan``) against the
JAX package's, leaf by leaf, bit for bit.

Both sides start from the same state (carried across with
``convert.state_from_reference``) and run the same numpy-made schedule
through a window: FloodSub on the lattice (dense, banded) and on a ragged
power-law graph (CSR-resident), the per-round GossipSub step with
``static_heartbeat`` at he=2, and the phase engine at r=1 and r=8 on the
lattice. The r=8 cell also runs the port's phase engine CSR-resident on the
same lattice, whose final state, densified, must equal the JAX package's
dense window's (``tests/test_csr.py`` pins the JAX package's dense and CSR
engines equal), so one JAX window compile serves both. The port runs with
``device="cpu"``, where a window is the plain loop over dispatches (on the
card it is a captured CUDA graph: ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``). A fresh JAX state is built for every run: the JAX
windows donate their buffers."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eth2 import eth2_builds
from test_torch_sybil import GaterLog, sybil_builds, verdict_schedule
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    phase_schedule,
    reference_leaves,
    step_options,
)

from go_libp2p_pubsub_tpu import driver as jdriver
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake_step
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake_phase
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake_step
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step as tmake_phase
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import densify_edge_planes

N, M, ROUNDS = 64, 64, 16


def _flood_cell(kind):
    if kind == "lattice":
        jt, tt, layout = jgraph.ring_lattice(N, d=4), tgraph.ring_lattice(N, d=4), "dense"
    else:
        jt = jtopo.to_topology(jtopo.powerlaw(N, 2.2, 2, 16, seed=0), max_degree=16)
        tt = ttopo.to_topology(ttopo.powerlaw(N, 2.2, 2, 16, seed=0), max_degree=16)
        layout = "csr"
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 1), edge_layout=layout)
    tnet = TNet.build(tt, tgraph.subscribe_all(N, 1), edge_layout=layout, device="cpu")
    jst = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree,
                    n_edges=jnet.n_edges if layout == "csr" else None)
    return jnet, tnet, jst


def _obs_of(s):
    return {"tick": s.tick, "have": s.dlv.have.sum(0, dtype=torch.int32)}


def _jobs_of(s):
    return {"tick": s.tick, "have": s.dlv.have.sum(0, dtype=jnp.uint32)}


@pytest.mark.parametrize("kind", ["lattice", "powerlaw-csr"])
def test_floodsub_window_equals_reference(kind):
    """Every leaf after the window; on the lattice also ``observe``'s stack,
    against the JAX window's and against the per-dispatch series of the
    plain loop."""
    jnet, tnet, jst = _flood_cell(kind)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    start = tst
    po, pt, pv = phase_schedule(N, ROUNDS)
    observe = _obs_of if kind == "lattice" else None
    jwin = jdriver.make_window(lambda s, a, b, c: jflood.floodsub_step(jnet, s, a, b, c),
                               observe=observe and _jobs_of)
    twin = driver.make_window(lambda s, a, b, c: tflood.floodsub_step(tnet, s, a, b, c),
                              observe=observe)
    jst, jys = jwin(jst, (jnp.asarray(po), jnp.asarray(pt), jnp.asarray(pv)))
    tst, tys = twin(tst, (po, pt, pv))
    diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"floodsub {kind}")
    assert int(tst.tick) == ROUNDS
    assert (convert.state_leaves(tst)[".dlv.first_round"] >= 0).sum() > 4 * N
    if observe is None:
        assert jys == {} and tys == {}
        return
    series, s = [], start
    for i in range(ROUNDS):
        s = tflood.floodsub_step(tnet, s, *(torch.from_numpy(a[i]) for a in (po, pt, pv)))
        series.append(_obs_of(s))
    for name in ("tick", "have"):
        got = tys["obs"][name].numpy()
        np.testing.assert_array_equal(got, np.stack([x[name].numpy() for x in series]))
        want = np.asarray(jys["obs"][name])
        assert got.shape == want.shape and np.array_equal(got.view(want.dtype), want)


def _scan_pair(builds, r, he, rounds, static_heartbeat=None, port_builds=(), phase=None,
               schedule=None):
    """The JAX package's make_scan and the port's over the same schedule
    (``phase_schedule``'s, or ``schedule``) from the same fresh state, on
    the phase engine (``phase``, default r > 1) or the per-round step, with
    the builds' step options. Returns the JAX window's final leaves and the
    port's final state, then the port's final state on each of
    ``port_builds`` (more (cfg, net, sp) builds of the same graph)."""
    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    phase = r > 1 if phase is None else phase
    jkw, tkw = step_options(builds)

    def steps(cfg, net, sp, make_phase, make_step, opts):
        if phase:
            return make_phase(cfg, net, r, score_params=sp, **opts)
        return make_step(cfg, net, score_params=sp, static_heartbeat=bool(static_heartbeat),
                         **opts)

    jst = jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=0)
    leaves0 = reference_leaves(jst)
    po, pt, pv = schedule or phase_schedule(tnet.n_peers, rounds)
    kw = dict(heartbeat_every=he, rounds_per_phase=r,
              static_heartbeat=True if phase else static_heartbeat)
    if phase and r == 1:
        # make_scan hands a per-round step [P] rows: a phase step at r=1
        # takes [1, P] phases through make_window, as the JAX tests drive it
        po, pt, pv = (a[:, None] for a in (po, pt, pv))

        def scan(step, **kw):
            win = kw["driver"].make_window(step, heartbeat=kw["driver"].heartbeat_schedule(he, 1))
            return lambda st, *xs: win(st, xs)[0]
    else:
        def scan(step, **kw):
            return kw.pop("driver").make_scan(step, **kw)
    jst = scan(steps(jcfg, jnet, jsp, jmake_phase, jmake_step, jkw), driver=jdriver, **kw)(
        jst, jnp.asarray(po), jnp.asarray(pt), jnp.asarray(pv))
    out = [reference_leaves(jst)]
    for cfg, net, sp in ((tcfg, tnet, tsp),) + tuple(port_builds):
        tst = TState.init(net, M, cfg, score_params=sp, seed=0)
        if net.edge_layout == "dense":
            tst = convert.state_from_reference(leaves0, device="cpu")
        out.append(scan(steps(cfg, net, sp, tmake_phase, tmake_step, tkw), driver=driver,
                        **kw)(tst, po, pt, pv))
    return out


def test_phase_r8_scan_equals_reference():
    """The lattice at r=8, dense (banded: ``edge_exchange``'s plain
    version) and CSR-resident (the composite crossings)."""
    builds = bench_builds(n=N, d=4, heartbeat_every=8, count_events=False)
    csr = bench_builds(n=N, d=4, heartbeat_every=8, count_events=False,
                       edge_layout="csr", fused=True)
    ref, dense, flat = _scan_pair(builds, 8, 8, ROUNDS, port_builds=[csr[3:]])
    diff_leaves(ref, convert.state_leaves(dense), "r=8 dense")
    e = csr[4].n_edges
    assert flat.served_lo.shape[0] == flat.core.dlv.fe_words.shape[0] == e
    diff_leaves(ref, convert.state_leaves(densify_edge_planes(csr[4], flat)), "r=8 csr")
    assert ref[".core.tick"] == ROUNDS and ref[".mesh"].sum() > 0


def test_phase_r1_scan_equals_reference():
    builds = bench_builds(n=N, d=4, heartbeat_every=1, count_events=True)
    ref, got = _scan_pair(builds, 1, 1, ROUNDS, phase=True)
    got = convert.state_leaves(got)
    diff_leaves(ref, got, "r=1")
    assert got[".core.tick"] == ROUNDS and got[".core.events"].sum() > 0


def test_static_heartbeat_scan_equals_reference():
    builds = bench_builds(n=N, d=4, heartbeat_every=2, count_events=False)
    ref, got = _scan_pair(builds, 1, 2, ROUNDS, static_heartbeat=True)
    diff_leaves(ref, convert.state_leaves(got), "per-round he=2")
    assert int(got.core.tick) == ROUNDS


def test_eth2_phase_window_equals_reference():
    """The eth2 config's fanout plane through a phase window: the K=16
    lattice, 64 topics, 2 a peer, half the publishes on unjoined topics,
    r=8 with a heartbeat every phase."""
    builds = eth2_builds("lattice", 64, heartbeat_every=8, count_events=False)
    tnet = builds[4]
    sched = phase_schedule(tnet.n_peers, 32, my_topics=tnet.my_topics.numpy(), n_topics=64)
    ref, got = _scan_pair(builds, 8, 8, 32, schedule=sched)
    diff_leaves(ref, convert.state_leaves(got), "eth2 r=8 window")
    assert int(got.fanout_peers.sum()) > 0 and int((got.fanout_topic >= 0).sum()) > 0


def test_sybil_round_window_equals_reference():
    """The sybil config's gater, throttle and no-forward vector through a
    per-round window (the bench's continuity shape): the K=16 lattice,
    shared ip groups, a capacity of 2, rejected and ignored publishes."""
    builds = sybil_builds("lattice", 2, 3, count_events=False)
    ref, got = _scan_pair(builds, 1, 1, 24, schedule=verdict_schedule(24))
    diff_leaves(ref, convert.state_leaves(got), "sybil per-round window")
    log = GaterLog()
    log(got)
    assert log.throttle > 0 and log.reject > 0


def test_pipeline_phase_window_equals_reference():
    """The async-validation pipeline (V = 2) and the queue cap (2)
    through a phase window: the K=8 lattice at r=8, where the per-round
    step's fused kernels do not run and the phase engine's edge_exchange
    still does; the pipeline's stages are a captured leaf."""
    builds = bench_builds(n=N, d=4, heartbeat_every=8, count_events=True,
                          validation_delay_rounds=2, queue_cap=2)
    ref, got = _scan_pair(builds, 8, 8, ROUNDS)
    diff_leaves(ref, convert.state_leaves(got), "pipelined r=8 window")
    assert got.core.dlv.pending.shape[1] == 2 and int(got.core.events[8]) > 0


def test_donated_window_continues():
    """A second call from the state a ``donate=True`` window returned
    continues the run: two windows of 8 rounds end where one of 16 does."""
    _jcfg, _jnet, _jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4, heartbeat_every=8)
    step = tmake_phase(tcfg, tnet, 8, score_params=tsp)
    po, pt, pv = phase_schedule(N, ROUNDS)
    scan = driver.make_scan(step, heartbeat_every=8, rounds_per_phase=8)
    one = scan(_fresh(tcfg, tnet, tsp), po, pt, pv)
    two = scan(scan(_fresh(tcfg, tnet, tsp), po[:8], pt[:8], pv[:8]), po[8:], pt[8:], pv[8:])
    diff_leaves(convert.state_leaves(one), convert.state_leaves(two), "two windows")


def test_min_cycle_equals_reference():
    for flags in ([True, False, True, False], [True], [True, True, False],
                  [False, True] * 3, [True, False, False, True, False, False],
                  driver.heartbeat_schedule(3, 2), driver.heartbeat_schedule(8, 8)):
        assert driver.min_cycle(flags) == jdriver.min_cycle(flags)


def test_misaligned_lengths_raise():
    _jcfg, _jnet, _jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4, heartbeat_every=2)
    step = tmake_step(tcfg, tnet, score_params=tsp, static_heartbeat=True)
    po, pt, pv = phase_schedule(N, ROUNDS)
    win = driver.make_window(step, heartbeat=[True, False])
    with pytest.raises(ValueError, match="not a multiple"):
        win(_fresh(tcfg, tnet, tsp), (po[:3], pt[:3], pv[:3]))
    scan = driver.make_scan(step, heartbeat_every=4, static_heartbeat=True)
    with pytest.raises(ValueError, match="not a multiple"):
        scan(_fresh(tcfg, tnet, tsp), po[:6], pt[:6], pv[:6])
    with pytest.raises(ValueError, match="static_heartbeat"):
        driver.make_scan(step, heartbeat_every=2)


def _fresh(tcfg, tnet, tsp):
    return TState.init(tnet, M, tcfg, score_params=tsp, seed=0)


def test_unported_window_options_raise():
    _jcfg, _jnet, _jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4)
    step = tmake_step(tcfg, tnet, score_params=tsp)
    po, pt, pv = (a[:2] for a in phase_schedule(N, ROUNDS))
    # the folded checker is ported (tests/test_torch_window_check.py holds
    # it to the JAX windows): a checked window wants its due rows
    win = driver.make_window(step, check=lambda s, p, d: None, check_every=2)
    assert win.unit == 2
    with pytest.raises(ValueError, match="due rows"):
        win(_fresh(tcfg, tnet, tsp), (po, pt, pv))
    # the liveness schedule (tests/test_torch_churn.py) and the lifted
    # plane are ported, through make_window and make_scan alike
    # (tests/test_torch_lift.py holds the windows to their eager loops)
    from go_libp2p_pubsub_tpu_torch.score.params import ScoreParams

    lifted = tmake_step(tcfg, tnet, score_params=tsp, lift_scores=True)
    plane = ScoreParams.from_config(tcfg, tsp, device="cpu")
    st, _ = driver.make_window(lifted)(_fresh(tcfg, tnet, tsp), (po, pt, pv), consts=(plane,))
    assert int(st.core.tick) == 2
    st = driver.make_scan(lifted)(_fresh(tcfg, tnet, tsp), po, pt, pv, consts=(plane,))
    assert int(st.core.tick) == 2
