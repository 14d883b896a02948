"""The ensemble plane over the port's other planes, against the JAX package
on the CPU:

* the router plane: the choke smoke's C cell (``scripts/choke_smoke.py``:
  v1.2 IDONTWANT, the latency ring, episub lazy choking with the smoke's
  knobs, i.i.d. loss 0.05, mcache history 12 with 8 gossiped, sparse
  single publishes) at S = 2 on ``tests/test_torch_router.py``'s
  latency-classed ``powerlaw(48)``: the port's ensemble equals the JAX
  ensemble on every leaf, sim ``i`` equals the one-sim run under
  ``fold_in``, and both choke properties hold in every sim;
* the telemetry panel (the twin of ``tests/test_telemetry.py``'s
  ``test_reconcile_batched_s3_per_sim_exact``): at S = 3 every sim's
  panel reconciles against its own counters, equals the one-sim panel
  under ``fold_in`` bit for bit, and equals the JAX ensemble's panel: the
  reconciled columns (delivery ratio and event deltas, integer
  arithmetic) bit for bit, the derived float32 state columns (means,
  quantiles) within ``rtol=1e-5, atol=1e-6``, the tolerance the JAX test
  names, since vmap changes XLA's reduction order there;
* dynamic peers with a liveness schedule a sim (``[S, N]`` up rows).
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from go_libp2p_pubsub_tpu import ensemble as jens
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import routers as jrouters
from go_libp2p_pubsub_tpu.chaos import ChaosConfig as JChaos
from go_libp2p_pubsub_tpu.config import GossipSubParams as JParams
from go_libp2p_pubsub_tpu.config import PeerScoreParams as JScore
from go_libp2p_pubsub_tpu.config import PeerScoreThresholds as JThr
from go_libp2p_pubsub_tpu.config import TopicScoreParams as JTopic
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.telemetry import TelemetryConfig as JTelem

from go_libp2p_pubsub_tpu_torch import convert, ensemble, graph
from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig
from go_libp2p_pubsub_tpu_torch.config import (
    GossipSubParams,
    PeerScoreParams,
    PeerScoreThresholds,
    TopicScoreParams,
)
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig, make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
from go_libp2p_pubsub_tpu_torch.routers import RouterConfig
from go_libp2p_pubsub_tpu_torch.state import Net
from go_libp2p_pubsub_tpu_torch.telemetry import N_METRICS, TelemetryConfig, reconcile_batched
from go_libp2p_pubsub_tpu_torch.trace.events import EV, N_EVENTS
from test_torch_ensemble import M, gossip_builds, port_margs, port_state, schedule
from test_torch_router import graph_of
from torch_parity import diff_leaves, jinit, reference_leaves

#: scripts/choke_smoke.py's choke knobs
KNOBS = dict(choke_ema_alpha=0.4, choke_threshold=0.35, unchoke_threshold=0.1,
             choke_max_per_hb=2)
CHOKE_ROUNDS, CHOKE_MSGS = 40, 16


def smoke_schedule(n: int):
    """The smoke's sparse schedule: single publishes every 2 rounds from
    round 3, origins from default_rng(1)."""
    rng = np.random.default_rng(1)
    po = np.full((CHOKE_ROUNDS, 4), -1, np.int32)
    pt = np.zeros((CHOKE_ROUNDS, 4), np.int32)
    pv = np.zeros((CHOKE_ROUNDS, 4), bool)
    for i in range(CHOKE_MSGS):
        po[3 + 2 * i, 0], pv[3 + 2 * i, 0] = rng.integers(0, n), True
    return po, pt, pv


def test_choke_smoke_cell_as_an_ensemble():
    s = 2
    _el, topo, jtopology, delay, depth = graph_of(True)
    n = topo.nbr.shape[0]
    rk = dict(idontwant=True, latency_rounds=depth, choke=True, **KNOBS)
    hist = dict(history_length=12, history_gossip=8)
    jsp = JScore(topics={0: JTopic(mesh_message_deliveries_weight=0.0,
                                   mesh_failure_penalty_weight=0.0)}, skip_app_specific=True)
    tsp = PeerScoreParams(topics={0: TopicScoreParams(mesh_message_deliveries_weight=0.0,
                                                      mesh_failure_penalty_weight=0.0)},
                          skip_app_specific=True)
    jnet = JNet.build(jtopology, jgraph.subscribe_all(n, 1))
    tnet = Net.build(topo, graph.subscribe_all(n, 1), device="cpu")
    jcfg = JCfg.build(JParams(**hist), JThr(), score_enabled=True,
                      chaos=JChaos(loss_rate=0.05), router=jrouters.RouterConfig(**rk))
    tcfg = GossipSubConfig.build(GossipSubParams(**hist), PeerScoreThresholds(),
                                 score_enabled=True, chaos=ChaosConfig(loss_rate=0.05),
                                 router=RouterConfig(**rk))
    po, pt, pv = smoke_schedule(n)
    jst = jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=0)
    jrun = jens.run_rounds(jens.lift_step(jmake(jcfg, jnet, score_params=jsp, link_delay=delay)),
                           jens.batch_states(jst, s),
                           lambda i: (jens.tile(po[i], s), jens.tile(pt[i], s),
                                      jens.tile(pv[i], s)), CHOKE_ROUNDS)
    tst = port_state(jst)
    step = make_gossipsub_step(tcfg, tnet, score_params=tsp, link_delay=delay)
    hook = inv.InvariantHook("gossipsub", tnet, tcfg,
                             inv.InvariantConfig(check_every=8, delivery_window=48),
                             due_fn=lambda tick: inv.due_vector(quiet=(0, CHOKE_ROUNDS)))
    trun = ensemble.run_rounds(ensemble.lift_step(step), ensemble.batch_states(tst, s),
                               port_margs(po, pt, pv, s), CHOKE_ROUNDS, invariants=hook)
    diff_leaves(reference_leaves(jrun.states), convert.state_leaves(trun.states), "choke S=2")
    rep = trun.invariant_report
    assert {"choke-wf", "no-choke-below-dlo"} <= set(rep.names) and rep.all_ok
    assert rep.ok.shape[1] == s
    ev = trun.states.core.events.numpy()
    assert (ev[:, EV.CHOKE] > 0).any() and (ev[:, EV.IDONTWANT_SENT] > 0).all()
    for i in range(s):
        one = ensemble.with_sim_key(tst, tst.core.key, i)
        for r in range(CHOKE_ROUNDS):
            one = step(one, *(torch.from_numpy(a[r]) for a in (po, pt, pv)))
        diff_leaves(convert.state_leaves(one),
                    convert.state_leaves(ensemble.unbatch(trun.states, i)), f"choke sim {i}")


def test_telemetry_panels_per_sim():
    s, rounds = 3, 10
    jt, tt = JTelem(rows=rounds), TelemetryConfig(rows=rounds)
    jcfg, jnet, jsp, tcfg, tnet, tsp = gossip_builds(dict(loss_rate=0.35), seed=5)
    po, pt, pv = schedule(rounds, seed=5)
    jst = jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=5, telemetry=jt)
    jrun = jens.run_rounds(jens.lift_step(jmake(jcfg, jnet, score_params=jsp, telemetry=jt)),
                           jens.batch_states(jst, s),
                           lambda i: (jens.tile(po[i], s), jens.tile(pt[i], s),
                                      jens.tile(pv[i], s)), rounds)
    tst = port_state(jst)
    step = make_gossipsub_step(tcfg, tnet, score_params=tsp, telemetry=tt)
    trun = ensemble.run_rounds(ensemble.lift_step(step), ensemble.batch_states(tst, s),
                               port_margs(po, pt, pv, s), rounds)
    panels = trun.states.core.telem.panel.numpy()
    events = trun.states.core.events.numpy()
    assert panels.shape == (s, rounds, N_METRICS)
    assert reconcile_batched(panels, events) == []
    assert not np.array_equal(panels[0], panels[1])
    for i in range(s):
        one = ensemble.with_sim_key(tst, tst.core.key, i)
        for r in range(rounds):
            one = step(one, *(torch.from_numpy(a[r]) for a in (po, pt, pv)))
        diff_leaves(convert.state_leaves(one),
                    convert.state_leaves(ensemble.unbatch(trun.states, i)), f"telemetry sim {i}")
    want = np.asarray(jrun.states.core.telem.panel)
    cols = 1 + N_EVENTS
    np.testing.assert_array_equal(panels[..., :cols], want[..., :cols])
    np.testing.assert_allclose(panels, want, rtol=1e-5, atol=1e-6)
    # every other leaf of the ensemble is the JAX ensemble's bit for bit
    ref = {p: v for p, v in reference_leaves(jrun.states).items() if ".telem." not in p}
    got = {p: v for p, v in convert.state_leaves(trun.states).items() if ".telem." not in p}
    diff_leaves(ref, got, "telemetry S=3 (the panel apart)")


def test_churn_ensemble_per_sim_liveness():
    """Dynamic peers as an S = 2 ensemble with a different liveness
    schedule a sim (``[S, N]`` up rows: sim 0 loses a fifth of its peers in
    rounds 2-9, sim 1 none): the port's ensemble equals the JAX ensemble
    on every leaf, each sim its one-sim run (the spill-slot scatters of
    ``state._scatter_drop`` batched)."""
    from go_libp2p_pubsub_tpu_torch.perf import sweep
    from torch_parity import bench_builds

    s, rounds, n = 2, 12, 48
    jcfg, jnet, jsp, tcfg, tnet, tsp = bench_builds(n=n)
    po, pt, pv = schedule(rounds, seed=3)
    up = np.stack([sweep.churn_up(n, rounds=rounds, down_at=2, up_at=10),
                   np.ones((rounds, n), bool)], axis=1)          # [rounds, S, N]
    jst = jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=4)
    jrun = jens.run_rounds(
        jens.lift_step(jmake(jcfg, jnet, score_params=jsp, dynamic_peers=True)),
        jens.batch_states(jst, s),
        lambda i: (jens.tile(po[i], s), jens.tile(pt[i], s), jens.tile(pv[i], s),
                   jnp.asarray(up[i])), rounds)
    tst = port_state(jst)
    step = make_gossipsub_step(tcfg, tnet, score_params=tsp, dynamic_peers=True)
    trun = ensemble.run_rounds(ensemble.lift_step(step), ensemble.batch_states(tst, s),
                               port_margs(po, pt, pv, s, extra=[up]), rounds)
    diff_leaves(reference_leaves(jrun.states), convert.state_leaves(trun.states), "churn S=2")
    removed = trun.states.core.events.numpy()[:, EV.REMOVE_PEER]
    assert removed[0] > 0 and removed[1] == 0     # only sim 0 lost peers
    for i in range(s):
        one = ensemble.with_sim_key(tst, tst.core.key, i)
        for r in range(rounds):
            one = step(one, *(torch.from_numpy(a[r]) for a in (po, pt, pv)),
                       torch.from_numpy(up[r, i]))
        diff_leaves(convert.state_leaves(one),
                    convert.state_leaves(ensemble.unbatch(trun.states, i)), f"churn sim {i}")
