"""The attack plane (``chaos/adversary.py``) in the port against the JAX
package's, leaf for leaf: the host parts (``Adversary``, ``resolve``,
``AttackScenario``'s placements, hash and events) and every engine under
attack — the per-round GossipSub step on the banded lattice (which leaves
the fused kernels for the composites) and CSR-resident, the phase engine at
r = 8, FloodSub and RandomSub dense and CSR-resident — each every round or
phase, the ADV_* counters included. The twins of the JAX package's
tests/test_adversary.py:503-869 are tests/test_torch_adversary_twins.py,
which uses this file's build helpers (split so that each file stays within a
loadfile worker's share of the suite).

The port runs on the CPU, so the kernels' plain versions run: the routes
under attack are asserted from launch counts on the card (``chip_smoke.py``
phase 40). A fresh JAX state is built for every run: the JAX steps donate
their buffers."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_randomsub import nets, schedule
from torch_parity import (
    SECOND_PLANE,
    Builds,
    bench_builds,
    diff_leaves,
    jinit,
    lifted_planes,
    phases_against_reference,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import config as jconfig
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.chaos import adversary as jadv
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models import randomsub as jrs
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu.telemetry import TelemetryConfig as JTel
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import config as tconfig
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.chaos import adversary as tadv
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.telemetry import TelemetryConfig as TTel
from go_libp2p_pubsub_tpu_torch.telemetry import reconcile
from go_libp2p_pubsub_tpu_torch.trace.events import EV

N, M = 64, 64
#: every behaviour, a ramped onset, censoring every fourth peer's messages
ALL = dict(n_peers=N, sybil_fraction=0.25, onset=2, ramp_rounds=3, seed=4,
           behaviors=tadv.BEHAVIORS, censor_origins=tuple(range(0, N, 4)))
#: the data behaviours inside an activity window
DATA = dict(n_peers=N, sybil_fraction=0.25, onset=3, stop=9, seed=1,
            behaviors=("drop_forward", "censor"), censor_origins=tuple(range(1, N, 3)))


def armed(builds, **scenario):
    """``builds`` with both packages' populations of one scenario armed (each
    built against its own package's net: a surround placement reads it)."""
    builds.jkw["adversary"] = jadv.AttackScenario(**scenario).build(builds[1])
    builds.tkw["adversary"] = tadv.AttackScenario(**scenario).build(builds[4])
    return builds


def twins(n, d, seed, params=None, thresholds=None, score=True, score_params=None):
    """(JAX, port) builds of one GossipSub config on ``random_connect(n, d,
    seed)``: ``params`` and ``thresholds`` are GossipSubParams and
    PeerScoreThresholds fields, ``score_params(config_module)`` builds the
    PeerScoreParams from either package's config module."""
    out = []
    for cm, graph, net_cls, cfg_cls, kw in (
            (jconfig, jgraph, JNet, JCfg, {}), (tconfig, tgraph, TNet, TCfg, {"device": "cpu"})):
        net = net_cls.build(graph.random_connect(n, d, seed=seed), graph.subscribe_all(n, 1), **kw)
        cfg = cfg_cls.build(cm.GossipSubParams(**(params or {})),
                            cm.PeerScoreThresholds(**(thresholds or {})), score_enabled=score)
        out += [cfg, net, score_params(cm) if score else None]
    b = Builds(out)
    b.jkw, b.tkw = {}, {}
    return b


def p7_score_params(cm, **peer):
    """The JAX adversary tests' P7-focused parameters (tests/test_adversary.py:
    36-58) from a package's config module."""
    tp = cm.TopicScoreParams(
        topic_weight=1.0, time_in_mesh_weight=0.0, first_message_deliveries_weight=1.0,
        first_message_deliveries_cap=50.0, first_message_deliveries_decay=0.9,
        mesh_message_deliveries_weight=0.0, mesh_failure_penalty_weight=0.0,
        invalid_message_deliveries_weight=-10.0, invalid_message_deliveries_decay=0.9)
    kw = dict(behaviour_penalty_weight=-10.0, behaviour_penalty_threshold=0.0,
              behaviour_penalty_decay=0.9, ip_colocation_factor_weight=0.0)
    kw.update(peer)
    return cm.PeerScoreParams(topics={0: tp}, skip_app_specific=True, **kw)


#: the JAX adversary tests' thresholds
THRESHOLDS = dict(gossip_threshold=-2.0, publish_threshold=-4.0, graylist_threshold=-8.0,
                  accept_px_threshold=10.0, opportunistic_graft_threshold=1.0)


def rows(spec, p=4):
    """A per-round publish schedule from ``spec``: a list of origins (-1 for
    a round without a publish), each publishing one valid message on topic
    0 in a batch of ``p``."""
    r = len(spec)
    po = np.full((r, p), -1, np.int32)
    po[:, 0] = spec
    pt = np.where(po >= 0, 0, -1).astype(np.int32)
    pv = np.zeros((r, p), bool)
    pv[:, 0] = po[:, 0] >= 0
    return po, pt, pv


def random_schedule(rounds, seed, n, width=4):
    """The JAX adversary tests' ``_schedule``: random origins, topic 0."""
    rng = np.random.default_rng(seed)
    po = rng.integers(0, n, size=(rounds, width)).astype(np.int32)
    return po, np.zeros((rounds, width), np.int32), np.ones((rounds, width), bool)


def edge_to(nbr, ok, j, target):
    """The neighbour slot k with nbr[j, k] == target, or None."""
    hit = np.flatnonzero(ok[j] & (nbr[j] == target))
    return int(hit[0]) if hit.size else None


# ---------------------------------------------------------------------------
# the host parts


def _off_populations(mod, n):
    """The two unarmed shapes: no sybils, and sybils with no behaviour."""
    return (mod.Adversary(n, np.zeros(n, bool), behaviors=("drop_forward", "lie_ihave")),
            mod.Adversary(n, np.arange(n) < 4, behaviors=()))


def test_resolve_and_fingerprint_equal_reference():
    for off in _off_populations(tadv, 16):
        assert tadv.resolve(off) is None
    live = tadv.Adversary(16, np.arange(16) < 4)
    assert tadv.resolve(live) is live
    for bad in (dict(behaviors=("no_such_attack",)),
                dict(masks={"drop_forward": np.arange(16) >= 4}),
                dict(behaviors=("censor",))):
        with pytest.raises(tadv.AdversaryError):
            tadv.Adversary(16, np.arange(16) < 4, **bad)
    kw = dict(behaviors=("drop_forward", "graft_spam", "censor"), onset=3, stop=40,
              promo_score=7.5, censor_origins=np.arange(16) == 9,
              masks={"graft_spam": np.arange(16) < 2})
    assert (tadv.Adversary(16, np.arange(16) < 4, **kw).fingerprint()
            == jadv.Adversary(16, np.arange(16) < 4, **kw).fingerprint())
    # the trace drain keeps the ADV counters counter-only, as the JAX drain
    from go_libp2p_pubsub_tpu.trace import drain as jdrain
    from go_libp2p_pubsub_tpu_torch.trace import drain as tdrain

    adv_events = {EV.ADV_DROP, EV.ADV_IHAVE_LIE, EV.ADV_GRAFT_SPAM}
    assert adv_events <= set(tdrain.COUNTER_ONLY_EVENTS)
    assert [int(e) for e in tdrain.COUNTER_ONLY_EVENTS] == [
        int(e) for e in jdrain.COUNTER_ONLY_EVENTS]


def test_attack_scenario_equals_reference():
    kw = dict(n_peers=24, sybil_fraction=0.25, behaviors=("drop_forward", "graft_spam"),
              onset=5, ramp_rounds=6, seed=3, stop=30, censor_origins=(2, 5))
    a, b = tadv.AttackScenario(**kw).build(), tadv.AttackScenario(**kw).build()
    ref = jadv.AttackScenario(**kw).build()
    for f in ("is_sybil", "onset", "stop", "censor_origins"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
        assert np.array_equal(getattr(a, f), getattr(ref, f)), f
    assert a.is_sybil.sum() == 6
    idx = np.flatnonzero(a.is_sybil)
    assert (a.onset[idx] >= 5).all() and (a.onset[idx] < 11).all()
    sc = tadv.AttackScenario(**kw)
    assert sc.scenario_hash() == jadv.AttackScenario(**kw).scenario_hash()
    assert sc.scenario_hash() != dataclasses.replace(sc, onset=6).scenario_hash()
    assert sc.events() == jadv.AttackScenario(**kw).events()
    assert sc.events()[0][1] == "AttackOnset"


def test_surround_placement_equals_reference():
    jnet = JNet.build(jgraph.random_connect(32, 6, seed=7), jgraph.subscribe_all(32, 1))
    tnet = TNet.build(tgraph.random_connect(32, 6, seed=7), tgraph.subscribe_all(32, 1),
                      device="cpu")
    kw = dict(n_peers=32, targets=(0, 1), surround_targets=True, surround_fraction=0.5,
              behaviors=("drop_forward", "graft_spam"), seed=7)
    adv, ref = tadv.AttackScenario(**kw).build(tnet), jadv.AttackScenario(**kw).build(jnet)
    assert np.array_equal(adv.is_sybil, ref.is_sybil)
    assert np.array_equal(adv.graft_targets, ref.graft_targets)
    nbr, ok = tnet.nbr.numpy(), tnet.nbr_ok.numpy()
    hood = set(nbr[0][ok[0]].tolist()) | set(nbr[1][ok[1]].tolist())
    sybils = set(np.flatnonzero(adv.is_sybil).tolist())
    assert sybils and sybils <= hood
    assert not adv.is_sybil[0] and not adv.is_sybil[1]
    with pytest.raises(tadv.AdversaryError):
        tadv.AttackScenario(**kw).build()     # the placement needs the topology


# ---------------------------------------------------------------------------
# every engine under attack, leaf for leaf


@pytest.mark.parametrize("cell", ["lattice-all-lifted", "csr-window"])
def test_per_round_step_equals_reference(cell):
    """The lattice cell runs every behaviour under a lifted score plane (a
    moved weight set: self-promotion pins the lifted path's memoised
    scores) with the telemetry panel and a flight recorder (its ADV
    columns reconcile); the CSR-resident cell the data behaviours inside
    [onset, stop) on a random net. The static score path is the twins'
    below, the count path the phase engine's."""
    kw = {}
    if cell == "lattice-all-lifted":
        builds, scenario = bench_builds(n=N, d=4), ALL
        kw = dict(telemetry=(JTel(rows=12, tracked=(0, 50)), TTel(rows=12, tracked=(0, 50))),
                  plane=lifted_planes(builds, moves=SECOND_PLANE),
                  step_kw={"lift_scores": True})
    else:
        builds = bench_builds(n=N, d=4, topologies=(jgraph.random_connect(N, 5, seed=1),
                                                    tgraph.random_connect(N, 5, seed=1)),
                              edge_layout="csr", fused=True)
        scenario = DATA
    st = rounds_against_reference(armed(builds, **scenario), 12, **kw)
    ev = st.core.events
    assert int(ev[EV.ADV_DROP]) > 0
    if cell == "lattice-all-lifted":
        assert int(ev[EV.ADV_IHAVE_LIE]) > 0 and int(ev[EV.ADV_GRAFT_SPAM]) > 0
        assert reconcile(st.core.telem.panel, ev) == []


def test_phase_engine_equals_reference():
    """r = 8 on the lattice: the IWANT service masked receiver-side at the
    head's tick, each sub-round's data sender-side at its own tick, the
    control behaviours in the tail heartbeat, the panel a row a phase, on
    the count path (``score_counts``), whose scores self-promotion pins."""
    builds = armed(bench_builds(n=N, d=4, heartbeat_every=8), **ALL)
    st = phases_against_reference(builds, 8, 8, 24, telemetry=(JTel(rows=3), TTel(rows=3)),
                                  score_counts=True)
    ev = st.core.events
    assert min(int(ev[e]) for e in (EV.ADV_DROP, EV.ADV_IHAVE_LIE, EV.ADV_GRAFT_SPAM)) > 0
    assert reconcile(st.core.telem.panel, ev) == []


@pytest.mark.parametrize("router,layout", [("floodsub", "dense"), ("randomsub", "csr")])
def test_sim_engines_equal_reference(router, layout):
    """FloodSub on the lattice and RandomSub CSR-resident on a power-law
    graph: the data behaviours mask the edge mask before the shared
    delivery round. The port's step takes the scenario itself (built
    against its net), the JAX step the population it builds."""
    jnet, tnet = nets("lattice" if layout == "dense" else "powerlaw", layout, n=N)
    ref_adv = jadv.AttackScenario(**DATA).build()
    scenario = tadv.AttackScenario(**DATA)
    jst = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree, n_edges=jnet.n_edges)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    if router == "floodsub":
        jstep = lambda s, *a: jflood.floodsub_step(jnet, s, *a, adversary=ref_adv)
        tstep = lambda s, *a: tflood.floodsub_step(tnet, s, *a, adversary=scenario)
    else:
        jstep = jrs.make_randomsub_step(jnet, adversary=ref_adv)
        tstep = trs.make_randomsub_step(tnet, adversary=scenario)
    po, pt, pv = schedule(N, 12)
    for r in range(12):
        jst = jstep(jst, *(jnp.asarray(x[r]) for x in (po, pt, pv)))
        tst = tstep(tst, *(torch.from_numpy(x[r]) for x in (po, pt, pv)))
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"{router} round {r}")
    assert int(tst.events[EV.ADV_DROP]) > 0


def test_floodsub_takes_constants_built_once():
    """``build_floodsub``'s step holds the population's device constants,
    built once over its net; ``floodsub_step`` given those constants equals
    the step given the population, every leaf, every round."""
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    scenario = tadv.AttackScenario(**DATA)
    st, run = sweep.build_floodsub(N, M, device="cpu", adversary=scenario)
    assert isinstance(run.adversary, tadv.AdversaryConsts)
    assert tadv.build_consts(run.adversary, run.net) is run.adversary
    assert tadv.build_consts(tadv.Adversary(N, np.zeros(N, bool)), run.net) is None
    ref = st
    po, pt, pv = (torch.from_numpy(x) for x in schedule(N, 12))
    for r in range(12):
        st = run(st, po[r], pt[r], pv[r])
        ref = tflood.floodsub_step(run.net, ref, po[r], pt[r], pv[r], adversary=scenario)
        diff_leaves(convert.state_leaves(ref), convert.state_leaves(st), f"round {r}")
    assert int(st.events[EV.ADV_DROP]) > 0
