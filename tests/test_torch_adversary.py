"""The attack plane (``chaos/adversary.py``) in the port against the JAX
package's, leaf for leaf: the host parts (``Adversary``, ``resolve``,
``AttackScenario``'s placements, hash and events) and every engine under
attack — the per-round GossipSub step on the banded lattice (which leaves
the fused kernels for the composites) and CSR-resident, the phase engine at
r = 8, FloodSub and RandomSub dense and CSR-resident — each every round or
phase, the ADV_* counters included; and the twins of the JAX package's
tests/test_adversary.py:503-869 (the elision of both unarmed shapes in all
four engines, the phase engine at r = 1 against the per-round step, the
drop-forward schedule window, lie_ihave, graft_spam, self_promo and censor
engine-driven on a random dense net, the attacked checkpoint resume) and an
attacked window against its eager loop.

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
from go_libp2p_pubsub_tpu_torch import checkpoint, convert
from go_libp2p_pubsub_tpu_torch import config as tconfig
from go_libp2p_pubsub_tpu_torch import driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.chaos import adversary as tadv
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim
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
    jst = JSim.init(N, M, seed=0, k=jnet.max_degree, n_edges=jnet.n_edges)
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


# ---------------------------------------------------------------------------
# the JAX tests' twins (tests/test_adversary.py:503-869)


def _port_run(engine, adversary, rounds=8, n=32):
    """The port's final leaves of one engine on ``random_connect(n, 5, 1)``
    from the JAX elision tests' schedule."""
    tnet = TNet.build(tgraph.random_connect(n, 5, seed=1), tgraph.subscribe_all(n, 1),
                      device="cpu")
    po, pt, pv = (torch.from_numpy(a) for a in random_schedule(rounds, 5, n))
    if engine in ("floodsub", "randomsub"):
        st = TSim.init(n, 32, seed=2, k=tnet.max_degree, device="cpu")
        if engine == "floodsub":
            step = lambda s, *a: tflood.floodsub_step(tnet, s, *a, adversary=adversary)
        else:
            step = trs.make_randomsub_step(tnet, adversary=adversary)
        for i in range(rounds):
            st = step(st, po[i], pt[i], pv[i])
        return convert.state_leaves(st)
    cfg = TCfg.build(tconfig.GossipSubParams(), tconfig.PeerScoreThresholds(**THRESHOLDS))
    st = TState.init(tnet, 32, cfg, seed=5)
    if engine == "per-round":
        step = make_gossipsub_step(cfg, tnet, adversary=adversary)
        for i in range(rounds):
            st = step(st, po[i], pt[i], pv[i])
    else:
        r = int(engine.split("-r")[1])
        step = make_gossipsub_phase_step(cfg, tnet, r, adversary=adversary)
        for p in range(rounds // r):
            sl = slice(p * r, (p + 1) * r)
            st = step(st, po[sl], pt[sl], pv[sl], do_heartbeat=True)
    return convert.state_leaves(st)


@pytest.mark.parametrize("engine", ["per-round", "phase-r4", "floodsub", "randomsub"])
def test_unarmed_populations_elide_the_plane(engine):
    """Both unarmed shapes give the leaves of a build without the plane in
    all four engines."""
    base = _port_run(engine, None)
    for off in _off_populations(tadv, 32):
        diff_leaves(base, _port_run(engine, off), f"{engine} unarmed")


def test_attacked_phase_r1_matches_per_round():
    """The r = 1 phase engine equals the per-round step under a
    multi-behaviour attack on every leaf but the ADV_DROP count (the
    per-round engines count receiver-side after their gates, the phase
    engine sender-side before them)."""
    tnet = TNet.build(tgraph.random_connect(32, 5, seed=1), tgraph.subscribe_all(32, 1),
                      device="cpu")
    cfg = TCfg.build(tconfig.GossipSubParams(), tconfig.PeerScoreThresholds(**THRESHOLDS))
    adv = tadv.AttackScenario(n_peers=32, sybil_fraction=0.25, onset=2,
                              behaviors=("drop_forward", "lie_ihave", "graft_spam")).build()
    po, pt, pv = (torch.from_numpy(a) for a in random_schedule(8, 4, 32))
    s1 = make_gossipsub_step(cfg, tnet, adversary=adv)
    s2 = make_gossipsub_phase_step(cfg, tnet, 1, adversary=adv)
    st1 = st2 = TState.init(tnet, 32, cfg, seed=4)
    for i in range(8):
        st1 = s1(st1, po[i], pt[i], pv[i])
        st2 = s2(st2, po[i][None], pt[i][None], pv[i][None], do_heartbeat=True)
    assert int(st1.core.events[EV.ADV_DROP]) > 0
    a, b = convert.state_leaves(st1), convert.state_leaves(st2)
    for leaves in (a, b):
        leaves[".core.events"] = np.delete(leaves[".core.events"], int(EV.ADV_DROP))
    diff_leaves(a, b, "attacked r1")


def test_drop_forward_schedule_window():
    """ADV_DROP (and so the masking) moves only inside [onset, stop), and
    the run forwards honestly after stop, the JAX engine's rounds equal."""
    n = 24
    builds = twins(n, 5, 2, score=False)
    builds.jkw["adversary"] = jadv.Adversary(n, np.arange(n) < 6, ("drop_forward",),
                                             onset=4, stop=8)
    builds.tkw["adversary"] = tadv.Adversary(n, np.arange(n) < 6, ("drop_forward",),
                                             onset=4, stop=8)
    drops = []
    rounds_against_reference(builds, 14, schedule=random_schedule(14, 2, n), seed=2,
                             msg_slots=32,
                             observe=lambda st: drops.append(int(st.core.events[EV.ADV_DROP])))
    deltas = np.diff([0] + drops)
    assert (deltas[:4] == 0).all() and deltas[4:8].sum() > 0 and (deltas[9:] == 0).all(), deltas


def test_lie_ihave_engine_driven_breaks_promises():
    """The attacker publishes, never forwards, and lies about every live
    message each heartbeat: the victims IWANT, nothing is served, promises
    break, P7 accrues and the neighbourhood scores the liar negative."""
    n, attacker = 24, 5
    builds = twins(n, 6, 9, thresholds=THRESHOLDS, score_params=p7_score_params)
    for side, mod in (("jkw", jadv), ("tkw", tadv)):
        getattr(builds, side)["adversary"] = mod.Adversary(
            n, np.arange(n) == attacker, behaviors=("drop_forward", "lie_ihave"))
    spec = [-1] * 6 + ([attacker] + [-1] * 5) * 4
    st = rounds_against_reference(builds, len(spec), schedule=rows(spec), seed=9, msg_slots=32)
    assert int(st.core.events[EV.ADV_IHAVE_LIE]) > 0
    nbr, ok = builds[4].nbr.numpy(), builds[4].nbr_ok.numpy()
    bp, scores = st.score.bp.numpy(), st.scores.numpy()
    hits = 0
    for j in range(n):
        k = edge_to(nbr, ok, j, attacker)
        if k is None or j == attacker:
            continue
        if bp[j, k] > 0:
            hits += 1
            assert scores[j, k] < 0, (j, k, scores[j, k])
    assert hits >= 2, (hits, bp.max())


def test_graft_spam_engine_driven_penalized_backoffless():
    n, attacker = 24, 7
    builds = twins(n, 5, 11, params=dict(D=3, Dlo=2, Dhi=4, Dscore=2, Dout=1),
                   thresholds=THRESHOLDS,
                   score_params=lambda cm: p7_score_params(cm, behaviour_penalty_weight=-1.0))
    for side, mod in (("jkw", jadv), ("tkw", tadv)):
        getattr(builds, side)["adversary"] = mod.Adversary(
            n, np.arange(n) == attacker, behaviors=("drop_forward", "graft_spam"))
    st = rounds_against_reference(builds, 30, schedule=rows([-1] * 30), seed=11, msg_slots=32)
    assert int(st.core.events[EV.ADV_GRAFT_SPAM]) > 0
    # the spammer keeps no backoff bookkeeping (a raw-wire fake)
    assert not bool(st.backoff_present[attacker].any())
    assert int(st.backoff_expire[attacker].max()) == 0
    nbr, ok = builds[4].nbr.numpy(), builds[4].nbr_ok.numpy()
    bp = st.score.bp.numpy()
    accrued = [bp[j, k] for j in range(n) if j != attacker
               and (k := edge_to(nbr, ok, j, attacker)) is not None]
    assert max(accrued) > 0.0


def test_self_promo_pins_sybil_faction_scores():
    n = 24
    builds = twins(n, 5, 13, thresholds=THRESHOLDS, score_params=p7_score_params)
    mask = np.arange(n) >= 18
    for side, mod in (("jkw", jadv), ("tkw", tadv)):
        getattr(builds, side)["adversary"] = mod.Adversary(
            n, mask, behaviors=("drop_forward", "self_promo"), promo_score=7.5)
    st = rounds_against_reference(builds, 10, schedule=rows([-1] * 10), seed=13, msg_slots=32)
    scores = st.scores.numpy()
    nbr, ok = builds[4].nbr.clamp(min=0).numpy(), builds[4].nbr_ok.numpy()
    syb_syb = ok & mask[nbr] & mask[:, None]
    assert syb_syb.any() and (scores[syb_syb] == np.float32(7.5)).all()
    # honest peers' scores of sybils are not pinned (the defence untouched)
    assert not (scores[ok & mask[nbr] & ~mask[:, None]] == np.float32(7.5)).all()


def test_censor_masks_only_target_messages():
    """The censored origin's messages alone are withheld, on attacker edges
    alone (the masks equal the JAX package's on the run's own state), and
    every other message reaches everyone."""
    n, censored = 20, 3
    builds = twins(n, 5, 15, score=False)
    kw = dict(behaviors=("censor",), censor_origins=np.arange(n) == censored)
    builds.jkw["adversary"] = jadv.Adversary(n, np.arange(n) >= 14, **kw)
    builds.tkw["adversary"] = tadv.Adversary(n, np.arange(n) >= 14, **kw)
    spec = [-1] * 6 + [censored, 0] + [-1] * 8
    at8 = []
    st = rounds_against_reference(builds, len(spec), schedule=rows(spec), seed=15, msg_slots=32,
                                  observe=lambda s: at8.append(s) if len(at8) < 8 else None)
    mid = at8[-1]                        # after the two publishes
    consts = tadv.AdversaryConsts(builds.tkw["adversary"], builds[4])
    ref = jadv.AdversaryConsts(builds.jkw["adversary"], builds[1])
    plane = torch.full((n, builds[4].max_degree, 1), -1, dtype=torch.int32)
    masked, removed = consts.mask_transmit_nbr(mid.core.tick, plane, mid.core.msgs)
    leaves = convert.state_leaves(mid)
    from go_libp2p_pubsub_tpu.state import MsgTable as JMsgs

    jm = JMsgs(**{f.name: jnp.asarray(leaves[f".core.msgs.{f.name}"])
                  for f in dataclasses.fields(JMsgs) if f".core.msgs.{f.name}" in leaves})
    rmasked, rremoved = ref.mask_transmit_nbr(jnp.int32(int(mid.core.tick)),
                                              jnp.full(plane.shape, 0xFFFFFFFF, jnp.uint32), jm)
    assert np.array_equal(masked.numpy().view(np.uint32), np.asarray(rmasked))
    assert np.array_equal(removed.numpy().view(np.uint32), np.asarray(rremoved))
    cw = consts.censor_words(mid.core.msgs).numpy().view(np.uint32)
    origin = mid.core.msgs.origin.numpy()
    slots = np.flatnonzero(origin == censored)
    assert len(slots) >= 1 and all(cw[s // 32] & np.uint32(1 << (s % 32)) for s in slots)
    s0 = int(np.flatnonzero(origin == 0)[0])
    assert not cw[s0 // 32] & np.uint32(1 << (s0 % 32))
    att = consts.active_nbr("censor", mid.core.tick).numpy()
    rem = removed.numpy().view(np.uint32)[..., 0]
    assert (rem[~att] == 0).all() and (rem[att] == cw[0]).all()
    # the run delivers the rest and counts the withheld bits
    assert int(st.core.events[EV.ADV_DROP]) > 0
    have = st.core.dlv.have.numpy().view(np.uint32)
    assert (have[:, s0 // 32] & np.uint32(1 << (s0 % 32)) != 0).all()


def test_checkpoint_attacked_resume_bitexact(tmp_path):
    """The plane is stateless: a v6 checkpoint of an attacked run holds no
    new leaf and resumes the uninterrupted run bit for bit."""
    n = 24
    tnet = TNet.build(tgraph.random_connect(n, 5, seed=21), tgraph.subscribe_all(n, 1),
                      device="cpu")
    cfg = TCfg.build(tconfig.GossipSubParams(), tconfig.PeerScoreThresholds(**THRESHOLDS),
                     score_enabled=True)
    sp = p7_score_params(tconfig)
    adv = tadv.AttackScenario(n_peers=n, sybil_fraction=0.25, onset=4, ramp_rounds=4,
                              behaviors=("drop_forward", "lie_ihave", "graft_spam"),
                              seed=21).build()
    po, pt, pv = (torch.from_numpy(a) for a in random_schedule(12, 21, n))
    step = make_gossipsub_step(cfg, tnet, score_params=sp, adversary=adv)

    def steps(st, lo, hi):
        for i in range(lo, hi):
            st = step(st, po[i], pt[i], pv[i])
        return st

    init = lambda: TState.init(tnet, 32, cfg, score_params=sp, seed=21)
    full = steps(init(), 0, 12)
    path = str(tmp_path / "attacked.npz")
    checkpoint.save(path, steps(init(), 0, 6))
    with np.load(path) as data:
        assert int(data["__version__"]) == 6
        assert int(data["__n_leaves__"]) == len(convert.leaf_specs(init()))
    resumed = steps(checkpoint.restore(path, init()), 6, 12)
    assert int(full.core.events[EV.ADV_GRAFT_SPAM]) > 0
    diff_leaves(convert.state_leaves(full), convert.state_leaves(resumed), "attacked resume")


def test_attacked_window_equals_eager_and_refusals():
    """An attacked phase step through ``make_scan`` equals its eager loop
    (the plane has no state, so a window needs no new row); the mutable
    overlay refuses an adversary, armed or not, as the JAX step does."""
    _j, _jn, _js, tcfg, tnet, tsp = bench_builds(n=N, d=4, heartbeat_every=4)
    adv = tadv.AttackScenario(**ALL).build()
    step = make_gossipsub_phase_step(tcfg, tnet, 4, score_params=tsp, adversary=adv)
    po, pt, pv = (torch.from_numpy(a) for a in random_schedule(16, 3, N))
    st0 = TState.init(tnet, M, tcfg, score_params=tsp, seed=3)
    eager = st0
    for p in range(4):
        sl = slice(4 * p, 4 * p + 4)
        eager = step(eager, po[sl], pt[sl], pv[sl], do_heartbeat=True)
    win = driver.make_scan(step, heartbeat_every=4, rounds_per_phase=4)(st0, po, pt, pv)
    diff_leaves(convert.state_leaves(eager), convert.state_leaves(win), "attacked window")
    assert int(eager.core.events[EV.ADV_DROP]) > 0
    dnet = TNet.build(tgraph.random_connect(16, 3, seed=0), tgraph.subscribe_all(16, 1),
                      device="cpu", dynamic=True)
    cfg = TCfg.build(tconfig.GossipSubParams())
    for a in (tadv.Adversary(16, np.arange(16) < 2), _off_populations(tadv, 16)[0]):
        with pytest.raises(ValueError, match="adversary"):
            make_gossipsub_step(cfg, dnet, dynamic_peers=True, dynamic_topo=True, adversary=a)
