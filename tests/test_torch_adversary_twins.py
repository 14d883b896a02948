"""The twins of the JAX package's tests/test_adversary.py:503-869 in the
port: the elision of both unarmed shapes in all four engines, the phase
engine at r = 1 against the per-round step, the drop-forward schedule
window, lie_ihave, graft_spam, self_promo and censor engine-driven on a
random dense net against the JAX engine every round, the attacked
checkpoint resume, and an attacked window against its eager loop (split
from tests/test_torch_adversary.py, whose build helpers it uses)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_adversary import (
    ALL,
    THRESHOLDS,
    M,
    N,
    _off_populations,
    edge_to,
    p7_score_params,
    random_schedule,
    rows,
    twins,
)
from torch_parity import bench_builds, diff_leaves, rounds_against_reference

from go_libp2p_pubsub_tpu.chaos import adversary as jadv
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
from go_libp2p_pubsub_tpu_torch.trace.events import EV


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
