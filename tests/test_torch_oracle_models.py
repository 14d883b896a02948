"""The port's scalar golden models (``oracle/gossipsub.py``,
``floodsub.py``, ``randomsub.py``, ``score.py``) and the north star's
parity claim on the port's engine.

* The port's copies equal the JAX package's oracles exactly: the same
  inputs and seeds give the same first-receipt hops, event counters,
  meshes and scores (host Python with ``random`` and numpy on both sides).
* The port's GossipSub and RandomSub engines (``device="cpu"``) stay
  within 2% sup-norm of the port's oracles' propagation-latency CDF, in
  ``tests/test_parity_cdf.py``'s three cases (GossipSub v1.0 with and
  without flood publishing, RandomSub) and ``tests/test_parity_v11.py``'s
  composed v1.1 cases (sybil scoring with a no-forward minority, the eth2
  subnet geometry with fanout), with the mean hops within 2% and the
  aggregate event counters of ``test_event_accounting_tracks_oracle``
  within 10%: the tolerances of those files.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import config as jconfig
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
from go_libp2p_pubsub_tpu.oracle.floodsub import OracleFloodSub as JFlood
from go_libp2p_pubsub_tpu.oracle.gossipsub import OracleGossipSub as JGossip
from go_libp2p_pubsub_tpu.oracle.randomsub import OracleRandomSub as JRandom
from go_libp2p_pubsub_tpu.oracle.score import OracleScore as JScore
from go_libp2p_pubsub_tpu_torch import config as tconfig
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState, make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.models.randomsub import make_randomsub_step
from go_libp2p_pubsub_tpu_torch.oracle.floodsub import OracleFloodSub as TFlood
from go_libp2p_pubsub_tpu_torch.oracle.gossipsub import OracleGossipSub as TGossip
from go_libp2p_pubsub_tpu_torch.oracle.randomsub import OracleRandomSub as TRandom
from go_libp2p_pubsub_tpu_torch.oracle.score import OracleScore as TScore
from go_libp2p_pubsub_tpu_torch.state import Net, SimState, hops
from go_libp2p_pubsub_tpu_torch.trace.events import EV

N, DEG, MSG_SLOTS = 192, 8, 64
PUB_ROUNDS, PUBS_PER_ROUND, DRAIN, MAX_H = 18, 2, 12, 14


def _empty():
    z = torch.full((PUBS_PER_ROUND,), -1, dtype=torch.int32)
    return z, z, torch.zeros((PUBS_PER_ROUND,), dtype=torch.bool)


def _cdf(hop_counts, total):
    hist = np.zeros(MAX_H + 1)
    for h in hop_counts:
        hist[min(h, MAX_H)] += 1
    return np.cumsum(hist) / total


def _sup(cv, co) -> float:
    return float(np.max(np.abs(cv - co)))


def _oracle_run(cls, args, kw, warmup, sched, topics, drain=DRAIN):
    o = cls(*args, **kw)
    for _ in range(warmup):
        o.step()
    for r in range(sched.shape[0]):
        o.step([(int(p), int(t), True) for p, t in zip(sched[r], topics[r])])
    for _ in range(drain):
        o.step()
    mesh = [{t: sorted(ks) for t, ks in m.items()} for m in getattr(o, "mesh", [])]
    return o, dict(hops=o.hops(), events=list(o.events), mesh=mesh)


def _oracles(kind, jt, tt, js, ts, jcfg, tcfg, warmup, sched, topics, jsp=None, tsp=None,
             adversary=None):
    """The JAX and the port oracle over the same schedule: equal hops,
    events and meshes (and scores, when scored); the port's oracle."""
    kw = dict(msg_slots=MSG_SLOTS, seed=11)
    if kind == "gossipsub":
        jo, jr = _oracle_run(JGossip, (jt, js, jcfg), dict(kw, score_params=jsp,
                                                           adversary=adversary), warmup,
                             sched, topics)
        to, tr = _oracle_run(TGossip, (tt, ts, tcfg), dict(kw, score_params=tsp,
                                                           adversary=adversary), warmup,
                             sched, topics)
        if jsp is not None:
            for i in range(N):
                for k, _s, _r in to._edges(i):
                    assert to._score(i, k) == jo._score(i, k)
    else:
        jo, jr = _oracle_run(JRandom, (jt, js), kw, warmup, sched, topics)
        to, tr = _oracle_run(TRandom, (tt, ts), kw, warmup, sched, topics)
    assert tr["hops"] == jr["hops"] and tr["events"] == jr["events"]
    assert tr["mesh"] == jr["mesh"]
    assert len(tr["hops"]) > 0
    return to


def _engine_hops(net, st, step, warmup, sched, topics, sub_only=False):
    """The port engine's first-receipt hops (receipts at subscribed peers
    only with ``sub_only``) and its final state."""
    for _ in range(warmup):
        st = step(st, *_empty())
    pv = torch.ones((PUBS_PER_ROUND,), dtype=torch.bool)
    for r in range(sched.shape[0]):
        st = step(st, torch.from_numpy(sched[r]), torch.from_numpy(topics[r]), pv)
    for _ in range(DRAIN):
        st = step(st, *_empty())
    core = st.core if hasattr(st, "core") else st
    h = hops(core.msgs, core.dlv).numpy()
    mask = h >= 0
    if sub_only:
        mt = core.msgs.topic.numpy()
        mask &= net.subscribed.numpy()[:, np.clip(mt, 0, None)]
    return [int(x) for x in h[mask]], st


def _schedule(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N, size=(PUB_ROUNDS, PUBS_PER_ROUND)).astype(np.int32),
            np.zeros((PUB_ROUNDS, PUBS_PER_ROUND), np.int32))


def _graphs(seed=5):
    return jgraph.random_connect(N, d=DEG, seed=seed), tgraph.random_connect(N, d=DEG, seed=seed)


@pytest.mark.parametrize("flood_publish", [False, True])
def test_gossipsub_cdf_within_2pct_of_the_port_oracle(flood_publish):
    """``tests/test_parity_cdf.py::test_propagation_cdf_within_2pct`` on the
    port, its oracle equal to the JAX package's; with flood publishing off
    also the event accounting within 10%."""
    jt, tt = _graphs()
    js, ts = jgraph.subscribe_all(N, 1), tgraph.subscribe_all(N, 1)
    jcfg = JCfg.build(jconfig.GossipSubParams(flood_publish=flood_publish))
    tcfg = TCfg.build(tconfig.GossipSubParams(flood_publish=flood_publish))
    sched, topics = _schedule()
    warmup = 20
    o = _oracles("gossipsub", jt, tt, js, ts, jcfg, tcfg, warmup, sched, topics)
    net = Net.build(tt, ts, device="cpu")
    st = GossipSubState.init(net, MSG_SLOTS, tcfg, seed=3)
    hv, st = _engine_hops(net, st, make_gossipsub_step(tcfg, net), warmup, sched, topics)
    ho = list(o.hops().values())
    n_msgs = PUB_ROUNDS * PUBS_PER_ROUND
    cv, co = _cdf(hv, n_msgs * N), _cdf(ho, n_msgs * N)
    assert _sup(cv, co) <= 0.02, f"CDF sup-distance {_sup(cv, co):.4f}\nvec={cv}\noracle={co}"
    assert cv[-1] >= 0.999 and co[-1] >= 0.999
    mv, mo = np.mean(hv), np.mean(ho)
    assert abs(mv - mo) / mo <= 0.02, f"mean hops {mv:.3f} vs {mo:.3f}"
    if flood_publish:
        return
    ev_v = st.core.events.numpy()
    for e in (EV.DELIVER_MESSAGE, EV.DUPLICATE_MESSAGE, EV.SEND_RPC):
        v, w = float(ev_v[e]), float(o.events[e])
        assert w > 0 and abs(v - w) / w <= 0.10, f"event {e}: engine {v} oracle {w}"
    assert int(ev_v[EV.PUBLISH_MESSAGE]) == int(o.events[EV.PUBLISH_MESSAGE])


def test_randomsub_cdf_within_2pct_of_the_port_oracle():
    jt, tt = _graphs()
    js, ts = jgraph.subscribe_all(N, 1), tgraph.subscribe_all(N, 1)
    sched, topics = _schedule()
    o = _oracles("randomsub", jt, tt, js, ts, None, None, 0, sched, topics)
    net = Net.build(tt, ts, device="cpu")
    st = SimState.init(N, MSG_SLOTS, seed=3, k=net.max_degree, device="cpu")
    hv, _st = _engine_hops(net, st, make_randomsub_step(net), 0, sched, topics)
    n_msgs = PUB_ROUNDS * PUBS_PER_ROUND
    cv, co = _cdf(hv, n_msgs * N), _cdf(list(o.hops().values()), n_msgs * N)
    assert _sup(cv, co) <= 0.02, f"CDF sup-distance {_sup(cv, co):.4f}\nvec={cv}\noracle={co}"
    assert cv[-1] >= 0.999 and co[-1] >= 0.999


def _v11(name):
    """``tests/test_parity_v11.py``'s sybil and eth2 setups on both
    packages: graphs, subscriptions, configs, score parameters, the
    no-forward set, the schedule and its topics."""
    sides = []
    for cfgmod, graph in ((jconfig, jgraph), (tconfig, tgraph)):
        cfg_cls = JCfg if cfgmod is jconfig else TCfg
        if name == "sybil":
            topo = graph.random_connect(N, d=DEG, seed=5)
            subs = graph.subscribe_all(N, 1)
            tp = cfgmod.TopicScoreParams(
                mesh_message_deliveries_weight=-0.5, mesh_message_deliveries_threshold=4.0,
                mesh_message_deliveries_activation=10.0, mesh_message_deliveries_window=2.0)
            sp = cfgmod.PeerScoreParams(topics={0: tp}, skip_app_specific=True,
                                        behaviour_penalty_weight=-1.0,
                                        behaviour_penalty_threshold=1.0,
                                        behaviour_penalty_decay=0.9)
            thr = cfgmod.PeerScoreThresholds(gossip_threshold=-10.0, publish_threshold=-20.0,
                                             graylist_threshold=-40.0)
            cfg = dataclasses.replace(cfg_cls.build(cfgmod.GossipSubParams(), thr,
                                                    score_enabled=True), fanout_slots=0)
        else:
            topo = graph.random_connect(N, d=DEG, seed=9)
            subs = graph.subscribe_random(N, n_topics=8, topics_per_peer=2, seed=3)
            tp = cfgmod.TopicScoreParams(mesh_message_deliveries_weight=0.0,
                                         mesh_failure_penalty_weight=0.0)
            sp = cfgmod.PeerScoreParams(topics={t: tp for t in range(8)},
                                        skip_app_specific=True,
                                        behaviour_penalty_weight=-1.0,
                                        behaviour_penalty_threshold=1.0,
                                        behaviour_penalty_decay=0.9)
            cfg = cfg_cls.build(cfgmod.GossipSubParams(), cfgmod.PeerScoreThresholds(),
                                score_enabled=True)
        sides.append((topo, subs, cfg, sp))
    if name == "sybil":
        rng = np.random.default_rng(2)
        adversary = rng.random(N) < 0.2
        honest = np.flatnonzero(~adversary)
        sched = honest[rng.integers(0, len(honest), size=(PUB_ROUNDS, PUBS_PER_ROUND))]
        topics = np.zeros((PUB_ROUNDS, PUBS_PER_ROUND), np.int32)
    else:
        rng = np.random.default_rng(4)
        adversary = None
        sched = rng.integers(0, N, size=(PUB_ROUNDS, PUBS_PER_ROUND))
        topics = rng.integers(0, 8, size=(PUB_ROUNDS, PUBS_PER_ROUND)).astype(np.int32)
    return sides, adversary, sched.astype(np.int32), topics


@pytest.mark.parametrize("name", ["sybil", "eth2"])
def test_v11_composed_cdf_within_2pct_of_the_port_oracle(name):
    """``tests/test_parity_v11.py::test_v11_composed_cdf_within_2pct`` on
    the port, its scored oracle equal to the JAX package's."""
    ((jt, js, jcfg, jsp), (tt, ts, tcfg, tsp)), adversary, sched, topics = _v11(name)
    warmup = 24
    adv = None if adversary is None else set(np.flatnonzero(adversary).tolist())
    o = _oracles("gossipsub", jt, tt, js, ts, jcfg, tcfg, warmup, sched, topics, jsp=jsp,
                 tsp=tsp, adversary=adv)
    net = Net.build(tt, ts, device="cpu")
    st = GossipSubState.init(net, MSG_SLOTS, tcfg, score_params=tsp, seed=3)
    step = make_gossipsub_step(tcfg, net, score_params=tsp, adversary_no_forward=adversary)
    hv, _st = _engine_hops(net, st, step, warmup, sched, topics, sub_only=True)
    sub = ts.subscribed
    ho = [h for (i, slot), h in o.hops().items() if sub[i, o.msgs[slot].topic]]
    total = sum(int(sub[:, int(t)].sum()) for t in topics.ravel())
    cv, co = _cdf(hv, total), _cdf(ho, total)
    assert _sup(cv, co) <= 0.02, (f"[{name}] CDF sup-distance {_sup(cv, co):.4f}\n"
                                  f"vec={np.round(cv, 4)}\noracle={np.round(co, 4)}")
    assert cv[-1] > 0.9 and co[-1] > 0.9


def test_floodsub_and_score_oracles_equal_reference():
    """OracleFloodSub over a lattice and a random graph, and OracleScore
    driven through graft, deliveries, prunes and decay: equal to the JAX
    package's models."""
    for jt, tt in ((jgraph.ring_lattice(64, d=4), tgraph.ring_lattice(64, d=4)),
                   (jgraph.random_connect(64, d=5, seed=2), tgraph.random_connect(64, d=5,
                                                                                  seed=2))):
        rng = np.random.default_rng(1)
        pubs = rng.integers(0, 64, size=(10, 3))
        res = []
        for cls, topo, subs in ((JFlood, jt, jgraph.subscribe_all(64, 1)),
                                (TFlood, tt, tgraph.subscribe_all(64, 1))):
            o = cls(topo, subs, msg_slots=32)
            for r in range(16):
                o.step([(int(p), 0, bool(p % 5)) for p in pubs[r]] if r < 10 else ())
            res.append((o.hops(), list(o.events)))
        assert res[0] == res[1] and len(res[0][0]) > 0
    out = []
    for cls, cfgmod in ((JScore, jconfig), (TScore, tconfig)):
        sp = cfgmod.PeerScoreParams(
            topics={0: cfgmod.TopicScoreParams(mesh_message_deliveries_weight=-1.0,
                                               mesh_message_deliveries_activation=2.0,
                                               invalid_message_deliveries_weight=-2.0)},
            skip_app_specific=True, behaviour_penalty_weight=-1.0,
            behaviour_penalty_threshold=1.0)
        s = cls(sp)
        rng = np.random.default_rng(3)
        trace = []
        for t in range(40):
            for p in range(6):
                u = rng.random()
                if u < 0.1:
                    s.graft(p, 0, t)
                elif u < 0.35:
                    s.first_delivery(p, 0)
                elif u < 0.5:
                    s.duplicate_delivery(p, 0, bool(rng.random() < 0.5))
                elif u < 0.55:
                    s.invalid_delivery(p, 0)
                elif u < 0.6:
                    s.prune(p, 0)
                elif u < 0.65:
                    s.add_penalty(p, int(rng.integers(1, 3)))
            s.refresh(t)
            trace.append([s.score(p, ip_count=1 + p % 2, app_score=0.5) for p in range(6)])
        out.append(trace)
    assert out[0] == out[1] and len({x for row in out[0] for x in row}) > 3
