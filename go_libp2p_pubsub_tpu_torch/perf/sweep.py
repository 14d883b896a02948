"""Bench workload: the ``default`` configuration of the JAX package's
``perf/sweep.build_bench`` (GossipSub v1.1, one topic every peer
subscribes, live scoring, ``ring_lattice(n, d=8)`` so K=16 and banded,
4 publishes per round) built on the port, and the loop that drives it with
the bench's publish schedule."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import graph
from ..config import GossipSubParams, PeerScoreParams, PeerScoreThresholds, TopicScoreParams
from ..models.gossipsub import GossipSubConfig, GossipSubState, make_gossipsub_step
from ..state import Net, resolve_device

#: publish batch width of every bench cell ([R, 4] schedules)
PUBS_PER_ROUND = 4


def bench_score_params(n_topics: int):
    """The ``default`` config's score parameterization: an honest net, so
    the delivery deficit is off and every publish is valid (P4 never
    fires). Returns (TopicScoreParams, PeerScoreParams)."""
    tp = TopicScoreParams(
        mesh_message_deliveries_weight=0.0,
        mesh_failure_penalty_weight=0.0,
        invalid_message_deliveries_weight=0.0,
    )
    sp = PeerScoreParams(
        topics={t: tp for t in range(n_topics)},
        skip_app_specific=True,
        behaviour_penalty_weight=-1.0,
        behaviour_penalty_threshold=1.0,
        behaviour_penalty_decay=0.9,
    )
    return tp, sp


def build_bench(n_peers: int, msg_slots: int, seed: int = 0,
                config: str = "default", count_events: bool = False,
                device=None):
    """Build (state, step, n_topics, honest) for the ``default`` bench
    config: the per-round step, tracer detached (no event counters unless
    ``count_events``), no fanout slots (every peer joins the topic)."""
    if config != "default":
        raise NotImplementedError(
            f"bench config {config!r} is not ported yet (eth2 needs fanout, "
            "sybil the gater and adversary planes) — ROADMAP §1 items 6-11")
    dev = resolve_device(device)
    topo = graph.ring_lattice(n_peers, d=8)
    n_topics = 1
    subs = graph.subscribe_all(n_peers, 1)
    net = Net.build(topo, subs, device=dev)
    params = dataclasses.replace(GossipSubParams(), flood_publish=False)
    _tp, sp = bench_score_params(n_topics)
    cfg = GossipSubConfig.build(params, PeerScoreThresholds(), score_enabled=True)
    cfg = dataclasses.replace(cfg, count_events=count_events, fanout_slots=0)
    st = GossipSubState.init(net, msg_slots, cfg, score_params=sp, seed=seed)
    step = make_gossipsub_step(cfg, net, score_params=sp)
    return st, step, n_topics, None


def publish_schedule(n_rounds: int, n_peers: int, n_topics: int,
                     honest: np.ndarray | None = None, seed: int = 0):
    """The bench's [R, 4] publish schedule (origins, topics, verdicts)."""
    rng = np.random.default_rng(seed)
    if honest is not None:
        po = honest[rng.integers(0, len(honest), size=(n_rounds, PUBS_PER_ROUND))]
    else:
        po = rng.integers(0, n_peers, size=(n_rounds, PUBS_PER_ROUND))
    pt = rng.integers(0, n_topics, size=(n_rounds, PUBS_PER_ROUND))
    pv = np.ones((n_rounds, PUBS_PER_ROUND), bool)
    return po.astype(np.int32), pt.astype(np.int32), pv


def run_rounds(st, step, po, pt, pv):
    """Drive ``step`` over a publish schedule (uploaded once)."""
    dev = st.core.tick.device
    po_t, pt_t, pv_t = (torch.as_tensor(np.asarray(a), device=dev)
                        for a in (po, pt, pv))
    for r in range(len(po_t)):
        st = step(st, po_t[r], pt_t[r], pv_t[r])
    return st
