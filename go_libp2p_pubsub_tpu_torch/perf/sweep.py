"""Bench workloads built on the port, and the loop that drives them with
the bench's publish schedule:

* ``build_bench`` — the ``default`` configuration of the JAX package's
  ``perf/sweep.build_bench`` (GossipSub v1.1, one topic every peer
  subscribes, live scoring, ``ring_lattice(n, d=8)`` so K=16, 4 publishes
  per round), banded dense or, with ``edge_layout="csr"``, CSR-resident,
  built with the ``fused`` flag the config and the Net share: the per-round
  step, or with ``rounds_per_phase`` > 1 the phase engine ``bench.py``
  measures (r=8 there), driven by ``run_phases``;
* ``build_floodsub`` — FloodSub on one topic every peer joins, over the
  same lattice or the capacity-bounded power-law graph, in the dense or
  the CSR layout."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import graph as graphlib
from .. import topo
from ..config import GossipSubParams, PeerScoreParams, PeerScoreThresholds, TopicScoreParams
from ..models.floodsub import floodsub_step
from ..driver import heartbeat_schedule
from ..models.gossipsub import GossipSubConfig, GossipSubState, make_gossipsub_step
from ..models.gossipsub_phase import make_gossipsub_phase_step
from ..state import Net, SimState, resolve_device

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
                edge_layout: str = "dense", fused: bool = False,
                rounds_per_phase: int = 1, heartbeat_every: int | None = None,
                device=None):
    """Build (state, step, n_topics, honest) for the ``default`` bench
    config, tracer detached (no event counters unless ``count_events``),
    no fanout slots (every peer joins the topic). ``edge_layout`` and
    ``fused`` go to both ``Net.build`` and ``GossipSubConfig.build``, as in
    the JAX package. ``rounds_per_phase`` > 1 builds the phase engine with a
    heartbeat every ``heartbeat_every`` rounds (default: every phase, as
    ``bench.py`` runs it); 1 builds the per-round step (a heartbeat every
    round by default; every ``heartbeat_every`` rounds with a required
    ``do_heartbeat`` otherwise)."""
    if config != "default":
        raise NotImplementedError(
            f"bench config {config!r} is not ported yet (eth2 needs fanout, "
            "sybil the gater and adversary planes) — ROADMAP §1 items 3 and 5")
    dev = resolve_device(device)
    tp = graphlib.ring_lattice(n_peers, d=8)
    n_topics = 1
    subs = graphlib.subscribe_all(n_peers, 1)
    net = Net.build(tp, subs, edge_layout=edge_layout, fused=fused, device=dev)
    params = dataclasses.replace(GossipSubParams(), flood_publish=False)
    _tp, sp = bench_score_params(n_topics)
    r = int(rounds_per_phase)
    he = (r if r > 1 else 1) if heartbeat_every is None else int(heartbeat_every)
    cfg = GossipSubConfig.build(params, PeerScoreThresholds(), score_enabled=True,
                                heartbeat_every=he, edge_layout=edge_layout, fused=fused)
    cfg = dataclasses.replace(cfg, count_events=count_events, fanout_slots=0)
    st = GossipSubState.init(net, msg_slots, cfg, score_params=sp, seed=seed)
    if r > 1:
        step = make_gossipsub_phase_step(cfg, net, r, score_params=sp)
    else:
        step = make_gossipsub_step(cfg, net, score_params=sp, static_heartbeat=he > 1)
    return st, step, n_topics, None


#: the power-law graph of the CSR runs: topo.powerlaw's defaults, the
#: max-degree cap being the padded K
POWERLAW = dict(exponent=2.2, d_min=2, max_degree=64)


@dataclasses.dataclass
class FloodSubRun:
    """A built FloodSub workload's step: ``run(state, po, pt, pv)``. Keeps
    the Net and the host seconds its build took (graph generation,
    topology and CSR build, upload, state init)."""

    net: Net
    setup_seconds: float

    def __call__(self, st, pub_origin, pub_topic, pub_valid):
        return floodsub_step(self.net, st, pub_origin, pub_topic, pub_valid)


def build_floodsub(n_peers: int, msg_slots: int, graph: str = "lattice",
                   layout: str = "dense", resident: bool = True,
                   seed: int = 0, device=None):
    """Build (state, step) for FloodSub on one topic every peer joins.

    ``graph``: ``"lattice"`` is ``ring_lattice(n, d=8)`` (K=16,
    banded when dense); ``"powerlaw"`` is ``topo.powerlaw(n, 2.2, d_min=2,
    max_degree=64, seed)`` padded to K=64. ``layout="csr"`` builds the
    flat edge space; with ``resident`` the state keeps its first-arrival
    plane flat ``[E, W]``, else dense ``[N, K, W]``. ``step.setup_seconds``
    is the host time of the build."""
    if graph not in ("lattice", "powerlaw"):
        raise ValueError(f"graph must be 'lattice' or 'powerlaw', got {graph!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if graph == "lattice":
        tp = graphlib.ring_lattice(n_peers, d=8)
    else:
        el = topo.powerlaw(n_peers, seed=seed, **POWERLAW)
        tp = topo.to_topology(el, max_degree=POWERLAW["max_degree"])
    net = Net.build(tp, graphlib.subscribe_all(n_peers, 1), edge_layout=layout,
                    device=dev)
    n_edges = net.n_edges if layout == "csr" and resident else None
    st = SimState.init(n_peers, msg_slots, seed=seed, k=net.max_degree,
                       device=dev, n_edges=n_edges)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st, FloodSubRun(net, time.perf_counter() - t0)


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


def run_phases(st, step, po, pt, pv, *, rounds_per_phase: int, heartbeat_every: int):
    """Drive a phase step over a publish schedule of whole phases ([R, P],
    R a multiple of ``rounds_per_phase``, uploaded once): ``[r, P]`` blocks
    with ``heartbeat_schedule``'s flags for the phases' tick windows (the
    state's tick, read once, must start a phase)."""
    r = int(rounds_per_phase)
    if len(po) % r:
        raise ValueError(f"{len(po)} rounds are not whole phases of {r}")
    tick = int(st.core.tick)
    if tick % r:
        raise ValueError(f"tick {tick} does not start a phase of {r} rounds")
    flags = heartbeat_schedule(heartbeat_every, r)
    dev = st.core.tick.device
    po_t, pt_t, pv_t = (torch.as_tensor(np.asarray(a), device=dev).reshape(
        (-1, r) + np.asarray(a).shape[1:]) for a in (po, pt, pv))
    for p in range(len(po_t)):
        st = step(st, po_t[p], pt_t[p], pv_t[p],
                  do_heartbeat=flags[(tick // r + p) % len(flags)])
    return st


def run_rounds(st, step, po, pt, pv):
    """Drive ``step`` over a publish schedule (uploaded once); ``st`` is a
    GossipSub state or a ``SimState``."""
    dev = (st.core if hasattr(st, "core") else st).tick.device
    po_t, pt_t, pv_t = (torch.as_tensor(np.asarray(a), device=dev)
                        for a in (po, pt, pv))
    for r in range(len(po_t)):
        st = step(st, po_t[r], pt_t[r], pv_t[r])
    return st
