"""Bench workloads built on the port, and the loop that drives them with
the bench's publish schedule:

* ``build_bench`` — the three configurations of the JAX package's
  ``perf/sweep.build_bench`` (GossipSub v1.1, live scoring,
  ``ring_lattice(n, d=8)`` so K=16, 4 publishes per round): ``default``
  (one topic every peer subscribes), ``eth2`` (64 topics, 2 a peer, fanout)
  and ``sybil`` (one topic, 20% no-forward sybils, the peer gater, the
  validation throttle and deficit scoring); banded dense or, with
  ``edge_layout="csr"``, CSR-resident, built with the ``fused`` flag the
  config and the Net share: the per-round step, or with
  ``rounds_per_phase`` > 1 the phase engine ``bench.py`` measures (r=8
  there), driven by ``run_phases``;
* ``churn_up``, ``build_overlay`` — the churn cell (the default config
  with ``dynamic_peers``: a fifth of the peers down and back) and the
  mutating overlay (the default config with ``dynamic_topo`` on a
  power-law net with free slots, under ``topo.churn_storm``);
* ``build_floodsub`` — FloodSub on one topic every peer joins, over the
  same lattice or the capacity-bounded power-law graph, in the dense or
  the CSR layout;
* ``build_randomsub`` — RandomSub (``BASELINE.json`` config #2: 1k peers,
  D=6 fanout, one topic) on the same graphs or ``random_connect(n, 32)``,
  with the size estimate, the queue cap and the validation pipeline passed
  explicitly (no bench config runs it);
* ``measure_rate``, ``metric_name``, ``workload_fingerprint`` — the bench
  line of ``python -m go_libp2p_pubsub_tpu_torch.bench``: a config driven
  through ``driver.make_scan`` (a captured CUDA graph a block on the card),
  as the JAX package's bench drives its compiled windows."""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from .. import graph as graphlib
from .. import topo
from ..chaos import adversary as adversary_mod
from ..config import (
    GossipSubParams,
    PeerGaterParams,
    PeerScoreParams,
    PeerScoreThresholds,
    TopicScoreParams,
)
from ..models.floodsub import floodsub_step
from ..models.randomsub import make_randomsub_step
from ..driver import heartbeat_schedule
from ..models.gossipsub import GossipSubConfig, GossipSubState, make_gossipsub_step
from ..models.gossipsub_phase import make_gossipsub_phase_step
from ..state import Net, SimState, resolve_device

#: publish batch width of every bench cell ([R, 4] schedules)
PUBS_PER_ROUND = 4

#: the JAX package's phase engine takes its scatter publish allocation from
#: this peer count (a fingerprint field; the port's phase engine allocates
#: one way at every N, to the same bits)
SCATTER_ALLOC_MIN_N = 20_000

#: the bench configs (the JAX package's perf/sweep.build_bench)
CONFIGS = ("default", "eth2", "sybil")

#: the sybil config's share of no-forward peers
SYBIL_FRACTION = 0.2

#: the PX cell's share of dormant lattice edges (``graph.dormant_edges``,
#: seed 5)
PX_DORMANT = 0.3


def _check_config(config: str) -> None:
    if config not in CONFIGS:
        raise ValueError(f"unknown bench config {config!r}; one of {CONFIGS}")


def bench_score_params(config: str, n_topics: int):
    """The per-config score parameterization. ``sybil`` turns the delivery
    deficit on (the sybils are what scoring must catch); the honest
    configs turn it off, and every publish being valid, P4 with it.
    Returns (TopicScoreParams, PeerScoreParams)."""
    if config == "sybil":
        tp = TopicScoreParams(
            mesh_message_deliveries_weight=-0.5,
            mesh_message_deliveries_threshold=4.0,
            mesh_message_deliveries_activation=10.0,
            mesh_message_deliveries_window=2.0,
        )
    else:
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


def bench_wire_coalesced(wire_coalesced: bool | None = None) -> bool:
    """The bench's wire form: the coalesced control head and stacked
    accumulators (the default), or with ``BENCH_WIRE_COALESCED=0`` the
    per-plane A/B form. One source for the build and the fingerprint."""
    if wire_coalesced is not None:
        return bool(wire_coalesced)
    return os.environ.get("BENCH_WIRE_COALESCED", "1") != "0"


def bench_topics(config: str) -> int:
    """The config's topic universe: eth2's 64 attestation subnets, else 1."""
    return 64 if config == "eth2" else 1


def bench_parts(n_peers: int, seed: int = 0, config: str = "default",
                count_events: bool = False, edge_layout: str = "dense", fused: bool = False,
                rounds_per_phase: int = 1, heartbeat_every: int | None = None, device=None,
                queue_cap: int = 0, validation_delay_rounds: int = 0, px: bool = False,
                wire_coalesced: bool | None = None, chaos=None, router=None):
    """(net, cfg, score params, gater params, no-forward vector) of a bench
    config, as ``build_bench`` builds them (its arguments of the same
    names)."""
    _check_config(config)
    dev = resolve_device(device)
    tp = graphlib.ring_lattice(n_peers, d=8)
    n_topics = bench_topics(config)
    if config == "eth2":
        subs = graphlib.subscribe_random(n_peers, n_topics=n_topics, topics_per_peer=2,
                                         seed=seed)
    else:
        subs = graphlib.subscribe_all(n_peers, 1)
    net = Net.build(tp, subs, edge_layout=edge_layout, fused=fused, device=dev)
    params = dataclasses.replace(GossipSubParams(), flood_publish=False, do_px=px)
    _tp, sp = bench_score_params(config, n_topics)
    gater = PeerGaterParams() if config == "sybil" else None
    no_forward = None
    if config == "sybil":
        no_forward = np.random.default_rng(seed).random(n_peers) < SYBIL_FRACTION
    r = int(rounds_per_phase)
    he = (r if r > 1 else 1) if heartbeat_every is None else int(heartbeat_every)
    cfg = GossipSubConfig.build(params, bench_thresholds(px), score_enabled=True,
                                heartbeat_every=he, gater_params=gater,
                                validation_capacity=8 if config == "sybil" else 0,
                                queue_cap=queue_cap,
                                validation_delay_rounds=validation_delay_rounds,
                                edge_layout=edge_layout, fused=fused,
                                wire_coalesced=bench_wire_coalesced(wire_coalesced),
                                trace_exact=px, narrow_counters=px, chaos=chaos,
                                router=router)
    cfg = dataclasses.replace(cfg, count_events=count_events,
                              fanout_slots=cfg.fanout_slots if config == "eth2" else 0)
    return net, cfg, sp, gater, no_forward


def bench_invariants(n_peers: int, *, check_every: int, due_fn=None,
                     delivery_window: int = 12, batched: bool = False, **bench_kw):
    """The invariant oracle of a bench build (``oracle.invariants.
    ScanInvariants`` on ``bench_parts``' net and config): fold its ``check``
    into ``driver.make_window(check=spec.check, check_every=check_every)``.
    ``bench_kw`` are ``bench_parts``' (the engine, the layout, the
    device)."""
    from ..oracle.invariants import InvariantConfig, ScanInvariants

    r = int(bench_kw.get("rounds_per_phase", 1))
    net, cfg, _sp, _g, _nf = bench_parts(n_peers, **bench_kw)
    return ScanInvariants("phase" if r > 1 else "gossipsub", net, cfg,
                          InvariantConfig(delivery_window=delivery_window,
                                          check_every=check_every),
                          batched=batched, due_fn=due_fn, rounds_per_step=r)


def build_bench(n_peers: int, msg_slots: int, seed: int = 0,
                config: str = "default", count_events: bool = False,
                edge_layout: str = "dense", fused: bool = False,
                rounds_per_phase: int = 1, heartbeat_every: int | None = None,
                device=None, queue_cap: int = 0, validation_delay_rounds: int = 0,
                px: bool = False, dynamic_peers: bool = False,
                wire_coalesced: bool | None = None, lift_scores: bool = False,
                score_counts: bool = False, chaos=None, telemetry=None, adversary=None,
                router=None):
    """Build (state, step, n_topics, honest) for a bench config, tracer
    detached (no event counters unless ``count_events``):

    * ``default`` — one topic every peer subscribes, no fanout slots (fanout
      cannot occur when every peer joins the topic);
    * ``eth2`` — 64 topics, each peer in 2 random ones (``subscribe_random``
      with the seed), 2 fanout slots: the Eth2 attestation-subnet geometry
      (BASELINE.json config #5);
    * ``sybil`` — one topic, 20% of the peers (``default_rng(seed)``) no-forward
      sybils, ``PeerGaterParams()``, ``validation_capacity=8`` and deficit
      scoring (BASELINE.json config #4); ``honest`` lists the other peers,
      the only publish origins (a sybil would drop its own publish).

    ``edge_layout`` and ``fused`` go to both ``Net.build`` and
    ``GossipSubConfig.build``, as in the JAX package. ``rounds_per_phase`` >
    1 builds the phase engine with a heartbeat every ``heartbeat_every``
    rounds (default: every phase, as ``bench.py`` runs it); 1 builds the
    per-round step (a heartbeat every round by default; every
    ``heartbeat_every`` rounds with a required ``do_heartbeat`` otherwise).
    ``queue_cap`` and ``validation_delay_rounds`` turn on the delivery
    core's options (no config has them on). ``px`` builds the PX cell:
    peer exchange over the lattice with ``PX_DORMANT`` of its edges
    dormant, AcceptPXThreshold 0 (the config's own default: at the
    thresholds' 10 a pruner, out of the pruned peer's mesh, never scores
    high enough on the bench lattice, and no edge activates), the
    exact-trace duplicate plane and the int16 IHAVE counters.
    ``dynamic_peers`` builds the churn cell's step, which takes a liveness
    row a dispatch (``churn_up``). ``wire_coalesced`` (default
    ``BENCH_WIRE_COALESCED``, on) picks the wire form; ``lift_scores``
    builds a lifted step, which takes ``bench_plane``'s plane (or any
    other) as its last argument; ``score_counts`` the phase engine's count
    path. ``chaos`` (a ``chaos.ChaosConfig``) turns the link-fault plane on:
    a ``scheduled`` config's step takes a ``link_deny`` row a dispatch
    after the liveness row. ``telemetry`` (a ``telemetry.TelemetryConfig``)
    builds the recording variant: the state carries the panel and the step
    writes a row a dispatch (its event columns move only with
    ``count_events``). ``adversary`` (a ``chaos.Adversary`` or an
    ``AttackScenario``, built against the bench lattice) arms the attack
    plane; ``honest`` then lists the peers outside its faction (and outside
    the sybil config's no-forward set). ``router`` (a ``routers.RouterConfig``
    without the latency ring, whose delay plane the lattice lacks) turns the
    router plane on; it needs the per-round step."""
    net, cfg, sp, gater, no_forward = bench_parts(
        n_peers, seed=seed, config=config, count_events=count_events,
        edge_layout=edge_layout, fused=fused, rounds_per_phase=rounds_per_phase,
        heartbeat_every=heartbeat_every, device=device, queue_cap=queue_cap,
        validation_delay_rounds=validation_delay_rounds, px=px,
        wire_coalesced=wire_coalesced, chaos=chaos, router=router)
    tp = graphlib.ring_lattice(n_peers, d=8)
    r, he, n_topics = int(rounds_per_phase), cfg.heartbeat_every, bench_topics(config)
    st = GossipSubState.init(
        net, msg_slots, cfg, score_params=sp, seed=seed,
        dormant=graphlib.dormant_edges(tp, PX_DORMANT, seed=5) if px else None,
        telemetry=telemetry)
    attack = adversary_mod.resolve(adversary, net)
    if r > 1:
        step = make_gossipsub_phase_step(cfg, net, r, score_params=sp, gater_params=gater,
                                         adversary_no_forward=no_forward,
                                         dynamic_peers=dynamic_peers, lift_scores=lift_scores,
                                         score_counts=score_counts, telemetry=telemetry,
                                         adversary=attack)
    else:
        step = make_gossipsub_step(cfg, net, score_params=sp, gater_params=gater,
                                   adversary_no_forward=no_forward,
                                   static_heartbeat=he > 1, dynamic_peers=dynamic_peers,
                                   lift_scores=lift_scores, telemetry=telemetry,
                                   adversary=attack)
    faction = np.zeros((n_peers,), bool)
    if no_forward is not None:
        faction |= no_forward
    if attack is not None:
        faction |= attack.is_sybil
    honest = np.flatnonzero(~faction) if faction.any() else None
    return st, step, n_topics, honest


def bench_thresholds(px: bool = False) -> PeerScoreThresholds:
    """The bench's score thresholds (the PX cell's AcceptPXThreshold 0)."""
    thresholds = PeerScoreThresholds()
    if px:
        thresholds = dataclasses.replace(thresholds, accept_px_threshold=0.0)
    return thresholds


def bench_plane(config: str = "default", device=None, mesh: bool = False, px: bool = False):
    """The lifted plane of a bench config's own values
    (``ScoreParams.from_config``): a lifted bench step fed it computes what
    the static build computes. ``mesh`` adds the mesh degrees
    (``CandidateParams``)."""
    from ..score.params import CandidateParams, ScoreParams

    _check_config(config)
    n_topics = bench_topics(config)
    _tp, sp = bench_score_params(config, n_topics)
    params = dataclasses.replace(GossipSubParams(), flood_publish=False, do_px=px)
    cfg = GossipSubConfig.build(params, bench_thresholds(px), score_enabled=True)
    make = CandidateParams if mesh else ScoreParams
    return make.from_config(cfg, sp, n_topics, device=resolve_device(device))


#: the churn cell: churn_storm's kill fraction and its kill and replace
#: points over an 80-round run, on the up plane alone
CHURN = dict(kill_frac=0.2, rounds=80, down_at=16, up_at=48)


def churn_up(n_peers: int, rounds: int = CHURN["rounds"], kill_frac: float = CHURN["kill_frac"],
             down_at: int = CHURN["down_at"], up_at: int = CHURN["up_at"],
             seed: int = 0) -> np.ndarray:
    """[rounds, N] bool liveness rows of the churn cell: ``kill_frac`` of the
    peers (``default_rng(seed).choice``, without replacement) down in rounds
    [down_at, up_at), every peer up otherwise."""
    up = np.ones((rounds, n_peers), bool)
    victims = np.random.default_rng(seed).choice(n_peers, int(round(kill_frac * n_peers)),
                                                 replace=False)
    up[down_at:up_at, victims] = False
    return up


#: the mutating overlay's graph: a power-law tail of 60 padded to a
#: capacity of 64, which leaves free slots for joins
OVERLAY = dict(exponent=2.2, d_min=2, max_degree=60, capacity=64)


def build_overlay(n_peers: int, msg_slots: int, n_dispatches: int, edge_layout: str = "dense",
                  seed: int = 0, count_events: bool = False, device=None, storm=None):
    """The mutating overlay: the bench default config's per-round step with
    ``dynamic_peers`` and ``dynamic_topo`` on ``topo.powerlaw(n, 2.2,
    d_min=2, max_degree=60, seed)`` padded to K = 64, built dynamic (dense,
    or the full-capacity CSR layout, E = N·K), under ``topo.churn_storm``
    (a fifth killed a quarter in and replaced half way with 2 links each, 8
    rewires, 2 joins). ``storm`` reuses a schedule already compiled for
    the same graph. Returns (state, step, schedule, seconds the schedule
    took to compile)."""
    dev = resolve_device(device)
    tp = topo.to_topology(topo.powerlaw(n_peers, OVERLAY["exponent"], d_min=OVERLAY["d_min"],
                                        max_degree=OVERLAY["max_degree"], seed=seed),
                          max_degree=OVERLAY["capacity"])
    t0 = time.perf_counter()
    if storm is None:
        storm = topo.churn_storm(tp, n_dispatches=n_dispatches, kill_frac=0.2, rewires=8,
                                 joins=2, join_links=2, seed=seed)
        storm.build()
    storm_seconds = time.perf_counter() - t0
    net = Net.build(tp, graphlib.subscribe_all(n_peers, 1), edge_layout=edge_layout,
                    device=dev, dynamic=True)
    params = dataclasses.replace(GossipSubParams(), flood_publish=False)
    _tp, sp = bench_score_params("default", 1)
    cfg = GossipSubConfig.build(params, PeerScoreThresholds(), score_enabled=True,
                                edge_layout=edge_layout)
    cfg = dataclasses.replace(cfg, count_events=count_events, fanout_slots=0)
    st = GossipSubState.init(net, msg_slots, cfg, score_params=sp, seed=seed, dynamic_topo=True)
    step = make_gossipsub_step(cfg, net, score_params=sp, dynamic_peers=True,
                               dynamic_topo=True)
    return st, step, storm, storm_seconds


#: the power-law graph of the CSR runs: topo.powerlaw's defaults, the
#: max-degree cap being the padded K
POWERLAW = dict(exponent=2.2, d_min=2, max_degree=64)

#: dials a peer of the ``"random"`` graph makes (random_connect's d)
RANDOM_DIALS = 32


@dataclasses.dataclass
class FloodSubRun:
    """A built FloodSub workload's step: ``run(state, po, pt, pv[,
    link_deny])`` (the deny row of a scheduled ``chaos``), with its
    ``adversary`` (its ``AdversaryConsts``, built once) and ``telemetry``
    planes. Keeps the Net and the host seconds its build took (graph
    generation, topology and CSR build, upload, state init)."""

    net: Net
    setup_seconds: float
    queue_cap: int = 0
    chaos: object = None
    adversary: object = None
    telemetry: object = None

    def __call__(self, st, pub_origin, pub_topic, pub_valid, link_deny=None):
        return floodsub_step(self.net, st, pub_origin, pub_topic, pub_valid,
                             queue_cap=self.queue_cap, chaos=self.chaos,
                             link_deny=link_deny, telemetry=self.telemetry,
                             adversary=self.adversary)


@dataclasses.dataclass
class RandomSubRun:
    """A built RandomSub workload's step (``make_randomsub_step``'s), with
    the Net and the host seconds of the build."""

    net: Net
    setup_seconds: float
    step: object

    def __call__(self, st, pub_origin, pub_topic, pub_valid, *rows):
        return self.step(st, pub_origin, pub_topic, pub_valid, *rows)


def _one_topic_net(n_peers: int, graph: str, layout: str, seed: int, dev) -> Net:
    """The Net of a one-topic workload: ``"lattice"`` is
    ``ring_lattice(n, d=8)`` (K=16, banded when dense), ``"powerlaw"``
    ``topo.powerlaw(n, 2.2, d_min=2, max_degree=64, seed)`` padded to K=64,
    ``"random"`` ``random_connect(n, RANDOM_DIALS, seed)``."""
    if graph == "lattice":
        tp = graphlib.ring_lattice(n_peers, d=8)
    elif graph == "powerlaw":
        el = topo.powerlaw(n_peers, seed=seed, **POWERLAW)
        tp = topo.to_topology(el, max_degree=POWERLAW["max_degree"])
    elif graph == "random":
        tp = graphlib.random_connect(n_peers, RANDOM_DIALS, seed=seed)
    else:
        raise ValueError(f"graph must be 'lattice', 'powerlaw' or 'random', got {graph!r}")
    return Net.build(tp, graphlib.subscribe_all(n_peers, 1), edge_layout=layout, device=dev)


def _one_topic_state(net: Net, msg_slots: int, layout: str, resident: bool, seed: int,
                     val_delay: int = 0, chaos=None, telemetry=None) -> SimState:
    n_edges = net.n_edges if layout == "csr" and resident else None
    return SimState.init(net.n_peers, msg_slots, seed=seed, k=net.max_degree,
                         device=net.device, n_edges=n_edges, val_delay=val_delay,
                         chaos_ge=chaos is not None and chaos.needs_state, telemetry=telemetry)


def build_floodsub(n_peers: int, msg_slots: int, graph: str = "lattice",
                   layout: str = "dense", resident: bool = True,
                   seed: int = 0, device=None, queue_cap: int = 0, chaos=None,
                   adversary=None, telemetry=None):
    """Build (state, step) for FloodSub on one topic every peer joins.

    ``graph``: ``"lattice"``, ``"powerlaw"`` or ``"random"``
    (``_one_topic_net``). ``layout="csr"`` builds the flat edge space;
    with ``resident`` the state keeps its first-arrival plane flat
    ``[E, W]``, else dense ``[N, K, W]``. ``queue_cap`` is the step's
    outbound-queue cap, ``chaos`` its link-fault plane (a scheduled config's
    step takes a ``link_deny`` row), ``adversary`` its attack plane (a
    ``chaos.Adversary`` or an ``AttackScenario``, built here against the
    net), ``telemetry`` its panel (the state carries it).
    ``step.setup_seconds`` is the host time of the build."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    net = _one_topic_net(n_peers, graph, layout, seed, dev)
    st = _one_topic_state(net, msg_slots, layout, resident, seed, chaos=chaos,
                          telemetry=telemetry)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st, FloodSubRun(net, time.perf_counter() - t0, queue_cap, chaos,
                           adversary_mod.build_consts(adversary, net), telemetry)


def build_randomsub(n_peers: int, msg_slots: int, graph: str = "lattice",
                    size_estimate: int | None = None, device=None, *,
                    layout: str = "dense", resident: bool = True,
                    queue_cap: int = 0, val_delay: int = 0, seed: int = 0, chaos=None,
                    adversary=None, telemetry=None):
    """Build (state, step) for RandomSub on one topic every peer joins,
    over ``graph`` as ``build_floodsub`` takes it. ``size_estimate`` sets
    the fanout target max(6, ceil(sqrt(size))) (None: each topic's
    subscribers); ``queue_cap`` and ``val_delay`` (the pipeline's depth)
    are the delivery core's options, ``chaos`` the link-fault plane,
    ``adversary`` the attack plane and ``telemetry`` the panel."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    net = _one_topic_net(n_peers, graph, layout, seed, dev)
    st = _one_topic_state(net, msg_slots, layout, resident, seed, val_delay, chaos=chaos,
                          telemetry=telemetry)
    step = make_randomsub_step(net, size_estimate=size_estimate, queue_cap=queue_cap,
                               chaos=chaos, adversary=adversary, telemetry=telemetry)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st, RandomSubRun(net, time.perf_counter() - t0, step)


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


def run_phases(st, step, po, pt, pv, *, rounds_per_phase: int, heartbeat_every: int,
               up=None, consts=(), link_deny=None):
    """Drive a phase step over a publish schedule of whole phases ([R, P],
    R a multiple of ``rounds_per_phase``, uploaded once): ``[r, P]`` blocks
    with ``heartbeat_schedule``'s flags for the phases' tick windows (the
    state's tick, read once, must start a phase). ``up`` ([R, N]) is a
    ``dynamic_peers`` step's liveness schedule and ``link_deny`` ([R, N, K])
    a scheduled chaos step's deny plane: a phase takes its first round's
    row of each. ``consts`` (a lifted step's plane) follow every call's
    rows."""
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
    extra = tuple(torch.as_tensor(np.asarray(a)[::r], device=dev)
                  for a in (up, link_deny) if a is not None)
    for p in range(len(po_t)):
        st = step(st, po_t[p], pt_t[p], pv_t[p], *(a[p] for a in extra), *consts,
                  do_heartbeat=flags[(tick // r + p) % len(flags)])
    return st


def run_rounds(st, step, po, pt, pv, *rows, consts=()):
    """Drive ``step`` over a publish schedule (uploaded once); ``st`` is a
    GossipSub state or a ``SimState``. ``rows`` are further per-round
    arrays (a ``dynamic_peers`` step's liveness rows [R, N], a
    ``dynamic_topo`` step's write batches [R, B, 4]); ``consts`` (a lifted
    step's plane) follow every call's rows."""
    dev = (st.core if hasattr(st, "core") else st).tick.device
    po_t, pt_t, pv_t, *rows_t = (torch.as_tensor(np.asarray(a), device=dev)
                                 for a in (po, pt, pv, *rows))
    for r in range(len(po_t)):
        st = step(st, po_t[r], pt_t[r], pv_t[r], *(a[r] for a in rows_t), *consts)
    return st


def metric_name(config: str, n_peers: int, rounds_per_phase: int) -> str:
    """The bench's metric name (the JAX package's convention: a phase
    metric carries its cadence)."""
    tag = "" if config == "default" else f"_{config}"
    if rounds_per_phase > 1:
        return (f"gossipsub_v1.1_delivery_rounds_per_sec_n{n_peers}{tag}"
                f"_phase{rounds_per_phase}")
    return f"gossipsub_v1.1_heartbeat_ticks_per_sec_n{n_peers}{tag}"


def workload_fingerprint(config: str, n_peers: int, msg_slots: int, heartbeat_every: int,
                         rounds_per_phase: int, seg_rounds: int | None = None,
                         unroll: int | None = None, edge_layout: str = "dense",
                         device=None, wire_coalesced: bool | None = None,
                         lift_scores: bool = False) -> dict:
    """The bench line's self-description, field for field the JAX
    package's. ``platform`` is ``cuda`` and the card's name (``cpu`` on the
    CPU), ``prng_impl`` the port's one generator, ``n_devices`` 1.
    ``permute_sets_per_phase`` counts the phase engine's edge crossings a
    phase: the coalesced control head and one data crossing a sub-round
    (``edge_exchange`` launches 1 + r times a phase on the banded lattice).
    Two fields are the port's own: ``incr_members`` (its phase engine
    carries the membership planes incrementally for any topic universe)
    and, for ``eth2`` and ``sybil``, ``permute_sets_per_phase`` (the JAX
    package crosses the edges once more a phase, for the heartbeat's
    neighbour-protocol view or the gater's source groups; the port builds
    both once, with the step, as static views). In the per-plane form
    (``wire_coalesced`` False) the head crosses twice: the control words
    with the scores, and the IWANT window. ``params`` names the fields a
    lifted build reads from its plane (``score.params.LIFTED_FIELD_NAMES``)."""
    from .artifacts import (
        chaos_fingerprint,
        execution_fingerprint,
        params_fingerprint,
        router_fingerprint,
    )
    from ..score.params import LIFTED_FIELD_NAMES

    _check_config(config)
    n_topics = bench_topics(config)
    tp, sp = bench_score_params(config, n_topics)
    r = int(rounds_per_phase)
    phase = r > 1
    p3_elided = (tp.mesh_message_deliveries_weight == 0.0
                 and (tp.mesh_failure_penalty_weight == 0.0
                      or tp.mesh_message_deliveries_threshold <= 0.0))
    p4_elided = tp.invalid_message_deliveries_weight == 0.0
    coalesced = bench_wire_coalesced(wire_coalesced)
    fp = {
        "config": config,
        "n_peers": int(n_peers),
        "msg_slots": int(msg_slots),
        "degree": 16,
        "n_topics": n_topics,
        "topics_per_peer": 2 if config == "eth2" else 1,
        "adversary_fraction": SYBIL_FRACTION if config == "sybil" else 0.0,
        "rounds_per_phase": r,
        "heartbeat_every": int(heartbeat_every),
        "pubs_per_round": PUBS_PER_ROUND,
        "score_weights": {
            "mesh_message_deliveries_weight": tp.mesh_message_deliveries_weight,
            "mesh_failure_penalty_weight": tp.mesh_failure_penalty_weight,
            "invalid_message_deliveries_weight": tp.invalid_message_deliveries_weight,
            "first_message_deliveries_weight": tp.first_message_deliveries_weight,
            "time_in_mesh_weight": tp.time_in_mesh_weight,
            "behaviour_penalty_weight": sp.behaviour_penalty_weight,
        },
        "elides_mesh_message_deliveries": bool(phase and p3_elided),
        "elides_invalid_message_deliveries": bool(phase and p4_elided),
        "engine": {
            "mode": "phase" if phase else "per_round",
            "wire_coalesced": coalesced,
            "edge_layout": edge_layout,
            "gater": config == "sybil",
            "validation_capacity": 8 if config == "sybil" else 0,
            "count_events": False,
            "fanout_slots": 2 if config == "eth2" else 0,
            "scatter_publish_alloc": bool(phase and n_peers >= SCATTER_ALLOC_MIN_N),
            # incremental membership planes: the port's phase engine keeps
            # them for any topic universe, the JAX package's up to 8 topics
            "incr_members": phase,
        },
        "chaos": chaos_fingerprint(),
        "params": params_fingerprint(lift_scores, LIFTED_FIELD_NAMES if lift_scores else ()),
        "router": router_fingerprint(),
    }
    if seg_rounds is not None:
        fp["seg_rounds"] = int(seg_rounds)
    if unroll is not None:
        fp["unroll"] = int(unroll)
    if seg_rounds is not None:
        fp["execution"] = execution_fingerprint(
            scan=True, segment_rounds=int(seg_rounds), dispatches_per_window=1,
            rounds_per_dispatch=int(seg_rounds), unroll=unroll)
    if phase:
        fp["permute_sets_per_phase"] = r + 1 if coalesced else r + 2
    dev = resolve_device(device)
    fp["platform"] = (f"cuda {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
                      else dev.type)
    fp["prng_impl"] = "threefry2x32"
    fp["n_devices"] = 1
    return fp


def measure_rate(config: str, n_req: int, msg_slots: int, heartbeat_every: int,
                 rounds_per_phase: int, seg_rounds: int, reps: int = 3,
                 unroll: int | None = None, edge_layout: str = "dense", device=None,
                 wire_coalesced: bool | None = None):
    """Build and run one bench cell through ``driver.make_scan``; returns
    (rounds_per_sec, n_used, unroll_used, scan) or None. The rate is the best
    of ``reps`` windows of ``seg_rounds`` rounds (cut to whole lcm(he, r)
    groups) after one window that captures and warms; each timed window
    ends in a readback of the tick and a score checksum. ``unroll`` is
    rounds a captured block (default 2·lcm(he, r) in phase mode, 4 rounds
    per-round). Out of device memory it halves N down to 10k (below 10k
    the request runs as it is), and the N used is returned."""
    from ..driver import make_scan

    he, r = int(heartbeat_every), int(rounds_per_phase)
    group = math.lcm(he, r)
    seg = seg_rounds - seg_rounds % group
    if seg <= 0:
        raise ValueError(f"seg_rounds={seg_rounds} < one lcm(heartbeat_every, "
                         f"rounds_per_phase) group ({group})")
    sizes, nn = [n_req], n_req // 2
    while nn >= 10_000:
        sizes.append(nn)
        nn //= 2
    for n in sizes:
        try:
            st, step, n_topics, honest = build_bench(
                n, msg_slots, config=config, heartbeat_every=he, rounds_per_phase=r,
                edge_layout=edge_layout, device=device, wire_coalesced=wire_coalesced)
            po, pt, pv = publish_schedule(seg, n, n_topics, honest)
            dev = st.core.tick.device
            po, pt, pv = (torch.as_tensor(a, device=dev) for a in (po, pt, pv))
            u = unroll if unroll is not None else (2 * group if r > 1 else 4)
            scan = make_scan(step, heartbeat_every=he, rounds_per_phase=r,
                             static_heartbeat=he > 1 or r > 1, unroll=max(1, u // group))
            st = scan(st, po, pt, pv)                       # capture and warm up
            _ = (int(st.core.tick), float(st.scores.sum()))
            rates = []
            for _ in range(reps):
                t0 = time.perf_counter()
                st = scan(st, po, pt, pv)
                # the completion barrier: a readback that depends on the
                # whole window
                _ = (int(st.core.tick), float(st.scores.sum()))
                rates.append(seg / (time.perf_counter() - t0))
            return max(rates), n, u, scan
        except torch.cuda.OutOfMemoryError:
            st = step = scan = None
            torch.cuda.empty_cache()
            continue
    return None
