"""The lifted score plane (``score/params.py``, ``lift_scores=True``) held
against the JAX package's lifted builds.

A lifted step reads every score weight, decay, cap and threshold (and, with
a ``CandidateParams``, every mesh degree) from the plane passed to each
call, so one step runs any weight set. Here the port's lifted per-round
step and phase engine (r = 1 and 8) equal the JAX package's lifted builds
on every leaf after every round or phase, on the banded lattice, a random
dense net and CSR-resident, with the plane switched part way through one
run (the build's own values, the JAX lift test's ``second_plane`` moves,
and a candidate plane with moved degrees); the port's planes are
``convert.score_plane_from_reference`` of the JAX ones. At the build's own
values the lifted step equals the port's static step, and under the moved
plane the trajectory differs from it. FloodSub and RandomSub take the plane
and ignore it. A lifted window equals its eager loop under two planes in
one window object (its captures are counted on the card,
``tests/test_torch_kernels_cuda.py``).

The lifted score sum's float forms differ from the static build's (no
weight folds, the cap is a select): ``compute_scores_lifted`` equals the
JAX package's lifted ``compute_scores`` bit for bit on random counters at
residue widths, under the sybil parameters, the moved plane and the
subnormal cells, and the step equals the JAX lifted step under each
subnormal cell."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_score_fma import (
    _ALL,
    _ZERO_TOPIC,
    FMA_CELLS,
    P5_CELLS,
    SYBIL_CELL,
    WRAP_ULPS,
    _rings,
)
from torch_parity import (
    SECOND_PLANE,
    SUBNORMAL_CELLS,
    bench_builds,
    diff_leaves,
    lifted_planes,
    phase_schedule,
    phases_against_reference,
    reference_leaves,
    rounds_against_reference,
    subnormal_overrides,
)

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.config import PeerScoreParams as JPSP
from go_libp2p_pubsub_tpu.config import TopicScoreParams as JTSP
from go_libp2p_pubsub_tpu.score import engine as je
from go_libp2p_pubsub_tpu.score import params as jparams
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.config import PeerScoreParams as TPSP
from go_libp2p_pubsub_tpu_torch.config import TopicScoreParams as TTSP
from go_libp2p_pubsub_tpu_torch.models import floodsub as tfs
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.ops.fnum import flush_subnormals
from go_libp2p_pubsub_tpu_torch.score import engine as te
from go_libp2p_pubsub_tpu_torch.score import params as tparams
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import SimState

N = 96
#: the candidate plane's degrees: D, Dlo and Dhi moved off the config's
DEGREES = dict(D=5, Dlo=4, Dhi=8, Dscore=3, Dlazy=4)

NETS = {
    "lattice": dict(),
    "random": dict(topologies=(jgraph.random_connect(N, d=4, seed=1),
                               tgraph.random_connect(N, d=4, seed=1))),
    "csr": dict(edge_layout="csr", fused=True),
}


def _three_planes(builds):
    """plane(i) for i in [0, 3): the builds' own values, the moved plane,
    the candidate plane with moved degrees."""
    planes = [lifted_planes(builds), lifted_planes(builds, moves=SECOND_PLANE),
              lifted_planes(builds, mesh=True, moves=SECOND_PLANE, degrees=DEGREES)]
    return planes


@pytest.mark.parametrize("net", sorted(NETS))
def test_lifted_step_equals_reference(net):
    """24 rounds, the plane switched every 8: every leaf after every round."""
    builds = bench_builds(n=N, d=4, config="sybil", **NETS[net])
    planes = _three_planes(builds)
    rounds_against_reference(builds, 24, codes=True, step_kw={"lift_scores": True},
                             plane=lambda t: planes[t // 8])


@pytest.mark.parametrize("net,r", [("lattice", 8), ("csr", 8), ("lattice", 1)])
def test_lifted_phase_equals_reference(net, r):
    """Every leaf after every phase, the plane switched every third of the
    run."""
    builds = bench_builds(n=N, d=4, config="sybil", **NETS[net])
    planes = _three_planes(builds)
    rounds = 48 if r > 1 else 12
    phases_against_reference(builds, r, r, rounds, codes=True, lift_scores=True,
                             plane=lambda p: planes[min(3 * p * r // rounds, 2)])


def _port_run(builds, n_rounds, plane=None, r=1):
    """The port's static (``plane`` None) or lifted step over the parity
    schedule from the init state; returns the final state."""
    _j, _jn, _js, tcfg, tnet, tsp = builds
    st = TState.init(tnet, 64, tcfg, score_params=tsp, seed=0)
    lift = plane is not None
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(N, n_rounds))
    extra = (plane,) if lift else ()
    if r == 1:
        step = tmake(tcfg, tnet, score_params=tsp, lift_scores=lift)
        for t in range(n_rounds):
            st = step(st, po[t], pt[t], pv[t], *extra)
        return st
    step = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp, lift_scores=lift,
                                     exact_counters=True)
    for p in range(n_rounds // r):
        sl = slice(p * r, (p + 1) * r)
        st = step(st, po[sl], pt[sl], pv[sl], *extra, do_heartbeat=True)
    return st


@pytest.mark.parametrize("r", [1, 8])
def test_matched_plane_equals_static_build_and_moved_plane_differs(r):
    """At the build's own values the lifted step is the static step, leaf
    for leaf (the phase engine with ``exact_counters``, as a lifted build
    carries every attribution plane); under the moved plane the scores,
    the mesh and the counters go another way (on the K = 16 lattice, where
    the mesh is a choice among the neighbours)."""
    builds = bench_builds(n=N, d=8, config="sybil")
    tsp, tcfg = builds[5], builds[3]
    static = _port_run(builds, 32, r=r)
    matched = _port_run(builds, 32, tparams.ScoreParams.from_config(tcfg, tsp, device="cpu"),
                        r=r)
    diff_leaves(convert.state_leaves(static), convert.state_leaves(matched), f"r={r}")
    moved = _port_run(builds, 32, lifted_planes(builds, moves=SECOND_PLANE)[1], r=r)
    a, b = convert.state_leaves(static), convert.state_leaves(moved)
    for leaf in (".scores", ".mesh", ".score.fmd", ".core.dlv.first_round"):
        assert not np.array_equal(a[leaf], b[leaf]), leaf


def test_candidate_plane_degrees_bound_the_mesh():
    """On the K = 16 lattice a candidate plane with D = 5, Dlo = 4, Dhi = 8
    keeps every peer's mesh degree within [Dlo, Dhi] once formed, where the
    config's (D = 6, Dhi = 12) lets it grow past 8: the mesh plane reaches
    the heartbeat's selections."""
    builds = bench_builds(n=N, d=8)
    plane = lifted_planes(builds, mesh=True, degrees=dict(D=5, Dlo=4, Dhi=8))[1]
    static = _port_run(builds, 16)
    lifted = _port_run(builds, 16, plane)
    deg = lifted.mesh.sum(-1).numpy()
    assert deg.min() >= 4 and deg.max() <= 8
    assert static.mesh.sum(-1).max() > 8


def test_floodsub_and_randomsub_take_the_plane():
    """FloodSub's ``score_plane`` keyword and a lifted RandomSub step's last
    positional are taken and unused: the rounds equal the plain ones."""
    net = TNet.build(tgraph.ring_lattice(64, d=4), tgraph.subscribe_all(64, 1), device="cpu")
    plane = tparams.ScoreParams.build(TPSP(topics={0: TTSP()}), device="cpu")
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(64, 12))
    plain_rs, lifted_rs = trs.make_randomsub_step(net), trs.make_randomsub_step(
        net, lift_scores=True)
    outs = []
    for flood, rs in ((lambda s, *a: tfs.floodsub_step(net, s, *a), plain_rs),
                      (lambda s, *a: tfs.floodsub_step(net, s, *a, score_plane=plane),
                       lambda s, *a: lifted_rs(s, *a, plane))):
        sf = ss = SimState.init(64, 64, seed=0, k=net.max_degree, device="cpu")
        for t in range(12):
            sf, ss = flood(sf, po[t], pt[t], pv[t]), rs(ss, po[t], pt[t], pv[t])
        outs.append((convert.state_leaves(sf), convert.state_leaves(ss)))
    for a, b in zip(*outs):
        diff_leaves(a, b)


@pytest.mark.parametrize("r", [1, 8])
def test_lifted_window_equals_eager_under_two_planes(r):
    """One ``make_scan`` window run under the build's plane, then the moved
    plane: each equals the eager loop under the same plane."""
    builds = bench_builds(n=N, d=4, config="sybil")
    _j, _jn, _js, tcfg, tnet, tsp = builds
    planes = [p for _, p in _three_planes(builds)[:2]]
    if r > 1:
        step = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp, lift_scores=True)
    else:
        step = tmake(tcfg, tnet, score_params=tsp, lift_scores=True)
    scan = driver.make_scan(step, rounds_per_phase=r, heartbeat_every=r)
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(N, 16))
    for plane in planes:
        st0 = TState.init(tnet, 64, tcfg, score_params=tsp, seed=0)
        win = scan(st0, po, pt, pv, consts=(plane,))
        st = TState.init(tnet, 64, tcfg, score_params=tsp, seed=0)
        for p in range(16 // r):
            sl = slice(p * r, (p + 1) * r) if r > 1 else p
            st = (step(st, po[sl], pt[sl], pv[sl], plane, do_heartbeat=True) if r > 1
                  else step(st, po[sl], pt[sl], pv[sl], plane))
        diff_leaves(convert.state_leaves(st), convert.state_leaves(win))


@pytest.mark.parametrize("mesh", [False, True])
def test_score_plane_from_reference_round_trips(mesh):
    """A JAX plane's leaves become the port's plane with the same names,
    dtypes and values, and back; ``from_config`` of one config builds the
    same plane in both packages."""
    builds = bench_builds(n=N, d=4, config="sybil")
    jplane, tplane = lifted_planes(builds, mesh=mesh, moves=SECOND_PLANE,
                                   degrees=DEGREES if mesh else None)
    diff_leaves(reference_leaves(jplane), convert.plane_leaves(tplane))
    assert tplane.app_specific_weight == jplane.app_specific_weight
    make_j = jparams.CandidateParams if mesh else jparams.ScoreParams
    make_t = tparams.CandidateParams if mesh else tparams.ScoreParams
    diff_leaves(reference_leaves(make_j.from_config(builds[0], builds[2], 1)),
                convert.plane_leaves(make_t.from_config(builds[3], builds[5], 1, device="cpu")))
    assert tparams.LIFTED_FIELD_NAMES == jparams.LIFTED_FIELD_NAMES
    assert tparams.MESH_LIFTED_FIELD_NAMES == jparams.MESH_LIFTED_FIELD_NAMES


def _lifted_scores(cell, seed, n=64, d=4, plane_kw=None):
    """(port, JAX) lifted ``compute_scores`` on random counters, the JAX
    one jitted with the plane as a traced argument."""
    topic_kw, peer_kw, n_topics, per_topic = cell
    kws = [dict(topic_kw, **per_topic.get(t, {})) for t in range(n_topics)]
    jsp = JPSP(topics={t: JTSP(**kw) for t, kw in enumerate(kws)}, **peer_kw)
    tsp = TPSP(topics={t: TTSP(**kw) for t, kw in enumerate(kws)}, **peer_kw)
    jsub = jgraph.subscribe_all(n, n_topics)
    jtopo, ttopo = _rings(n, d)
    jnet = JNet.build(jtopo, jsub)
    tnet = TNet.build(ttopo, tgraph.Subscriptions(*(np.asarray(getattr(jsub, f)) for f in (
        "subscribed", "my_topics", "slot_of"))), device="cpu")
    s, k = jnet.my_topics.shape[1], int(2 * d)
    rng = np.random.default_rng(seed)
    f = lambda *shape: (rng.random(shape) * 3).astype(np.float32)
    planes = dict(fmd=f(n, s, k), mmd=f(n, s, k), mfp=f(n, s, k), imd=f(n, s, k), bp=f(n, k))
    ints = dict(mesh_time=rng.integers(0, 50, (n, s, k)).astype(np.int32),
                mmd_active=rng.random((n, s, k)) < 0.7)
    in_mesh = rng.random((n, s, k)) < 0.5
    p6, app = f(n, k), f(n)
    jst = je.ScoreState.empty(n, s, k).replace(
        **{x: jnp.asarray(v) for x, v in {**planes, **ints}.items()})
    jplane = jparams.ScoreParams.build(jsp, None, n_topics)
    fn = jax.jit(lambda st, m, p, a, pl: je.compute_scores(
        st, m, pl.gather(jnet.my_topics), pl, p, a, jnet))
    want = np.asarray(fn(jst, jnp.asarray(in_mesh), jnp.asarray(p6), jnp.asarray(app), jplane))
    tst = dataclasses.replace(te.ScoreState.empty(n, s, k, "cpu"), **{
        x: torch.from_numpy(v) for x, v in {**planes, **ints}.items()})
    tplane = convert.score_plane_from_reference(
        reference_leaves(jplane), device="cpu",
        app_specific_weight=jplane.app_specific_weight).flushed()
    got = te.compute_scores_lifted(tst, torch.from_numpy(in_mesh),
                                   tplane.gather(tnet.my_topics), tplane,
                                   flush_subnormals(torch.from_numpy(p6)),
                                   torch.from_numpy(app), tnet).numpy()
    return got, want


_PEER = FMA_CELLS["p2"][1]
#: cells of the lifted float map: the sybil terms, the moved plane's, every
#: term on two slots, P6 with and without the topic-score cap on one slot,
#: and the subnormal weights
LIFT_CELLS = {
    "sybil": SYBIL_CELL,
    "moved": (dict(_ZERO_TOPIC, **SECOND_PLANE["topic"]),
              dict(_PEER, **SECOND_PLANE["peer"]), 1, {}),
    "every_term": FMA_CELLS["every_term"],
    "p3b": FMA_CELLS["p3b"],
    "p6_one_topic": FMA_CELLS["p6_one_topic"],
    "p6_capped": FMA_CELLS["p6_capped"],
    "subnormal_negative": (dict(_ZERO_TOPIC, **SUBNORMAL_CELLS["negative"]["topic"]),
                           dict(_PEER, **SUBNORMAL_CELLS["negative"]["peer"]), 1, {}),
    "subnormal_caps": (dict(_ZERO_TOPIC, mesh_message_deliveries_weight=-1.0,
                            first_message_deliveries_cap=1e-40),
                       dict(_PEER, topic_score_cap=1e-40), 1, {}),
}


@pytest.mark.parametrize("k", [3, 4, 9, 16, 18, 21, 41])
@pytest.mark.parametrize("name", sorted(LIFT_CELLS))
def test_lifted_score_sum_equals_reference(name, k):
    """Bit for bit on every column: the fused forms of the vector chunks
    and the one-slot scalar columns (``lifted_scalar_columns``: columns 0-1
    of a row of 3, a row of 4, column 8 of a row of 9)."""
    d = k / 2 if k % 2 else k // 2
    for seed in (0, 1):
        got, want = _lifted_scores(LIFT_CELLS[name], seed, d=d)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", sorted(P5_CELLS))
def test_lifted_score_sum_with_app_scores(name):
    """With P5 live (a host weight under lift too) the lifted sum is
    bit-exact off the rows XLA:CPU splits off around the banded gather's
    wrap (the first and last 2d rows of the ring) and within ``WRAP_ULPS``
    of the largest term on them, as the static sum is (ROADMAP §3)."""
    n, d = 64, 4
    cell = P5_CELLS[name]
    bound = 3 * (abs(cell[1]["app_specific_weight"]) + abs(cell[1]["ip_colocation_factor_weight"])
                 + 4 * abs(cell[1]["behaviour_penalty_weight"]) + 100 * cell[2])
    for seed in (0, 1):
        got, want = _lifted_scores(cell, seed, n=n, d=d)
        inner = slice(2 * d, n - 2 * d)
        np.testing.assert_array_equal(got[inner].view(np.uint32), want[inner].view(np.uint32))
        tol = WRAP_ULPS * float(np.spacing(np.float32(bound)))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


#: the lifted scalar columns with P5 live: every topic term on one slot,
#: the topic-score cap off and on
_P5_PEER = dict(P5_CELLS["p5_one_topic"][1], behaviour_penalty_weight=-0.8)
P5_LIFT_CELLS = {
    "uncapped": (_ALL, _P5_PEER, 1, {}),
    "capped": (_ALL, dict(_P5_PEER, topic_score_cap=5.0), 1, {}),
}


@pytest.mark.parametrize("n", [64, 96, 256])
@pytest.mark.parametrize("k", [3, 4, 9])
@pytest.mark.parametrize("name", sorted(P5_LIFT_CELLS))
def test_lifted_scalar_columns_with_app_scores(name, k, n):
    """The one-slot scalar columns with P5 live (``lifted_scalar_columns``
    with ``app_on``: columns 0-1 of a row of 3 take P5's product fused and
    P6's rounded apart; rows of 4 and 9 keep no scalar column): bit for
    bit off the banded gather's wrap rows (the first and last 2d rows of
    the ring) and within ``WRAP_ULPS`` of the largest term on them, as
    ``test_lifted_score_sum_with_app_scores``."""
    d = k / 2 if k % 2 else k // 2
    wrap = int(2 * d)
    cell = P5_LIFT_CELLS[name]
    bound = 3 * (abs(cell[1]["app_specific_weight"]) + abs(cell[1]["ip_colocation_factor_weight"])
                 + 4 * abs(cell[1]["behaviour_penalty_weight"]) + 100 * cell[2])
    for seed in (0, 1):
        got, want = _lifted_scores(cell, seed, n=n, d=d)
        inner = slice(wrap, n - wrap)
        np.testing.assert_array_equal(got[inner].view(np.uint32), want[inner].view(np.uint32))
        tol = WRAP_ULPS * float(np.spacing(np.float32(bound)))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("cell", sorted(SUBNORMAL_CELLS))
def test_lifted_step_flushes_subnormals_as_the_reference(cell):
    """The lifted step under each subnormal cell, the plane's leaves
    carrying the raw subnormal values (flushed on the device): every leaf
    after every round."""
    builds = bench_builds(n=N, d=4, **subnormal_overrides(cell, N))
    rng = np.random.default_rng(2)
    po = rng.integers(0, N, size=(16, 4)).astype(np.int32)
    pv = rng.random((16, 4)) < 0.8
    st = rounds_against_reference(builds, 16, schedule=(po, np.zeros_like(po), pv),
                                  step_kw={"lift_scores": True}, plane=lifted_planes(builds))
    scores = convert.state_leaves(st)[".scores"]
    assert not np.any((scores != 0) & (np.abs(scores) < np.finfo(np.float32).tiny))


def test_lift_needs_scoring():
    builds = bench_builds(n=N, d=4)
    cfg = dataclasses.replace(builds[3], score_enabled=False)
    with pytest.raises(ValueError, match="score_enabled"):
        tmake(cfg, builds[4], lift_scores=True)
    with pytest.raises(ValueError, match="score_enabled"):
        make_gossipsub_phase_step(cfg, builds[4], 8, lift_scores=True)
