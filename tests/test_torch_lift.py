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
weight folds, the cap is a select): tests/test_torch_lift_sums.py holds
``compute_scores_lifted`` to the JAX package's lifted ``compute_scores``
on random counters; tests/test_torch_lift_subnormal.py holds the lifted
step to the JAX lifted step under each subnormal cell (split so that each
file stays within a loadfile worker's share of the suite)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (
    SECOND_PLANE,
    bench_builds,
    diff_leaves,
    lifted_planes,
    phase_schedule,
    phases_against_reference,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.score import params as jparams
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.config import PeerScoreParams as TPSP
from go_libp2p_pubsub_tpu_torch.config import TopicScoreParams as TTSP
from go_libp2p_pubsub_tpu_torch.models import floodsub as tfs
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
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
    # the CSR-resident case (the lattice) replays the lattice case's JAX run
    rounds_against_reference(builds, 24, codes=True, step_kw={"lift_scores": True},
                             plane=lambda t: planes[t // 8],
                             share=("lift rounds", "random" if net == "random" else "lattice"))


@pytest.mark.parametrize("net,r", [("lattice", 8), ("csr", 8), ("lattice", 1)])
def test_lifted_phase_equals_reference(net, r):
    """Every leaf after every phase, the plane switched every third of the
    run."""
    builds = bench_builds(n=N, d=4, config="sybil", **NETS[net])
    planes = _three_planes(builds)
    rounds = 48 if r > 1 else 12
    phases_against_reference(builds, r, r, rounds, codes=True, lift_scores=True,
                             plane=lambda p: planes[min(3 * p * r // rounds, 2)],
                             share=("lift phases", r))


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


def test_lift_needs_scoring():
    builds = bench_builds(n=N, d=4)
    cfg = dataclasses.replace(builds[3], score_enabled=False)
    with pytest.raises(ValueError, match="score_enabled"):
        tmake(cfg, builds[4], lift_scores=True)
    with pytest.raises(ValueError, match="score_enabled"):
        make_gossipsub_phase_step(cfg, builds[4], 8, lift_scores=True)
