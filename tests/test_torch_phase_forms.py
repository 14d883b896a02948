"""The phase engine's count path (``score_counts=True``) and the per-plane
wire form (``cfg.wire_coalesced=False``) of both GossipSub engines, held
against the JAX package.

The count path reduces each sub-round's arrivals to per-(peer, slot, edge)
counts at arrival time and folds them into the counters at the phase tail
(``score.engine.apply_delivery_counts``): at r = 1 it is the per-round
step, and at r = 8 with message slots recycled within a phase it keeps the
first-delivery credit the plane path sheds, as the JAX package's does
(``tests/test_phase.py``). The per-plane form is the JAX package's A/B twin
of the coalesced one (the per-round control exchange at the phase head,
``allocate_publishes`` every sub-round, per-plane folds): every leaf equals
the JAX package's per-plane builds, with and without dynamic peers, and the
port's own coalesced form."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (
    bench_builds,
    diff_leaves,
    phase_schedule,
    phases_against_reference,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step

N = 96


def test_count_path_at_r1_is_the_per_round_step():
    """r = 1, 16 rounds of 4 publishes into 64 slots (no recycling): the
    count path equals the JAX count path every round, and the port's
    per-round step on every leaf."""
    builds = bench_builds(n=N, d=4, config="sybil")
    st = phases_against_reference(builds, 1, 1, 16, codes=True, score_counts=True)
    _j, _jn, _js, tcfg, tnet, tsp = builds
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(N, 16, codes=True))
    ref = TState.init(tnet, 64, tcfg, score_params=tsp, seed=0)
    step = tmake(tcfg, tnet, score_params=tsp)
    for t in range(16):
        ref = step(ref, po[t], pt[t], pv[t])
    diff_leaves(convert.state_leaves(ref), convert.state_leaves(st))


def test_count_path_with_recycling_equals_reference():
    """r = 8 over 48 rounds of 4 publishes into 64 slots, so slots recycle
    while their messages are still arriving: every leaf equals the JAX
    count path after every phase, the delivery planes equal the plane
    path's, and the count path keeps at least the plane path's P2 credit,
    more once recycling bites."""
    builds = bench_builds(n=N, d=4, config="sybil")
    counted = phases_against_reference(builds, 8, 8, 48, codes=True, score_counts=True)
    _j, _jn, _js, tcfg, tnet, tsp = builds
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(N, 48, codes=True))
    st = TState.init(tnet, 64, tcfg, score_params=tsp, seed=0)
    step = make_gossipsub_phase_step(tcfg, tnet, 8, score_params=tsp)
    for p in range(6):
        sl = slice(8 * p, 8 * p + 8)
        st = step(st, po[sl], pt[sl], pv[sl], do_heartbeat=True)
    for leaf in ("have", "first_round"):
        assert torch.equal(getattr(st.core.dlv, leaf), getattr(counted.core.dlv, leaf)), leaf
    assert float(counted.score.fmd.sum()) > float(st.score.fmd.sum())


def _up_rows(rounds: int, seed: int = 5) -> np.ndarray:
    """[rounds, N] liveness: about 5% of the peers down in each row's
    window, so transitions land both ways."""
    rng = np.random.default_rng(seed)
    up = np.ones((rounds, N), bool)
    for t0 in range(0, rounds, 8):
        up[t0:t0 + 8] = rng.random(N) > 0.05
    return up


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("engine", ["phase", "round"])
def test_per_plane_form_equals_reference(engine, dynamic):
    """Both engines under ``wire_coalesced=False`` against the JAX
    package's per-plane builds, every leaf after every round or phase, and
    the port's per-plane final state against its coalesced one."""
    builds = bench_builds(n=N, d=4, config="sybil", options=dict(wire_coalesced=False))
    up = _up_rows(32) if dynamic else None
    if engine == "phase":
        st = phases_against_reference(builds, 8, 8, 32, codes=True, up=up,
                                      dynamic_peers=dynamic)
    else:
        st = rounds_against_reference(builds, 16, codes=True, up=up,
                                      step_kw={"dynamic_peers": dynamic})
    _j, _jn, _js, tcfg, tnet, tsp = builds
    cfg = dataclasses.replace(tcfg, wire_coalesced=True)
    rounds = 32 if engine == "phase" else 16
    po, pt, pv = (torch.from_numpy(a) for a in phase_schedule(N, rounds, codes=True))
    ref = TState.init(tnet, 64, cfg, score_params=tsp, seed=0)
    extra = (lambda t: (torch.from_numpy(up[t]),)) if dynamic else (lambda t: ())
    if engine == "phase":
        step = make_gossipsub_phase_step(cfg, tnet, 8, score_params=tsp, dynamic_peers=dynamic)
        for p in range(4):
            sl = slice(8 * p, 8 * p + 8)
            ref = step(ref, po[sl], pt[sl], pv[sl], *extra(8 * p), do_heartbeat=True)
    else:
        step = tmake(cfg, tnet, score_params=tsp, dynamic_peers=dynamic)
        for t in range(16):
            ref = step(ref, po[t], pt[t], pv[t], *extra(t))
    diff_leaves(convert.state_leaves(ref), convert.state_leaves(st))


def test_per_plane_phase_csr_equals_reference():
    """The per-plane phase engine CSR-resident (its control exchange and
    IWANT window through ``Net.edge_gather``)."""
    builds = bench_builds(n=N, d=4, config="sybil", edge_layout="csr", fused=True,
                          options=dict(wire_coalesced=False))
    phases_against_reference(builds, 8, 8, 32, codes=True)
