"""The outbound-queue cap (``queue_cap``) in every engine of the port,
against the JAX package's, leaf by leaf, every round or phase.

Each directed link carries at most ``queue_cap`` messages a round, the
lowest slots first, and the overflow is lost and counted (DROP_RPC). In
GossipSub the IWANT responses share the link's budget with the push, and a
link that saturates in a round suppresses that round's heartbeat gossip
toward it (``congested_in``). Cells: FloodSub and RandomSub on the banded
lattice (which the cap routes off ``delivery_banded``) and CSR-resident
(off ``csr_delivery``), the per-round GossipSub step on the banded lattice
(off the fused kernels) and the phase engine at r = 1 and 8, at caps of 1
and 2. A cap that never binds equals no cap, across the routing change.
The port runs with ``device="cpu"``; no tolerance on any leaf."""

from __future__ import annotations

import dataclasses
import functools

import pytest
import torch
from test_torch_randomsub import ROUNDS, nets, randomsub_steps, run_against_reference, schedule
from torch_parity import (
    bench_builds,
    diff_leaves,
    phase_schedule,
    phases_against_reference,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState, make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.perf import sweep as tsweep

DROP_RPC = 8


def floodsub_steps(jnet, tnet, queue_cap):
    return (functools.partial(jflood.floodsub_step, jnet, queue_cap=queue_cap),
            functools.partial(tflood.floodsub_step, tnet, queue_cap=queue_cap))


@pytest.mark.parametrize("engine,kind,queue_cap", [
    ("floodsub", "lattice", 1), ("floodsub", "powerlaw", 2),
    ("randomsub", "lattice", 2), ("randomsub", "powerlaw", 1),
])
def test_router_cap_equals_reference(engine, kind, queue_cap):
    layout = "csr" if kind == "powerlaw" else "dense"
    jnet, tnet = nets(kind, layout)
    if engine == "floodsub":
        steps = floodsub_steps(jnet, tnet, queue_cap)
    else:
        steps = randomsub_steps(jnet, tnet, size_estimate=30, queue_cap=queue_cap)
    leaves = run_against_reference(jnet, tnet, *steps, resident=kind == "powerlaw")
    assert leaves[".events"][DROP_RPC] > 0


def _congestion_log():
    """An ``observe`` callback: the most links seen congested at once."""
    seen = [0]

    def observe(st):
        seen[0] = max(seen[0], int(st.congested_in.sum()))
    return seen, observe


@pytest.mark.parametrize("engine,queue_cap", [
    ("round", 1), ("round", 2), ("phase1", 1), ("phase8", 2),
])
def test_gossipsub_cap_equals_reference(engine, queue_cap):
    builds = bench_builds(n=96, d=4, queue_cap=queue_cap)
    seen, observe = _congestion_log()
    if engine == "round":
        st = rounds_against_reference(builds, 16, observe=observe)
    else:
        r = 1 if engine == "phase1" else 8
        st = phases_against_reference(builds, r, 1, 16 if r == 1 else 24, observe=observe)
    assert int(st.core.events[DROP_RPC]) > 0 and seen[0] > 0


def test_cap_that_never_binds_equals_no_cap():
    """``queue_cap=10**6`` takes the composites, ``queue_cap=0`` the
    kernels' plain versions (FloodSub's ``delivery_banded``, GossipSub's
    fused round): every leaf equal (tests/test_backpressure.py:124)."""
    po, pt, pv = (torch.from_numpy(a) for a in schedule(256, ROUNDS))
    out = []
    for cap in (0, 10**6):
        st, run = tsweep.build_floodsub(256, 64, device="cpu", queue_cap=cap)
        out.append(convert.state_leaves(tsweep.run_rounds(st, run, po, pt, pv)))
    diff_leaves(*out, "floodsub")
    _j, _jn, _jsp, tcfg, tnet, tsp = bench_builds(n=96, d=4)
    po, pt, pv = phase_schedule(96, ROUNDS)
    out = []
    for cap in (0, 10**6):
        cfg = dataclasses.replace(tcfg, queue_cap=cap)
        step = make_gossipsub_step(cfg, tnet, score_params=tsp)
        st = GossipSubState.init(tnet, 64, cfg, score_params=tsp)
        out.append(convert.state_leaves(tsweep.run_rounds(st, step, po, pt, pv)))
    diff_leaves(*out, "gossipsub per-round")
