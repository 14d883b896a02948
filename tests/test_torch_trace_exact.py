"""The exact-trace duplicate plane (``cfg.trace_exact``) and the hop count
(``state.hops``) of the port, against the JAX package's, leaf by leaf,
every round or phase.

``dup_trans`` holds each round's arrivals beyond the first per (peer,
msg), per edge (trace.go:186-194), taken before the validation throttle
(its refusals are fresh receipts, traced Reject) and by arrival under the
async-validation pipeline; the phase engine ORs its sub-rounds into one
lane that recycled slots do not clear. Its popcount equals the device's
DuplicateMessage counter's step a round and bounds it a phase (as
tests/test_phase.py::test_phase_trace_exact_dup_plane_reconciles holds the
JAX package, equal where no pair repeats within a phase). ``hops`` is the
per-(peer, msg) hop count behind the propagation-hop CDF. Cells: the per-round step on the banded lattice (the
plain ``fused_delivery``, whose ``trans`` output feeds the plane) under
the throttle, on a random dense net under the pipeline, and the phase
engine on the lattice (r = 8) and CSR-resident (r = 2), both under the
throttle. The port runs with ``device="cpu"``; no tolerance on any
leaf."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bench_builds, phases_against_reference, rounds_against_reference

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import state as jstate
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import state as tstate
from go_libp2p_pubsub_tpu_torch.ops import bitset
from go_libp2p_pubsub_tpu_torch.trace.events import EV

N = 96
TRACE = dict(trace_exact=True)


class DupLog:
    """An ``observe`` callback holding each ``dup_trans`` popcount to the
    DuplicateMessage counter's step: equal a round; at most the step a
    phase, whose lane ORs its sub-rounds (an (edge, slot) pair that repeats
    within a phase, its slot recycled, is one bit)."""

    def __init__(self, exact: bool):
        self.exact = exact
        self.prev = 0
        self.total = 0

    def __call__(self, st):
        now = int(st.core.events[EV.DUPLICATE_MESSAGE])
        plane = int(bitset.popcount(st.dup_trans).sum())
        step = now - self.prev
        assert plane == step if self.exact else plane <= step, (plane, step)
        self.prev = now
        self.total += plane


@pytest.mark.parametrize("kind,kw", [
    ("lattice", dict(validation_capacity=2)),
    ("random", dict(validation_delay_rounds=2)),
], ids=["lattice-throttle", "random-pipeline"])
def test_dup_plane_rounds_equal_reference(kind, kw):
    topos = ((jgraph.ring_lattice(N, d=4), tgraph.ring_lattice(N, d=4)) if kind == "lattice"
             else (jgraph.random_connect(N, 5, seed=1), tgraph.random_connect(N, 5, seed=1)))
    builds = bench_builds(n=N, topologies=topos, options=TRACE, **kw)
    log = DupLog(exact=True)
    st = rounds_against_reference(builds, 16, observe=log)
    assert log.total > 0 and st.dup_trans.shape == (N, topos[1].max_degree, 2)


@pytest.mark.parametrize("layout,r", [("dense", 8), ("csr", 2)])
def test_dupt_lane_phases_equal_reference(layout, r):
    """The phase engine's ``dupt`` lane: the lattice at r = 8 crosses its
    data with ``edge_exchange``'s plain version; CSR-resident keeps the
    plane dense, as the JAX package does."""
    builds = bench_builds(n=N, d=4, options=TRACE, heartbeat_every=r, edge_layout=layout,
                          fused=layout == "csr", validation_capacity=3)
    log = DupLog(exact=False)
    st = phases_against_reference(builds, r, r, 24 if r == 8 else 16, observe=log)
    assert log.total > 0 and st.dup_trans.dim() == 3


def test_hops_equal_reference():
    """``state.hops`` of a run's final state equals the JAX package's on
    the same leaves: 0 at the origins, the rounds since the publish where
    delivered, -1 elsewhere."""
    builds = bench_builds(n=N, d=4)
    st = rounds_against_reference(builds, 12)
    got = tstate.hops(st.core.msgs, st.core.dlv)
    msgs = types.SimpleNamespace(birth=jnp.asarray(st.core.msgs.birth.numpy()))
    dlv = types.SimpleNamespace(first_round=jnp.asarray(st.core.dlv.first_round.numpy()))
    want = np.asarray(jstate.hops(msgs, dlv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    delivered = got[got >= 0]
    assert (delivered == 0).any() and (delivered > 1).any() and (got == -1).any()
