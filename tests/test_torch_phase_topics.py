"""The port's phase engine against the JAX package's on a wide topic
universe, leaf by leaf, after every phase.

Ten topics, four a peer (``subscribe_random``), each publish on a topic of
its origin's own. Past eight topics the JAX package recomputes the
membership planes (which slots and peers hold each message's topic) every
sub-round; the port carries them incrementally for every universe, so the
words must come out the same. Cells: the K=16 lattice (banded,
``edge_exchange`` on the card) and a random dense net, r=8, a heartbeat
every phase. The port runs with ``device="cpu"``."""

from __future__ import annotations

import numpy as np
import pytest
from torch_parity import bench_builds, phases_against_reference

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph

N = 96
ROUNDS = 32


@pytest.mark.parametrize("kind", ["lattice", "random"])
def test_wide_universe_equals_reference_every_phase(kind):
    if kind == "lattice":
        topologies = jgraph.ring_lattice(N, d=8), tgraph.ring_lattice(N, d=8)
    else:
        topologies = jgraph.random_connect(N, d=6, seed=1), tgraph.random_connect(N, d=6, seed=1)
    subs = jgraph.subscribe_random(N, 10, 4, seed=2)
    builds = bench_builds(n=N, heartbeat_every=8, topologies=topologies, subscriptions=subs)
    assert builds[4].n_topics == 10 and (builds[4].band_off is not None) == (kind == "lattice")
    tst = phases_against_reference(builds, 8, 8, ROUNDS)
    leaves = convert.state_leaves(tst)
    topic = leaves[".core.msgs.topic"]
    assert len(np.unique(topic[topic >= 0])) > 8
    assert leaves[".mesh"].any(-1).all(-1).mean() > 0.9
    born = leaves[".core.msgs.birth"]
    reach = (leaves[".core.dlv.first_round"] >= 0).sum(0)
    assert np.median(reach[(born >= 8) & (born <= ROUNDS - 8)]) > 1
