"""The per-round step at residue widths against the JAX package, every
leaf every round (split from tests/test_torch_score_fma.py, whose score
sums these runs reach through the heartbeat): a random dense net of K = 18
with P3 and P4 at -1, and several topic slots at K = 18, 17 and 16 with P3
and P7 at -1, both penalties live. A last-bit score difference in a
scalar-loop column flips a mesh decision and the run diverges from the
reference, so the whole run is the check."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_sybil import verdict_schedule
from torch_parity import bench_builds, rounds_against_reference

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu_torch import graph as tgraph


def test_step_with_p4_at_minus_one_on_a_residue_width_equals_reference():
    """The per-round step on a random dense net of K = 18 (two columns past
    the last whole chunk), one topic, the sybil config's deficit scoring
    with P3 and P4 at -1, a fifth of the publishes rejected: every leaf
    equal after every one of 24 rounds, a heartbeat each, the scores
    included. Before the tail columns took the scalar loop's form (P3's
    guarded square rounded apart) a last-bit score difference there
    flipped a mesh decision and the run diverged."""
    n = 96
    topologies = jgraph.random_connect(n, d=5, seed=0), tgraph.random_connect(n, d=5, seed=0)
    assert topologies[1].nbr.shape[1] == 18
    builds = bench_builds(n=n, topologies=topologies, config="sybil",
                          topic=dict(mesh_message_deliveries_weight=-1.0,
                                     invalid_message_deliveries_weight=-1.0))
    st = rounds_against_reference(builds, 24, codes=True, schedule=verdict_schedule(24))
    assert float(st.score.imd.max()) > 0 and float(st.scores.min()) < 0


#: multi-slot nets at residue widths: (dials, seed) of random_connect(96),
#: the topic universe and the topics a peer; K = 18, 17 and 16
MULTI_SLOT_NETS = [((5, 0), 4, 2), ((6, 1), 8, 2), ((5, 3), 3, 3)]


class PenaltyLog:
    """An ``observe`` callback: the largest P3 deficit (the mesh-delivery
    shortfall of an activated edge of the mesh the round started from) and
    P7 excess (the behaviour penalty past its threshold) over a run."""

    def __init__(self, threshold3: float, threshold7: float):
        self.t3, self.t7 = threshold3, threshold7
        self.deficit = self.excess = 0.0
        self.mesh = None

    def __call__(self, st):
        sc = st.score
        if self.mesh is not None:
            live = sc.mmd_active & self.mesh & (sc.mmd < self.t3)
            self.deficit = max(self.deficit,
                               float(torch.where(live, self.t3 - sc.mmd, 0.0).max()))
        self.mesh = st.mesh
        self.excess = max(self.excess, float((sc.bp - self.t7).clamp(min=0).max()))


@pytest.mark.parametrize("dials_seed,n_topics,per_peer", MULTI_SLOT_NETS,
                         ids=[f"K{k}" for k in (18, 17, 16)])
def test_multi_slot_step_with_p3_and_p7_live_equals_reference(dials_seed, n_topics, per_peer):
    """Several topic slots at residue widths with P3 and P7 at -1, both
    penalties live: a mesh-delivery threshold (4) the deliveries miss,
    activated after 2 ticks, and a P7 threshold of 0 that the broken
    promises of 20% no-forward peers pass. Every leaf equal after every one
    of 24 rounds, a fifth of the publishes rejected and a fifth ignored;
    P3's deficit and P7's excess nonzero at some round. Before the scalar
    loop's columns took their form with several slots
    (``score/engine.scalar_tail_start``) a last-bit score difference at
    K = 18, column 16, split the run from the reference at round 8."""
    n = 96
    dials, seed = dials_seed
    topologies = (jgraph.random_connect(n, d=dials, seed=seed),
                  tgraph.random_connect(n, d=dials, seed=seed))
    subs = jgraph.subscribe_random(n, n_topics, per_peer, seed=2)
    builds = bench_builds(n=n, topologies=topologies, config="sybil", subscriptions=subs,
                          adversary=np.random.default_rng(0).random(n) < 0.2,
                          topic=dict(mesh_message_deliveries_weight=-1.0,
                                     mesh_message_deliveries_threshold=4.0,
                                     mesh_message_deliveries_activation=2.0,
                                     invalid_message_deliveries_weight=-1.0),
                          peer=dict(behaviour_penalty_weight=-1.0,
                                    behaviour_penalty_threshold=0.0))
    assert builds[4].n_slots == per_peer
    log = PenaltyLog(4.0, 0.0)
    po, pt, pv = verdict_schedule(24)
    my_topics = builds[4].my_topics.numpy()
    pt = my_topics[po.clip(0), 0].astype(np.int32)
    rounds_against_reference(builds, 24, codes=True, schedule=(po, pt, pv), observe=log)
    assert log.deficit > 0 and log.excess > 0, (log.deficit, log.excess)
