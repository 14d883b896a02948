"""The sybil bench config's planes in the port's per-round GossipSub step —
the peer gater, the validation throttle and the no-forward adversary
vector — against the JAX package's, leaf by leaf, every round.

Every cell marks a fifth of the peers as sybils that never transmit data
(``adversary_no_forward``), runs the gater with its default parameters
and a validation capacity of 2 or 3 receipts a peer a round (small enough
to throttle, so the gater's circuit breaker closes and its random-early
drop clears ``acc_msg`` bits), scores with the sybil config's delivery
deficit, and groups consecutive peers into shared ip groups, so the
gater's per-source share sums several counters. Publishes come from any
peer with verdict codes: a fifth rejected and a fifth ignored, so the
gater's reject and ignore counters move. Cells: the K=16 lattice (banded:
the ``F_SENDER_FWD`` flag bit off on edges from sybils), a random dense net
(the composites), the lattice CSR-resident, and the lattice with a
subnormal ``decay_to_zero`` and decays whose products turn subnormal. The
port runs with ``device="cpu"``; no tolerance on any leaf."""

from __future__ import annotations

import numpy as np
import pytest
from torch_parity import bench_builds, phase_schedule, rounds_against_reference

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu_torch import graph as tgraph

N = 96
ROUNDS = 24
SUBNORMAL_GATER = dict(decay_to_zero=1e-40, global_decay=1e-10, source_decay=1e-12)


def sybil_builds(kind: str, cap: int, group: int, gater=None, **kw):
    """bench_builds for a sybil cell."""
    if kind == "random":
        topologies = jgraph.random_connect(N, d=6, seed=1), tgraph.random_connect(N, d=6, seed=1)
    else:
        topologies = jgraph.ring_lattice(N, d=8), tgraph.ring_lattice(N, d=8)
    adversary = np.random.default_rng(0).random(N) < 0.2
    return bench_builds(n=N, topologies=topologies, config="sybil", gater=gater or {},
                        validation_capacity=cap, adversary=adversary,
                        ip_group=(np.arange(N) // group).astype(np.int32), **kw)


def verdict_schedule(rounds: int):
    """``phase_schedule`` with verdict codes, a fifth of the publishes
    rejected and a fifth ignored."""
    po, pt, pv = phase_schedule(N, rounds, codes=True)
    u = np.random.default_rng(1).random(pv.shape)
    pv = np.where(u < 0.2, 1, np.where(u < 0.4, 2, pv)).astype(np.int32)
    return po, pt, pv


class GaterLog:
    """An ``observe`` callback: the largest throttle, reject and ignore
    totals seen, and the peers whose circuit breaker was closed (the
    random-early drop live) at some round."""

    def __init__(self, quiet: int = 60, threshold: float = 0.33):
        self.quiet, self.threshold = quiet, threshold
        self.throttle = self.reject = self.ignore = 0.0
        self.breaker_closed = 0

    def __call__(self, st):
        g = st.gater
        self.throttle = max(self.throttle, float(g.throttle.sum()))
        self.reject = max(self.reject, float(g.reject.sum()))
        self.ignore = max(self.ignore, float(g.ignore.sum()))
        tick = int(st.core.tick)
        ratio = g.throttle / g.validate.clamp(min=1e-9)
        closed = (((tick - g.last_throttle) <= self.quiet) & (g.throttle != 0)
                  & ((g.validate == 0) | (ratio >= self.threshold)))
        self.breaker_closed = max(self.breaker_closed, int(closed.sum()))

    def check(self):
        assert self.throttle > 0 and self.reject > 0 and self.ignore > 0, vars(self)
        assert self.breaker_closed > 0, vars(self)


@pytest.mark.parametrize("kind,layout,cap,group,gater", [
    pytest.param("lattice", "dense", 2, 3, None, id="lattice"),
    pytest.param("random", "dense", 3, 4, None, id="random"),
    pytest.param("lattice", "csr", 2, 3, None, id="lattice-csr"),
    pytest.param("lattice", "dense", 2, 5, SUBNORMAL_GATER, id="lattice-subnormal-decay"),
])
def test_sybil_step_equals_reference_every_round(kind, layout, cap, group, gater):
    builds = sybil_builds(kind, cap, group, gater, edge_layout=layout, fused=layout == "csr")
    log = GaterLog()
    tst = rounds_against_reference(builds, ROUNDS, schedule=verdict_schedule(ROUNDS),
                                   observe=log)
    log.check()
    # sybils carry no data: no receipt's first arrival came from one
    adv = builds.tkw["adversary_no_forward"]
    nbr = builds[4].nbr.numpy()
    fe = tst.core.dlv.fe_words
    if fe.dim() == 3:
        from_sybil = adv[np.clip(nbr, 0, None)] & builds[4].nbr_ok.numpy()
        assert not bool((fe.numpy()[from_sybil] != 0).any())
