"""The eth2 bench config's fanout plane in the port's phase engine, against
the JAX package's, leaf by leaf, after every phase.

The cells of ``tests/test_torch_eth2.py`` (2 random topics a peer, half the
publishes on unjoined topics, 2 fanout slots with a FanoutTTL of 3 ticks)
in phases: r=8 with a heartbeat every phase on the K=16 lattice with 64
topics — where the JAX package recomputes the membership planes every
sub-round and the port carries them incrementally — on a random dense net
with 10 topics and on the lattice CSR-resident, and r=1 on the lattice.
The fanout peers ride the loop packed, one word a slot, and fanout slots
move at every sub-round's publishes. The port runs with ``device="cpu"``;
no tolerance on any leaf."""

from __future__ import annotations

import pytest
from test_torch_eth2 import ROUNDS, check_fanout_run, eth2_builds
from torch_parity import FanoutLog, phases_against_reference


@pytest.mark.parametrize("kind,n_topics,layout,r", [
    pytest.param("lattice", 64, "dense", 8, id="lattice-64-r8"),
    pytest.param("random", 10, "dense", 8, id="random-10-r8"),
    pytest.param("lattice", 64, "csr", 8, id="lattice-64-csr-r8"),
    pytest.param("lattice", 64, "dense", 1, id="lattice-64-r1"),
])
def test_eth2_phase_equals_reference_every_phase(kind, n_topics, layout, r):
    builds = eth2_builds(kind, n_topics, heartbeat_every=r, edge_layout=layout,
                         fused=layout == "csr")
    log = FanoutLog()
    rounds = 32 if r > 1 else ROUNDS
    # the CSR-resident case replays the dense case's JAX run (densified)
    tst = phases_against_reference(builds, r, r, rounds, fanout_topics=True, observe=log,
                                   share=("eth2 phase", kind, n_topics, r))
    check_fanout_run(builds, log, rounds)
    assert int(tst.fanout_peers.sum()) > 0
