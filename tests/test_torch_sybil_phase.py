"""The sybil bench config's planes in the port's phase engine against the
JAX package's, leaf by leaf, after every phase: the cells of
``tests/test_torch_sybil.py`` (a fifth of the peers no-forward sybils, the
gater with shared ip groups, a throttling validation capacity, rejected
and ignored publishes) in phases of r=8 with a heartbeat every phase on
the K=16 lattice, a random dense net and the lattice CSR-resident, and of
r=1 on the lattice. The gater draws once a phase, at the head; the
throttle runs every sub-round; the gater's outcome planes fold over the
phase and land at the tail. The port runs with ``device="cpu"``; no
tolerance on any leaf."""

from __future__ import annotations

import pytest
from test_torch_sybil import GaterLog, sybil_builds, verdict_schedule
from torch_parity import phases_against_reference


@pytest.mark.parametrize("kind,layout,cap,group,r", [
    pytest.param("lattice", "dense", 2, 3, 8, id="lattice-r8"),
    pytest.param("random", "dense", 3, 4, 8, id="random-r8"),
    pytest.param("lattice", "csr", 2, 3, 8, id="lattice-csr-r8"),
    pytest.param("lattice", "dense", 2, 3, 1, id="lattice-r1"),
])
def test_sybil_phase_equals_reference_every_phase(kind, layout, cap, group, r):
    builds = sybil_builds(kind, cap, group, heartbeat_every=r, edge_layout=layout,
                          fused=layout == "csr")
    rounds = 32 if r > 1 else 24
    log = GaterLog()
    # the CSR-resident case replays the dense case's JAX run (densified)
    phases_against_reference(builds, r, r, rounds, schedule=verdict_schedule(rounds),
                             observe=log, share=("sybil phase", kind, cap, group, r))
    log.check()
