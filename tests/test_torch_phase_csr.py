"""The port's phase engine on a CSR net against the JAX package's CSR
phase step, leaf by leaf, after every phase (tests/test_csr.py pins the
JAX package's dense and CSR phase steps equal): the lattice and a ragged
power-law graph, CSR-resident, at r=8 with a heartbeat every phase,
``fused`` on and off. The state stays CSR-resident between phases (flat
``[E, W]`` first-arrival and served planes), and a sub-round's data
crossing is the composite gather, no ``edge_exchange``."""

from __future__ import annotations

import numpy as np
import pytest
from torch_parity import bench_builds, phases_against_reference

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr

ROUNDS = 32


def _topologies(kind, n):
    if kind == "lattice":
        return jgraph.ring_lattice(n, d=4), tgraph.ring_lattice(n, d=4)
    return (jtopo.to_topology(jtopo.powerlaw(n, 2.2, 2, 64, seed=0), max_degree=64),
            ttopo.to_topology(ttopo.powerlaw(n, 2.2, 2, 64, seed=0), max_degree=64))


@pytest.mark.parametrize("kind,n,fused,count_events", [
    pytest.param("lattice", 96, True, True, id="lattice-csr-fused"),
    pytest.param("powerlaw", 256, False, False, id="powerlaw-csr"),
])
def test_csr_phase_equals_reference_every_phase(kind, n, fused, count_events):
    builds = bench_builds(n=n, heartbeat_every=8, count_events=count_events,
                          topologies=_topologies(kind, n), edge_layout="csr", fused=fused)
    tnet = builds[4]
    fr.reset_launch_counts()
    tst = phases_against_reference(builds, 8, 8, ROUNDS)
    e = tnet.n_edges
    assert tst.served_lo.shape[0] == tst.peerhave.shape[0] == tst.core.dlv.fe_words.shape[0] == e
    assert fr.LAUNCHES["edge_exchange"] == 0
    leaves = convert.state_leaves(tst)
    assert leaves[".mesh"].sum(-1).max() >= 1
    born = leaves[".core.msgs.birth"]
    reach = (leaves[".core.dlv.first_round"] >= 0).sum(0)
    # messages spread past their origins (a power-law leaf can be left out
    # of every mesh, so the median, not every message)
    assert np.median(reach[(born >= 8) & (born <= ROUNDS - 8)]) > 1
