"""The eth2 bench config's fanout plane in the port's per-round GossipSub
step, against the JAX package's, leaf by leaf, every round.

Each cell subscribes every peer to 2 random topics (``subscribe_random``)
and publishes half of each round's messages on a topic of the origin's own
and half on a uniform topic of the universe, mostly one the origin has not
joined: those open and refresh fanout slots (2 a peer), which push the
messages to D subscribed neighbours, are gossiped to others at the
heartbeat, and expire after a FanoutTTL of 3 ticks, so slots expire and
fill again within the run. Cells: the K=16 lattice with the eth2 config's
64 topics (banded: the fanout words ride ``fused_delivery``'s carry), a
random dense net with 10 topics (the composites), and the lattice with 64
topics CSR-resident. The port runs with ``device="cpu"``; no tolerance on
any leaf."""

from __future__ import annotations

import pytest
from torch_parity import FanoutLog, bench_builds, phase_schedule, rounds_against_reference

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu_torch import graph as tgraph

N = 96
ROUNDS = 24
TTL = 3.0


def eth2_builds(kind: str, n_topics: int, **kw):
    """bench_builds for an eth2 cell: the eth2 score parameters, 2 fanout
    slots with a FanoutTTL of ``TTL`` seconds, 2 topics a peer."""
    if kind == "random":
        topologies = jgraph.random_connect(N, d=6, seed=1), tgraph.random_connect(N, d=6, seed=1)
    else:
        topologies = jgraph.ring_lattice(N, d=8), tgraph.ring_lattice(N, d=8)
    subs = jgraph.subscribe_random(N, n_topics, 2, seed=2)
    return bench_builds(n=N, topologies=topologies, subscriptions=subs, config="eth2",
                        fanout_slots=2, fanout_ttl=TTL, **kw)


def check_fanout_run(builds, log, rounds):
    """The schedule published to joined and unjoined topics, and fanout
    slots opened, expired and filled again."""
    tnet = builds[4]
    my_topics = tnet.my_topics.numpy()
    po, pt, _pv = phase_schedule(N, rounds, my_topics=my_topics, n_topics=tnet.n_topics)
    live = po >= 0
    joined = tnet.subscribed.numpy()[po[live], pt[live]]
    assert joined.any() and (~joined).any()
    assert log.fresh > 0 and log.expired > 0, vars(log)


@pytest.mark.parametrize("kind,n_topics,layout", [
    pytest.param("lattice", 64, "dense", id="lattice-64"),
    pytest.param("random", 10, "dense", id="random-10"),
    pytest.param("lattice", 64, "csr", id="lattice-64-csr"),
])
def test_eth2_step_equals_reference_every_round(kind, n_topics, layout):
    builds = eth2_builds(kind, n_topics, edge_layout=layout, fused=layout == "csr")
    assert (builds[4].band_off is not None) == (kind == "lattice" and layout == "dense")
    log = FanoutLog()
    # the CSR-resident case replays the dense case's JAX run (densified)
    tst = rounds_against_reference(builds, ROUNDS, fanout_topics=True, observe=log,
                                   share=("eth2 rounds", kind, n_topics))
    check_fanout_run(builds, log, ROUNDS)
    assert int(tst.fanout_peers.sum()) > 0
    reach = (tst.core.dlv.first_round >= 0).sum(0)
    assert int(reach.max()) > 2
