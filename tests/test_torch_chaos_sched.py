"""Scheduled partitions (``chaos/scenario.two_group_partition`` fed to a
``ChaosConfig(scheduled=True)`` build as its ``link_deny`` rows) in the
port's GossipSub engines against the JAX package's, every leaf every
round or phase, through the cut and the heal, with P3's delivery deficit
scored (the shape of the JAX package's tests/test_chaos.py:279-306): the
per-round step alone, with dynamic peers and with the mutable overlay
(whose ``mut_writes`` row comes after the deny row), and the phase engine
at r = 8 (a partition lands at phase heads) alone and with dynamic peers.
A fresh JAX state is built for every run: the JAX steps donate their
buffers."""

from __future__ import annotations

import numpy as np
import pytest
from test_torch_churn import up_schedule
from test_torch_dynamics import storms
from test_torch_dynamics import topologies as overlay_topologies
from torch_parity import bench_builds, phases_against_reference, rounds_against_reference

from go_libp2p_pubsub_tpu_torch.chaos import halves, two_group_partition
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.trace.events import EV

N = 48
#: P3's deficit live and active within the run
DEFICIT = dict(mesh_message_deliveries_weight=-0.5, mesh_message_deliveries_threshold=4.0,
               mesh_message_deliveries_activation=2.0, mesh_message_deliveries_window=2.0)


def deny_rows(n, nbr, rounds, start, length):
    """[rounds, N, K] bool: the partition's deny plane, all False off it."""
    sc = two_group_partition(n, start=start, rounds=length)
    rows = [sc.link_deny_at(t, nbr) for t in range(rounds)]
    return np.stack([np.zeros(nbr.shape, bool) if d is None else d for d in rows])


@pytest.mark.parametrize("rows", ["alone", "dynamic_peers", "dynamic_topo"])
def test_per_round_partition_equals_reference(rows):
    """The cut (rounds 4-11) leaves no cross-group delivery of a message
    born inside it until the heal, and LINK_DOWN counts the cross links a
    round; the step's rows are (up, deny, writes) in the JAX order."""
    kw, run_kw = {}, {}
    if rows == "dynamic_topo":
        n, rounds = 32, 16
        kw = dict(topologies=overlay_topologies(0), dynamic=True)
        writes, up = storms(0)[1].build()
        run_kw = dict(up=up, writes=writes, dynamic_topo=True,
                      step_kw=dict(dynamic_peers=True, dynamic_topo=True))
    else:
        n, rounds = N, 16
        if rows == "dynamic_peers":
            run_kw = dict(up=up_schedule(rounds, n), step_kw=dict(dynamic_peers=True))
    builds = bench_builds(n=n, d=3, topic=DEFICIT, chaos=dict(loss_rate=0.1, scheduled=True),
                          **kw)
    tnet = builds[4]
    deny = deny_rows(n, tnet.nbr.numpy(), rounds, 4, 8)
    st = rounds_against_reference(builds, rounds, deny=deny, **run_kw)
    ev = st.core.events
    assert int(ev[EV.LINK_DOWN]) > 0
    if rows == "alone":
        step = make_gossipsub_step(builds[3], tnet, score_params=builds[5])
        assert step.rows == ("link_deny",)
        with pytest.raises(TypeError, match="link_deny"):
            step(st, *(st.core.msgs.origin[:4],) * 2, st.core.msgs.valid[:4])


@pytest.mark.parametrize("rows", ["alone", "dynamic_peers"])
def test_phase_partition_equals_reference(rows):
    """The phase engine at r = 8: one deny row a phase, the head's; the
    partition of rounds 8-23 cuts phases 1 and 2 and heals at phase 3.
    Without a generator LINK_DOWN is exactly the undirected cross links
    times the 16 cut rounds; the cross-group mesh series is observed on
    the port's state after every phase."""
    r, rounds = 8, 40
    run_kw = {}
    if rows == "dynamic_peers":
        run_kw = dict(up=up_schedule(rounds, N, down=(8, 16), second=(24, 32)),
                      dynamic_peers=True)
    builds = bench_builds(n=N, d=3, heartbeat_every=r, topic=DEFICIT,
                          chaos=dict(scheduled=True))
    tnet = builds[4]
    nbr = tnet.nbr.numpy()
    deny = deny_rows(N, nbr, rounds, 8, 16)
    groups = np.asarray(halves(N))
    cross = (groups[:, None] != groups[np.clip(nbr, 0, None)]) & tnet.nbr_ok.numpy()
    seen = []
    st = phases_against_reference(
        builds, r, r, rounds, deny=deny,
        observe=lambda s: seen.append(int((s.mesh.numpy() & cross[:, None, :]).sum())),
        **run_kw)
    if rows == "alone":
        assert int(st.core.events[EV.LINK_DOWN]) == 16 * int(cross.sum()) // 2
        assert len(seen) == rounds // r and seen[0] > 0
    else:
        assert int(st.core.events[EV.LINK_DOWN]) > 0
