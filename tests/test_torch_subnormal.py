"""The port's per-round GossipSub step against the JAX package's under
score parameters that make float32 subnormals, leaf by leaf, every round.

The JAX package's platforms (XLA on the CPU, a TPU) flush every subnormal
float32 result to a zero of its sign and read every subnormal operand as
zero, so a score term of 1e-40 is 0.0 there and -1e-42 is -0.0, which no
``< 0`` gate counts as negative. The port flushes the same results itself
(``ops/fnum.py``). Each cell runs both steps from the same state on the
banded lattice (the fused data plane) and on a dense non-banded graph (the
composites), and every leaf must be equal bit for bit after every round,
under each of tests/torch_parity.SUBNORMAL_CELLS:

* ``positive`` — P1 and P2 weights of 1e-40;
* ``negative`` — P3, P3b, P4, P6 and P7 weights of -1e-42 (P6 over ip
  groups of three peers), P1 and P2 off;
* ``decay`` — a decay_to_zero of 1e-40 and counter decays of 1e-20, so a
  counter reaches the subnormal range at its second decay;
* ``caps`` — a topic score cap and P2 and P3 counter caps of 1e-40, which
  clamp at zero (XLA's minimum reads the subnormal cap as +0.0);
* ``zero_thresholds`` — the negative weights with the gossip, publish,
  graylist and opportunistic-graft thresholds at 0.0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    SUBNORMAL_CELLS,
    bench_builds,
    diff_leaves,
    jinit,
    reference_leaves,
    subnormal_overrides,
)

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake

ROUNDS = 24
N = 96

NETS = {
    "lattice": None,
    "random": lambda: (jgraph.random_connect(N, d=4, seed=1),
                       tgraph.random_connect(N, d=4, seed=1)),
}


def _schedule():
    rng = np.random.default_rng(2)
    po = rng.integers(0, N, size=(ROUNDS, 4)).astype(np.int32)
    pt = np.zeros((ROUNDS, 4), np.int32)
    pv = rng.random((ROUNDS, 4)) < 0.8    # invalid publishes charge P4
    return po, pt, pv


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("cell", sorted(SUBNORMAL_CELLS))
def test_step_flushes_subnormals_as_the_reference(cell, net):
    topologies = NETS[net]() if NETS[net] else None
    jcfg, jnet, jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4, topologies=topologies,
                                                    **subnormal_overrides(cell, N))
    assert (tnet.band_off is not None) == (net == "lattice")
    jst = jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=0)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    jstep = jmake(jcfg, jnet, score_params=jsp)
    tstep = tmake(tcfg, tnet, score_params=tsp)
    po, pt, pv = _schedule()
    for r in range(ROUNDS):
        jst = jstep(jst, jnp.asarray(po[r]), jnp.asarray(pt[r]), jnp.asarray(pv[r]))
        tst = tstep(tst, torch.from_numpy(po[r]), torch.from_numpy(pt[r]),
                    torch.from_numpy(pv[r]))
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"{cell} round {r}")
    # and the port's score plane holds no subnormal
    scores = convert.state_leaves(tst)[".scores"]
    assert not np.any((scores != 0) & (np.abs(scores) < np.finfo(np.float32).tiny))


def test_compute_scores_sums_topic_slots_as_the_reference():
    """Three topic slots whose terms cancel into the subnormal range part
    way through the sum over slots: XLA flushes each partial sum in slot
    order, so 2e-38 - 1.5e-38 + 2e-38 is 2e-38 there, not 2.5e-38, and the
    port's scores must be the same bits."""
    from go_libp2p_pubsub_tpu import config as jconfig
    from go_libp2p_pubsub_tpu.score import engine as jeng
    from go_libp2p_pubsub_tpu.state import Net as JNet
    from go_libp2p_pubsub_tpu_torch import config as tconfig
    from go_libp2p_pubsub_tpu_torch.score import engine as teng
    from go_libp2p_pubsub_tpu_torch.state import Net as TNet

    n, s = 32, 3
    jnet = JNet.build(jgraph.ring_lattice(n, d=2), jgraph.subscribe_all(n, s))
    tnet = TNet.build(tgraph.ring_lattice(n, d=2), tgraph.subscribe_all(n, s), device="cpu")
    k = tnet.max_degree
    topic = dict(topic_weight=1.0, time_in_mesh_weight=0.0,
                 first_message_deliveries_weight=1.0, mesh_message_deliveries_weight=0.0,
                 mesh_failure_penalty_weight=-1.0, invalid_message_deliveries_weight=0.0)
    sps = [cfg.PeerScoreParams(topics={t: cfg.TopicScoreParams(**topic) for t in range(s)},
                               skip_app_specific=True) for cfg in (jconfig, tconfig)]
    rng = np.random.default_rng(3)
    planes = {
        "fmd": rng.choice(np.array([0.0, 2e-38, 1.5e-38, 3.0], np.float32), size=(n, s, k)),
        "mfp": rng.choice(np.array([0.0, 1.5e-38, 2e-38], np.float32), size=(n, s, k)),
        "mmd": np.zeros((n, s, k), np.float32), "imd": np.zeros((n, s, k), np.float32),
        "graft_tick": np.full((n, s, k), -1, np.int32),
        "mesh_time": np.zeros((n, s, k), np.int32),
        "mmd_active": np.zeros((n, s, k), bool), "bp": np.zeros((n, k), np.float32),
    }
    in_mesh = rng.random((n, s, k)) < 0.5
    z = lambda *shape: np.zeros(shape, np.float32)
    ref = jeng.compute_scores(
        jeng.ScoreState(**{f: jnp.asarray(v) for f, v in planes.items()}), jnp.asarray(in_mesh),
        jeng.TopicParamsArrays.build(sps[0], s).gather(jnet.my_topics), sps[0],
        jnp.asarray(z(n, k)), jnp.asarray(z(n)), jnet)
    got = teng.compute_scores(
        teng.ScoreState(**{f: torch.from_numpy(v) for f, v in planes.items()}),
        torch.from_numpy(in_mesh), teng.TopicParamsArrays.build(sps[1], s).gather(tnet.my_topics),
        teng.ScoreScalars.build(sps[1]), torch.from_numpy(z(n, k)), torch.from_numpy(z(n)), tnet)
    np.testing.assert_array_equal(np.asarray(ref).view(np.uint32), got.numpy().view(np.uint32))
