"""The lifted score sum's float forms (split from
tests/test_torch_lift.py, so that each file stays within a loadfile
worker's share of the suite): ``compute_scores_lifted`` equals the JAX
package's lifted ``compute_scores`` bit for bit on random counters at
residue widths K = 3, 4, 9, 16, 18, 21 and 41, under the sybil parameters,
the moved plane, every term on two slots, P6 with and without the cap and
the subnormal cells; with P5 live off its banded gather's wrap rows and
within ``WRAP_ULPS`` on them; and the one-slot scalar columns with P5 live
at K = 3, 4, 9 and N = 64, 96, 256."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_score_fma import (
    _ALL,
    _ZERO_TOPIC,
    FMA_CELLS,
    P5_CELLS,
    SYBIL_CELL,
    WRAP_ULPS,
    _rings,
)
from torch_parity import SECOND_PLANE, SUBNORMAL_CELLS, reference_leaves

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.config import PeerScoreParams as JPSP
from go_libp2p_pubsub_tpu.config import TopicScoreParams as JTSP
from go_libp2p_pubsub_tpu.score import engine as je
from go_libp2p_pubsub_tpu.score import params as jparams
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.config import PeerScoreParams as TPSP
from go_libp2p_pubsub_tpu_torch.config import TopicScoreParams as TTSP
from go_libp2p_pubsub_tpu_torch.ops.fnum import flush_subnormals
from go_libp2p_pubsub_tpu_torch.score import engine as te
from go_libp2p_pubsub_tpu_torch.state import Net as TNet


def _lifted_scores(cell, seed, n=64, d=4, plane_kw=None):
    """(port, JAX) lifted ``compute_scores`` on random counters, the JAX
    one jitted with the plane as a traced argument."""
    topic_kw, peer_kw, n_topics, per_topic = cell
    kws = [dict(topic_kw, **per_topic.get(t, {})) for t in range(n_topics)]
    jsp = JPSP(topics={t: JTSP(**kw) for t, kw in enumerate(kws)}, **peer_kw)
    tsp = TPSP(topics={t: TTSP(**kw) for t, kw in enumerate(kws)}, **peer_kw)
    jsub = jgraph.subscribe_all(n, n_topics)
    jtopo, ttopo = _rings(n, d)
    jnet = JNet.build(jtopo, jsub)
    tnet = TNet.build(ttopo, tgraph.Subscriptions(*(np.asarray(getattr(jsub, f)) for f in (
        "subscribed", "my_topics", "slot_of"))), device="cpu")
    s, k = jnet.my_topics.shape[1], int(2 * d)
    rng = np.random.default_rng(seed)
    f = lambda *shape: (rng.random(shape) * 3).astype(np.float32)
    planes = dict(fmd=f(n, s, k), mmd=f(n, s, k), mfp=f(n, s, k), imd=f(n, s, k), bp=f(n, k))
    ints = dict(mesh_time=rng.integers(0, 50, (n, s, k)).astype(np.int32),
                mmd_active=rng.random((n, s, k)) < 0.7)
    in_mesh = rng.random((n, s, k)) < 0.5
    p6, app = f(n, k), f(n)
    jst = je.ScoreState.empty(n, s, k).replace(
        **{x: jnp.asarray(v) for x, v in {**planes, **ints}.items()})
    jplane = jparams.ScoreParams.build(jsp, None, n_topics)
    fn = jax.jit(lambda st, m, p, a, pl: je.compute_scores(
        st, m, pl.gather(jnet.my_topics), pl, p, a, jnet))
    want = np.asarray(fn(jst, jnp.asarray(in_mesh), jnp.asarray(p6), jnp.asarray(app), jplane))
    tst = dataclasses.replace(te.ScoreState.empty(n, s, k, "cpu"), **{
        x: torch.from_numpy(v) for x, v in {**planes, **ints}.items()})
    tplane = convert.score_plane_from_reference(
        reference_leaves(jplane), device="cpu",
        app_specific_weight=jplane.app_specific_weight).flushed()
    got = te.compute_scores_lifted(tst, torch.from_numpy(in_mesh),
                                   tplane.gather(tnet.my_topics), tplane,
                                   flush_subnormals(torch.from_numpy(p6)),
                                   torch.from_numpy(app), tnet).numpy()
    return got, want


_PEER = FMA_CELLS["p2"][1]
#: cells of the lifted float map: the sybil terms, the moved plane's, every
#: term on two slots, P6 with and without the topic-score cap on one slot,
#: and the subnormal weights
LIFT_CELLS = {
    "sybil": SYBIL_CELL,
    "moved": (dict(_ZERO_TOPIC, **SECOND_PLANE["topic"]),
              dict(_PEER, **SECOND_PLANE["peer"]), 1, {}),
    "every_term": FMA_CELLS["every_term"],
    "p3b": FMA_CELLS["p3b"],
    "p6_one_topic": FMA_CELLS["p6_one_topic"],
    "p6_capped": FMA_CELLS["p6_capped"],
    "subnormal_negative": (dict(_ZERO_TOPIC, **SUBNORMAL_CELLS["negative"]["topic"]),
                           dict(_PEER, **SUBNORMAL_CELLS["negative"]["peer"]), 1, {}),
    "subnormal_caps": (dict(_ZERO_TOPIC, mesh_message_deliveries_weight=-1.0,
                            first_message_deliveries_cap=1e-40),
                       dict(_PEER, topic_score_cap=1e-40), 1, {}),
}


@pytest.mark.parametrize("k", [3, 4, 9, 16, 18, 21, 41])
@pytest.mark.parametrize("name", sorted(LIFT_CELLS))
def test_lifted_score_sum_equals_reference(name, k):
    """Bit for bit on every column: the fused forms of the vector chunks
    and the one-slot scalar columns (``lifted_scalar_columns``: columns 0-1
    of a row of 3, a row of 4, column 8 of a row of 9)."""
    d = k / 2 if k % 2 else k // 2
    for seed in (0, 1):
        got, want = _lifted_scores(LIFT_CELLS[name], seed, d=d)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", sorted(P5_CELLS))
def test_lifted_score_sum_with_app_scores(name):
    """With P5 live (a host weight under lift too) the lifted sum is
    bit-exact off the rows XLA:CPU splits off around the banded gather's
    wrap (the first and last 2d rows of the ring) and within ``WRAP_ULPS``
    of the largest term on them, as the static sum is (ROADMAP §3)."""
    n, d = 64, 4
    cell = P5_CELLS[name]
    bound = 3 * (abs(cell[1]["app_specific_weight"]) + abs(cell[1]["ip_colocation_factor_weight"])
                 + 4 * abs(cell[1]["behaviour_penalty_weight"]) + 100 * cell[2])
    for seed in (0, 1):
        got, want = _lifted_scores(cell, seed, n=n, d=d)
        inner = slice(2 * d, n - 2 * d)
        np.testing.assert_array_equal(got[inner].view(np.uint32), want[inner].view(np.uint32))
        tol = WRAP_ULPS * float(np.spacing(np.float32(bound)))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


#: the lifted scalar columns with P5 live: every topic term on one slot,
#: the topic-score cap off and on
_P5_PEER = dict(P5_CELLS["p5_one_topic"][1], behaviour_penalty_weight=-0.8)
P5_LIFT_CELLS = {
    "uncapped": (_ALL, _P5_PEER, 1, {}),
    "capped": (_ALL, dict(_P5_PEER, topic_score_cap=5.0), 1, {}),
}


@pytest.mark.parametrize("n", [64, 96, 256])
@pytest.mark.parametrize("k", [3, 4, 9])
@pytest.mark.parametrize("name", sorted(P5_LIFT_CELLS))
def test_lifted_scalar_columns_with_app_scores(name, k, n):
    """The one-slot scalar columns with P5 live (``lifted_scalar_columns``
    with ``app_on``: columns 0-1 of a row of 3 take P5's product fused and
    P6's rounded apart; rows of 4 and 9 keep no scalar column): bit for
    bit off the banded gather's wrap rows (the first and last 2d rows of
    the ring) and within ``WRAP_ULPS`` of the largest term on them, as
    ``test_lifted_score_sum_with_app_scores``."""
    d = k / 2 if k % 2 else k // 2
    wrap = int(2 * d)
    cell = P5_LIFT_CELLS[name]
    bound = 3 * (abs(cell[1]["app_specific_weight"]) + abs(cell[1]["ip_colocation_factor_weight"])
                 + 4 * abs(cell[1]["behaviour_penalty_weight"]) + 100 * cell[2])
    for seed in (0, 1):
        got, want = _lifted_scores(cell, seed, n=n, d=d)
        inner = slice(wrap, n - wrap)
        np.testing.assert_array_equal(got[inner].view(np.uint32), want[inner].view(np.uint32))
        tol = WRAP_ULPS * float(np.spacing(np.float32(bound)))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
