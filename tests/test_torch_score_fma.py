"""The score sum's fused multiply-add, held against the JAX package.

XLA:CPU compiles ``compute_scores`` into one fused loop and contracts a
multiply into the add that consumes it (one rounding where the written
order has two). Under the bench's score parameters the product that
rounds is P7's: ``score + where(excess > 0, excess**2, 0) * w`` with
``w = behaviour_penalty_weight``; at ``w = -1`` the compiler folds the
weight into the square first, so the square itself is fused. The port
computes those sites with ``ops/fnum.fma_f32``. Here the port's
``compute_scores`` must equal the JAX package's, jitted, bit for bit on
random counters with behaviour penalties past their threshold, and
``fma_f32`` must round once, also where a float64 sum would land on a
float32 midpoint.

The same loop fuses every other weighted product into its add: P2, P3
(the rounded square times the weight; at a weight of -1 the square
itself), P3b, P4, each topic slot's weighted term into the slot sum, P5
and P6. Those cells run at N=64, K=8, where XLA's vector loop covers every
element and the scores are bit-exact. With P5 live, XLA splits the rows
around the wrap of the banded gather of the application scores off into
scalar loops, which round the select-guarded squares (P3, P7) that the
vector loop fuses: there the scores are bit-exact on the interior rows
and within ``WRAP_ULPS`` of the reference on the wrap rows. The per-round
steps at residue widths are tests/test_torch_score_fma_steps.py (split so
that each file stays within a loadfile worker's share of the suite)."""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.config import PeerScoreParams as JPSP
from go_libp2p_pubsub_tpu.config import TopicScoreParams as JTSP
from go_libp2p_pubsub_tpu.score import engine as je
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.config import PeerScoreParams as TPSP
from go_libp2p_pubsub_tpu_torch.config import TopicScoreParams as TTSP
from go_libp2p_pubsub_tpu_torch.ops.fnum import flush_subnormals, fma_f32
from go_libp2p_pubsub_tpu_torch.score import engine as te
from go_libp2p_pubsub_tpu_torch.state import Net as TNet


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the exact ``x``, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.uint32)) & 1))
    return np.float32(best)


def test_fma_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.normal(size=400).astype(np.float32)
    b = rng.normal(size=400).astype(np.float32)
    c = (rng.normal(size=400) * 4).astype(np.float32)
    # a float64 sum that lands on a float32 midpoint: the exact value lies
    # 2^-24 below it, so the right answer is c itself, not the even side
    a[0], b[0], c[0] = 8 * (1 + 2.0**-15), 8 * (1 - 2.0**-15), 2.0**30 + 2.0**7
    a[1], b[1], c[1] = -a[0], b[0], -c[0]
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] == np.float32(2.0**30 + 2.0**7)


@pytest.mark.parametrize("w", [-0.3, -0.7, 0.0, 2.5])
def test_fma_float_weight_equals_tensor_weight(w):
    """A Python float ``b`` is read as its float32 value, as a float32
    tensor of it would be: the same bits, with no tensor made for it."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy((rng.normal(size=300) * 3).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=300) * 5).astype(np.float32))
    want = fma_f32(a, torch.tensor(w, dtype=torch.float32), c)
    got = fma_f32(a, w, c)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("n_topics", [1, 2])
@pytest.mark.parametrize("w7", [-1.0, -0.7, -2.0, 0.0])
def test_compute_scores_equals_reference_past_the_penalty_threshold(n_topics, w7):
    n, k = 64, 8
    topic = dict(mesh_message_deliveries_weight=0.0, mesh_failure_penalty_weight=0.0,
                 invalid_message_deliveries_weight=0.0)
    peer = dict(skip_app_specific=True, behaviour_penalty_weight=w7,
                behaviour_penalty_threshold=1.0, behaviour_penalty_decay=0.9)
    jsp = JPSP(topics={t: JTSP(**topic) for t in range(n_topics)}, **peer)
    tsp = TPSP(topics={t: TTSP(**topic) for t in range(n_topics)}, **peer)
    jsub = jgraph.subscribe_all(n, n_topics)
    jnet = JNet.build(jgraph.ring_lattice(n, d=4), jsub)
    tnet = TNet.build(tgraph.ring_lattice(n, d=4),
                      tgraph.Subscriptions(*(np.asarray(getattr(jsub, f)) for f in (
                          "subscribed", "my_topics", "slot_of"))), device="cpu")
    s = jnet.my_topics.shape[1]
    rng = np.random.default_rng(n_topics * 10 + int(-w7 * 10))
    f = lambda *shape: (rng.random(shape) * 3).astype(np.float32)
    planes = dict(fmd=f(n, s, k), mmd=f(n, s, k), mfp=f(n, s, k), imd=f(n, s, k), bp=f(n, k))
    ints = dict(mesh_time=rng.integers(0, 50, (n, s, k)).astype(np.int32),
                mmd_active=rng.random((n, s, k)) < 0.7)
    in_mesh = rng.random((n, s, k)) < 0.5
    p6, app = f(n, k), f(n)

    jst = je.ScoreState.empty(n, s, k).replace(
        **{x: jnp.asarray(v) for x, v in {**planes, **ints}.items()})
    jtp = je.TopicParamsArrays.build(jsp, n_topics).gather(jnet.my_topics)
    want = np.asarray(jax.jit(lambda st, m, p, a: je.compute_scores(st, m, jtp, jsp, p, a, jnet))(
        jst, jnp.asarray(in_mesh), jnp.asarray(p6), jnp.asarray(app)))

    tst = dataclasses.replace(
        te.ScoreState.empty(n, s, k, "cpu"),
        **{x: torch.from_numpy(v) for x, v in {**planes, **ints}.items()})
    ttp = te.TopicParamsArrays.build(tsp, n_topics).gather(tnet.my_topics)
    got = te.compute_scores(tst, torch.from_numpy(in_mesh), ttp, te.ScoreScalars.build(tsp),
                            flush_subnormals(torch.from_numpy(p6)), torch.from_numpy(app),
                            tnet).numpy()
    assert (planes["bp"] > 1.0).mean() > 0.5
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


#: the one tolerance of this file, on ``.scores`` in the wrap rows of a
#: cell with P5 live (XLA's scalar loops there round what its vector loop
#: fuses): float32 ulps at the largest magnitude among the score's terms
#: (a rounding difference inside the sum can cancel into many ulps of a
#: small result, never into more than an ulp of its largest term)
WRAP_ULPS = 1

_ZERO_TOPIC = dict(mesh_message_deliveries_weight=0.0, mesh_failure_penalty_weight=0.0,
                   invalid_message_deliveries_weight=0.0,
                   mesh_message_deliveries_threshold=20.0)
_PEER = dict(skip_app_specific=True, behaviour_penalty_weight=-1.0,
             behaviour_penalty_threshold=1.0, behaviour_penalty_decay=0.9)
_ALL = dict(_ZERO_TOPIC, first_message_deliveries_weight=0.7,
            mesh_message_deliveries_weight=-0.6, mesh_failure_penalty_weight=-0.3,
            invalid_message_deliveries_weight=-0.9, topic_weight=0.3)

#: name -> (topic params, peer params, topics, per-topic overrides)
FMA_CELLS = {
    "p2": (dict(_ZERO_TOPIC, first_message_deliveries_weight=0.7), _PEER, 1, {}),
    "p3": (dict(_ZERO_TOPIC, mesh_message_deliveries_weight=-0.7), _PEER, 1, {}),
    "p3_at_minus_one": (dict(_ZERO_TOPIC, mesh_message_deliveries_weight=-1.0), _PEER, 1, {}),
    "p3_mixed_weights": (dict(_ZERO_TOPIC, mesh_message_deliveries_weight=-1.0, topic_weight=0.3),
                         _PEER, 2, {1: dict(mesh_message_deliveries_weight=-0.7)}),
    "p3b": (dict(_ZERO_TOPIC, mesh_failure_penalty_weight=-0.7), _PEER, 1, {}),
    "p4": (dict(_ZERO_TOPIC, invalid_message_deliveries_weight=-0.7), _PEER, 1, {}),
    "p4_at_minus_one_three_topics": (
        dict(_ZERO_TOPIC, invalid_message_deliveries_weight=-1.0, topic_weight=0.3), _PEER, 3, {}),
    "p6_one_topic": (dict(_ZERO_TOPIC, topic_weight=0.3),
                     dict(_PEER, ip_colocation_factor_weight=-0.7, behaviour_penalty_weight=-0.7),
                     1, {}),
    "p6_capped": (dict(_ZERO_TOPIC, topic_weight=0.3),
                  dict(_PEER, ip_colocation_factor_weight=-0.7, topic_score_cap=5.0), 1, {}),
    "two_topics": (dict(_ZERO_TOPIC, topic_weight=0.3), _PEER, 2, {}),
    "three_topics": (dict(_ZERO_TOPIC, topic_weight=0.3), _PEER, 3, {}),
    "two_topics_mixed_weights": (
        dict(_ZERO_TOPIC, topic_weight=0.3, first_message_deliveries_weight=0.7), _PEER, 2,
        {1: dict(topic_weight=0.45, first_message_deliveries_weight=0.2)}),
    "every_term": (_ALL, dict(_PEER, ip_colocation_factor_weight=-0.4,
                              behaviour_penalty_weight=-0.8), 2, {}),
}

#: cells with P5 live: bit-exact off the wrap rows, WRAP_ULPS on them
P5_CELLS = {
    "p5_one_topic": (dict(_ZERO_TOPIC, topic_weight=0.3),
                     dict(_PEER, skip_app_specific=False, app_specific_weight=0.7,
                          ip_colocation_factor_weight=-0.4), 1, {}),
    "p5_two_topics": (dict(_ZERO_TOPIC, topic_weight=0.3),
                      dict(_PEER, skip_app_specific=False, app_specific_weight=0.7,
                           ip_colocation_factor_weight=-0.4), 2, {}),
}


def _rings(n, d):
    """(JAX, port) topologies of the ring of half-width ``d`` (K = 2d
    neighbours, every slot live): the lattice for a whole ``d``; for a
    half-integer the lattice of ``d - 1/2`` plus each peer's antipode (N
    even), so odd widths are regular too."""
    if d == int(d):
        return jgraph.ring_lattice(n, d=int(d)), tgraph.ring_lattice(n, d=int(d))
    half = int(d)
    pairs = sorted({tuple(sorted((i, (i + o) % n))) for i in range(n)
                    for o in [*range(1, half + 1), n // 2]})
    k = int(2 * d)
    return jgraph.from_edges(n, pairs, max_degree=k), tgraph.from_edges(n, pairs, max_degree=k)


def _scores(cell, seed, n=64, d=4):
    """(port scores, jitted reference scores, a float64 bound on the
    magnitude of the score's largest term) on random counters."""
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
    jtp = je.TopicParamsArrays.build(jsp, n_topics).gather(jnet.my_topics)
    want = np.asarray(jax.jit(lambda st, m, p, a: je.compute_scores(st, m, jtp, jsp, p, a, jnet))(
        jst, jnp.asarray(in_mesh), jnp.asarray(p6), jnp.asarray(app)))
    tst = dataclasses.replace(
        te.ScoreState.empty(n, s, k, "cpu"),
        **{x: torch.from_numpy(v) for x, v in {**planes, **ints}.items()})
    ttp = te.TopicParamsArrays.build(tsp, n_topics).gather(tnet.my_topics)
    got = te.compute_scores(tst, torch.from_numpy(in_mesh), ttp, te.ScoreScalars.build(tsp),
                            flush_subnormals(torch.from_numpy(p6)), torch.from_numpy(app),
                            tnet).numpy()
    # every term at its largest: 3 bounds each counter, 50 the mesh time
    w = lambda name: max(abs(getattr(TTSP(**kw), name)) for kw in kws)
    topic = (50 * w("time_in_mesh_weight") + 3 * w("first_message_deliveries_weight")
             + 400 * w("mesh_message_deliveries_weight")
             + 3 * w("mesh_failure_penalty_weight") + 9 * w("invalid_message_deliveries_weight"))
    bound = (n_topics * topic * w("topic_weight")
             + 3 * (abs(tsp.app_specific_weight) + abs(tsp.ip_colocation_factor_weight))
             + 4 * abs(tsp.behaviour_penalty_weight))
    return got, want, bound


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(FMA_CELLS))
def test_compute_scores_fuses_every_weighted_term_as_the_reference(name, seed):
    got, want, _ = _scores(FMA_CELLS[name], seed)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", sorted(P5_CELLS))
def test_compute_scores_with_app_scores_as_the_reference(name):
    """Bit-exact off the rows XLA splits off around the gather's wrap (the
    first and last 2d rows of the ring), ``WRAP_ULPS`` on them."""
    n, d = 64, 4
    for seed in (0, 1):
        got, want, bound = _scores(P5_CELLS[name], seed, n=n, d=d)
        inner = slice(2 * d, n - 2 * d)
        np.testing.assert_array_equal(got[inner].view(np.uint32), want[inner].view(np.uint32))
        tol = WRAP_ULPS * float(np.spacing(np.float32(bound)))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


#: the sybil bench config's score terms: P3 at -0.5 with its deficit live,
#: P4 at the default -1 and P7 at -1, one topic
SYBIL_CELL = (dict(_ZERO_TOPIC, mesh_message_deliveries_weight=-0.5,
                   mesh_message_deliveries_threshold=4.0,
                   invalid_message_deliveries_weight=-1.0), _PEER, 1, {})


@pytest.mark.parametrize("d", [2, 4, 8, 12])
@pytest.mark.parametrize("name", ["p4_at_minus_one", "sybil"])
def test_p4_square_fusion_follows_the_row_width(name, d):
    """With one topic slot XLA:CPU rounds P4's square apart at a weight of
    -1 in rows of 5 to 8 neighbour slots and fuses it into the sum in
    narrower rows and in rows of whole 8-slot chunks (K = 4, 8, 16, 24
    here; the bench lattice is K = 16)."""
    cell = SYBIL_CELL if name == "sybil" else (
        dict(_ZERO_TOPIC, invalid_message_deliveries_weight=-1.0), _PEER, 1, {})
    for seed in (0, 1):
        got, want, _ = _scores(cell, seed, n=64, d=d)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


#: half-widths d (K = 2d) of the P4 width map: every K from 9 to 41 that
#: is not a multiple of 8, the single tail column (K = 17, 25, 33, 41) too
P4_MAP_D = [k / 2 if k % 2 else k // 2 for k in range(9, 42) if k % 8]


@pytest.mark.parametrize("d", P4_MAP_D)
@pytest.mark.parametrize("name", ["p4_at_minus_one", "sybil"])
def test_p4_square_residue_past_the_last_whole_chunk(name, d):
    """With one topic slot and K >= 9 not a multiple of 8, XLA:CPU leaves
    the columns past the last whole 8-column chunk to a scalar loop (rows of
    20 to 23 columns take columns 16-19 in a 4-wide vector chunk): P4's
    square stays fused there, and the select-guarded squares at -1 (P7
    here) are rounded apart (``score/engine.scalar_tail_start``). Bit-exact
    on every column."""
    cell = SYBIL_CELL if name == "sybil" else (
        dict(_ZERO_TOPIC, invalid_message_deliveries_weight=-1.0), _PEER, 1, {})
    for seed in (0, 1):
        got, want, _ = _scores(cell, seed, n=64, d=d)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


#: the select-guarded products of P3 and P7 at weights other than -1, both
#: squares at -1, P6's product and every term, on one to three slots
GUARDED_CELLS = {
    "p3_at_minus_0.7": (dict(_ZERO_TOPIC, mesh_message_deliveries_weight=-0.7, topic_weight=0.3),
                        dict(_PEER, behaviour_penalty_weight=0.0)),
    "p7_at_minus_0.7": (dict(_ZERO_TOPIC, topic_weight=0.3),
                        dict(_PEER, behaviour_penalty_weight=-0.7)),
    "p3_p7_at_minus_one": (dict(_ZERO_TOPIC, mesh_message_deliveries_weight=-1.0,
                                topic_weight=0.3), _PEER),
    "p6": (dict(_ZERO_TOPIC, topic_weight=0.3),
           dict(_PEER, behaviour_penalty_weight=0.0, ip_colocation_factor_weight=-0.4)),
    "every_term": (_ALL, dict(_PEER, ip_colocation_factor_weight=-0.4,
                              behaviour_penalty_weight=-0.8)),
}


@pytest.mark.parametrize("k", [9, 12, 18, 21, 41])
@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(GUARDED_CELLS))
def test_scalar_columns_round_as_the_reference(name, slots, k):
    """The columns XLA:CPU's scalar loop takes (``scalar_tail_start``:
    past the last whole 8-column chunk, 16-19 fused in rows of 20-23, none
    below K = 16 with several slots) round the select-guarded products of
    P3 and P7 apart, the squares at -1 and the weighted squares at any
    other weight; in a row of 9 with one slot the scalar column fuses
    P6's product into the rounded slot term. Bit-exact on every column
    (the map: every K from 9 to 41 not a multiple of 8, one to three
    slots, ROADMAP §3)."""
    topic, peer = GUARDED_CELLS[name]
    got, want, _ = _scores((topic, peer, slots, {}), k, n=64, d=k / 2 if k % 2 else k // 2)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
