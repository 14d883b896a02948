"""The port's FloodSub step against the JAX package's, leaf by leaf, every
round, on five graph and layout combinations, plus the host builders the
CSR runs stand on (``topo.powerlaw``, ``to_topology``, ``ops/csr.build_csr``,
``graph.from_edges``) against their JAX twins.

Both sides start from the same state (carried across with
``convert.state_from_reference``) and step the same numpy-made publish
schedule; every leaf must be equal bit for bit after every round. The
port runs with ``device="cpu"``, where the ``delivery_banded`` and
``csr_delivery`` wrappers take their plain versions. A fresh JAX state is
built for every run: the JAX step donates its buffers."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import diff_leaves, jinit, reference_leaves

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.ops import csr as jcsr
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.ops import csr as tcsr
from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as tcd
from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as tdb
from go_libp2p_pubsub_tpu_torch.perf import sweep as tsweep
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim

N, M, ROUNDS = 256, 64, 16


def _schedule():
    rng = np.random.default_rng(0)
    po = rng.integers(0, N, size=(ROUNDS, 4)).astype(np.int32)
    pt = np.zeros((ROUNDS, 4), np.int32)
    pv = np.ones((ROUNDS, 4), bool)
    pv[3, 1] = False   # one invalid publish
    po[5, 2] = -1      # and one empty publish slot
    return po, pt, pv


def _topologies(kind):
    if kind == "lattice":
        return jgraph.ring_lattice(N, d=4), tgraph.ring_lattice(N, d=4)
    if kind == "random":
        return jgraph.random_connect(N, d=3, seed=1), tgraph.random_connect(N, d=3, seed=1)
    return (jtopo.to_topology(jtopo.powerlaw(N, 2.2, 2, 16, seed=0), max_degree=16),
            ttopo.to_topology(ttopo.powerlaw(N, 2.2, 2, 16, seed=0), max_degree=16))


@pytest.mark.parametrize("kind,layout,resident,fused", [
    pytest.param("lattice", "dense", False, False, id="lattice-banded"),
    pytest.param("random", "dense", False, False, id="random-dense"),
    pytest.param("powerlaw", "csr", False, False, id="powerlaw-csr-dense-fe"),
    pytest.param("powerlaw", "csr", True, False, id="powerlaw-csr-resident"),
    pytest.param("powerlaw", "csr", True, True, id="powerlaw-csr-resident-fused"),
])
def test_step_equals_reference_every_round(kind, layout, resident, fused):
    jt, tt = _topologies(kind)
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 1), edge_layout=layout, fused=fused)
    tnet = TNet.build(tt, tgraph.subscribe_all(N, 1), edge_layout=layout, fused=fused,
                      device="cpu")
    assert (tnet.band_off is not None) == (kind == "lattice")
    jst = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree,
                    n_edges=jnet.n_edges if resident else None)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    assert tst.dlv.fe_words.dim() == (2 if resident else 3)
    diff_leaves(reference_leaves(jst), convert.state_leaves(tst), "init")
    po, pt, pv = _schedule()
    tdb.reset_launch_counts()
    tcd.reset_launch_counts()
    for r in range(ROUNDS):
        jst = jflood.floodsub_step(jnet, jst, jnp.asarray(po[r]), jnp.asarray(pt[r]),
                                   jnp.asarray(pv[r]))
        tst = tflood.floodsub_step(tnet, tst, torch.from_numpy(po[r]),
                                   torch.from_numpy(pt[r]), torch.from_numpy(pv[r]))
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"round {r}")
    # CPU tensors: the plain versions ran, no kernel launched
    assert tdb.LAUNCHES["delivery_banded"] == tcd.LAUNCHES["csr_delivery"] == 0
    leaves = convert.state_leaves(tst)
    assert leaves[".events"][3] > 0     # deliveries were counted
    reach = (leaves[".dlv.first_round"] >= 0).sum(0)
    born = leaves[".msgs.birth"]
    assert (reach[(born >= 0) & (born <= ROUNDS - 4)] > 1).all()


def test_delivery_only_rounds_equal_reference():
    jt, tt = _topologies("lattice")
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 1))
    tnet = TNet.build(tt, tgraph.subscribe_all(N, 1), device="cpu")
    jst = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    po = jnp.asarray(np.array([3, 77, -1, 5], np.int32))
    z = jnp.zeros((4,), jnp.int32)
    jst = jflood.floodsub_step(jnet, jst, po, z, jnp.ones((4,), bool))
    tst = tflood.floodsub_step(tnet, tst, torch.tensor([3, 77, -1, 5], dtype=torch.int32),
                               torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    jst = jflood.run_rounds(jnet, jst, 6)
    tst = tflood.run_rounds(tnet, tst, 6)
    diff_leaves(reference_leaves(jst), convert.state_leaves(tst), "run_rounds")


def test_flood_edge_mask_is_a_view_equal_to_reference():
    jt, tt = _topologies("random")
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 2))
    tnet = TNet.build(tt, tgraph.subscribe_all(N, 2), device="cpu")
    jst = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree)
    topic = np.random.default_rng(1).integers(-1, 2, size=(M,)).astype(np.int32)
    jmsgs = jst.msgs.replace(topic=jnp.asarray(topic))
    tst = TSim.init(N, M, k=tnet.max_degree, device="cpu")
    tmsgs = dataclasses.replace(tst.msgs, topic=torch.from_numpy(topic))
    got = tflood.flood_edge_mask(tnet, tmsgs)
    assert got.stride(1) == 0
    np.testing.assert_array_equal(np.asarray(jflood.flood_edge_mask(jnet, jmsgs)),
                                  got.numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# host builders


@pytest.mark.parametrize("n,exponent,d_min,max_degree,seed", [
    (128, 2.2, 2, 16, 0), (2000, 2.2, 2, 64, 0), (400, 1.5, 1, 8, 3), (60, 2.2, 4, 4, 1),
])
def test_powerlaw_and_topology_equal_reference(n, exponent, d_min, max_degree, seed):
    jel = jtopo.powerlaw(n, exponent, d_min, max_degree, seed=seed)
    tel = ttopo.powerlaw(n, exponent, d_min, max_degree, seed=seed)
    assert jel.canonical_bytes() == tel.canonical_bytes()
    assert (jel.n_undirected, jel.max_degree, jel.mean_degree) == (
        tel.n_undirected, tel.max_degree, tel.mean_degree)
    np.testing.assert_array_equal(jel.degree, tel.degree)
    for md in (None, max_degree):
        jt, tt = jtopo.to_topology(jel, max_degree=md), ttopo.to_topology(tel, max_degree=md)
        for f in ("nbr", "nbr_ok", "rev", "outbound", "degree"):
            a, b = getattr(jt, f), getattr(tt, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    with pytest.raises(ValueError, match="exceeds"):
        ttopo.to_topology(tel, max_degree=tel.max_degree - 1)


@pytest.mark.parametrize("kind", ["lattice", "random", "powerlaw"])
def test_build_csr_equals_reference(kind):
    jt, tt = _topologies(kind)
    jc, tc = jcsr.build_csr(jt.nbr, jt.rev, jt.nbr_ok), tcsr.build_csr(tt.nbr, tt.rev, tt.nbr_ok)
    for f in ("row_ptr", "col", "row", "slot", "e2nk", "e_of_nk", "eperm",
              "seg_start", "row_last", "row_nonempty"):
        a, b = getattr(jc, f), getattr(tc, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("n_peers", "max_degree", "n_edges", "n_real_edges", "density"):
        assert getattr(jc, f) == getattr(tc, f), f


def test_from_edges_and_build_nets_equal_reference():
    pairs = [(0, 3), (3, 1), (2, 4), (4, 0), (1, 2), (0, 3)]
    jt, tt = jgraph.from_edges(6, pairs, max_degree=4), tgraph.from_edges(6, pairs, max_degree=4)
    for f in ("nbr", "nbr_ok", "rev", "outbound", "degree"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)
    el = ttopo.powerlaw(64, 2.2, 2, 8, seed=2)
    tp, dense, csr = ttopo.build_nets(el, tgraph.subscribe_all(64, 1), max_degree=8,
                                      device="cpu")
    assert dense.edge_layout == "dense" and csr.edge_layout == "csr"
    assert torch.equal(dense.nbr, csr.nbr) and csr.n_edges == int(tp.degree.sum())
    with pytest.raises(ValueError, match="not symmetric"):
        bad = tp.nbr_ok.copy()
        bad[0, 0] = False
        tcsr.build_csr(tp.nbr, tp.rev, bad)


# ---------------------------------------------------------------------------
# state, workload and refusals


def test_csr_resident_state_carries_across():
    el = ttopo.powerlaw(96, 2.2, 2, 16, seed=0)
    net = TNet.build(ttopo.to_topology(el, 16), tgraph.subscribe_all(96, 1),
                     edge_layout="csr", device="cpu")
    st = TSim.init(96, 40, seed=3, k=net.max_degree, device="cpu", n_edges=net.n_edges)
    assert tuple(st.dlv.fe_words.shape) == (net.n_edges, 2)
    leaves = convert.state_leaves(st)
    assert leaves[".dlv.fe_words"].dtype == np.uint32 and leaves[".key"].dtype == np.uint32
    diff_leaves(leaves, convert.state_leaves(convert.state_from_reference(leaves, "cpu")))
    with pytest.raises(ValueError, match="CSR-resident"):
        st.dlv.first_edge


@pytest.mark.parametrize("val_delay", [0, 2])
@pytest.mark.parametrize("resident", [False, True])
def test_pipelined_state_carries_across(val_delay, resident):
    """A reference state with the async-validation pipeline (and one
    without: no ``.dlv.pending`` leaf on either side) carries into the port
    and back, dense and CSR-resident, stages holding receipts."""
    jt, _ = _topologies("powerlaw")
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 1), edge_layout="csr")
    jst = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree, val_delay=val_delay,
                    n_edges=jnet.n_edges if resident else None)
    z = jnp.zeros((4,), jnp.int32)
    jst = jflood.floodsub_step(jnet, jst, jnp.asarray([3, 9, 40, 77], jnp.int32), z,
                               jnp.ones((4,), bool))
    jst = jflood.run_rounds(jnet, jst, 2)
    leaves = reference_leaves(jst)
    assert (".dlv.pending" in leaves) == (val_delay > 0)
    tst = convert.state_from_reference(leaves, device="cpu")
    assert (tst.dlv.pending is None) == (val_delay == 0)
    back = convert.state_leaves(tst)
    diff_leaves(leaves, back)
    diff_leaves(back, convert.state_leaves(convert.state_from_reference(back, "cpu")))
    if val_delay:
        assert tuple(tst.dlv.pending.shape) == (N, val_delay, 2)
        assert back[".dlv.pending"].dtype == np.uint32 and back[".dlv.pending"].any()


@pytest.mark.parametrize("graph,layout,resident", [
    ("lattice", "dense", True), ("powerlaw", "csr", True), ("powerlaw", "csr", False),
    ("powerlaw", "dense", True),
])
def test_floodsub_workload_on_cpu(graph, layout, resident):
    n = 512
    st, step = tsweep.build_floodsub(n, 64, graph=graph, layout=layout,
                                     resident=resident, device="cpu")
    assert step.setup_seconds > 0
    assert (step.net.band_off is not None) == (graph == "lattice" and layout == "dense")
    po, pt, pv = tsweep.publish_schedule(16, n, 1, None)
    st = tsweep.run_rounds(st, step, po, pt, pv)
    assert int(st.tick) == 16
    assert not bool(((st.dlv.fwd & ~st.dlv.have) != 0).any())
    reach = (st.dlv.first_round >= 0).sum(0)
    born = st.msgs.birth
    old = (born >= 0) & (born <= 12)
    assert bool(old.any()) and bool((reach[old] > 1).all())


def test_unported_options_raise():
    tnet = TNet.build(tgraph.ring_lattice(16, d=2), tgraph.subscribe_all(16, 1), device="cpu")
    p = torch.full((1,), -1, dtype=torch.int32)
    ok = torch.ones(1, dtype=torch.bool)
    # the attack plane is ported (tests/test_torch_adversary.py): an invalid
    # scenario raises before the round
    from go_libp2p_pubsub_tpu_torch.chaos import AdversaryError, AttackScenario

    with pytest.raises(AdversaryError):
        tflood.floodsub_step(tnet, TSim.init(16, 32, k=tnet.max_degree, device="cpu"),
                             p, p, ok, adversary=AttackScenario(n_peers=16, surround_targets=True))
    # the chaos plane is ported (tests/test_torch_chaos_engines.py): an
    # invalid config raises before the round
    from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig, ChaosConfigError

    with pytest.raises(ChaosConfigError):
        tflood.floodsub_step(tnet, TSim.init(16, 32, k=tnet.max_degree, device="cpu"),
                             p, p, ok, chaos=ChaosConfig(generator="nope"))
    with pytest.raises(ValueError, match="edge_layout"):
        TNet.build(tgraph.ring_lattice(16, d=2), tgraph.subscribe_all(16, 1),
                   edge_layout="sparse", device="cpu")


def test_entry_points_refuse_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.build_floodsub(64, 64, graph="powerlaw", layout="csr")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSim.init(64, 64, k=4, n_edges=100)
