"""The port's GossipSub step off the banded lattice against the JAX
package's, leaf by leaf, every round: a non-banded dense topology, the
lattice and a ragged power-law graph in the CSR layout (the state
CSR-resident between steps, as ``GossipSubState.init`` makes it there), with
``fused`` off and on (the JAX step then ranks by its sort form, the port by
its one pairwise form).

Both sides run the bench's default params (v1.1, live scoring, one topic)
from the same state, carried across with ``convert.state_from_reference``,
on the same numpy-made publish schedule; every leaf must be equal bit for
bit after every round. The port runs with ``device="cpu"``, where
``select_topk`` takes its plain version. A fresh JAX state is built for
every run: the JAX step donates its buffers."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bench_builds, diff_leaves, jinit, reference_leaves

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake
from go_libp2p_pubsub_tpu_torch.ops import select_topk as tsk
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import densify_edge_planes, flatten_edge_planes

ROUNDS = 24


def _topologies(kind, n):
    if kind == "lattice":
        return jgraph.ring_lattice(n, d=4), tgraph.ring_lattice(n, d=4)
    if kind == "random":
        return jgraph.random_connect(n, d=3, seed=1), tgraph.random_connect(n, d=3, seed=1)
    return (jtopo.to_topology(jtopo.powerlaw(n, 2.2, 2, 64, seed=0), max_degree=64),
            ttopo.to_topology(ttopo.powerlaw(n, 2.2, 2, 64, seed=0), max_degree=64))


def _schedule(n):
    rng = np.random.default_rng(0)
    po = rng.integers(0, n, size=(ROUNDS, 4)).astype(np.int32)
    pt = np.zeros((ROUNDS, 4), np.int32)
    pv = np.ones((ROUNDS, 4), bool)
    pv[5, 1] = False   # one invalid publish
    po[9, 3] = -1      # and one empty publish slot
    return po, pt, pv


@pytest.mark.parametrize("kind,n,layout,fused,heartbeat_every,count_events", [
    pytest.param("random", 96, "dense", False, 1, True, id="random-dense"),
    pytest.param("random", 96, "dense", True, 1, False, id="random-dense-fused"),
    pytest.param("lattice", 96, "csr", False, 1, False, id="lattice-csr"),
    pytest.param("lattice", 96, "csr", True, 1, True, id="lattice-csr-fused"),
    pytest.param("powerlaw", 256, "csr", True, 1, True, id="powerlaw-csr-fused"),
    pytest.param("powerlaw", 256, "csr", False, 2, True, id="powerlaw-csr-hb2-static"),
])
def test_step_equals_reference_every_round(kind, n, layout, fused, heartbeat_every,
                                           count_events):
    jcfg, jnet, jsp, tcfg, tnet, tsp = bench_builds(
        n=n, heartbeat_every=heartbeat_every, count_events=count_events,
        topologies=_topologies(kind, n), edge_layout=layout, fused=fused)
    assert tnet.band_off is None and (tnet.n_edges is None) == (layout == "dense")
    static_hb = heartbeat_every > 1
    jst = jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=0)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    if layout == "csr":
        e = tnet.n_edges
        assert tst.served_lo.shape[0] == tst.peerhave.shape[0] == e
        assert tst.core.dlv.fe_words.shape[0] == e
    diff_leaves(reference_leaves(jst), convert.state_leaves(tst), "init")
    jstep = jmake(jcfg, jnet, score_params=jsp, static_heartbeat=static_hb)
    tstep = tmake(tcfg, tnet, score_params=tsp, static_heartbeat=static_hb)
    po, pt, pv = _schedule(n)
    tsk.reset_launch_counts()
    for r in range(ROUNDS):
        kw = {"do_heartbeat": r % heartbeat_every == 0} if static_hb else {}
        jst = jstep(jst, jnp.asarray(po[r]), jnp.asarray(pt[r]), jnp.asarray(pv[r]), **kw)
        tst = tstep(tst, torch.from_numpy(po[r]), torch.from_numpy(pt[r]),
                    torch.from_numpy(pv[r]), **kw)
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"round {r}")
    # CPU tensors: the plain versions ran, no kernel launched
    assert tsk.LAUNCHES["select_topk"] == 0
    leaves = convert.state_leaves(tst)
    assert leaves[".mesh"].sum(-1).max() >= 1
    if count_events:
        assert leaves[".core.events"].sum() > 0
    born = leaves[".core.msgs.birth"]
    reach = (leaves[".core.dlv.first_round"] >= 0).sum(0)
    assert (reach[(born >= 0) & (born <= ROUNDS - 4)] > 1).all()


def test_csr_gathers_equal_reference_csr_net():
    """The port's CSR net gathers through the dense involution; the JAX
    CSR net through the flat edge space. Both give the same values,
    including the junk on absent slots (self-pointing for edge_gather,
    v[0] for peer_gather)."""
    n = 256
    jt, tt = _topologies("powerlaw", n)
    jnet = JNet.build(jt, jgraph.subscribe_all(n, 1), edge_layout="csr")
    tnet = TNet.build(tt, tgraph.subscribe_all(n, 1), edge_layout="csr", device="cpu")
    assert not tnet.nbr_ok.all()
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2 ** 32, size=(n, jnet.max_degree, 2), dtype=np.uint32)
    s = rng.standard_normal((n, jnet.max_degree)).astype(np.float32)
    v = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    for a in (x, s):
        want = np.asarray(jnet.edge_gather(jnp.asarray(a)))
        got = tnet.edge_gather(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                                else a)).numpy()
        np.testing.assert_array_equal(want.view(np.int32) if want.dtype == np.uint32
                                      else want, got)
    want = np.asarray(jnet.peer_gather(jnp.asarray(v))).view(np.int32)
    np.testing.assert_array_equal(want, tnet.peer_gather(torch.from_numpy(v.view(np.int32))).numpy())


def test_csr_resident_planes_round_trip():
    """densify/flatten are inverse on a CSR-resident state, and a dense
    state passes through both unchanged."""
    n = 256
    jcfg, jnet, jsp, tcfg, tnet, tsp = bench_builds(
        n=n, topologies=_topologies("powerlaw", n), edge_layout="csr", fused=True)
    st = convert.state_from_reference(reference_leaves(
        jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=2)), device="cpu")
    rng = np.random.default_rng(0)
    e = tnet.n_edges
    st.served_lo = torch.from_numpy(rng.integers(-2**31, 2**31, size=(e, 2)).astype(np.int32))
    st.peerhave = torch.from_numpy(rng.integers(0, 9, size=(e,)).astype(np.int32))
    dense = densify_edge_planes(tnet, st)
    assert dense.served_lo.shape == (n, 64, 2) and dense.peerhave.shape == (n, 64)
    assert dense.core.dlv.fe_words.shape == (n, 64, 2)
    ok = tnet.nbr_ok
    assert not bool((dense.peerhave[~ok] != 0).any())
    diff_leaves(convert.state_leaves(dense),
                convert.state_leaves(densify_edge_planes(tnet, dense)), "dense again")
    back = flatten_edge_planes(tnet, dense)
    diff_leaves(convert.state_leaves(st), convert.state_leaves(back), "round trip")
    diff_leaves(convert.state_leaves(back),
                convert.state_leaves(flatten_edge_planes(tnet, back)), "flat again")
