"""The port's RandomSub step against the JAX package's, leaf by leaf, every
round, on FloodSub's five graph and layout combinations
(``tests/test_torch_floodsub.py``), under threefry.

Each cell draws its random fanout from the same key stream on both sides
(``fold_in(key, tick)``), with the size target either given
(``size_estimate``) or counted from the topic's gossip-capable subscribers,
one cell with floodsub-only peers (``protocol == 0``: excluded from the
draw and always sent to, and flooding themselves), one with the queue cap.
The JAX step's ``stacked`` switch picks one of two bit-identical forms of
its recycled-slot clears; both are held against the port's one form. A
fresh JAX state is built for every run: the JAX step donates its buffers.
The port runs with ``device="cpu"``, where the kernel wrappers take their
plain versions."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import diff_leaves, jinit, reference_leaves

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.models import randomsub as jrs
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs
from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as tcd
from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as tdb
from go_libp2p_pubsub_tpu_torch.ops import select_topk as tsk
from go_libp2p_pubsub_tpu_torch.perf import sweep as tsweep
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim

N, M, ROUNDS = 256, 64, 16


def schedule(n: int, rounds: int):
    """4 publishes a round from random origins on topic 0, one invalid and
    one slot empty (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    po = rng.integers(0, n, size=(rounds, 4)).astype(np.int32)
    pt = np.zeros((rounds, 4), np.int32)
    pv = np.ones((rounds, 4), bool)
    pv[3, 1] = False
    po[5, 2] = -1
    return po, pt, pv


def topologies(kind: str, n: int = N):
    """(JAX, port) topologies: the K=16 lattice (banded), a random dense
    net, or a ragged power-law graph padded to K=16."""
    if kind == "lattice":
        return jgraph.ring_lattice(n, d=8), tgraph.ring_lattice(n, d=8)
    if kind == "random":
        return jgraph.random_connect(n, d=6, seed=1), tgraph.random_connect(n, d=6, seed=1)
    return (jtopo.to_topology(jtopo.powerlaw(n, 2.2, 2, 16, seed=0), max_degree=16),
            ttopo.to_topology(ttopo.powerlaw(n, 2.2, 2, 16, seed=0), max_degree=16))


def nets(kind: str, layout: str = "dense", fused: bool = False, protocol=None, n: int = N):
    jt, tt = topologies(kind, n)
    jnet = JNet.build(jt, jgraph.subscribe_all(n, 1), protocol=protocol, edge_layout=layout,
                      fused=fused)
    tnet = TNet.build(tt, tgraph.subscribe_all(n, 1), protocol=protocol, edge_layout=layout,
                      fused=fused, device="cpu")
    return jnet, tnet


def run_against_reference(jnet, tnet, jstep, tstep, resident: bool = False,
                          val_delay: int = 0, rounds: int = ROUNDS):
    """Two SimState steps (the JAX package's and the port's: FloodSub or
    RandomSub) from the same fresh state over ``schedule``; every leaf
    equal after every round. Returns the port's final leaves."""
    jst = jinit(JSim.init, tnet.n_peers, M, seed=0, k=jnet.max_degree, val_delay=val_delay,
                    n_edges=jnet.n_edges if resident else None)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    po, pt, pv = schedule(tnet.n_peers, rounds)
    for r in range(rounds):
        jst = jstep(jst, jnp.asarray(po[r]), jnp.asarray(pt[r]), jnp.asarray(pv[r]))
        tst = tstep(tst, torch.from_numpy(po[r]), torch.from_numpy(pt[r]),
                    torch.from_numpy(pv[r]))
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"round {r}")
    return convert.state_leaves(tst)


def randomsub_steps(jnet, tnet, **kw):
    """Both packages' RandomSub steps with the same options (the JAX
    step's ``stacked`` switch is its own)."""
    return (jrs.make_randomsub_step(jnet, **kw),
            trs.make_randomsub_step(tnet, **{k: v for k, v in kw.items() if k != "stacked"}))


def _floodsub_fifth(n: int = N) -> np.ndarray:
    protocol = np.full((n,), 2, np.int8)
    protocol[np.random.default_rng(3).random(n) < 0.2] = 0
    return protocol


@pytest.mark.parametrize("kind,layout,resident,fused,kw", [
    pytest.param("lattice", "dense", False, False, dict(size_estimate=30, stacked=False),
                 id="lattice-banded"),
    pytest.param("random", "dense", False, False, dict(size_estimate=None),
                 id="random-dense"),
    pytest.param("powerlaw", "csr", False, False, dict(size_estimate=30),
                 id="powerlaw-csr-dense-fe"),
    pytest.param("powerlaw", "csr", True, False, dict(size_estimate=100, stacked=False),
                 id="powerlaw-csr-resident"),
    pytest.param("powerlaw", "csr", True, True, dict(size_estimate=None),
                 id="powerlaw-csr-resident-fused"),
    pytest.param("lattice", "dense", False, False, dict(size_estimate=None),
                 id="lattice-floodsub-peers"),
    pytest.param("random", "dense", False, False, dict(size_estimate=30, queue_cap=2),
                 id="random-queue-cap"),
])
def test_step_equals_reference_every_round(kind, layout, resident, fused, kw):
    protocol = _floodsub_fifth() if kind == "lattice" and kw["size_estimate"] is None else None
    jnet, tnet = nets(kind, layout, fused, protocol)
    assert (tnet.band_off is not None) == (kind == "lattice")
    for lib in (tdb, tcd, tsk):
        lib.reset_launch_counts()
    leaves = run_against_reference(jnet, tnet, *randomsub_steps(jnet, tnet, **kw), resident)
    # CPU tensors: the plain versions ran, no kernel launched
    assert (tdb.LAUNCHES["delivery_banded"] == tcd.LAUNCHES["csr_delivery"]
            == tsk.LAUNCHES["select_topk"] == 0)
    if kw.get("queue_cap"):
        assert leaves[".events"][8] > 0     # DROP_RPC: the cap bit
        return
    reach = (leaves[".dlv.first_round"] >= 0).sum(0)
    born = leaves[".msgs.birth"]
    assert (reach[(born >= 0) & (born <= ROUNDS - 4)] > 1).all()


def test_size_targets_and_the_random_draw():
    """The fanout target per topic: max(6, ceil(sqrt(size))), the size
    given or counted over gossip-capable subscribers; and the draw sends
    to fewer neighbours than FloodSub would where the target is below the
    degree."""
    _jnet, tnet = nets("lattice", protocol=_floodsub_fifth())
    gossip = int((tnet.protocol >= 1).sum())
    assert trs.size_targets(tnet).tolist() == [int(np.ceil(np.sqrt(gossip)))]
    assert trs.size_targets(tnet, size_estimate=30).tolist() == [6]
    assert trs.size_targets(tnet, d=3, size_estimate=4).tolist() == [3]
    st, run = tsweep.build_randomsub(N, M, size_estimate=30, device="cpu")
    po, pt, pv = schedule(N, 8)
    st = tsweep.run_rounds(st, run, po, pt, pv)
    st2, flood = tsweep.build_floodsub(N, M, device="cpu")
    st2 = tsweep.run_rounds(st2, flood, po, pt, pv)
    rpc = lambda s: int(s.events[7])     # SEND_RPC
    assert 0 < rpc(st) < rpc(st2)


def test_unported_options_raise():
    tnet = TNet.build(tgraph.ring_lattice(16, d=2), tgraph.subscribe_all(16, 1), device="cpu")
    # the attack plane is ported (tests/test_torch_adversary.py): an invalid
    # scenario raises at the build
    from go_libp2p_pubsub_tpu_torch.chaos import AdversaryError, AttackScenario

    with pytest.raises(AdversaryError):
        trs.make_randomsub_step(tnet, adversary=AttackScenario(n_peers=16, sybil_fraction=1.5))
    # the chaos plane is ported (tests/test_torch_chaos_engines.py): an
    # invalid config raises at the build
    from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig, ChaosConfigError

    with pytest.raises(ChaosConfigError):
        trs.make_randomsub_step(tnet, chaos=ChaosConfig(loss_rate=1.5))
    # the lifted call convention: the plane is taken and unused
    # (tests/test_torch_lift.py)
    lifted = trs.make_randomsub_step(tnet, lift_scores=True)
    from go_libp2p_pubsub_tpu_torch.state import SimState

    st = SimState.init(16, 32, seed=0, k=tnet.max_degree, device="cpu")
    po = torch.tensor([1, -1], dtype=torch.int32)
    assert int(lifted(st, po, torch.zeros(2, dtype=torch.int32),
                      torch.ones(2, dtype=torch.bool), object()).tick) == 1
    with pytest.raises(ValueError, match="graph"):
        tsweep.build_randomsub(16, 32, graph="star", device="cpu")


def test_window_of_randomsub_equals_eager():
    """``driver.make_window`` drives a RandomSub step as it drives
    FloodSub's: the window's state equals the eager loop's."""
    from go_libp2p_pubsub_tpu_torch import driver

    st, run = tsweep.build_randomsub(64, M, size_estimate=9, device="cpu", val_delay=1)
    po, pt, pv = schedule(64, 8)
    eager = tsweep.run_rounds(st, run, po, pt, pv)
    win, _ = driver.make_window(run)(st, (po, pt, pv))
    diff_leaves(convert.state_leaves(eager), convert.state_leaves(win), "window")
    assert TSim.init(8, 32, device="cpu", val_delay=2).dlv.pending.shape == (8, 2, 1)
