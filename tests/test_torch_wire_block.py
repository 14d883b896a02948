"""The transmit-block plane (``MsgTable.wire_block``, behind
``api.Network(max_message_size=)``) in every engine of the port, against
the JAX package's, leaf by leaf, every round or phase: the per-round
GossipSub step on the banded lattice (the ``fused_delivery`` route) and
CSR-resident, the phase engine on the lattice and CSR-resident, FloodSub
and RandomSub dense and CSR-resident; and the checkpoint's leaf order with
the plane present.

Publishes carry int verdict codes with the ``VERDICT_WIRE_BLOCK`` bit on a
few of them (one also rejected). A blocked message is stamped at its
origin and nowhere else: it still enters the origin's mcache and is
IHAVE-advertised, and an IWANT for it ticks the retransmission counter
before it dies at the wire, as in the JAX package. On the CPU the kernel
wrappers take their plain versions, which get the block through their
receiver-exclusion argument, as the kernels do on the card. A fresh JAX
state is built for every run: the JAX step donates its buffers."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    phase_schedule,
    phases_against_reference,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import checkpoint as jck
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models import randomsub as jrs
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import checkpoint as tck
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.state import VERDICT_WIRE_BLOCK
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim

N, M = 64, 64


def block_schedule(n: int, rounds: int):
    """``phase_schedule``'s int codes with the block bit on four publishes
    (one of them rejected as well)."""
    po, pt, pv = phase_schedule(n, rounds, codes=True)
    for r, j in ((0, 0), (2, 1), (4, 3), (5, 1)):
        pv[r, j] |= VERDICT_WIRE_BLOCK
    return po, pt, pv


def assert_blocked_stay_home(st):
    """Every live blocked message is stamped at its origin only."""
    core = getattr(st, "core", st)
    block = core.msgs.wire_block.numpy()
    assert block.any()
    fr = core.dlv.first_round.numpy()
    origin = core.msgs.origin.numpy()
    for s in np.flatnonzero(block):
        got = np.flatnonzero(fr[:, s] >= 0)
        assert got.tolist() == [origin[s]], (s, got)


def _powerlaw_pair(n):
    return (jtopo.to_topology(jtopo.powerlaw(n, 2.2, 2, 16, seed=0), max_degree=16),
            ttopo.to_topology(ttopo.powerlaw(n, 2.2, 2, 16, seed=0), max_degree=16))


@pytest.mark.parametrize("layout", ["lattice", "csr"])
def test_per_round_step_blocks_transmits(layout):
    kw = {} if layout == "lattice" else dict(edge_layout="csr", fused=True,
                                              topologies=_powerlaw_pair(N))
    b = bench_builds(n=N, d=4, **kw)
    assert (b[4].band_off is not None) == (layout == "lattice")
    tst = rounds_against_reference(b, 10, schedule=block_schedule(N, 10), wire_block=True)
    assert_blocked_stay_home(tst)


@pytest.mark.parametrize("layout", ["lattice", "csr"])
def test_phase_engine_blocks_transmits(layout):
    kw = {} if layout == "lattice" else dict(edge_layout="csr", fused=True,
                                              topologies=_powerlaw_pair(N))
    b = bench_builds(n=N, d=4, heartbeat_every=4, **kw)
    tst = phases_against_reference(b, 4, 4, 16, schedule=block_schedule(N, 16),
                                   wire_block=True)
    assert (tst.core.dlv.fe_words.dim() == 2) == (layout == "csr")
    assert_blocked_stay_home(tst)


@pytest.mark.parametrize("engine,layout", [("floodsub", "dense"), ("floodsub", "csr"),
                                           ("randomsub", "dense"), ("randomsub", "csr")])
def test_sim_engines_block_transmits(engine, layout):
    if layout == "dense":
        jt, tt = jgraph.ring_lattice(N, d=4), tgraph.ring_lattice(N, d=4)
    else:
        jt, tt = _powerlaw_pair(N)
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 1), edge_layout=layout)
    tnet = TNet.build(tt, tgraph.subscribe_all(N, 1), edge_layout=layout, device="cpu")
    if engine == "floodsub":
        jstep = functools.partial(jflood.floodsub_step, jnet)
        tstep = functools.partial(tflood.floodsub_step, tnet)
    else:
        jstep, tstep = jrs.make_randomsub_step(jnet), trs.make_randomsub_step(tnet)
    jst = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree, wire_block=True,
                    n_edges=jnet.n_edges)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    assert tst.msgs.wire_block is not None
    po, pt, pv = block_schedule(N, 10)
    for r in range(10):
        jst = jstep(jst, jnp.asarray(po[r]), jnp.asarray(pt[r]), jnp.asarray(pv[r]))
        tst = tstep(tst, torch.from_numpy(po[r]), torch.from_numpy(pt[r]),
                    torch.from_numpy(pv[r]))
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"round {r}")
    assert_blocked_stay_home(tst)


def test_checkpoint_leaf_order_with_the_block_plane(tmp_path):
    """The plane sits after the cursor in the message table, as in the JAX
    tree, in both state kinds; a file of either package loads in the other."""
    b = bench_builds(n=N, d=4)
    jst = jinit(JState.init, b[1], M, b[0], score_params=b[2], seed=0, wire_block=True)
    ref = reference_leaves(jst)
    tst = TState.init(b[4], M, b[3], score_params=b[5], seed=0, wire_block=True)
    specs = convert.leaf_specs(tst)
    assert specs == {p: (a.shape, a.dtype) for p, a in ref.items()}
    paths = list(specs)
    assert paths[paths.index(".core.msgs.cursor") + 1] == ".core.msgs.wire_block"
    jsim = jinit(JSim.init, N, M, seed=0, k=8, wire_block=True)
    tsim = convert.state_from_reference(reference_leaves(jsim), device="cpu")
    assert list(convert.leaf_specs(tsim)) == list(reference_leaves(jsim))
    # a blocked publish in the table, then both ways through a file
    tsim.msgs.wire_block[3] = True
    tck.save(str(tmp_path / "port.npz"), tsim)
    back = jck.restore(str(tmp_path / "port.npz"), jinit(JSim.init, N, M, seed=0, k=8,
                                                            wire_block=True))
    diff_leaves(convert.state_leaves(tsim), reference_leaves(back), "port -> jax")
    jck.save(str(tmp_path / "jax.npz"), back)
    again = tck.restore(str(tmp_path / "jax.npz"), tsim)
    diff_leaves(convert.state_leaves(tsim), convert.state_leaves(again), "jax -> port")
    # a template without the plane is refused by its leaf count
    with pytest.raises(ValueError, match="leaves"):
        tck.restore(str(tmp_path / "jax.npz"), TSim.init(N, M, seed=0, k=8, device="cpu"))
