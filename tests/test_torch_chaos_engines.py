"""The chaos plane in the port's four engines against the JAX package's,
leaf by leaf, every round or phase, ``ge_bad`` and the LINK_DOWN and
IWANT_RECOVER counters included; and the elision: a build whose
``ChaosConfig`` is None or disabled (the JAX package's ``OFF_CONFIGS``,
tests/test_chaos.py:52) gives the chaos-off build's states bit for bit.

The generators are the JAX tests' values (tests/test_chaos.py:50-51):
i.i.d. at a loss rate of 0.35 and Gilbert–Elliott at 0.15 down, 0.4 up.
Cells: FloodSub and RandomSub dense (the banded lattice) and CSR-resident
(a power-law graph), one of each scheduled (a random deny plane a round);
the per-round GossipSub step on the lattice, a random dense net and
CSR-resident (densified); the phase engine at r = 1 and r = 8 on the
lattice, in the coalesced and the per-plane wire form. Scheduled
partitions are ``test_torch_chaos_sched.py``'s. The port runs on
the CPU, so the kernels' plain versions run: the routes under chaos are
asserted from launch counts on the card (``chip_smoke.py``). A fresh JAX
state is built for every run: the JAX steps donate their buffers."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_randomsub import nets, schedule
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    phases_against_reference,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.chaos import ChaosConfig as JChaos
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models import randomsub as jrs
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig as TChaos
from go_libp2p_pubsub_tpu_torch.driver import heartbeat_schedule
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim
from go_libp2p_pubsub_tpu_torch.trace.events import EV

IID = dict(loss_rate=0.35)
GE = dict(generator="ge", ge_p_down=0.15, ge_p_up=0.4)
#: the JAX package's OFF_CONFIGS (tests/test_chaos.py:52)
OFF_CONFIGS = (None, dict(), dict(generator="ge"))
N, M, ROUNDS = 64, 64, 12


def _deny_plane(n, k, rounds, seed=7, p=0.3):
    """[rounds, N, K] bool: a random deny plane, not symmetric (the engines
    take any mask)."""
    return np.random.default_rng(seed).random((rounds, n, k)) < p


def _sim_run(router, jnet, tnet, chaos, resident, deny=None):
    """FloodSub or RandomSub of both packages under ``chaos`` from one
    fresh state, every leaf every round; returns the port's last leaves."""
    jc, tc = JChaos(**chaos), TChaos(**chaos)
    jst = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree, chaos_ge=jc.needs_state,
                    n_edges=jnet.n_edges if resident else None)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    assert (tst.chaos is not None) == tc.needs_state
    po, pt, pv = schedule(N, ROUNDS)
    if router == "floodsub":
        jstep = lambda s, a, row: jflood.floodsub_step(jnet, s, *a, chaos=jc, link_deny=row)
        tstep = lambda s, a, row: tflood.floodsub_step(tnet, s, *a, chaos=tc, link_deny=row)
    else:
        js, ts = jrs.make_randomsub_step(jnet, chaos=jc), trs.make_randomsub_step(tnet, chaos=tc)
        jstep = lambda s, a, row: js(s, *a, *(() if row is None else (row,)))
        tstep = lambda s, a, row: ts(s, *a, *(() if row is None else (row,)))
    for r in range(ROUNDS):
        row = None if deny is None else deny[r]
        jst = jstep(jst, [jnp.asarray(x[r]) for x in (po, pt, pv)],
                    None if row is None else jnp.asarray(row))
        tst = tstep(tst, [torch.from_numpy(x[r]) for x in (po, pt, pv)],
                    None if row is None else torch.from_numpy(row))
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"{router} round {r}")
    return convert.state_leaves(tst)


@pytest.mark.parametrize("router,cell", [
    ("floodsub", "lattice-iid"), ("floodsub", "csr-ge-scheduled"),
    ("randomsub", "lattice-ge-scheduled"), ("randomsub", "csr-iid")])
def test_sim_state_engines_equal_reference(router, cell):
    """FloodSub and RandomSub each under both generators, dense on the
    banded lattice and CSR-resident on a power-law graph (the link mask
    folds into the edge mask, then ``pack_edges``), each once scheduled
    (a deny plane a round)."""
    layout, gen, *sched = cell.split("-")
    chaos = dict(IID if gen == "iid" else GE, scheduled=bool(sched))
    kind = "lattice" if layout == "lattice" else "powerlaw"
    jnet, tnet = nets(kind, "csr" if layout == "csr" else "dense", n=N)
    deny = _deny_plane(N, tnet.max_degree, ROUNDS) if sched else None
    leaves = _sim_run(router, jnet, tnet, chaos, layout == "csr", deny)
    assert leaves[".events"][EV.LINK_DOWN] > 0 and leaves[".events"][EV.DELIVER_MESSAGE] > 0
    assert (".chaos.ge_bad" in leaves) == (gen == "ge")


@pytest.mark.parametrize("cell", ["lattice-iid", "random-ge", "csr-iid"])
def test_per_round_step_equals_reference(cell):
    """The per-round GossipSub step: the wire view (control exchange and
    IWANT window) and the data gate under the round's mask, the counters
    over the live links; on the lattice it leaves the fused kernels for
    the composites; on CSR it densifies as without chaos."""
    kind, gen = cell.split("-")
    kw = {}
    if kind != "lattice":
        kw["topologies"] = (jgraph.random_connect(N, 5, seed=1),
                            tgraph.random_connect(N, 5, seed=1))
    if kind == "csr":
        kw.update(edge_layout="csr", fused=True)
    builds = bench_builds(n=N, d=4, chaos=IID if gen == "iid" else GE, **kw)
    st = rounds_against_reference(builds, ROUNDS)
    assert int(st.core.events[EV.LINK_DOWN]) > 0
    assert (st.core.chaos is not None) == (gen == "ge")


@pytest.mark.parametrize("r,coalesced,gen", [(1, True, "ge"), (8, True, "ge"),
                                             (8, False, "iid")],
                         ids=["r1-ge", "r8-ge", "r8-per-plane-iid"])
def test_phase_engine_equals_reference(r, coalesced, gen):
    """The phase engine: the head's mask on its one crossing, each
    sub-round's own on its data crossing, the GE chain a sub-round, in the
    coalesced and the per-plane wire form."""
    builds = bench_builds(n=N, d=4, heartbeat_every=r, chaos=IID if gen == "iid" else GE,
                          options=dict(wire_coalesced=coalesced))
    st = phases_against_reference(builds, r, r, 24 if r > 1 else 10)
    assert int(st.core.events[EV.LINK_DOWN]) > 0
    assert int(st.core.events[EV.IWANT_RECOVER]) > 0


# ---------------------------------------------------------------------------
# elision


def _flood_states(chaos):
    tnet = nets("lattice", n=N)[1]
    po, pt, pv = (torch.from_numpy(a) for a in schedule(N, 6))
    outs = []
    for step in (lambda s, i: tflood.floodsub_step(tnet, s, po[i], pt[i], pv[i], chaos=chaos),
                 lambda s, i, f=trs.make_randomsub_step(tnet, chaos=chaos):
                 f(s, po[i], pt[i], pv[i])):
        st = TSim.init(N, M, seed=2, k=tnet.max_degree, device="cpu")
        for i in range(6):
            st = step(st, i)
        outs.append(convert.state_leaves(st))
    return outs


def _gossip_states(chaos, r):
    _j, _jn, _js, tcfg, tnet, tsp = bench_builds(n=N, d=4, heartbeat_every=r)
    tcfg = dataclasses.replace(tcfg, chaos=chaos)
    st = TState.init(tnet, M, tcfg, score_params=tsp, seed=3)
    po, pt, pv = (torch.from_numpy(a) for a in schedule(N, 8))
    if r == 1:
        step = make_gossipsub_step(tcfg, tnet, score_params=tsp)
        for i in range(8):
            st = step(st, po[i], pt[i], pv[i])
    else:
        step = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp)
        hb = heartbeat_schedule(r, r)
        for p in range(8 // r):
            sl = slice(p * r, (p + 1) * r)
            st = step(st, po[sl], pt[sl], pv[sl], do_heartbeat=hb[p % len(hb)])
    return convert.state_leaves(st)


@pytest.mark.parametrize("engine", ["sim", "per-round", "phase"])
def test_off_configs_elide_the_plane(engine):
    """None and the two disabled configs give the same leaves in FloodSub,
    RandomSub, the per-round step and the phase engine (r = 4), no chaos
    leaf among them; a disabled scheduled-off config takes no deny row."""
    runs = []
    for kw in OFF_CONFIGS:
        chaos = None if kw is None else TChaos(**kw)
        if engine == "sim":
            runs.append(_flood_states(chaos))
        else:
            runs.append([_gossip_states(chaos, 1 if engine == "per-round" else 4)])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            diff_leaves(a, b, f"{engine} off")
            assert not any("chaos" in p for p in a)
            assert a[".core.events" if ".core.events" in a else ".events"][EV.LINK_DOWN] == 0
