"""Three parameters of the JAX package's entry points, at its positions
and with its defaults, held against it: FloodSub's ``stacked`` switch
(``floodsub_step(..., queue_cap, stacked, chaos, ...)``), the P5 plane of
``GossipSubState.init(..., seed, app_score, dormant, ...)`` and the
verdict dtype of ``driver.form_mesh(..., pv_dtype=)``. Every comparison
is bit for bit; the port runs on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    bench_builds,
    diff_leaves,
    jinit,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import driver as jdriver
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim

N = 32


def _sim_nets(seed=1):
    """The JAX stacked test's net: random_connect(32, 6), two topics, one a
    peer."""
    js = jgraph.subscribe_random(N, n_topics=2, topics_per_peer=1, seed=seed)
    ts = tgraph.Subscriptions(*(np.asarray(getattr(js, f)) for f in (
        "subscribed", "my_topics", "slot_of")))
    return (JNet.build(jgraph.random_connect(N, 6, seed=seed), js),
            TNet.build(tgraph.random_connect(N, 6, seed=seed), ts, device="cpu"))


@pytest.mark.parametrize("queue_cap,val_delay", [(0, 0), (2, 2)])
def test_floodsub_stacked_equals_reference(queue_cap, val_delay):
    """The twin of the JAX package's tests/test_phase_stacked.py:204-225:
    both ``stacked`` values give the same state, equal to the JAX step's
    leaf for leaf every round, the switch passed by keyword."""
    jnet, tnet = _sim_nets()
    rng = np.random.default_rng(2)
    po_all = rng.integers(0, N, size=(10, 2)).astype(np.int32)
    po_all[6:] = -1
    outs = []
    for stacked in (True, False):
        jst = jinit(JSim.init, N, 16, seed=2, k=jnet.max_degree, val_delay=val_delay)
        tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
        for i in range(10):
            pt = np.full((2,), i % 2, np.int32)
            jst = jflood.floodsub_step(jnet, jst, jnp.asarray(po_all[i]), jnp.asarray(pt),
                                       jnp.ones((2,), bool), queue_cap=queue_cap,
                                       stacked=stacked)
            tst = tflood.floodsub_step(tnet, tst, torch.from_numpy(po_all[i]),
                                       torch.from_numpy(pt), torch.ones((2,), dtype=torch.bool),
                                       queue_cap=queue_cap, stacked=stacked)
            diff_leaves(reference_leaves(jst), convert.state_leaves(tst),
                        f"stacked={stacked} round {i}")
        outs.append(convert.state_leaves(tst))
    diff_leaves(outs[0], outs[1], "stacked against per-plane")


def test_floodsub_positional_call_in_the_reference_order():
    """``(net, state, po, pt, pv, queue_cap, stacked, chaos, link_deny)``
    positionally: ``stacked`` lands in its place, so a positional False is
    the per-plane clears and ``chaos`` stays None, as in the JAX step."""
    jnet, tnet = _sim_nets(seed=4)
    jst = jinit(JSim.init, N, 16, seed=4, k=jnet.max_degree)
    tst = TSim.init(N, 16, seed=4, k=tnet.max_degree, device="cpu")
    po = np.array([3, 9], np.int32)
    pt = np.zeros((2,), np.int32)
    for _ in range(4):
        jst = jflood.floodsub_step(jnet, jst, jnp.asarray(po), jnp.asarray(pt),
                                   jnp.ones((2,), bool), 1, False, None, None)
        tst = tflood.floodsub_step(tnet, tst, torch.from_numpy(po), torch.from_numpy(pt),
                                   torch.ones((2,), dtype=torch.bool), 1, False, None, None)
    diff_leaves(reference_leaves(jst), convert.state_leaves(tst), "positional")


def test_gossipsub_state_app_score_equals_reference():
    """``app_score`` at its place (after ``seed``, before ``dormant``) and
    by keyword: the port's initial state equals the JAX one with the same
    random [N] plane; then 10 scored rounds with P5's weight live on a
    random dense net equal the JAX rounds leaf for leaf (P5's wrap-row
    tolerance belongs to the banded ring and is not needed here)."""
    peer = dict(app_specific_weight=0.7)
    topologies = jgraph.random_connect(N, 5, seed=2), tgraph.random_connect(N, 5, seed=2)
    builds = bench_builds(n=N, topologies=topologies, peer=peer)
    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    app = (np.random.default_rng(3).standard_normal(N) * 4).astype(np.float32)
    dormant = np.zeros(tuple(tnet.nbr.shape), bool)
    want = reference_leaves(jinit(JState.init, jnet, 64, jcfg, jsp, 5, app, dormant))
    diff_leaves(want, convert.state_leaves(TState.init(tnet, 64, tcfg, tsp, 5, app, dormant)),
                "positional init")
    diff_leaves(want, convert.state_leaves(TState.init(tnet, 64, tcfg, score_params=tsp,
                                                       seed=5, app_score=app)), "keyword init")
    assert not convert.state_leaves(TState.init(tnet, 64, tcfg))[".app_score"].any()
    # the telemetry panel is ported (tests/test_torch_telemetry.py): an
    # invalid config raises before the state is built
    from go_libp2p_pubsub_tpu_torch.telemetry import TelemetryConfig, TelemetryConfigError

    with pytest.raises(TelemetryConfigError):
        TState.init(tnet, 64, tcfg, telemetry=TelemetryConfig(rows=0))
    assert TState.init(tnet, 64, tcfg, telemetry=TelemetryConfig(rows=3)).core.telem.panel.shape[0] == 3
    st = rounds_against_reference(builds, 10, app_score=app)
    assert float(st.scores.abs().max()) > 0


@pytest.mark.parametrize("pv_dtype", ["bool", "int32"])
def test_form_mesh_verdict_dtype_equals_reference(pv_dtype):
    """The pattern of the JAX package's tests/test_trace_exact.py:320:
    ``form_mesh(..., pv_dtype=)`` then phases whose verdicts are of that
    dtype (int verdict codes, one a reject), every leaf against the JAX
    ``form_mesh`` and phase step."""
    r = 4
    builds = bench_builds(n=N, d=3, heartbeat_every=r)
    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    jst = jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=0)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    jstep = jmake(jcfg, jnet, r, score_params=jsp)
    tstep = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp)
    jdt, tdt = (jnp.bool_, torch.bool) if pv_dtype == "bool" else (jnp.int32, torch.int32)
    jst = jdriver.form_mesh(jstep, jst, rounds_per_phase=r, pub_width=3, pv_dtype=jdt)
    tst = driver.form_mesh(tstep, tst, rounds_per_phase=r, pub_width=3, pv_dtype=tdt)
    diff_leaves(reference_leaves(jst), convert.state_leaves(tst), "form_mesh")
    rng = np.random.default_rng(1)
    for p in range(3):
        po = rng.integers(0, N, size=(r, 3)).astype(np.int32)
        pt = np.zeros((r, 3), np.int32)
        pv = np.zeros((r, 3), np.int32) if pv_dtype == "int32" else np.ones((r, 3), bool)
        pv[1, 1] = 1 if pv_dtype == "int32" else False
        jst = jstep(jst, jnp.asarray(po), jnp.asarray(pt), jnp.asarray(pv), do_heartbeat=True)
        tst = tstep(tst, torch.from_numpy(po), torch.from_numpy(pt), torch.from_numpy(pv),
                    do_heartbeat=True)
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"phase {p}")
