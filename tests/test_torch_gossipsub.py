"""The port's per-round GossipSub step against the JAX package's, leaf by
leaf, every round.

Both sides run the bench's default params (v1.1, live scoring, one topic)
on ring_lattice(96, d=4), at the bench's degree on ring_lattice(96,
d=8), and on ring_lattice(96, d=10), whose K=20 is past the fused
kernels' 16 and takes the composites. The JAX step runs its default XLA
path, which the
JAX package holds bit-identical to its fused Pallas path
(tests/test_fused_round.py); the port always takes the fused data plane,
on the CPU through its plain versions. The port's initial state is carried
across with convert.state_from_reference, and every leaf — integer, bool,
packed word and f32 score planes alike — must be equal bit for bit after
every round: the score arithmetic keeps the JAX operation order, so no
tolerance is needed on any leaf."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bench_builds, diff_leaves, jinit, reference_leaves

from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake
from go_libp2p_pubsub_tpu_torch.perf import sweep as tsweep

ROUNDS = 24
N = 96


def _schedule():
    rng = np.random.default_rng(0)
    po = rng.integers(0, N, size=(ROUNDS, 4)).astype(np.int32)
    pt = np.zeros((ROUNDS, 4), np.int32)
    pv = np.ones((ROUNDS, 4), bool)
    pv[5, 1] = False   # one invalid publish
    po[9, 3] = -1      # and one empty publish slot
    return po, pt, pv


def _case(d, heartbeat_every, static_hb, count_events):
    tag = f"{heartbeat_every}-{static_hb}-{count_events}"
    return pytest.param(d, heartbeat_every, static_hb, count_events,
                        id=tag if d == 4 else f"d{d}-{tag}")


@pytest.mark.parametrize("d,heartbeat_every,static_hb,count_events", [
    _case(4, 1, False, True), _case(4, 1, False, False), _case(4, 2, True, True),
    _case(4, 2, True, False), _case(4, 2, False, True),
    # the bench's K=16: meshes can exceed Dhi, so the heartbeat's
    # oversubscription prune and top-k/random selection over 16 candidates
    # are held against the reference too
    _case(8, 1, False, True),
    # K=20: banded, but past the fused kernels' K <= 16, so the composites
    _case(10, 1, False, True),
])
def test_step_equals_reference_every_round(d, heartbeat_every, static_hb, count_events):
    jcfg, jnet, jsp, tcfg, tnet, tsp = bench_builds(
        n=N, d=d, heartbeat_every=heartbeat_every, count_events=count_events)
    # a fresh JAX state per run: the JAX steps donate their buffers
    jst = jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=0)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    diff_leaves(reference_leaves(jst), convert.state_leaves(tst), "init")
    jstep = jmake(jcfg, jnet, score_params=jsp, static_heartbeat=static_hb)
    tstep = tmake(tcfg, tnet, score_params=tsp, static_heartbeat=static_hb)
    po, pt, pv = _schedule()
    for r in range(ROUNDS):
        kw = ({"do_heartbeat": r % heartbeat_every == 0}
              if static_hb and heartbeat_every > 1 else {})
        jst = jstep(jst, jnp.asarray(po[r]), jnp.asarray(pt[r]), jnp.asarray(pv[r]), **kw)
        tst = tstep(tst, torch.from_numpy(po[r]), torch.from_numpy(pt[r]),
                    torch.from_numpy(pv[r]), **kw)
        diff_leaves(reference_leaves(jst), convert.state_leaves(tst), f"round {r}")
    leaves = convert.state_leaves(tst)
    deg = leaves[".mesh"].sum(-1)
    assert deg.min() >= 1
    if count_events:
        assert leaves[".core.events"].sum() > 0


def test_state_matches_schema_manifest():
    """The port's state tree carries exactly the gossipsub manifest of
    STATE_SCHEMA.json: same 53 paths, dtypes and shapes."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "STATE_SCHEMA.json")) as f:
        schema = json.load(f)
    man = schema["engines"]["gossipsub"]["leaves"]
    n, m = schema["shape"]["n_peers"], schema["shape"]["msg_slots"]
    st, _step, _t, _h = tsweep.build_bench(n, m, device="cpu")
    leaves = convert.state_leaves(st)
    assert len(man) == 53 == len(leaves)
    for leaf in man:
        a = leaves[leaf["path"]]
        dtype = "uint32" if leaf["dtype"] == "key" else leaf["dtype"]
        shape = [2] if leaf["dtype"] == "key" else leaf["shape"]
        assert (str(a.dtype), list(a.shape)) == (dtype, shape), leaf["path"]


def test_reference_state_round_trips():
    _jcfg, jnet, jsp, _tcfg, _tnet, _tsp = bench_builds(n=N, d=4)
    ref = reference_leaves(jinit(JState.init, jnet, 64, _jcfg, score_params=jsp, seed=3))
    diff_leaves(ref, convert.state_leaves(convert.state_from_reference(ref, "cpu")))


def test_bench_loop_on_cpu():
    st, step, n_topics, honest = tsweep.build_bench(256, 64, device="cpu")
    po, pt, pv = tsweep.publish_schedule(20, 256, n_topics, honest)
    st = tsweep.run_rounds(st, step, po, pt, pv)
    assert int(st.core.tick) == 20
    deg = st.mesh.sum(-1)
    assert int(deg.min()) >= 5 and int(deg.max()) <= 12
    assert torch.equal(st.core.dlv.fwd & ~st.core.dlv.have,
                       torch.zeros_like(st.core.dlv.fwd))
    # every message published 4+ rounds ago spread beyond its origin, and
    # each receipt was stamped no earlier than the message's birth
    born = st.core.msgs.birth
    reach = (st.core.dlv.first_round >= 0).sum(0)
    old = (born >= 0) & (born <= 16)
    assert bool(old.any()) and bool((reach[old] > 8).all())
    fr_ = st.core.dlv.first_round
    assert bool(((fr_ < 0) | (fr_ >= born[None, :])).all())


def test_entry_points_refuse_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.build_bench(64, 64)
    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.state import Net

    with pytest.raises(RuntimeError, match="CUDA"):
        Net.build(graph.ring_lattice(64, d=4), graph.subscribe_all(64, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.state_from_reference({})


def test_unported_options_raise():
    import dataclasses

    _jcfg, _jnet, _jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4)
    # PX builds and steps (its parity with the JAX step is
    # tests/test_torch_px.py)
    px_cfg = dataclasses.replace(tcfg, do_px=True)
    st = tmake(px_cfg, tnet, score_params=tsp)(
        TState.init(tnet, 64, px_cfg, score_params=tsp), torch.tensor([3, -1], dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool))
    assert int(st.core.tick) == 1 and torch.equal(st.edge_live, tnet.nbr_ok)
    # dynamic peers, the overlay and announce holes are ported
    # (tests/test_torch_churn.py, _dynamics.py), and so are lifted scores in
    # both engines (tests/test_torch_lift.py), and so are the attack plane
    # and telemetry (tests/test_torch_adversary.py, _telemetry.py), whose
    # invalid configs raise at the build, and so is the router plane
    # (tests/test_torch_router.py), whose delay plane without a ring raises
    # as the reference's does
    from go_libp2p_pubsub_tpu_torch.chaos import AdversaryError, AttackScenario
    from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
    from go_libp2p_pubsub_tpu_torch.score.params import ScoreParams
    from go_libp2p_pubsub_tpu_torch.telemetry import TelemetryConfig, TelemetryConfigError

    for make, kw, err in (
            (tmake, {"link_delay": np.zeros((N, 8), np.int32)}, ValueError),
            (tmake, {"telemetry": TelemetryConfig(rows=0)}, TelemetryConfigError),
            (tmake, {"adversary": AttackScenario(n_peers=N, surround_targets=True)},
             AdversaryError)):
        with pytest.raises(err, match="link_delay" if err is ValueError else None):
            make(tcfg, tnet, score_params=tsp, **kw)
    plane = ScoreParams.from_config(tcfg, tsp, device="cpu")
    st0 = TState.init(tnet, 64, tcfg, score_params=tsp)
    pub = (torch.tensor([3, -1], dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
           torch.ones(2, dtype=torch.bool))
    assert int(tmake(tcfg, tnet, score_params=tsp, lift_scores=True)(
        st0, *pub, plane).core.tick) == 1
    phase = make_gossipsub_phase_step(tcfg, tnet, 8, score_params=tsp, lift_scores=True)
    assert int(phase(st0, *(a.expand(8, 2) for a in pub), plane,
                     do_heartbeat=True).core.tick) == 8
    # the gater needs its parameters
    with pytest.raises(ValueError, match="gater_params"):
        tmake(dataclasses.replace(tcfg, gater_enabled=True), tnet, score_params=tsp)
    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.state import Net

    # CSR, fused and non-banded nets build and step (their parity with the
    # JAX step is tests/test_torch_gossipsub_csr.py); a config whose layout
    # or fused flag differs from the net's is refused
    po = torch.tensor([3, 7, -1, 11], dtype=torch.int32)
    pt = torch.zeros(4, dtype=torch.int32)
    pv = torch.ones(4, dtype=torch.bool)
    for topo, kw in ((graph.ring_lattice(N, d=4), {"edge_layout": "csr"}),
                     (graph.ring_lattice(N, d=4), {"fused": True}),
                     (graph.ring_lattice(N, d=4), {"edge_layout": "csr", "fused": True}),
                     (graph.random_connect(N, d=3, seed=1), {})):
        other = Net.build(topo, graph.subscribe_all(N, 1), device="cpu", **kw)
        cfg = dataclasses.replace(tcfg, **kw)
        step = tmake(cfg, other, score_params=tsp)
        st = TState.init(other, 64, cfg, score_params=tsp)
        for _ in range(3):
            st = step(st, po, pt, pv)
        assert int(st.core.tick) == 3
        assert st.served_lo.dim() == (2 if other.edge_layout == "csr" else 3)
        assert bool((st.mesh.sum(-1) > 0).any())
        for bad in ({"fused": not cfg.fused}, {"edge_layout": "dense" if kw.get(
                "edge_layout") == "csr" else "csr"}):
            with pytest.raises(ValueError, match="same"):
                tmake(dataclasses.replace(cfg, **bad), other, score_params=tsp)
    # integer verdict codes: accept, reject, ignore
    step = tmake(tcfg, tnet, score_params=tsp)
    st = TState.init(tnet, 64, tcfg, score_params=tsp)
    z = torch.zeros(4, dtype=torch.int32)
    st = step(st, z, z, torch.tensor([0, 1, 2, 0], dtype=torch.int32))
    assert st.core.msgs.valid[:4].tolist() == [True, False, False, True]
    assert st.core.msgs.ignored[:4].tolist() == [False, False, True, False]
    st = TState.init(tnet, 64, tcfg, score_params=tsp)
    assert st.mesh.shape == (N, 1, 8)
