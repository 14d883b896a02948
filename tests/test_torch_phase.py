"""The port's phase engine against the JAX package's, leaf by leaf, after
every phase, and against the port's own per-round step at r=1.

Both sides run the bench's default params (v1.1, live scoring, one topic)
from the same state, carried across with ``convert.state_from_reference``,
on the same numpy-made publish schedule (one invalid publish, one empty
slot), under threefry: every leaf, the f32 score planes included, must be
equal bit for bit. The cells: ring_lattice(96, d=4) at r=8 with events
counted; the bench's K=16 lattice at r=8 without; a random dense net at r=8
with live P3 weights, ``exact_counters`` (the trans and mesh-credit lanes)
and int verdict codes (an ignored publish beside the rejected one); the
K=16 lattice at r=1 with a heartbeat every other round (``do_heartbeat``
both ways); a K=20 lattice, banded but past the fused kernels' K, which
takes the composites. The port runs with ``device="cpu"``, where
``edge_exchange`` and ``select_topk`` take their plain versions. A fresh JAX
state is built for every run: the JAX step donates its buffers."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bench_builds, phase_schedule, phases_against_reference

from go_libp2p_pubsub_tpu import driver as jdriver
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import state as jstate
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import state as tstate
from go_libp2p_pubsub_tpu_torch.models import gossipsub_phase as tphase
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
from go_libp2p_pubsub_tpu_torch.ops import select_topk as tsk

N = 96
ROUNDS = 32
#: live P3 weights (tests/test_phase.py's score params)
P3_LIVE = dict(mesh_message_deliveries_weight=-0.3, mesh_message_deliveries_threshold=3.0,
               mesh_message_deliveries_activation=6.0, mesh_message_deliveries_window=2.0)


def _random_topologies(n):
    return jgraph.random_connect(n, d=3, seed=1), tgraph.random_connect(n, d=3, seed=1)


@pytest.mark.parametrize("cell", ["d4-r8-events", "d8-r8-bench", "random-r8-p3-exact",
                                  "d8-r1-hb2", "d10-r8-k20"])
def test_phase_equals_reference_every_phase(cell):
    kw = {}
    if cell == "d4-r8-events":
        builds, r, he = bench_builds(n=N, d=4, heartbeat_every=8), 8, 8
    elif cell == "d8-r8-bench":
        builds, r, he = bench_builds(n=N, d=8, heartbeat_every=8, count_events=False), 8, 8
    elif cell == "random-r8-p3-exact":
        builds = bench_builds(n=N, heartbeat_every=8, topologies=_random_topologies(N),
                              topic=P3_LIVE)
        r, he, kw = 8, 8, {"exact_counters": True, "codes": True}
    elif cell == "d8-r1-hb2":
        builds, r, he = bench_builds(n=N, d=8, heartbeat_every=2), 1, 2
    else:
        builds, r, he = bench_builds(n=N, d=10, heartbeat_every=8), 8, 8
    tnet = builds[4]
    assert (tnet.band_off is not None) == (cell != "random-r8-p3-exact")
    tsk.reset_launch_counts()
    fr.reset_launch_counts()
    tst = phases_against_reference(builds, r, he, ROUNDS, **kw)
    # CPU tensors: the plain versions ran, no kernel launched
    assert tsk.LAUNCHES["select_topk"] == 0 == fr.LAUNCHES["edge_exchange"]
    leaves = convert.state_leaves(tst)
    assert leaves[".mesh"].sum(-1).min() >= 1
    if builds[0].count_events:
        assert leaves[".core.events"].sum() > 0
    born = leaves[".core.msgs.birth"]
    reach = (leaves[".core.dlv.first_round"] >= 0).sum(0)
    assert (reach[(born >= 8) & (born <= ROUNDS - 4)] > 1).all()


@pytest.mark.parametrize("d", [4, 8])
def test_r1_phase_equals_per_round_step(d):
    """At r=1 with a heartbeat every round the phase step is the per-round
    step (tests/test_phase.py pins the same in the JAX package; with
    ``exact_counters``, since the bench's zero P3 weight otherwise elides
    the in-window mesh credit the per-round step counts): integer,
    bool and word leaves exact, f32 leaves to rtol 1e-5, atol 1e-6. On the
    lattice the per-round step takes fused_delivery, the phase step the
    sender-side exchange."""
    _jcfg, _jnet, _jsp, tcfg, tnet, tsp = bench_builds(n=N, d=d)
    step = make_gossipsub_step(tcfg, tnet, score_params=tsp)
    pstep = tphase.make_gossipsub_phase_step(tcfg, tnet, 1, score_params=tsp,
                                             exact_counters=True)
    a = TState.init(tnet, 64, tcfg, score_params=tsp, seed=3)
    b = TState.init(tnet, 64, tcfg, score_params=tsp, seed=3)
    po, pt, pv = (torch.from_numpy(x) for x in phase_schedule(N, 16))
    for i in range(16):
        a = step(a, po[i], pt[i], pv[i])
        b = pstep(b, po[i:i + 1], pt[i:i + 1], pv[i:i + 1], do_heartbeat=True)
        la, lb = convert.state_leaves(a), convert.state_leaves(b)
        assert sorted(la) == sorted(lb)
        for p in la:
            if la[p].dtype.kind == "f":
                np.testing.assert_allclose(la[p], lb[p], rtol=1e-5, atol=1e-6,
                                           err_msg=f"round {i}: {p}")
            else:
                assert np.array_equal(la[p], lb[p]), f"round {i}: {p}"
    assert int(a.core.tick) == 16 and bool(a.mesh.any())


@pytest.mark.parametrize("r,width,m", [(8, 4, 64), (4, 3, 20), (2, 4, 8)])
def test_pub_plan_equals_reference(r, width, m):
    """PhasePubPlan against the JAX package's on the same table and
    schedule, through a cursor wrap, empty entries, verdict codes
    (accept, reject, ignore, a wire-block flag) and, at r*P > M, slots
    written twice in one phase: the snapshots, masks and publish words."""
    rng = np.random.default_rng(r * 100 + m)
    n = 12
    po = rng.integers(-1, n, size=(r, width)).astype(np.int32)
    pt = rng.integers(0, 3, size=(r, width)).astype(np.int32)
    pv = rng.choice([0, 1, 2, 4, 6], size=(r, width)).astype(np.int32)
    topic = rng.integers(-1, 3, size=m).astype(np.int32)
    origin = rng.integers(-1, n, size=m).astype(np.int32)
    birth = rng.integers(-1, 9, size=m).astype(np.int32)
    valid, ignored = rng.random(m) < 0.5, rng.random(m) < 0.2
    cursor = np.int32(m * 3 - 5)
    jm = jstate.MsgTable(topic=jnp.asarray(topic), origin=jnp.asarray(origin),
                         birth=jnp.asarray(birth), valid=jnp.asarray(valid),
                         ignored=jnp.asarray(ignored), cursor=jnp.asarray(cursor))
    tm = tstate.MsgTable(*(torch.from_numpy(np.asarray(x)) for x in (
        topic, origin, birth, valid, ignored, cursor)))
    jp = jstate.PhasePubPlan(jm, n, jnp.int32(40), jnp.asarray(po), jnp.asarray(pt),
                             jnp.asarray(pv))
    tp = tstate.PhasePubPlan(tm, n, torch.tensor(40, dtype=torch.int32),
                             torch.from_numpy(po), torch.from_numpy(pt), torch.from_numpy(pv))
    u = lambda x: np.asarray(x).view(np.int32) if np.asarray(x).dtype == np.uint32 else x
    for f in ("sidx", "is_pub", "reused", "keep_w", "pub_words", "valid_words",
              "cursor_at"):
        np.testing.assert_array_equal(u(getattr(jp, f)), getattr(tp, f).numpy(), err_msg=f)
    for i in range(r + 1):
        a, b = jp.msgs_at(i), tp.msgs_at(i)
        for f in ("topic", "origin", "birth", "valid", "ignored", "cursor"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(), err_msg=f"{f} at {i}")


def test_admission_tiers():
    _jcfg, _jnet, _jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4)
    st = TState.init(tnet, 16, tcfg, score_params=tsp)
    z = lambda r, p: torch.full((r, p), -1, dtype=torch.int32)
    pv = lambda r, p: torch.ones((r, p), dtype=torch.bool)

    def run(r, p, **kw):
        step = tphase.make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp, **kw)
        return step(st, z(r, p), z(r, p) * 0, pv(r, p), do_heartbeat=False)

    with pytest.raises(tphase.PhaseAdmissionError, match="exceeds msg_slots"):
        run(5, 4)                        # 20 > 16
    with pytest.warns(UserWarning, match="msg_slots//2"):
        run(3, 4)                        # 12 > 8
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert int(run(2, 4).core.tick) == 2          # 8 <= 8: neither
        assert int(run(5, 4, admission_capped=True).core.tick) == 5


def test_refused_options_raise():
    _jcfg, _jnet, _jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4)
    build = lambda cfg, **kw: tphase.make_gossipsub_phase_step(cfg, tnet, 8,
                                                               score_params=tsp, **kw)
    # the per-plane wire form and the count path build and step
    # (tests/test_torch_phase_forms.py holds them to the JAX package)
    po8, pt8, pv8 = (torch.from_numpy(a[:8]) for a in phase_schedule(N, 16))
    st_pp = build(dataclasses.replace(tcfg, wire_coalesced=False))(
        TState.init(tnet, 64, tcfg, score_params=tsp), po8, pt8, pv8, do_heartbeat=True)
    assert int(st_pp.core.tick) == 8
    # PX, edge liveness, the exact-trace plane and the int16 counters build
    # and step in both engines (tests/test_torch_px.py, _trace_exact.py,
    # _narrow.py hold them to the JAX package)
    for field in ("do_px", "edge_liveness", "trace_exact", "narrow_counters"):
        cfg = dataclasses.replace(tcfg, **{field: True})
        st0 = TState.init(tnet, 64, cfg, score_params=tsp)
        po, pt, pv = (torch.from_numpy(a[:8]) for a in phase_schedule(N, 16))
        st = build(cfg)(st0, po, pt, pv, do_heartbeat=True)
        assert int(st.core.tick) == 8
        st = make_gossipsub_step(cfg, tnet, score_params=tsp)(st0, po[0], pt[0], pv[0])
        assert int(st.core.tick) == 1
        assert (st.dup_trans is not None) == (field == "trace_exact")
        assert (st.iasked.dtype == torch.int16) == (field == "narrow_counters")
    # the router plane is ported to the per-round step alone, as in the JAX
    # package (tests/test_torch_router.py): the phase engine refuses a router
    # build with the reference's ValueError; the chaos plane is ported
    # (tests/test_torch_chaos_engines.py)
    from go_libp2p_pubsub_tpu_torch.routers import RouterConfig

    with pytest.raises(ValueError, match="phase engine predates the router plane"):
        build(dataclasses.replace(tcfg, router=RouterConfig(idontwant=True)))
    from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig

    cfg = dataclasses.replace(tcfg, chaos=ChaosConfig(loss_rate=0.2))
    st = build(cfg)(TState.init(tnet, 64, cfg, score_params=tsp), po8, pt8, pv8,
                    do_heartbeat=True)
    assert int(st.core.tick) == 8
    # the queue cap and the validation pipeline are (tests/test_torch_valdelay.py)
    for field in ("queue_cap", "validation_delay_rounds", "validator_timeout_rounds"):
        build(dataclasses.replace(tcfg, **{field: 1}))
    # the attack plane and telemetry are ported (tests/test_torch_adversary.py,
    # _telemetry.py): an invalid config raises at the build, an unset one
    # passes
    from go_libp2p_pubsub_tpu_torch.chaos import AdversaryError, AttackScenario
    from go_libp2p_pubsub_tpu_torch.telemetry import TelemetryConfig, TelemetryConfigError

    for key, bad, err in (("adversary", AttackScenario(n_peers=N, surround_targets=True),
                           AdversaryError),
                          ("telemetry", TelemetryConfig(rows=0), TelemetryConfigError)):
        with pytest.raises(err):
            build(tcfg, **{key: bad})
        build(tcfg, **{key: None})       # unset options pass
    st_cnt = build(tcfg, score_counts=True)(TState.init(tnet, 64, tcfg, score_params=tsp),
                                            po8, pt8, pv8, do_heartbeat=True)
    assert int(st_cnt.core.tick) == 8
    with pytest.raises(TypeError, match="unexpected keyword argument"):
        build(tcfg, fanout=True)
    with pytest.raises(ValueError):
        build(dataclasses.replace(tcfg, edge_layout="csr"))


@pytest.mark.parametrize("he,r", [(1, 1), (2, 1), (8, 8), (3, 2)])
def test_heartbeat_schedule_equals_reference(he, r):
    assert driver.heartbeat_schedule(he, r) == jdriver.heartbeat_schedule(he, r)


def test_build_bench_phase_and_run_phases_on_cpu():
    """build_bench(rounds_per_phase=8): form_mesh, then run_phases over
    whole phases; mesh degrees inside [Dlo, Dhi] after the heartbeats,
    fwd within have, messages spread."""
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    st, step, n_topics, honest = sweep.build_bench(256, 64, rounds_per_phase=8, device="cpu")
    st = driver.form_mesh(step, st, rounds_per_phase=8)
    po, pt, pv = sweep.publish_schedule(24, 256, n_topics, honest)
    st = sweep.run_phases(st, step, po, pt, pv, rounds_per_phase=8, heartbeat_every=8)
    assert int(st.core.tick) == 32
    deg = st.mesh.sum(-1)
    assert int(deg.min()) >= 5 and int(deg.max()) <= 12
    assert not bool((st.core.dlv.fwd & ~st.core.dlv.have).any())
    born = st.core.msgs.birth
    reach = (st.core.dlv.first_round >= 0).sum(0)
    assert bool((reach[(born >= 8) & (born <= 24)] > 8).all())
    with pytest.raises(ValueError, match="whole phases"):
        sweep.run_phases(st, step, po[:5], pt[:5], pv[:5], rounds_per_phase=8,
                         heartbeat_every=8)
