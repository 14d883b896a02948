"""The chaos plane through the port's run windows, checkpoint and trace
drain, against the JAX package's: a scheduled GE phase engine driven by
``driver.make_scan(..., link_deny=)`` and ``make_window`` with the deny
rows as ``xs`` equals its eager loop and the JAX window; a GE run
checkpointed inside a partition restores (from the port's file and from
the JAX package's) and continues equal to the uninterrupted JAX run, and
the JAX package restores the port's file too; a traced chaos run writes
the JAX package's trace bytes. The port runs on the CPU; a fresh JAX state
is built for every run (the JAX steps donate their buffers)."""

from __future__ import annotations

import jax.numpy as jnp
import torch
from test_torch_chaos_sched import deny_rows
from test_torch_trace import _both, _gossip_run
from torch_parity import bench_builds, diff_leaves, jinit, phase_schedule, reference_leaves

from go_libp2p_pubsub_tpu import checkpoint as jck
from go_libp2p_pubsub_tpu import driver as jdriver
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake_phase
from go_libp2p_pubsub_tpu_torch import checkpoint as tck
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState as TState
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.trace.events import EV

N = 48
GE_SCHEDULED = dict(generator="ge", ge_p_down=0.2, ge_p_up=0.4, scheduled=True)


def test_window_with_deny_rows_equals_eager_and_reference():
    """The phase engine at r = 8 under a GE generator and a partition of
    rounds 8-23: ``make_scan(..., link_deny=)`` (one row a phase, the
    head's) and ``make_window`` with the rows as xs equal the eager loop
    and the JAX package's ``driver.make_window`` on the same xs, every
    leaf."""
    r, rounds = 8, 32
    builds = bench_builds(n=N, d=3, heartbeat_every=r, chaos=GE_SCHEDULED)
    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    deny = deny_rows(N, tnet.nbr.numpy(), rounds, 8, 16)
    po, pt, pv = phase_schedule(N, rounds)
    grouped = [a.reshape((rounds // r, r) + a.shape[1:]) for a in (po, pt, pv)]
    jst = jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=0)
    assert jst.core.chaos is not None
    init = reference_leaves(jst)
    jwin = jdriver.make_window(jmake_phase(jcfg, jnet, r, score_params=jsp), heartbeat=[True])
    jst, _ = jwin(jst, tuple(jnp.asarray(a) for a in grouped + [deny[::r]]))
    want = reference_leaves(jst)

    step = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp)
    assert step.rows == ("link_deny",)
    fresh = lambda: convert.state_from_reference(init, device="cpu")
    eager = fresh()
    for p in range(rounds // r):
        eager = step(eager, *(torch.from_numpy(a[p]) for a in grouped),
                     torch.from_numpy(deny[p * r]), do_heartbeat=True)
    diff_leaves(want, convert.state_leaves(eager), "eager")
    scan = driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r)
    got = scan(fresh(), *(torch.from_numpy(a) for a in (po, pt, pv)),
               link_deny=torch.from_numpy(deny))
    diff_leaves(want, convert.state_leaves(got), "make_scan")
    got, _ = driver.make_window(step, heartbeat=[True])(
        fresh(), tuple(torch.from_numpy(a) for a in grouped + [deny[::r]]))
    diff_leaves(want, convert.state_leaves(got), "make_window")
    assert int(got.core.events[EV.LINK_DOWN]) > 0
    # form_mesh hands a scheduled step its all-False deny row
    formed = driver.form_mesh(step, fresh(), rounds_per_phase=r)
    assert int(formed.core.tick) == r


def test_ge_checkpoint_mid_partition_resumes_exact_fault_stream(tmp_path):
    """The per-round step under a GE generator and a partition of rounds
    4-15 (the JAX package's tests/test_chaos.py:356-390 shape): checkpoints
    at round 8, inside the cut, of both packages; the port restores its own
    file and the JAX package's, the JAX package the port's, and each run
    continued to round 20 equals the uninterrupted JAX run on every leaf,
    ``core.chaos.ge_bad`` included."""
    builds = bench_builds(n=N, d=3, chaos=GE_SCHEDULED)
    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    deny = deny_rows(N, tnet.nbr.numpy(), 20, 4, 12)
    po, pt, pv = phase_schedule(N, 20)
    jstep = jmake(jcfg, jnet, score_params=jsp)
    tstep = tmake(tcfg, tnet, score_params=tsp)

    def jdrive(st, t0, t1):
        for t in range(t0, t1):
            st = jstep(st, *(jnp.asarray(a[t]) for a in (po, pt, pv, deny)))
        return st

    def tdrive(st, t0, t1):
        for t in range(t0, t1):
            st = tstep(st, *(torch.from_numpy(a[t]) for a in (po, pt, pv, deny)))
        return st

    jtemplate = lambda: jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=3)
    ttemplate = lambda: TState.init(tnet, 64, tcfg, score_params=tsp, seed=3)
    diff_leaves(reference_leaves(jtemplate()), convert.state_leaves(ttemplate()), "init")
    jmid = jdrive(jtemplate(), 0, 8)
    jck.save(str(tmp_path / "jax.npz"), jmid)
    want = reference_leaves(jdrive(jmid, 8, 20))
    tmid = tdrive(ttemplate(), 0, 8)
    tck.save(str(tmp_path / "port.npz"), tmid)
    assert tck.verify(str(tmp_path / "port.npz"))["n_leaves"] == len(convert.leaf_specs(tmid))
    for name in ("port", "jax"):
        st = tck.restore(str(tmp_path / f"{name}.npz"), ttemplate())
        diff_leaves(convert.state_leaves(tmid), convert.state_leaves(st), f"{name} file")
        diff_leaves(want, convert.state_leaves(tdrive(st, 8, 20)), f"resumed from {name}")
    jst = jck.restore(str(tmp_path / "port.npz"), jtemplate())
    diff_leaves(want, reference_leaves(jdrive(jst, 8, 20)), "JAX resumed from the port")
    assert want[".core.chaos.ge_bad"].any()


def test_traced_chaos_run_writes_the_reference_bytes(tmp_path):
    """The per-round step on the lattice under i.i.d. flaps through both
    packages' trace sessions: the JSON, protobuf and collector bytes equal,
    and the counter-only LINK_DOWN and IWANT_RECOVER totals equal the
    device counters."""
    builds = bench_builds(n=N, d=3, chaos=dict(loss_rate=0.35))
    snap, sess, _evs = _both(tmp_path, *_gossip_run(builds, 12))
    counts = sess.counter_events(snap)
    assert counts["LINK_DOWN"] == int(snap.events[EV.LINK_DOWN]) > 0
    assert counts["IWANT_RECOVER"] == int(snap.events[EV.IWANT_RECOVER])
