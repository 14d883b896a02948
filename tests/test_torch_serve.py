"""The port's supervised service loop (``serve/``) against the JAX
package's, on the CPU: the twins of tests/test_serve.py:155-395 and
:454-606 (the store's twins are ``tests/test_torch_checkpoint.py``'s).

Both packages build the ``_child`` cell (GossipSub under 10% i.i.d. loss,
live scoring, event counters) from the same seeds and supervise it with
the same configs and fault plans. Where the JAX supervisor runs too (the
clean, resumed and NaN-recovered runs here; the retried, degraded and
drained ones in ``test_torch_serve_recovery.py``), the port's final state
equals the JAX one on every leaf (through ``convert``), its
``state_digest`` equals the JAX digest, and the reports agree (segments,
recoveries, retries, the ladder, the bundle's first bad dispatch, its
failures and its NaN census). The port's other runs end in the JAX bare
window's digest, as the JAX runs do in the JAX tests.

Two departures, named: ``window_compiles`` is the capture count (0 on the
CPU, where a window is the plain loop; the JAX runs count one jit entry),
and the retried failures are ``TransientDispatchError`` and the
allocator's out-of-memory error alone (the supervisor's docstring);
another error propagates."""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os

import numpy as np
import pytest
import torch
from torch_parity import diff_leaves, reference_leaves

from go_libp2p_pubsub_tpu import ensemble as jensemble
from go_libp2p_pubsub_tpu import serve as jserve
from go_libp2p_pubsub_tpu.oracle import HealthConfig as JHealth
from go_libp2p_pubsub_tpu.oracle import InvariantConfig as JInv
from go_libp2p_pubsub_tpu.oracle import ScanInvariants as JScan
from go_libp2p_pubsub_tpu.oracle import health_check as jhealth
from go_libp2p_pubsub_tpu.serve import _child as jchild
from go_libp2p_pubsub_tpu_torch import checkpoint, convert
from go_libp2p_pubsub_tpu_torch import ensemble as tensemble
from go_libp2p_pubsub_tpu_torch import serve as tserve
from go_libp2p_pubsub_tpu_torch.oracle import HealthConfig as THealth
from go_libp2p_pubsub_tpu_torch.oracle import InvariantConfig as TInv
from go_libp2p_pubsub_tpu_torch.oracle import ScanInvariants as TScan
from go_libp2p_pubsub_tpu_torch.oracle import health_check as thealth
from go_libp2p_pubsub_tpu_torch.oracle import make_health_probe
from go_libp2p_pubsub_tpu_torch.serve import _child as tchild
from go_libp2p_pubsub_tpu_torch.serve.supervisor import RETRYABLE, overflow_horizon_note

N, ROUNDS, SEG, SEED, LOSS = 32, 16, 4, 7, 0.1
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jserve, JScan, JInv, JHealth), "port": (tserve, TScan, TInv, THealth)}


@functools.lru_cache(maxsize=None)
def cell(side: str):
    if side == "jax":
        return jchild.build_cell(N, ROUNDS, SEED, LOSS)
    return tchild.build_cell(N, ROUNDS, SEED, LOSS, device="cpu")


def spec(side: str, check_every: int = SEG):
    _serve, scan, inv, _h = SIDES[side]
    _s, _m, _t, net, cfg = cell(side)
    return scan("gossipsub", net, cfg, inv(check_every=check_every, delivery_window=16),
                batched=False)


def supervisor(side: str, root, *, invariants: bool = False, plan=None, health="default",
               **svc_kw):
    """One side's Supervisor over its cell: the JAX tests' ``_svc``
    defaults, ``plan`` a dict of FaultPlan fields, ``health`` a dict of
    HealthConfig fields (None: probes off)."""
    serve, _scan, _inv, hcfg = SIDES[side]
    step, make_args, template_fn, _net, _cfg = cell(side)
    svc_kw.setdefault("n_dispatches", ROUNDS)
    svc_kw.setdefault("segment_len", SEG)
    svc_kw.setdefault("report_name", None)
    svc_kw.setdefault("backoff_base_s", 0.001)
    if health != "default":
        svc_kw["health"] = None if health is None else hcfg(**health)
    return serve.Supervisor(step, make_args, template_fn, str(root),
                            serve.ServiceConfig(**svc_kw),
                            invariants=spec(side) if invariants else None,
                            faults=serve.FaultPlan(**plan) if plan is not None else None)


@functools.lru_cache(maxsize=None)
def jax_gold():
    """(leaves, digest) of the JAX bare window over the whole run."""
    step, make_args, template_fn, _net, _cfg = cell("jax")
    run = jensemble.WindowRunner(step, ROUNDS).run(template_fn(), make_args)
    return reference_leaves(run.states), jserve.state_digest(run.states)


def assert_twins(jrep, trep, where: str) -> None:
    """The port's report against the JAX supervisor's: every leaf of the
    final state, the digest and what the runs did."""
    diff_leaves(reference_leaves(jrep.states), convert.state_leaves(trep.states), where)
    assert tserve.state_digest(trep.states) == jserve.state_digest(jrep.states), where
    for f in ("n_dispatches", "rounds", "segments", "segment_rounds", "recoveries",
              "retries", "degradations", "resumed_from", "invariant_checks", "probes"):
        assert getattr(trep, f) == getattr(jrep, f), (where, f)
    assert [e["ordinal"] for e in trep.checkpoints] == [e["ordinal"] for e in jrep.checkpoints]
    assert [e["tick"] for e in trep.checkpoints] == [e["tick"] for e in jrep.checkpoints]
    assert len(trep.bundles) == len(jrep.bundles), where
    for tb, jb in zip(trep.bundles, jrep.bundles):
        for f in ("segment", "start_dispatch", "segment_len", "first_bad_dispatch",
                  "first_bad_tick", "replay_failures", "window_probe_failures", "nan_census",
                  "window_invariants"):
            assert tb[f] == jb[f], (where, f, tb[f], jb[f])
    assert trep.fingerprint() == jrep.fingerprint(), where
    assert set(trep.window_compiles) == set(jrep.window_compiles), where
    assert all(v == 0 for v in trep.window_compiles.values()), trep.window_compiles
    if jrep.ev_totals is None:
        assert trep.ev_totals is None
    else:
        np.testing.assert_array_equal(trep.ev_totals, jrep.ev_totals)


def both(tmp_path, name: str, **kw):
    """The JAX and the port supervisor of one scenario, each run in its own
    directory; returns (jax report, port report)."""
    reps = []
    for side in ("jax", "port"):
        reps.append(supervisor(side, tmp_path / f"{name}-{side}", **kw).run())
    return tuple(reps)


# ---------------------------------------------------------------------------
# probes


def _probe_states():
    """(JAX, port) template states of the cell, the port's carried over
    from the JAX one."""
    jst = cell("jax")[2]()
    return jst, convert.state_from_reference(reference_leaves(jst), device="cpu")


def test_probe_clean_state_passes():
    _jst, tst = _probe_states()
    probe, names = make_health_probe(THealth())
    assert names == ("finite-state", "events-monotone", "delivery-floor")
    assert probe(tst, tst.core.events).all()


@pytest.mark.parametrize("case", ["finite-state", "events-monotone", "delivery-floor"])
def test_probe_negatives_equal_reference(case):
    """Each seeded negative trips what the JAX probe trips (the NaN score
    exactly finite-state; a counter gone backwards events-monotone and
    the floor's negative delta; an unreachable floor exactly the floor)."""
    jst, tst = _probe_states()
    jprev, tprev = jst.core.events, tst.core.events
    jcfg, tcfg = JHealth(), THealth()
    if case == "finite-state":
        jst = jst.replace(scores=jst.scores.at[0, 0].set(np.nan))
        scores = tst.scores.clone()
        scores[0, 0] = float("nan")
        tst = dataclasses.replace(tst, scores=scores)
    elif case == "events-monotone":
        jprev = jprev.at[3].set(10)
        tprev = tprev.clone()
        tprev[3] = 10
    else:
        jcfg, tcfg = JHealth(delivery_floor=10), THealth(delivery_floor=10)
    want = np.asarray(jhealth(jst, jprev, jcfg))
    got = thealth(tst, tprev, tcfg).numpy()
    assert np.array_equal(want, got) and not got.all(), (case, want, got)


# ---------------------------------------------------------------------------
# supervised runs against the JAX supervisor


def test_supervised_clean_run_equals_reference(tmp_path, caplog):
    """Probes and the folded invariants on: the same final state as the JAX
    supervisor and as the JAX bare window; one invariant check a segment;
    the heartbeat done; the horizon note logged at start."""
    with caplog.at_level(logging.INFO, logger="go_libp2p_pubsub_tpu_torch.serve.supervisor"):
        jrep, trep = both(tmp_path, "clean", invariants=True)
    assert_twins(jrep, trep, "clean")
    assert tserve.state_digest(trep.states) == jax_gold()[1]
    assert trep.segments == ROUNDS // SEG and trep.invariant_checks == ROUNDS // SEG
    assert trep.recoveries == trep.retries == 0
    hb = json.load(open(trep.heartbeat_path))
    assert hb["status"] == "done" and hb["dispatch"] == ROUNDS
    assert trep.fingerprint()["enabled"] is True
    assert any("range audit horizons" in r.message for r in caplog.records)


def test_checkpoints_hold_the_state_at_their_boundary(tmp_path):
    """Every snapshot the loop saved restores to the bare window's state at
    its boundary (a save copies the state to the host before the next
    segment's window runs), and the last one to the final state."""
    step, make_args, template_fn, _net, _cfg = cell("port")
    digests = []
    tensemble.WindowRunner(step, ROUNDS, segment_len=SEG).run(
        template_fn(), make_args, on_segment=lambda g, st: digests.append(tserve.state_digest(st)))
    digests.append(jax_gold()[1])
    sup = supervisor("port", tmp_path, invariants=True,
                     retention=tserve.RetentionPolicy(keep_last=ROUNDS // SEG))
    rep = sup.run()
    assert [e["tick"] for e in rep.checkpoints] == [SEG * (g + 1) for g in range(ROUNDS // SEG)]
    got = [tserve.state_digest(checkpoint.restore(os.path.join(sup.store.root, e["file"]),
                                          template_fn())) for e in rep.checkpoints]
    assert got == digests


def test_supervised_probes_off_still_bitexact(tmp_path):
    rep = supervisor("port", tmp_path, health=None).run()
    assert tserve.state_digest(rep.states) == jax_gold()[1]
    assert rep.probes == ()


def test_supervised_resume_midway_equals_reference(tmp_path):
    """A run stopped at its halfway checkpoint and driven on by a fresh
    supervisor, in both packages."""
    reps = []
    for side in ("jax", "port"):
        root = tmp_path / side
        supervisor(side, root, n_dispatches=ROUNDS // 2).run()
        reps.append(supervisor(side, root).run())
    assert_twins(*reps, "resume")
    assert reps[1].resumed_from == ROUNDS // 2
    assert tserve.state_digest(reps[1].states) == jax_gold()[1]


def test_supervised_report_written_incrementally(tmp_path):
    supervisor("port", tmp_path, report_name="service").run()
    rows = [json.loads(x) for x in open(tmp_path / "service.jsonl")]
    assert len(rows) == ROUNDS // SEG and rows[-1]["dispatch"] == ROUNDS
    assert [r["segment"] for r in rows] == list(range(ROUNDS // SEG))
    assert "supervised service loop" in (tmp_path / "service.html").read_text()


def test_nan_injection_recovers_and_localizes_as_reference(tmp_path):
    """A NaN in ``scores`` after dispatch 2 of segment 1: one recovery, the
    bundle names dispatch 6 and the ``.scores`` leaf in both packages, and
    the rerun ends in the bare window's state."""
    jrep, trep = both(tmp_path, "nan", invariants=True,
                      plan=dict(corrupt_segment=1, corrupt_dispatch=2, corrupt_leaf="scores",
                                corrupt_kind="nan"))
    assert_twins(jrep, trep, "nan")
    b = trep.bundles[0]
    assert trep.recoveries == 1 and b["first_bad_dispatch"] == 1 * SEG + 2
    assert "finite-state" in b["window_probe_failures"]
    assert "finite-state" in b["replay_failures"]
    assert b["nan_census"] == {".scores": 1}
    assert os.path.exists(os.path.join(b["path"], "bundle.json"))
    assert np.load(os.path.join(b["path"], "masks.npz"))["invariant_ok"].shape == (1, 1, len(
        spec("port").names))
    assert tserve.state_digest(trep.states) == jax_gold()[1]


def test_events_corruption_trips_monotone_probe(tmp_path):
    rep = supervisor("port", tmp_path, plan=dict(corrupt_segment=2, corrupt_dispatch=1,
                                                 corrupt_kind="events")).run()
    b = rep.bundles[0]
    assert rep.recoveries == 1 and "events-monotone" in b["window_probe_failures"]
    assert b["first_bad_dispatch"] == 2 * SEG + 1
    assert tserve.state_digest(rep.states) == jax_gold()[1]


def test_persistent_corruption_halts_with_bundle(tmp_path):
    sup = supervisor("port", tmp_path, max_recoveries_per_segment=2,
                     plan=dict(corrupt_segment=1, corrupt_kind="nan", corrupt_leaf="scores",
                               corrupt_max_fires=10 ** 9))
    with pytest.raises(tserve.ServiceHalted) as ei:
        sup.run()
    assert ei.value.bundle is not None and "finite-state" in str(ei.value)
    assert ei.value.bundle["first_bad_dispatch"] == 2 * SEG - 1
    assert json.load(open(sup.heartbeat_path))["status"] == "halted"


def test_delivery_floor_violation_halts(tmp_path):
    sup = supervisor("port", tmp_path, health=dict(delivery_floor=10 ** 9),
                     max_recoveries_per_segment=1)
    with pytest.raises(tserve.ServiceHalted, match="delivery-floor"):
        sup.run()


def test_replay_localizes_under_nonzero_delivery_floor(tmp_path):
    """The replay's probe zeroes the per-segment floor: a NaN mid-segment
    under a satisfiable floor is named finite-state at its dispatch."""
    rep = supervisor("port", tmp_path, health=dict(delivery_floor=1),
                     plan=dict(corrupt_segment=1, corrupt_dispatch=2)).run()
    b = rep.bundles[0]
    assert b["first_bad_dispatch"] == 1 * SEG + 2
    assert "finite-state" in b["replay_failures"]
    assert "delivery-floor" not in b["replay_failures"]
    assert tserve.state_digest(rep.states) == jax_gold()[1]


# ---------------------------------------------------------------------------
# configuration and helpers


def test_config_validation_as_reference():
    for kw in (dict(n_dispatches=10, segment_len=4),
               dict(n_dispatches=8, segment_len=4, checkpoint_every_segments=0),
               dict(n_dispatches=0, segment_len=4),
               dict(n_dispatches=8, segment_len=4, drain_event_counters=True,
                    checkpoint_every_segments=2)):
        for serve in (jserve, tserve):
            with pytest.raises(ValueError):
                serve.ServiceConfig(**kw)


def test_invariant_cadence_must_divide_segment(tmp_path):
    step, make_args, template_fn, _net, _cfg = cell("port")
    with pytest.raises(ValueError, match="check_every"):
        tserve.Supervisor(step, make_args, template_fn, str(tmp_path),
                          tserve.ServiceConfig(n_dispatches=ROUNDS, segment_len=SEG),
                          invariants=spec("port", check_every=3))


def test_overflow_horizon_note_equals_reference(tmp_path):
    from go_libp2p_pubsub_tpu.serve.supervisor import overflow_horizon_note as jnote

    for total in (None, 1, 10 ** 12):
        assert overflow_horizon_note(total, repo_root=_REPO) == jnote(total, repo_root=_REPO)
    note = overflow_horizon_note(repo_root=_REPO)
    assert "int32 event counter" in note and "DUPLICATE_MESSAGE" in note
    assert "fits every horizon" in overflow_horizon_note(1, repo_root=_REPO)
    assert "EXCEEDS" in overflow_horizon_note(10 ** 12, repo_root=_REPO)
    assert overflow_horizon_note(repo_root=str(tmp_path)) is None
    (tmp_path / "RANGE_AUDIT.json").write_text("{not json")
    assert overflow_horizon_note(repo_root=str(tmp_path)) is None


def test_corrupt_helpers_raise_typed_errors(tmp_path):
    st = cell("port")[2]()
    for i, damage in enumerate((tserve.truncate_file, lambda p: tserve.flip_bit(p, seed=1),
                                lambda p: tserve.corrupt_leaf_member(p, 0))):
        p = str(tmp_path / f"{i}.npz")
        checkpoint.save(p, st)
        damage(p)
        with pytest.raises(checkpoint.CheckpointCorrupt, match="leaf_0" if i == 2 else None):
            checkpoint.verify(p)


def test_fault_plan_validation_and_budget():
    with pytest.raises(ValueError, match="kill_site"):
        tserve.FaultPlan(kill_site="nope")
    assert tserve.KILL_SITES == jserve.KILL_SITES
    plan = tserve.FaultPlan(fail_dispatches={2: 2})
    for _ in range(2):
        with pytest.raises(tserve.TransientDispatchError):
            plan.before_dispatch(2)
    plan.before_dispatch(2)  # the budget is spent
    plan.before_dispatch(0)  # an unscheduled segment


def test_corruption_writes_a_new_tensor():
    """Every corruption kind leaves the state it was given untouched (a
    window's static buffers on the card) and changes one leaf only."""
    st = cell("port")[2]()
    before = convert.state_leaves(st)
    for kind, leaf in (("nan", ".scores"), ("events", ".core.events")):
        plan = tserve.FaultPlan(corrupt_segment=0, corrupt_dispatch=0, corrupt_kind=kind)
        bad = plan.corrupt_state(st, 0, 0, SEG)
        diff_leaves(before, convert.state_leaves(st), kind)
        after = convert.state_leaves(bad)
        assert [p for p in before if not np.array_equal(before[p], after[p],
                                                        equal_nan=False)] == [leaf]
    with pytest.raises(ValueError, match="dynamic-overlay"):
        tserve.FaultPlan(corrupt_segment=0, corrupt_dispatch=0,
                         corrupt_kind="topo").corrupt_state(st, 0, 0, SEG)
    with pytest.raises(ValueError, match="no floating-point state leaf"):
        tserve.FaultPlan(corrupt_segment=0, corrupt_dispatch=0,
                         corrupt_leaf="nope").corrupt_state(st, 0, 0, SEG)


def test_state_digest_equals_reference_on_a_carried_state():
    """The digest of the port's state carried from a JAX state is the JAX
    digest: the leaves, their order, dtypes and shapes are the v6
    checkpoint's."""
    jst = cell("jax")[2]()
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    assert tserve.state_digest(tst) == jserve.state_digest(jst)
    assert tserve.state_digest(cell("port")[2]()) == jserve.state_digest(jst)
    tst.core.tick.add_(1)
    assert tserve.state_digest(tst) != jserve.state_digest(jst)


def test_cuda_errors_other_than_out_of_memory_are_not_retried(tmp_path):
    """The port's retry rule: an out-of-memory error is retried like a
    transient failure (the segment's state rebuilt from its checkpoint),
    and any other error, such as a sticky CUDA fault, propagates at
    once. The retried set is a constant, not an option."""
    assert RETRYABLE == (tserve.TransientDispatchError, torch.cuda.OutOfMemoryError)

    class Plan(tserve.FaultPlan):
        def __init__(self, exc, **kw):
            super().__init__(**kw)
            self.exc, self.raised = exc, 0

        def before_dispatch(self, segment):
            if segment == 1 and self.raised < 2:
                self.raised += 1
                raise self.exc

    step, make_args, template_fn, _net, _cfg = cell("port")
    svc = tserve.ServiceConfig(n_dispatches=ROUNDS, segment_len=SEG, report_name=None,
                               backoff_base_s=0.001)
    oom = Plan(torch.cuda.OutOfMemoryError("CUDA out of memory (injected)"))
    rep = tserve.Supervisor(step, make_args, template_fn, str(tmp_path / "oom"), svc,
                            faults=oom).run()
    assert rep.retries == 2 and oom.raised == 2
    assert tserve.state_digest(rep.states) == jax_gold()[1]
    sticky = Plan(RuntimeError("CUDA error: an illegal memory access was encountered"))
    sup = tserve.Supervisor(step, make_args, template_fn, str(tmp_path / "sticky"), svc,
                            faults=sticky)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sup.run()
    assert sticky.raised == 1
