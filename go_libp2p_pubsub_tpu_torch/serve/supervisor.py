"""The supervised service loop (the JAX package's ``serve/supervisor.py``):
a long run driven as checkpointed segments that survives crashes,
corruption and failed dispatches.

``ensemble.WindowRunner`` runs a segment as one window call (on the card
a captured CUDA graph replayed a block at a time). This module wraps it in
what a multi-hour run needs:

  * **pipeline**: segment k's window is enqueued on the card, and segment
    k+1's stacked rows are made on the host while it runs; the segment's
    one host sync is the probe and verdict readback at its boundary. The
    segment length is the checkpoint quantum.
  * **durability**: rolling checksummed v6 checkpoints through
    :class:`serve.store.CheckpointStore` (atomic writes, retention, a
    manifest). A ``kill -9`` anywhere, mid-write included, resumes
    bit-exact, because the resume replays from the last committed
    snapshot.
  * **detection and recovery**: the ``oracle.probes`` health probes
    (finite floats, monotone counters, a delivery floor) run at every
    segment boundary beside the window-folded invariant checker. On a
    violation the loop rolls back to the last good state and replays the
    segment dispatch by dispatch (checking every ``replay_check_every``)
    to find the first violating dispatch, writes a forensic bundle (the
    verdicts, the NaN census, the telemetry rows), and reruns the segment
    (a transient corruption then ends bit-exact) or halts with the bundle
    once the segment's recovery budget is spent.
  * **retry and degradation**: a failed dispatch is retried with
    exponential backoff and jitter; past the budget the loop degrades
    (halves the segment, then drops the observers) before it stops.
    Rounds are never dropped.
  * **liveness**: an atomically rewritten ``HEARTBEAT.json`` and a report
    (jsonl and a self-contained HTML page) written segment by segment.

With probes, invariants and observers off, a supervised run runs the bare
``WindowRunner``'s windows, and a clean supervised run ends in the bare
window's state bit for bit.

Where the port departs from the JAX package:

  * **Which failures are retried.** The JAX package retries
    ``TransientDispatchError`` and XLA's ``JaxRuntimeError``. On the card
    most CUDA errors are sticky (the context is lost, so a retry cannot
    succeed), so the port retries ``TransientDispatchError`` and
    ``torch.cuda.OutOfMemoryError`` only, emptying the allocator's cache
    before an out-of-memory retry (the ladder's shorter windows need less
    memory). Every other error, a kernel's build or launch failure
    included, propagates and the run fails.
  * **Donated windows alias their state.** On the card a window returns
    its capture's own state buffers, and its next replay overwrites them
    (JAX arrays are immutable, so the JAX loop needs no care). So the
    counters snapshot is a clone, the forensic evidence (NaN census,
    telemetry rows, verdicts) is read from the bad state before the
    rollback replays anything, a fault writes a new tensor, and a
    checkpoint's device-to-host copy ends before the next segment is
    enqueued (``checkpoint.save`` copies leaf by leaf, synchronously): the
    only host work the loop overlaps with a running window is stacking
    the next segment's rows, which reads no state.
  * **Compiles are captures.** ``window_compiles`` is the growth of each
    runner's ``Window.captures``: one per window shape on the card, 0 on
    the CPU, where a window is the plain loop.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import os
import random
import time

import numpy as np
import torch

from .. import checkpoint as _ckpt
from .. import convert
from ..driver import _core_of, _leaves, _rebuild
from ..ensemble.runner import WindowRunner, _sync
from ..oracle import invariants as _oinv
from ..oracle.probes import HealthConfig, make_health_probe
from .faults import TransientDispatchError, state_paths
from .store import CheckpointStore, RetentionPolicy, write_json_atomic

_log = logging.getLogger(__name__)

#: the failures a dispatch is retried on; every other error, a sticky CUDA
#: fault included, propagates (module docstring)
RETRYABLE = (TransientDispatchError, torch.cuda.OutOfMemoryError)


class ServiceError(RuntimeError):
    """Base class for supervised-loop failures."""


class ServiceHalted(ServiceError):
    """The loop stopped without completing: the recovery or degradation
    budget is spent. ``bundle`` is the last forensic bundle (a dict with
    its on-disk ``path``) when a health violation caused the halt."""

    def __init__(self, msg: str, bundle: dict | None = None):
        super().__init__(msg)
        self.bundle = bundle


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """The supervised run's shape and policies. ``n_dispatches`` is the
    whole run in engine dispatches (rounds = n_dispatches x
    rounds_per_dispatch); ``segment_len`` is the checkpoint quantum in
    dispatches and must divide ``n_dispatches``."""

    n_dispatches: int
    segment_len: int
    rounds_per_dispatch: int = 1
    health: HealthConfig | None = HealthConfig()
    retention: RetentionPolicy = RetentionPolicy()
    #: checkpoint every k committed segments (1 = every boundary)
    checkpoint_every_segments: int = 1
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.25
    max_recoveries_per_segment: int = 2
    #: localisation cadence of the rollback replay (1 = every dispatch)
    replay_check_every: int = 1
    degrade: bool = True
    report_name: str | None = "service"
    #: drain the int32 event counters into a host int64 total at every
    #: committed segment boundary and zero them on the device, so a counter
    #: never holds more than one segment's growth however long the service
    #: runs (RANGE_AUDIT.json's overflow horizons then bound a segment, not
    #: the run). The totals ride the checkpoint's meta and come back on
    #: resume. Off by default: a drained run's counters differ from a bare
    #: window's.
    drain_event_counters: bool = False

    def __post_init__(self):
        if self.n_dispatches < 1 or self.segment_len < 1:
            raise ValueError("n_dispatches and segment_len must be >= 1")
        if self.n_dispatches % self.segment_len:
            raise ValueError(
                f"segment_len {self.segment_len} does not divide the "
                f"{self.n_dispatches}-dispatch run")
        if self.checkpoint_every_segments < 1:
            raise ValueError("checkpoint_every_segments must be >= 1")
        if self.drain_event_counters and self.checkpoint_every_segments != 1:
            raise ValueError(
                "drain_event_counters needs checkpoint_every_segments=1: a "
                "fast-forward through undrained boundaries would count the "
                "drained totals twice")


@dataclasses.dataclass
class ServiceReport:
    """What one :meth:`Supervisor.run` did. ``window_compiles`` maps each
    window shape (segment length) to its capture count."""

    states: object
    n_dispatches: int
    rounds: int
    segments: int
    segment_rounds: int
    seconds: float
    recoveries: int
    retries: int
    degradations: list
    resumed_from: int | None
    window_compiles: dict
    checkpoints: list
    heartbeat_path: str
    invariant_checks: int
    probes: tuple
    retention: RetentionPolicy
    bundles: list
    #: the stacked per-dispatch observe() tree ([D, ...] numpy leaves) over
    #: the committed dispatches, or None without an observer (a rolled-back
    #: segment's observations go with it)
    observations: object = None
    #: [N_EVENTS] np.int64 drained event totals over the whole run (the
    #: counters a bare run holds on the device, summed on the host past the
    #: int32 horizon), or None when ``drain_event_counters`` is off
    ev_totals: object = None

    def fingerprint(self) -> dict:
        """The schema-v3 ``fingerprint["service"]`` block
        (``perf/artifacts.service_fingerprint``)."""
        from ..perf.artifacts import service_fingerprint

        return service_fingerprint(
            segment_rounds=self.segment_rounds,
            keep_last=self.retention.keep_last,
            keep_every=self.retention.keep_every,
            probes=self.probes,
            recoveries=self.recoveries,
            segments=self.segments,
            resumes=0 if self.resumed_from is None else 1,
        )


def _with_events(st, ev):
    """The state with its event counter vector replaced (a GossipSub state
    nests it under ``.core``)."""
    core = dataclasses.replace(_core_of(st), events=ev)
    return dataclasses.replace(st, core=core) if hasattr(st, "core") else core


def state_digest(state) -> str:
    """SHA-256 over the state's leaves as the v6 checkpoint writes them
    (``convert.state_leaves``: the JAX tree's order and dtypes, word planes
    ``uint32``, the key its two ``uint32`` words), each leaf's dtype and
    shape strings then its bytes: the JAX package's ``state_digest`` of the
    same state, so a digest compares across processes and packages."""
    h = hashlib.sha256()
    for arr in convert.state_leaves(state).values():
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def overflow_horizon_note(total_rounds: int | None = None,
                          repo_root: str | None = None) -> str | None:
    """One startup line from the committed range audit
    (``RANGE_AUDIT.json``): the tightest proven int32 event-counter horizon
    and its float32 telemetry-exactness analogue, against the planned run
    length when given. Reads the JSON file itself; None when it is absent
    or malformed (a missing audit never blocks serving)."""
    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        with open(os.path.join(root, "RANGE_AUDIT.json")) as f:
            horizons = json.load(f)["horizons"]
        active = [(name, row) for name, row in horizons["events"].items()
                  if row["i32_horizon_rounds"] is not None]
        if not active:
            return None
        i32_name, i32_row = min(active, key=lambda kv: kv[1]["i32_horizon_rounds"])
        f32_name, f32_row = min(active, key=lambda kv: kv[1]["f32_exact_horizon_rounds"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
    i32_h = int(i32_row["i32_horizon_rounds"])
    f32_h = int(f32_row["f32_exact_horizon_rounds"])
    note = (
        f"range audit horizons: tightest int32 event counter is {i32_name} "
        f"at {i32_h} rounds (per-round delta bound "
        f"{int(i32_row['per_round_delta_hi'])}); f32 telemetry columns stay "
        f"exact to {f32_name} at {f32_h} rounds"
    )
    if total_rounds is not None:
        worst = min(i32_h, f32_h)
        note += (f"; planned {int(total_rounds)} rounds "
                 + ("fits every horizon" if total_rounds <= worst else
                    f"EXCEEDS the {worst}-round horizon — drain counters "
                    "(trace.drain.counter_events) within that window"))
    return note


def _failing(mask, names, prefix: str = "") -> list:
    """The names of the properties a ``[..., P]`` verdict mask fails."""
    flat = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    flat = flat.reshape(-1, flat.shape[-1])
    return [prefix + names[k] for k in np.nonzero(~flat.all(axis=0))[0]]


class Supervisor:
    """Drive a long run as supervised checkpoint-quantum segments.

    * ``step``: the per-dispatch engine step (``make_*_step``).
    * ``make_args(i)``: the per-dispatch positional tensors after the state
      (``ensemble.run_rounds``' contract).
    * ``template_fn()``: a fresh initial state (same configs, topology and
      seed every call): the cold start and the checkpoint restore template.
    * ``root``: the service directory: ``checkpoints/`` (the store),
      ``HEARTBEAT.json``, ``<report_name>.jsonl``/``.html``,
      ``forensics/``.
    * ``heartbeat_fn(i)``: the static cadence flags by global dispatch
      (periodic, the period dividing ``segment_len``); ``invariants`` an
      ``oracle.ScanInvariants`` of this engine (``check_every`` dividing
      ``segment_len``); ``observe`` a device function folded per dispatch.
    * ``faults``: a ``serve.faults.FaultPlan`` (tests and smoke runs only).

    A dispatch is retried on ``RETRYABLE`` only (module docstring).
    """

    def __init__(self, step, make_args, template_fn, root: str,
                 svc: ServiceConfig, *, heartbeat_fn=None, invariants=None,
                 observe=None, faults=None):
        self.step = step
        self.make_args = make_args
        self.template_fn = template_fn
        self.root = str(root)
        self.svc = svc
        self.heartbeat_fn = heartbeat_fn
        self.invariants = invariants
        self.observe = observe
        self.faults = faults
        os.makedirs(self.root, exist_ok=True)
        self._cur_segment = -1
        hook = (faults.store_hook(lambda: self._cur_segment)
                if faults is not None else None)
        self.store = CheckpointStore(os.path.join(self.root, "checkpoints"), svc.retention,
                                     write_hook=hook)
        if svc.health is not None:
            self._probe, self._probe_names = make_health_probe(svc.health)
        else:
            self._probe, self._probe_names = None, ()
        self._replay_probe = None  # built at the first rollback
        if invariants is not None and svc.segment_len % invariants.check_every:
            raise ValueError(
                f"invariant check_every {invariants.check_every} must "
                f"divide segment_len {svc.segment_len}")
        self._seg_len = int(svc.segment_len)
        self._runners: dict = {}
        self._captures_base: dict = {}
        self._degradations: list = []
        self._bundles: list = []
        self._rows: list | None = None  # report rows (the jsonl read once)
        self._segments_run = self._recoveries = self._retries = 0

    # -- window plumbing ------------------------------------------------

    def _runner_for(self, L: int) -> WindowRunner:
        key = (L, self.observe is not None)
        runner = self._runners.get(key)
        if runner is None:
            runner = WindowRunner(
                self.step, L, rounds_per_phase=self.svc.rounds_per_dispatch,
                heartbeat_fn=self.heartbeat_fn, invariants=self.invariants,
                observe=self.observe, unroll=1)
            self._runners[key] = runner
            self._captures_base[key] = runner.window.captures
        return runner

    def window_compiles(self) -> dict:
        """Captures per window shape since its runner was made (one on the
        card, 0 on the CPU)."""
        return {f"L{key[0]}" + ("+obs" if key[1] else ""):
                runner.window.captures - self._captures_base[key]
                for key, runner in self._runners.items()}

    def _due_row(self, tick: int) -> np.ndarray:
        spec = self.invariants
        return np.asarray(spec.due_fn(tick) if spec.due_fn is not None
                          else _oinv.due_vector(), np.int32)

    def _segment_due(self, start: int, L: int):
        """The due rows of dispatches [start, start+L) at the run's global
        ticks (the supervisor owns the schedule), and those ticks."""
        spec = self.invariants
        if spec is None:
            return None, ()
        ce = spec.check_every
        rows, ticks = [], []
        for j in range(L):
            if (j + 1) % ce:
                continue
            tick = (start + j + 1) * self.svc.rounds_per_dispatch
            rows.append(self._due_row(tick))
            ticks.append(tick)
        due = torch.as_tensor(np.stack(rows) if rows
                              else np.zeros((0, _oinv.DUE_LEN), np.int32),
                              device=spec.device)
        return due, tuple(ticks)

    def _step_once(self, st, i: int):
        """One engine step at global dispatch ``i``: the rollback replay's
        unit, equal to the window's body."""
        args = tuple(self.make_args(i))
        kw = {}
        if self.heartbeat_fn is not None:
            kw["do_heartbeat"] = bool(self.heartbeat_fn(i))
        return self.step(st, *args, **kw)

    # -- state reconstruction -------------------------------------------

    def _state_at(self, start: int):
        """The state at dispatch boundary ``start``: the newest usable
        checkpoint at or before it, run forward through the same windows
        when the checkpoint cadence is sparser than the target."""
        rps = self.svc.rounds_per_dispatch
        st, d0 = None, 0
        entries = self.store.entries()
        while entries:
            e = entries[-1]
            d = int(e.get("meta", {}).get("dispatch", e["tick"] // rps))
            if d > start:
                entries.pop()
                continue
            try:
                st = _ckpt.restore(os.path.join(self.store.root, e["file"]),
                                   self.template_fn())
                d0 = d
                break
            except (_ckpt.CheckpointCorrupt, FileNotFoundError) as err:
                _log.warning("rollback: snapshot ordinal %d unusable (%s)",
                             e["ordinal"], err)
                entries.pop()
        if st is None:
            st, d0 = self.template_fn(), 0
        while d0 < start:
            L = min(self._seg_len, start - d0)
            runner = self._runner_for(L)
            xs = runner.stack_args(self.make_args, d0, d0 + L)
            due, _ = self._segment_due(d0, L)
            st, _ys = runner.dispatch(st, xs, due)
            d0 += L
        return st

    # -- dispatch with retry and degradation -----------------------------

    def _dispatch_retrying(self, seg: int, start: int, L: int, states, xs, due):
        """One segment's window call through the fault seam, with backoff
        retries and the degradation ladder. Returns ``(states, ys,
        retries, degraded)``; ``degraded`` means the shape changed and the
        caller rebuilds the segment."""
        svc = self.svc
        retries = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.before_dispatch(seg)
                out, ys = self._runner_for(L).dispatch(states, xs, due)
                return out, ys, retries, False
            except RETRYABLE as e:
                retries += 1
                if not isinstance(e, TransientDispatchError):
                    # out of memory: the window may have started and
                    # written its state buffers, so the segment's entry
                    # state is rebuilt, after the cache is released
                    if torch.cuda.is_available():
                        torch.cuda.empty_cache()
                    states = self._state_at(start)
                if retries <= svc.max_retries:
                    delay = (svc.backoff_base_s
                             * svc.backoff_factor ** (retries - 1)
                             * (1.0 + svc.backoff_jitter * random.random()))
                    _log.warning("segment %d dispatch failed (%s): retry %d/%d in %.3fs",
                                 seg, e, retries, svc.max_retries, delay)
                    time.sleep(delay)
                    continue
                # the budget is spent: degrade before giving up, never
                # drop rounds
                if svc.degrade and self._try_degrade(L):
                    return states, None, retries, True
                # a monitor must see this death, not a stale 'running'
                self._heartbeat(start, "halted")
                raise ServiceHalted(
                    f"segment {seg}: dispatch failed {retries} times and "
                    f"the degradation ladder is exhausted: {e}") from e

    def _try_degrade(self, L: int) -> bool:
        """One rung down: halve the segment while the heartbeat period and
        the check cadence allow, then drop the observers. True when a rung
        was taken (the caller rebuilds the segment)."""
        period = 1
        if self.heartbeat_fn is not None:
            from ..driver import min_cycle

            period = len(min_cycle(self.heartbeat_fn(i) for i in range(self._seg_len)))
        ce = self.invariants.check_every if self.invariants is not None else 1
        block = math.lcm(period, ce)
        half = self._seg_len // 2
        if half >= block and half % block == 0:
            self._seg_len = half
            self._degradations.append(f"shrink-segment:{half}")
            # the delivery floor is per segment: a shorter segment delivers
            # proportionally less, so the boundary probe scales with it
            health = self.svc.health
            if health is not None and health.delivery_floor > 0:
                scaled = health.delivery_floor * half // self.svc.segment_len
                self._probe, self._probe_names = make_health_probe(
                    dataclasses.replace(health, delivery_floor=scaled))
            _log.warning("degraded: segment length halved to %d", half)
            return True
        if self.observe is not None:
            self.observe = None
            self._degradations.append("drop-observers")
            _log.warning("degraded: optional observers dropped")
            return True
        return False

    # -- violation handling ----------------------------------------------

    def _evidence(self, states_bad, window_report) -> tuple:
        """The bundle's evidence, read from the bad state before anything
        replays (on the card the replay's windows write the buffers it
        lives in): the NaN census by leaf path and the arrays of
        ``masks.npz``."""
        nan_census, arrays = {}, {}
        for path, leaf in state_paths(states_bad):
            if leaf.is_floating_point():
                n_bad = int((~torch.isfinite(leaf)).sum())
                if n_bad:
                    nan_census[path] = n_bad
        core = _core_of(states_bad)
        if getattr(core, "telem", None) is not None:
            arrays["telemetry_panel"] = core.telem.panel.cpu().numpy()
        if window_report is not None:
            arrays["invariant_ok"] = np.asarray(window_report.ok)
        return nan_census, arrays

    def _rollback_replay(self, seg: int, start: int, L: int, states_bad,
                         probe_fail, window_report):
        """Roll back to the segment's entry state and replay it dispatch by
        dispatch, checking every ``replay_check_every``, to find the first
        violating dispatch; writes the forensic bundle and returns it (a
        dict with its on-disk path)."""
        svc = self.svc
        rps = svc.rounds_per_dispatch
        spec = self.invariants
        ce = max(1, int(svc.replay_check_every))
        evidence = self._evidence(states_bad, window_report)
        st = self._state_at(start)
        prev_ev = _core_of(st).events.clone()
        first_bad, replay_fail = None, []
        if self._probe is not None and self._replay_probe is None:
            # the delivery floor is per segment: held to one dispatch's
            # delta it would trip at the first replayed dispatch, so the
            # replay's probe zeroes it (non-negativity stays, through
            # events-monotone)
            self._replay_probe, _ = make_health_probe(
                dataclasses.replace(svc.health, delivery_floor=0))
        for j in range(L):
            i = start + j
            st = self._step_once(st, i)
            if self.faults is not None:
                st = self.faults.corrupt_state(st, seg, j, L)
            fails = []
            if self._probe is not None:
                fails += _failing(self._replay_probe(st, prev_ev), self._probe_names)
            if spec is not None and (j + 1) % ce == 0:
                due = torch.as_tensor(self._due_row((i + 1) * rps), device=spec.device)
                fails += _failing(spec.check(st, prev_ev, due), spec.names, "invariant:")
            if fails:
                first_bad, replay_fail = i, fails
                break
            prev_ev = _core_of(st).events.clone()
        return self._write_bundle(seg, start, L, first_bad, replay_fail, probe_fail,
                                  window_report, evidence)

    def _write_bundle(self, seg, start, L, first_bad, replay_fail, probe_fail,
                      window_report, evidence) -> dict:
        rps = self.svc.rounds_per_dispatch
        # keyed by start dispatch, not segment ordinal: after a shrink
        # several windows share one ordinal, and a second bundle must never
        # overwrite the first's evidence
        bdir = os.path.join(self.root, "forensics", f"d{start:07d}")
        os.makedirs(bdir, exist_ok=True)
        nan_census, arrays = evidence
        doc = {
            "segment": seg,
            "start_dispatch": start,
            "segment_len": L,
            "first_bad_dispatch": first_bad,
            "first_bad_tick": None if first_bad is None else (first_bad + 1) * rps,
            "replay_failures": replay_fail,
            "window_probe_failures": probe_fail,
            "window_invariants": (window_report.artifact_block()
                                  if window_report is not None else None),
            "nan_census": nan_census,
            "written_at": time.time(),
        }
        write_json_atomic(os.path.join(bdir, "bundle.json"), doc)
        if arrays:
            np.savez_compressed(os.path.join(bdir, "masks.npz"), **arrays)
        doc["path"] = bdir
        self._bundles.append(doc)
        return doc

    # -- liveness ---------------------------------------------------------

    @property
    def heartbeat_path(self) -> str:
        return os.path.join(self.root, "HEARTBEAT.json")

    def _heartbeat(self, dispatch: int, status: str) -> None:
        write_json_atomic(self.heartbeat_path, {
            "status": status,
            "dispatch": int(dispatch),
            "total_dispatches": int(self.svc.n_dispatches),
            "tick": int(dispatch) * self.svc.rounds_per_dispatch,
            "segments_run": self._segments_run,
            "recoveries": self._recoveries,
            "retries": self._retries,
            "degradations": list(self._degradations),
            "pid": os.getpid(),
            "updated_at": time.time(),
        })

    def _report_paths(self):
        if self.svc.report_name is None:
            return None, None
        base = os.path.join(self.root, self.svc.report_name)
        return base + ".jsonl", base + ".html"

    def _report_row(self, row: dict) -> None:
        jsonl, html = self._report_paths()
        if jsonl is None:
            return
        if self._rows is None:
            # a resumed run's earlier rows, read once; the list is kept
            # from then on (re-reading the jsonl every segment would be
            # quadratic over a long run)
            self._rows = []
            try:
                with open(jsonl) as f:
                    self._rows = [json.loads(line) for line in f if line.strip()]
            except (FileNotFoundError, ValueError):
                pass
        with open(jsonl, "a") as f:
            f.write(json.dumps(row) + "\n")
        self._rows.append(row)
        with open(html + ".tmp", "w") as f:
            f.write(_render_report_html(self._rows, self.svc))
        os.replace(html + ".tmp", html)

    # -- the loop ---------------------------------------------------------

    def run(self, *, fresh: bool = False) -> ServiceReport:
        """Run (or resume) the supervised loop to completion."""
        svc = self.svc
        rps = svc.rounds_per_dispatch
        total = svc.n_dispatches
        self._segments_run = 0
        self._recoveries = 0
        self._retries = 0
        t0 = time.perf_counter()
        resumed_from = None
        states, start = self.template_fn(), 0
        ev_totals = (np.zeros(tuple(_core_of(states).events.shape), np.int64)
                     if svc.drain_event_counters else None)
        if not fresh:
            st, entry = self.store.restore_latest(self.template_fn())
            if st is not None:
                states = st
                start = int(entry.get("meta", {}).get("dispatch", entry["tick"] // rps))
                resumed_from = start
                if ev_totals is not None:
                    # a checkpoint's device counters were zeroed at its
                    # boundary, so (its counters, its meta totals) is the
                    # full count; a checkpoint without the key resumes the
                    # total from its own counters
                    ev_totals = np.asarray(
                        entry.get("meta", {}).get("ev_totals", ev_totals.tolist()), np.int64)
                _log.info("resuming at dispatch %d (tick %d) from %s",
                          start, start * rps, entry["file"])
        prev_events = _core_of(states).events.clone()
        recov_per_segment: dict = {}
        xs_cache: dict = {}
        inv_checks = 0
        obs_acc: list = []
        self._heartbeat(start, "running")
        note = overflow_horizon_note(total_rounds=total * rps)
        if note:
            _log.info("%s", note)
        while start < total:
            L = min(self._seg_len, total - start)
            seg = start // svc.segment_len
            self._cur_segment = seg
            runner = self._runner_for(L)
            xs = xs_cache.pop(start, None)
            if xs is None:
                xs = runner.stack_args(self.make_args, start, start + L)
            due, ticks = self._segment_due(start, L)
            t_seg = time.perf_counter()
            out, ys, retries, degraded = self._dispatch_retrying(
                seg, start, L, states, xs, due)
            self._retries += retries
            if degraded:
                # the shape changed (or the observers went): rebuild the
                # segment on the new rung from an intact state
                states = out if out is not None else self._state_at(start)
                xs_cache.clear()
                continue
            states = out
            # stack the next segment's rows while the card runs this one
            # (host work that reads no state)
            nxt = start + L
            if nxt < total:
                Ln = min(self._seg_len, total - nxt)
                xs_cache[nxt] = runner.stack_args(self.make_args, nxt, nxt + Ln)
            # an injected silent corruption lands before the probe reads
            if self.faults is not None and self.faults.wants_corruption(seg):
                states = self.faults.corrupt_state(
                    states, seg, self.faults.resolved_dispatch(L), L)
            # the segment's one host sync: the probe and verdict readback
            probe_fail = []
            if self._probe is not None:
                probe_fail = _failing(self._probe(states, prev_events), self._probe_names)
            window_report = None
            if self.invariants is not None and ys and "ok" in ys:
                window_report = self.invariants.report(ys["ok"], ticks=ticks)
            inv_bad = window_report is not None and not window_report.all_ok
            if probe_fail or inv_bad:
                self._recoveries += 1
                n = recov_per_segment.get(start, 0) + 1
                recov_per_segment[start] = n
                bundle = self._rollback_replay(seg, start, L, states, probe_fail,
                                               window_report)
                _log.warning(
                    "segment %d unhealthy (%s): rolled back; the replay found the "
                    "first violating dispatch %s (bundle %s)", seg,
                    probe_fail or "invariants", bundle["first_bad_dispatch"],
                    bundle["path"])
                if n > svc.max_recoveries_per_segment:
                    self._heartbeat(start, "halted")
                    what = bundle["replay_failures"] or probe_fail
                    raise ServiceHalted(
                        f"segment {seg}: {n} recoveries exceeded the "
                        f"budget ({svc.max_recoveries_per_segment}): "
                        f"persistent violation ({what}); forensic "
                        f"bundle at {bundle['path']}", bundle)
                states = self._state_at(start)
                prev_events = _core_of(states).events.clone()
                continue
            if self.faults is not None:
                self.faults.maybe_kill("post-segment", seg)
            # commit
            self._segments_run += 1
            if window_report is not None:
                inv_checks += window_report.n_checks
            if ys and "obs" in ys:
                obs_acc.append(ys["obs"])
            start += L
            if ev_totals is not None:
                # the segment passed its probes: its counter growth joins
                # the host total and the device counters restart at 0
                ev_totals += (_core_of(states).events.cpu().numpy().astype(np.int64)
                              - prev_events.cpu().numpy().astype(np.int64))
                states = _with_events(states, torch.zeros_like(_core_of(states).events))
            if (self._segments_run % svc.checkpoint_every_segments == 0
                    or start >= total):
                meta = {"dispatch": start}
                if ev_totals is not None:
                    meta["ev_totals"] = ev_totals.tolist()
                # copies every leaf to the host before it returns: the next
                # segment's replay cannot overwrite a buffer mid-save
                self.store.save(states, tick=start * rps, meta=meta)
            prev_events = _core_of(states).events.clone()
            dt = time.perf_counter() - t_seg
            self._heartbeat(start, "running")
            self._report_row({
                "segment": seg,
                "dispatch": start,
                "tick": start * rps,
                "seconds": round(dt, 4),
                "rounds_per_sec": round(L * rps / dt, 2) if dt > 0 else 0.0,
                "probes_ok": not probe_fail,
                "invariants_ok": not inv_bad,
                "invariant_checks": window_report.n_checks if window_report else 0,
                "retries": retries,
                "recoveries_total": self._recoveries,
            })
        _sync(states)
        self._heartbeat(start, "done")
        observations = None
        if obs_acc:
            cols = zip(*(_leaves(o) for o in obs_acc))
            observations = _rebuild(obs_acc[0], iter(
                [np.concatenate([x.cpu().numpy() for x in c]) for c in cols]))
        return ServiceReport(
            states=states,
            n_dispatches=total,
            rounds=total * rps,
            segments=self._segments_run,
            segment_rounds=svc.segment_len * rps,
            seconds=time.perf_counter() - t0,
            recoveries=self._recoveries,
            retries=self._retries,
            degradations=list(self._degradations),
            resumed_from=resumed_from,
            window_compiles=self.window_compiles(),
            checkpoints=self.store.entries(),
            heartbeat_path=self.heartbeat_path,
            invariant_checks=inv_checks,
            probes=self._probe_names,
            retention=svc.retention,
            bundles=list(self._bundles),
            observations=observations,
            ev_totals=ev_totals,
        )


def _render_report_html(rows: list, svc: ServiceConfig) -> str:
    """A self-contained report page: the segment table, a rate sparkline
    and the progress, rewritten atomically after every segment so a
    browser mid-run sees a whole page."""
    import html as _html

    rates = [r.get("rounds_per_sec", 0.0) for r in rows]
    done = rows[-1]["dispatch"] if rows else 0
    total = svc.n_dispatches
    spark = ""
    if rates:
        hi = max(max(rates), 1e-9)
        w, h = 360, 48
        pts = " ".join(
            f"{i * w / max(len(rates) - 1, 1):.1f},"
            f"{h - 4 - (v / hi) * (h - 8):.1f}"
            for i, v in enumerate(rates))
        spark = (f'<svg width="{w}" height="{h}" role="img">'
                 f'<polyline fill="none" stroke="#36f" stroke-width="1.5" '
                 f'points="{pts}"/></svg>')
    trs = "".join(
        "<tr><td>{segment}</td><td>{dispatch}</td><td>{tick}</td>"
        "<td>{rounds_per_sec}</td><td>{p}</td><td>{v}</td>"
        "<td>{retries}</td></tr>".format(
            p="ok" if r.get("probes_ok", True) else "FAIL",
            v="ok" if r.get("invariants_ok", True) else "FAIL",
            **{k: r.get(k, "") for k in
               ("segment", "dispatch", "tick", "rounds_per_sec", "retries")})
        for r in rows[-200:])
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>supervised service loop</title>"
        "<style>body{font:13px system-ui;margin:1.5em;color:#222}"
        "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
        "padding:2px 8px;text-align:right}th{background:#f5f5f5}"
        ".big{font-size:1.4em;font-weight:600}</style></head><body>"
        f"<h1>supervised service loop</h1>"
        f"<p class='big'>{done} / {total} dispatches "
        f"({100.0 * done / max(total, 1):.1f}%)</p>"
        f"<p>segment quantum {svc.segment_len} dispatches · "
        f"{_html.escape(str(len(rows)))} segments reported</p>"
        f"{spark}"
        "<table><tr><th>segment</th><th>dispatch</th><th>tick</th>"
        "<th>rounds/s</th><th>probes</th><th>invariants</th>"
        "<th>retries</th></tr>"
        f"{trs}</table></body></html>")
