"""The ensemble sweep / Monte Carlo driver (the JAX package's
``ensemble/runner.py``).

S sims run together in each dispatch of a lifted step
(``batch.lift_step``): every kernel launches once for the S sims, so an
S-sim dispatch costs the launches of one. ``run_rounds`` is the
per-dispatch face (the invariant hook and parity surface);
``WindowRunner``/``run_window`` drive a whole segment through one run
window (``driver.make_window``): on the card a captured CUDA graph
replayed a block at a time, with the invariant checks
(``oracle.ScanInvariants``) and device observations folded into the same
graph, so a checked and observed S-sim run issues no kernel launch from
the host.

There is no compile cache to read: ``EnsembleRun.compiles`` is -1 for
``run_rounds`` (as ``oracle.InvariantHook.compiles``), and for a window the
growth of ``Window.captures`` over the run (1 for the first run of a
window on the card, whatever its segment count; 0 on the CPU, where a
window is the plain loop).

Placing a batched state on a device mesh (``shard_ensemble_state``) needs
the peer-axis sharding the port has not yet (ROADMAP §1, item 7).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..driver import _core_of, _leaves, _rebuild, make_window, min_cycle


@dataclasses.dataclass
class EnsembleRun:
    """One ensemble segment's result: the final batched state, the
    compile sentinel, and wall-clock aggregates. Window runs also carry the
    dispatch count (one per segment), the folded invariant report and the
    stacked per-dispatch observations."""

    states: object
    n_sims: int
    rounds: int          # simulated rounds per sim (ticks advanced)
    compiles: int        # -1 (run_rounds: no cache), or the window's capture growth
    seconds: float
    #: dispatches the segment executed as (run_rounds: one a step;
    #: run_window: one a segment)
    dispatches: int = 0
    #: oracle.InvariantReport when invariants were folded or hooked
    invariant_report: object = None
    #: stacked per-dispatch observe() tree ([D, ...] numpy leaves) or None
    observations: object = None

    @property
    def aggregate_rounds_per_sec(self) -> float:
        """Sim-rounds per wall second (S x rounds / time): the Monte Carlo
        throughput set against S runs one after another."""
        return (self.n_sims * self.rounds / self.seconds
                if self.seconds > 0 else float("inf"))


def _sync(states) -> None:
    dev = _core_of(states).tick.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _n_sims(states) -> int:
    leaves = _leaves(states)
    return int(leaves[0].shape[0]) if leaves[0].dim() else 1


def run_rounds(ens_step, states, make_args, n_steps: int, *,
               rounds_per_phase: int = 1, heartbeat_fn=None,
               observe=None, invariants=None) -> EnsembleRun:
    """Drive ``n_steps`` dispatches of a lifted ensemble step.

    ``make_args(i)`` returns the tuple of per-step tensors after the
    state, each with the leading S axis (publish batches ``[S, P]`` /
    ``[S, r, P]``, churn rows ``[S, N]``, deny masks ``[S, N, K]``;
    ``batch.tile`` for shared inputs). ``heartbeat_fn(i)`` gives the
    ``do_heartbeat`` flag of steps that take one; None omits it.
    ``observe(i, states)`` sees the live batched state after each
    dispatch (host-side analysis, not part of the run).

    ``invariants`` is an ``oracle.InvariantHook`` (built ``batched``):
    every ``check_every`` dispatches it checks the live batched state and
    keeps the ``[S, P]`` verdicts on the device, its due rows made before
    the run; ``invariants.report()`` reads them afterwards, and the
    result's ``invariant_report`` holds that report."""
    n_sims = _n_sims(states)
    if invariants is not None:
        invariants.precompute(n_steps)
    t0 = time.perf_counter()
    for i in range(int(n_steps)):
        kw = {}
        if heartbeat_fn is not None:
            kw["do_heartbeat"] = bool(heartbeat_fn(i))
        states = ens_step(states, *make_args(i), **kw)
        if invariants is not None:
            invariants.on_step(i, states)
        if observe is not None:
            observe(i, states)
    _sync(states)
    dt = time.perf_counter() - t0
    return EnsembleRun(
        states=states,
        n_sims=n_sims,
        rounds=int(n_steps) * int(rounds_per_phase),
        compiles=-1,
        seconds=dt,
        dispatches=int(n_steps),
        invariant_report=invariants.report() if invariants is not None else None,
    )


class WindowRunner:
    """One run window over a lifted ensemble step, reusable across runs
    (a warm re-run replays the same capture on the card).

    ``n_steps`` is a run's total dispatch count; ``segment_len`` splits it
    into equal segments, one window call each (``run`` yields to
    ``on_segment`` between them), by default the whole run as one.
    ``heartbeat_fn(i)`` gives the heartbeat cadence (periodic, its period
    dividing ``segment_len``); ``invariants`` is an
    ``oracle.ScanInvariants`` (``batched``), folded into the window;
    ``observe(state) -> tree`` is a device function stacked per dispatch.
    ``unroll`` is the window's (blocks of periods a captured graph holds)."""

    def __init__(self, ens_step, n_steps: int, *, rounds_per_phase: int = 1,
                 heartbeat_fn=None, invariants=None, observe=None,
                 segment_len: int | None = None, unroll: int = 1):
        self.n_steps = int(n_steps)
        self.rounds_per_phase = max(int(rounds_per_phase), 1)
        self.invariants = invariants
        seg = int(segment_len) if segment_len else self.n_steps
        if self.n_steps % seg:
            raise ValueError(
                f"segment_len {seg} does not divide the {self.n_steps}"
                "-dispatch window")
        self.segment_len = seg
        hb = None
        if heartbeat_fn is not None:
            # the exact minimal cycle of the flags (an aperiodic sequence
            # comes back whole): only its divisibility into the segment counts
            hb = min_cycle(heartbeat_fn(i) for i in range(self.n_steps))
            if seg % len(hb):
                raise ValueError(
                    f"heartbeat_fn's minimal period {len(hb)} does not "
                    f"divide segment_len={seg} — every segment must "
                    "compile the same window program")
        ce = 1
        check = None
        if invariants is not None:
            check = invariants.check
            ce = invariants.check_every
            if seg % ce:
                raise ValueError(
                    f"segment_len {seg} must be a multiple of the "
                    f"invariant check_every {ce} (checks must land on "
                    "segment boundaries for exact resume)")
        self.window = make_window(ens_step, heartbeat=hb, check=check,
                                  check_every=ce, observe=observe, unroll=unroll)

    def dispatch(self, states, xs, due=None, consts=()):
        """One window call, without timing: the service loop's seam. ``xs``
        is a ``stack_args`` tuple of this runner's segment; ``due`` the
        segment's stacked due rows when invariants are folded (by default
        this runner's own, segment-local ticks); ``consts`` the
        window-invariant trailing step arguments (a stacked plane), so a
        new population replays the same capture. Returns ``(states, ys)``."""
        if self.invariants is None:
            return self.window(states, xs, None, tuple(consts))
        if due is None:
            due = self.invariants.due_rows(self.segment_len)
        return self.window(states, xs, due, tuple(consts))

    def stack_args(self, make_args, lo: int, hi: int) -> tuple:
        """Stack the per-dispatch tuples ``make_args(i)`` for ``i`` in
        ``[lo, hi)`` into the window's ``[D, ...]`` rows."""
        rows = [tuple(make_args(i)) for i in range(lo, hi)]
        width = {len(r) for r in rows}
        if len(width) != 1:
            raise ValueError(f"make_args returned ragged tuples: {width}")
        return tuple(torch.stack([torch.as_tensor(r[k]) for r in rows])
                     for k in range(width.pop()))

    def run(self, states, make_args, *, on_segment=None, consts=()) -> EnsembleRun:
        """Run the window, one call a segment. ``make_args`` is
        ``run_rounds``' contract; ``on_segment(seg_idx, states)`` fires
        between segments (the checkpoint hook); ``consts`` are the
        window-invariant trailing step arguments every segment shares."""
        n_sims = _n_sims(states)
        seg, d = self.segment_len, self.n_steps
        due = self.invariants.due_rows(d) if self.invariants is not None else None
        cpseg = seg // self.invariants.check_every if due is not None else 0
        consts = tuple(consts)
        before = self.window.captures
        oks, obs = [], []
        t0 = time.perf_counter()
        for g in range(d // seg):
            xs = self.stack_args(make_args, g * seg, (g + 1) * seg)
            dseg = due[g * cpseg:(g + 1) * cpseg] if due is not None else None
            states, ys = self.window(states, xs, dseg, consts)
            if "ok" in ys:
                oks.append(ys["ok"])
            if "obs" in ys:
                obs.append(ys["obs"])
            if on_segment is not None and g + 1 < d // seg:
                on_segment(g, states)
        _sync(states)
        dt = time.perf_counter() - t0
        report = None
        if self.invariants is not None:
            ok = (np.concatenate([o.cpu().numpy() for o in oks]) if oks
                  else np.zeros((0, len(self.invariants.names)), bool))
            report = self.invariants.report(ok)
        observations = None
        if obs:
            cols = zip(*(_leaves(o) for o in obs))
            observations = _rebuild(obs[0], iter(
                [np.concatenate([x.cpu().numpy() for x in c]) for c in cols]))
        return EnsembleRun(
            states=states,
            n_sims=n_sims,
            rounds=d * self.rounds_per_phase,
            compiles=self.window.captures - before,
            seconds=dt,
            dispatches=d // seg,
            invariant_report=report,
            observations=observations,
        )


def run_window(ens_step, states, make_args, n_steps: int, *,
               rounds_per_phase: int = 1, heartbeat_fn=None,
               invariants=None, observe=None, segment_len=None,
               unroll: int = 1, on_segment=None, consts=()) -> EnsembleRun:
    """A one-shot ``WindowRunner``: the whole run as one window call a
    segment (one segment by default), with ``run_rounds``' ``make_args``
    contract and result, the invariant hook replaced by an
    ``oracle.ScanInvariants`` folded into the window and ``observe`` a
    device function ``state -> tree`` stacked per dispatch."""
    return WindowRunner(
        ens_step, n_steps, rounds_per_phase=rounds_per_phase,
        heartbeat_fn=heartbeat_fn, invariants=invariants, observe=observe,
        segment_len=segment_len, unroll=unroll,
    ).run(states, make_args, on_segment=on_segment, consts=consts)


def shard_ensemble_state(states, mesh, n_peers: int, axis: str = "peers",
                         n_edges: int | None = None):
    """Place a batched state on a device mesh (the sim axis, the peer axis
    or both). Refused: it needs the port's peer-axis sharding
    (``parallel/sharding.py`` of the JAX package), ROADMAP §1, item 7."""
    raise NotImplementedError(
        "shard_ensemble_state: the port has no peer-axis sharding yet "
        "(ROADMAP §1, item 7); run the ensemble on one device")
