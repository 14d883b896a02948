"""Drivers: the phase engine's heartbeat schedule and mesh formation
prelude, and run windows (the JAX package's ``driver.py``).

A run window drives a step over a whole schedule of dispatches. In the JAX
package it is one compiled program, ``jax.jit`` of a ``lax.scan``. Here, on
the CPU, it is the plain loop over dispatches; on the card it is a captured
CUDA graph: one block of dispatches (the heartbeat pattern's period, times
``unroll``) is captured once per (shapes, pattern) and replayed with one
graph launch a block, so a window issues no kernel launch from the host.

The block reads its dispatch rows from static device buffers at a cursor
held on the device and writes the state it leaves back into the static
state buffers it started from (the step returns fresh tensors), so a replay
copies nothing from the host and the next replay starts where the last one
ended. Window-invariant inputs (``consts``: a lifted step's score plane)
are static buffers of the block too: each call copies the caller's into
them, so one capture replays any plane of the same leaf shapes. A capture
or a replay that fails raises: a CUDA window never runs eagerly.

A checked window (``check=``, the invariant oracle folded in) runs its
checks inside the same graph: the due rows are static buffers copied in
before the replay, the counters snapshot a static buffer each check
rewrites, and each check's verdict goes to its row of a static output
buffer, so a checked run is still one graph replay a block.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

def heartbeat_schedule(heartbeat_every: int, rounds_per_phase: int) -> list[bool]:
    """Per-phase heartbeat flags over one schedule period: phase p covers
    ticks [p*r, (p+1)*r) and heartbeats iff that window holds a tick that is
    0 mod ``heartbeat_every``. The pattern repeats every lcm(he, r) // r
    phases; with r == 1 it is the per-round static-heartbeat contract."""
    he, r = int(heartbeat_every), int(rounds_per_phase)
    if he < 1 or r < 1:
        raise ValueError(f"heartbeat_every and rounds_per_phase must be >= 1, got {he}, {r}")
    period = math.lcm(he, r) // r
    return [any((p * r + i) % he == 0 for i in range(r)) for p in range(period)]


def form_mesh(step, st, *, rounds_per_phase: int, pub_width: int = 4,
              pv_dtype=torch.bool, up=None, consts=()):
    """One publish-free phase with ``do_heartbeat=True``: its tail heartbeat
    selects every peer's mesh (Join's immediate mesh, gossipsub.go:1015-1064)
    and the next phase's control head ingests the GRAFTs before any data
    sub-round, so the first phase a caller publishes into sees a formed
    mesh. Advances the tick by ``rounds_per_phase``. ``pv_dtype`` is the
    verdicts' dtype (bool, or integer verdict codes), which should match
    the caller's later publish batches. ``up`` is the [N] liveness row of a
    ``dynamic_peers`` step, ``consts`` a lifted step's plane; a scheduled
    chaos step (its ``rows`` name ``link_deny``) gets an all-False deny
    row: no partition during the formation."""
    r = int(rounds_per_phase)
    dev = st.core.tick.device
    po = torch.full((r, pub_width), -1, dtype=torch.int32, device=dev)
    pt = torch.zeros((r, pub_width), dtype=torch.int32, device=dev)
    pv = torch.zeros((r, pub_width), dtype=pv_dtype, device=dev)
    args = (po, pt, pv) if up is None else (po, pt, pv, torch.as_tensor(up, device=dev))
    if "link_deny" in getattr(step, "rows", ()):
        nbr_shape = tuple(st.mesh.shape[:1] + st.mesh.shape[2:])
        args += (torch.zeros(nbr_shape, dtype=torch.bool, device=dev),)
    return step(st, *args, *consts, do_heartbeat=True)


def min_cycle(flags) -> list[bool]:
    """The minimal repeating pattern of a periodic flag sequence (the whole
    sequence when aperiodic), so a window built from a full per-dispatch
    heartbeat list captures the same block as one built from the pattern."""
    flags = [bool(b) for b in flags]
    n = len(flags)
    for p in range(1, n + 1):
        if n % p == 0 and all(flags[i] == flags[i % p] for i in range(n)):
            return flags[:p]
    return flags


def _core_of(st):
    """The SimState face of any engine state (GossipSubState wraps it)."""
    return st.core if hasattr(st, "core") else st


# ---------------------------------------------------------------------------
# trees of tensors: engine states (dataclasses) and observations (any nest
# of dataclasses, dicts, tuples and lists)

def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _rebuild(tree, leaves):
    """``tree`` with its tensor leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return tree


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


def _structure(tree):
    """The shape of a tree apart from its tensors: its classes, field
    names and non-tensor values (a plane's host ``app_specific_weight``),
    so two trees with the same structure and leaf signatures can share a
    captured block."""
    if isinstance(tree, torch.Tensor):
        return None
    if dataclasses.is_dataclass(tree):
        return (type(tree), tuple((f.name, _structure(getattr(tree, f.name)))
                                  for f in dataclasses.fields(tree)))
    if isinstance(tree, dict):
        return (dict, tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_structure(v) for v in tree))
    return tree


def _stack(trees):
    """A per-dispatch list of observation trees -> one tree of stacks."""
    leaves = [_leaves(t) for t in trees]
    return _rebuild(trees[0], iter([torch.stack(col) for col in zip(*leaves)]))


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter (host counts, which move when
    a wrapper launches, so during a capture and never during a replay)."""
    from .ops import csr_delivery, delivery_banded, fused_round, select_topk

    out = {}
    for mod in (fused_round, delivery_banded, csr_delivery, select_topk):
        out.update(mod.LAUNCHES)
    return out


class _Captured:
    """One captured block of a CUDA window: its graph, the static state,
    row, due, counters and output buffers it reads and writes, the device
    cursor."""

    def __init__(self, win: "Window", st, xs, consts, n_dispatch: int, due=None):
        dev = xs[0].device
        self.device = dev
        self.template = st
        leaves = _leaves(st)
        self.state_sig = _signature(leaves)
        self.state = [t.clone() for t in leaves]
        self.consts_template = consts
        self.consts = [t.clone() for t in _leaves(consts)]
        self.rows = [torch.empty((n_dispatch,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
                     for a in xs]
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        self.n_dispatch = n_dispatch
        self.obs = None
        self.obs_template = None
        # the checks: the due rows, the counters snapshot the next check
        # compares against, and the verdicts (one spill row past the last
        # check, which a clamped row index writes instead of past the end)
        self.n_checks = n_dispatch // win.check_every if win.check is not None else 0
        self.due = self.prev = self.ok = None
        if win.check is not None:
            self.due = torch.empty((self.n_checks, due.shape[-1]), dtype=torch.int32, device=dev)
            self.due.copy_(due)
            self.prev = _core_of(st).events.clone()
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}
        self.launches = {}
        side = torch.cuda.Stream(dev)
        t0 = time.perf_counter()
        for a, buf in zip(xs, self.rows):
            buf.copy_(a)
        # warm-up on a side stream (torch.cuda.graphs asks for it): it
        # loads every kernel module and fills the wrappers' and the
        # checker's constant caches, with the block's own heartbeat pattern
        # and checks, from a copy of the state that is then dropped
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            sw = _rebuild(st, iter([t.clone() for t in leaves]))
            cw = self.const_args()
            prev = None if self.prev is None else self.prev.clone()
            for j in range(win.block_dispatches):
                sw = win.call(sw, [r[j % n_dispatch] for r in self.rows] + cw, j)
                if win.observe is not None:
                    obs = win.observe(sw)
                if win.checks_after(j):
                    c = ((j + 1) // win.check_every - 1) % self.n_checks
                    ok = win.check(sw, prev, self.due[c])
                    prev = _core_of(sw).events.clone()
            if win.observe is not None:
                self.obs_template = obs
                self.obs = [torch.empty((n_dispatch,) + tuple(t.shape), dtype=t.dtype, device=dev)
                            for t in _leaves(obs)]
            if win.check is not None:
                self.ok = torch.zeros((self.n_checks + 1,) + tuple(ok.shape), dtype=torch.bool,
                                      device=dev)
            del sw
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        win.capture_seconds += time.perf_counter() - t0

    def const_args(self) -> list:
        """The step's trailing arguments, read from the static buffers."""
        return list(_rebuild(self.consts_template, iter(self.consts)))

    def graph(self, win: "Window", n: int) -> torch.cuda.CUDAGraph:
        """The graph of a block of ``n`` dispatches, captured at first use."""
        g = self.graphs.get(n)
        if g is not None:
            return g
        t0 = time.perf_counter()
        before = launch_counts()
        g = torch.cuda.CUDAGraph()
        inputs = {t.untyped_storage().data_ptr() for t in self.state}
        ce = win.check_every
        with torch.cuda.graph(g, pool=self.pool):
            st = _rebuild(self.template, iter(self.state))
            idx = self.cursor + torch.arange(n, device=self.device)
            rows = [buf.index_select(0, idx) for buf in self.rows]
            if self.ok is not None:
                # this block's checks: their rows of the due and output
                # buffers, from the cursor (a block starts at a multiple of
                # check_every)
                cidx = torch.div(self.cursor, ce, rounding_mode="floor") + torch.arange(
                    n // ce, device=self.device)
                due = self.due.index_select(0, cidx.clamp(max=self.n_checks - 1))
                out_row = cidx.clamp(max=self.n_checks)
            cw = self.const_args()
            for j in range(n):
                st = win.call(st, [r[j] for r in rows] + cw, j)
                if self.obs is not None:
                    for buf, t in zip(self.obs, _leaves(win.observe(st))):
                        buf.index_copy_(0, idx[j:j + 1], t.unsqueeze(0))
                if win.checks_after(j):
                    c = (j + 1) // ce - 1
                    ok = win.check(st, self.prev, due[c])
                    self.ok.index_copy_(0, out_row[c:c + 1], ok.unsqueeze(0))
                    self.prev.copy_(_core_of(st).events)
            out = _leaves(st)
            if _signature(out) != self.state_sig:
                raise ValueError("make_window: the step changed the state's leaf shapes "
                                 "or dtypes, which a captured block cannot carry")
            # an output that shares memory with another input buffer is
            # copied aside first, so no write-back reads a buffer already
            # written
            out = [o if o is s or o.untyped_storage().data_ptr() not in inputs else o.clone()
                   for o, s in zip(out, self.state)]
            for o, s in zip(out, self.state):
                if o is not s:
                    s.copy_(o)
            self.cursor.add_(n)
        after = launch_counts()
        self.launches[n] = {k: after[k] - before[k] for k in after}
        self.graphs[n] = g
        torch.cuda.synchronize(self.device)
        win.capture_seconds += time.perf_counter() - t0
        return g


class Window:
    """A run window: ``run(state, xs, due=None, consts=()) -> (state, ys)``
    (see ``make_window``). On the card it keeps its captured blocks and
    counts what it did: ``replays`` (graph launches, every window call),
    ``captures`` and ``capture_seconds`` (warm-up and capture), and
    ``block_launches`` (kernel launches each wrapper made while a block of
    ``block_dispatches`` was captured, so once a replay). A call with other
    ``consts`` of the same structure and leaf shapes (another weight set)
    replays the same capture: ``captures`` does not move."""

    def __init__(self, step, heartbeat, observe, unroll: int, donate: bool, check=None,
                 check_every: int = 1):
        self.step = step
        self.hb = None if heartbeat is None else min_cycle(heartbeat)
        self.period = 1 if self.hb is None else len(self.hb)
        self.observe = observe
        self.check = check
        self.check_every = int(check_every)
        # a checked window's unit: the heartbeat period and the check
        # cadence both repeat within it
        self.unit = math.lcm(self.period, self.check_every) if check is not None else self.period
        self.unroll = max(1, int(unroll))
        self.donate = bool(donate)
        self.block_dispatches = self.unit * self.unroll
        self.replays = 0
        self.captures = 0
        self.capture_seconds = 0.0
        self.block_launches: dict = {}
        self._entries: dict = {}

    def call(self, st, args, j: int):
        if self.hb is None:
            return self.step(st, *args)
        return self.step(st, *args, do_heartbeat=self.hb[j % self.period])

    def checks_after(self, j: int) -> bool:
        """Whether a check follows dispatch ``j`` of a block."""
        return self.check is not None and (j + 1) % self.check_every == 0

    def __call__(self, st, xs, due=None, consts=()):
        consts = tuple(consts)
        xs = tuple(xs)
        if not xs:
            raise ValueError("make_window: xs must carry at least one per-dispatch array "
                             "(the dispatch count is read from its leading axis)")
        n_dispatch = xs[0].shape[0]
        if any(a.shape[0] != n_dispatch for a in xs[1:]):
            raise ValueError(f"make_window: xs leading axes disagree "
                             f"({[a.shape[0] for a in xs]})")
        if n_dispatch % self.unit:
            if self.check is None:
                raise ValueError(f"window length {n_dispatch} dispatches is not a multiple of "
                                 f"the heartbeat period {self.period}")
            raise ValueError(f"window length {n_dispatch} dispatches is not a multiple of "
                             f"lcm(heartbeat period={self.period}, check_every="
                             f"{self.check_every}) = {self.unit}")
        dev = _core_of(st).tick.device
        xs = tuple(torch.as_tensor(a, device=dev) for a in xs)
        if self.check is not None:
            if due is None:
                raise ValueError("make_window: a checked window needs the stacked "
                                 "[n_checks, DUE_LEN] due rows")
            due = torch.as_tensor(due, dtype=torch.int32, device=dev)
            if due.shape[0] != n_dispatch // self.check_every:
                raise ValueError(f"due rows {due.shape[0]} != expected checks "
                                 f"{n_dispatch // self.check_every} ({n_dispatch} dispatches "
                                 f"every {self.check_every})")
        if any(t.device != dev for t in _leaves(consts)):
            raise ValueError(f"make_window: consts must live on the state's device {dev}")
        if dev.type != "cuda":
            return self._loop(st, xs, consts, n_dispatch, due)
        return self._replay(st, xs, consts, n_dispatch, due)

    def _loop(self, st, xs, consts, n_dispatch: int, due):
        obs, oks = [], []
        prev = _core_of(st).events.clone() if self.check is not None else None
        for d in range(n_dispatch):
            st = self.call(st, [a[d] for a in xs] + list(consts), d)
            if self.observe is not None:
                obs.append(self.observe(st))
            if self.checks_after(d):
                oks.append(self.check(st, prev, due[(d + 1) // self.check_every - 1]))
                prev = _core_of(st).events.clone()
        ys = {"obs": _stack(obs)} if obs else {}
        if self.check is not None:
            ys["ok"] = torch.stack(oks)
        return st, ys

    def _replay(self, st, xs, consts, n_dispatch: int, due):
        leaves = _leaves(st)
        const_leaves = _leaves(consts)
        # one capture serves every window up to its row capacity, and every
        # consts of its structure and leaf signatures
        key = (_signature(leaves), tuple((tuple(a.shape[1:]), a.dtype) for a in xs),
               _structure(consts), _signature(const_leaves))
        entry = self._entries.get(key)
        if entry is None or entry.n_dispatch < n_dispatch:
            self._entries.pop(key, None)
            entry = self._entries[key] = _Captured(self, st, xs, consts, n_dispatch, due)
            self.captures += 1
        else:
            for a, buf in zip(xs, entry.rows):
                buf[:n_dispatch].copy_(a)
            if due is not None:
                entry.due[:due.shape[0]].copy_(due)
        if entry.prev is not None:
            # the first check compares against the window-entry counters
            entry.prev.copy_(_core_of(st).events)
        for t, buf in zip(const_leaves, entry.consts):
            if t.data_ptr() != buf.data_ptr():
                buf.copy_(t)
        # the state comes in through the static buffers (a state this
        # window returned under donate=True already lives there)
        for t, buf in zip(leaves, entry.state):
            if t.data_ptr() != buf.data_ptr():
                buf.copy_(t)
        entry.cursor.zero_()
        big = self.block_dispatches
        plan = [big] * (n_dispatch // big) + [self.unit] * ((n_dispatch % big) // self.unit)
        graphs = {n: entry.graph(self, n) for n in sorted(set(plan), reverse=True)}
        self.block_launches = entry.launches.get(big, self.block_launches)
        for n in plan:
            graphs[n].replay()
            self.replays += 1
        out = entry.state if self.donate else [t.clone() for t in entry.state]
        st = _rebuild(entry.template, iter(out))
        ys = {}
        if entry.obs is not None:
            ys["obs"] = _rebuild(entry.obs_template,
                                 iter([b[:n_dispatch].clone() for b in entry.obs]))
        if entry.ok is not None:
            ys["ok"] = entry.ok[:n_dispatch // self.check_every].clone()
        return st, ys


def make_window(step, *, heartbeat=None, check=None, check_every: int = 1, observe=None,
                unroll: int = 1, donate: bool = True) -> Window:
    """A whole run window: ``run(state, xs, due=None, consts=()) -> (state,
    ys)``.

    * ``xs`` is a tuple of per-dispatch arrays, each with leading axis ``D``
      (publish batches ``[D, P]`` per-round, ``[D, r, P]`` phase); dispatch
      ``d`` consumes row ``d`` of every array, exactly as if ``step`` had
      been called ``D`` times from Python.
    * ``heartbeat`` is the static cadence pattern (a bool sequence, cycled;
      ``heartbeat_schedule``'s shape) for steps that take a keyword-only
      ``do_heartbeat``; None for steps that own their cadence.
    * ``observe`` is a state function evaluated after every dispatch; its
      per-dispatch stack comes back in ``ys["obs"]`` (leading axis D).
    * ``check`` folds the invariant oracle into the window: a predicate
      ``check(state, prev_events, due_row) -> [P]`` (batched: ``[S, P]``)
      evaluated after every ``check_every``-th dispatch; build it with
      ``oracle.invariants.ScanInvariants``. ``due`` is the stacked
      ``[n_checks, DUE_LEN]`` due rows (``ScanInvariants.precompute``); the
      first check compares the counters against the window-entry counters,
      each later one against the previous check's; the verdicts come back
      in ``ys["ok"]`` (``[n_checks, P]`` / ``[n_checks, S, P]``). On the
      card the checks are part of the captured block, so they must make no
      host sync (the oracle's predicates make none).
    * ``D`` must be a multiple of the pattern's period, and with ``check``
      of lcm(period, ``check_every``), the span of a captured block.
    * ``donate=True`` (the JAX default) returns the window's own state
      buffers, which its next call overwrites; ``donate=False`` returns
      copies. A state a window returned may be passed back in as it is.
    * ``unroll`` blocks of one period (a checked window: of the lcm above)
      each are captured as one graph on the card (a window whose length is
      not a multiple of that replays a one-unit graph for the rest).
    * ``consts`` (a run-time argument) is a tuple of window-invariant
      inputs appended to every step call after the per-dispatch rows: a
      lifted step's score plane (``score.params``). On the card its tensor
      leaves are static buffers of the capture, so the same window replays
      another plane of the same structure and leaf shapes without a new
      capture (``Window.captures``).
    * Every tensor leaf of the state is a static buffer of the capture: the
      validation pipeline's stages (``dlv.pending``), the queue cap's
      ``congested_in``, PX's ``edge_live`` and ``prune_px_out``, the
      exact-trace ``dup_trans``, the int16 counters, dynamic peers' ``up``
      and ``blacklist`` and the mutable overlay ``core.topo`` too; a None
      leaf (a state without a pipeline, the trace plane or the overlay)
      stays None. A ``dynamic_peers`` step's liveness rows ``[D, N]`` and a
      ``dynamic_topo`` step's write batches ``[D, B, 4]`` are ordinary
      ``xs`` after the publish arrays, and so is a scheduled chaos step's
      ``link_deny`` ``[D, N, K]`` bool (in the step's row order: up, deny,
      writes); a dispatch with no partition takes an all-False row, since a
      window row cannot be None. ``step`` may be any engine's: a
      GossipSub or phase step, or a FloodSub or RandomSub round
      (``perf/sweep``'s runs)."""
    if int(check_every) < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    return Window(step, heartbeat, observe, unroll, donate, check=check,
                  check_every=check_every)


def make_scan(step, *, heartbeat_every: int = 1, rounds_per_phase: int = 1,
              static_heartbeat: bool | None = None, unroll: int = 1, donate: bool = True):
    """``run(state, pub_origin, pub_topic, pub_valid) -> state`` over a full
    ``[R, P]`` publish schedule, the heartbeat cadence owned here:

    * a per-round step that decides its heartbeat itself (``heartbeat_every``
      1, or a plain build): rounds are dispatches;
    * a per-round step built with ``static_heartbeat=True``: ``do_heartbeat``
      is True exactly on ticks that are 0 mod ``heartbeat_every``;
    * a phase step (``rounds_per_phase`` r > 1): the schedule is regrouped
      into R // r phases of ``[r, P]``, each heartbeating iff its tick window
      holds a heartbeat tick.

    A ``dynamic_peers`` step takes the liveness schedule as ``run(st, po,
    pt, pv, up)``, ``up`` an ``[R, N]`` bool plane; a phase consumes the
    first row of its r rows (the transitions land once a phase, at its
    head). A scheduled chaos step takes ``run(..., link_deny=deny)``,
    ``deny`` an ``[R, N, K]`` bool plane (all False where no partition is
    active), of which a phase likewise consumes its head's row. A lifted
    step takes its plane as ``run(..., consts=(plane,))``.

    The state's tick at entry must be 0 mod lcm(he, r), and R a multiple of
    it. A thin adapter over ``make_window``; ``run.window`` is the window
    (its replay and capture counts on the card)."""
    he, r = int(heartbeat_every), int(rounds_per_phase)
    if static_heartbeat is None:
        if r == 1 and he > 1:
            raise ValueError(
                "make_scan: pass static_heartbeat=True/False explicitly for a per-round "
                "step with heartbeat_every > 1 (True for a make_gossipsub_step("
                "static_heartbeat=True) build, False for a plain build)")
        static_heartbeat = r > 1
    lcm = math.lcm(he, r)
    sched = heartbeat_schedule(he, r) if static_heartbeat else None
    win = make_window(step, heartbeat=sched, unroll=unroll, donate=donate)

    def run(st, po, pt, pv, up=None, consts=(), link_deny=None):
        n_rounds = po.shape[0]
        if n_rounds % lcm:
            raise ValueError(f"schedule length {n_rounds} is not a multiple of "
                             f"lcm(heartbeat_every={he}, rounds_per_phase={r}) = {lcm}")
        xs = (po, pt, pv)
        if r > 1:
            xs = tuple(torch.as_tensor(a).reshape((n_rounds // r, r) + tuple(a.shape[1:]))
                       for a in xs)
        # one liveness and one deny row a phase: its first round's
        xs += tuple(torch.as_tensor(a)[::r] for a in (up, link_deny) if a is not None)
        st, _ = win(st, xs, None, consts)
        return st

    run.window = win
    return run
