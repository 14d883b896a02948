"""The mutable overlay: device-side topology writes and their host
compiler (the port's own copy of the JAX package's ``topo/dynamics.py``).

* ``apply_mutation`` scatters one fixed-width batch of ``[B, 4]`` write
  rows ``(slot, peer, rev, ok)`` over the flat ``[N*K]`` slot space onto a
  ``state.TopoState``: ``ok=1`` installs ``nbr[slot]=peer, rev[slot]=rev,
  edge_perm[slot]=peer*K+rev``; ``ok=0`` clears the slot back to the absent
  convention (``nbr=-1``, a self-pointing perm). Every written slot bumps
  its ``epoch``. Rows whose slot lies outside the slot space (the
  ``PAD_SLOT`` padding) are dropped on the device, without a host sync: the
  scatter writes into an ``[N*K + 1]`` buffer whose last element takes
  every dropped row and is cut away (torch's scatters have no drop mode,
  and an out-of-range index is a device-side assert on the card).
* ``MutationSchedule`` keeps an exact numpy mirror of the evolving edge
  pool and records, per dispatch, the write rows of edge adds, removes and
  rewires, kills and revivals (on the ``dynamic_peers`` up plane) and
  preferential-attachment joins; ``build()`` pads every batch to one width.
  Both endpoint slots of an edge are written in one batch, so the
  involution stays closed by construction; a slot written twice in one
  batch raises ``ScheduleError``. ``churn_storm`` is the standard program.
  Both draw from numpy's generator in the JAX package's order, so a
  schedule's ``build()`` arrays and ``schedule_hash()`` are the JAX
  package's bit for bit (``tests/test_torch_dynamics.py``).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

#: the padding row's slot: outside every slot space, so the scatter drops it
PAD_SLOT = np.iinfo(np.int32).max


def _drop_index(slot: torch.Tensor, e: int) -> torch.Tensor:
    """int64 scatter indices into an ``[e + 1]`` buffer: a row whose slot
    lies outside ``[0, e)`` lands on the spill element ``e``."""
    return torch.where((slot >= 0) & (slot < e), slot, e).long()


def apply_mutation(topo, writes: torch.Tensor):
    """One fixed-width mutation batch applied to the overlay ``topo`` (a
    ``state.TopoState``); ``writes`` is ``[B, 4]`` int32. Peer and rev are
    clamped into their planes' ranges before they land (identity for every
    batch ``MutationSchedule`` emits), so a malformed row cannot write an
    out-of-range perm that the next gather would index with; the scatter
    index itself is not clamped, so padding rows drop. Returns the new
    ``TopoState``."""
    from ..state import replace

    n, k = topo.nbr.shape
    e = n * k
    slot = writes[:, 0]
    peer = writes[:, 1].clamp(0, n - 1)
    rv = writes[:, 2].clamp(0, k - 1)
    ok = writes[:, 3] != 0
    idx = _drop_index(slot, e)
    nbr_new = torch.where(ok, peer, -1)
    rev_new = torch.where(ok, rv, 0)
    perm_new = torch.where(ok, peer * k + rv, slot.clamp(0, e - 1))

    def scat(plane, vals, accumulate=False):
        ext = torch.cat([plane.reshape(e), plane.new_zeros((1,))])
        ext = ext.index_put((idx,), vals.to(plane.dtype), accumulate=accumulate)
        return ext[:e].reshape(n, k)

    return replace(
        topo,
        nbr=scat(topo.nbr, nbr_new),
        nbr_ok=scat(topo.nbr_ok, ok),
        rev=scat(topo.rev, rev_new),
        edge_perm=scat(topo.edge_perm, perm_new),
        epoch=scat(topo.epoch, torch.ones_like(slot), accumulate=True),
    )


def written_edge_mask(writes: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """[N, K] bool: the slots this batch writes, padding rows excluded (the
    step's clear mask for edge-keyed state, ``clear_mutated_edges``)."""
    e = n * k
    m = torch.zeros((e + 1,), dtype=torch.bool, device=writes.device)
    m = m.index_put((_drop_index(writes[:, 0], e),),
                    torch.ones(writes.shape[:1], dtype=torch.bool, device=writes.device))
    return m[:e].reshape(n, k)


class ScheduleError(ValueError):
    """An ill-formed mutation program."""


class MutationSchedule:
    """A host-compiled mutation program over a fixed window of dispatches.

    Mirrors the evolving edge pool in numpy (the planes the device carries)
    and records, per dispatch, a batch of write rows and the liveness row
    the ``dynamic_peers`` step consumes. Ops take the dispatch they land on
    and must come in non-decreasing dispatch order; a slot may be written
    once a dispatch. ``build()`` returns ``writes [D, B, 4]`` int32 and
    ``up [D, N]`` bool."""

    def __init__(self, nbr, nbr_ok, rev, n_dispatches: int,
                 rounds_per_dispatch: int = 1):
        self.nbr = np.array(nbr, np.int32, copy=True)
        self.nbr_ok = np.array(nbr_ok, bool, copy=True)
        self.rev = np.array(rev, np.int32, copy=True)
        self.n, self.k = self.nbr.shape
        self.n_dispatches = int(n_dispatches)
        self.rounds_per_dispatch = int(rounds_per_dispatch)
        self.up = np.ones((self.n,), bool)
        self._rows: list[list[tuple[int, int, int, int]]] = [
            [] for _ in range(self.n_dispatches)]
        self._up_rows = np.ones((self.n_dispatches, self.n), bool)
        self._touched: list[set[int]] = [set() for _ in range(self.n_dispatches)]
        self._cursor = 0
        # the degrees, kept with every write (the JAX package sums the
        # [N, K] mirror at every join; the values are the same)
        self._deg = self.nbr_ok.sum(axis=1).astype(np.int64)
        self.n_kills = 0
        self.n_joins = 0
        self.n_rewires = 0

    # -- mirror bookkeeping -------------------------------------------------

    def _write(self, d: int, slot: int, peer: int, rv: int, ok: int):
        if not (0 <= d < self.n_dispatches):
            raise ScheduleError(f"dispatch {d} outside window")
        if d < self._cursor:
            raise ScheduleError(
                f"dispatch {d} recorded after dispatch {self._cursor} — "
                "ops must arrive in non-decreasing dispatch order")
        self._cursor = d
        if slot in self._touched[d]:
            raise ScheduleError(
                f"slot {slot} written twice in dispatch {d} — scatter "
                "rows within a batch must be unique")
        self._touched[d].add(slot)
        self._rows[d].append((slot, peer, rv, ok))
        i, ki = divmod(slot, self.k)
        self._deg[i] += int(bool(ok)) - int(self.nbr_ok[i, ki])
        if ok:
            self.nbr[i, ki] = peer
            self.rev[i, ki] = rv
            self.nbr_ok[i, ki] = True
        else:
            self.nbr[i, ki] = -1
            self.rev[i, ki] = 0
            self.nbr_ok[i, ki] = False

    def _slot_of(self, u: int, v: int) -> int:
        ks = np.flatnonzero((self.nbr[u] == v) & self.nbr_ok[u])
        if ks.size == 0:
            raise ScheduleError(f"no edge {u}->{v} in the mirror")
        return int(ks[0])

    def _free_slot(self, u: int, d: int | None = None) -> int | None:
        """First absent slot of u; with ``d``, not one already written in
        dispatch d's batch (a remove earlier in the batch frees it in the
        mirror, but writing it again would be two rows on one slot)."""
        ks = np.flatnonzero(~self.nbr_ok[u])
        if d is not None:
            touched = self._touched[d]
            ks = ks[[u * self.k + int(s) not in touched for s in ks]] if ks.size else ks
        return int(ks[0]) if ks.size else None

    def degree(self, u: int | None = None):
        return self._deg.copy() if u is None else int(self._deg[u])

    def has_edge(self, u: int, v: int) -> bool:
        return bool(((self.nbr[u] == v) & self.nbr_ok[u]).any())

    # -- mutation ops -------------------------------------------------------

    def add_edge(self, d: int, u: int, v: int) -> bool:
        """Install the undirected edge u—v (both slots, one batch). False
        (recording nothing) when an endpoint has no free slot left this
        dispatch; raises on a self-edge or a duplicate."""
        if u == v:
            raise ScheduleError(f"self-edge {u}")
        if self.has_edge(u, v):
            raise ScheduleError(f"edge {u}-{v} already present")
        ku, kv = self._free_slot(u, d), self._free_slot(v, d)
        if ku is None or kv is None:
            return False
        self._write(d, u * self.k + ku, v, kv, 1)
        self._write(d, v * self.k + kv, u, ku, 1)
        return True

    def remove_edge(self, d: int, u: int, v: int):
        """Clear the undirected edge u—v (both slots back to absent)."""
        ku = self._slot_of(u, v)
        kv = self._slot_of(v, u)
        self._write(d, u * self.k + ku, 0, 0, 0)
        self._write(d, v * self.k + kv, 0, 0, 0)

    def rewire(self, d: int, u: int, v: int, t: int) -> bool:
        """Move u's edge off v onto t in three rows: u's slot re-aims at t,
        v's reverse slot clears, t gains a slot pointing back. False when t
        has no free slot, or the edge was itself written this dispatch."""
        if t == u or self.has_edge(u, t):
            return False
        ku = self._slot_of(u, v)
        kv = self._slot_of(v, u)
        kt = self._free_slot(t, d)
        if kt is None:
            return False
        if {u * self.k + ku, v * self.k + kv} & self._touched[d]:
            return False
        self._write(d, u * self.k + ku, t, kt, 1)
        self._write(d, v * self.k + kv, 0, 0, 0)
        self._write(d, t * self.k + kt, u, ku, 1)
        self.n_rewires += 1
        return True

    def kill(self, d: int, p: int):
        """Peer p is down from dispatch d (its edges stay in the pool; the
        up plane masks them)."""
        self.up[p] = False
        self._up_rows[d:, p] = False
        self.n_kills += 1

    def revive(self, d: int, p: int):
        """Peer p is up again from dispatch d (the replacement node)."""
        self.up[p] = True
        self._up_rows[d:, p] = True

    def join(self, d: int, p: int, n_links: int, rng: np.random.Generator) -> int:
        """Preferential-attachment join: connect p to ``n_links`` distinct
        live targets drawn with probability proportional to degree + 1.
        Returns the links installed (capacity may refuse some)."""
        w = np.where(self.up, self._deg + 1.0, 0.0)
        w[p] = 0.0
        w[self.nbr[p][self.nbr_ok[p]]] = 0.0
        made = 0
        for _ in range(n_links):
            total = w.sum()
            if total <= 0 or self._free_slot(p) is None:
                break
            # ``rng.choice(self.n, p=w / total)`` without its checks of p:
            # the same cumulative sum and the same one draw, so the same
            # target (the checks cost most of a join at N=100k)
            cdf = (w / total).cumsum()
            cdf /= cdf[-1]
            t = int(cdf.searchsorted(rng.random(), side="right"))
            if self.add_edge(d, p, t):
                made += 1
            w[t] = 0.0
        self.n_joins += 1
        return made

    # -- compilation --------------------------------------------------------

    @property
    def mutation_dispatches(self) -> list[int]:
        return [d for d in range(self.n_dispatches) if self._rows[d]]

    def build(self, batch: int | None = None):
        """Pad to one batch width (at least 1) and return ``(writes [D, B,
        4] int32, up [D, N] bool)``; padding rows carry ``PAD_SLOT``."""
        widest = max((len(r) for r in self._rows), default=0)
        b = widest if batch is None else int(batch)
        if widest > b:
            raise ScheduleError(f"batch width {b} < widest dispatch ({widest} rows)")
        b = max(b, 1)
        writes = np.full((self.n_dispatches, b, 4), 0, np.int32)
        writes[:, :, 0] = PAD_SLOT
        for d, rows in enumerate(self._rows):
            for j, row in enumerate(rows):
                writes[d, j] = row
        return writes, self._up_rows.copy()

    def due_fn(self, check_every: int, grace_checks: int = 1, recover=None, quiet=None):
        """The invariant oracle's due-row factory for this program: sets
        ``DUE_MUT_GRACE`` on every check whose window saw a mutation batch
        (plus ``grace_checks - 1`` further checks), so the mutation-aware
        invariants (mesh-in-topology, first-edge-wf) grace the re-peering
        transient around mutation ticks. ``recover``/``quiet`` pass through
        to ``oracle.invariants.due_vector``."""
        from ..oracle import invariants as _oinv

        mut_ticks = sorted(t * self.rounds_per_dispatch for t in self.mutation_dispatches)
        span = int(check_every) * int(grace_checks)

        def fn(tick: int) -> np.ndarray:
            row = _oinv.due_vector(quiet=quiet, recover=recover)
            lo = tick - span
            if any(lo <= mt < tick + 1 for mt in mut_ticks):
                row[_oinv.DUE_MUT_GRACE] = 1
            return row

        return fn

    def schedule_hash(self) -> str:
        """sha256 over the compiled program (which storm ran)."""
        writes, up = self.build()
        h = hashlib.sha256()
        h.update(np.int64([self.n, self.k, self.n_dispatches,
                           self.rounds_per_dispatch]).tobytes())
        h.update(writes.tobytes())
        h.update(np.packbits(up).tobytes())
        return h.hexdigest()


def churn_storm(topo, *, n_dispatches: int, kill_frac: float = 0.2,
                kill_at: int | None = None, replace_at: int | None = None,
                rewires: int = 8, joins: int = 2, join_links: int = 2,
                rounds_per_dispatch: int = 1, seed: int = 0) -> MutationSchedule:
    """The standard churn storm: kill ``kill_frac`` of the peers at
    ``kill_at`` (default a quarter in), replace them at ``replace_at``
    (default half way: the same rows come back up and re-peer by
    preferential attachment), and spread ``rewires`` rewires and ``joins``
    joins over the other dispatches. ``topo`` is a ``graph.Topology``."""
    rng = np.random.default_rng(seed)
    s = MutationSchedule(topo.nbr, topo.nbr_ok, topo.rev, n_dispatches,
                         rounds_per_dispatch=rounds_per_dispatch)
    n = s.n
    kill_at = n_dispatches // 4 if kill_at is None else int(kill_at)
    replace_at = n_dispatches // 2 if replace_at is None else int(replace_at)
    victims = rng.choice(n, size=max(1, int(round(kill_frac * n))), replace=False)
    victims_set = set(int(v) for v in victims)
    slots = [d for d in range(1, n_dispatches) if d not in (kill_at, replace_at)]
    ops: list[tuple[int, str]] = []
    for j in range(rewires):
        ops.append((slots[(j * len(slots)) // max(rewires, 1) % len(slots)], "rewire"))
    for j in range(joins):
        off = [d for d in slots if d > replace_at] or slots
        ops.append((off[(j * len(off)) // max(joins, 1) % len(off)], "join"))
    ops.sort(key=lambda t: t[0])

    done_kill = done_replace = False
    for d in range(n_dispatches):
        if d == kill_at and not done_kill:
            for v in sorted(victims_set):
                s.kill(d, v)
            done_kill = True
        if d == replace_at and not done_replace:
            for v in sorted(victims_set):
                s.revive(d, v)
                s.join(d, v, join_links, rng)
            done_replace = True
        for od, kind in ops:
            if od != d:
                continue
            if kind == "rewire":
                live = np.flatnonzero(s.up & (s.degree() > 1))
                rng.shuffle(live)
                for u in live:
                    u = int(u)
                    nb = s.nbr[u][s.nbr_ok[u]]
                    if nb.size == 0:
                        continue
                    v = int(rng.choice(nb))
                    cand = np.flatnonzero(s.up)
                    t = int(rng.choice(cand))
                    if t not in (u, v) and not s.has_edge(u, t):
                        if s.rewire(d, u, v, t):
                            break
            elif kind == "join":
                live = np.flatnonzero(s.up)
                p = int(rng.choice(live))
                s.join(d, p, join_links, rng)
    return s
