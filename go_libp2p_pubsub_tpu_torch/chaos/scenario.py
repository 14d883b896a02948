"""Declarative chaos scenarios: scheduled partitions and crash storms (the
port's copy of the JAX package's ``chaos/scenario.py``, numpy only).

A :class:`Scenario` is a host-side schedule — windows of network
partition (the topology split into groups; every cross-group link is
forced down) and windows of peer crash (composed from the existing
churn plane's ``up`` vector, notify.go:19-75 / handleDeadPeers) — that
compiles to the per-round mask arguments the chaos-enabled steps take:

  * ``link_deny_at(tick, nbr)`` → the [N, K] bool forced-down mask the
    ``ChaosConfig(scheduled=True)`` step consumes (True = down);
  * ``up_at(tick)`` → the [N] liveness row a ``dynamic_peers`` build
    consumes.

Phase-cadence quantization: the phase engine applies control once per
phase and takes ONE ``link_deny`` per phase — partitions therefore
quantize to phase boundaries (use ``link_deny_at(phase_head_tick)``;
the mask holds for the whole phase), exactly like peer churn, whose
transitions also land once per phase at its head. Windows whose
start/end are not multiples of ``rounds_per_phase`` round OUTWARD for
partitions (the partition is at least as long as declared) via
``link_deny_at`` evaluated at the head tick — document any finer claim
against the per-round engine.

Everything here is deterministic host-side numpy: the same Scenario +
the same sim seed replays the identical fault sequence (the
determinism test pins a bit-identical trace), and ``scenario_hash``
gives artifacts a stable fingerprint of the schedule.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """Split the network into groups for ticks [start, start+rounds):
    links whose endpoints are in different groups are forced down; at
    ``start + rounds`` the partition heals."""

    start: int
    rounds: int
    groups: tuple  # [N] int group id per peer (tuple — hashable/frozen)

    @property
    def end(self) -> int:
        return self.start + self.rounds


@dataclasses.dataclass(frozen=True)
class CrashStorm:
    """Peers down (crashed) for ticks [start, start+rounds): composed
    from the churn plane — a dynamic_peers build disconnects them with
    full dead-peer cleanup and restarts them with fresh soft state."""

    start: int
    rounds: int
    peers: tuple  # peer indices

    @property
    def end(self) -> int:
        return self.start + self.rounds


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A reproducible fault schedule over one simulated run."""

    n_peers: int
    partitions: tuple = ()   # tuple[Partition, ...]
    crashes: tuple = ()      # tuple[CrashStorm, ...]

    def validate(self) -> None:
        for p in self.partitions:
            if len(p.groups) != self.n_peers:
                raise ValueError(
                    f"partition groups has {len(p.groups)} entries for "
                    f"{self.n_peers} peers"
                )
            if p.rounds <= 0:
                raise ValueError("partition window must be >= 1 round")
        for c in self.crashes:
            if c.rounds <= 0:
                raise ValueError("crash window must be >= 1 round")
            for i in c.peers:
                if not (0 <= i < self.n_peers):
                    raise ValueError(f"crash peer {i} out of range")

    # -- per-round mask compilation ---------------------------------------

    def link_deny_at(self, tick: int, nbr: np.ndarray) -> np.ndarray | None:
        """[N, K] bool forced-down mask active at ``tick`` (None when no
        partition window is active — callers may skip the argument-free
        round). ``nbr`` is the topology's neighbor table; padding slots
        (-1) are left False (they carry nothing anyway)."""
        nbr = np.asarray(nbr)
        deny = None
        for p in self.partitions:
            if not (p.start <= tick < p.end):
                continue
            g = np.asarray(p.groups, np.int32)
            cross = g[:, None] != g[np.clip(nbr, 0, None)]
            cross &= nbr >= 0
            deny = cross if deny is None else (deny | cross)
        return deny

    def up_at(self, tick: int) -> np.ndarray:
        """[N] bool liveness row active at ``tick`` (True = up)."""
        up = np.ones((self.n_peers,), bool)
        for c in self.crashes:
            if c.start <= tick < c.end:
                up[list(c.peers)] = False
        return up

    @property
    def scheduled(self) -> bool:
        """True when the scenario carries partition windows (the built
        step then needs ChaosConfig(scheduled=True))."""
        return bool(self.partitions)

    @property
    def dynamic(self) -> bool:
        """True when the scenario carries crash storms (the build then
        needs dynamic_peers=True)."""
        return bool(self.crashes)

    def horizon(self) -> int:
        """Last tick any window is active (run at least this long plus
        the recovery tail you want to measure)."""
        ends = [p.end for p in self.partitions] + [c.end for c in self.crashes]
        return max(ends) if ends else 0

    # -- reporting ---------------------------------------------------------

    def events(self) -> list:
        """The schedule as (tick, kind, detail) rows — the host-side
        PartitionStart/PartitionHeal/CrashStart/CrashHeal event stream
        (the chaos plane's scheduled faults are host-known, so these
        are exact; generator flaps are counted on device via the
        LINK_DOWN counter instead)."""
        out = []
        for i, p in enumerate(self.partitions):
            n_groups = len(set(p.groups))
            out.append((p.start, "PartitionStart",
                        {"partition": i, "groups": n_groups}))
            out.append((p.end, "PartitionHeal", {"partition": i}))
        for i, c in enumerate(self.crashes):
            out.append((c.start, "CrashStart",
                        {"storm": i, "peers": len(c.peers)}))
            out.append((c.end, "CrashHeal", {"storm": i}))
        return sorted(out, key=lambda e: (e[0], e[1]))

    def scenario_hash(self) -> str:
        """Stable short hash of the whole schedule (artifact chaos
        fingerprint field)."""
        h = hashlib.sha256()
        h.update(repr((self.n_peers,
                       [(p.start, p.rounds, tuple(p.groups))
                        for p in self.partitions],
                       [(c.start, c.rounds, tuple(c.peers))
                        for c in self.crashes])).encode())
        return h.hexdigest()[:12]


def halves(n: int) -> tuple:
    """The canonical 2-group split: peers [0, n/2) vs [n/2, n)."""
    return tuple(int(i >= n // 2) for i in range(n))


def two_group_partition(n: int, start: int, rounds: int,
                        groups: tuple | None = None) -> Scenario:
    """Convenience: one partition window splitting the net in half."""
    return Scenario(
        n_peers=n,
        partitions=(Partition(start=start, rounds=rounds,
                              groups=groups or halves(n)),),
    )
