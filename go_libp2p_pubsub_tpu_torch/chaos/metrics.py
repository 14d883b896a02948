"""Recovery metrics for chaos runs (the port's copy of the JAX package's
``chaos/metrics.py``: host-side numpy, and one device observer in torch).

Everything here is computed from artifacts a chaos run already
produces — the device delivery plane (``dlv.first_round`` + the message
table, the same planes the trace drain reconstructs DELIVER events
from), the cumulative event counters (trace/events.py — including the
chaos plane's LINK_DOWN and IWANT_RECOVER), per-round/phase mesh
snapshots, and the Scenario schedule (host-known partition windows).

The headline metrics, matching the v1.1 evaluation methodology's
degraded-network measurements (arxiv 2007.02754 §4):

  * **delivery ratio** — delivered / expected over (subscriber, live
    message) pairs; the loss a generator actually inflicted end-to-end;
  * **IWANT-recovery share** — the fraction of deliveries whose FIRST
    arrival rode an IWANT service rather than an eager push: the lazy
    gossip machinery's measured contribution under loss;
  * **mesh-repair latency** — rounds from a partition's heal until the
    cross-group mesh re-forms (from mesh snapshots + the group map);
  * **time-to-recover** — rounds from heal until every expected
    delivery of partition-era messages has landed.

Cadence caveat (same shape as the tracestat caveat block): under the
phase engine (r > 1) the LINK_DOWN / IWANT_RECOVER counters are exact
TOTALS but accumulate at phase cadence, and mesh snapshots exist only
at phase boundaries — latencies derived from them quantize to
multiples of r. The delivery plane keeps 1-round resolution at every
cadence (the device stamps ``first_round`` per sub-round).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..trace.events import EV


@dataclasses.dataclass
class DeliveryStats:
    """delivered / expected over (subscriber, message) pairs."""

    delivered: int
    expected: int

    @property
    def ratio(self) -> float:
        return self.delivered / self.expected if self.expected else 1.0


def expected_receivers(msg_birth: np.ndarray, msg_topic: np.ndarray,
                       msg_origin: np.ndarray, subscribed: np.ndarray,
                       up: np.ndarray | None = None,
                       born_in: tuple | None = None) -> np.ndarray:
    """[N, M] bool: peers that SHOULD receive each live message — topic
    subscribers excluding the origin (it has its own copy), optionally
    restricted to up peers and to messages born in ``born_in = (lo,
    hi)`` ticks (half-open)."""
    birth = np.asarray(msg_birth)
    live = birth >= 0
    if born_in is not None:
        lo, hi = born_in
        live = live & (birth >= lo) & (birth < hi)
    sub = np.asarray(subscribed)[:, np.clip(np.asarray(msg_topic), 0, None)]
    exp = sub & live[None, :]
    n = exp.shape[0]
    origin = np.clip(np.asarray(msg_origin), 0, n - 1)
    exp[origin[live], np.nonzero(live)[0]] = False
    if up is not None:
        exp &= np.asarray(up, bool)[:, None]
    return exp


def delivery_stats(first_round: np.ndarray, msg_birth, msg_topic,
                   msg_origin, subscribed, up=None,
                   born_in: tuple | None = None) -> DeliveryStats:
    """Delivery ratio from the device delivery plane. Caveat: slots
    recycle — only messages still resident in the table are counted,
    so size ``msg_slots`` above the run's publish volume (every chaos
    scenario in scripts/chaos_report.py does) or compute per-window
    with ``born_in``."""
    exp = expected_receivers(msg_birth, msg_topic, msg_origin, subscribed,
                             up=up, born_in=born_in)
    got = (np.asarray(first_round) >= 0) & exp
    return DeliveryStats(delivered=int(got.sum()), expected=int(exp.sum()))


def iwant_recovery_share(events: np.ndarray) -> float:
    """Fraction of validated deliveries whose FIRST arrival came via
    IWANT service (the chaos plane's IWANT_RECOVER counter over the
    DELIVER_MESSAGE counter). Requires a chaos-enabled build with
    ``count_events=True`` (the counter is statically elided otherwise).
    """
    ev = np.asarray(events)
    deliver = int(ev[EV.DELIVER_MESSAGE])
    return int(ev[EV.IWANT_RECOVER]) / deliver if deliver else 0.0


def links_down_total(events: np.ndarray) -> int:
    """Cumulative undirected link-down rounds (the LINK_DOWN counter)."""
    return int(np.asarray(events)[EV.LINK_DOWN])


def batched_iwant_shares(events) -> np.ndarray:
    """[S] per-sim IWANT-recovery shares from BATCHED ensemble event
    counters (``events [S, N_EVENTS]``) — iwant_recovery_share per
    sim, one vectorized reduction."""
    ev = np.asarray(events)
    deliver = ev[:, EV.DELIVER_MESSAGE].astype(np.float64)
    return np.where(deliver > 0,
                    ev[:, EV.IWANT_RECOVER] / np.maximum(deliver, 1.0),
                    0.0)


# ---------------------------------------------------------------------------
# partition recovery


def _cross_edge_mask(nbr, nbr_ok, groups) -> np.ndarray:
    """[N, K] bool: neighbor-slot positions whose edge crosses the
    group boundary — the ONE definition of "cross edge" every
    partition metric (single-sim and batched) counts with."""
    g = np.asarray(groups, np.int32)
    return ((g[:, None] != g[np.clip(np.asarray(nbr), 0, None)])
            & np.asarray(nbr_ok))


def cross_group_mesh_count(mesh: np.ndarray, nbr: np.ndarray,
                           nbr_ok: np.ndarray, groups) -> int:
    """Directed cross-group mesh edges in a mesh snapshot ([N, S, K])."""
    cross = _cross_edge_mask(nbr, nbr_ok, groups)
    return int((np.asarray(mesh) & cross[:, None, :]).sum())


def batched_cross_group_mesh_counts(mesh: np.ndarray, nbr: np.ndarray,
                                    nbr_ok: np.ndarray,
                                    groups) -> np.ndarray:
    """[S] directed cross-group mesh edge counts for a BATCHED
    ensemble mesh snapshot ([S, N, SL, K]) — cross_group_mesh_count
    per sim, one vectorized reduction."""
    cross = _cross_edge_mask(nbr, nbr_ok, groups)
    return (np.asarray(mesh) & cross[None, :, None, :]).sum(
        axis=(1, 2, 3)).astype(np.int64)


def make_cross_mesh_observer(nbr, nbr_ok, groups, device=None):
    """The device counterpart of :func:`batched_cross_group_mesh_counts`
    for a run window's ``observe=`` (``driver.make_window``): a function
    ``state -> int32 scalar`` counting directed cross-group mesh edges on
    the live mesh plane, so the per-round repair arc needs no host read
    inside the window. The same ``_cross_edge_mask``, so the series equals
    the host reduction. ``device`` holds the mask (default: the CPU)."""
    import torch

    cross = torch.as_tensor(_cross_edge_mask(nbr, nbr_ok, groups), device=device)

    def observe(state):
        mesh = state.mesh  # [..., N, SL, K]
        return (mesh & cross[:, None, :]).sum(dim=(-3, -2, -1), dtype=torch.int32)

    return observe


def mesh_repair_latency(mesh_series, heal_tick: int,
                        min_edges: int = 1) -> int | None:
    """Rounds from ``heal_tick`` until the cross-group mesh re-forms.

    ``mesh_series`` is an iterable of ``(tick, cross_edge_count)`` rows
    (the runner samples ``cross_group_mesh_count`` per round/phase).
    Returns the first ``tick - heal_tick`` at/after heal with count >=
    ``min_edges``, or None if the mesh never repairs in the observed
    window (infinite — the smoke asserts finiteness)."""
    for tick, count in sorted(mesh_series):
        if tick >= heal_tick and count >= min_edges:
            return int(tick - heal_tick)
    return None


def mesh_reform_latency(mesh_series, heal_tick: int,
                        prune_floor: int = 2,
                        min_edges: int = 6) -> int | None:
    """Rounds from ``heal_tick`` until cross-group connectivity is
    RE-ESTABLISHED after the post-heal starvation prune — the
    band-robust repair metric (round 10).

    The raw ``count >= min_edges`` reading (mesh_repair_latency) is
    ambiguous right after heal: the mesh map still lists partition-era
    ZOMBIE edges (entries that carried no traffic through the window;
    pruning their accumulated P3 deficit is heartbeat-rate-limited, so
    they drain over ~tens of rounds). Measured from the Monte Carlo
    band, the real arc is: zombie edges drain to ~zero, then the prune
    backoff expires and the reference's lazy 15-tick backoff-presence
    clear (gossipsub.go:1585-1604) releases a re-graft wave. This
    metric reports that arc: the first tick at/after the count drops
    to ``prune_floor`` or below (the trough — full starvation prune)
    where a LATER count reaches ``min_edges`` (re-formed), as
    ``tick - heal_tick``. A sim whose count never troughs — the
    starvation prune never completed, so cross connectivity never
    collapsed — reports 0 provided it stays above ``prune_floor`` for
    the whole post-heal window and ends re-formed (``>= min_edges``);
    None when the mesh troughs but never re-forms, or hovers below
    ``min_edges`` without ever recovering."""
    post = [(t, c) for t, c in sorted(mesh_series) if t >= heal_tick]
    troughed = False
    for tick, count in post:
        if not troughed:
            if count <= prune_floor:
                troughed = True
            continue
        if count >= min_edges:
            return int(tick - heal_tick)
    # never troughed == every post-heal count stayed above prune_floor
    if not troughed and post and post[-1][1] >= min_edges:
        return 0
    return None


def time_to_recover(first_round: np.ndarray, msg_birth, msg_topic,
                    msg_origin, subscribed, heal_tick: int,
                    born_in: tuple | None = None,
                    up=None) -> int | None:
    """Rounds from ``heal_tick`` until the LAST expected delivery of
    the window's messages landed (full eventual delivery). None when
    deliveries are still missing in the final state — recovery did not
    complete in the observed run."""
    exp = expected_receivers(msg_birth, msg_topic, msg_origin, subscribed,
                             up=up, born_in=born_in)
    fr = np.asarray(first_round)
    if not exp.any():
        return 0
    missing = exp & (fr < 0)
    if missing.any():
        return None
    return max(0, int(fr[exp].max()) - int(heal_tick))
