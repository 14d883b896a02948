"""Cheap per-segment health probes (the JAX package's ``oracle/probes.py``).

The invariant oracle (``invariants.py``) is the deep end: 21 engine-aware
properties with a due/grace contract. Long runs also need a shallow end, a
few engine-agnostic predicates cheap enough for every segment boundary,
that turn silent state corruption (a NaN'd score plane, a counter that went
backwards through a bad resume) into a detected event:

  * ``finite-state`` — every floating-point tensor leaf of the state is
    finite (integer, bool and key leaves are skipped);
  * ``events-monotone`` — the event counters never decrease across a
    segment (against the segment-entry snapshot);
  * ``topo-involution`` (opt-in, dynamic-overlay states) — the mutable edge
    plane (``state.core.topo``) is still a well-formed involution
    (``ops.edges.involution_wf``, the predicate the oracle's
    ``edge-involution-wf`` checks);
  * ``delivery-floor`` — the segment's ``EV.DELIVER_MESSAGE`` delta is at
    least ``delivery_floor`` (0 only asks for a non-negative delta).

A probe is a plain function ``(state, prev_events) -> [P] bool`` (``[S,
P]`` batched) of device ops: it reads the live state and writes nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from ..trace.events import EV

#: probe evaluation order — the mask index space of every report
PROBE_NAMES = ("finite-state", "events-monotone", "topo-involution",
               "delivery-floor")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Which probes run, and the delivery floor (messages delivered per
    segment, per sim for batched states; 0 means "only require the delta
    to be non-negative"). ``topo_involution`` is opt-in and only valid
    against dynamic-overlay states (``state.core.topo`` present:
    ``GossipSubState.init(dynamic_topo=True)``)."""

    finite_state: bool = True
    events_monotone: bool = True
    topo_involution: bool = False
    delivery_floor: int = 0

    @property
    def names(self) -> tuple:
        out = []
        if self.finite_state:
            out.append("finite-state")
        if self.events_monotone:
            out.append("events-monotone")
        if self.topo_involution:
            out.append("topo-involution")
        out.append("delivery-floor")
        return tuple(out)


def _core_of(st):
    return st.core if hasattr(st, "core") else st


def health_check(state, prev_events, cfg: HealthConfig) -> torch.Tensor:
    """The probe predicate: ``[P] bool`` in ``cfg.names`` order.
    ``prev_events`` is the segment-entry counters snapshot."""
    from ..driver import _leaves

    core = _core_of(state)
    dev = core.events.device
    prev = torch.as_tensor(prev_events, dtype=core.events.dtype, device=dev)
    oks = []
    if cfg.finite_state:
        finite = [torch.isfinite(leaf).all() for leaf in _leaves(state)
                  if leaf.is_floating_point()]
        oks.append(torch.stack(finite).all() if finite
                   else torch.ones((), dtype=torch.bool, device=dev))
    if cfg.events_monotone:
        oks.append((core.events >= prev).all())
    if cfg.topo_involution:
        topo = getattr(core, "topo", None)
        if topo is None:
            raise ValueError(
                "HealthConfig.topo_involution=True needs a dynamic-"
                "overlay state (state.core.topo is None — build the "
                "state with dynamic_topo=True)")
        from ..ops import edges as _edges

        oks.append(_edges.involution_wf(topo.nbr, topo.rev, topo.nbr_ok, topo.edge_perm))
    delta = core.events[EV.DELIVER_MESSAGE] - prev[EV.DELIVER_MESSAGE]
    oks.append(delta >= int(cfg.delivery_floor))
    return torch.stack(oks)


def make_health_probe(cfg: HealthConfig, *, batched: bool = False):
    """The segment-boundary probe: ``(fn, names)``, ``fn(state,
    prev_events) -> [P] bool`` (``[S, P]`` when ``batched``: state and
    snapshot carry a leading sim axis, checked one sim after another). A
    plain function that writes nothing."""
    from .invariants import sim_state

    def check(state, prev_events):
        return health_check(state, prev_events, cfg)

    if not batched:
        return check, cfg.names

    def check_batched(states, prev_events):
        s_dim = _core_of(states).events.shape[0]
        return torch.stack([check(sim_state(states, s), prev_events[s])
                            for s in range(s_dim)])

    return check_batched, cfg.names
