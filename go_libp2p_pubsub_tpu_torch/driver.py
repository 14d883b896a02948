"""Drivers of the phase engine: its heartbeat schedule and the mesh
formation prelude (the JAX package's ``driver.py``; its scanned windows
are not ported yet — ROADMAP §1 item 2)."""

from __future__ import annotations

import math

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


def form_mesh(step, st, *, rounds_per_phase: int, pub_width: int = 4):
    """One publish-free phase with ``do_heartbeat=True``: its tail heartbeat
    selects every peer's mesh (Join's immediate mesh, gossipsub.go:1015-1064)
    and the next phase's control head ingests the GRAFTs before any data
    sub-round, so the first phase a caller publishes into sees a formed
    mesh. Advances the tick by ``rounds_per_phase``."""
    r = int(rounds_per_phase)
    dev = st.core.tick.device
    po = torch.full((r, pub_width), -1, dtype=torch.int32, device=dev)
    pt = torch.zeros((r, pub_width), dtype=torch.int32, device=dev)
    pv = torch.zeros((r, pub_width), dtype=torch.bool, device=dev)
    return step(st, po, pt, pv, do_heartbeat=True)
