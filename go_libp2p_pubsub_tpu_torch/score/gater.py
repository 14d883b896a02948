"""Peer-gater counter state (peer_gater.go). The per-round step of this
slice runs without the gater; the state still carries its counters so the
state tree matches the JAX package leaf for leaf."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class GaterState:
    validate: torch.Tensor       # [N] f32 — messages entering validation
    throttle: torch.Tensor       # [N] f32 — throttle events
    last_throttle: torch.Tensor  # [N] i32 — tick of the last throttle
    deliver: torch.Tensor        # [N,K] f32 per-edge outcome counters
    duplicate: torch.Tensor
    ignore: torch.Tensor
    reject: torch.Tensor

    @classmethod
    def empty(cls, n: int, k: int, device) -> "GaterState":
        z = lambda: torch.zeros((n, k), dtype=torch.float32, device=device)
        return cls(
            validate=torch.zeros((n,), dtype=torch.float32, device=device),
            throttle=torch.zeros((n,), dtype=torch.float32, device=device),
            last_throttle=torch.full((n,), -(2**30), dtype=torch.int32,
                                     device=device),
            deliver=z(), duplicate=z(), ignore=z(), reject=z(),
        )
