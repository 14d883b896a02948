"""Router configuration: the static knob block of the post-v1.1 protocol
extensions (the port's own copy of the JAX package's ``routers/config.py``).

A frozen dataclass like ChaosConfig and TelemetryConfig: it rides the
step's closure, so every combination of switches builds its own step, and
an all-off block is refused (``router=None`` is the one spelling of "v1.1
semantics": the step without the plane, op for op).
"""

from __future__ import annotations

import dataclasses


class RouterConfigError(ValueError):
    """Raised by RouterConfig.validate() on invalid parameters."""


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Static router-plane switches.

    ``idontwant`` — GossipSub v1.2 duplicate suppression: on FIRST
    receipt of a message, a peer pushes the message id to its mesh
    neighbors as an IDONTWANT annotation riding the next round's
    control head (one-RTT control latency, like every other outbox),
    and senders mask their mesh data push against the announced plane.
    ``idontwant_threshold`` is the v1.2 size gate
    (IDontWantMessageThreshold): the sim's messages are unit-size, so
    the knob is a degenerate static — <= 1.0 makes every message
    eligible, > 1.0 none (a deliberately inert build for A/B).

    ``choke`` — episub-style lazy choking (Topiary, arXiv:2312.06800):
    a per-edge lateness EMA (fraction of arrivals that were NOT the
    first copy) drives heartbeat choke/unchoke decisions. A choked mesh
    link stays in the mesh but is demoted to lazy: the receiver stops
    accepting its eager data push (suppressed like IDONTWANT) and the
    sender learns it is choked via one extra edge gather per heartbeat,
    folding the choked link into its IHAVE gossip targets. Decisions
    are bounded so every topic slot keeps at least ``Dlo`` unchoked
    mesh links (the no-choke-below-Dlo invariant).

    ``latency_rounds`` — depth L of the per-edge delayed-commit ring:
    a static [N, K] integer delay plane (from topo.link_class_planes)
    holds each edge's delay in rounds, in [0, L]; an edge's data-plane
    commit lands that many rounds after the send decision. 0 = no ring
    (every edge commits immediately, the v1.1 step).
    """

    idontwant: bool = False
    idontwant_threshold: float = 1.0
    choke: bool = False
    choke_ema_alpha: float = 0.25
    choke_threshold: float = 0.6
    unchoke_threshold: float = 0.2
    choke_max_per_hb: int = 1
    latency_rounds: int = 0

    def validate(self) -> None:
        if self.latency_rounds < 0:
            raise RouterConfigError(
                f"latency_rounds must be >= 0, got {self.latency_rounds}"
            )
        if not (self.idontwant or self.choke or self.latency_rounds > 0):
            raise RouterConfigError(
                "all-off RouterConfig — spell v1.1 semantics as router=None "
                "(the elision contract is a single static branch)"
            )
        if self.choke:
            if not (0.0 < self.choke_ema_alpha <= 1.0):
                raise RouterConfigError(
                    f"choke_ema_alpha must lie in (0, 1], got {self.choke_ema_alpha}"
                )
            if self.unchoke_threshold >= self.choke_threshold:
                raise RouterConfigError(
                    "unchoke_threshold must be below choke_threshold "
                    f"(hysteresis), got {self.unchoke_threshold} >= "
                    f"{self.choke_threshold}"
                )
            if self.choke_max_per_hb < 1:
                raise RouterConfigError(
                    f"choke_max_per_hb must be >= 1, got {self.choke_max_per_hb}"
                )

    @property
    def idontwant_eligible(self) -> bool:
        """Static eligibility of the sim's unit-size messages under the
        v1.2 size threshold (a Python branch of the build)."""
        return self.idontwant and self.idontwant_threshold <= 1.0
