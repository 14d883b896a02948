"""Validated parameter dataclasses (the port's own copy of the JAX
package's ``config.py``, trimmed to what the ported GossipSub steps read).

Mirrors the reference's config mechanism: params structs with
``validate()`` — GossipSubParams (gossipsub.go:62-199 with defaults at
gossipsub.go:31-59), PeerScoreParams / TopicScoreParams / PeerScoreThresholds
(score_params.go:12-268) — plus the package-level default vars, here
class-level defaults.

Time base: the reference uses wall-clock `time.Duration`; the simulator is
tick-quantized (1 tick == 1 heartbeat interval by default, matching how the
reference already quantizes maintenance to heartbeat ticks: DirectConnectTicks,
OpportunisticGraftTicks, backoff slack gossipsub.go:1596). All durations here
are kept in **seconds** (the reference's semantic unit) and converted to ticks
via `ticks_for(seconds, heartbeat_interval)` when the device state is built;
each conversion rounds up so "at least this long" semantics survive
quantization.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

# ---------------------------------------------------------------------------
# helpers


def _bad(x: float) -> bool:
    """isInvalidNumber: NaN or Inf (score_params.go:291-293)."""
    return math.isnan(x) or math.isinf(x)


DEFAULT_DECAY_INTERVAL = 1.0  # seconds (score_params.go:271)
DEFAULT_DECAY_TO_ZERO = 0.01  # score_params.go:272


def score_parameter_decay(
    decay_seconds: float,
    base_seconds: float = DEFAULT_DECAY_INTERVAL,
    decay_to_zero: float = DEFAULT_DECAY_TO_ZERO,
) -> float:
    """Per-interval decay factor so a counter hits ``decay_to_zero`` after
    ``decay_seconds`` (score_params.go:277-287)."""
    ticks = float(int(decay_seconds / base_seconds))
    if ticks == 0.0:
        # Go's integer Duration division yields 1/0 = +Inf and
        # math.Pow(decayToZero, +Inf) = 0.0 (score_params.go:285-286); the
        # decay validators then reject 0.0 with a clear error.
        return 0.0
    return decay_to_zero ** (1.0 / ticks)


class ConfigError(ValueError):
    """Raised by validate() on invalid parameters (mirrors the reference's
    error returns from the validate() methods)."""


# ---------------------------------------------------------------------------
# GossipSub parameters


@dataclass
class GossipSubParams:
    """GossipSub router parameters (gossipsub.go:62-199; defaults :31-59).

    Durations are seconds. `validate()` enforces the documented constraints
    (Dout < Dlo, Dout <= D/2 — gossipsub.go:84-90; HistoryGossip <=
    HistoryLength — mcache.go:23-28).
    """

    # overlay degree parameters (gossipsub.go:33-37)
    D: int = 6
    Dlo: int = 5
    Dhi: int = 12
    Dscore: int = 4
    Dout: int = 2

    # gossip parameters (gossipsub.go:38-42,56-58)
    history_length: int = 5
    history_gossip: int = 3
    Dlazy: int = 6
    gossip_factor: float = 0.25
    gossip_retransmission: int = 3
    max_ihave_length: int = 5000
    max_ihave_messages: int = 10
    iwant_followup_time: float = 3.0  # seconds (gossipsub.go:58)

    # heartbeat (gossipsub.go:43-44); the heartbeat interval defines the tick
    heartbeat_interval: float = 1.0
    heartbeat_initial_delay: float = 0.1
    slow_heartbeat_warning: float = 0.1  # fraction of interval (gossipsub.go:258)

    # fanout / prune / connect (gossipsub.go:45-55)
    fanout_ttl: float = 60.0
    prune_peers: int = 16
    prune_backoff: float = 60.0
    unsubscribe_backoff: float = 10.0
    connectors: int = 8
    max_pending_connections: int = 128
    connection_timeout: float = 30.0
    direct_connect_ticks: int = 300
    direct_connect_initial_delay: float = 1.0
    opportunistic_graft_ticks: int = 60
    opportunistic_graft_peers: int = 2
    graft_flood_threshold: float = 10.0

    # v1.1 feature switches (gossipsub.go options WithPeerExchange/
    # WithFloodPublish, gossipsub.go:306-330)
    do_px: bool = False
    flood_publish: bool = False

    def validate(self) -> None:
        if self.D < 0 or self.Dlo < 0 or self.Dhi < self.Dlo or self.D < self.Dlo or self.D > self.Dhi:
            raise ConfigError(
                "invalid degree params; need 0 <= Dlo <= D <= Dhi, got "
                f"Dlo={self.Dlo} D={self.D} Dhi={self.Dhi}"
            )
        if self.Dscore < 0 or self.Dscore > self.D:
            raise ConfigError(
                "invalid Dscore; must be within [0, D], got "
                f"Dscore={self.Dscore} D={self.D}"
            )
        # Dout must be set below Dlo and must not exceed D/2 (gossipsub.go:89)
        if self.Dout >= self.Dlo or self.Dout > self.D // 2:
            raise ConfigError(
                "invalid Dout; must be < Dlo and <= D/2, got "
                f"Dout={self.Dout} Dlo={self.Dlo} D={self.D}"
            )
        # gossip slots cannot exceed history slots (mcache.go:23-28)
        if self.history_gossip > self.history_length:
            raise ConfigError("invalid mcache params; history_gossip must be <= history_length")
        if self.history_length <= 0 or self.history_gossip <= 0:
            raise ConfigError("invalid mcache params; history slots must be positive")
        if not (0.0 <= self.gossip_factor <= 1.0):
            raise ConfigError("invalid gossip_factor; must be in [0,1]")
        if self.heartbeat_interval <= 0:
            raise ConfigError("invalid heartbeat_interval; must be positive")
        if self.max_ihave_length <= 0 or self.max_ihave_messages <= 0:
            raise ConfigError("invalid IHAVE flood-protection caps; must be positive")
        if self.gossip_retransmission < 0:
            raise ConfigError("invalid gossip_retransmission; must be >= 0")


# ---------------------------------------------------------------------------
# Peer score parameters


@dataclass
class TopicScoreParams:
    """Per-topic score parameters (score_params.go:98-148).

    Weight-sign conventions enforced exactly as score_params.go:200-268:
    P1/P2 weights >= 0, P3/P3b/P4 weights <= 0.
    """

    topic_weight: float = 0.5

    # P1: time in mesh (score_params.go:102-108)
    time_in_mesh_weight: float = 1.0
    time_in_mesh_quantum: float = 1.0  # seconds
    time_in_mesh_cap: float = 3600.0

    # P2: first message deliveries (score_params.go:110-116)
    first_message_deliveries_weight: float = 1.0
    first_message_deliveries_decay: float = 0.5
    first_message_deliveries_cap: float = 2000.0

    # P3: mesh message delivery deficit (score_params.go:118-134)
    mesh_message_deliveries_weight: float = -1.0
    mesh_message_deliveries_decay: float = 0.5
    mesh_message_deliveries_cap: float = 100.0
    mesh_message_deliveries_threshold: float = 20.0
    mesh_message_deliveries_window: float = 0.01  # seconds
    mesh_message_deliveries_activation: float = 1.0  # seconds

    # P3b: sticky mesh failure penalty (score_params.go:136-140)
    mesh_failure_penalty_weight: float = -1.0
    mesh_failure_penalty_decay: float = 0.5

    # P4: invalid messages (score_params.go:142-147)
    invalid_message_deliveries_weight: float = -1.0
    invalid_message_deliveries_decay: float = 0.3

    def validate(self) -> None:
        if self.topic_weight < 0 or _bad(self.topic_weight):
            raise ConfigError("invalid topic weight; must be >= 0")
        # P1 (score_params.go:207-218)
        if self.time_in_mesh_quantum == 0:
            raise ConfigError("invalid time_in_mesh_quantum; must be non zero")
        if self.time_in_mesh_weight < 0 or _bad(self.time_in_mesh_weight):
            raise ConfigError("invalid time_in_mesh_weight; must be positive (or 0 to disable)")
        if self.time_in_mesh_weight != 0 and self.time_in_mesh_quantum <= 0:
            raise ConfigError("invalid time_in_mesh_quantum; must be positive")
        if self.time_in_mesh_weight != 0 and (self.time_in_mesh_cap <= 0 or _bad(self.time_in_mesh_cap)):
            raise ConfigError("invalid time_in_mesh_cap; must be positive")
        # P2 (score_params.go:221-229)
        if self.first_message_deliveries_weight < 0 or _bad(self.first_message_deliveries_weight):
            raise ConfigError("invalid first_message_deliveries_weight; must be positive (or 0 to disable)")
        if self.first_message_deliveries_weight != 0:
            if not (0.0 < self.first_message_deliveries_decay < 1.0) or _bad(self.first_message_deliveries_decay):
                raise ConfigError("invalid first_message_deliveries_decay; must be between 0 and 1")
            if self.first_message_deliveries_cap <= 0 or _bad(self.first_message_deliveries_cap):
                raise ConfigError("invalid first_message_deliveries_cap; must be positive")
        # P3 (score_params.go:232-248)
        if self.mesh_message_deliveries_weight > 0 or _bad(self.mesh_message_deliveries_weight):
            raise ConfigError("invalid mesh_message_deliveries_weight; must be negative (or 0 to disable)")
        if self.mesh_message_deliveries_weight != 0:
            if not (0.0 < self.mesh_message_deliveries_decay < 1.0) or _bad(self.mesh_message_deliveries_decay):
                raise ConfigError("invalid mesh_message_deliveries_decay; must be between 0 and 1")
            if self.mesh_message_deliveries_cap <= 0 or _bad(self.mesh_message_deliveries_cap):
                raise ConfigError("invalid mesh_message_deliveries_cap; must be positive")
            if self.mesh_message_deliveries_threshold <= 0 or _bad(self.mesh_message_deliveries_threshold):
                raise ConfigError("invalid mesh_message_deliveries_threshold; must be positive")
            if self.mesh_message_deliveries_activation < 1.0:
                raise ConfigError("invalid mesh_message_deliveries_activation; must be at least 1s")
        if self.mesh_message_deliveries_window < 0:
            raise ConfigError("invalid mesh_message_deliveries_window; must be non-negative")
        # P3b (score_params.go:252-257)
        if self.mesh_failure_penalty_weight > 0 or _bad(self.mesh_failure_penalty_weight):
            raise ConfigError("invalid mesh_failure_penalty_weight; must be negative (or 0 to disable)")
        if self.mesh_failure_penalty_weight != 0 and (
            not (0.0 < self.mesh_failure_penalty_decay < 1.0) or _bad(self.mesh_failure_penalty_decay)
        ):
            raise ConfigError("invalid mesh_failure_penalty_decay; must be between 0 and 1")
        # P4 (score_params.go:260-265)
        if self.invalid_message_deliveries_weight > 0 or _bad(self.invalid_message_deliveries_weight):
            raise ConfigError("invalid invalid_message_deliveries_weight; must be negative (or 0 to disable)")
        if not (0.0 < self.invalid_message_deliveries_decay < 1.0) or _bad(self.invalid_message_deliveries_decay):
            raise ConfigError("invalid invalid_message_deliveries_decay; must be between 0 and 1")


@dataclass
class PeerScoreParams:
    """Global peer-score parameters (score_params.go:53-96).

    ``topics`` maps topic-id -> TopicScoreParams; unscored topics contribute
    nothing (score.go:269-273). ``app_specific_score`` is the P5 injection
    point (score_params.go:62); in the vectorized engine it is evaluated on
    the host into a per-peer array.
    """

    topics: Dict[int, TopicScoreParams] = field(default_factory=dict)
    topic_score_cap: float = 0.0  # 0 = no cap (score_params.go:57-59)

    app_specific_score: Optional[Callable[[int], float]] = None
    app_specific_weight: float = 0.0

    # P6 (score_params.go:65-75)
    ip_colocation_factor_weight: float = 0.0
    ip_colocation_factor_threshold: int = 1
    # whitelist is modeled as a set of exempt ip-group ids (the sim's analogue
    # of IPColocationFactorWhitelist CIDR ranges)
    ip_colocation_factor_whitelist: frozenset = frozenset()

    # P7 (score_params.go:77-86)
    behaviour_penalty_weight: float = 0.0
    behaviour_penalty_threshold: float = 0.0
    behaviour_penalty_decay: float = 0.9

    decay_interval: float = DEFAULT_DECAY_INTERVAL  # seconds
    decay_to_zero: float = DEFAULT_DECAY_TO_ZERO
    retain_score: float = 3600.0  # seconds

    skip_app_specific: bool = False  # sim-only: allow omitting P5 callback

    def validate(self) -> None:
        for tid, tp in self.topics.items():
            try:
                tp.validate()
            except ConfigError as e:
                raise ConfigError(f"invalid score parameters for topic {tid}: {e}") from e
        if self.topic_score_cap < 0 or _bad(self.topic_score_cap):
            raise ConfigError("invalid topic score cap; must be positive (or 0 for no cap)")
        if self.app_specific_score is None and not self.skip_app_specific:
            raise ConfigError("missing application specific score function")
        if self.ip_colocation_factor_weight > 0 or _bad(self.ip_colocation_factor_weight):
            raise ConfigError("invalid ip_colocation_factor_weight; must be negative (or 0 to disable)")
        if self.ip_colocation_factor_weight != 0 and self.ip_colocation_factor_threshold < 1:
            raise ConfigError("invalid ip_colocation_factor_threshold; must be at least 1")
        if self.behaviour_penalty_weight > 0 or _bad(self.behaviour_penalty_weight):
            raise ConfigError("invalid behaviour_penalty_weight; must be negative (or 0 to disable)")
        if self.behaviour_penalty_weight != 0 and (
            not (0.0 < self.behaviour_penalty_decay < 1.0) or _bad(self.behaviour_penalty_decay)
        ):
            raise ConfigError("invalid behaviour_penalty_decay; must be between 0 and 1")
        if self.behaviour_penalty_threshold < 0 or _bad(self.behaviour_penalty_threshold):
            raise ConfigError("invalid behaviour_penalty_threshold; must be >= 0")
        if self.decay_interval < 1.0:
            raise ConfigError("invalid decay_interval; must be at least 1s")
        if not (0.0 < self.decay_to_zero < 1.0) or _bad(self.decay_to_zero):
            raise ConfigError("invalid decay_to_zero; must be between 0 and 1")
        # retain_score: 0 means no retention (score_params.go:196)


@dataclass
class PeerScoreThresholds:
    """Score thresholds (score_params.go:12-51)."""

    gossip_threshold: float = -10.0
    publish_threshold: float = -50.0
    graylist_threshold: float = -80.0
    accept_px_threshold: float = 10.0
    opportunistic_graft_threshold: float = 20.0

    def validate(self) -> None:
        if self.gossip_threshold > 0 or _bad(self.gossip_threshold):
            raise ConfigError("invalid gossip threshold; it must be <= 0")
        if self.publish_threshold > 0 or self.publish_threshold > self.gossip_threshold or _bad(self.publish_threshold):
            raise ConfigError("invalid publish threshold; it must be <= 0 and <= gossip threshold")
        if self.graylist_threshold > 0 or self.graylist_threshold > self.publish_threshold or _bad(self.graylist_threshold):
            raise ConfigError("invalid graylist threshold; it must be <= 0 and <= publish threshold")
        if self.accept_px_threshold < 0 or _bad(self.accept_px_threshold):
            raise ConfigError("invalid accept PX threshold; it must be >= 0")
        if self.opportunistic_graft_threshold < 0 or _bad(self.opportunistic_graft_threshold):
            raise ConfigError("invalid opportunistic grafting threshold; it must be >= 0")


# ---------------------------------------------------------------------------
# Peer gater parameters


@dataclass
class PeerGaterParams:
    """Peer gater (random-early-drop admission control) parameters
    (peer_gater.go:31-116; defaults :19-28)."""

    threshold: float = 0.33
    global_decay: float = field(default_factory=lambda: score_parameter_decay(120.0))
    source_decay: float = field(default_factory=lambda: score_parameter_decay(3600.0))
    decay_interval: float = DEFAULT_DECAY_INTERVAL
    decay_to_zero: float = DEFAULT_DECAY_TO_ZERO
    retain_stats: float = 6 * 3600.0
    quiet: float = 60.0
    duplicate_weight: float = 0.125
    ignore_weight: float = 1.0
    reject_weight: float = 16.0
    topic_delivery_weights: Dict[int, float] = field(default_factory=dict)

    def validate(self) -> None:
        # peer_gater.go:57-88
        if self.threshold <= 0:
            raise ConfigError("invalid threshold; must be > 0")
        if not (0.0 < self.global_decay < 1.0):
            raise ConfigError("invalid global_decay; must be between 0 and 1")
        if not (0.0 < self.source_decay < 1.0):
            raise ConfigError("invalid source_decay; must be between 0 and 1")
        if self.decay_interval < 1.0:
            raise ConfigError("invalid decay_interval; must be at least 1s")
        if not (0.0 < self.decay_to_zero < 1.0):
            raise ConfigError("invalid decay_to_zero; must be between 0 and 1")
        if self.quiet < 1.0:
            raise ConfigError("invalid quiet interval; must be at least 1s")
        if self.duplicate_weight <= 0:
            raise ConfigError("invalid duplicate_weight; must be > 0")
        if self.ignore_weight < 1:
            raise ConfigError("invalid ignore_weight; must be >= 1")
        if self.reject_weight < 1:
            raise ConfigError("invalid reject_weight; must be >= 1")


def ticks_for(seconds: float, heartbeat_interval: float) -> int:
    """Duration (s) -> heartbeat ticks under a given heartbeat interval;
    rounds up, so "at least this long" survives quantization."""
    if seconds <= 0:
        return 0
    return max(1, math.ceil(seconds / heartbeat_interval))


def default_topic_score_params() -> TopicScoreParams:
    return TopicScoreParams()


def default_peer_score_params(n_topics: int = 1) -> PeerScoreParams:
    """The JAX package's API default: every topic at the default topic
    parameters, P7 and P6 weighted."""
    return PeerScoreParams(
        topics={t: TopicScoreParams() for t in range(n_topics)},
        skip_app_specific=True,
        behaviour_penalty_weight=-1.0,
        behaviour_penalty_threshold=1.0,
        behaviour_penalty_decay=0.9,
        ip_colocation_factor_weight=-1.0,
        ip_colocation_factor_threshold=4,
    )
