"""Scalar peer-score oracle: one observer node scoring its neighbors.

Independent transcription of score.go semantics in tick time, used as the
golden model for the vectorized engine (the role score_test.go's direct
`newPeerScore` driving plays in the reference — survey §4 tier 1).

State per (neighbor, topic): the topicStats fields (score.go:37-62).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..config import PeerScoreParams, ticks_for


@dataclass
class TStats:
    in_mesh: bool = False
    graft_tick: int = -1
    mesh_time: int = 0
    mmd_active: bool = False
    fmd: float = 0.0
    mmd: float = 0.0
    mfp: float = 0.0
    imd: float = 0.0


@dataclass
class OracleScore:
    params: PeerScoreParams
    heartbeat_interval: float = 1.0
    stats: dict = field(default_factory=dict)   # (nbr, topic) -> TStats
    bp: dict = field(default_factory=dict)      # nbr -> behaviour penalty

    def _t(self, p, topic) -> TStats | None:
        if topic not in self.params.topics:
            return None  # unscored topic: no counters (score.go:881-884)
        return self.stats.setdefault((p, topic), TStats())

    def _tp(self, topic):
        return self.params.topics[topic]

    # -- mesh transitions ---------------------------------------------------

    def graft(self, p, topic, tick):
        ts = self._t(p, topic)
        if ts is None:
            return
        ts.in_mesh = True
        ts.graft_tick = tick
        ts.mesh_time = 0
        ts.mmd_active = False

    def prune(self, p, topic):
        ts = self._t(p, topic)
        if ts is None:
            return
        tp = self._tp(topic)
        if ts.mmd_active and ts.mmd < tp.mesh_message_deliveries_threshold:
            deficit = tp.mesh_message_deliveries_threshold - ts.mmd
            ts.mfp += deficit * deficit
        ts.in_mesh = False

    # -- delivery attribution ----------------------------------------------

    def first_delivery(self, p, topic):
        """markFirstMessageDelivery (score.go:912-939)."""
        ts = self._t(p, topic)
        if ts is None:
            return
        tp = self._tp(topic)
        ts.fmd = min(ts.fmd + 1, tp.first_message_deliveries_cap)
        if ts.in_mesh:
            ts.mmd = min(ts.mmd + 1, tp.mesh_message_deliveries_cap)

    def duplicate_delivery(self, p, topic, in_window: bool):
        """markDuplicateMessageDelivery (score.go:944-974)."""
        ts = self._t(p, topic)
        if ts is None or not ts.in_mesh or not in_window:
            return
        tp = self._tp(topic)
        ts.mmd = min(ts.mmd + 1, tp.mesh_message_deliveries_cap)

    def invalid_delivery(self, p, topic):
        ts = self._t(p, topic)
        if ts is None:
            return
        ts.imd += 1

    def add_penalty(self, p, count):
        self.bp[p] = self.bp.get(p, 0.0) + count

    # -- maintenance ---------------------------------------------------------

    def refresh(self, tick):
        """refreshScores decay pass (score.go:497-558)."""
        dtz = self.params.decay_to_zero

        def dec(x, d):
            x *= d
            return 0.0 if x < dtz else x

        for (p, topic), ts in self.stats.items():
            tp = self._tp(topic)
            ts.fmd = dec(ts.fmd, tp.first_message_deliveries_decay)
            ts.mmd = dec(ts.mmd, tp.mesh_message_deliveries_decay)
            ts.mfp = dec(ts.mfp, tp.mesh_failure_penalty_decay)
            ts.imd = dec(ts.imd, tp.invalid_message_deliveries_decay)
            if ts.in_mesh:
                ts.mesh_time = tick - ts.graft_tick
                if ts.mesh_time > ticks_for(
                    tp.mesh_message_deliveries_activation, self.heartbeat_interval
                ):
                    ts.mmd_active = True
        for p in list(self.bp):
            self.bp[p] = dec(self.bp[p], self.params.behaviour_penalty_decay)

    # -- the score (score.go:258-335) ----------------------------------------

    def score(self, p, ip_count: int = 1, app_score: float = 0.0) -> float:
        total = 0.0
        for (q, topic), ts in self.stats.items():
            if q != p:
                continue
            tp = self._tp(topic)
            s = 0.0
            if ts.in_mesh:
                quantum = max(1, ticks_for(tp.time_in_mesh_quantum, self.heartbeat_interval))
                p1 = min(ts.mesh_time / quantum, tp.time_in_mesh_cap)
                s += p1 * tp.time_in_mesh_weight
            s += ts.fmd * tp.first_message_deliveries_weight
            if ts.mmd_active and ts.mmd < tp.mesh_message_deliveries_threshold:
                deficit = tp.mesh_message_deliveries_threshold - ts.mmd
                s += deficit * deficit * tp.mesh_message_deliveries_weight
            s += ts.mfp * tp.mesh_failure_penalty_weight
            s += ts.imd * ts.imd * tp.invalid_message_deliveries_weight
            total += s * tp.topic_weight

        if self.params.topic_score_cap > 0:
            total = min(total, self.params.topic_score_cap)

        total += app_score * self.params.app_specific_weight

        thr = self.params.ip_colocation_factor_threshold
        if ip_count > thr:
            surplus = ip_count - thr
            total += surplus * surplus * self.params.ip_colocation_factor_weight

        bp = self.bp.get(p, 0.0)
        if bp > self.params.behaviour_penalty_threshold:
            excess = bp - self.params.behaviour_penalty_threshold
            total += excess * excess * self.params.behaviour_penalty_weight

        return total
