"""Scalar GossipSub oracle: a per-node Python transcription of the
reference protocol (gossipsub.go) under the simulator's synchronous-round
timing, used as the parity target for the vectorized router.

Scope: the data+control plane — mesh maintenance (gossipsub.go:1344-1515),
GRAFT/PRUNE with backoff (handleGraft :718-809, handlePrune :811-843),
IHAVE/IWANT lazy gossip with flood caps (handleIHave :615-677,
handleIWant :679-716), mcache windows (mcache.go), flood-publish
(gossipsub.go:957-963) — and, when `score_params` is given, the COMPOSED
v1.1 machine: the live score plane (one oracle/score.OracleScore per
node), threshold gating (gossip/publish/graylist), score-directed mesh
maintenance incl. opportunistic grafting, IWANT promises at the
reference's per-batch granularity (gossip_tracer.go:48-75 — one random
message per IWANT batch, several batches outstanding per peer), fanout
for publishes to unjoined topics (gossipsub.go:981-1002, 1517-1554), and
the sybil adversary vector (control-plane-only peers).

RNG parity with the vectorized engine is impossible by design (survey §7
hard-part (d)); the oracle draws from its own `random.Random`, and parity
is asserted *distributionally*: propagation-latency CDFs within 2%
(BASELINE.json north_star).

Round ordering mirrors models/gossipsub.py `_round` exactly:
  1. GRAFT/PRUNE ingest (sent by neighbors last round)
  2. IWANT service (requests I issued last round -> extra deliveries)
  3. IHAVE ingest (advertisements from neighbors' last heartbeat -> asks)
  4. mesh/flood delivery of senders' forward sets, then IWANT merges
  5. mcache put of validated new receipts
  6. publish interning (transmits next round)
  7. heartbeat: promise penalties, score refresh + memoization, backoff
     clear, mesh maintenance, fanout maintenance, emitGossip, mcache shift
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..config import PeerScoreParams, ticks_for
from ..graph import Subscriptions, Topology
from ..models.gossipsub import GossipSubConfig
from ..trace.events import EV, N_EVENTS
from .score import OracleScore


@dataclass
class OMsg:
    slot: int
    topic: int
    origin: int
    birth: int
    valid: bool
    ignored: bool = False


@dataclass
class OracleGossipSub:
    topo: Topology
    subs: Subscriptions
    cfg: GossipSubConfig
    msg_slots: int = 64
    seed: int = 0
    score_params: PeerScoreParams | None = None
    adversary: set | None = None   # peer idx that never transmit data

    tick: int = 0
    msgs: dict = field(default_factory=dict)   # slot -> OMsg
    cursor: int = 0
    first_round: dict = field(default_factory=dict)  # (i, slot) -> round
    first_edge: dict = field(default_factory=dict)   # (i, slot) -> k | -1

    def __post_init__(self):
        assert self.cfg.score_enabled == (self.score_params is not None), (
            "score_params must accompany score_enabled"
        )
        # heartbeat_every = h > 1 is the reference's ACTUAL timing shape
        # (gossipsub.go:1278-1301): delivery + control PROCESSING stay
        # continuous (every round — the reference handles GRAFT/PRUNE/
        # IHAVE/IWANT on RPC arrival), while the heartbeat batch — score
        # refresh + memoization, promise penalties, backoff clear, mesh
        # maintenance, fanout maintenance, gossip EMISSION, mcache shift
        # — runs only at ticks ≡ h-1 (mod h), the same executed ticks as
        # the phase engine's tail heartbeat at rounds_per_phase = h. This
        # is the oracle anchor for the phase-vs-reference parity rows
        # (tests/test_parity_phase_oracle.py): unlike the phase engine it
        # does NOT defer control ingest/service, so the measured distance
        # includes the phase engine's extra control-batching latency.
        assert self.cfg.heartbeat_every >= 1
        if self.cfg.validation_delay_topic is not None:
            assert len(self.cfg.validation_delay_topic) == self.subs.n_topics, (
                "validation_delay_topic must cover every topic"
            )
        # async-validation pipeline (survey §7 hard-part (c)): a receipt's
        # verdict lands validation-delay rounds after arrival; per-topic
        # delays (cfg.validation_delay_topic) make verdicts interleave out
        # of arrival order (validation.go:123-135,391-438)
        self.pending = {}  # (i, slot) -> verdict tick
        n = self.topo.n_peers
        self.rng = random.Random(self.seed)
        self.seen = [set() for _ in range(n)]
        self.fwd = [set() for _ in range(n)]
        # mesh[i][t] = set of edge slots k
        self.mesh = [dict() for _ in range(n)]
        for i in range(n):
            for t in range(self.subs.n_topics):
                if self.subs.subscribed[i, t]:
                    self.mesh[i][t] = set()
        self.backoff_expire = [dict() for _ in range(n)]  # (t,k) -> tick
        self.backoff_present = [set() for _ in range(n)]  # {(t,k)}
        # mcache windows: index 0 = current heartbeat (mcache.go:94-104)
        self.mcache = [[set() for _ in range(self.cfg.history_length)]
                       for _ in range(n)]
        self.ihave_out = [dict() for _ in range(n)]  # k -> set(slot)
        self.iwant_out = [dict() for _ in range(n)]  # k -> set(slot)
        self.graft_out = [set() for _ in range(n)]   # {(t, k)}
        self.prune_out = [set() for _ in range(n)]   # {(t, k)}
        self.peerhave = [dict() for _ in range(n)]   # k -> int
        self.iasked = [dict() for _ in range(n)]     # k -> int
        self.served = [dict() for _ in range(n)]     # (k, slot) -> count
        self.events = [0] * N_EVENTS
        self.adversary = self.adversary or set()
        self._gossip_suppress = set()  # (i, k): congested outbound links
        # v1.1 composed plane
        if self.score_params is not None:
            self.oscore = [OracleScore(self.score_params) for _ in range(n)]
            self.scores = [dict() for _ in range(n)]  # k -> memoized score
            # IWANT promises at the reference granularity: one random msg
            # per IWANT batch, any number outstanding per edge
            # (gossip_tracer.go:48-75); (k, slot) -> expire tick
            self.promises = [dict() for _ in range(n)]
        # fanout: t -> set of edge slots; lastpub: t -> tick
        # (gossipsub.go:444-447 fanout + lastpub maps)
        self.fanout = [dict() for _ in range(n)]
        self.fanout_lastpub = [dict() for _ in range(n)]

    # -- score helpers ------------------------------------------------------

    def _score(self, i, k) -> float:
        """Peer i's memoized score of its edge-slot-k neighbor (the
        per-heartbeat cache, gossipsub.go:1333-1341)."""
        if self.score_params is None:
            return 0.0
        return self.scores[i].get(k, 0.0)

    def _acc_ok(self, i, k) -> bool:
        """AcceptFrom graylist gate (gossipsub.go:583-594)."""
        if self.score_params is None:
            return True
        return self._score(i, k) >= self.cfg.graylist_threshold

    # -- helpers ------------------------------------------------------------

    def _edges(self, i):
        """Valid (k, s, r): edge slot k to neighbor s whose reverse slot is r."""
        topo = self.topo
        for k in range(topo.max_degree):
            if topo.nbr_ok[i, k]:
                yield k, int(topo.nbr[i, k]), int(topo.rev[i, k])

    def _sample(self, pool, k):
        pool = sorted(pool)
        if k <= 0 or not pool:
            return set()
        if k >= len(pool):
            return set(pool)
        return set(self.rng.sample(pool, k))

    def _vdelay(self, topic) -> int:
        """Rounds between arrival and verdict for a topic's messages."""
        if self.cfg.validation_delay_rounds <= 0:
            return 0
        if self.cfg.validation_delay_topic is not None:
            return self.cfg.validation_delay_topic[topic]
        return self.cfg.validation_delay_rounds

    def _recycle(self, slot):
        self.msgs.pop(slot, None)
        for i in range(self.topo.n_peers):
            self.seen[i].discard(slot)
            self.fwd[i].discard(slot)
            self.first_round.pop((i, slot), None)
            self.first_edge.pop((i, slot), None)
            self.pending.pop((i, slot), None)
            for w in self.mcache[i]:
                w.discard(slot)
            for d in (self.ihave_out[i], self.iwant_out[i]):
                for s in d.values():
                    s.discard(slot)
            for key in [key for key in self.served[i] if key[1] == slot]:
                del self.served[i][key]
            if self.score_params is not None:
                for key in [k for k in self.promises[i] if k[1] == slot]:
                    del self.promises[i][key]

    def publish(self, origin, topic, valid=True, ignored=False):
        slot = self.cursor % self.msg_slots
        self.cursor += 1
        self._recycle(slot)
        self.msgs[slot] = OMsg(slot, topic, origin, self.tick, valid, ignored)
        self.seen[origin].add(slot)
        self.fwd[origin].add(slot)
        self.first_round[(origin, slot)] = self.tick
        self.first_edge[(origin, slot)] = -1
        self.mcache[origin][0].add(slot)
        self.events[EV.PUBLISH_MESSAGE] += 1
        # publish to an unjoined topic creates/refreshes a fanout slot with
        # D random eligible peers (gossipsub.go:981-1002)
        if topic not in self.mesh[origin] and self.cfg.fanout_slots > 0:
            if not self.fanout[origin].get(topic):
                cand = {
                    k for k, s, r in self._edges(origin)
                    if self.subs.subscribed[s, topic]
                }
                if self.score_params is not None:
                    cand = {
                        k for k in cand
                        if self._score(origin, k) >= self.cfg.publish_threshold
                    }
                self.fanout[origin][topic] = self._sample(cand, self.cfg.D)
            self.fanout_lastpub[origin][topic] = self.tick
        return slot

    # -- one round ----------------------------------------------------------

    def step(self, publishes=()):
        cfg, topo, subs = self.cfg, self.topo, self.subs
        n = topo.n_peers
        tick = self.tick

        # 1. GRAFT/PRUNE ingest (handle_graft_prune)
        prune_resp = [set() for _ in range(n)]
        for i in range(n):
            incoming_graft, incoming_prune = [], []
            for k, s, r in self._edges(i):
                if not self._acc_ok(i, k):
                    continue  # graylisted: whole RPC dropped
                for (t, ks) in self.graft_out[s]:
                    if ks == r and t in self.mesh[i]:
                        incoming_graft.append((t, k))
                for (t, ks) in self.prune_out[s]:
                    if ks == r and t in self.mesh[i]:
                        incoming_prune.append((t, k))
            # handlePrune first (the vectorized handler masks mesh before
            # computing graft admission)
            for (t, k) in incoming_prune:
                if k in self.mesh[i][t]:
                    self.mesh[i][t].discard(k)
                    if self.score_params is not None:
                        self.oscore[i].prune(k, t)  # sticky P3b
                    self.events[EV.PRUNE] += 1
                be = self.backoff_expire[i]
                be[(t, k)] = max(be.get((t, k), 0), tick + cfg.prune_backoff_ticks)
                self.backoff_present[i].add((t, k))
            # handleGraft: one degree snapshot for all of this round's grafts
            deg0 = {t: len(m) for t, m in self.mesh[i].items()}
            for (t, k) in incoming_graft:
                if k in self.mesh[i][t]:
                    continue
                be = self.backoff_expire[i].get((t, k), None)
                backoff_active = (t, k) in self.backoff_present[i] and (
                    be is not None and tick < be
                )
                if backoff_active and self.score_params is not None:
                    # backoff-GRAFT behaviour penalty, doubled inside the
                    # flood window (gossipsub.go:753-770)
                    flood_cutoff = (be or 0) + (
                        cfg.graft_flood_ticks - cfg.prune_backoff_ticks
                    )
                    self.oscore[i].add_penalty(
                        k, 2 if tick < flood_cutoff else 1
                    )
                neg_score = (
                    self.score_params is not None and self._score(i, k) < 0
                )
                full = deg0[t] >= cfg.Dhi and not topo.outbound[i, k]
                if backoff_active or neg_score or full:
                    prune_resp[i].add((t, k))
                    be2 = self.backoff_expire[i]
                    be2[(t, k)] = max(be2.get((t, k), 0), tick + cfg.prune_backoff_ticks)
                    self.backoff_present[i].add((t, k))
                else:
                    self.mesh[i][t].add(k)
                    if self.score_params is not None:
                        self.oscore[i].graft(k, t, tick)
                    self.events[EV.GRAFT] += 1

        # 2. IWANT service (iwant_responses): what I asked last round, from
        # the neighbor's full mcache window, capped per (edge, msg)
        extra = [dict() for _ in range(n)]  # i -> {slot: [k,...]}
        for i in range(n):
            for k, s, r in self._edges(i):
                asked = self.iwant_out[i].get(k, ())
                if not asked or s in self.adversary:
                    continue
                if self.score_params is not None and (
                    self.scores[s].get(r, 0.0) < cfg.gossip_threshold
                ):
                    continue  # responder ignores low-score requesters
                              # (gossipsub.go:681-685)
                window = set().union(*self.mcache[s])
                for slot in asked:
                    if slot not in window:
                        continue
                    cnt = self.served[i].get((k, slot), 0)
                    if cnt >= min(max(cfg.gossip_retransmission, 0), 3):
                        continue
                    self.served[i][(k, slot)] = cnt + 1
                    extra[i].setdefault(slot, []).append(k)

        # 3. IHAVE ingest (handle_ihave) -> next round's asks
        new_iwant = [dict() for _ in range(n)]
        for i in range(n):
            for k, s, r in self._edges(i):
                advertised = self.ihave_out[s].get(r, ())
                if not advertised or not self._acc_ok(i, k):
                    continue
                if self.score_params is not None and (
                    self._score(i, k) < cfg.gossip_threshold
                ):
                    continue  # score gate precedes the counter in the
                              # reference (gossipsub.go:616-628)
                ph = self.peerhave[i].get(k, 0) + 1
                self.peerhave[i][k] = ph
                if ph > cfg.max_ihave_messages:
                    continue
                ia = self.iasked[i].get(k, 0)
                if ia >= cfg.max_ihave_length:
                    continue
                wants = sorted(
                    slot for slot in advertised
                    if slot not in self.seen[i]
                    and self.msgs[slot].topic in self.mesh[i]
                )
                budget = cfg.max_ihave_length - ia
                if len(wants) > budget:
                    # the reference shuffles before truncating
                    # (gossipsub.go:655-667); the engine keeps lowest
                    # slots — tests/test_promise_sensitivity.py bounds
                    # the distributional impact of that approximation
                    asks = sorted(self.rng.sample(wants, budget))
                else:
                    asks = wants
                if asks:
                    self.iasked[i][k] = ia + len(asks)
                    new_iwant[i][k] = set(asks)
                    if self.score_params is not None:
                        # one promise per IWANT batch: a random message of
                        # the batch, due within the followup window
                        # (gossip_tracer.go:48-75)
                        mid = self.rng.choice(asks)
                        self.promises[i].setdefault(
                            (k, mid), tick + cfg.iwant_followup_ticks
                        )
        self.iwant_out = new_iwant

        # 4. delivery: senders push last round's fwd along mesh (+fanout,
        # +flood-publish), adversary senders transmit nothing. With
        # queue_cap each directed link carries at most cap messages per
        # round — lowest slots kept, overflow genuinely LOST (the engine's
        # prefix_cap_bits; doDropRPC gossipsub.go:1153-1160)
        arrivals = [dict() for _ in range(n)]  # slot -> [k,...]
        n_rpc = 0
        cap = cfg.queue_cap
        n_drop = 0
        link_used = {}  # (i, k) -> push count on that link after the cap
        for i in range(n):
            link_push: dict[int, list] = {}  # k -> [slot,...]
            for k, s, r in self._edges(i):
                if s in self.adversary or not self._acc_ok(i, k):
                    continue
                for slot in self.fwd[s]:
                    msg = self.msgs.get(slot)
                    if msg is None or msg.origin == i:
                        continue
                    if msg.topic not in self.mesh[i]:
                        continue  # receiver's joined filter
                    if self.first_edge.get((s, slot)) == r:
                        continue  # echo exclusion
                    carries = r in self.mesh[s].get(msg.topic, ())
                    if not carries and msg.topic in self.fanout[s]:
                        carries = r in self.fanout[s][msg.topic]
                    if cfg.flood_publish and msg.origin == s:
                        # origin floods to peers it scores above the
                        # publish threshold (gossipsub.go:957-963)
                        if self.score_params is None or (
                            self.scores[s].get(r, 0.0)
                            >= cfg.publish_threshold
                        ):
                            carries = True
                    if not carries:
                        continue
                    link_push.setdefault(k, []).append(slot)
            for k, slots in link_push.items():
                slots = sorted(slots)
                if cap > 0 and len(slots) > cap:
                    n_drop += len(slots) - cap
                    slots = slots[:cap]
                link_used[(i, k)] = len(slots)
                for slot in slots:
                    arrivals[i].setdefault(slot, []).append(k)
                    n_rpc += 1

        def _window_rounds(topic) -> int:
            # same tick conversion as TopicParamsArrays.build (engine.py)
            tp = (self.score_params.topics.get(topic)
                  if self.score_params else None)
            if tp is None:
                return 0
            w = tp.mesh_message_deliveries_window
            return ticks_for(w, 1.0) - 1 if w >= 1.0 else 0

        def _attribute(i, slot, ks, first: bool):
            """Score attribution for one round's arrivals of `slot` at i:
            first arrival -> markFirstMessageDelivery on its edge; every
            other arrival -> duplicate (window-gated mesh credit; arrivals
            while the message is pending validation are in the delivery
            record and credited unconditionally, score.go:712-718) or
            invalid penalty (score.go:695-820)."""
            if self.score_params is None:
                return
            msg = self.msgs[slot]
            fr = self.first_round.get((i, slot))
            in_window = (
                fr is not None and (tick - fr) <= _window_rounds(msg.topic)
            ) or (i, slot) in self.pending
            ks = sorted(ks)
            for j, k in enumerate(ks):
                if not msg.valid:
                    if not msg.ignored:
                        self.oscore[i].invalid_delivery(k, msg.topic)
                    continue
                if first and j == 0:
                    self.oscore[i].first_delivery(k, msg.topic)
                else:
                    self.oscore[i].duplicate_delivery(k, msg.topic, in_window)

        def _fulfill_promises(i, slot):
            for key in [key for key in self.promises[i] if key[1] == slot]:
                del self.promises[i][key]

        new_fwd = [set() for _ in range(n)]
        n_new = n_deliver = n_reject_verdict = 0

        # 4a. pipeline exits: verdicts due this round (the reference's
        # post-validation publishMessage ordering — forwarding, the CDF
        # timestamp, mcache insertion, and the first-delivery credit all
        # land at the verdict, validation.go:274-351 -> pubsub.go:1124)
        for (i, slot) in sorted(
            key for key, due in self.pending.items() if due == tick
        ):
            del self.pending[(i, slot)]
            msg = self.msgs.get(slot)
            if msg is None:
                continue
            self.first_round[(i, slot)] = tick
            if msg.valid:
                if self.score_params is not None:
                    fe = self.first_edge.get((i, slot), -1)
                    if fe >= 0:
                        self.oscore[i].first_delivery(fe, msg.topic)
                n_deliver += 1
                new_fwd[i].add(slot)
            else:
                n_reject_verdict += 1

        def _arrive_new(i, slot, ks) -> int:
            """First receipt of `slot` at i via edges ks; returns the
            inline deliver count (0 when the verdict is deferred)."""
            self.seen[i].add(slot)
            self.first_edge[(i, slot)] = min(ks)
            if self.score_params is not None:
                _fulfill_promises(i, slot)
            msg = self.msgs[slot]
            d = self._vdelay(msg.topic)
            if d == 0:
                self.first_round[(i, slot)] = tick
                _attribute(i, slot, ks, first=True)
                if msg.valid:
                    new_fwd[i].add(slot)
                    return 1
                return 0
            # enters the pipeline; same-round extra arrivals are in the
            # delivery record (credited now), invalid arrivals take P4 at
            # arrival (the engine's trans-based imd), the first edge's
            # credit waits for the verdict
            self.pending[(i, slot)] = tick + d
            if self.score_params is not None:
                sks = sorted(ks)
                for j, k in enumerate(sks):
                    if not msg.valid:
                        if not msg.ignored:
                            self.oscore[i].invalid_delivery(k, msg.topic)
                    elif j > 0:
                        self.oscore[i].duplicate_delivery(k, msg.topic, True)
            return 0

        for i in range(n):
            for slot, ks in sorted(arrivals[i].items()):
                if slot in self.seen[i]:
                    _attribute(i, slot, ks, first=False)
                    continue
                n_new += 1
                n_deliver += _arrive_new(i, slot, ks)
        # merge IWANT responses (merge_extra_tx: no echo exclusion,
        # origin-exclusion only, mesh arrivals take first_edge precedence).
        # With queue_cap, responses share each link's budget with the mesh
        # push that already claimed it (merge_extra_tx in
        # models/gossipsub.py: used = trans popcount, budget = cap - used)
        # — the retransmission counters in step 2 ticked regardless, like
        # the reference's mcache.GetForPeer counting the attempt before
        # sendRPC drops it
        for i in range(n):
            live_by_slot: dict[int, list] = {}
            for slot, ks in sorted(extra[i].items()):
                msg = self.msgs.get(slot)
                live = [
                    k for k in ks
                    if msg is not None and msg.origin != i
                    and self._acc_ok(i, k)
                ]
                if live:
                    live_by_slot[slot] = live
            if cap > 0:
                ex_link: dict[int, list] = {}
                for slot, ks in live_by_slot.items():
                    for k in ks:
                        ex_link.setdefault(k, []).append(slot)
                keep = set()
                for k, slots in ex_link.items():
                    b = max(cap - link_used.get((i, k), 0), 0)
                    slots = sorted(slots)
                    n_drop += len(slots) - min(len(slots), b)
                    keep.update((slot, k) for slot in slots[:b])
                live_by_slot = {
                    slot: [k for k in ks if (slot, k) in keep]
                    for slot, ks in live_by_slot.items()
                }
            for slot, live in sorted(live_by_slot.items()):
                n_rpc += len(live)
                if not live:
                    continue
                for k in live:
                    # responses occupy the link too: saturation (below) is
                    # judged on the merged traffic, engine's trans | extra
                    link_used[(i, k)] = link_used.get((i, k), 0) + 1
                if slot in self.seen[i]:
                    _attribute(i, slot, live, first=False)
                    continue
                n_new += 1
                n_deliver += _arrive_new(i, slot, live)
        self.events[EV.DROP_RPC] += n_drop
        # congested links suppress the next heartbeat's IHAVE toward them
        # (gossip is never retried — gossipsub.go:1757-1764, :1155-1160);
        # sender-side view of each saturated inbound link, the engine's
        # edge_gather(sat_recv) over the post-merge transmit set
        self._gossip_suppress = set()
        if cap > 0:
            for i in range(n):
                for k, s, r in self._edges(i):
                    if link_used.get((i, k), 0) >= cap:
                        self._gossip_suppress.add((s, r))
        self.events[EV.DELIVER_MESSAGE] += n_deliver
        if self.cfg.validation_delay_rounds > 0:
            self.events[EV.REJECT_MESSAGE] += n_reject_verdict
        else:
            self.events[EV.REJECT_MESSAGE] += n_new - n_deliver
        self.events[EV.DUPLICATE_MESSAGE] += n_rpc - n_new
        self.events[EV.SEND_RPC] += n_rpc
        self.events[EV.RECV_RPC] += n_rpc

        # 5. mcache put: validated new receipts in joined topics
        for i in range(n):
            for slot in new_fwd[i]:
                if self.msgs[slot].topic in self.mesh[i]:
                    self.mcache[i][0].add(slot)
        self.fwd = new_fwd

        # 6. publishes (transmit next round); tuples are
        # (origin, topic, valid[, ignored])
        for pub in publishes:
            self.publish(*pub)

        # 7. heartbeat — every h-th round only (h = cfg.heartbeat_every).
        # The one-shot outboxes written by the LAST heartbeat were
        # ingested by neighbors in steps 1-3 above, so they clear now
        # either way (the engine zeroes graft_out/ihave_out every step
        # the same way); prune responses to rejected grafts go out every
        # round (the reference PRUNEs inline in handleGraft,
        # gossipsub.go:785-808). Heartbeats execute at ticks ≡ h-1
        # (mod h) — the phase engine's tail-heartbeat ticks — so the two
        # cadences' timers (backoff expiry, opportunistic-graft schedule,
        # promise deadlines) compare identical tick values.
        self.prune_out = prune_resp
        self.graft_out = [set() for _ in range(n)]
        hbe = cfg.heartbeat_every
        if self.tick % hbe == hbe - 1:
            self._heartbeat()
        else:
            self.ihave_out = [dict() for _ in range(n)]
        self.tick += 1

    # -- heartbeat ----------------------------------------------------------

    def _heartbeat(self):
        cfg, topo = self.cfg, self.topo
        n = topo.n_peers
        tick = self.tick
        scored = self.score_params is not None

        for i in range(n):
            if scored:
                # applyIwantPenalties: promises past their deadline break
                # -> P7 per broken promise (gossipsub.go:1578-1583,
                # gossip_tracer.go:79-115)
                broken = {}
                for (k, slot), exp in list(self.promises[i].items()):
                    if tick > exp:
                        broken[k] = broken.get(k, 0) + 1
                        del self.promises[i][(k, slot)]
                for k, cnt in broken.items():
                    self.oscore[i].add_penalty(k, cnt)
                # refreshScores decay + the per-heartbeat score memo
                # (score.go:497-558; gossipsub.go:1333-1341)
                self.oscore[i].refresh(tick)
                self.scores[i] = {
                    k: self.oscore[i].score(k) for k, s, r in self._edges(i)
                }

            # clearIHaveCounters
            self.peerhave[i] = {}
            self.iasked[i] = {}
            # clearBackoff every backoff_clear_ticks, with slack
            if tick % cfg.backoff_clear_ticks == 0:
                expired = [
                    key for key in self.backoff_present[i]
                    if self.backoff_expire[i].get(key, 0) + cfg.backoff_slack_ticks < tick
                ]
                for key in expired:
                    self.backoff_present[i].discard(key)
                    self.backoff_expire[i].pop(key, None)

            tograft, toprune = set(), set()
            nbr_sub = {}  # t -> set of candidate-capable edges
            for t in self.mesh[i]:
                nbr_sub[t] = {
                    k for k, s, r in self._edges(i) if self.subs.subscribed[s, t]
                }

            for t, m in self.mesh[i].items():
                # drop negative-score mesh members first
                # (gossipsub.go:1361-1368)
                if scored:
                    bad = {k for k in m if self._score(i, k) < 0}
                    toprune |= {(t, k) for k in bad}
                    m -= bad
                cand = {
                    k for k in nbr_sub[t]
                    if k not in m and (t, k) not in self.backoff_present[i]
                    and (not scored or self._score(i, k) >= 0)
                }
                # underpopulated -> graft to D
                if len(m) < cfg.Dlo:
                    grafts = self._sample(cand, cfg.D - len(m))
                    m |= grafts
                    tograft |= {(t, k) for k in grafts}
                    cand -= grafts
                # overpopulated -> keep D with >= Dout outbound
                if len(m) > cfg.Dhi:
                    if scored:
                        # keep the Dscore best by score, random tie-break
                        # (gossipsub.go:1389-1399)
                        ranked = sorted(
                            m, key=lambda k: (-self._score(i, k),
                                              self.rng.random())
                        )
                        protected = set(ranked[: cfg.Dscore])
                    else:
                        protected = self._sample(m, cfg.Dscore)
                    keep = protected | self._sample(m - protected, cfg.D - cfg.Dscore)
                    out_in_keep = {k for k in keep if topo.outbound[i, k]}
                    x_need = max(cfg.Dout - len(out_in_keep), 0)
                    bring = self._sample(
                        {k for k in m - keep if topo.outbound[i, k]}, x_need
                    )
                    droppable = {k for k in keep - protected if not topo.outbound[i, k]}
                    drop = self._sample(droppable, len(bring))
                    keep = (keep - drop) | bring
                    toprune |= {(t, k) for k in m - keep}
                    m &= keep
                # outbound quota top-up
                if len(m) >= cfg.Dlo:
                    have_out = sum(1 for k in m if topo.outbound[i, k])
                    need = max(cfg.Dout - have_out, 0)
                    grafts2 = self._sample(
                        {k for k in cand - m if topo.outbound[i, k]}, need
                    )
                    m |= grafts2
                    tograft |= {(t, k) for k in grafts2}
                # opportunistic grafting (gossipsub.go:1479-1510)
                if (scored and cfg.opportunistic_graft_ticks > 0
                        and tick % cfg.opportunistic_graft_ticks == 0
                        and len(m) > 1):
                    ranked = sorted(self._score(i, k) for k in m)
                    med = ranked[len(ranked) // 2]
                    if med < cfg.opportunistic_graft_threshold:
                        better = {
                            k for k in cand - m if self._score(i, k) > med
                        }
                        grafts3 = self._sample(
                            better, cfg.opportunistic_graft_peers
                        )
                        m |= grafts3
                        tograft |= {(t, k) for k in grafts3}

            if scored:
                for (t, k) in tograft:
                    self.oscore[i].graft(k, t, tick)
                for (t, k) in toprune:
                    self.oscore[i].prune(k, t)
            for (t, k) in toprune:
                be = self.backoff_expire[i]
                be[(t, k)] = max(be.get((t, k), 0), tick + cfg.prune_backoff_ticks)
                self.backoff_present[i].add((t, k))
            self.graft_out[i] = tograft
            self.prune_out[i] = self.prune_out[i] | toprune
            self.events[EV.GRAFT] += len(tograft)
            self.events[EV.PRUNE] += len(toprune)

            # fanout maintenance (gossipsub.go:1517-1554): TTL expiry,
            # threshold filtering, top-up to D
            if cfg.fanout_slots > 0 and self.fanout[i]:
                for t in list(self.fanout[i]):
                    if self.fanout_lastpub[i].get(t, 0) + cfg.fanout_ttl_ticks < tick:
                        del self.fanout[i][t]
                        self.fanout_lastpub[i].pop(t, None)
                        continue
                    f = self.fanout[i][t]
                    if scored:
                        f = {
                            k for k in f
                            if self._score(i, k) >= cfg.publish_threshold
                        }
                    cand_f = {
                        k for k, s, r in self._edges(i)
                        if self.subs.subscribed[s, t] and k not in f
                        and (not scored
                             or self._score(i, k) >= cfg.publish_threshold)
                    }
                    f |= self._sample(cand_f, cfg.D - len(f))
                    self.fanout[i][t] = f

            # emitGossip: IHAVE of the gossip window to random non-mesh peers
            gwin = set().union(*self.mcache[i][: cfg.history_gossip])
            ihave = {}
            for t, m in self.mesh[i].items():
                gcand = {
                    k for k in nbr_sub[t] - m
                    if (not scored or self._score(i, k) >= cfg.gossip_threshold)
                    and (i, k) not in self._gossip_suppress
                }
                target = max(cfg.Dlazy, int(cfg.gossip_factor * len(gcand)))
                adv = {slot for slot in gwin if self.msgs[slot].topic == t}
                if not adv:
                    continue
                for k in self._sample(gcand, target):
                    ihave.setdefault(k, set()).update(adv)
            # fanout-topic gossip (gossipsub.go:1551-1553)
            for t, f in self.fanout[i].items():
                gcand = {
                    k for k, s, r in self._edges(i)
                    if self.subs.subscribed[s, t] and k not in f
                    and (not scored
                         or self._score(i, k) >= cfg.gossip_threshold)
                    and (i, k) not in self._gossip_suppress
                }
                target = max(cfg.Dlazy, int(cfg.gossip_factor * len(gcand)))
                adv = {slot for slot in gwin if self.msgs[slot].topic == t}
                if not adv:
                    continue
                for k in self._sample(gcand, target):
                    ihave.setdefault(k, set()).update(adv)
            self.ihave_out[i] = ihave

            # mcache.Shift
            self.mcache[i] = [set()] + self.mcache[i][: cfg.history_length - 1]

    # -- metrics ------------------------------------------------------------

    def hops(self):
        """{(peer, slot): hop} for every first receipt, origin included at 0."""
        return {
            (i, slot): r - self.msgs[slot].birth
            for (i, slot), r in self.first_round.items()
            if slot in self.msgs
        }
