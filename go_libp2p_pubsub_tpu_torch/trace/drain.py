"""Device→host trace drain.

The reference calls its tracer inline from every protocol action
(trace.go:63-530). The vectorized loop cannot call host code per event, so
tracing is *reconstructive*: the drain snapshots the small trace-relevant
slices of device state each round, diffs consecutive snapshots, and emits
`TraceEvent` protos in the reference schema (pb/pubsub_trace.proto) to any
set of sinks (sinks.py).

Fidelity contract (documented, tested):
  exact per-event — PUBLISH_MESSAGE, DELIVER_MESSAGE, REJECT_MESSAGE
    (first receipts carry the arrival edge in `first_edge`), GRAFT/PRUNE
    (mesh diffs), ADD_PEER/REMOVE_PEER (liveness diffs), JOIN/LEAVE,
    SEND_RPC/RECV_RPC for every message-bearing first-delivery RPC,
    DROP_RPC from the outbound-queue model (overflow beyond `queue_cap`
    messages per edge per round — pubsub.go:240's 32-deep queue).
  aggregate-only (default mode) — duplicate arrivals and control-only
    RPCs are counted exactly in the device event counters
    (state.core.events, see events.py) but not expanded into per-event
    records; `counter_events()` exposes those totals. Propagation analysis
    (latency CDFs — the north star's tracestat parity) uses
    first-deliveries only, which are exact.
  exact mode — a cfg.trace_exact build + TraceSession(exact=True) expands
    duplicates and control-only RPCs into individual events too
    (trace.go:166-194, 341-414), with RPC records grouped per
    (sender, receiver, round) carrying full RPCMeta; the accounting test
    (tests/test_trace_exact.py) reconciles every type against the device
    counters in the style of trace_test.go's traceStats.check. Costs one
    [N,K,W] plane store per round when on; nothing when off.

Identity: peer ids are stable opaque bytes from the peer index; message ids
follow DefaultMsgIdFn = from || seqno (pubsub.go:1041-1043) with per-origin
monotone seqnos (pubsub.go:1259-1264) assigned host-side at publish.
Timestamps are tick * tick_ns (integer time base — survey §7: the reference
already quantizes to heartbeat ticks).

Device and host: ``snapshot`` is the only part that reads the device. It
copies each trace-relevant slice of a port state to the host once, with
the JAX package's dtypes (``uint32`` word planes, ``int8`` first arrival
edges, ``bool`` masks), so the diff code below is the JAX package's
``trace/drain.py`` line for line and writes the same events for the same
run. A snapshot synchronises with the host, so a traced run dispatches
eagerly, one round or one phase at a time (message ids are keyed by slot,
and slots recycle every M / P rounds): never inside a captured window.

Phase cadence: the same session consumes phase steps (rounds_per_phase =
r > 1) — one observe() per PHASE. The device stamps `first_round` per
sub-round and the reconstructive diff recovers per-sub-round timestamps
for PUBLISH/DELIVER/REJECT (the CDF-bearing events keep 1-round
resolution, like the engine itself); duplicates, control-only RPCs,
GRAFT/PRUNE and liveness diffs emit at phase-boundary resolution, stamped
at the phase head — which for control and peer transitions is the exact
crossing round (the phase gathers prev outboxes and applies transitions
once, at its head). The reference traces at its production cadence always
(trace.go:63-530); this is that contract at the phase engine's cadence.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import bitset
from ..pb import trace_pb2
from .events import EV

PROTOCOL_NAMES = {0: "/floodsub/1.0.0", 1: "/meshsub/1.0.0", 2: "/meshsub/1.1.0"}

#: sim-only counters with NO trace.proto record type: never expanded
#: into per-event TraceEvents (not even in exact mode — the reference's
#: event stream has no LinkDown/IwantRecover records, and its attackers
#: are raw-wire test fakes its tracer never sees, so there are no
#: AdvDrop/AdvIhaveLie/AdvGraftSpam records either — and its v1.1
#: trace schema predates the v1.2 IDONTWANT / episub choke extensions,
#: so the router counters have no record type by construction), exposed
#: exclusively through ``counter_events()`` at phase-cadence resolution
#: (docs/DESIGN.md §8, §13, §24). Every other EV.* member maps 1:1 to a
#: TraceEvent emission below (the JAX package's ``ev-drain`` simlint rule
#: pins both halves of that contract on its copy of this module).
COUNTER_ONLY_EVENTS = (EV.LINK_DOWN, EV.IWANT_RECOVER,
                       EV.ADV_DROP, EV.ADV_IHAVE_LIE, EV.ADV_GRAFT_SPAM,
                       EV.IDONTWANT_SENT, EV.DUP_SUPPRESSED,
                       EV.CHOKE, EV.UNCHOKE)

#: The r>1 accounting caveats, as one machine-surfaced note. This is the
#: single source of truth: ``TraceSession.accounting_caveats()`` returns
#: it once the session has observed a step with ``new.tick - prev.tick
#: > 1``, and ``scripts/tracestat.py`` attaches the same text to its
#: ``phase_cadence`` caveat flag when its timestamp heuristic detects a
#: phase trace after the fact (ADVICE round 5: the caveats used to live
#: only in the ``observe()`` docstring, invisible to ``--json``
#: consumers).
PHASE_CADENCE_NOTE = (
    "phase-cadence trace (control events land at phase "
    "boundaries): GRAFT/PRUNE event streams can undercount the "
    "device mutation counters (graft+prune cancellation within "
    "one phase); the synthesized DROP_RPC queue model excludes "
    "duplicate arrivals; a late duplicate of a slot recycled "
    "within its death phase resolves against the end-of-phase "
    "message id. The chaos-plane counters (LINK_DOWN / "
    "IWANT_RECOVER, trace/events.py) are exact totals but "
    "accumulate at phase cadence too — latencies derived from "
    "them quantize to multiples of r (the delivery plane's "
    "first_round stamps keep 1-round resolution at every "
    "cadence). See trace/drain.py \"Phase cadence\" and "
    "chaos/metrics.py."
)


def peer_id(i: int) -> bytes:
    """Stable opaque peer-id bytes for a peer index."""
    return b"sim-peer-%08d" % int(i)


def message_id(origin_id: bytes, seqno: int) -> bytes:
    """DefaultMsgIdFn: from || seqno (pubsub.go:1041-1043)."""
    return origin_id + int(seqno).to_bytes(8, "big")


@dataclasses.dataclass
class Snapshot:
    """Host copy of the trace-relevant state slices for one round."""

    tick: int
    cursor: int
    msg_topic: np.ndarray    # [M]
    msg_origin: np.ndarray   # [M]
    msg_valid: np.ndarray    # [M]
    msg_ignored: np.ndarray  # [M] — ValidationIgnore verdicts
    first_round: np.ndarray  # [N,M]
    first_edge: np.ndarray   # [N,M]
    events: np.ndarray       # [N_EVENTS]
    mesh: np.ndarray | None = None  # [N,S,K]
    up: np.ndarray | None = None    # [N]
    # exact-trace extras (cfg.trace_exact states; None otherwise):
    dup_trans: np.ndarray | None = None   # [N,K,W] u32 duplicate plane
    # control outboxes pending their wire crossing NEXT round — a prev
    # snapshot's outboxes are exactly the control the far end receives in
    # the observed round (the engine's one-RTT outbox model)
    graft_out: np.ndarray | None = None   # [N,S,K] bool
    prune_out: np.ndarray | None = None   # [N,S,K] bool
    ihave_out: np.ndarray | None = None   # [N,K,W] u32
    iwant_out: np.ndarray | None = None   # [N,K,W] u32
    edge_live: np.ndarray | None = None   # [N,K] bool


def _host(x) -> np.ndarray:
    """A host array of a tensor on any device, or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _words(x: torch.Tensor) -> np.ndarray:
    """A packed word plane on the host as the JAX package holds it: the
    port's int32 bits as uint32."""
    return _host(x).view(np.uint32)


def snapshot(st, net=None) -> Snapshot:
    """Pull a Snapshot from a port state: a GossipSubState (exposes
    `.core`) or a bare SimState; mesh/up captured when present. A
    CSR-resident state (flat [E, W] fe_words) needs ``net`` so the
    first-arrival edge view can be densified here (``Net.unpack_edges``).
    Raises while a CUDA graph capture is in progress: a snapshot copies to
    the host, which no captured window can hold."""
    core = getattr(st, "core", st)
    if core.tick.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "snapshot() copies the state to the host, which a CUDA graph capture "
            "cannot hold: trace eager dispatches (one round or one phase a call), "
            "not a captured window (driver.make_window / make_scan)")
    exact = getattr(st, "dup_trans", None) is not None
    dlv = core.dlv
    fe_words = dlv.fe_words
    if fe_words.dim() == 2:
        if net is None:
            raise ValueError(
                "snapshot() of a CSR-resident state needs net= to "
                "densify the first-arrival plane (or densify the whole "
                "state first: state.densify_edge_planes(net, st))")
        fe_words = net.unpack_edges(fe_words)
    return Snapshot(
        tick=int(core.tick),
        cursor=int(core.msgs.cursor),
        msg_topic=_host(core.msgs.topic),
        msg_origin=_host(core.msgs.origin),
        msg_valid=_host(core.msgs.valid),
        msg_ignored=_host(core.msgs.ignored),
        first_round=_host(dlv.first_round),
        first_edge=_host(bitset.first_edge_of(fe_words, dlv.first_round.shape[-1])),
        events=_host(core.events),
        mesh=_host(st.mesh) if hasattr(st, "mesh") else None,
        up=_host(st.up) if hasattr(st, "up") else None,
        dup_trans=_words(st.dup_trans) if exact else None,
        graft_out=_host(st.graft_out) if exact else None,
        prune_out=_host(st.prune_out) if exact else None,
        ihave_out=_words(st.ihave_out) if exact else None,
        iwant_out=_words(st.iwant_out) if exact else None,
        edge_live=_host(st.edge_live) if exact else None,
    )


class TraceSession:
    """Reconstructive tracer over a simulation run.

    Usage:
        sess = TraceSession(net, [sink...], tick_ns=10**9)
        sess.emit_init(snapshot(st))
        for each round:
            prev = snapshot(st); st = step(st, po, pt, pv)
            sess.observe(prev, snapshot(st), po, pt, pv)
        sess.close(snapshot(st))
    """

    def __init__(self, net, sinks, tick_ns: int = 10**9, queue_cap: int = 32,
                 topic_name=None, peer_id_of=None, mid_fn=None,
                 exact: bool = False):
        """``exact=True`` (requires a cfg.trace_exact state so snapshots
        carry the duplicate plane + control outboxes) expands every
        DuplicateMessage and every control-only RPC into individual
        TraceEvents, and groups RPC records per (sender, receiver, round)
        with full RPCMeta — the reference's per-RPC granularity
        (trace.go:166-194, 341-414). Default mode keeps those as exact
        aggregate counters only (counter_events)."""
        self.sinks = list(sinks)
        self.tick_ns = tick_ns
        self.queue_cap = queue_cap
        self.exact = exact
        self.topic_name = topic_name or (lambda t: f"topic-{t}")
        self.nbr = _host(net.nbr)
        self.my_topics = _host(net.my_topics)
        self.subscribed = _host(net.subscribed)
        self.protocol = _host(net.protocol)
        n = self.nbr.shape[0]
        # identity seams: a bare engine session reconstructs synthetic
        # peer ids and from‖seqno message ids; an embedding layer with real
        # identities (api.Network: ed25519 peer ids, WithMessageAuthor
        # overrides, custom WithMessageIdFn) supplies both so traced ids
        # match the wire's (trace.go events carry the real ids)
        pid = peer_id_of or peer_id
        self.peer_ids = [pid(i) for i in range(n)]
        self.mid_fn = mid_fn  # (origin_idx, seqno, slot) -> bytes | None
        self.seqno = np.zeros(n, np.int64)       # per-origin counters
        m_cap = None  # learned from first snapshot
        self._m_cap = m_cap
        self.slot_mid: dict[int, bytes] = {}     # slot -> message id bytes
        self.max_tick_stride = 0  # widest observed new.tick - prev.tick

    # -- emission helpers --------------------------------------------------

    def _emit(self, ev: trace_pb2.TraceEvent) -> None:
        for s in self.sinks:
            s.trace(ev)

    def _base(self, typ, peer: int, tick: int) -> trace_pb2.TraceEvent:
        return trace_pb2.TraceEvent(
            type=typ, peerID=self.peer_ids[peer], timestamp=tick * self.tick_ns
        )

    # -- lifecycle ---------------------------------------------------------

    def emit_init(self, snap: Snapshot) -> None:
        """ADD_PEER + JOIN for the initial network (replayed as events the
        way a node would have seen its boot)."""
        n = len(self.peer_ids)
        up = snap.up if snap.up is not None else np.ones(n, bool)
        for i in range(n):
            if not up[i]:
                continue
            ev = self._base(trace_pb2.TraceEvent.ADD_PEER, i, snap.tick)
            ev.addPeer.peerID = self.peer_ids[i]
            ev.addPeer.proto = PROTOCOL_NAMES.get(int(self.protocol[i]), "?")
            self._emit(ev)
            for t in np.nonzero(self.subscribed[i])[0]:
                ev = self._base(trace_pb2.TraceEvent.JOIN, i, snap.tick)
                ev.join.topic = self.topic_name(int(t))
                self._emit(ev)

    def close(self, snap: Snapshot | None = None) -> None:
        if snap is not None:
            for i in range(len(self.peer_ids)):
                if snap.up is not None and not snap.up[i]:
                    continue
                for t in np.nonzero(self.subscribed[i])[0]:
                    ev = self._base(trace_pb2.TraceEvent.LEAVE, i, snap.tick)
                    ev.leave.topic = self.topic_name(int(t))
                    self._emit(ev)
        for s in self.sinks:
            s.close()

    def accounting_caveats(self) -> dict[str, str]:
        """Caveat-flag -> prose for the strides this session has actually
        observed. Empty at per-round cadence (every stride == 1): the
        event stream then reconciles exactly against the device counters
        with no coarsening. At phase cadence (any ``new.tick - prev.tick
        > 1``) the phase-boundary caveats apply — same map shape as
        ``tracestat --json``'s ``caveat_notes`` so callers can merge."""
        if self.max_tick_stride > 1:
            return {"phase_cadence": PHASE_CADENCE_NOTE}
        return {}

    # -- per-round / per-phase observation ---------------------------------

    def observe(self, prev: Snapshot, new: Snapshot,
                pub_origin, pub_topic, pub_valid) -> None:
        """Consume one step transition; the publish arrays are tensors on
        any device or numpy arrays. Accepts BOTH cadences:

        * per-round step: pub_* are [P]; ``new.tick - prev.tick == 1``.
        * phase step (rounds_per_phase = r > 1): pub_* are [r, P];
          ``new.tick - prev.tick == r``. DELIVER/REJECT events keep
          per-sub-round timestamps (the device stamps ``first_round`` per
          sub-round) and PUBLISH events land at their sub-round's tick;
          duplicate expansion, control-only RPCs, GRAFT/PRUNE mesh diffs
          and liveness diffs are PHASE-BOUNDARY resolution, stamped at
          the phase head — which is when control actually crosses (the
          phase gathers prev outboxes once, at its head) and when peer
          transitions apply. Boundary coarsening is the drain-side
          analogue of the engine's r-round control latency; totals stay
          exact (the accounting suite reconciles them at r > 1 too).
          The caveats that coarsening implies (GRAFT/PRUNE undercount
          via same-phase graft+prune cancellation, the duplicate-queue
          exclusion, chaos-counter quantization) are machine-surfaced:
          once any observed stride exceeds 1, ``accounting_caveats()``
          returns ``PHASE_CADENCE_NOTE``.
        """
        self.max_tick_stride = max(self.max_tick_stride,
                                   int(new.tick) - int(prev.tick))
        tick = prev.tick  # the step's first executed round
        m = len(new.msg_topic)
        # the slot->mid mapping as of the step's START: duplicate arrivals
        # and control advertisements name the message a slot held BEFORE
        # this step's publishes recycled it
        prev_slot_mid = dict(self.slot_mid) if self.exact else None

        # publishes: replicate the allocator's slot assignment
        # (state.allocate_publishes: slots = cursor + running index, mod
        # M — per sub-round in phase mode, flattened in allocation order)
        po = _host(pub_origin)
        pt = _host(pub_topic)
        if po.ndim == 1:
            po, pt = po[None], pt[None]
        is_pub = po >= 0
        pos = (np.cumsum(is_pub.ravel()) - 1).reshape(is_pub.shape)
        slots = (prev.cursor + pos) % m
        for i, j in zip(*map(np.ndarray.tolist, np.nonzero(is_pub))):
            origin, slot = int(po[i, j]), int(slots[i, j])
            sq = int(self.seqno[origin])
            self.seqno[origin] += 1
            if self.mid_fn is not None:
                mid = self.mid_fn(origin, sq, slot)
            else:
                mid = message_id(self.peer_ids[origin], sq)
            self.slot_mid[slot] = mid
            ev = self._base(trace_pb2.TraceEvent.PUBLISH_MESSAGE, origin,
                            tick + i)
            ev.publishMessage.messageID = mid
            ev.publishMessage.topic = self.topic_name(int(pt[i, j]))
            self._emit(ev)

        # first receipts this step: first_round in [tick, new.tick) with
        # an arrival edge; each receipt's own stamp is its timestamp
        recv = (new.first_round >= tick) & (new.first_round < new.tick) \
            & (new.first_edge >= 0)
        peers, mslots = np.nonzero(recv)
        # per-(sender,receiver,round) message counts for the queue model
        edge_count: dict[tuple[int, int, int], int] = {}
        # exact mode: messages per directed edge+round, grouped per RPC
        edge_msgs: dict[tuple[int, int, int], list] = {}
        for p, s in zip(peers.tolist(), mslots.tolist()):
            sender = int(self.nbr[p, new.first_edge[p, s]])
            t_arr = int(new.first_round[p, s])
            # slot-unique fallback: a shared constant would alias distinct
            # messages in downstream messageID-keyed attribution
            mid = self.slot_mid.get(s, b"?unknown-%d" % s)
            topic = self.topic_name(int(new.msg_topic[s]))
            if new.msg_valid[s]:
                ev = self._base(trace_pb2.TraceEvent.DELIVER_MESSAGE, p, t_arr)
                ev.deliverMessage.messageID = mid
                ev.deliverMessage.topic = topic
                ev.deliverMessage.receivedFrom = self.peer_ids[sender]
            else:
                ev = self._base(trace_pb2.TraceEvent.REJECT_MESSAGE, p, t_arr)
                ev.rejectMessage.messageID = mid
                ev.rejectMessage.receivedFrom = self.peer_ids[sender]
                # rejection-reason string table (tracer.go:27-39):
                # ValidationIgnore verdicts trace "validation ignored"
                # and carry no P4 penalty (score.go:768-774)
                ev.rejectMessage.reason = (
                    "validation ignored" if new.msg_ignored[s]
                    else "validation failed"
                )
                ev.rejectMessage.topic = topic
            self._emit(ev)

            if self.exact:
                edge_msgs.setdefault((sender, p, t_arr), []).append(
                    (mid, topic)
                )
            else:
                # the message-bearing RPC on this edge (exact for firsts)
                sev = self._base(trace_pb2.TraceEvent.SEND_RPC, sender, t_arr)
                sev.sendRPC.sendTo = self.peer_ids[p]
                mm = sev.sendRPC.meta.messages.add()
                mm.messageID = mid
                mm.topic = topic
                self._emit(sev)
                rev = self._base(trace_pb2.TraceEvent.RECV_RPC, p, t_arr)
                rev.recvRPC.receivedFrom = self.peer_ids[sender]
                mm = rev.recvRPC.meta.messages.add()
                mm.messageID = mid
                mm.topic = topic
                self._emit(rev)

            key = (sender, p, t_arr)
            edge_count[key] = edge_count.get(key, 0) + 1

        if self.exact:
            self._observe_exact(prev, new, tick, edge_msgs, edge_count,
                                prev_slot_mid,
                                published_slots=set(slots[is_pub].tolist()))

        # outbound-queue model: overflow beyond queue_cap msgs/edge/round
        # drops the RPC (comm.go:139-170 bounded chan; DropRPC trace at
        # gossipsub.go:1153-1160). Bookkeeping only — delivery itself is
        # unaffected. When the ENGINE enforces real backpressure
        # (GossipSubConfig.queue_cap > 0) construct the session with
        # queue_cap=0 to disable this model; engine drops then show in
        # counter_events()[DROP_RPC]. Duplicate arrivals (exact mode)
        # count toward this cap only at r=1 — the phase-accumulated dup
        # plane has no sub-round info, and folding a phase's dups into
        # one round would fabricate drops (_observe_exact).
        if self.queue_cap:
            for (sender, p, t_arr), cnt in edge_count.items():
                for _ in range(max(0, cnt - self.queue_cap)):
                    ev = self._base(trace_pb2.TraceEvent.DROP_RPC, sender,
                                    t_arr)
                    ev.dropRPC.sendTo = self.peer_ids[p]
                    self._emit(ev)

        # mesh diffs -> GRAFT / PRUNE (peer's own mesh view)
        if prev.mesh is not None and new.mesh is not None:
            added = new.mesh & ~prev.mesh
            removed = prev.mesh & ~new.mesh
            for typ, diff in ((trace_pb2.TraceEvent.GRAFT, added),
                              (trace_pb2.TraceEvent.PRUNE, removed)):
                pp, ss, kk = np.nonzero(diff)
                for p, s, k in zip(pp.tolist(), ss.tolist(), kk.tolist()):
                    other = int(self.nbr[p, k])
                    topic = self.topic_name(int(self.my_topics[p, s]))
                    ev = self._base(typ, p, tick)
                    sub = ev.graft if typ == trace_pb2.TraceEvent.GRAFT else ev.prune
                    sub.peerID = self.peer_ids[other]
                    sub.topic = topic
                    self._emit(ev)

        # liveness diffs -> ADD_PEER / REMOVE_PEER
        if prev.up is not None and new.up is not None:
            for p in np.nonzero(new.up & ~prev.up)[0]:
                ev = self._base(trace_pb2.TraceEvent.ADD_PEER, int(p), tick)
                ev.addPeer.peerID = self.peer_ids[int(p)]
                ev.addPeer.proto = PROTOCOL_NAMES.get(int(self.protocol[p]), "?")
                self._emit(ev)
            for p in np.nonzero(prev.up & ~new.up)[0]:
                ev = self._base(trace_pb2.TraceEvent.REMOVE_PEER, int(p), tick)
                ev.removePeer.peerID = self.peer_ids[int(p)]
                self._emit(ev)

    # -- exact per-event expansion (trace.go:166-194, 341-414) -------------

    def _observe_exact(self, prev: Snapshot, new: Snapshot, tick: int,
                       edge_msgs, edge_count, prev_slot_mid,
                       published_slots=frozenset()) -> None:
        """Expand duplicates + control into individual events and emit ONE
        SendRPC/RecvRPC pair per (sender, receiver, round) with full
        RPCMeta — the reference's per-RPC granularity. Duplicate/control
        content is attributed against the step-START slot->mid mapping (a
        dup bit names the message its slot held when the arrival
        happened, even in the message's death round). Note the aggregate
        SEND_RPC/RECV_RPC device counters stay (edge, message)-grained;
        in exact mode the per-message total is instead the sum of
        RPCMeta.messages lengths (tests/test_trace_exact.py pins both
        accountings).

        Phase cadence (``new.tick - prev.tick`` = r > 1): first-delivery
        messages group at their own sub-round (their first_round stamp);
        duplicates — whose plane is phase-accumulated and carries no
        sub-round info — and control-only RPCs group at the phase-head
        round ``tick``. For control that stamp is EXACT, not coarsened:
        the phase engine gathers the prev outboxes once, at its head."""
        nbr = self.nbr
        m = len(new.msg_topic)

        # duplicate arrivals (DuplicateMessage, trace.go:186-194).
        # Attribution per slot: the step-START mapping names slots whose
        # occupant predates this step — exact at r=1 (a message published
        # this round transmits next round, so it cannot be its own
        # round's duplicate). At phase cadence a slot PUBLISHED this
        # phase can collect duplicates of its NEW message from sub-round
        # publish+2 on, so published slots resolve against the CURRENT
        # (end-of-phase) mapping instead; the residual ambiguity — an
        # old occupant of a recycled slot duplicating in its death phase
        # — picks the new mid, the dominant reading (the admission cap
        # guarantees recycled occupants are >= 2 phases old, i.e. ~fully
        # propagated, while the fresh message is actively flooding), but
        # since round 7 the event says so instead of staying silent: a
        # recycled slot whose PREVIOUS occupant was a different message
        # is emitted with ``ambiguousMid = true`` (sim-only proto field;
        # ADVICE round-5 item 4), so a consumer reconciling mids can
        # discount exactly the arrivals whose attribution is a choice.
        per_round = (new.tick - prev.tick) == 1
        if new.dup_trans is not None and new.dup_trans.any():
            widx = np.arange(m) // 32
            bpos = (np.arange(m) % 32).astype(np.uint32)
            bits = ((new.dup_trans[:, :, widx] >> bpos) & 1).astype(bool)
            for p, k, s in zip(*map(np.ndarray.tolist, np.nonzero(bits))):
                sender = int(nbr[p, k])
                ambiguous = False
                if not per_round and s in published_slots:
                    mid = self.slot_mid.get(s, b"?unknown-%d" % s)
                    topic = self.topic_name(int(new.msg_topic[s]))
                    old_mid = prev_slot_mid.get(s)
                    ambiguous = old_mid is not None and old_mid != mid
                else:
                    mid = prev_slot_mid.get(s, b"?unknown-%d" % s)
                    topic = self.topic_name(int(prev.msg_topic[s]))
                ev = self._base(trace_pb2.TraceEvent.DUPLICATE_MESSAGE, p, tick)
                ev.duplicateMessage.messageID = mid
                ev.duplicateMessage.receivedFrom = self.peer_ids[sender]
                ev.duplicateMessage.topic = topic
                if ambiguous:
                    ev.duplicateMessage.ambiguousMid = True
                self._emit(ev)
                edge_msgs.setdefault((sender, p, tick), []).append((mid, topic))
                if per_round:
                    # the queue model is per-round; at phase cadence the
                    # dup plane has no sub-round info, and folding r
                    # rounds of dup traffic into the head round would
                    # fabricate drops — dups count toward the session
                    # cap only at r=1 (engine-enforced queue_cap is the
                    # real backpressure path either way)
                    edge_count[(sender, p, tick)] = \
                        edge_count.get((sender, p, tick), 0) + 1

        # control crossing this round: the PREV snapshot's outboxes (the
        # engine's one-RTT outbox model — written last round, gathered by
        # the far end this round). Liveness gates with NEW.up: the engine
        # applies peer down-transitions — clearing down edges' outboxes
        # and masking the gather — BEFORE the control exchange of the
        # same round (apply_peer_transitions precedes control_exchange;
        # live_step_views builds the exchange's net_l from eff_next), so
        # a peer downed at round t neither sends nor receives control at
        # round t. edge_live stays PREV: px_connect's edge_live_next is
        # applied at the round tail, after the exchange.
        live = (
            prev.edge_live if prev.edge_live is not None else (nbr >= 0)
        ) & (nbr >= 0)
        if new.up is not None:
            live = live & new.up[:, None] & new.up[np.clip(nbr, 0, None)]
        ctrl: dict[tuple[int, int, int], dict] = {}

        def centry(s, p):
            # control crosses at the step head (one-RTT outbox model)
            return ctrl.setdefault(
                (s, p, tick),
                {"graft": [], "prune": [], "ihave": {}, "iwant": []},
            )

        for name, outbox in (("graft", prev.graft_out),
                             ("prune", prev.prune_out)):
            if outbox is None or not outbox.any():
                continue
            for p, s_, k in zip(*map(np.ndarray.tolist, np.nonzero(outbox))):
                if not live[p, k]:
                    continue
                centry(p, int(nbr[p, k]))[name].append(
                    self.topic_name(int(self.my_topics[p, s_]))
                )
        widx = np.arange(m) // 32
        bpos = (np.arange(m) % 32).astype(np.uint32)
        for name, outbox in (("ihave", prev.ihave_out),
                             ("iwant", prev.iwant_out)):
            if outbox is None or not outbox.any():
                continue
            has = (outbox != 0).any(axis=-1) & live
            for p, k in zip(*map(np.ndarray.tolist, np.nonzero(has))):
                entry = centry(p, int(nbr[p, k]))
                for s in np.nonzero((outbox[p, k, widx] >> bpos) & 1)[0].tolist():
                    mid = prev_slot_mid.get(s, b"?unknown-%d" % s)
                    if name == "iwant":
                        entry["iwant"].append(mid)
                    else:
                        t = self.topic_name(int(prev.msg_topic[s]))
                        entry["ihave"].setdefault(t, []).append(mid)

        # one RPC record pair per (directed edge, round) with any content
        for s, p, t_rpc in sorted(set(edge_msgs) | set(ctrl)):
            meta = trace_pb2.TraceEvent.RPCMeta()
            for mid, topic in edge_msgs.get((s, p, t_rpc), ()):
                mm = meta.messages.add()
                mm.messageID = mid
                mm.topic = topic
            c = ctrl.get((s, p, t_rpc))
            if c is not None:
                for t, mids in c["ihave"].items():
                    ih = meta.control.ihave.add()
                    ih.topic = t
                    ih.messageIDs.extend(mids)
                if c["iwant"]:
                    meta.control.iwant.add().messageIDs.extend(c["iwant"])
                for t in c["graft"]:
                    meta.control.graft.add().topic = t
                for t in c["prune"]:
                    meta.control.prune.add().topic = t
            sev = self._base(trace_pb2.TraceEvent.SEND_RPC, s, t_rpc)
            sev.sendRPC.sendTo = self.peer_ids[p]
            sev.sendRPC.meta.CopyFrom(meta)
            self._emit(sev)
            rev = self._base(trace_pb2.TraceEvent.RECV_RPC, p, t_rpc)
            rev.recvRPC.receivedFrom = self.peer_ids[s]
            rev.recvRPC.meta.CopyFrom(meta)
            self._emit(rev)

    # -- aggregates --------------------------------------------------------

    @staticmethod
    def counter_events(snap: Snapshot) -> dict[str, int]:
        """Exact cumulative totals from the device counters (includes the
        duplicate/control volume the per-event stream elides)."""
        return {e.name: int(snap.events[e]) for e in EV}


def batched_counter_events(events) -> tuple[list[dict[str, int]], dict[str, int]]:
    """Counters-only drain for a BATCHED ensemble run (docs/DESIGN.md
    §10): ``events [S, N_EVENTS]`` (a batched state's
    ``core.events``) -> (per-sim counter dicts, pooled totals).

    This is the only batched trace mode: the counters are exact per
    sim (each sim's row is bit-identical to the unbatched run's
    vector — the vmapped accumulation is elementwise). Exact
    PER-EVENT emission stays per-sim by design — a TraceSession's
    reconstructive diff walks host-side snapshots, so batching it
    would serialize on the host anyway; drive one session over
    ``ensemble.unbatch(states, i)`` snapshots for the sims whose event
    streams you need (typically a handful of representative sims out
    of a band, not all S)."""
    ev = _host(events)
    if ev.ndim != 2:
        raise ValueError(
            f"expected batched [S, N_EVENTS] counters, got shape {ev.shape}"
        )
    per_sim = [{e.name: int(row[e]) for e in EV} for row in ev]
    totals = {e.name: int(ev[:, e].sum()) for e in EV}
    return per_sim, totals
