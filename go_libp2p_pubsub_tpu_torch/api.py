"""Application API: the reference's L6 surface (topic.go, subscription.go,
pubsub.go Join/Subscribe/Publish) over the vectorized engine.

A `Network` owns one simulation (all N nodes in one state on one device —
the replacement for N processes with event loops); each `Node` is the
per-peer API view a go-libp2p-pubsub user would hold:

    net = Network(router="gossipsub")       # on the card; device="cpu" too
    a, b = net.add_node(), net.add_node()
    net.connect(a, b)
    ta, tb = a.join("news"), b.join("news")
    sub = tb.subscribe()
    net.start()
    ta.publish(b"hello")
    net.run(3)
    msg = sub.next()            # pb.Message with from/seqno/signature

Reference-surface mapping (citations into the Go reference, go-libp2p-pubsub):
  Node.join / Topic           — PubSub.Join + tryJoin (pubsub.go:1146-1197)
  Topic.subscribe             — topic.go:135-173 (buffered chan 32,
                                drop-if-slow pubsub.go:905-916)
  Topic.relay                 — refcounted relaying, topic.go:178-199
  Topic.publish               — topic.go:211-249 (build+sign+seqno, local
                                validation push validation.go:216-226)
  Topic.event_handler         — PeerJoin/PeerLeave log, topic.go:305-390
  Node.register_topic_validator — pubsub.go:1297 + validation.go:391-438
  Node.blacklist_peer         — pubsub.go:590-605 (global-view in the
                                vectorized engine; see state.py docstring)
  Network.connect/_all/sparse/dense — the test topology helpers
                                (floodsub_test.go:57-99)

Static-after-start contract: topology and the topic universe freeze at
`start()` (they are build constants of the step). Subscriptions, relays,
validators, publishes, churn, blacklists — and runtime Join/Leave of
*existing* topics (pubsub.go:1146-1218), which rebuild the subscription
constants and the step with a per-node topic-slot state remap — are all
live. Mid-run Join of a topic that never existed before start() still
raises rather than silently growing the topic universe.

The state lives on ``Network(device=...)``'s device: the card unless the
caller passes ``device="cpu"`` (no CUDA device raises). Every edit of the
device state (runtime Join/Leave, runtime connect, PX's edge growth) builds
new tensors on that device and never writes into a state a caller may
still hold; host reads copy the rows they need. Each step is the same
engine a direct build gives (``models/gossipsub.make_gossipsub_step``,
``make_gossipsub_phase_step``, ``floodsub_step``, ``make_randomsub_step``),
so the route through the kernels is the direct build's.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from . import graph as graphlib
from .blacklist import MapBlacklist
from .config import (
    GossipSubParams,
    PeerGaterParams,
    PeerScoreParams,
    PeerScoreThresholds,
)
from .discovery import Discovery, DiscoverySession, min_topic_size
from .pb import rpc_pb2
from .protocol import ProtocolMatcher
from .sign import (
    Identity,
    SignPolicy,
    check_signing_policy,
    make_peer_record,
    sign_message,
    validate_peer_record,
)
from .state import (
    VERDICT_ACCEPT,
    VERDICT_IGNORE,
    VERDICT_REJECT,
    Net,
    SimState,
    replace,
    resolve_device,
)
from .subscription_filter import SubscriptionFilter
from .trace.drain import TraceSession, snapshot

# validation defaults (validation.go:13-17)
DEFAULT_VALIDATE_THROTTLE = 8192
DEFAULT_TOPIC_THROTTLE = 1024
SUBSCRIPTION_BUFFER = 32  # pubsub.go chan size; drop-if-slow
SLOW_HEARTBEAT_WARN = 0.1  # warn fraction of the interval (gossipsub.go:258)

_log = logging.getLogger("go_libp2p_pubsub_tpu_torch")


def _host(x) -> np.ndarray:
    """A host array of a tensor on any device."""
    return x.detach().cpu().numpy()


class APIError(RuntimeError):
    pass


class ValidationResult:
    """Topic-validator verdicts (ValidationResult, validation.go:40-52).

    Validators may return one of these, or a plain bool (True = ACCEPT,
    False = REJECT — the original two-verdict interface). IGNORE drops
    the message without penalizing its senders (score.go:768-774)."""

    ACCEPT = VERDICT_ACCEPT
    REJECT = VERDICT_REJECT
    IGNORE = VERDICT_IGNORE


class ValidationError(APIError):
    """Local publish rejected (reject, ignore, or throttle) — the errors
    PushLocal surfaces to the publisher (validation.go:216-244,339-341)."""


class NotReadyError(APIError):
    """Publish gated on router readiness (RouterReady / MinTopicSize)."""


PEER_JOIN = "PEER_JOIN"
PEER_LEAVE = "PEER_LEAVE"


class Subscription:
    """Buffered delivery queue (subscription.go). `next()` returns the next
    pb.Message or None when empty; messages beyond the buffer are dropped
    and counted (the reference's drop-if-slow, pubsub.go:909-914)."""

    def __init__(self, topic: "Topic", buffer: int = SUBSCRIPTION_BUFFER):
        self.topic = topic
        self._q: deque = deque()
        self._buffer = buffer
        self.dropped = 0
        self.cancelled = False

    def next(self):
        if self._q:
            return self._q.popleft()
        return None

    def __iter__(self):
        while self._q:
            yield self._q.popleft()

    def cancel(self) -> None:
        self.cancelled = True
        self.topic._subs.discard(self)

    def _push(self, msg) -> None:
        if len(self._q) >= self._buffer:
            self.dropped += 1
            return
        self._q.append(msg)


class TopicEventHandler:
    """Coalescing PeerJoin/PeerLeave event log (topic.go:305-390)."""

    def __init__(self, topic: "Topic"):
        self.topic = topic
        self._q: deque = deque()
        # coalescing: one pending state per peer (the reference's event log
        # keeps only the latest transition per peer)
        self._pending: dict[bytes, str] = {}

    def _emit(self, kind: str, peer: bytes) -> None:
        prev = self._pending.get(peer)
        if prev == kind:
            return
        if prev is not None and prev != kind:
            # join then leave (or vice versa) coalesces to nothing
            del self._pending[peer]
            self._q = deque((k, p) for k, p in self._q if p != peer)
            return
        self._pending[peer] = kind
        self._q.append((kind, peer))

    def next_event(self):
        if not self._q:
            return None
        kind, peer = self._q.popleft()
        self._pending.pop(peer, None)
        return kind, peer


@dataclasses.dataclass
class TopicScoreSnapshot:
    """Per-topic counters behind a neighbor's score (TopicScoreSnapshot,
    score.go:155-166), in ticks / raw counter units."""

    time_in_mesh: int
    first_message_deliveries: float
    mesh_message_deliveries: float
    invalid_message_deliveries: float


@dataclasses.dataclass
class PeerScoreSnapshot:
    """Detailed score inspection record (PeerScoreSnapshot, score.go:134-153;
    surfaced by WithPeerScoreInspectDetailed)."""

    score: float
    topics: "dict[str, TopicScoreSnapshot]"
    behaviour_penalty: float
    ip_colocation_factor: float


@dataclasses.dataclass
class _Validator:
    fn: Callable
    inline: bool
    throttle: int


class Topic:
    """Per-(node, topic) handle; one per topic per node (pubsub.go:1146)."""

    def __init__(self, node: "Node", name: str, tid: int):
        self.node = node
        self.name = name
        self.tid = tid
        self._subs: set[Subscription] = set()
        self._relays = 0
        self._handlers: list[TopicEventHandler] = []
        self.closed = False

    # -- subscription ------------------------------------------------------

    def subscribe(self, buffer: int = SUBSCRIPTION_BUFFER) -> Subscription:
        sub = Subscription(self, buffer)
        self._subs.add(sub)
        return sub

    def relay(self) -> Callable[[], None]:
        """Keep forwarding this topic without delivering locally
        (topic.go:178-199). Returns the cancel closure."""
        self._relays += 1
        done = [False]

        def cancel():
            if not done[0]:
                done[0] = True
                self._relays -= 1

        return cancel

    def set_score_params(self, tsp) -> None:
        """Live per-topic score-parameter update (Topic.SetScoreParams,
        topic.go:36-74): validates, swaps the topic's params, and — when
        the router is running with scoring — recompiles the step. Counters
        are parameter-independent, so state carries unchanged."""
        net = self.node.network
        if net.score_params is None:
            raise APIError("scoring is not enabled on this network")
        tsp.validate()
        net.score_params.topics[self.tid] = tsp
        if net.started and net.router == "gossipsub":
            net._recompile_gossipsub()

    def event_handler(self) -> TopicEventHandler:
        h = TopicEventHandler(self)
        self._handlers.append(h)
        # replay current membership as joins (reference primes from
        # ListPeers at handler creation)
        for other in self.node.network._topic_members(self.tid):
            if other is not self.node and other.up:
                h._emit(PEER_JOIN, other.identity.peer_id)
        return h

    # -- publish -----------------------------------------------------------

    def publish(self, data: bytes, min_peers: int | None = None) -> bytes:
        """Build, sign, locally validate, and enqueue a message for the next
        round (topic.go:211-249 -> validation.PushLocal). Returns the
        message id.

        `min_peers` mirrors `WithReadiness(MinTopicSize(n))`: the publish is
        gated on the router having enough topic peers (discovery.go:76-82),
        evaluated against live mesh state."""
        if self.closed:
            raise APIError("topic handle closed")
        net = self.node.network
        if min_peers is not None and net.discovery is not None:
            if not net.discovery.enough_peers(self.node, self.name, min_peers):
                raise NotReadyError(
                    f"router not ready for {self.name!r} (min {min_peers} peers)"
                )
        return net._publish(self.node, self, data)

    def close(self) -> None:
        self.closed = True


class Node:
    """One simulated peer's API endpoint."""

    def __init__(self, network: "Network", idx: int, identity: Identity,
                 protocol: str, ip: str | None,
                 sub_filter: SubscriptionFilter | None,
                 author: Identity | None = None):
        self.network = network
        self.idx = idx
        self.identity = identity
        # WithMessageAuthor (pubsub.go:372-383): the identity stamped as
        # the author (`from` + signing key) of this node's published
        # messages — e.g. a stable logical identity distinct from the
        # transient host identity. None = the node's own identity.
        self.author = author
        self.protocol = protocol
        self.ip = ip
        self.sub_filter = sub_filter
        self.topics: dict[str, Topic] = {}
        self.blacklist = MapBlacklist()
        self.up = True

    @property
    def peer_id(self) -> bytes:
        return self.identity.peer_id

    # -- topic lifecycle ---------------------------------------------------

    def join(self, topic: str) -> Topic:
        """Join a topic (subscribes the node at the protocol level). One
        handle per topic; joining again returns it (pubsub.go:1146-1157)."""
        if topic in self.topics:
            return self.topics[topic]
        if self.sub_filter is not None and not self.sub_filter.can_subscribe(topic):
            raise APIError(f"subscription filter rejects topic {topic!r}")
        t = self.network._join(self, topic)
        self.topics[topic] = t
        return t

    def leave(self, topic: str) -> None:
        """Leave a topic (Topic.Close + router Leave, gossipsub.go:1066).

        On a *started* gossipsub network this advances the simulation by
        one transition round so the PRUNE crosses the wire before the
        mesh is rebuilt — tick-sensitive observables (heartbeat phase,
        score decay, run(rounds) totals) shift by that extra round."""
        t = self.topics.pop(topic, None)
        if t is not None:
            t.close()
            self.network._leave(self, t)

    # -- validators --------------------------------------------------------

    def get_topics(self) -> "list[str]":
        """Topics this node is subscribed to (GetTopics, pubsub.go)."""
        return sorted(self.topics)

    def list_peers(self, topic: str) -> "list[bytes]":
        """Peer ids of connected peers known to subscribe `topic`
        (ListPeers, pubsub.go:1220-1237 — the per-node topics-map view)."""
        net = self.network
        if topic not in net.topic_ids:
            return []
        tid = net.topic_ids[topic]
        if not net.started:
            return sorted(
                nd.identity.peer_id for nd in net._topic_members(tid)
                if nd is not self and net.are_connected(self, nd)
            )
        nbr = net._nh["nbr"][self.idx]
        ok = net._nh["nbr_ok"][self.idx]
        subbed = net._nh["subscribed"][:, tid]
        out = []
        for k in range(len(nbr)):
            j = int(nbr[k])
            if ok[k] and j >= 0 and subbed[j] and net.nodes[j].up:
                out.append(net.nodes[j].identity.peer_id)
        return sorted(set(out))

    def register_topic_validator(self, topic: str, fn: Callable,
                                 inline: bool = False,
                                 throttle: int = DEFAULT_TOPIC_THROTTLE) -> None:
        """fn(peer_id, pb.Message) -> bool/None; False rejects. Inline
        validators run synchronously (WithValidatorInline); async ones are
        subject to global + per-topic throttles (validation.go:391-438)."""
        self.network._register_validator(topic, _Validator(fn, inline, throttle))

    def unregister_topic_validator(self, topic: str) -> None:
        self.network._unregister_validator(topic)

    # -- lifecycle / moderation -------------------------------------------

    def blacklist_peer(self, peer: bytes) -> None:
        """BlacklistPeer (pubsub.go:590-605). In the vectorized engine the
        blacklist is global-view: the peer is disconnected from the whole
        simulation on the next round."""
        self.blacklist.add(peer)

    def disconnect(self) -> None:
        self.up = False

    def reconnect(self) -> None:
        self.up = True

    def peer_scores(self) -> dict[bytes, float]:
        """Score snapshot for this node's neighbors (WithPeerScoreInspect,
        score.go:120-177)."""
        return self.network._peer_scores(self)

    def peer_score_snapshots(self) -> "dict[bytes, PeerScoreSnapshot]":
        """Extended inspection (WithPeerScoreInspectDetailed): per-neighbor
        score plus the per-topic counters it is computed from
        (PeerScoreSnapshot/TopicScoreSnapshot, score.go:134-177)."""
        return self.network._peer_score_snapshots(self)


class Network:
    """The simulation owner: topology assembly -> start() -> run()."""

    def __init__(
        self,
        router: str = "gossipsub",
        params: GossipSubParams | None = None,
        score_params: PeerScoreParams | None = None,
        thresholds: PeerScoreThresholds | None = None,
        gater_params: PeerGaterParams | None = None,
        sign_policy: SignPolicy = SignPolicy.STRICT_SIGN,
        msg_slots: int = 64,
        max_publishes_per_round: int = 8,
        validate_throttle: int = DEFAULT_VALIDATE_THROTTLE,
        validation_delay_rounds: int = 0,
        validator_timeout_rounds: int = 0,
        queue_cap: int = 0,
        px_connect: bool = False,
        seed: int = 0,
        trace_sinks=None,
        msg_id_fn: Callable | None = None,
        discovery: Discovery | None = None,
        track_tags: bool = False,
        protocol_matcher: "ProtocolMatcher | None" = None,
        max_message_size: int | None = None,
        trace_exact: bool = False,
        rounds_per_phase: int = 1,
        device=None,
    ):
        if router not in ("gossipsub", "floodsub", "randomsub"):
            raise APIError(f"unknown router {router!r}")
        # the card unless the caller asks for another device; no CUDA
        # device raises (state.resolve_device)
        self.device = resolve_device(device)
        # validation_delay_rounds and queue_cap apply to EVERY router: in
        # the reference both sit below the router — the async validation
        # pipeline (validation.go:65-83) and the per-peer outbound writer
        # queues (comm.go:139-170; floodsub's drop at floodsub.go:91-98)
        # serve floodsub/randomsub exactly as they serve gossipsub, and
        # the shared delivery engine (models/common.py) models both
        # router-agnostically
        if trace_exact and router != "gossipsub":
            raise APIError("trace_exact is only modeled on the gossipsub router")
        if rounds_per_phase > 1:
            # the multi-round phase engine (models/gossipsub_phase.py):
            # control every r rounds, the reference's continuous-delivery
            # timing shape — the bench's production cadence. All observers
            # (trace_sinks / track_tags / trace_exact) work at this
            # cadence too: the drains consume phase-boundary snapshots,
            # reconstructing per-sub-round DELIVER/PUBLISH timestamps
            # from the device's first_round stamps and emitting control/
            # duplicate/mesh events at boundary resolution (trace/drain
            # module docstring). The reference never turns its router
            # observers off for cadence reasons (trace.go:63-530).
            if router != "gossipsub":
                raise APIError("rounds_per_phase requires the gossipsub router")
        if px_connect:
            if router != "gossipsub":
                raise APIError("px_connect requires the gossipsub router")
            if params is None or not params.do_px:
                raise APIError(
                    "px_connect requires GossipSubParams(do_px=True) — PX "
                    "only rides PRUNEs when the router emits it"
                )
        self.router = router
        # protocol id -> feature set (custom protocols + WithProtocolMatchFn
        # analogue; protocol.py documents the mapping to Net.protocol levels)
        self.protocol_matcher = protocol_matcher or ProtocolMatcher()
        # announce-retry model (pubsub.go:842-901): with queue_cap, a
        # runtime Join's SubOpts announcement toward a congested link is
        # dropped and retried with jitter; until it lands, that neighbor
        # cannot see the subscription (sub_knowledge_holes)
        self._pending_announce: dict = {}  # (joiner, tid) -> {receiver: due}
        self.announce_retries = 0
        self._announce_rng = np.random.default_rng(seed ^ 0xA220)
        self._sub_holes = None  # [N, K, T] bool | None
        self.params = params or GossipSubParams()
        self.score_params = score_params
        self.thresholds = thresholds or PeerScoreThresholds()
        self.gater_params = gater_params
        self.sign_policy = sign_policy
        self.msg_slots = msg_slots
        self.pub_width = max_publishes_per_round
        self.validate_throttle = validate_throttle
        self.validation_delay_rounds = validation_delay_rounds
        # WithValidatorTimeout (validation.go:522-529): an async verdict
        # that cannot land within T rounds of arrival times out and the
        # message resolves to Ignore (dropped, no sender penalty). The
        # knob composes with per-topic delays at the config layer
        # (GossipSubConfig.validation_timed_out); at the API layer the
        # effective delay is the uniform validation_delay_rounds.
        if validator_timeout_rounds < 0:
            raise APIError("validator_timeout_rounds must be >= 0")
        self.validator_timeout_rounds = validator_timeout_rounds
        self.queue_cap = queue_cap
        self.px_connect = px_connect
        # WithMaxMessageSize (pubsub.go:480-485; the reference defaults to
        # 1 MiB): a publish whose serialized message exceeds the limit
        # delivers locally and enters mcache/IHAVE, but every transmit
        # drops it (the sendRPC fragmentRPC drop, gossipsub.go:1126-1140).
        # Opt-in here (None = unchecked): enabling it adds the per-message
        # wire_block plane to the device state, which every engine's
        # kernels take through their receiver-exclusion masks — pass
        # max_message_size=1 << 20 for the reference's default behavior.
        self.max_message_size = max_message_size
        self.oversized_publishes = 0
        self._author_seqno: dict[bytes, int] = {}  # author id -> next seqno
        # the certified addr-book analogue: each peer's self-signed record,
        # what makePrune attaches to PX suggestions (gossipsub.go:1827-45).
        # Tests may override _px_record_source to model record forgery.
        self._peer_records: dict[int, "object"] = {}
        self._px_record_source = (
            lambda pruner_idx, suggested_idx:
            self._peer_records.get(suggested_idx)
        )
        self.seed = seed
        self.trace_sinks = trace_sinks
        # exact per-event tracing (duplicates + control-only RPCs as
        # individual events; trace.go:166-194, 341-414) — adds the
        # per-round duplicate plane to the device state
        self.trace_exact = trace_exact
        self.rounds_per_phase = int(rounds_per_phase)
        self.msg_id_fn = msg_id_fn or default_msg_id
        self.nodes: list[Node] = []
        self.topic_ids: dict[str, int] = {}
        self._edges: set[tuple[int, int]] = set()
        self._dormant_pairs: set[tuple[int, int]] = set()
        self._spare_pool: list[Node] = []  # provision_spare_nodes rows
        self._validators: dict[str, _Validator] = {}
        self._pub_queue: deque = deque()
        self._slot_msg: dict[int, rpc_pb2.Message] = {}
        self._timed_round = False  # first round pays kernel builds; no warn
        self._seen_mids: dict[bytes, int] = {}  # msgid -> slot
        self.started = False
        self._session: TraceSession | None = None
        self.state = None
        self.net = None
        self._nh: dict = {}  # host copies of the net's planes (_adopt_net)
        self._async_budget = validate_throttle
        self._topic_budget: dict[str, int] = {}
        # discovery pipeline (WithDiscovery; discovery.go Start)
        self.discovery = (
            DiscoverySession(self, discovery, seed=seed)
            if discovery is not None else None
        )
        # connmgr tag tracer (tag_tracer.go), attached at start()
        self._track_tags = track_tags
        self.tag_tracer = None

    # -- assembly ----------------------------------------------------------

    def add_node(self, protocol: str = "/meshsub/1.1.0", ip: str | None = None,
                 sub_filter: SubscriptionFilter | None = None,
                 seed: int | None = None,
                 author: Identity | None = None) -> Node:
        """Add a node. Pre-start: grows the assembly graph. POST-start:
        claims a pre-provisioned spare row (provision_spare_nodes) — the
        build-constant analogue of the reference admitting unknown peers at
        any moment (pubsub.go:614-646, notify.go:19-75): the row's padded
        adjacency, subscription template, and score/gater planes were
        compiled in at start(); claiming flips its liveness, with NO
        recompile. The claimed node keeps its provisioned identity,
        protocol, and topic template (join new topics via the runtime
        Join path, which does rebuild). Raises when the pool is empty —
        restart() is then the capacity-growing path."""
        if self.started:
            if not self._spare_pool:
                raise APIError(
                    "add_node after start(): the spare-node pool is empty "
                    "— provision capacity pre-start with "
                    "provision_spare_nodes(n), or restart() to grow the "
                    "topology (build-constant adjacency)"
                )
            if (protocol != "/meshsub/1.1.0" or ip is not None
                    or sub_filter is not None or seed is not None
                    or author is not None):
                # a claim returns the PROVISIONED row; silently dropping
                # a requested configuration would hand back a node with
                # the wrong protocol/identity
                raise APIError(
                    "add_node after start() claims a pre-provisioned "
                    "spare row and cannot honor per-node arguments — "
                    "configure rows at provision_spare_nodes() time"
                )
            node = self._spare_pool.pop(0)
            node._spare = False
            node.up = True  # the liveness plane applies it next round
            return node
        self.protocol_matcher.level(protocol)  # fail fast on unknown ids
        idx = len(self.nodes)
        ident = Identity.generate(self.seed * 1_000_003 + idx if seed is None else seed)
        node = Node(self, idx, ident, protocol, ip, sub_filter, author=author)
        self.nodes.append(node)
        return node

    def add_nodes(self, n: int, **kw) -> list[Node]:
        return [self.add_node(**kw) for _ in range(n)]

    def provision_spare_nodes(self, count: int, topics=(), degree: int = 4,
                              candidates: "list[Node] | None" = None,
                              seed: int = 0, **node_kw) -> "list[Node]":
        """Pre-start capacity pool for post-start add_node() (round-4
        review item 9: dormant PEER rows, not just edge slots).

        Each spare is a real row in the compiled state: DOWN at start
        (liveness plane), with `topics` pre-joined as its subscription
        template (invisible while down — down peers neither transmit nor
        receive, and mesh selection skips them) and `degree` dormant
        edges provisioned to random `candidates` (default: all current
        non-spare nodes). Claiming via add_node() post-start flips the
        row up; connect() then activates its dormant pairs on the live
        state — delivery flows the next round, zero recompiles, and the
        next heartbeat grafts it into its topics' meshes (the runtime-
        Join formation the reference gets from handleNewPeer + Join).

        The capacity contract is explicit where the reference's is
        implicit (memory): rows, their candidate edges, and their topic
        template are sized pre-start; anything outside the template goes
        through the rebuild paths (runtime Join / restart)."""
        self._check_not_started("provision_spare_nodes")
        if self.router != "gossipsub":
            raise APIError("spare rows require the gossipsub router "
                           "(liveness + edge-liveness planes)")
        rng = np.random.default_rng(seed ^ 0x5BA2E)
        cand = [
            nd for nd in (candidates if candidates is not None else self.nodes)
            if not getattr(nd, "_spare", False)
        ]
        if not cand:
            raise APIError("provision_spare_nodes needs existing non-spare "
                           "candidate neighbors")
        spares = []
        for _ in range(count):
            nd = self.add_node(**node_kw)
            nd._spare = True
            nd.up = False
            for t in topics:
                nd.join(t)
            picks = rng.choice(len(cand), size=min(degree, len(cand)),
                               replace=False)
            for j in picks:
                self.connect(nd, cand[int(j)], dormant=True)
            spares.append(nd)
        self._spare_pool.extend(spares)
        return spares

    def connect(self, a: Node, b: Node, dormant: bool = False) -> None:
        """a dials b (direction recorded for the outbound quota).

        Pre-start, records the edge in the assembly graph;
        ``dormant=True`` provisions the K-slot pair but leaves it
        inactive — the runtime-connect pool. Post-start, activates a
        provisioned dormant pair ON THE LIVE STATE (notify.go:19-75
        Connected / pubsub.go:614-646 newPeers): delivery flows the next
        round, no recompile. Connecting an unprovisioned pair post-start
        still requires restart() — the padded adjacency is a build
        constant."""
        if a.idx == b.idx:
            raise APIError("self connection")
        if dormant and self.router != "gossipsub":
            raise APIError(
                "dormant provisioning requires the gossipsub router "
                "(the edge-liveness plane)"
            )
        if not self.started:
            self._edges.add((a.idx, b.idx))
            pair = (min(a.idx, b.idx), max(a.idx, b.idx))
            if dormant:
                self._dormant_pairs.add(pair)
            else:
                # an explicit live connect overrides earlier dormant
                # provisioning of the same pair (last instruction wins)
                self._dormant_pairs.discard(pair)
            return
        if dormant:
            raise APIError("dormant provisioning is pre-start assembly")
        self._set_edge_live(a, b, True)

    def disconnect_edge(self, a: Node, b: Node) -> None:
        """Deactivate a live provisioned edge at runtime (the notify
        Disconnected path) — it returns to the dormant pool and can be
        re-activated by connect() or PX."""
        if not self.started:
            raise APIError("disconnect_edge is a runtime operation; "
                           "assemble the graph with connect() pre-start")
        self._set_edge_live(a, b, False)

    def _set_edge_live(self, a: Node, b: Node, value: bool) -> None:
        if self.router != "gossipsub":
            raise APIError("runtime edge activation requires the gossipsub "
                           "router (edge-liveness plane)")
        if not (self._cfg.do_px or self._cfg.edge_liveness):
            # the compiled step only consults state.edge_live when the
            # liveness plane is enabled — writing it here would silently
            # change nothing (messages would keep flowing)
            raise APIError(
                "this network was compiled without the edge-liveness "
                "plane: provision at least one connect(a, b, dormant="
                "True) pre-start (or enable px_connect) to make runtime "
                "edge activation/deactivation effective"
            )
        nbr = self._nh["nbr"]
        ok = self._nh["nbr_ok"]
        ka = np.flatnonzero((nbr[a.idx] == b.idx) & ok[a.idx])
        kb = np.flatnonzero((nbr[b.idx] == a.idx) & ok[b.idx])
        if len(ka) == 0 or len(kb) == 0:
            raise APIError(
                "edge not provisioned: post-start connect() only activates "
                "pairs provisioned pre-start (connect(a, b, dormant=True)) "
                "or PX-dormant slots; use restart() to grow the topology"
            )
        el = self.state.edge_live.clone()  # a new plane, not the held one
        el[a.idx, int(ka[0])] = value
        el[b.idx, int(kb[0])] = value
        self.state = replace(self.state, edge_live=el)

    def connect_all(self) -> None:
        for i, a in enumerate(self.nodes):
            for b in self.nodes[i + 1:]:
                self.connect(a, b)

    def sparse_connect(self, d: int = 3, seed: int = 0) -> None:
        """Each node dials d random others (floodsub_test.go:72-79)."""
        rng = np.random.default_rng(seed)
        n = len(self.nodes)
        for a in self.nodes:
            for j in rng.choice(n, size=min(d + 1, n), replace=False):
                if j != a.idx:
                    self.connect(a, self.nodes[int(j)])

    def dense_connect(self, d: int = 10, seed: int = 0) -> None:
        self.sparse_connect(d, seed)

    # -- internal assembly hooks ------------------------------------------

    def _check_not_started(self, what: str) -> None:
        if self.started:
            raise APIError(f"{what} after start(): topology is frozen (build constant)")

    def _join(self, node: Node, topic: str) -> Topic:
        if self.started and topic not in self.topic_ids:
            raise APIError("cannot create a new topic after start()")
        tid = self.topic_ids.setdefault(topic, len(self.topic_ids))
        t = Topic(node, topic, tid)
        if self.started:
            # runtime Join (pubsub.go:1163-1197): register the handle
            # first so _build_net sees the new subscription
            node.topics[topic] = t
            self._resubscribe(joiner=(node.idx, tid))
        # advertise joined topics to the discovery service
        # (handleAddSubscription -> disc.Advertise, pubsub.go:759-780)
        if self.discovery is not None:
            self.discovery.advertise(node, topic)
        return t

    def _leave(self, node: Node, t: Topic) -> None:
        if self.started:
            self._resubscribe(leaver=(node.idx, t.tid))
        if self.discovery is not None:
            self.discovery.stop_advertise(node, t.name)

    def are_connected(self, a: Node, b: Node) -> bool:
        return (a.idx, b.idx) in self._edges or (b.idx, a.idx) in self._edges

    def bootstrap(self, topic: str, min_peers: int = 0, max_polls: int = 100) -> bool:
        """Discover peers for `topic` until the router is ready
        (discover.Bootstrap, discovery.go:239-295). Pre-start this grows the
        topology; returns readiness."""
        if self.discovery is None:
            return True  # no discovery configured: trivially ready (d.Bootstrap nil path)
        return self.discovery.bootstrap(
            topic, min_topic_size(min_peers), max_polls=max_polls
        )

    def restart(self) -> None:
        """Unfreeze the topology: drop the compiled program + device state so
        assembly (connect / bootstrap / join) is allowed again; the next
        start()/run() recompiles with the grown topology. Protocol state is
        soft and rebuilt from the network, exactly as a process restart in
        the reference (SURVEY §5: no checkpointing of mesh state; it is
        reconstructed via heartbeats)."""
        if not self.started:
            return
        self.stop()
        self.started = False
        self.state = None
        self.net = None
        self._session = None
        self.tag_tracer = None  # rebuilt at next start()
        self._slot_msg.clear()
        self._seen_mids.clear()
        self._pub_queue.clear()

    def _topic_members(self, tid: int):
        return [n for n in self.nodes if any(t.tid == tid for t in n.topics.values())]

    def _register_validator(self, topic: str, v: _Validator) -> None:
        if topic in self._validators:
            raise APIError(f"duplicate validator for topic {topic!r}")
        self._validators[topic] = v

    def _unregister_validator(self, topic: str) -> None:
        if topic not in self._validators:
            raise APIError(f"no validator for topic {topic!r}")
        del self._validators[topic]

    # -- net construction (start() and post-start resubscription) ---------

    def _build_net(self, min_slots: int = 0):
        """Assemble the Net from the current nodes/edges/subscriptions."""
        n = len(self.nodes)
        n_topics = max(1, len(self.topic_ids))

        dialed = [set() for _ in range(n)]
        for a, b in self._edges:
            dialed[a].add(b)
        topo = graphlib._from_edge_lists(n, dialed, None)

        sub_mask = np.zeros((n, n_topics), bool)
        for node in self.nodes:
            for t in node.topics.values():
                sub_mask[node.idx, t.tid] = True
        max_slots = max(int(sub_mask.sum(axis=1).max()) if n else 1, min_slots, 1)
        subs = graphlib.subscribe_mask(sub_mask, max_slots=max_slots)

        protocol = np.array(
            [self.protocol_matcher.level(nd.protocol) for nd in self.nodes],
            np.int8,
        )
        ip_names = [nd.ip if nd.ip is not None else f"ip-{nd.idx}" for nd in self.nodes]
        ip_tbl: dict[str, int] = {}
        ip_group = np.array([ip_tbl.setdefault(s, len(ip_tbl)) for s in ip_names], np.int32)
        return Net.build(topo, subs, ip_group=ip_group, protocol=protocol,
                         device=self.device)

    def _adopt_net(self, net) -> dict:
        """Install ``net`` and its host copies (the neighbour and
        subscription planes every host-side read uses, copied once a
        build); returns the previous net's copies."""
        old = self._nh
        self.net = net
        self._nh = {name: _host(getattr(net, name)) for name in (
            "nbr", "nbr_ok", "slot_of", "my_topics", "subscribed")}
        return old

    def _resubscribe(self, leaver: "tuple[int, int] | None" = None,
                     joiner: "tuple[int, int] | None" = None) -> None:
        """Runtime Join/Leave (pubsub.go:1146-1218, topic.go): rebuild the
        subscription constants and recompile the step, carrying all protocol
        state across with a per-node topic-slot remap. The reference
        announces subscription changes via a SubOpts RPC that peers apply
        on receipt (announce, pubsub.go:842-859); without backpressure the
        new subscription map becomes visible to everyone on the next round
        — the same one-RTT visibility. With ``queue_cap`` the announce
        rides the joiner's per-link outbound queues: toward a link that
        was saturated it is dropped and retried with jitter
        (pubsub.go:861-901), and until it lands that neighbor cannot see
        the subscription (sub_knowledge_holes; _process_announces runs the
        retry loop each round).

        For a Leave, the leaver first PRUNEs its mesh members (Leave sends
        PRUNE+backoff, gossipsub.go:1066-1082): the prune rides the current
        step for one transition round before the rebuild. Every remapped
        plane is a new tensor on the state's device with the leaf's dtype."""
        from .trace.events import EV

        if self.router == "gossipsub" and leaver is not None:
            node_idx, tid = leaver
            s_old = int(self._nh["slot_of"][node_idx, tid])
            if s_old >= 0:
                st = self.state
                prune_out = st.prune_out.clone()
                prune_out[node_idx, s_old] |= st.mesh[node_idx, s_old]
                mesh = st.mesh.clone()
                mesh[node_idx, s_old] = False
                self.state = replace(st, prune_out=prune_out, mesh=mesh)
                # one transition round under the old net so the PRUNE
                # crosses the wire and the far ends apply it — advanced
                # directly, without run()'s publish-queue drain or
                # validation-budget reset side effects
                self._advance_empty_round()

        old_net = self.net
        old_s = old_net.n_slots
        # never shrink the slot axis: keeps array shapes monotonic
        old_nh = self._adopt_net(self._build_net(min_slots=old_s))
        self.topic_names = {tid: name for name, tid in self.topic_ids.items()}

        if self.router == "gossipsub":
            # per-node slot remap: new slot s (topic t) takes the old
            # slot's state when the node was subscribed to t before
            my_t_new = self._nh["my_topics"]                 # [N, S']
            old_slot_of = old_nh["slot_of"]                  # [N, T_old]
            t_old_dim = old_slot_of.shape[1]
            tclip = np.clip(my_t_new, 0, t_old_dim - 1)
            old_slot = np.where(
                (my_t_new >= 0) & (my_t_new < t_old_dim),
                np.take_along_axis(old_slot_of, tclip, axis=1), -1,
            )
            idx = np.where(old_slot >= 0, old_slot, old_s)   # old_s = fresh
            idx_t = torch.as_tensor(idx, dtype=torch.int64, device=self.device)

            def remap(a, fill):
                return _take_slots(a, idx_t, 1, fill)

            st = self.state
            sc = st.score
            # a freshly joined topic that was being tracked as fanout is
            # promoted (Join, gossipsub.go:1024-1048): drop the fanout slot;
            # the next heartbeat grafts the mesh
            joined_now = self._nh["subscribed"]
            ft = _host(st.fanout_topic)
            drop_f = (ft >= 0) & np.take_along_axis(
                joined_now, np.clip(ft, 0, joined_now.shape[1] - 1), axis=1
            )
            events = st.core.events
            if self._cfg.count_events:
                events = events.clone()
                events[EV.JOIN if leaver is None else EV.LEAVE] += 1
            self.state = replace(
                st,
                core=replace(st.core, events=events),
                mesh=remap(st.mesh, False),
                backoff_expire=remap(st.backoff_expire, 0),
                backoff_present=remap(st.backoff_present, False),
                graft_out=remap(st.graft_out, False),
                prune_out=remap(st.prune_out, False),
                prune_px_out=remap(st.prune_px_out, False),
                fanout_topic=torch.as_tensor(np.where(drop_f, -1, ft).astype(ft.dtype),
                                             device=self.device),
                score=replace(
                    sc,
                    fmd=remap(sc.fmd, 0.0), mmd=remap(sc.mmd, 0.0),
                    mfp=remap(sc.mfp, 0.0), imd=remap(sc.imd, 0.0),
                    graft_tick=remap(sc.graft_tick, -1),
                    mesh_time=remap(sc.mesh_time, 0),
                    mmd_active=remap(sc.mmd_active, False),
                ),
            )
            if joiner is not None and self.queue_cap > 0:
                # every live edge of the joiner needs the SubOpts announce
                # delivered before the far end can see the subscription;
                # first attempt rides out next round
                j, tid = joiner
                nbr = self._nh["nbr"]
                ok = self._nh["nbr_ok"]
                now = int(self.state.core.tick)
                recv = {
                    i: now + 1
                    for i in range(len(self.nodes))
                    if i != j and bool((ok[i] & (nbr[i] == j)).any())
                }
                if recv:
                    self._pending_announce[(j, tid)] = recv
                    self._rebuild_sub_holes()
            self._recompile_gossipsub()
            if self.tag_tracer is not None:
                old_tags = self.tag_tracer.cm.tags
                last_decay = self.tag_tracer.cm.last_decay
                from .connmgr import TagTracer

                self.tag_tracer = TagTracer(self.net)
                padded = np.concatenate(
                    [old_tags, np.zeros_like(old_tags[:, :1])], axis=1
                )
                self.tag_tracer.cm.tags = np.take_along_axis(
                    padded, idx[:, :, None], axis=1
                )
                self.tag_tracer.cm.last_decay = last_decay
        elif self.router == "randomsub":
            from .models.randomsub import make_randomsub_step

            self._step = make_randomsub_step(self.net, queue_cap=self.queue_cap)
        else:
            from .models.floodsub import floodsub_step

            def _fstep(st, po, pt, pv, _net=self.net, _cap=self.queue_cap):
                return floodsub_step(_net, st, po, pt, pv, queue_cap=_cap)

            self._step = _fstep

        if self._session is not None:
            self._session.nbr = self._nh["nbr"]
            self._session.my_topics = self._nh["my_topics"]
            self._session.subscribed = self._nh["subscribed"]

    def _recompile_gossipsub(self) -> None:
        """(Re)build the gossipsub step for the current net + score/gater
        params (start, runtime Join/Leave, SetScoreParams). There is no
        compile cache to invalidate: the step closure is built anew, with
        the options the JAX package's API passes."""
        from .models.gossipsub import make_gossipsub_step
        from .models.gossipsub_phase import make_gossipsub_phase_step

        if self.rounds_per_phase > 1:
            self._step = make_gossipsub_phase_step(
                self._cfg, self.net, self.rounds_per_phase,
                score_params=self.score_params,
                gater_params=self.gater_params, dynamic_peers=True,
                sub_knowledge_holes=self._sub_holes,
                # the API owns the inspect surface (peer_score_snapshots,
                # score.go:120-177's always-exact contract), so its builds
                # never elide attribution planes — counters stay
                # reference-faithful; the tracer-detached bench path
                # (bench.py builds the step directly) keeps elision
                exact_counters=True,
                # _run_phase enforces the msg_slots//2 flat admission cap,
                # so the engine-layer capacity warning would be noise here
                admission_capped=True,
            )
            return
        self._step = make_gossipsub_step(
            self._cfg, self.net, score_params=self.score_params,
            gater_params=self.gater_params, dynamic_peers=True,
            sub_knowledge_holes=self._sub_holes,
        )

    # -- start: freeze + compile ------------------------------------------

    def start(self) -> None:
        if self.started:
            return
        from .models.gossipsub import GossipSubConfig, GossipSubState
        from .models.randomsub import make_randomsub_step

        n = len(self.nodes)
        if n == 0:
            raise APIError("empty network")
        self._adopt_net(self._build_net())
        self.topic_names = {tid: name for name, tid in self.topic_ids.items()}

        if self.router == "gossipsub":
            sp = self.score_params
            score_enabled = sp is not None
            cfg = GossipSubConfig.build(
                self.params, self.thresholds,
                score_enabled=score_enabled,
                gater_params=self.gater_params,
                validation_delay_rounds=self.validation_delay_rounds,
                validator_timeout_rounds=self.validator_timeout_rounds,
                queue_cap=self.queue_cap,
                trace_exact=self.trace_exact,
            )
            dormant = None
            if self._dormant_pairs:
                # the runtime-connect pool: provisioned K-slot pairs that
                # start inactive; post-start connect() flips them live on
                # the device state without recompiling
                cfg = dataclasses.replace(cfg, edge_liveness=True)
                nbr_np = self._nh["nbr"]
                ok_np = self._nh["nbr_ok"]
                dormant = np.zeros(nbr_np.shape, bool)
                for lo, hi in self._dormant_pairs:
                    dormant[lo, (nbr_np[lo] == hi) & ok_np[lo]] = True
                    dormant[hi, (nbr_np[hi] == lo) & ok_np[hi]] = True
            self.state = GossipSubState.init(
                self.net, self.msg_slots, cfg, score_params=sp, seed=self.seed,
                wire_block=self.max_message_size is not None,
                dormant=dormant,
            )
            self._cfg = cfg
            self._recompile_gossipsub()
            self._dynamic = True
        elif self.router == "randomsub":
            # the validation pipeline + outbound queues sit below the
            # router in the reference (validation.go:65-83,
            # comm.go:139-170) — same knobs as gossipsub
            self.state = SimState.init(n, self.msg_slots, self.seed,
                                       k=self.net.max_degree, device=self.device,
                                       val_delay=self.validation_delay_rounds,
                                       wire_block=self.max_message_size is not None)
            self._step = make_randomsub_step(self.net, queue_cap=self.queue_cap)
            self._dynamic = False
        else:  # floodsub
            from .models.floodsub import floodsub_step

            self.state = SimState.init(n, self.msg_slots, self.seed,
                                       k=self.net.max_degree, device=self.device,
                                       val_delay=self.validation_delay_rounds,
                                       wire_block=self.max_message_size is not None)

            def _fstep(st, po, pt, pv, _net=self.net, _cap=self.queue_cap):
                return floodsub_step(_net, st, po, pt, pv, queue_cap=_cap)

            self._step = _fstep
            self._dynamic = False

        self.started = True
        # certified addr book: every peer's self-signed record (what
        # makePrune will attach to PX suggestions)
        self._peer_records = {
            nd.idx: make_peer_record(nd.identity, 0) for nd in self.nodes
        }
        if self._track_tags:
            from .connmgr import TagTracer

            self.tag_tracer = TagTracer(self.net)
        if self.trace_sinks:
            # with engine-enforced backpressure the session's bookkeeping
            # DropRPC model must be off — drops are real (and counted in
            # the DROP_RPC event counter), so modeling them again would
            # emit phantom or missing drop events
            self._session = TraceSession(
                self.net, self.trace_sinks,
                queue_cap=0 if self.queue_cap else 32,
                topic_name=lambda t: self.topic_names.get(t, f"topic-{t}"),
                # real identities on the trace: event peerIDs are the
                # nodes' ed25519 ids, and messageIDs come from the actual
                # published message (honoring WithMessageAuthor overrides
                # and custom WithMessageIdFn) — run() records the slot ->
                # message mapping before observe() runs
                peer_id_of=lambda i: self.nodes[i].identity.peer_id,
                # the defensive fallback is slot-unique: if it ever fired
                # for two slots, a shared constant would alias their trace
                # messageIDs and silently corrupt slot_mid-based
                # DUPLICATE/DELIVER attribution downstream
                mid_fn=lambda origin, sq, slot: (
                    self.msg_id_fn(self._slot_msg[slot])
                    if slot in self._slot_msg else b"?unknown-%d" % slot
                ),
                exact=self.trace_exact,
            )
            self._session.emit_init(snapshot(self.state))
        if self.rounds_per_phase > 1:
            # formation prelude (driver-owned cold start): the phase
            # engine's first heartbeat fires at the first phase TAIL, so
            # a publish in phase 0 would find no mesh and lose most of
            # the network. One publish-free phase here forms the mesh
            # (tail heartbeat = Join selection; the next phase's control
            # head ingests the GRAFTs), so publishing right after
            # start() behaves like the reference's immediate Join
            # (gossipsub.go:1015-1064). Costs rounds_per_phase ticks of
            # simulated time before round 0 of user traffic.
            self._advance_empty_round()

    # -- publish path ------------------------------------------------------

    def _publish(self, node: Node, topic: Topic, data: bytes) -> bytes:
        if not self.started:
            raise APIError("publish before start()")
        msg = rpc_pb2.Message(data=data, topic=topic.name)
        if self.sign_policy in (SignPolicy.STRICT_SIGN, SignPolicy.LAX_SIGN):
            # author override (WithMessageAuthor, pubsub.go:372-383): the
            # message is attributed to — and signed by — the configured
            # author identity rather than the transient node identity.
            # Seqnos are drawn from one counter per author id, so two
            # nodes sharing an author never collide on from‖seqno message
            # ids (the reference avoids this probabilistically with
            # time-initialized counters, pubsub.go:1259-1264; a
            # deterministic sim needs the counter shared outright)
            author = node.author or node.identity
            setattr(msg, "from", author.peer_id)
            sq = self._author_seqno.setdefault(author.peer_id, 0)
            self._author_seqno[author.peer_id] = sq + 1
            msg.seqno = sq.to_bytes(8, "big")
            if self.sign_policy.signs:
                sign_message(msg, author)
        # local validation front-end (PushLocal validation.go:216-226):
        # signing policy, then inline + async validators
        check_signing_policy(self.sign_policy, msg)
        verdict = self._run_validators(node, topic, msg, local=True)
        if (self.max_message_size is not None
                and msg.ByteSize() > self.max_message_size):
            # oversized: local delivery + mcache/IHAVE presence, but the
            # wire refuses it everywhere (WithMaxMessageSize pubsub.go:480;
            # fragmentRPC single-message drop gossipsub.go:1126-1140).
            # Boundary approximation: the reference gates on the full
            # serialized RPC envelope (out.Size() < maxMessageSize), so a
            # message within a few bytes of the limit can pass here yet be
            # dropped by the reference once RPC framing overhead is added;
            # the sim compares the bare Message size because its wire model
            # never materializes per-RPC envelopes
            from .state import VERDICT_WIRE_BLOCK

            verdict = verdict | VERDICT_WIRE_BLOCK
            self.oversized_publishes += 1
            _log.warning(
                "message from %d on %r exceeds max_message_size (%d > %d); "
                "it will not be transmitted", node.idx, topic.name,
                msg.ByteSize(), self.max_message_size,
            )
        mid = self.msg_id_fn(msg)
        self._pub_queue.append((node.idx, topic.tid, verdict, msg, mid))
        # local delivery to the publisher's own subscriptions happens at
        # publish (publishMessage -> notifySubs, pubsub.go:1124-1128)
        for sub in list(topic._subs):
            if not sub.cancelled:
                sub._push(msg)
        return mid

    # -- peer exchange (host-side pxConnect) ------------------------------

    def _px_connect_pass(self) -> None:
        """Host-side pxConnect (gossipsub.go:861-941): a PRUNE carrying PX
        suggests up to PrunePeers of the pruner's current topic-mesh
        members (score >= 0, excluding the pruned peer — makePrune,
        gossipsub.go:1814-1850), each with a signed peer record. The
        pruned peer validates every record — identity mismatch or a
        signature that doesn't verify against the advertised peer's key
        discards the suggestion (gossipsub.go:877-895) — and dials
        validated peers it has no edge to, genuinely growing the topology
        (the engine-level PX plane can only activate pre-provisioned
        dormant edges). At most 8 dials per round (the reference's
        connector pool, gossipsub.go:493-495)."""
        if not bool(self.state.prune_px_out.any()):
            return
        px_out = _host(self.state.prune_px_out)
        nbr = self._nh["nbr"]
        nbr_ok = self._nh["nbr_ok"]
        mesh = _host(self.state.mesh)
        scores = _host(self.state.scores)
        rng = np.random.default_rng(self.seed ^ (int(self.state.core.tick) << 1))
        PRUNE_PEERS = 16   # GossipSubPrunePeers (gossipsub.go:46)
        MAX_DIALS = 8      # per-peer pending-dial cap: each peer's router
                           # owns its own connector pool (gossipsub.go:493-495)
        dials: dict[int, int] = {}
        new_edges = []
        have = {(min(a, b), max(a, b)) for a, b in self._edges}
        for j, s, k in np.argwhere(px_out):
            if not nbr_ok[j, k]:
                continue
            p = int(nbr[j, k])   # the pruned peer receiving suggestions
            sugg = [
                int(nbr[j, kk]) for kk in np.nonzero(mesh[j, s])[0]
                if nbr_ok[j, kk] and scores[j, kk] >= 0
                and int(nbr[j, kk]) != p
            ]
            if len(sugg) > PRUNE_PEERS:
                sugg = [int(x) for x in
                        rng.choice(sugg, size=PRUNE_PEERS, replace=False)]
            for q in sugg:
                if dials.get(p, 0) >= MAX_DIALS:
                    break
                key = (min(p, q), max(p, q))
                if p == q or key in have:
                    continue
                rec = self._px_record_source(int(j), q)
                if not validate_peer_record(rec, self.nodes[q].identity.peer_id):
                    continue
                new_edges.append((p, q))
                have.add(key)
                dials[p] = dials.get(p, 0) + 1
        if new_edges:
            for a, b in new_edges:
                self._edges.add((a, b))
            self._rebuild_edges()

    def _rebuild_edges(self) -> None:
        """Rebuild the topology after edge additions, carrying all
        per-edge protocol state across with an edge-slot remap (the edge
        analogue of _resubscribe's topic-slot remap). Existing neighbors
        keep their state at their new slot; fresh edges start with clean
        soft state. Every remapped plane is a new tensor on the state's
        device with the leaf's dtype (int16 counters stay int16)."""
        assert self.router == "gossipsub"
        old_net = self.net
        old_nh = self._adopt_net(self._build_net(min_slots=old_net.n_slots))

        old_nbr = old_nh["nbr"]
        old_ok = old_nh["nbr_ok"]
        new_nbr = self._nh["nbr"]
        new_ok = self._nh["nbr_ok"]
        n = len(self.nodes)
        k_old, k_new = old_nbr.shape[1], new_nbr.shape[1]
        # idx[i, k'] = old edge slot holding the same neighbor, k_old = fresh
        idx = np.full((n, k_new), k_old, np.int64)
        for i in range(n):
            pos = {int(old_nbr[i, kk]): kk
                   for kk in range(k_old) if old_ok[i, kk]}
            for kk in range(k_new):
                if new_ok[i, kk]:
                    o = pos.get(int(new_nbr[i, kk]))
                    if o is not None:
                        idx[i, kk] = o

        idx_t = torch.as_tensor(idx, device=self.device)

        def remap(arr, axis, fill):
            return _take_slots(arr, idx_t, axis, fill)

        st = self.state
        score = replace(
            st.score,
            fmd=remap(st.score.fmd, 2, 0.0),
            mmd=remap(st.score.mmd, 2, 0.0),
            mfp=remap(st.score.mfp, 2, 0.0),
            imd=remap(st.score.imd, 2, 0.0),
            graft_tick=remap(st.score.graft_tick, 2, -1),
            mesh_time=remap(st.score.mesh_time, 2, 0),
            mmd_active=remap(st.score.mmd_active, 2, False),
            bp=remap(st.score.bp, 1, 0.0),
        )
        gater = replace(
            st.gater,
            deliver=remap(st.gater.deliver, 1, 0.0),
            duplicate=remap(st.gater.duplicate, 1, 0.0),
            ignore=remap(st.gater.ignore, 1, 0.0),
            reject=remap(st.gater.reject, 1, 0.0),
        )
        if self.score_params is not None:
            from .score.engine import ip_colocation_surplus_sq

            p6 = ip_colocation_surplus_sq(
                self.net,
                self.score_params.ip_colocation_factor_threshold,
                self.score_params.ip_colocation_factor_whitelist,
            )
        else:
            p6 = torch.zeros((n, k_new), dtype=torch.float32, device=self.device)
        self.state = replace(
            st,
            core=replace(
                st.core,
                dlv=replace(
                    st.core.dlv,
                    fe_words=remap(st.core.dlv.fe_words, 1, 0)
                )
            ),
            mesh=remap(st.mesh, 2, False),
            backoff_expire=remap(st.backoff_expire, 2, 0),
            backoff_present=remap(st.backoff_present, 2, False),
            graft_out=remap(st.graft_out, 2, False),
            prune_out=remap(st.prune_out, 2, False),
            prune_px_out=remap(st.prune_px_out, 2, False),
            ihave_out=remap(st.ihave_out, 1, 0),
            iwant_out=remap(st.iwant_out, 1, 0),
            served_lo=remap(st.served_lo, 1, 0),
            served_hi=remap(st.served_hi, 1, 0),
            peerhave=remap(st.peerhave, 1, 0),
            iasked=remap(st.iasked, 1, 0),
            promise_mid=remap(st.promise_mid, 1, -1),
            promise_expire=remap(st.promise_expire, 1, 0),
            congested_in=remap(st.congested_in, 1, False),
            scores=remap(st.scores, 1, 0.0),
            p6=p6,
            fanout_peers=remap(st.fanout_peers, 2, False),
            edge_live=remap(st.edge_live, 1, True),
            score=score,
            gater=gater,
        )
        # pending-announce holes are keyed by receiver id, not edge slot,
        # but the [N, K, T] mask must be rebuilt at the new max_degree
        # before the recompile consumes it
        self._rebuild_sub_holes()
        self._recompile_gossipsub()

    def _edge_slots_toward(self, i: int, j: int, nbr=None, ok=None):
        """Edge slots of receiver i whose far end is peer j (live edges)."""
        nbr = self._nh["nbr"] if nbr is None else nbr
        ok = self._nh["nbr_ok"] if ok is None else ok
        return np.flatnonzero(ok[i] & (nbr[i] == j))

    def _rebuild_sub_holes(self) -> None:
        """[N, K, T] knowledge-hole mask from the pending announces (which
        are keyed by RECEIVER id — edge slots are derived from the CURRENT
        net here, so topology rebuilds can't leave stale slots)."""
        if not self._pending_announce:
            self._sub_holes = None
            return
        nbr = self._nh["nbr"]
        ok = self._nh["nbr_ok"]
        holes = np.zeros(
            (len(self.nodes), self.net.max_degree, self.net.n_topics), bool
        )
        for (j, tid), recv in self._pending_announce.items():
            for i in recv:
                for k in self._edge_slots_toward(i, j, nbr, ok):
                    holes[i, k, tid] = True
        self._sub_holes = holes

    def _process_announces(self) -> None:
        """One round of the announce-retry loop (pubsub.go:861-901): a
        pending SubOpts announcement lands unless the joiner's outbound
        link toward that neighbor was saturated this round — then it is
        dropped and retried after a jittered backoff."""
        if not self._pending_announce or self.router != "gossipsub":
            return
        cong = _host(self.state.congested_in)  # [N, K]
        nbr = self._nh["nbr"]
        ok = self._nh["nbr_ok"]
        now = int(self.state.core.tick)
        changed = False
        for key, recv in list(self._pending_announce.items()):
            j, _tid = key
            for i in list(recv):
                if now < recv[i]:
                    continue
                ks = self._edge_slots_toward(i, j, nbr, ok)
                if ks.size and bool(cong[i, ks].any()):
                    self.announce_retries += 1
                    recv[i] = now + 1 + int(self._announce_rng.integers(0, 2))
                else:
                    del recv[i]
                    changed = True
            if not recv:
                del self._pending_announce[key]
        if changed:
            self._rebuild_sub_holes()
            self._recompile_gossipsub()

    def _run_validators(self, node: Node, topic: Topic, msg, local: bool) -> int:
        """Returns a VERDICT_* code. Local publishes surface reject and
        ignore as ValidationError, matching validate()'s errors back to
        Publish (validation.go:318-322, 339-341)."""
        v = self._validators.get(topic.name)
        if v is None:
            return VERDICT_ACCEPT
        timed_out = False
        if not v.inline:
            tb = self._topic_budget.setdefault(topic.name, v.throttle)
            if self._async_budget <= 0 or tb <= 0:
                # throttled: local publishes error out (validation.go:241-244)
                raise ValidationError("validation throttled")
            self._async_budget -= 1
            self._topic_budget[topic.name] = tb - 1
            # WithValidatorTimeout (validation.go:522-529): the verdict
            # of an async validator whose pipeline delay exceeds the
            # timeout never lands — the expired context resolves to
            # Ignore. The validator still RUNS (the reference cancels
            # the context, not the goroutine); its result is discarded.
            if self.validator_timeout_rounds > 0:
                cfg = getattr(self, "_cfg", None)  # gossipsub-only per-topic
                if cfg is not None:
                    timed_out = cfg.validation_timed_out(topic.tid)
                else:
                    timed_out = (self.validation_delay_rounds
                                 > self.validator_timeout_rounds)
        res = v.fn(node.identity.peer_id, msg)
        if timed_out:
            if local:
                raise ValidationError("validation timed out")
            return VERDICT_IGNORE
        # bool returns keep the original two-verdict interface. Normalize
        # by type first: bools (incl. numpy bools) overlap the int codes
        # 1/0, so a truthiness check must precede the code comparison
        if isinstance(res, (bool, np.bool_)):
            res = VERDICT_ACCEPT if res else VERDICT_REJECT
        if res == VERDICT_REJECT:
            if local:
                raise ValidationError("message rejected by validator")
            return VERDICT_REJECT
        if res == VERDICT_IGNORE:
            if local:
                raise ValidationError("message ignored by validator")
            return VERDICT_IGNORE
        return VERDICT_ACCEPT

    # -- run loop ----------------------------------------------------------

    def _advance_empty_round(self) -> None:
        """One protocol round with no publishes and full observation
        bookkeeping (traces, tags, membership, delivery drain) — but
        without run()'s publish-queue drain or validation-budget reset.
        Used for internal transition rounds (e.g. Leave's PRUNE). In phase
        mode the transition quantum is one full (publish-free) phase — the
        step advances rounds_per_phase ticks."""
        r = self.rounds_per_phase
        if r > 1:
            po = np.full((r, self.pub_width), -1, np.int32)
            pt = np.zeros((r, self.pub_width), np.int32)
            pv = np.zeros((r, self.pub_width), np.int8)
        else:
            po = np.full(self.pub_width, -1, np.int32)
            pt = np.zeros(self.pub_width, np.int32)
            pv = np.zeros(self.pub_width, np.int8)  # VERDICT_* codes
        prev = snapshot(self.state)
        args = (self.state, *self._dev(po, pt, pv))
        kw = {"do_heartbeat": True} if r > 1 else {}
        if self._dynamic:
            self.state = self._step(*args, *self._dev(self._up_row()), **kw)
        else:
            self.state = self._step(*args, **kw)
        new = snapshot(self.state)
        if prev.up is not None and new.up is not None:
            self._emit_membership_events(prev.up, new.up)
        if self._session is not None:
            self._session.observe(prev, new, po, pt, pv)
        if self.tag_tracer is not None:
            self.tag_tracer.observe(prev, new)
        self._drain_deliveries(prev, new)

    def run(self, rounds: int = 1, checkpoint_every: int | None = None,
            checkpoint_path: str | None = None, keep_last: int = 1,
            keep_every: int = 0) -> None:
        """Advance the simulation; distributes queued publishes over the
        first rounds (pub_width per round) and drains deliveries into
        subscriptions after each round.

        ``checkpoint_every=k, checkpoint_path=p`` auto-snapshots the
        DEVICE state through the npz checkpoint backend every k simulated
        rounds, so long soaks — chaos runs especially — are resumable
        after a host crash: ``load_checkpoint(p)`` on an identically-
        built Network restores the snapshot, and the resumed run
        continues the exact PRNG — and therefore the exact chaos fault —
        stream (the generators are functions of (key, tick), both in the
        snapshot; a GE chain's state plane rides the pytree).

        With the default ``keep_last=1, keep_every=0`` the snapshot
        atomically overwrites the single file ``p`` (the pre-round-17
        behavior). ``keep_last=k`` and/or ``keep_every=m`` instead treat
        ``p`` as a DIRECTORY driven by the same rolling
        ``serve.store.CheckpointStore`` the supervised service loop
        uses — checksummed snapshots, a manifest, the last k always
        retained plus every m-th pinned forever, and
        ``load_checkpoint(p)`` restoring the newest uncorrupted entry
        (falling back past damaged files) — multi-snapshot durability
        for API-layer soaks, for free.

        In phase mode the snapshot cadence quantizes up to phase
        boundaries. Host-side observation state (subscription queues,
        trace sessions, message-id maps) is NOT in the snapshot — resume
        on a freshly built Network."""
        # argument validation precedes start(): a bad call must not have
        # the irreversible side effect of compiling/freezing the topology
        if (checkpoint_every is None) != (checkpoint_path is None):
            raise APIError(
                "checkpoint_every and checkpoint_path must be passed "
                "together"
            )
        if checkpoint_every is not None and checkpoint_every < 1:
            raise APIError("checkpoint_every must be >= 1")
        if keep_last < 1 or keep_every < 0:
            raise APIError(
                "keep_last must be >= 1 and keep_every >= 0 "
                f"(got keep_last={keep_last}, keep_every={keep_every})")
        self._ckpt_retention = (int(keep_last), int(keep_every))
        if not self.started:
            self.start()
        if checkpoint_every is not None and not hasattr(self, "_last_ckpt_tick"):
            # cadence anchors at this run()'s entry tick; later runs (and
            # a load_checkpoint) keep the anchor so snapshots land every
            # k simulated rounds across run() calls
            self._last_ckpt_tick = int(
                getattr(self.state, "core", self.state).tick
            )
        # per-run validation throttle budgets (the reference's are
        # steady-state queue depths; one run() is our quantum)
        self._async_budget = self.validate_throttle
        self._topic_budget = {}

        if self.rounds_per_phase > 1:
            r = self.rounds_per_phase
            if rounds % r:
                raise APIError(
                    f"run({rounds}) with rounds_per_phase={r}: the round "
                    "count must be a multiple of the phase size"
                )
            for _ in range(rounds // r):
                self._run_phase()
                self._maybe_checkpoint(checkpoint_every, checkpoint_path)
            return

        for _ in range(rounds):
            _t0 = time.perf_counter()
            po = np.full(self.pub_width, -1, np.int32)
            pt = np.zeros(self.pub_width, np.int32)
            pv = np.zeros(self.pub_width, np.int8)  # VERDICT_* codes
            batch = []
            for j in range(self.pub_width):
                if not self._pub_queue:
                    break
                origin, tid, verdict, msg, mid = self._pub_queue.popleft()
                po[j], pt[j], pv[j] = origin, tid, verdict
                batch.append((msg, mid))

            prev = snapshot(self.state)
            args = (self.state, *self._dev(po, pt, pv))
            if self._dynamic:
                self.state = self._step(*args, *self._dev(self._up_row()))
            else:
                self.state = self._step(*args)
            new = snapshot(self.state)
            if prev.up is not None and new.up is not None:
                self._emit_membership_events(prev.up, new.up)

            # record slot -> message for delivery fan-out
            is_pub = po >= 0
            pos = np.cumsum(is_pub) - 1
            slots = (prev.cursor + pos) % self.msg_slots
            for j, (msg, mid) in zip(np.nonzero(is_pub)[0], batch):
                slot = int(slots[j])
                self._slot_msg[slot] = msg
                self._seen_mids[mid] = slot

            if self._session is not None:
                self._session.observe(prev, new, po, pt, pv)
            if self.tag_tracer is not None:
                self.tag_tracer.observe(prev, new)
            self._drain_deliveries(prev, new)
            if self.px_connect:
                self._px_connect_pass()
            self._process_announces()
            self._maybe_checkpoint(checkpoint_every, checkpoint_path)

            # slow-heartbeat warning (gossipsub.go:133-135,1305-1312): a
            # real-time co-simulation can't keep up when a tick's wall
            # time exceeds the warn fraction of the heartbeat interval.
            # The first round is excluded — it pays one-time kernel builds.
            dt = time.perf_counter() - _t0
            warmed, self._timed_round = self._timed_round, True
            if warmed and dt > SLOW_HEARTBEAT_WARN * self.params.heartbeat_interval:
                _log.warning(
                    "slow heartbeat: tick took %.3fs, %.0f%% of the %.1fs "
                    "interval", dt,
                    100.0 * dt / self.params.heartbeat_interval,
                    self.params.heartbeat_interval,
                )

    def _run_phase(self) -> None:
        """One multi-round phase through the phase engine: r publish batches
        land one per sub-round; deliveries drain at the phase boundary.

        Publish admission is capped at msg_slots // 2 per phase: slots
        recycled WITHIN a phase wipe their receipts before the boundary
        drain can deliver them (allocate_publishes clears first_round on
        recycle — the per-round path drains every round so never races
        this). Half the table per phase leaves the other half for the
        previous phases' delivery tails; excess publishes stay queued for
        the next phase (the reference's publish path backpressures the
        same way when its validation frontend saturates).

        The cap protects exactly ONE phase of delivery tail: at sustained
        cap-rate publishing a slot is recycled two phases after
        allocation, so messages whose propagation spans 2+ phases (small
        rounds_per_phase relative to network diameter) can still lose
        their first_round stamp before the boundary drain sees it —
        subscriber deliveries silently drop. That is the r-dependent slot
        TTL constraint (state.py MsgTable documents the per-round form):
        slots live ~msg_slots/publish-rate ROUNDS, and a phase consumes r
        of them per drain opportunity. _run_phase warns when consecutive
        phases saturate the cap; size msg_slots >= 2 * cap_rate *
        ceil(diameter / r + 1) (or lower the publish rate) to keep tails
        drainable."""
        r = self.rounds_per_phase
        po = np.full((r, self.pub_width), -1, np.int32)
        pt = np.zeros((r, self.pub_width), np.int32)
        pv = np.zeros((r, self.pub_width), np.int8)
        batch = []  # (flat running index, msg, mid) in allocation order
        flat = 0
        cap = max(1, self.msg_slots // 2)
        for i in range(r):
            if flat >= cap:
                break
            for j in range(self.pub_width):
                if not self._pub_queue or flat >= cap:
                    break
                origin, tid, verdict, msg, mid = self._pub_queue.popleft()
                po[i, j], pt[i, j], pv[i, j] = origin, tid, verdict
                batch.append((flat, msg, mid))
                flat += 1
        # sustained cap-rate publishing shortens the slot TTL below the
        # delivery tail (see docstring): surface it instead of silently
        # dropping late receipts
        if flat >= cap and self._pub_queue:
            self._saturated_phases = getattr(self, "_saturated_phases", 0) + 1
            if self._saturated_phases == 2:
                _log.warning(
                    "publish admission saturated the per-phase cap (%d = "
                    "msg_slots // 2) for consecutive phases: slots now "
                    "recycle two phases after allocation, and receipts of "
                    "messages still propagating then are silently dropped. "
                    "Raise msg_slots, raise rounds_per_phase, or lower the "
                    "publish rate.", cap,
                )
        else:
            self._saturated_phases = 0
        prev = snapshot(self.state)
        args = (self.state, *self._dev(po, pt, pv))
        if self._dynamic:
            self.state = self._step(*args, *self._dev(self._up_row()),
                                    do_heartbeat=True)
        else:
            self.state = self._step(*args, do_heartbeat=True)
        new = snapshot(self.state)
        if prev.up is not None and new.up is not None:
            self._emit_membership_events(prev.up, new.up)
        # slot mapping replicates allocate_publishes' running cursor over
        # the phase's flattened publish order — recorded BEFORE observe()
        # so the trace session's mid_fn sees the real messages
        for flat_idx, msg, mid in batch:
            slot = (prev.cursor + flat_idx) % self.msg_slots
            self._slot_msg[slot] = msg
            self._seen_mids[mid] = slot
        if self._session is not None:
            self._session.observe(prev, new, po, pt, pv)
        if self.tag_tracer is not None:
            self.tag_tracer.observe(prev, new)
        self._drain_deliveries(prev, new)
        if self.px_connect:
            self._px_connect_pass()
        self._process_announces()

    def _maybe_checkpoint(self, every: int | None, path: str | None) -> None:
        """Auto-snapshot support for run(): save when >= ``every`` rounds
        of simulated time have passed since the last snapshot (phase mode
        quantizes the cadence up to phase boundaries). A non-default
        retention (run(keep_last=/keep_every=)) routes through the
        rolling checkpoint store instead of the single-file overwrite."""
        if every is None:
            return
        tick = int(getattr(self.state, "core", self.state).tick)
        last = getattr(self, "_last_ckpt_tick", None)
        if last is not None and tick - last < every:
            return
        keep_last, keep_every = getattr(self, "_ckpt_retention", (1, 0))
        if keep_last == 1 and keep_every == 0:
            self.save_checkpoint(path)
        else:
            self._checkpoint_store(path, keep_last, keep_every).save(
                self.state, tick=tick)
        self._last_ckpt_tick = tick

    def _checkpoint_store(self, path: str, keep_last: int,
                          keep_every: int):
        """The lazily-built rolling store for retention-mode snapshots
        (one per Network; rebuilt if the retention pair changes)."""
        from .serve.store import CheckpointStore, RetentionPolicy

        policy = RetentionPolicy(keep_last=keep_last, keep_every=keep_every)
        store = getattr(self, "_ckpt_store", None)
        if (store is None or store.root != str(path)
                or store.policy != policy):
            store = CheckpointStore(path, policy)
            self._ckpt_store = store
        return store

    def save_checkpoint(self, path: str) -> str:
        """Snapshot the device state through the npz checkpoint backend,
        atomically (tmp + rename — a host crash mid-write never corrupts
        the previous snapshot). Returns the final path."""
        from . import checkpoint as _ckpt

        if not self.started:
            raise APIError("save_checkpoint before start(): no device state")
        final = path if str(path).endswith(".npz") else str(path) + ".npz"
        tmp = str(final) + ".tmp.npz"
        _ckpt.save(tmp, self.state)
        import os as _os

        _os.replace(tmp, final)
        return final

    def load_checkpoint(self, path: str) -> None:
        """Restore a snapshot taken by ``save_checkpoint`` / the
        ``run(checkpoint_every=...)`` auto-snapshots into THIS network's
        compiled state (the current state is the restore template, so
        the network must be built and started with the same configs and
        topology — mismatches raise with the offending pytree paths).

        ``path`` may also be a retention-mode store DIRECTORY (a run
        with ``keep_last``/``keep_every``): the newest uncorrupted
        manifest entry is restored, falling back past damaged snapshots
        exactly like the supervised loop does.

        Only the device state is restored: the PRNG key and tick come
        with it, so the continued run replays the exact random — and
        chaos-fault — stream of an uninterrupted one. Host-side message
        bodies and trace sessions are not part of the snapshot; restore
        into a fresh Network when those matter."""
        import os as _os

        from . import checkpoint as _ckpt

        if not self.started:
            raise APIError("load_checkpoint before start(): build the "
                           "template state first")
        if _os.path.isdir(path):
            from .serve.store import CheckpointStore

            st, entry = CheckpointStore(path).restore_latest(self.state)
            if st is None:
                raise APIError(
                    f"load_checkpoint({path!r}): the checkpoint store "
                    "holds no loadable snapshot")
            self.state = st
        else:
            self.state = _ckpt.restore(path, self.state)
        self._last_ckpt_tick = int(
            getattr(self.state, "core", self.state).tick
        )

    def _up_row(self) -> np.ndarray:
        """[N] bool notify plane of the next step: up and blacklisted by
        no node. Only nodes whose blacklist holds an entry are asked, so
        a network without blacklists pays one pass over the nodes."""
        up = np.fromiter((nd.up for nd in self.nodes), bool, len(self.nodes))
        holders = [nd.blacklist for nd in self.nodes if _may_hold(nd.blacklist)]
        if holders:
            pids = [nd.identity.peer_id for nd in self.nodes]
            for i, pid in enumerate(pids):
                if up[i] and any(bl.contains(pid) for bl in holders):
                    up[i] = False
        return up

    def _dev(self, *arrays):
        """Host arrays as tensors on the network's device."""
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _emit_membership_events(self, prev_up: np.ndarray, up: np.ndarray) -> None:
        changed = np.nonzero(prev_up != up)[0]
        if changed.size == 0:
            return
        for node in self.nodes:
            for t in node.topics.values():
                for h in t._handlers:
                    for i in changed:
                        other = self.nodes[int(i)]
                        if other is node or t.name not in other.topics:
                            continue
                        h._emit(PEER_JOIN if up[i] else PEER_LEAVE,
                                other.identity.peer_id)

    def _drain_deliveries(self, prev, new) -> None:
        """First receipts this round -> subscription queues (notifySubs,
        pubsub.go:905-916) + remote validator execution for visibility."""
        # range check (not ==): a phase step advances several ticks at once
        recv = (new.first_round >= prev.tick) & (new.first_round < new.tick) \
            & (new.first_edge >= 0) & new.msg_valid[None, :]
        peers, mslots = np.nonzero(recv)
        for p, s in zip(peers.tolist(), mslots.tolist()):
            msg = self._slot_msg.get(s)
            if msg is None:
                continue
            node = self.nodes[p]
            t = node.topics.get(msg.topic)
            if t is None:
                continue
            for sub in list(t._subs):
                if not sub.cancelled:
                    sub._push(msg)

    def _peer_scores(self, node: Node) -> dict[bytes, float]:
        st = self.state
        if not hasattr(st, "scores"):
            return {}
        scores = _host(st.scores[node.idx])
        nbr = self._nh["nbr"][node.idx]
        ok = self._nh["nbr_ok"][node.idx]
        return {
            self.nodes[int(nbr[k])].identity.peer_id: float(scores[k])
            for k in range(len(nbr)) if ok[k]
        }

    def _peer_score_snapshots(self, node: Node) -> "dict[bytes, PeerScoreSnapshot]":
        st = self.state
        if not hasattr(st, "score"):
            return {}
        i = node.idx
        nbr = self._nh["nbr"][i]
        ok = self._nh["nbr_ok"][i]
        my_topics = self._nh["my_topics"][i]
        sc = st.score
        scores = _host(st.scores[i])
        fmd = _host(sc.fmd[i]); mmd = _host(sc.mmd[i])
        imd = _host(sc.imd[i]); mt = _host(sc.mesh_time[i])
        bp = _host(sc.bp[i])
        # the exact P6 input the score used (threshold-gated surplus^2,
        # whitelist-aware — ip_colocation_surplus_sq)
        p6 = _host(st.p6[i]) if hasattr(st, "p6") else np.zeros(len(nbr))
        out: dict[bytes, PeerScoreSnapshot] = {}
        for k in range(len(nbr)):
            if not ok[k]:
                continue
            j = int(nbr[k])
            topics = {}
            for s, t in enumerate(my_topics):
                if t < 0:
                    continue
                topics[self.topic_names[int(t)]] = TopicScoreSnapshot(
                    time_in_mesh=int(mt[s, k]),
                    first_message_deliveries=float(fmd[s, k]),
                    mesh_message_deliveries=float(mmd[s, k]),
                    invalid_message_deliveries=float(imd[s, k]),
                )
            out[self.nodes[j].identity.peer_id] = PeerScoreSnapshot(
                score=float(scores[k]),
                topics=topics,
                behaviour_penalty=float(bp[k]),
                ip_colocation_factor=float(p6[k]),
            )
        return out

    def stop(self) -> None:
        if self._session is not None:
            self._session.close(snapshot(self.state))
            self._session = None


def _take_slots(a: torch.Tensor, idx: torch.Tensor, axis: int, fill) -> torch.Tensor:
    """``a`` with its ``axis`` (1 or 2) re-indexed by ``idx`` [N, X']:
    entry (i, x') takes ``a``'s (i, idx[i, x']), and ``idx`` equal to the
    axis length takes ``fill`` (a fresh slot). A new tensor on ``a``'s
    device, with ``a``'s dtype."""
    pad_shape = list(a.shape)
    pad_shape[axis] = 1
    ap = torch.cat([a, torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)], dim=axis)
    view = [1] * a.dim()
    view[0], view[axis] = idx.shape
    out_shape = list(a.shape)
    out_shape[axis] = idx.shape[1]
    return torch.gather(ap, axis, idx.reshape(view).expand(out_shape))


def _may_hold(bl) -> bool:
    """Whether a blacklist can hold an entry: False only for the two
    host implementations when they are empty."""
    held = getattr(bl, "_set", getattr(bl, "_expiry", None))
    return held is None or len(held) > 0


def default_msg_id(msg: rpc_pb2.Message) -> bytes:
    """DefaultMsgIdFn: from || seqno (pubsub.go:1041-1043); falls back to a
    content hash when unsigned (anonymous mode needs WithMessageIdFn in the
    reference; hashing is the customary choice)."""
    frm = getattr(msg, "from")
    if frm or msg.seqno:
        return frm + msg.seqno
    import hashlib

    return hashlib.sha256(msg.data + msg.topic.encode()).digest()
