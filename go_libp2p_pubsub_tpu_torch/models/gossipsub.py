"""GossipSub v1.0/v1.1 router, vectorized over all N peers (gossipsub.go).

The per-node state machine — mesh maintenance, heartbeat, IHAVE/IWANT lazy
gossip, GRAFT/PRUNE with backoff, scoring, graylisting — runs for every
peer at once as masked tensor ops over the padded neighbor axis; peer
selection is the rank/top-k primitive (ops/select.py).

Round model: one ``step()`` is one network-hop round, with the heartbeat
every ``heartbeat_every`` rounds. Control written to per-edge outboxes in
round r is read by the far end in round r+1 through the reverse-edge
gather (the one-RTT control latency of the reference's wire layer).

The step runs on every net the JAX step takes in the bench configuration.
On a banded dense topology with K <= 16 the whole edge-crossing exchange is
the two kernels of ``ops/fused_round.py``; on any other dense topology, and
on a CSR net, it is the JAX package's XLA-path composites (``control_exchange``,
``iwant_responses``, ``gossip_edge_mask``, the shared ``delivery_round``,
``merge_extra_tx``). A CSR net keeps its per-edge planes flat between steps
(``state.wrap_csr_resident``). Every heartbeat selection is one launch of
the ``select_topk`` kernel on the card (``ops/select.py``).

The outbound-queue cap (``queue_cap``) and the async-validation pipeline
(``validation_delay_rounds``/``validation_delay_topic``) take the
composites on every net, the banded K <= 16 one too, as the JAX package's
``fused_eligible`` routes them: under either option neither
``edge_exchange`` nor ``fused_delivery`` launches, and the shared delivery
round leaves ``delivery_banded`` for its composite. The chaos plane
(``cfg.chaos``) takes the composites too, but its link mask rides the edge
mask, so the shared delivery round keeps ``delivery_banded`` on a banded
net. The attack plane (``adversary``) leaves the fused kernels too, as the
JAX package's ``fused_eligible`` does; its data masks ride the edge mask
and the IWANT responses, so the shared delivery round keeps
``delivery_banded`` there as well. The telemetry panel changes no route:
its row is the step's last operation. The router plane (``cfg.router``:
IDONTWANT, lazy choking, the latency ring) leaves the fused kernels as the
JAX package's ``fused_eligible`` does; its suppression rides the edge mask
and the ring's arrivals the extra-transmission merge, so the shared
delivery round keeps ``delivery_banded`` on a banded net, and the choke
decision is one more ``select_topk`` launch a heartbeat.

Peer exchange (``do_px``) and ``edge_liveness`` keep the kernel route: a
round reads the live edges ``nbr_ok & edge_live`` (``live_step_views``)
for every gate, gather and kernel argument, ``edge_exchange``'s live words
and ``fused_delivery``'s F_LIVE flags included, and the px lane rides the
control words (C = 5 at one topic and W = 2). Without either option the
step reads the build's constants and launches nothing more.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import prng
from ..chaos import adversary as adversary_mod
from ..chaos import faults as chaos_faults
from ..chaos.faults import ChaosConfig
from ..config import (
    GossipSubParams,
    PeerGaterParams,
    PeerScoreParams,
    PeerScoreThresholds,
    ticks_for,
)
from ..ops import bitset, edges
from ..ops import fused_round as fr
from ..ops.fnum import bitcast, flush_f32
from ..ops.select import (
    count_true,
    masked_width_random,
    masked_width_topk,
    median_masked,
    select_random_mask,
    select_topk_mask,
)
from ..routers import (
    RouterConfig,
    choke_decide,
    choke_guard,
    choke_lateness_update,
    choke_suppression,
    dontwant_announcements,
    dontwant_suppression,
    idontwant_sent_count,
    ring_commit,
    ring_init,
    ring_keep,
)
from ..score.engine import (
    ScoreScalars,
    ScoreState,
    TopicParamsArrays,
    add_penalties,
    clear_edges,
    clear_mesh_status,
    compute_scores,
    compute_scores_lifted,
    ip_colocation_surplus_sq,
    on_deliveries,
    on_graft,
    on_prune,
    refresh_scores,
    slot_topic_words,
)
from ..score.gater import GaterState, gater_accept, gater_decay, gater_on_round, source_share
from ..score.params import split_plane
from ..state import (
    Net,
    SimState,
    TopoState,
    allocate_publishes,
    replace,
    tree_map,
    wire_block_words,
    wrap_csr_resident,
)
from ..telemetry import panel as telemetry_panel
from ..trace.events import EV, add_event
from .common import (
    RoundInfo,
    accumulate_round_events,
    delivery_round,
    origin_msg_words,
    pipeline_insert,
    subscribed_msg_words,
)

# ---------------------------------------------------------------------------
# configuration


@dataclasses.dataclass(frozen=True)
class GossipSubConfig:
    """Static configuration: GossipSubParams with durations in ticks, plus
    the v1.1 thresholds and feature switches (the JAX package's fields)."""

    D: int = 6
    Dlo: int = 5
    Dhi: int = 12
    Dscore: int = 4
    Dout: int = 2
    Dlazy: int = 6
    gossip_factor: float = 0.25
    history_length: int = 5
    history_gossip: int = 3
    gossip_retransmission: int = 3
    max_ihave_messages: int = 10
    max_ihave_length: int = 5000
    iwant_followup_ticks: int = 3
    prune_backoff_ticks: int = 60
    graft_flood_ticks: int = 10
    opportunistic_graft_ticks: int = 60
    opportunistic_graft_peers: int = 2
    backoff_clear_ticks: int = 15   # gossipsub.go:1587
    backoff_slack_ticks: int = 2    # gossipsub.go:1596
    direct_connect_ticks: int = 300  # gossipsub.go:1606-1628
    heartbeat_every: int = 1
    score_enabled: bool = False
    flood_publish: bool = False
    do_px: bool = False
    # edge liveness without PX: dormant provisioned edges (the state's
    # ``edge_live``) carry nothing until activated; PX implies it
    edge_liveness: bool = False
    # peer gater and the validation front-end queue (validation.go): 0
    # capacity = unbounded, and the gater is inert without throttle pressure
    gater_enabled: bool = False
    gater_quiet_ticks: int = 60
    validation_capacity: int = 0  # accepted validations per peer per round
    # outbound-queue backpressure: each link's message budget a round, the
    # overflow lost and traced DROP_RPC (pubsub.go:240, comm.go:139-170);
    # 0 = lossless
    queue_cap: int = 0
    # async validation latency in rounds: receipts spend this many rounds
    # between arrival (markSeen) and their verdict (forward, Deliver or
    # Reject, the CDF stamp); 0 = inline. ``validation_delay_topic`` holds
    # per-topic delays in [1, validation_delay_rounds] (validation.go:
    # 123-135, 391-438), None = uniform
    validation_delay_rounds: int = 0
    validation_delay_topic: tuple | None = None
    # WithValidatorTimeout (validation.go:522-529): a verdict later than
    # this many rounds times out and the message is ignored; 0 = none
    validator_timeout_rounds: int = 0
    # fanout: publishing to unjoined topics (gossipsub.go:981-1002,1517-1554)
    fanout_slots: int = 2         # concurrent unjoined publish topics a peer
    fanout_ttl_ticks: int = 60
    count_events: bool = True
    # the coalesced control head and stacked folds; False is the JAX
    # package's per-plane A/B form, to the same bits
    wire_coalesced: bool = True
    edge_layout: str = "dense"
    fused: bool = False
    # the IHAVE flood-protection counters (peerhave, iasked) as int16:
    # exact, since both clear every heartbeat and ``build`` refuses a cap
    # or a cadence outside int16
    narrow_counters: bool = False
    # the chaos plane (chaos/faults.py): i.i.d. or Gilbert–Elliott link
    # flaps drawn from the state's PRNG stream, and with ``scheduled`` a
    # per-round ``link_deny`` argument; None or a disabled config leaves
    # the plane out (the same leaves, ops and launches as without it)
    chaos: ChaosConfig | None = None
    # the exact-trace duplicate plane: each round's arrivals beyond the
    # first per (peer, msg), per edge, kept in the state's ``dup_trans``
    # (trace.go:186-194)
    trace_exact: bool = False
    # the router plane (routers/): v1.2 IDONTWANT, episub lazy choking and
    # the per-edge latency ring; None is v1.1, the step without the plane
    # (the same leaves, ops and launches)
    router: RouterConfig | None = None
    gossip_threshold: float = 0.0
    publish_threshold: float = 0.0
    graylist_threshold: float = 0.0
    accept_px_threshold: float = 0.0
    opportunistic_graft_threshold: float = 0.0

    @classmethod
    def build(cls, params: GossipSubParams | None = None,
              thresholds: PeerScoreThresholds | None = None,
              score_enabled: bool = False,
              heartbeat_every: int = 1,
              gater_params: PeerGaterParams | None = None,
              validation_capacity: int = 0,
              validation_delay_rounds: int = 0,
              validation_delay_topic: tuple | None = None,
              validator_timeout_rounds: int = 0,
              queue_cap: int = 0,
              edge_layout: str = "dense",
              fused: bool = False,
              wire_coalesced: bool = True,
              trace_exact: bool = False,
              narrow_counters: bool = False,
              chaos: ChaosConfig | None = None,
              router: RouterConfig | None = None) -> "GossipSubConfig":
        """``edge_layout`` and ``fused`` must match the Net's
        (``Net.build(..., edge_layout=..., fused=...)``); the step refuses
        a mismatch. The selections take one form under either flag; its
        ranks equal both of the JAX package's forms. Per-topic delays
        without a depth set the depth to their largest. ``narrow_counters``
        is refused where an int16 counter could not hold its bound; an
        invalid ``chaos`` config raises ``ChaosConfigError``, an invalid
        ``router`` one ``RouterConfigError``."""
        p = params or GossipSubParams()
        p.validate()
        if router is not None:
            router.validate()
        if edge_layout not in ("dense", "csr"):
            raise ValueError(
                f"edge_layout must be 'dense' or 'csr', got {edge_layout!r}")
        i16_cap = int(np.iinfo(np.int16).max) + 1
        if narrow_counters and p.max_ihave_length >= i16_cap:
            # iasked saturates at the cap it gates on
            raise ValueError(
                f"narrow_counters needs max_ihave_length < {i16_cap} "
                f"(got {p.max_ihave_length}) — the int16 iasked counter "
                "must be able to represent its own cap")
        if narrow_counters and heartbeat_every >= i16_cap:
            # peerhave counts one IHAVE batch a round until the heartbeat
            # clears it
            raise ValueError(
                f"narrow_counters needs heartbeat_every < {i16_cap} "
                f"(got {heartbeat_every}) — the int16 peerhave counter "
                "grows once per round until the heartbeat clear")
        if validator_timeout_rounds < 0:
            raise ValueError(
                f"validator_timeout_rounds must be >= 0, got {validator_timeout_rounds}")
        if validation_delay_topic is not None:
            validation_delay_topic = tuple(int(d) for d in validation_delay_topic)
            if validation_delay_rounds <= 0:
                validation_delay_rounds = max(validation_delay_topic)
            if not all(1 <= d <= validation_delay_rounds for d in validation_delay_topic):
                raise ValueError(
                    "validation_delay_topic entries must lie in "
                    f"[1, {validation_delay_rounds}] (the pipeline depth); "
                    f"got {validation_delay_topic}")
        hb = p.heartbeat_interval
        kw = dict(
            D=p.D, Dlo=p.Dlo, Dhi=p.Dhi, Dscore=p.Dscore, Dout=p.Dout,
            Dlazy=p.Dlazy, gossip_factor=p.gossip_factor,
            history_length=p.history_length, history_gossip=p.history_gossip,
            gossip_retransmission=p.gossip_retransmission,
            max_ihave_messages=p.max_ihave_messages,
            max_ihave_length=p.max_ihave_length,
            iwant_followup_ticks=ticks_for(p.iwant_followup_time, hb),
            prune_backoff_ticks=ticks_for(p.prune_backoff, hb),
            graft_flood_ticks=ticks_for(p.graft_flood_threshold, hb),
            opportunistic_graft_ticks=p.opportunistic_graft_ticks,
            opportunistic_graft_peers=p.opportunistic_graft_peers,
            direct_connect_ticks=p.direct_connect_ticks,
            heartbeat_every=heartbeat_every,
            score_enabled=score_enabled,
            flood_publish=p.flood_publish,
            do_px=p.do_px,
            gater_enabled=gater_params is not None,
            gater_quiet_ticks=ticks_for(gater_params.quiet, hb) if gater_params else 60,
            validation_capacity=validation_capacity,
            validation_delay_rounds=validation_delay_rounds,
            validation_delay_topic=validation_delay_topic,
            validator_timeout_rounds=validator_timeout_rounds,
            queue_cap=queue_cap,
            fanout_ttl_ticks=ticks_for(p.fanout_ttl, hb),
            edge_layout=edge_layout,
            fused=bool(fused),
            wire_coalesced=bool(wire_coalesced),
            trace_exact=bool(trace_exact),
            narrow_counters=bool(narrow_counters),
            chaos=chaos,
            router=router,
        )
        if chaos is not None:
            chaos.validate()
        if thresholds is not None:
            thresholds.validate()
            kw.update(
                gossip_threshold=thresholds.gossip_threshold,
                publish_threshold=thresholds.publish_threshold,
                graylist_threshold=thresholds.graylist_threshold,
                accept_px_threshold=thresholds.accept_px_threshold,
                opportunistic_graft_threshold=thresholds.opportunistic_graft_threshold,
            )
        return cls(**kw)

    def validation_timed_out(self, topic: int) -> bool:
        """True when this topic's verdict can never land inside the
        validator timeout (its effective delay exceeds
        ``validator_timeout_rounds``): its messages resolve to
        ValidationIgnore, the expired-context outcome (validation.go:
        522-529)."""
        if self.validator_timeout_rounds <= 0:
            return False
        if self.validation_delay_topic is not None:
            delay = self.validation_delay_topic[topic]
        else:
            delay = self.validation_delay_rounds
        return delay > self.validator_timeout_rounds


# ---------------------------------------------------------------------------
# state


@dataclasses.dataclass
class GossipSubState:
    core: SimState
    mesh: torch.Tensor              # [N,S,K] bool (gossipsub.go:441)
    backoff_expire: torch.Tensor    # [N,S,K] i32
    backoff_present: torch.Tensor   # [N,S,K] bool
    mcache: torch.Tensor            # [N,H,W] words; window 0 = current
    ihave_out: torch.Tensor         # [N,K,W] words, read next round
    iwant_out: torch.Tensor         # [N,K,W] words
    graft_out: torch.Tensor         # [N,S,K] bool
    prune_out: torch.Tensor         # [N,S,K] bool
    peerhave: torch.Tensor          # [N,K] i32, i16 narrowed (cleared each heartbeat)
    iasked: torch.Tensor            # [N,K] i32, i16 narrowed
    served_lo: torch.Tensor         # [N,K,W] 2-bit retransmission counters
    served_hi: torch.Tensor         # [N,K,W]
    promise_mid: torch.Tensor       # [N,K] i32 (-1 none)
    promise_expire: torch.Tensor    # [N,K] i32
    score: ScoreState
    scores: torch.Tensor            # [N,K] f32 memoized per heartbeat
    p6: torch.Tensor                # [N,K] f32 colocation surplus^2
    app_score: torch.Tensor         # [N] f32 (P5)
    gater: GaterState
    fanout_topic: torch.Tensor      # [N,F] i32, -1 free
    fanout_peers: torch.Tensor      # [N,F,K] bool
    fanout_lastpub: torch.Tensor    # [N,F] i32
    up: torch.Tensor                # [N] bool
    blacklist: torch.Tensor         # [N] bool
    # the PX connection plane: which provisioned edges are live (dormant
    # ones start False; kept symmetric over the edge involution), and the
    # PX flag riding this round's PRUNEs
    edge_live: torch.Tensor         # [N,K] bool
    prune_px_out: torch.Tensor      # [N,S,K] bool
    congested_in: torch.Tensor      # [N,K] bool
    # this round's arrivals beyond the first per (peer, msg), per edge
    # (cfg.trace_exact only, else None)
    dup_trans: torch.Tensor | None = None  # [N,K,W] words
    # the router plane (cfg.router, else None): the IDONTWANT ids a peer
    # announced (a subset of its seen-cache), the lazy-demoted mesh links
    # (within the mesh, at least Dlo unchoked a slot), the lateness EMA
    # and the delayed-commit ring (CSR-resident [E, L, W] on a CSR net)
    dontwant: torch.Tensor | None = None   # [N,W] words
    choked: torch.Tensor | None = None     # [N,S,K] bool
    choke_ema: torch.Tensor | None = None  # [N,K] f32
    inflight: torch.Tensor | None = None   # [N,K,L,W] words

    @classmethod
    def init(cls, net: Net, msg_slots: int, cfg: GossipSubConfig,
             score_params: PeerScoreParams | None = None,
             seed: int = 0, app_score: np.ndarray | None = None,
             dormant: np.ndarray | None = None, wire_block: bool = False,
             telemetry=None, dynamic_topo: bool = False) -> "GossipSubState":
        """The parameters follow the JAX package's order. ``app_score`` is
        the [N] P5 application-specific score plane (zeros when None);
        ``dormant`` ([N, K] bool, ``graph.dormant_edges``) marks the
        provisioned edges that start disconnected; ``wire_block`` adds the
        per-message transmit block (``MsgTable.wire_block``, behind
        ``api.Network(max_message_size=)``), which every route of every
        engine honours; ``dynamic_topo`` installs the mutable overlay
        (``core.topo``, seeded from the net) that a ``dynamic_topo`` step
        writes. A config whose chaos plane needs state (a GE generator) gets
        the link chain (``core.chaos``); ``telemetry`` (a
        ``telemetry.TelemetryConfig``) the panel a recording step writes
        (``core.telem``); a router config its plane's leaves (``dontwant``
        with IDONTWANT, ``choked`` and ``choke_ema`` with choking, the ring
        ``inflight`` with a latency depth)."""
        dev = net.device
        n, k = net.nbr.shape
        s = net.n_slots
        w = bitset.n_words(msg_slots)
        h = cfg.history_length
        f = cfg.fanout_slots
        if score_params is not None and cfg.score_enabled:
            p6 = ip_colocation_surplus_sq(
                net, score_params.ip_colocation_factor_threshold,
                score_params.ip_colocation_factor_whitelist)
        else:
            p6 = torch.zeros((n, k), dtype=torch.float32, device=dev)
        i32, b = torch.int32, torch.bool
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        rt = cfg.router
        # against a CSR net the per-edge planes are CSR-resident: fe_words
        # and served_* flat [E, W], peerhave/iasked [E] (the step densifies
        # them for its body, state.wrap_csr_resident)
        e = net.n_edges
        ph_shape = (n, k) if e is None else (e,)
        sv_shape = (n, k, w) if e is None else (e, w)
        ctr = torch.int16 if cfg.narrow_counters else i32
        edge_live = net.nbr_ok.clone()
        if dormant is not None:
            edge_live &= ~torch.as_tensor(np.asarray(dormant, bool), device=dev)
        return cls(
            core=SimState.init(n, msg_slots, seed, k=k, device=dev, n_edges=e,
                               val_delay=cfg.validation_delay_rounds,
                               topo=TopoState.from_net(net) if dynamic_topo else None,
                               wire_block=wire_block,
                               chaos_ge=cfg.chaos is not None and cfg.chaos.needs_state,
                               telemetry=telemetry),
            mesh=z((n, s, k), b),
            backoff_expire=z((n, s, k), i32),
            backoff_present=z((n, s, k), b),
            mcache=z((n, h, w), i32),
            ihave_out=z((n, k, w), i32),
            iwant_out=z((n, k, w), i32),
            graft_out=z((n, s, k), b),
            prune_out=z((n, s, k), b),
            peerhave=z(ph_shape, ctr),
            iasked=z(ph_shape, ctr),
            served_lo=z(sv_shape, i32),
            served_hi=z(sv_shape, i32),
            promise_mid=torch.full((n, k), -1, dtype=i32, device=dev),
            promise_expire=z((n, k), i32),
            score=ScoreState.empty(n, s, k, dev),
            scores=z((n, k), torch.float32),
            p6=p6,
            app_score=(z((n,), torch.float32) if app_score is None else torch.as_tensor(
                np.asarray(app_score, np.float32), device=dev)),
            gater=GaterState.empty(n, k, dev),
            fanout_topic=torch.full((n, f), -1, dtype=i32, device=dev),
            fanout_peers=z((n, f, k), b),
            fanout_lastpub=z((n, f), i32),
            up=torch.ones((n,), dtype=b, device=dev),
            blacklist=z((n,), b),
            edge_live=edge_live,
            prune_px_out=z((n, s, k), b),
            congested_in=z((n, k), b),
            dup_trans=z((n, k, w), i32) if cfg.trace_exact else None,
            dontwant=z((n, w), i32) if rt is not None and rt.idontwant else None,
            choked=z((n, s, k), b) if rt is not None and rt.choke else None,
            choke_ema=(z((n, k), torch.float32)
                       if rt is not None and rt.choke else None),
            inflight=(ring_init(sv_shape, rt.latency_rounds, dev)
                      if rt is not None and rt.latency_rounds > 0 else None),
        )


def joined_msg_words(net: Net, msgs) -> torch.Tensor:
    """[N, W]: messages in topics peer n has joined (mesh exists <=>
    subscribed in the sim)."""
    return subscribed_msg_words(net, msgs)


# ---------------------------------------------------------------------------
# control-plane handlers (per round)


def handle_graft_prune(cfg: GossipSubConfig, net: Net, st: GossipSubState,
                       tp: dict, acc_ok, graft_in_raw, prune_in_raw, px_in_raw=None,
                       thr=None, msh=None):
    """GRAFT/PRUNE received this round (handleGraft gossipsub.go:718-809,
    handlePrune :811-843); ``net`` is the round's live view. Returns
    (state, rejected, px_resp, px_ok, n_graft, n_prune): ``rejected``
    becomes next round's PRUNE outbox and ``px_resp`` its PX flags;
    ``px_ok`` [N,K] marks the edges whose PRUNE carried PX from a pruner
    scored at or above AcceptPXThreshold (None without PX). ``thr`` is
    the thresholds' source (``cfg``, or a lifted build's score plane) and
    ``msh`` the mesh degrees' (``cfg``, or a MeshParams plane)."""
    thr = cfg if thr is None else thr
    msh = cfg if msh is None else msh
    tick = st.core.tick
    graft_in = graft_in_raw & acc_ok[:, None, :]
    prune_in = prune_in_raw & acc_ok[:, None, :]

    # PX ingest (handlePrune gossipsub.go:834-841)
    px_ok = None
    if cfg.do_px:
        px_ok = ((px_in_raw & prune_in).any(1)
                 & (st.scores >= thr.accept_px_threshold))

    pruned = prune_in & st.mesh
    score = on_prune(st.score, pruned, tp) if cfg.score_enabled else st.score
    mesh = st.mesh & ~prune_in
    backoff_expire = torch.where(
        prune_in, torch.maximum(st.backoff_expire, tick + cfg.prune_backoff_ticks),
        st.backoff_expire)
    backoff_present = st.backoff_present | prune_in

    want = (graft_in & ~mesh & net.nbr_ok[:, None, :]
            & (net.protocol >= 1)[:, None, None])
    rej_direct = want & net.direct[:, None, :]
    backoff_active = backoff_present & (tick < backoff_expire)
    rej_backoff = want & backoff_active
    flood_cutoff = backoff_expire + (cfg.graft_flood_ticks - cfg.prune_backoff_ticks)
    flood = rej_backoff & (tick < flood_cutoff)
    penalty_counts = (rej_backoff.to(torch.float32)
                      + flood.to(torch.float32)).sum(1)
    if cfg.score_enabled:
        rej_score = want & (st.scores[:, None, :] < 0)
    else:
        rej_score = torch.zeros_like(want)
    mesh_deg = count_true(mesh)
    rej_full = want & (mesh_deg[:, :, None] >= msh.Dhi) & ~net.outbound[:, None, :]

    rejected = rej_direct | rej_backoff | rej_score | rej_full
    accepted = want & ~rejected
    mesh = mesh | accepted
    if cfg.score_enabled:
        score = on_graft(score, accepted, tick)
        score = add_penalties(score, penalty_counts)

    re_back = rej_backoff | rej_score | rej_full
    backoff_expire = torch.where(
        re_back, torch.maximum(backoff_expire, tick + cfg.prune_backoff_ticks),
        backoff_expire)
    backoff_present = backoff_present | re_back
    st = replace(st, mesh=mesh, backoff_expire=backoff_expire,
                 backoff_present=backoff_present, score=score)
    # graft-rejection PRUNEs carry PX unless the score rejected the graft
    # (handleGraft's makePrune, gossipsub.go:796-806)
    px_resp = rejected & ~rej_score if cfg.do_px else torch.zeros_like(rejected)
    if cfg.count_events:
        n_graft = accepted.sum(dtype=torch.int32)
        n_prune = pruned.sum(dtype=torch.int32)
    else:
        n_graft = n_prune = 0
    return st, rejected, px_resp, px_ok, n_graft, n_prune


def handle_ihave(cfg: GossipSubConfig, net: Net, st: GossipSubState,
                 joined_words, acc_ok, ihave_in_raw, thr=None) -> GossipSubState:
    """IHAVE received this round -> IWANT requests + a promise
    (handleIHave gossipsub.go:615-677); ``thr`` the thresholds' source."""
    thr = cfg if thr is None else thr
    m = st.core.msgs.capacity
    tick = st.core.tick
    ihave_in = torch.where(acc_ok[:, :, None], ihave_in_raw, 0)
    got = bitset.popcount(ihave_in, axis=-1) > 0
    peerhave = st.peerhave + got.to(st.peerhave.dtype)

    ok = got
    if cfg.score_enabled:
        ok = ok & (st.scores >= thr.gossip_threshold)
    ok = ok & (peerhave <= cfg.max_ihave_messages)
    ok = ok & (st.iasked < cfg.max_ihave_length)

    wants = ihave_in & ~st.core.dlv.have[:, None, :] & joined_words[:, None, :]
    wants = torch.where(ok[:, :, None], wants, 0)
    # the MaxIHaveLength ask budget can only bind if one heartbeat's asks
    # could exceed it — a static decision, as in the JAX package
    if m * (cfg.heartbeat_every + 1) > cfg.max_ihave_length:
        budget = (cfg.max_ihave_length - st.iasked).clamp(min=0).to(torch.int32)
        asks = bitset.prefix_cap_bits(wants, budget, m)
    else:
        asks = wants
    n_asked = bitset.popcount(asks, axis=-1)
    iasked = st.iasked + n_asked.to(st.iasked.dtype)

    first_ask, _ = bitset.lowest_bit(asks)
    adopt = (n_asked > 0) & (st.promise_mid < 0)
    return replace(
        st,
        peerhave=peerhave,
        iasked=iasked,
        iwant_out=asks,
        promise_mid=torch.where(adopt, first_ask, st.promise_mid),
        promise_expire=torch.where(adopt, tick + cfg.iwant_followup_ticks,
                                   st.promise_expire),
    )


def iwant_responses(cfg: GossipSubConfig, net: Net, st: GossipSubState,
                    nbr_score_of_me, window_g: torch.Tensor | None = None, thr=None):
    """The IWANT-response carry for this round's delivery and the
    retransmission counter update (handleIWant gossipsub.go:679-716):
    ``st.iwant_out`` holds what I asked each neighbor last round, and the
    neighbor serves from its whole mcache window unless the (edge, msg)
    count reached the cap. ``window_g`` is the neighbours' gathered window
    when the caller's wire exchange carried it (zero on dead edges).
    ``thr`` is the thresholds' source. Returns (state, resp [N,K,W])."""
    thr = cfg if thr is None else thr
    if window_g is None:
        sender_window = bitset.word_or_reduce(st.mcache, dim=1)   # [N, W]
        window_g = torch.where(net.nbr_ok[:, :, None], net.peer_gather(sender_window), 0)
    capped = fr.served_capped_mask(cfg.gossip_retransmission, st.served_lo,
                                   st.served_hi)
    resp = st.iwant_out & window_g & ~capped
    if cfg.score_enabled:
        # the responder ignores requesters below the gossip threshold
        # (gossipsub.go:681-685): the score the neighbor holds of me
        resp = torch.where((nbr_score_of_me >= thr.gossip_threshold)[:, :, None],
                           resp, 0)
    # 2-bit saturating increment on served slots
    inc = resp & ~(st.served_hi & st.served_lo)
    lo = st.served_lo ^ inc
    hi = st.served_hi | (st.served_lo & inc)
    return replace(st, served_lo=lo, served_hi=hi), resp


def sender_carry_words(mesh: torch.Tensor, slotw: torch.Tensor) -> torch.Tensor:
    """[N,K,W] sender-side: words each peer would push on edge k — the OR
    over its topic slots of the slot's messages where k is in that slot's
    mesh."""
    contrib = torch.where(mesh[:, :, :, None], slotw[:, :, None, :], 0)
    return bitset.word_or_reduce(contrib, dim=1)


def fanout_topic_words(fanout_topic: torch.Tensor, msg_topic: torch.Tensor) -> torch.Tensor:
    """[N,F,W] packed: messages in the topic of fanout slot f."""
    bits = ((msg_topic[None, None, :] == fanout_topic[:, :, None])
            & (msg_topic >= 0)[None, None, :])
    return bitset.pack(bits)


def fanout_carry_words(fanout_peers: torch.Tensor, fanout_topic: torch.Tensor,
                       msg_topic: torch.Tensor) -> torch.Tensor:
    """[N,K,W]: words each peer pushes on edge k for its fanout topics
    (gossipsub.go:1000-1002 — fanout peers receive published messages of
    unjoined topics)."""
    ftw = fanout_topic_words(fanout_topic, msg_topic)
    contrib = torch.where(fanout_peers[:, :, :, None], ftw[:, :, None, :], 0)
    return bitset.word_or_reduce(contrib, dim=1)


def _first_index(hit: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where none is (the
    JAX package's ``argmax`` of a bool row), without relying on a backend's
    tie order."""
    f = hit.shape[-1]
    idx = torch.where(hit, torch.arange(f, dtype=torch.int32, device=hit.device), f)
    return torch.where(hit.any(-1), idx.amin(-1), 0)


def fanout_candidates(cfg: GossipSubConfig, net: Net, scores, pub_origin, pub_topic,
                      nbr_sub_words, thr=None) -> torch.Tensor:
    """[..., P, K] bool: the peers a publish may take as fanout peers —
    connected, mesh-capable, subscribed to the topic, not direct, scored at
    or above publishThreshold (``pub_*`` [..., P]; ``thr`` the thresholds'
    source)."""
    thr = cfg if thr is None else thr
    k_dim = net.max_degree
    o = pub_origin.clamp(min=0).long()
    t32 = pub_topic.clamp(min=0).to(torch.int32)
    nbr_subbed = bitset.bit_get(nbr_sub_words[o], t32[..., None].expand(o.shape + (k_dim,)))
    cand = (nbr_subbed & net.nbr_ok[o]
            & (net.protocol[net.nbr[o].clamp(min=0).long()] >= 1) & ~net.direct[o])
    if cfg.score_enabled:
        cand = cand & (scores[o] >= thr.publish_threshold)
    return cand


def fanout_selections(cfg: GossipSubConfig, net: Net, scores, pub_origin, pub_topic,
                      nbr_sub_words, keys, thr=None, msh=None) -> torch.Tensor:
    """[R, P, K]: the D random fanout peers (gossipsub.go:983-998) of R
    rounds' publishes ``pub_*`` [R, P] at once, row i drawn from
    ``keys[i]`` (``jax.random`` threefry: ``masked_width_random`` with that
    key). The candidates read only static views and the scores, which a
    phase holds fixed, so a phase draws its sub-rounds' at its head.
    ``thr`` and ``msh`` are the thresholds' and the degrees' sources."""
    msh = cfg if msh is None else msh
    cand = fanout_candidates(cfg, net, scores, pub_origin, pub_topic, nbr_sub_words, thr)
    noise = prng.uniform_rows(keys, cand.shape[1:])
    return masked_width_topk(noise, cand, msh.D, net.max_degree)


def update_fanout_on_publish(cfg: GossipSubConfig, net: Net, st: "GossipSubState",
                             pub_origin, pub_topic, sel, tick):
    """Publishing to an unjoined topic creates or refreshes a fanout slot
    with the publish's D random eligible peers (``sel`` [P,K], from
    ``fanout_selections``) and stamps its last publish at ``tick``."""
    p_dim = pub_origin.shape[0]
    f_dim = cfg.fanout_slots
    n_peers = net.n_peers
    o = pub_origin.clamp(min=0).long()
    t32 = pub_topic.clamp(min=0).to(torch.int32)
    t = t32.long()
    is_pub = pub_origin >= 0
    joined = net.subscribed[o, t]
    # floodsub-only origins flood instead of tracking fanout
    need = is_pub & ~joined & (net.protocol[o] >= 1)

    # the slot: an existing topic match, else the oldest slot; same-round
    # fresh publishes by one origin land on different slots (each offset by
    # its rank among that origin's earlier fresh entries)
    ftop_o = st.fanout_topic[o]                                     # [P,F]
    match = ftop_o == t32[:, None]
    has_match = (match & need[:, None]).any(1)
    match_slot = _first_index(match)
    age = st.fanout_lastpub[o] + torch.where(ftop_o >= 0, 0, -(2**30))
    oldest_slot = _first_index(age == age.amin(-1, keepdim=True))
    fresh = need & ~has_match
    idx_p = torch.arange(p_dim, device=o.device)
    same_origin_before = (fresh[None, :] & fresh[:, None] & (o[None, :] == o[:, None])
                          & (idx_p[None, :] < idx_p[:, None]))
    fresh_rank = same_origin_before.sum(1, dtype=torch.int32)
    slot = torch.where(has_match, match_slot, (oldest_slot + fresh_rank) % f_dim)

    # a matched slot whose peer set emptied is repopulated like a fresh one
    # (gossipsub.go:983-989)
    held = torch.gather(st.fanout_peers[o], 1, slot.long()[:, None, None].expand(
        -1, 1, net.max_degree))[:, 0, :].any(-1)
    fresh = fresh | (has_match & ~held)

    # commit: fresh slots take the selection, matched ones keep theirs; a
    # fold of P masked selects over the [N, F] planes, ascending, so the
    # last of duplicate (origin, slot) pairs wins
    rows = torch.arange(n_peers, dtype=torch.int32, device=o.device)
    fslots = torch.arange(f_dim, dtype=torch.int32, device=o.device)
    fanout_topic, fanout_lastpub = st.fanout_topic, st.fanout_lastpub
    fanout_peers = st.fanout_peers
    for j in range(p_dim):
        row_j = torch.where(need[j], pub_origin[j], n_peers)
        mask = (rows == row_j)[:, None] & (fslots == slot[j])[None, :]      # [N,F]
        fanout_topic = torch.where(mask, t32[j], fanout_topic)
        fanout_lastpub = torch.where(mask, tick, fanout_lastpub)
        fanout_peers = torch.where((mask & fresh[j])[:, :, None], sel[j][None, None, :],
                                   fanout_peers)
    return replace(st, fanout_topic=fanout_topic, fanout_lastpub=fanout_lastpub,
                   fanout_peers=fanout_peers)


def gossip_edge_mask(cfg: GossipSubConfig, net: Net, st: GossipSubState,
                     joined_words, acc_msg, slotw, msgs, flood_edges,
                     nbr_score_of_me, thr=None) -> torch.Tensor:
    """[N,K,W] edge-carry mask: mesh and fanout push (gossipsub.go:981-1002),
    floodsub-peer edges (gossipsub.go:973-978) and v1.1 flood-publish of
    origin-sent messages (gossipsub.go:957-963), gated by the receiver's
    graylist, gater and joined topics. Sender-side packed outbox, one word
    gather. ``thr`` is the thresholds' source."""
    thr = cfg if thr is None else thr
    carry_out = sender_carry_words(st.mesh, slotw)
    if cfg.fanout_slots > 0:
        carry_out = carry_out | fanout_carry_words(st.fanout_peers, st.fanout_topic,
                                                   msgs.topic)
    mask = torch.where(net.nbr_ok[:, :, None], net.edge_gather(carry_out), 0)
    mask = mask | torch.where(flood_edges[:, :, None], bitset.ALL, 0).to(torch.int32)
    if cfg.flood_publish:
        origin_is_sender = msgs.origin[None, :] == net.nbr[..., None]   # [N,K,M]
        flood_ok = ((nbr_score_of_me >= thr.publish_threshold)
                    if cfg.score_enabled else net.nbr_ok)
        mask = mask | (bitset.pack(origin_is_sender)
                       & torch.where(flood_ok[:, :, None], bitset.ALL, 0).to(torch.int32))
    mask = torch.where(acc_msg[:, :, None], mask, 0)
    return mask & joined_words[:, None, :]


def merge_extra_tx(net: Net, msgs, dlv, info: RoundInfo, extra: torch.Tensor,
                   tick, count_events: bool = True, queue_cap: int = 0,
                   val_delay_topic: tuple | None = None):
    """Fold IWANT-response transmissions (outside the senders' forward
    sets) into the round's delivery results: dedup against the seen-cache,
    first arrivals, forward set and the round's counters. With
    ``queue_cap`` the responses share the link's budget with the push
    already in ``info.trans``, the overflow dropped and counted (comm.go:
    139-170); with the validation pipeline the fresh receipts enter it at
    their entry stage and their verdict lands at its exit."""
    m = msgs.capacity
    extra = extra & ~origin_msg_words(net, msgs)[:, None, :]
    block_w = wire_block_words(msgs)
    if block_w is not None:
        # IWANT responses for oversized messages die at the wire too, after
        # the retransmission counter ticked (mcache.GetForPeer counts the
        # attempt before sendRPC drops it, mcache.go:66-80 ->
        # gossipsub.go:1126-1140), which iwant_responses already did
        extra = extra & ~block_w[None, None, :]
    if queue_cap > 0:
        budget = (queue_cap - bitset.popcount(info.trans)).clamp(min=0)
        want = extra
        extra = bitset.keep_lowest_bits(want, queue_cap, m, rows=budget)
        info = replace(info, n_drop=info.n_drop + bitset.popcount(want & ~extra).sum(
            dtype=torch.int32))
    new_words = bitset.word_or_reduce(extra, 1) & ~dlv.have
    fa_words = bitset.first_set_per_bit(extra, 1) & new_words[:, None, :]
    valid_words = bitset.pack(msgs.valid)
    dlv = replace(
        dlv,
        have=dlv.have | new_words,
        fe_words=(dlv.fe_words & ~new_words[:, None, :]) | fa_words,
    )
    pipelined = dlv.pending is not None
    if pipelined:
        dlv = replace(dlv, pending=pipeline_insert(dlv.pending, new_words, msgs.topic,
                                                   val_delay_topic))
    else:
        dlv = replace(
            dlv,
            fwd=dlv.fwd | (new_words & valid_words[None, :]),
            first_round=torch.where(bitset.unpack(new_words, m), tick, dlv.first_round),
        )
    info = replace(info, trans=info.trans | extra,
                   recv_new_words=info.recv_new_words | new_words)
    if not pipelined:
        info = replace(info, new_words=info.new_words | new_words)
    if count_events:
        n_extra = bitset.popcount(extra).sum(dtype=torch.int32)
        n_new = bitset.popcount(new_words).sum(dtype=torch.int32)
        info = replace(info, n_duplicate=info.n_duplicate + (n_extra - n_new),
                       n_rpc=info.n_rpc + n_extra)
        if not pipelined:
            n_deliver = bitset.popcount(new_words & valid_words[None, :]).sum(
                dtype=torch.int32)
            info = replace(info, n_deliver=info.n_deliver + n_deliver,
                           n_reject=info.n_reject + (n_new - n_deliver))
    return dlv, info


# ---------------------------------------------------------------------------
# the heartbeat (gossipsub.go:1303-1564)


def _gossip_target(n_cand: torch.Tensor, msh) -> torch.Tensor:
    """max(Dlazy, int(gossip_factor * candidates)) (gossipsub.go:1697-1704).
    A static factor is its float32 value as a host scalar (no copy to the
    card): the float32 product of two float32 values is the same rounded in
    any wider type; a MeshParams plane's is a float32 0-d tensor."""
    gf = msh.gossip_factor
    if not isinstance(gf, torch.Tensor):
        gf = float(np.float32(gf))
    return torch.clamp((n_cand.to(torch.float32) * gf).to(torch.int32), min=msh.Dlazy)


def heartbeat(cfg: GossipSubConfig, net: Net, st: GossipSubState, tp: dict,
              sc: ScoreScalars, nbr_sub, gater_params: PeerGaterParams | None = None,
              nbr_sub_words: torch.Tensor | None = None,
              mesh_capable: torch.Tensor | None = None,
              gossip_suppress: torch.Tensor | None = None,
              present_ok: torch.Tensor | None = None, thr=None, msh=None,
              adversary=None) -> GossipSubState:
    """One heartbeat for every peer. The JAX package gates the maintenance
    sub-passes with ``lax.cond`` on "any row needs it"; both branches give
    identical results there, so this runs them unconditionally (no host
    sync). The opportunistic-graft cadence is a real gate and stays one, as
    a ``torch.where``. ``nbr_sub_words`` [N,K,Wt] (the neighbours'
    subscriptions as topic bits) turns on fanout maintenance and gossip,
    with ``mesh_capable`` [N,K] (the far end speaks a mesh protocol; a
    static view the step builds once). ``gossip_suppress`` [N,K] marks
    congested outbound links whose IHAVE batch is dropped this heartbeat
    (the queue cap's backpressure; gossipsub.go:1757-1764). ``net`` is
    the round's live view; ``present_ok`` [N,K] the provisioned edges the
    direct-peer redial may wake (default ``net.nbr_ok``). Under a lifted
    plane ``tp`` and ``sc`` are the plane's gathered rows and the flushed
    plane itself, ``thr`` the plane too and ``msh`` a MeshParams plane
    (default ``cfg`` for both): every threshold and degree is then a 0-d
    tensor on the device. ``adversary`` (a ``chaos.adversary.
    AdversaryConsts``, None without the attack plane) runs the heartbeat's
    attacker behaviours: self-promotion pins the sybils' held scores of
    fellow sybils, graft spam GRAFTs every eligible edge ignoring backoff
    (and keeps no backoff of its own), lie-in-IHAVE advertises every live
    message on every edge."""
    thr = cfg if thr is None else thr
    msh = cfg if msh is None else msh
    tick = st.core.tick
    n, s_dim, k_dim = st.mesh.shape
    key = prng.fold_in(st.core.key, tick)
    k1, k2, k3, k4, k5, k6 = prng.split(key, 6)
    events = st.core.events

    # applyIwantPenalties: broken promises -> P7 (gossipsub.go:1578-1583)
    promised_have = bitset.bit_get(st.core.dlv.have[:, None, :], st.promise_mid)
    live = st.promise_mid >= 0
    fulfilled = live & promised_have
    broken = live & ~promised_have & (tick > st.promise_expire)
    score = st.score
    if cfg.score_enabled:
        score = add_penalties(score, broken.to(torch.float32))
    promise_mid = torch.where(fulfilled | broken, -1, st.promise_mid)

    # clearIHaveCounters (gossipsub.go:1566-1576)
    peerhave = torch.zeros_like(st.peerhave)
    iasked = torch.zeros_like(st.iasked)

    # clearBackoff every 15 ticks with slack (gossipsub.go:1585-1604)
    clear_now = (tick % cfg.backoff_clear_ticks) == 0
    expired = (st.backoff_expire + cfg.backoff_slack_ticks) < tick
    backoff_present = torch.where(clear_now, st.backoff_present & ~expired,
                                  st.backoff_present)
    # graft spam: an attacker keeps no backoff bookkeeping (the reference's
    # attacker is a raw-wire fake), and the clear lands before the
    # candidate filter below, so a spammer pruned last round re-grafts at
    # once
    if adversary is not None and adversary.has("graft_spam"):
        spam_a = adversary.active_self("graft_spam", tick)
        backoff_present = torch.where(spam_a[:, None, None], False, backoff_present)

    # refreshScores + memoized score cache (gossipsub.go:1333-1341)
    if cfg.score_enabled:
        score = refresh_scores(score, st.mesh, tick, tp, sc)
        score_fn = compute_scores_lifted if getattr(sc, "lifted", False) else compute_scores
        scores = score_fn(score, st.mesh, tp, sc, st.p6, st.app_score, net)
        # self-promotion: cooperating sybils pin their held scores of fellow
        # sybils on the memoised plane, so every consumer (mesh maintenance,
        # gossip targets, accept gates, the wire's score column) sees the
        # faction's cohesion; honest peers' scores of sybils are untouched
        if adversary is not None and adversary.has("self_promo"):
            promo = adversary.active_self("self_promo", tick)
            scores = torch.where(promo[:, None] & adversary.sybil_nbr, adversary.promo_score,
                                 scores)
    else:
        scores = st.scores

    # gater counter decay (peer_gater.go:204-216; DecayInterval default ==
    # the heartbeat interval)
    gater = gater_decay(st.gater, gater_params) if cfg.gater_enabled else st.gater

    # ---- mesh maintenance per (peer, topic-slot) ------------------------
    mesh = st.mesh
    slot_live = (net.my_topics >= 0) & (net.protocol >= 1)[:, None]
    connected = net.nbr_ok[:, None, :] & slot_live[:, :, None]
    scores_b = scores[:, None, :].expand(mesh.shape)

    tograft = torch.zeros_like(mesh)
    toprune = torch.zeros_like(mesh)
    if cfg.score_enabled:
        bad = mesh & (scores_b < 0)
        toprune = toprune | bad
        mesh = mesh & ~bad

    cand = connected & nbr_sub & ~mesh & ~backoff_present & ~net.direct[:, None, :]
    if cfg.score_enabled:
        cand = cand & (scores_b >= 0)

    # |mesh| < Dlo -> graft to D (gossipsub.go:1371-1385)
    deg = count_true(mesh)
    ineed = torch.where(deg < msh.Dlo, msh.D - deg, 0)
    grafts = masked_width_random(k1, cand, ineed, k_dim)
    mesh = mesh | grafts
    tograft = tograft | grafts

    # |mesh| > Dhi -> keep Dscore best + random to D, Dout outbound
    # (gossipsub.go:1388-1448)
    deg = count_true(mesh)
    over = (deg > msh.Dhi)[:, :, None]
    outb = net.outbound[:, None, :].expand(mesh.shape)
    noise = prng.uniform(k2, mesh.shape)
    if cfg.score_enabled:
        topscore = masked_width_topk(scores_b, mesh, msh.Dscore, k_dim, key=k3)
    else:
        topscore = masked_width_random(k3, mesh, msh.Dscore, k_dim)
    rest_rand = masked_width_topk(noise, mesh & ~topscore, msh.D - msh.Dscore, k_dim)
    keep = topscore | rest_rand
    x_need = (msh.Dout - count_true(keep & outb)).clamp(min=0)
    bring = select_topk_mask(noise, mesh & outb & ~keep, x_need)
    drop = select_topk_mask(-noise, keep & ~outb & ~topscore, count_true(bring))
    keep = (keep & ~drop) | bring
    pruned_over = mesh & ~keep & over
    mesh = torch.where(over, mesh & keep, mesh)
    toprune = toprune | pruned_over
    # over-subscription prunes carry PX, score prunes (``bad``) none
    # (gossipsub.go:1365 vs :1446)
    px_prune = None
    if cfg.do_px:
        px_prune = pruned_over & (scores_b >= 0) if cfg.score_enabled else pruned_over

    # outbound quota top-up at Dlo <= |mesh| (gossipsub.go:1451-1476)
    deg = count_true(mesh)
    need_out = torch.where(
        deg >= msh.Dlo, (msh.Dout - count_true(mesh & outb)).clamp(min=0), 0)
    grafts2 = masked_width_random(k4, cand & outb & ~mesh, need_out, k_dim)
    mesh = mesh | grafts2
    tograft = tograft | grafts2

    # opportunistic grafting (gossipsub.go:1479-1510)
    if cfg.score_enabled and cfg.opportunistic_graft_ticks > 0:
        med = median_masked(scores_b, mesh)
        low = (med < thr.opportunistic_graft_threshold) & (count_true(mesh) > 1)
        cand3 = cand & ~mesh & (scores_b > med[:, :, None])
        oppo = select_random_mask(
            k5, cand3, torch.where(low, cfg.opportunistic_graft_peers, 0))
        grafts3 = oppo & ((tick % cfg.opportunistic_graft_ticks) == 0)
        mesh = mesh | grafts3
        tograft = tograft | grafts3

    new_grafts = tograft & ~st.mesh
    if cfg.score_enabled:
        score = on_graft(score, new_grafts, tick)
        score = on_prune(score, toprune, tp)
    backoff_expire = torch.where(
        toprune, torch.maximum(st.backoff_expire, tick + cfg.prune_backoff_ticks),
        st.backoff_expire)
    backoff_present = backoff_present | toprune

    # ---- fanout maintenance (gossipsub.go:1517-1554) --------------------
    ft, fpeers, flastpub = st.fanout_topic, st.fanout_peers, st.fanout_lastpub
    fanout = nbr_sub_words is not None and cfg.fanout_slots > 0
    if fanout:
        # expire by FanoutTTL since the last publish (gossipsub.go:1518-1524)
        f_expired = (ft >= 0) & (flastpub + cfg.fanout_ttl_ticks < tick)
        ft = torch.where(f_expired, -1, ft)
        f_live = ft >= 0
        fpeers = fpeers & f_live[:, :, None]
        # drop peers below the publish threshold (gossipsub.go:1528-1534)
        if cfg.score_enabled:
            fpeers = fpeers & (scores[:, None, :] >= thr.publish_threshold)
        # the neighbour subscribes the slot's topic: a topic-bit pick
        nbr_sub_f = bitset.bit_get(nbr_sub_words[:, None, :, :].expand(
            -1, ft.shape[1], -1, -1), ft.clamp(min=0)[:, :, None].expand(fpeers.shape))
        base_f = (nbr_sub_f & mesh_capable[:, None, :] & ~net.direct[:, None, :]
                  & f_live[:, :, None])
        cand_f = base_f & ~fpeers
        if cfg.score_enabled:
            cand_f = cand_f & (scores[:, None, :] >= thr.publish_threshold)
        ineed_f = torch.where(f_live, msh.D - count_true(fpeers), 0)
        kf1, kf2 = prng.split(prng.fold_in(key, 11))
        fpeers = fpeers | masked_width_random(kf1, cand_f, ineed_f, k_dim)

    # ---- choke/unchoke (routers/choke.py): after mesh maintenance (the
    # guard reads the maintained mesh), before emitGossip (whose targets
    # take the choked links). The sender learns it is choked through one
    # edge gather, riding the heartbeat's control batch
    router = cfg.router
    choked_by = None
    choked = st.choked
    if router is not None and router.choke:
        choked = choke_guard(msh.Dlo, mesh, st.choked)
        choked, n_choke, n_unchoke = choke_decide(router, msh.Dlo, mesh, choked,
                                                  st.choke_ema)
        choked_by = net.edge_gather(choked.any(1)) & net.nbr_ok
        if cfg.count_events:
            events = add_event(add_event(events, EV.CHOKE, n_choke), EV.UNCHOKE, n_unchoke)

    # ---- emitGossip (gossipsub.go:1669-1723) ----------------------------
    gwin = bitset.word_or_reduce(st.mcache[:, : cfg.history_gossip, :], dim=1)
    gossip_cand = connected & nbr_sub & ~mesh & ~net.direct[:, None, :]
    if gossip_suppress is not None:
        gossip_cand = gossip_cand & ~gossip_suppress[:, None, :]
    if cfg.score_enabled:
        gossip_cand = gossip_cand & (scores_b >= thr.gossip_threshold)
    n_cand = count_true(gossip_cand)
    target = _gossip_target(n_cand, msh)
    chosen = masked_width_random(k6, gossip_cand, target, k_dim)
    if choked_by is not None:
        # a choked mesh link is IHAVE-only: the choked sender always gossips
        # to the choking neighbour (episub's lazy links carry every id), so
        # the ids keep flowing and the IWANT service keeps working
        chosen = chosen | (connected & nbr_sub & choked_by[:, None, :]
                           & ~net.direct[:, None, :])
    slot_tw = slot_topic_words(net, st.core.msgs.topic)
    adv = torch.where(chosen[..., None], (gwin[:, None, :] & slot_tw)[:, :, None, :], 0)
    ihave_out = bitset.word_or_reduce(adv, dim=1)

    # fanout-topic gossip (gossipsub.go:1551-1553; fanout peers excluded)
    if fanout:
        gossip_cand_f = base_f & ~fpeers
        if gossip_suppress is not None:
            gossip_cand_f = gossip_cand_f & ~gossip_suppress[:, None, :]
        if cfg.score_enabled:
            gossip_cand_f = gossip_cand_f & (scores[:, None, :] >= thr.gossip_threshold)
        n_cand_f = count_true(gossip_cand_f)
        target_f = torch.where(ft >= 0, _gossip_target(n_cand_f, msh), 0)
        chosen_f = masked_width_random(kf2, gossip_cand_f, target_f, k_dim)
        ftw = fanout_topic_words(ft, st.core.msgs.topic)
        adv_f = torch.where(chosen_f[..., None], (gwin[:, None, :] & ftw)[:, :, None, :], 0)
        ihave_out = ihave_out | bitset.word_or_reduce(adv_f, dim=1)

    # mcache.Shift (gossipsub.go:1563)
    mcache = torch.cat([torch.zeros_like(st.mcache[:, :1, :]), st.mcache[:, :-1, :]],
                       dim=1)

    # directConnect (gossipsub.go:1606-1628): every DirectConnectTicks a
    # dormant direct edge comes back live, both ways; tick 0 is skipped
    # (DirectConnectInitialDelay)
    edge_live = st.edge_live
    if cfg.do_px and cfg.direct_connect_ticks > 0:
        direct_sym = net.direct | net.edge_gather(net.direct)
        redial = ((tick % cfg.direct_connect_ticks) == 0) & (tick > 0)
        ok = net.nbr_ok if present_ok is None else present_ok
        edge_live = torch.where(redial, edge_live | (direct_sym & ok), edge_live)

    # the attack plane's heartbeat behaviours
    graft_out_next = new_grafts
    if adversary is not None:
        if adversary.has("graft_spam"):
            # GRAFT every eligible (live slot, edge), backoff or not (the
            # GRAFT flood, gossipsub_spam_test.go:365); the spammer's own
            # backoff planes stay zero
            spam_a = adversary.active_self("graft_spam", tick)
            spam = (spam_a[:, None, None] & slot_live[:, :, None]
                    & adversary.spam_edges[:, None, :])
            graft_out_next = graft_out_next | spam
            backoff_present = torch.where(spam_a[:, None, None], False, backoff_present)
            backoff_expire = torch.where(spam_a[:, None, None], 0, backoff_expire)
            if cfg.count_events:
                events = add_event(events, EV.ADV_GRAFT_SPAM, spam.sum(dtype=torch.int32))
        if adversary.has("lie_ihave"):
            # advertise every live message on every present edge, held or
            # not (IHAVE spam, gossipsub_spam_test.go:290): the victims'
            # IWANTs go unserved and their promises break
            lie_a = adversary.active_self("lie_ihave", tick)
            live_w = bitset.pack(st.core.msgs.birth >= 0)
            lie = torch.where((lie_a[:, None] & net.nbr_ok)[:, :, None], live_w[None, None, :], 0)
            if cfg.count_events:
                events = add_event(events, EV.ADV_IHAVE_LIE,
                                   bitset.popcount(lie & ~ihave_out).sum(dtype=torch.int32))
            ihave_out = ihave_out | lie

    if cfg.count_events:
        events = add_event(events, EV.GRAFT, new_grafts.sum(dtype=torch.int32))
        events = add_event(events, EV.PRUNE, toprune.sum(dtype=torch.int32))

    return replace(
        st,
        core=replace(st.core, events=events),
        mesh=mesh,
        backoff_expire=backoff_expire,
        backoff_present=backoff_present,
        mcache=mcache,
        ihave_out=ihave_out,
        graft_out=graft_out_next,
        prune_out=st.prune_out | toprune,
        prune_px_out=st.prune_px_out if px_prune is None else st.prune_px_out | px_prune,
        edge_live=edge_live,
        peerhave=peerhave,
        iasked=iasked,
        promise_mid=promise_mid,
        score=score,
        scores=scores,
        gater=gater,
        fanout_topic=ft,
        fanout_peers=fpeers,
        fanout_lastpub=flastpub,
        choked=choked,
    )


def gather_nbr_subscribed(net: Net) -> torch.Tensor:
    """[N,S,K]: neighbor k subscribes the topic of my slot s."""
    n, s_dim = net.my_topics.shape
    k_dim = net.nbr.shape[1]
    sub_nbr = net.subscribed[net.nbr.clamp(min=0).long()]          # [N,K,T]
    idx = net.my_topics.clamp(min=0).long()[:, None, :].expand(n, k_dim, s_dim)
    out = torch.gather(sub_nbr, 2, idx).permute(0, 2, 1)
    return out & net.nbr_ok[:, None, :] & (net.my_topics >= 0)[:, :, None]


# ---------------------------------------------------------------------------
# the per-round step


@dataclasses.dataclass
class StepConsts:
    """Static per-topology constants of the step, computed once at build
    (float32 score constants flushed, ``ops/fnum.py``)."""

    scalars: ScoreScalars
    tp: dict
    window_rounds_t: torch.Tensor
    nbr_sub_const: torch.Tensor
    flood_from: torch.Tensor
    i_am_floodsub: torch.Tensor
    # the fanout checks' views (None without fanout slots): the
    # neighbours' subscriptions as topic bits [N,K,Wt], and whether the far
    # end speaks a mesh protocol [N,K]
    nbr_sub_words: torch.Tensor | None
    mesh_capable: torch.Tensor | None
    # edge (j, k) carries data only if its sender nbr[j, k] forwards; None
    # without an adversary vector (every sender forwards)
    sender_fwd_ok: torch.Tensor | None
    sender_fwd_full: torch.Tensor
    live_u32: torch.Tensor
    # the gater's per-source share of its counters (score/gater.py); None
    # without the gater
    gater_share: object = None
    # whether the live edges move from round to round (PX, edge_liveness
    # or dynamic peers): every gate, gather and kernel argument then reads
    # the round's live view instead of these constants
    live_moves: bool = False
    # the attack plane's device constants (chaos.adversary.AdversaryConsts),
    # None without an armed population
    adv: object = None


def topology_views(net: Net, fanout: bool):
    """(nbr_sub, flood_from, nbr_sub_words, mesh_capable): mesh candidates
    need a mesh-capable far end (gossipsub.go:1374,1692); floodsub-semantics
    edges face a floodsub-only peer; with ``fanout`` the neighbours'
    subscriptions as topic-bit words [N,K,Wt] and the mesh-capable plane
    serve the fanout checks (None without)."""
    proto_nbr = net.protocol[net.nbr.clamp(min=0).long()]
    mesh_capable = (proto_nbr >= 1) & net.nbr_ok
    nbr_sub = gather_nbr_subscribed(net) & mesh_capable[:, None, :]
    flood_from = (proto_nbr == 0) & net.nbr_ok
    if not fanout:
        return nbr_sub, flood_from, None, None
    subscribed_words = bitset.pack(net.subscribed)                    # [N, Wt]
    nbr_sub_words = torch.where(net.nbr_ok[:, :, None],
                                subscribed_words[net.nbr.clamp(min=0).long()], 0)
    return nbr_sub, flood_from, nbr_sub_words, mesh_capable


def announce_holes(net: Net, nbr_sub, nbr_sub_words, holes):
    """Fold the announce-visibility holes (pubsub.go:842-901) into the
    neighbour-subscription views: ``holes`` [N,K,T] marks the (receiver,
    edge, topic) triples whose SubOpts announcement has not arrived, and
    the unannounced subscriber is invisible to mesh-candidate selection,
    gossip targeting and fanout. Returns (nbr_sub, nbr_sub_words)."""
    holes = torch.as_tensor(np.asarray(holes, bool), device=net.device)   # [N,K,T]
    mt = net.my_topics
    hs = torch.gather(holes, 2, mt.clamp(min=0).long()[:, None, :].expand(
        -1, holes.shape[1], -1)).transpose(1, 2)                          # [N,S,K]
    nbr_sub = nbr_sub & ~(hs & (mt >= 0)[:, :, None])
    if nbr_sub_words is not None:
        nbr_sub_words = nbr_sub_words & ~bitset.pack(holes)
    return nbr_sub, nbr_sub_words


def rebind_step_consts(cfg: GossipSubConfig, consts: StepConsts, net: Net) -> StepConsts:
    """``consts`` with the topology views recomputed from ``net`` (a
    dynamic-topology round's rebound net) by the build's own expressions."""
    nbr_sub, flood_from, nbr_sub_words, mesh_capable = topology_views(
        net, cfg.fanout_slots > 0)
    return replace(
        consts, nbr_sub_const=nbr_sub, flood_from=flood_from, nbr_sub_words=nbr_sub_words,
        mesh_capable=mesh_capable, live_u32=net.nbr_ok.to(torch.int32),
        # the groups each peer sees move with its edges
        gater_share=source_share(net, static=False) if cfg.gater_enabled else None)


def prepare_step_consts(cfg: GossipSubConfig, net: Net,
                        score_params: PeerScoreParams | None,
                        heartbeat_interval: float,
                        gater_params: PeerGaterParams | None = None,
                        adversary_no_forward: np.ndarray | None = None,
                        sub_knowledge_holes: np.ndarray | None = None,
                        dynamic_peers: bool = False, adversary=None) -> StepConsts:
    # the layout and the fused flag are one choice per build: the config
    # drives the selections, the net the gathers and the delivery seam
    if cfg.edge_layout != net.edge_layout:
        raise ValueError(
            f"cfg.edge_layout={cfg.edge_layout!r} but the Net was built with "
            f"edge_layout={net.edge_layout!r} — build both with the same layout")
    if cfg.fused != net.fused:
        raise ValueError(
            f"cfg.fused={cfg.fused!r} but the Net was built with "
            f"fused={net.fused!r} — build both with the same flag")
    if cfg.gater_enabled:
        if gater_params is None:
            raise ValueError("cfg.gater_enabled needs gater_params")
        gater_params.validate()
    if (cfg.validation_delay_topic is not None
            and len(cfg.validation_delay_topic) != net.n_topics):
        raise ValueError(
            f"validation_delay_topic has {len(cfg.validation_delay_topic)} entries "
            f"but the net has {net.n_topics} topics")
    if cfg.score_enabled:
        assert score_params is not None
        score_params.validate()
        tpa = TopicParamsArrays.build(score_params, net.n_topics, heartbeat_interval)
    else:
        score_params = PeerScoreParams(topics={}, skip_app_specific=True)
        tpa = TopicParamsArrays.build(score_params, net.n_topics)
    nbr_sub, flood_from, nbr_sub_words, mesh_capable = topology_views(
        net, cfg.fanout_slots > 0)
    if sub_knowledge_holes is not None:
        nbr_sub, nbr_sub_words = announce_holes(net, nbr_sub, nbr_sub_words,
                                                sub_knowledge_holes)
    # the adversary behaviour vector: marked peers run the control plane
    # but never transmit message data (a build-time constant)
    if adversary_no_forward is not None:
        adv = torch.as_tensor(np.asarray(adversary_no_forward, bool), device=net.device)
        sender_fwd_ok = ~adv[net.nbr.clamp(min=0).long()] & net.nbr_ok
    else:
        sender_fwd_ok = None
    # the attack plane: None (or an unarmed population) leaves it out; an
    # armed one's planes and neighbour views are device constants built
    # here once
    adversary = adversary_mod.resolve(adversary, net)
    return StepConsts(
        scalars=ScoreScalars.build(score_params),
        tp=tpa.gather(net.my_topics),
        window_rounds_t=torch.as_tensor(tpa.window_rounds, device=net.device),
        nbr_sub_const=nbr_sub,
        flood_from=flood_from,
        i_am_floodsub=net.protocol == 0,
        nbr_sub_words=nbr_sub_words,
        mesh_capable=mesh_capable,
        sender_fwd_ok=sender_fwd_ok,
        sender_fwd_full=(sender_fwd_ok if sender_fwd_ok is not None else
                         torch.ones(net.nbr.shape, dtype=torch.bool, device=net.device)),
        live_u32=net.nbr_ok.to(torch.int32),
        gater_share=source_share(net) if cfg.gater_enabled else None,
        live_moves=tracks_liveness(cfg) or dynamic_peers,
        adv=adversary_mod.AdversaryConsts(adversary, net) if adversary is not None else None,
    )


@dataclasses.dataclass
class RoundParams:
    """What a round reads of the score and mesh parameters: the gathered
    topic rows ``tp``, the score scalars ``sc``, the per-topic P3 windows
    ``wrt``, the thresholds' source ``thr`` and the degrees' source
    ``msh``. A static build's are its constants and ``cfg``; a lifted
    build's come from the plane of the call (``round_params``)."""

    tp: dict
    sc: object
    wrt: torch.Tensor
    thr: object
    msh: object


def round_params(cfg: GossipSubConfig, net: Net, consts: "StepConsts",
                 score_plane=None) -> RoundParams:
    """The round's parameters: the build's (``score_plane`` None), or a
    lifted plane's (a ``score.params.ScoreParams``, or a
    ``CandidateParams`` whose mesh plane then gives the degrees), its
    float leaves flushed on the device."""
    if score_plane is None:
        return RoundParams(consts.tp, consts.scalars, consts.window_rounds_t, cfg, cfg)
    sc, mesh = split_plane(score_plane)
    sc = sc.flushed()
    return RoundParams(sc.gather(net.my_topics), sc, sc.window_rounds, sc,
                       cfg if mesh is None else mesh)


def flushed_thresholds(cfg: GossipSubConfig) -> GossipSubConfig:
    """``cfg`` with its five score thresholds as the float32 constants the
    JAX package compares against: a subnormal threshold is a zero of its
    sign (``ops/fnum.py``). The scores they meet are flushed already, so
    every compare of the step reads flushed operands on both sides."""
    return dataclasses.replace(cfg, **{
        f: flush_f32(getattr(cfg, f))
        for f in ("gossip_threshold", "publish_threshold", "graylist_threshold",
                  "accept_px_threshold", "opportunistic_graft_threshold")})


def accept_gates(cfg: GossipSubConfig, net: Net, st: GossipSubState,
                 consts: StepConsts, gater_params: PeerGaterParams | None, tick, thr=None):
    """AcceptFrom (gossipsub.go:583-594): direct always accepted,
    graylisted dropped entirely; the gater's random-early drop takes only
    the message plane (AcceptControl, peer_gater.go:362). ``net`` is the
    round's live view, ``thr`` the thresholds' source. Returns (acc_ok,
    acc_msg) [N,K] bool."""
    thr = cfg if thr is None else thr
    if cfg.score_enabled:
        acc_ok = (st.scores >= thr.graylist_threshold) | net.direct
    else:
        acc_ok = net.nbr_ok
    if not cfg.gater_enabled:
        return acc_ok, acc_ok
    # a stream of its own: the round key folded with a distinct tag (the
    # heartbeat takes fold_in(key, tick) directly)
    gkey = prng.fold_in(prng.fold_in(st.core.key, tick), 0x6A7E)
    live = net.nbr_ok if consts.live_moves else None
    acc_msg = acc_ok & (gater_accept(st.gater, consts.gater_share, gater_params,
                                     cfg.gater_quiet_ticks, tick, gkey, live) | net.direct)
    return acc_ok, acc_msg


def apply_validation_throttle(dlv, info: RoundInfo, cap: int, m: int, valid_words):
    """The validation front-end queue (validation.go:230-244, Push on a full
    queue => RejectValidationThrottled): each peer admits at most ``cap``
    new receipts a round, the lowest slots first; the overflow is refused —
    not marked seen, not forwarded, no score attribution
    (score.go:745-749,761-767). The cap applies at queue admission (this
    round's fresh receipts), so with the async pipeline the refused receipts
    clear from the stages, not from the verdict state, and this round's
    verdicts stand. Returns (dlv, info, accepted_new_words, n_throttled [N]
    i32); the accepted plane is the verdict cohort."""
    entry = info.recv_new_words
    # the clear-lowest-bit chain for a static cap, not an unpack+cumsum
    accepted = bitset.keep_lowest_bits(entry, cap, m)
    refused = entry & ~accepted
    n_throttled = bitset.popcount(refused)
    if dlv.pending is not None:
        # refused receipts are fresh, so they sit in their entry stage;
        # clearing every stage serves any per-topic entry pattern
        dlv = replace(dlv, have=dlv.have & ~refused,
                      fe_words=dlv.fe_words & ~refused[:, None, :],
                      pending=dlv.pending & ~refused[:, None, :])
        info = replace(info, recv_new_words=accepted,
                       n_reject=info.n_reject + n_throttled.sum(dtype=torch.int32))
        return dlv, info, info.new_words, n_throttled
    dlv = replace(
        dlv,
        have=dlv.have & ~refused,
        fwd=dlv.fwd & ~refused,
        first_round=torch.where(bitset.unpack(refused, m), -1, dlv.first_round),
        fe_words=dlv.fe_words & ~refused[:, None, :],
    )
    # accepted-valid deliver; accepted-invalid and throttled trace Reject
    info = replace(
        info, new_words=accepted, recv_new_words=accepted,
        n_deliver=bitset.popcount(accepted & valid_words[None, :]).sum(dtype=torch.int32),
        n_reject=(bitset.popcount(accepted & ~valid_words[None, :]).sum(dtype=torch.int32)
                  + n_throttled.sum(dtype=torch.int32)),
    )
    return dlv, info, accepted, n_throttled


def outcome_planes(trans, pre_have, valid_words, ignored_words):
    """The gater's per-edge outcome planes of a delivery round: arrivals of
    messages the receiver held already (duplicate), of ignored messages
    (ignore) and of the other invalid ones (reject), as (dup, rej, ign)
    [N,K,W] words (peer_gater.go:365-443)."""
    return (trans & pre_have[:, None, :],
            trans & ~(valid_words | ignored_words)[None, None, :],
            trans & ignored_words[None, None, :])


def gater_outcomes(gater: GaterState, fe_words, accepted, valid_words, dup, rej, ign,
                   n_validated, n_throttled, tick) -> GaterState:
    """Fold delivery outcomes into the gater's counters (the RawTracer
    hooks): first arrivals of accepted valid messages deliver, and the
    ``outcome_planes`` count per edge."""
    f32 = torch.float32
    first_arrival = fe_words & accepted[:, None, :] & valid_words[None, None, :]
    return gater_on_round(
        gater, n_validated, n_throttled, bitset.popcount(first_arrival).to(f32),
        bitset.popcount(dup).to(f32), bitset.popcount(rej).to(f32), tick,
        ignore_inc=bitset.popcount(ign).to(f32))


def control_parts(cfg: GossipSubConfig, net: Net, st: GossipSubState):
    """The control-plane outboxes as named packed word tensors, in the wire
    order (graft | prune | ihave, then px under PX); the score plane rides
    the exchange kernel as f32 beside them."""
    parts = [
        ("graft", edges.topic_pack(st.graft_out, net.my_topics, net.n_topics)),
        ("prune", edges.topic_pack(st.prune_out, net.my_topics, net.n_topics)),
        ("ihave", st.ihave_out),
    ]
    if cfg.do_px:
        parts.append(("px", edges.topic_pack(st.prune_px_out, net.my_topics, net.n_topics)))
    return parts


def control_unpack(cfg: GossipSubConfig, net: Net, w_seg):
    """Receiver-side split of the gathered control words (``w_seg(i)`` =
    the i-th part's edge view, in control_parts order; ``net`` the round's
    live view): (graft_in_raw, prune_in_raw, ihave_in_raw, px_in_raw), the
    last None without PX."""
    ok_slots = net.nbr_ok[:, None, :]
    graft_in_raw = edges.topic_unpack(w_seg(0), net.my_topics) & ok_slots
    prune_in_raw = edges.topic_unpack(w_seg(1), net.my_topics) & ok_slots
    px_in_raw = (edges.topic_unpack(w_seg(3), net.my_topics) & ok_slots
                 if cfg.do_px else None)
    return graft_in_raw, prune_in_raw, w_seg(2), px_in_raw


def gather_cross(net: Net, words: torch.Tensor, scores):
    """Carry ``[N, K, C]`` control words, and the ``[N, K]`` score plane
    when given, across the edge involution as two gathers (the JAX
    package's policy at Wt == 1; its split of IHAVE from the topic words at
    Wt > 1 only spared a TPU relayout and changes no value). Absent slots
    read 0."""
    wire = torch.where(net.nbr_ok[:, :, None], net.edge_gather(words), 0)
    if scores is None:
        return wire, None
    return wire, torch.where(net.nbr_ok, net.edge_gather(scores), 0.0)


def banded_cross(net: Net, live_u32: torch.Tensor, score_enabled: bool, words: torch.Tensor,
                 scores):
    """Carry ``[N, K, C]`` control words across the banded involution as one
    ``edge_exchange`` launch, the score plane riding as f32 (zero where
    ``live_u32`` is)."""
    n, k, c = words.shape
    wire_flat, nbr_score_of_me = fr.edge_exchange(
        words.reshape(n, k * c), scores, live_u32, offsets=net.band_off,
        revs=net.band_rev, c=c, score_enabled=score_enabled)
    return wire_flat.reshape(n, k, c), nbr_score_of_me


def control_exchange(cfg: GossipSubConfig, net: Net, st: GossipSubState, cross):
    """The control wire exchange: every control outbox crosses the edges at
    once through ``cross(words [N, K, C], scores or None) -> (wire
    [N, K, C], nbr_score_of_me or None)``, the score plane beside it;
    ``net`` is the round's live view. Returns (graft_in_raw, prune_in_raw,
    ihave_in_raw, px_in_raw, nbr_score_of_me), the last two None without
    PX and without scoring."""
    parts = [p for _, p in control_parts(cfg, net, st)]
    sizes = np.cumsum([0] + [p.shape[-1] for p in parts])
    wire, nbr_score_of_me = cross(torch.cat(parts, dim=-1),
                                  st.scores if cfg.score_enabled else None)
    return (*control_unpack(
        cfg, net, lambda i: wire[..., int(sizes[i]): int(sizes[i + 1])]),
        nbr_score_of_me)


def control_exchange_coalesced(cfg: GossipSubConfig, net: Net, st: GossipSubState,
                               live_u32: torch.Tensor):
    """The phase engine's control head as one exchange: the control
    outboxes, the score plane and the sender's mcache window (broadcast
    over the edges, so its peer gather becomes the same involution) cross
    the edges together (gossipsub.go:1096-1141 piggyback). On a banded net
    with K <= MAX_K it is one ``edge_exchange`` launch over ``graft | prune
    | ihave [| px] | window`` words with the scores as the kernel's f32
    plane, zero where ``live_u32`` is; on any other net one
    ``Net.edge_gather`` of the concatenation (scores as their bits), masked
    by the live view ``net.nbr_ok``, as the JAX package computes it. The
    JAX package also carries the P5 app plane here when its weight is live;
    the port's heartbeat gathers it where it reads it (``compute_scores``),
    which gives the same bits. Returns (graft_in_raw, prune_in_raw,
    ihave_in_raw, px_in_raw or None, nbr_score_of_me or None, window_g
    [N, K, W])."""
    n, k = net.n_peers, net.max_degree
    named = control_parts(cfg, net, st)
    window = bitset.word_or_reduce(st.mcache, dim=1)[:, None, :].expand(n, k, -1)
    named.append(("window", window))
    kernel_route = net.band_off is not None and k <= fr.MAX_K
    if not kernel_route and cfg.score_enabled:
        # the reference's order: the score bits ride after the control words
        named.insert(len(named) - 1, ("score", bitcast(st.scores, torch.int32)[..., None]))
    names = [nm for nm, _ in named]
    sizes = np.cumsum([0] + [p.shape[-1] for _, p in named])
    words = torch.cat([p for _, p in named], dim=-1)
    if kernel_route:
        c = words.shape[-1]
        wire, nbr_score_of_me = fr.edge_exchange(
            words.reshape(n, k * c), st.scores if cfg.score_enabled else None,
            live_u32, offsets=net.band_off, revs=net.band_rev, c=c,
            score_enabled=cfg.score_enabled)
        wire = wire.reshape(n, k, c)
    else:
        wire = torch.where(net.nbr_ok[:, :, None], net.edge_gather(words), 0)
        nbr_score_of_me = None

    def seg(name):
        i = names.index(name)
        return wire[..., int(sizes[i]): int(sizes[i + 1])]

    if not kernel_route and cfg.score_enabled:
        nbr_score_of_me = torch.where(net.nbr_ok, bitcast(seg("score")[..., 0], torch.float32),
                                      0.0)
    graft_in_raw, prune_in_raw, ihave_in_raw, px_in_raw = control_unpack(
        cfg, net, lambda i: seg(("graft", "prune", "ihave", "px")[i]))
    return (graft_in_raw, prune_in_raw, ihave_in_raw, px_in_raw, nbr_score_of_me,
            seg("window"))


def drop_edges(st: GossipSubState, edge: torch.Tensor, score: ScoreState) -> GossipSubState:
    """``st`` with every per-edge plane of the router cleared on ``edge``
    [N,K] (the edges leave the mesh and the fanout sets, their outboxes,
    served counters, IHAVE counters and promises reset) and ``score`` as
    its score state: the cleanup both a departing peer's edges and a
    rewritten slot take."""
    x3, e3 = edge[:, None, :], edge[:, :, None]
    return replace(
        st,
        mesh=st.mesh & ~x3,
        fanout_peers=st.fanout_peers & ~x3,
        graft_out=st.graft_out & ~x3,
        prune_out=st.prune_out & ~x3,
        ihave_out=torch.where(e3, 0, st.ihave_out),
        iwant_out=torch.where(e3, 0, st.iwant_out),
        served_lo=torch.where(e3, 0, st.served_lo),
        served_hi=torch.where(e3, 0, st.served_hi),
        peerhave=torch.where(edge, 0, st.peerhave),
        iasked=torch.where(edge, 0, st.iasked),
        promise_mid=torch.where(edge, -1, st.promise_mid),
        score=score,
    )


def apply_peer_transitions(cfg: GossipSubConfig, net: Net, st: GossipSubState,
                           up_next: torch.Tensor, tp: dict):
    """Peer lifecycle (dynamic peers): a peer that goes down, or is
    blacklisted (``set_blacklist``), is disconnected with the reference's
    whole dead-peer cleanup (handleDeadPeers pubsub.go:648-689, the
    router's RemovePeer gossipsub.go:545-562, score retention
    score.go:604-689), and every edge touching it dies both ways; a peer
    that comes back starts with fresh soft state. ``up_next`` [N] bool.
    Returns (state, live [N,K] bool: the edges whose two ends are up)."""
    eff_next = up_next & ~st.blacklist
    down_tr = st.up & ~eff_next
    up_tr = ~st.up & eff_next
    down_nbr = net.peer_gather(down_tr) & net.nbr_ok
    down_edge = (down_nbr | down_tr[:, None]) & net.nbr_ok
    score = st.score
    if cfg.score_enabled:
        # removePeer (score.go:604-637): a standing P3 deficit on a
        # departing mesh edge converts into the sticky P3b penalty, every
        # dead edge leaves the mesh, then the stats go, but those of
        # retained (negative-score) neighbours, which keep decaying
        score = on_prune(score, st.mesh & down_nbr[:, None, :], tp)
        score = clear_mesh_status(score, down_nbr)
        score = clear_edges(score, (down_nbr & (st.scores >= 0)) | down_tr[:, None])
    # a crashing node loses its soft state: seen-cache, forward set,
    # receipts, the pipeline, mcache
    dlv = st.core.dlv
    d2, d3 = down_tr[:, None], down_tr[:, None, None]
    dlv = replace(
        dlv, have=torch.where(d2, 0, dlv.have), fwd=torch.where(d2, 0, dlv.fwd),
        first_round=torch.where(d2, -1, dlv.first_round),
        fe_words=torch.where(d3, 0, dlv.fe_words),
        pending=torch.where(d3, 0, dlv.pending) if dlv.pending is not None else None)
    events = st.core.events
    if cfg.count_events:
        events = add_event(add_event(events, EV.REMOVE_PEER, down_tr.sum(dtype=torch.int32)),
                           EV.ADD_PEER, up_tr.sum(dtype=torch.int32))
    # the router plane: a crashing announcer forgets its IDONTWANT set with
    # the rest of its soft state; choke state and in-flight commits die with
    # their edges, and the guard re-establishes the choke contract against
    # the post-churn mesh (a death that took an unchoked link fails open)
    router_clear = {}
    if st.dontwant is not None:
        router_clear["dontwant"] = torch.where(d2, 0, st.dontwant)
    if st.choked is not None:
        de3 = down_edge[:, None, :]
        router_clear["choked"] = choke_guard(cfg.Dlo, st.mesh & ~de3, st.choked & ~de3)
        router_clear["choke_ema"] = torch.where(down_edge, 0.0, st.choke_ema)
    if st.inflight is not None:
        router_clear["inflight"] = torch.where(down_edge[:, :, None, None], 0, st.inflight)
    st = replace(drop_edges(st, down_edge, score),
                 core=replace(st.core, dlv=dlv, events=events),
                 mcache=torch.where(d3, 0, st.mcache), up=eff_next, **router_clear)
    live = net.nbr_ok & st.up[:, None] & net.peer_gather(st.up)
    return st, live


def clear_mutated_edges(cfg: GossipSubConfig, st: GossipSubState, wr_edge: torch.Tensor,
                        tp: dict) -> GossipSubState:
    """The dead-edge cleanup of the slots a dynamic-topology round wrote
    (``wr_edge`` [N,K], ``topo.dynamics.written_edge_mask``): a written slot
    names a new connection, so its per-edge state clears as a departing
    peer's edges do (score retention included), and its backoff clears too
    (the reference keys backoff by peer, and a rewired slot is another
    peer). Per-peer planes stay: both ends are up across a rewire."""
    we3 = wr_edge[:, None, :]
    score = st.score
    if cfg.score_enabled:
        score = on_prune(score, st.mesh & we3, tp)
        score = clear_mesh_status(score, wr_edge)
        score = clear_edges(score, wr_edge)
    # first-arrival attribution credits the slot's old far end
    dlv = replace(st.core.dlv, fe_words=torch.where(wr_edge[:, :, None], 0,
                                                    st.core.dlv.fe_words))
    return replace(drop_edges(st, wr_edge, score),
                   core=replace(st.core, dlv=dlv),
                   backoff_present=st.backoff_present & ~we3,
                   backoff_expire=torch.where(we3, 0, st.backoff_expire),
                   congested_in=st.congested_in & ~wr_edge)


def set_blacklist(st: GossipSubState, mask) -> GossipSubState:
    """BlacklistPeer (pubsub.go:590-605): ``mask`` [N] bool; the next
    dynamic-peers step disconnects each marked peer with the whole cleanup
    and keeps it out while its flag is set (pubsub.go:636-639,
    :1048-1060)."""
    if not isinstance(mask, torch.Tensor):
        mask = torch.as_tensor(np.asarray(mask, bool))
    return replace(st, blacklist=mask.to(device=st.blacklist.device, dtype=torch.bool))


def tracks_liveness(cfg: GossipSubConfig) -> bool:
    """Whether the build reads the state's ``edge_live`` plane: under PX
    or ``edge_liveness``. Otherwise the live view is the static topology
    and the step reads its build constants (no extra op, no extra launch)."""
    return cfg.do_px or cfg.edge_liveness


def live_step_views(cfg: GossipSubConfig, net: Net, st: GossipSubState,
                    consts: "StepConsts", live: torch.Tensor | None = None):
    """The topology views a round reads (the live-peer view): (net_l,
    nbr_sub_l, flood_from_l, nbr_sub_words_l, live_u32). ``live`` is the
    peer transitions' live mask (``apply_peer_transitions``, dynamic peers),
    None otherwise. Under PX or ``edge_liveness`` the live edges are that
    mask (or ``nbr_ok``) and ``st.edge_live`` (dormant edges carry nothing
    until activated; ``edge_live`` is symmetric, so one side suffices);
    under dynamic peers alone, the mask. ``net_l`` is the net with them as
    its ``nbr_ok``, the three planes are masked by them and ``live_u32`` is
    their int32 form, the live words of every ``edge_exchange``. Otherwise
    they are the build's constants."""
    if tracks_liveness(cfg):
        live = (net.nbr_ok if live is None else live) & st.edge_live
    if live is None:
        return (net, consts.nbr_sub_const, consts.flood_from, consts.nbr_sub_words,
                consts.live_u32)
    nbr_sub_words_l = None
    if consts.nbr_sub_words is not None:
        nbr_sub_words_l = torch.where(live[:, :, None], consts.nbr_sub_words, 0)
    return (replace(net, nbr_ok=live), consts.nbr_sub_const & live[:, None, :],
            consts.flood_from & live, nbr_sub_words_l, live.to(torch.int32))


def px_connect(cfg: GossipSubConfig, net: Net, net_l: Net, st: GossipSubState,
               px_ok, dynamic_peers: bool = False) -> torch.Tensor:
    """PX connect (pxConnect gossipsub.go:861-941): a peer pruned with PX
    activates its dormant provisioned edges to the peers the pruner
    suggested — the pruner's mesh members over its topics, one round stale
    as every outbox (makePrune/getPeers :1814-1872). ``net_l`` is the live
    view (suggestions ride live edges), ``net`` the static topology
    (dormant slots live there); with ``dynamic_peers`` only an edge whose
    two ends are up activates. Returns next round's ``edge_live``."""
    if not cfg.do_px:
        return st.edge_live
    sugg = torch.where(st.mesh.any(1) & net_l.nbr_ok, net_l.nbr, -1)    # [N, K]
    # the suggestions each PRUNE with an accepted PX carries, -1 elsewhere
    sugg_g = torch.where(px_ok[:, :, None], net.peer_gather(sugg), -1)  # [N, K, K]
    dormant_avail = net.nbr_ok & ~st.edge_live & (net.nbr >= 0)
    if dynamic_peers:
        dormant_avail = dormant_avail & st.up[:, None] & net.peer_gather(st.up)
    act = torch.zeros_like(dormant_avail)
    for kk in range(net.max_degree):
        # my dormant slot's peer is among pruner kk's suggestions, reduced
        # over the middle axis: the card reduces a last axis of K several
        # times slower (perf/profile.py --px)
        act = act | (net.nbr[:, None, :] == sugg_g[:, kk, :, None]).any(1)
    act = act & dormant_avail
    return st.edge_live | ((act | net.edge_gather(act)) & net.nbr_ok)


def make_gossipsub_step(cfg: GossipSubConfig, net: Net,
                        score_params: PeerScoreParams | None = None,
                        heartbeat_interval: float = 1.0,
                        gater_params: PeerGaterParams | None = None,
                        adversary_no_forward: np.ndarray | None = None,
                        static_heartbeat: bool = False, dynamic_peers: bool = False,
                        sub_knowledge_holes: np.ndarray | None = None,
                        dynamic_topo: bool = False, lift_scores: bool = False,
                        telemetry=None, adversary=None, link_delay: np.ndarray | None = None):
    """Build the per-round step for a fixed config + topology:

        step(state, pub_origin[P], pub_topic[P], pub_valid[P]
             [, up_next[N]] [, link_deny[N, K]] [, mut_writes[B, 4]]
             [, score_plane]) -> state

    With ``lift_scores=True`` (which needs ``cfg.score_enabled``) the step
    takes a lifted plane as its last positional (``score.params``: a
    ``ScoreParams``, or a ``CandidateParams`` with the mesh degrees too):
    every score weight, decay, cap and threshold, and with a mesh plane
    every degree, is read from it on the device, so one step (and one
    captured window) runs any weight set; ``ScoreParams.from_config`` of the
    build's values reproduces the static build. Its float forms are the
    JAX package's lifted build's (``score.engine.compute_scores_lifted``).

    With ``dynamic_peers=True`` the step takes the notify plane ``up_next``
    [N] bool: a peer that goes down, or is blacklisted (``set_blacklist``),
    is disconnected with the whole dead-peer cleanup
    (``apply_peer_transitions``) and every edge touching it carries nothing
    until it is back; every gate, gather and kernel argument reads the
    round's live edges. With ``dynamic_topo=True`` as well it takes
    ``mut_writes`` [B, 4] int32 (a ``topo.dynamics.MutationSchedule``
    batch, padded with ``PAD_SLOT`` rows): the round's writes land on the
    state's overlay (``GossipSubState.init(..., dynamic_topo=True)``) first,
    the net and its topology views are rebound from it and the written
    slots' edge state clears; it needs an unbanded net
    (``Net.build(..., dynamic=True)``, dense or full-capacity CSR) and
    refuses the adversary vector, announce holes, PX and edge liveness, as
    the JAX package does. ``sub_knowledge_holes`` [N,K,T] bool hides
    unannounced subscriptions from mesh, gossip and fanout selection.

    With ``static_heartbeat=True`` (and ``cfg.heartbeat_every > 1``) the
    step takes a required keyword ``do_heartbeat`` (the caller owns the
    contract do_heartbeat == (tick % heartbeat_every == 0)); otherwise a
    heartbeat_every > 1 step decides on the device and selects leafwise.

    ``gater_params`` (with ``cfg.gater_enabled``) drives the peer gater;
    ``cfg.validation_capacity`` > 0 the validation throttle; fanout slots
    (``cfg.fanout_slots``) track publishes to unjoined topics.
    ``adversary_no_forward`` is a static [N] bool behaviour vector: marked
    peers run the whole control plane but never transmit message data (the
    reference suite's ``sybilSquatter``, gossipsub_test.go:1777-1811).

    ``adversary`` (a ``chaos.Adversary``, or an ``AttackScenario`` built
    against ``net``) arms the attack plane: its per-peer planes and their
    neighbour views become device constants here, and each round compares
    them with the tick. drop_forward and censor mask the edge mask and the
    IWANT responses on edges from an active attacker (``ADV_DROP`` counts
    the withheld bits); lie_ihave, graft_spam and self_promo act in the
    heartbeat (``ADV_IHAVE_LIE``, ``ADV_GRAFT_SPAM``). The plane has no
    state. ``telemetry`` (a ``telemetry.TelemetryConfig``; the state needs
    ``GossipSubState.init(..., telemetry=)``) writes one panel row a round
    as the step's last operation, the event deltas from the step's entry.
    None leaves either plane out: the same leaves, ops and launches.

    ``cfg.wire_coalesced=False`` clears the recycled slots plane by plane
    (the JAX package's A/B form of the stacked fold, the same bits).

    ``cfg.chaos`` (a ``chaos.ChaosConfig``) flaps links: each round's link
    mask (``chaos.faults.round_link_ok``, keyed on the post-mutation overlay
    under ``dynamic_topo``) drops the whole link for the round, control and
    data, counted as ``LINK_DOWN`` over the live links, and first arrivals
    that rode the IWANT service count as ``IWANT_RECOVER``; a ``scheduled``
    config takes the ``link_deny`` row, and a GE generator advances the
    state's ``core.chaos`` chain (``GossipSubState.init`` builds it).

    ``cfg.queue_cap`` caps each link's messages a round (the overflow
    dropped and counted, congested links suppressing the next heartbeat's
    gossip toward them), and ``cfg.validation_delay_rounds`` (or
    ``validation_delay_topic``) runs the async-validation pipeline; the
    state carries its stages (``GossipSubState.init``).

    ``cfg.do_px`` runs peer exchange: PRUNEs carry PX, a peer pruned with
    PX by a pruner scored at or above ``accept_px_threshold`` activates its
    dormant edges to the pruner's mesh peers, and direct edges are redialed
    every ``direct_connect_ticks``; under it or ``cfg.edge_liveness`` every
    round reads the live edges ``nbr_ok & edge_live`` (the state's dormant
    edges: ``GossipSubState.init(..., dormant=...)``), the kernels' live
    words included. ``cfg.trace_exact`` keeps each round's duplicate
    arrivals in ``dup_trans``; ``cfg.narrow_counters`` the IHAVE counters
    as int16.

    On a banded dense net with K <= 16 the data plane is the two fused
    kernels, unless the queue cap, the pipeline, the chaos plane or the
    attack plane is on: as in the JAX package (its ``fused_eligible``),
    those configs take the XLA-path composites, as every other net does,
    and neither ``edge_exchange`` nor ``fused_delivery`` launches (under
    chaos and attack the shared delivery round still takes
    ``delivery_banded``). A CSR net's state stays CSR-resident between
    steps. The step is functional: it never writes into the state it is
    given.

    ``cfg.router`` (a ``routers.RouterConfig``) runs the router plane:
    IDONTWANT announcements from each round's first receipts suppress the
    mesh push toward the announcer (``IDONTWANT_SENT``, ``DUP_SUPPRESSED``),
    the heartbeat chokes late mesh links into lazy IHAVE-only links from a
    per-edge lateness EMA (``CHOKE``, ``UNCHOKE``), and with
    ``latency_rounds`` > 0 the data commits through the delayed-commit ring,
    each edge ``link_delay`` [N, K] int rounds later (required then, and
    only then, with values in [0, latency_rounds]: ``topo.link_delay_plane``;
    a device constant of the build). A router build takes the composites,
    as the JAX package's ``fused_eligible`` routes it: neither
    ``edge_exchange`` nor ``fused_delivery`` launches, and the suppression
    rides the edge mask, so the shared delivery round keeps
    ``delivery_banded`` on a banded net. It refuses ``dynamic_topo``."""
    if lift_scores and not cfg.score_enabled:
        raise ValueError("lift_scores=True needs cfg.score_enabled — the lifted plane "
                         "parameterizes the v1.1 score machinery")
    if telemetry is not None:
        telemetry.validate()
    if dynamic_topo:
        # each refused combination bakes neighbour identity or the banded
        # geometry into a build constant that a write could not update
        if not dynamic_peers:
            raise ValueError("dynamic_topo=True requires dynamic_peers=True — node "
                             "death/replacement rides the up_next plane")
        if net.band_off is not None or net.fused or cfg.fused:
            raise ValueError("dynamic_topo=True needs an unbanded net (Net.build(..., "
                             "dynamic=True)) — the banded/fused kernels bake the edge "
                             "geometry at build time")
        if net.edge_layout == "csr" and (
                not net.csr_identity or net.n_edges != net.n_peers * net.max_degree):
            raise ValueError("dynamic_topo=True on CSR needs the full-capacity identity "
                             "plane (Net.build(..., edge_layout='csr', dynamic=True)) — a "
                             "degree-compacted CSR cannot gain edges without a rebuild")
        if adversary is not None or adversary_no_forward is not None:
            raise ValueError("dynamic_topo=True is incompatible with the adversary planes "
                             "— their behaviour masks and neighbour views are constants "
                             "over the static topology")
        if sub_knowledge_holes is not None:
            raise ValueError("dynamic_topo=True is incompatible with sub_knowledge_holes "
                             "— the announce-hole mask is indexed by static (receiver, "
                             "slot) edge identity")
        if cfg.do_px or cfg.edge_liveness:
            raise ValueError("dynamic_topo=True is incompatible with do_px/edge_liveness "
                             "— the edge_live plane binds activation to static slot "
                             "identity; topology changes go through the mutation "
                             "schedule instead")
        from ..topo import dynamics as topo_dynamics
    router = cfg.router
    if router is not None:
        router.validate()
        if dynamic_topo:
            raise ValueError("cfg.router is incompatible with dynamic_topo — the link_delay "
                             "plane and the choke guard's edge views are static over the "
                             "build topology; mutate topology on a v1.1 build or rebuild "
                             "the router step")
    delay_c = None
    if router is not None and router.latency_rounds > 0:
        if link_delay is None:
            raise ValueError("cfg.router.latency_rounds > 0 needs the static link_delay "
                             "plane (make_gossipsub_step(..., link_delay=...) — see "
                             "topo.link_delay_plane)")
        link_delay = np.asarray(link_delay, np.int32)
        if link_delay.shape != tuple(net.nbr.shape):
            raise ValueError(f"link_delay shape {link_delay.shape} does not match the "
                             f"topology's [N, K] = {tuple(net.nbr.shape)}")
        if link_delay.min() < 0 or link_delay.max() > router.latency_rounds:
            raise ValueError(f"link_delay values must lie in [0, {router.latency_rounds}] "
                             f"(the ring depth); got [{link_delay.min()}, "
                             f"{link_delay.max()}]")
        delay_c = torch.as_tensor(link_delay, device=net.device)
    elif link_delay is not None:
        raise ValueError("link_delay given but cfg.router.latency_rounds == 0 — the delay "
                         "plane would be silently unread")
    consts = prepare_step_consts(cfg, net, score_params, heartbeat_interval, gater_params,
                                 adversary_no_forward, sub_knowledge_holes, dynamic_peers,
                                 adversary)
    cfg = flushed_thresholds(cfg)
    n_peers, k_dim = net.n_peers, net.max_degree
    adv = consts.adv

    # the chaos plane: None (or a disabled config) leaves every chaos branch
    # below out, so the round is the one without it, op for op
    chaos = chaos_faults.resolve(cfg.chaos)
    # the fused kernels hold a row's K first-arrival words in registers; a
    # wider banded net takes the composites, as every non-banded net does,
    # and so do the queue cap, the pipeline, the chaos, attack and router
    # planes, which the kernels predate (the JAX package's fused_eligible)
    banded = (net.band_off is not None and k_dim <= fr.MAX_K
              and cfg.validation_delay_rounds == 0 and cfg.queue_cap == 0
              and chaos is None and adv is None and router is None)
    # whether the round's live edges are the build's (the telemetry
    # recorder's divisions fold as the JAX program's constants then)
    static_live = not (dynamic_peers or dynamic_topo or tracks_liveness(cfg))
    opts = dict(count_events=cfg.count_events, queue_cap=cfg.queue_cap,
                val_delay_topic=cfg.validation_delay_topic)

    def banded_data_plane(net_l, st, st2, joined_words, slotw, acc_ok, acc_msg,
                          ihave_in_raw, nbr_score_of_me, valid_pack, thr):
        """IHAVE ingest first (it consumes nothing the delivery kernel
        writes), then the whole delivery plane in one fused_delivery launch
        over the post-graft mesh; under a lifted plane the kernel reads its
        (gossip, publish) threshold row from the device. Returns (st2, dlv,
        info)."""
        core = st.core
        tick = core.tick
        m = core.msgs.capacity
        w_dim = bitset.n_words(m)
        kw = k_dim * w_dim
        asked_old = st2.iwant_out
        served_lo_old, served_hi_old = st2.served_lo, st2.served_hi
        st2 = handle_ihave(cfg, net_l, st2, joined_words, acc_ok, ihave_in_raw, thr)

        carry = sender_carry_words(st2.mesh, slotw)
        if cfg.fanout_slots > 0:
            # the fanout push joins the mesh push in the kernel's carry
            carry = carry | fanout_carry_words(st2.fanout_peers, st2.fanout_topic,
                                               core.msgs.topic)
        origin_w = origin_msg_words(net_l, core.msgs)
        if cfg.flood_publish:
            # sender-side fold of v1.1 flood-publish (gossipsub.go:957-963)
            fp_ok = ((st.scores >= thr.publish_threshold)
                     if cfg.score_enabled else net_l.nbr_ok)
            carry = carry | torch.where(fp_ok[:, :, None], origin_w[:, None, :], 0)
        # the kernel gates every edge by F_LIVE, the static flood_from too
        flags = fr.make_flags(acc_msg, consts.flood_from, consts.i_am_floodsub,
                              consts.sender_fwd_full, net_l.nbr_ok)
        # the kernel's receiver exclusion (origin_w) masks the push and the
        # IWANT responses but not the retransmission counters, so blocked
        # messages join it: a blocked response still ticks its counter and
        # then dies at the wire, as in the composite
        block_w = wire_block_words(core.msgs)
        excl_w = origin_w if block_w is None else origin_w | block_w[None, :]
        mcw = bitset.word_or_reduce(st2.mcache, dim=1)
        if thr is cfg:
            thr_kw = dict(gossip_thr=cfg.gossip_threshold, publish_thr=cfg.publish_threshold)
        else:
            thr_kw = dict(thr_row=torch.stack([thr.gossip_threshold,
                                               thr.publish_threshold])[None])
        res = fr.fused_delivery(
            carry.reshape(n_peers, kw).contiguous(),
            core.dlv.fe_words.reshape(n_peers, kw),
            core.dlv.fwd, mcw, nbr_score_of_me,
            asked_old.reshape(n_peers, kw).contiguous(),
            served_lo_old.reshape(n_peers, kw),
            served_hi_old.reshape(n_peers, kw),
            flags, core.dlv.have, excl_w, joined_words.contiguous(),
            valid_pack[None, :], **thr_kw,
            offsets=net.band_off, revs=net.band_rev, w=w_dim,
            score_enabled=cfg.score_enabled,
            want_cohorts=cfg.count_events,
            retrans_cap=cfg.gossip_retransmission,
        )
        new_words = res["new"]
        new_bits = bitset.unpack(new_words, m)
        # first_round is stamped outside the kernel (it returns fresh
        # have/fwd/fe planes; the [N, M] stamp plane never enters it)
        dlv = replace(
            core.dlv,
            have=res["have"], fwd=res["fwd"],
            first_round=torch.where(new_bits, tick, core.dlv.first_round),
            fe_words=res["fe"].reshape(n_peers, k_dim, w_dim),
        )
        st2 = replace(
            st2,
            served_lo=res["served_lo"].reshape(n_peers, k_dim, w_dim),
            served_hi=res["served_hi"].reshape(n_peers, k_dim, w_dim),
        )
        if cfg.count_events:
            # cohort-split counters: RPCs count mesh-push and IWANT-response
            # transmissions separately even when they overlap
            n_rpc = (bitset.popcount(res["mesh_trans"]).sum(dtype=torch.int32)
                     + bitset.popcount(res["extra"]).sum(dtype=torch.int32))
            n_new = bitset.popcount(new_words).sum(dtype=torch.int32)
            n_deliver = bitset.popcount(new_words & valid_pack[None, :]).sum(
                dtype=torch.int32)
            n_reject = n_new - n_deliver
            n_duplicate = n_rpc - n_new
        else:
            n_rpc = n_new = n_deliver = n_reject = n_duplicate = 0
        info = RoundInfo(
            trans=res["trans"].reshape(n_peers, k_dim, w_dim),
            new_words=new_words, n_deliver=n_deliver, n_reject=n_reject,
            n_duplicate=n_duplicate, n_rpc=n_rpc,
        )
        return st2, dlv, info

    def composite_data_plane(net_l, net_w, flood_from_l, st, st2, joined_words, slotw,
                             acc_ok, acc_msg, ihave_in_raw, nbr_score_of_me, thr,
                             mesh_edge=None):
        """The JAX package's XLA path: IWANT service (last round's asks ->
        this round's carry), IHAVE ingest, the mesh/flood edge mask through
        the shared delivery_round, then the IWANT responses merged in.
        ``net_w`` is the wire view (the live view under the round's link
        mask): the IWANT window rides it, so a flapped link's responses are
        lost and its retransmission counters do not tick. ``mesh_edge``
        [N, K] (the post-ingest mesh's edges) is given on a router build,
        whose suppression masks and ring sit between the edge mask and the
        delivery round. Returns (st2, dlv, info, n_iwant_rec, n_adv_drop,
        n_dup_sup, inflight): with events counted, the valid first arrivals
        that rode the IWANT service under chaos, the attack plane's withheld
        bits and the router's suppressed ones (None without the plane), and
        the ring's next state (None without one)."""
        core = st.core
        st2, iwant_resp = iwant_responses(cfg, net_w, st2, nbr_score_of_me, thr=thr)
        st2 = handle_ihave(cfg, net_l, st2, joined_words, acc_ok, ihave_in_raw, thr)
        # floodsub-peer edges: sender floodsub => flood; receiver floodsub
        # => the gossipsub sender still sends everything, score-gated
        # (gossipsub.go:973-978)
        recv_ok = ((nbr_score_of_me >= thr.publish_threshold)
                   if cfg.score_enabled else net_l.nbr_ok)
        flood_edges = flood_from_l | (consts.i_am_floodsub[:, None]
                                      & recv_ok & net_l.nbr_ok)
        edge_mask = gossip_edge_mask(cfg, net_l, st2, joined_words, acc_msg, slotw,
                                     core.msgs, flood_edges, nbr_score_of_me, thr)
        if consts.sender_fwd_ok is not None:
            # edges from no-forward peers carry no data
            edge_mask = torch.where(consts.sender_fwd_ok[:, :, None], edge_mask, 0)
            iwant_resp = torch.where(consts.sender_fwd_ok[:, :, None], iwant_resp, 0)
        n_adv_drop = None
        if adv is not None and adv.data_plane:
            # drop-on-forward and censorship: edges from an active attacker
            # lose their bits, one mask on planes the round builds anyway
            edge_mask, rem_mask = adv.mask_transmit_nbr(core.tick, edge_mask, core.msgs)
            iwant_resp, rem_resp = adv.mask_transmit_nbr(core.tick, iwant_resp, core.msgs)
            if cfg.count_events:
                # withheld bits within the senders' forward sets; the IWANT
                # responses are serves, counted whole
                fwd_g = net_l.peer_gather(core.dlv.fwd)
                n_adv_drop = (bitset.popcount(rem_mask & fwd_g).sum(dtype=torch.int32)
                              + bitset.popcount(rem_resp).sum(dtype=torch.int32))
        n_dup_sup = ring_tx = inflight = None
        if router is not None:
            # receiver-side suppression: IDONTWANT and choke are ANDs on
            # the edge mask before the delivery round (receiver-indexed, as
            # the attack masks, so both layouts are covered alike)
            suppress = torch.zeros_like(edge_mask)
            if router.idontwant_eligible:
                suppress = suppress | dontwant_suppression(st.dontwant, mesh_edge)
            if router.choke:
                suppress = torch.where(choke_suppression(st2.choked)[:, :, None], bitset.ALL,
                                       suppress)
            removed = edge_mask & suppress
            edge_mask = edge_mask & ~suppress
            if cfg.count_events:
                # withheld bits within the senders' forward sets, as the
                # attack plane counts them
                fwd_g = net_l.peer_gather(core.dlv.fwd)
                n_dup_sup = bitset.popcount(removed & fwd_g).sum(dtype=torch.int32)
            if router.latency_rounds > 0:
                # store and forward: the sender's fwd window lasts one
                # round, so a delayed commit resolves against it and the
                # echo exclusion at send time and the ring carries the
                # resolved words; delay-0 edges keep the delivery round
                d0 = (delay_c == 0)[:, :, None]
                eager = torch.where(d0, 0, edge_mask & net_l.peer_gather(core.dlv.fwd)
                                    & ~net_l.edge_gather(core.dlv.fe_words))
                ring_tx, inflight = ring_commit(st.inflight, eager, delay_c)
                edge_mask = torch.where(d0, edge_mask, 0)
        dlv, info = delivery_round(net_l, core.msgs, core.dlv, edge_mask, core.tick, **opts)
        if ring_tx is not None:
            # the ring's arrivals land before the IWANT responses, so the
            # recovery count below stays IWANT-only
            dlv, info = merge_extra_tx(net_l, core.msgs, dlv, info, ring_tx, core.tick, **opts)
        iwant_resp = torch.where(acc_msg[:, :, None], iwant_resp, 0)
        have_pre_merge = dlv.have
        dlv, info = merge_extra_tx(net_l, core.msgs, dlv, info, iwant_resp, core.tick,
                                   **opts)
        n_iwant_rec = None
        if chaos is not None and cfg.count_events:
            # valid-plane membership read at arrival, as the duplicate
            # counter reads it
            n_iwant_rec = bitset.popcount(
                (dlv.have & ~have_pre_merge) & bitset.pack(core.msgs.valid)[None, :]
            ).sum(dtype=torch.int32)
        return st2, dlv, info, n_iwant_rec, n_adv_drop, n_dup_sup, inflight

    # net and consts are parameters of the round, not closure reads: a
    # dynamic-topology round rebinds both from the state's overlay
    def _round(st: GossipSubState, pub_origin, pub_topic, pub_valid, up_next=None,
               mut_writes=None, do_heartbeat: bool = True, score_plane=None,
               link_deny=None, *, net=net, consts=consts) -> GossipSubState:
        rp = round_params(cfg, net, consts, score_plane)
        if dynamic_topo:
            # the round's writes land first: the whole round runs on the
            # mutated topology
            topo1 = topo_dynamics.apply_mutation(st.core.topo, mut_writes)
            wr_edge = topo_dynamics.written_edge_mask(mut_writes, n_peers, k_dim)
            net = net.with_overlay(topo1)
            consts = rebind_step_consts(cfg, consts, net)
            st = clear_mutated_edges(cfg, st, wr_edge, rp.tp)
            st = replace(st, core=replace(st.core, topo=topo1))
        else:
            topo1 = None
        # the counters at the step's entry: the telemetry row's deltas cover
        # the whole step, peer transitions included
        ev_prev = st.core.events if telemetry is not None else None
        live = None
        if dynamic_peers:
            st, live = apply_peer_transitions(cfg, net, st, up_next, rp.tp)
        core = st.core
        tick = core.tick
        net_l, nbr_sub_l, flood_from_l, nbr_sub_words_l, live_u32 = live_step_views(
            cfg, net, st, consts, live)
        acc_ok, acc_msg = accept_gates(cfg, net_l, st, consts, gater_params, tick, rp.thr)

        # 0a. the chaos plane: this round's link outages. The whole link
        # (control and data, both directions) drops for the round, with no
        # cleanup at either end; ``net_w`` is the one-round-masked wire view
        # every receiver gather reads, and the data gate ``acc_msg`` (the
        # edge mask's and the IWANT responses') takes the mask too. Keyed on
        # the post-mutation overlay, so a rewired link re-keys at once.
        if chaos is not None:
            ge_bad0 = core.chaos.ge_bad if core.chaos is not None else None
            link_ok, ge_bad_next = chaos_faults.round_link_ok(
                chaos, chaos_faults.chaos_seed(core.key), net.nbr, tick, ge_bad0, link_deny,
                topo=topo1)
            net_w = replace(net_l, nbr_ok=net_l.nbr_ok & link_ok)
            acc_msg = acc_msg & link_ok
        else:
            net_w = net_l

        # 0b. merged wire exchange: every control outbox crosses the edge
        # involution at once, the score plane beside it
        cross = (functools.partial(banded_cross, net, live_u32, cfg.score_enabled) if banded
                 else functools.partial(gather_cross, net_w))
        graft_in_raw, prune_in_raw, ihave_in_raw, px_in_raw, nbr_score_of_me = (
            control_exchange(cfg, net_w, st, cross))

        # 1. GRAFT/PRUNE ingest, and PX connect
        st2, prune_resp, px_resp, px_ok, n_graft, n_prune = handle_graft_prune(
            cfg, net_l, st, rp.tp, acc_ok, graft_in_raw, prune_in_raw, px_in_raw,
            rp.thr, rp.msh)
        events = core.events
        if cfg.count_events:
            events = add_event(add_event(events, EV.GRAFT, n_graft),
                               EV.PRUNE, n_prune)
        # the choke guard at the GRAFT/PRUNE mutation site: the ingest may
        # have pruned an unchoked link, and the Dlo floor holds at every
        # round boundary
        if router is not None and router.choke:
            st2 = replace(st2, choked=choke_guard(rp.msh.Dlo, st2.mesh, st2.choked))
        edge_live_next = px_connect(cfg, net, net_l, st, px_ok, dynamic_peers)

        joined_words = joined_msg_words(net_l, core.msgs)
        slotw = slot_topic_words(net_l, core.msgs.topic)
        valid_pack = bitset.pack(core.msgs.valid)

        # 2-4. IWANT service, IHAVE ingest and delivery
        mesh_edge = st2.mesh.any(1) if router is not None else None
        if banded:
            st2, dlv, info = banded_data_plane(
                net_l, st, st2, joined_words, slotw, acc_ok, acc_msg, ihave_in_raw,
                nbr_score_of_me, valid_pack, rp.thr)
            n_iwant_rec = n_adv_drop = n_dup_sup = inflight = None
        else:
            st2, dlv, info, n_iwant_rec, n_adv_drop, n_dup_sup, inflight = (
                composite_data_plane(net_l, net_w, flood_from_l, st, st2, joined_words, slotw,
                                     acc_ok, acc_msg, ihave_in_raw, nbr_score_of_me, rp.thr,
                                     mesh_edge))

        # the exact-trace duplicate plane: arrivals beyond the first per
        # (peer, msg), before the throttle (its refusals are fresh receipts)
        dup_plane = None
        if cfg.trace_exact:
            dup_plane = info.trans & ~(dlv.fe_words & info.recv_new_words[:, None, :])

        # the choke signal: this round's per-edge lateness folded into the
        # EMA (arrivals before the throttle, the duplicate counter's cohort)
        choke_ema = None
        if router is not None and router.choke:
            choke_ema = choke_lateness_update(router, st2.choke_ema, info.trans,
                                              dlv.fe_words, info.new_words)

        # 4b. the validation front-end throttle (validation.go:230-244): it
        # rewrites the round's have, fwd, first_round and fe planes (the
        # pipeline's stages instead of fwd and first_round)
        accepted_new, n_throttled = info.new_words, None
        if cfg.validation_capacity > 0:
            dlv, info, accepted_new, n_throttled = apply_validation_throttle(
                dlv, info, cfg.validation_capacity, core.msgs.capacity, valid_pack)

        # 5. score delivery attribution (packed)
        score = st2.score
        if cfg.score_enabled:
            score = on_deliveries(
                score, net_l, st2.mesh, rp.tp, info.trans, info.new_words,
                dlv.fe_words, dlv.first_round, core.msgs.topic,
                core.msgs.valid, tick, rp.wrt,
                msg_ignored=core.msgs.ignored, slotw=slotw,
                pending_words=(bitset.word_or_reduce(dlv.pending, dim=1)
                               if dlv.pending is not None else None),
                recv_new_words=info.recv_new_words)

        # 5b. the gater's outcome counters (peer_gater.go:365-443)
        gater = st2.gater
        if cfg.gater_enabled:
            if n_throttled is None:
                n_throttled = torch.zeros((n_peers,), dtype=torch.int32, device=tick.device)
            dup, rej, ign = outcome_planes(info.trans, core.dlv.have, valid_pack,
                                           bitset.pack(core.msgs.ignored))
            gater = gater_outcomes(gater, dlv.fe_words, accepted_new, valid_pack, dup, rej,
                                   ign, bitset.popcount(accepted_new), n_throttled, tick)

        # 6. mcache put: validated new receipts in joined topics
        put = info.new_words & valid_pack[None, :] & joined_words
        mcache = st2.mcache.clone()
        mcache[:, 0, :] = mcache[:, 0, :] | put

        # 7. publishes + slot-recycle cleanup; the recycled-slot clear
        # precedes the origin's own mcache put (gossipsub.go:946)
        msgs, dlv, _slots, is_pub, keep_words, pub_words = allocate_publishes(
            core.msgs, dlv, tick, pub_origin, pub_topic, pub_valid,
            stacked_clears=cfg.wire_coalesced)
        mcache = mcache & keep_words
        mcache[:, 0, :] = mcache[:, 0, :] | pub_words
        # IHAVE outboxes were read by the far end this round
        ihave_out = torch.zeros_like(st2.ihave_out)
        if cfg.wire_coalesced:
            iwant_out, served_lo, served_hi = bitset.masked_keep(
                [st2.iwant_out, st2.served_lo, st2.served_hi], keep_words)
        else:
            iwant_out, served_lo, served_hi = (
                p & keep_words for p in (st2.iwant_out, st2.served_lo, st2.served_hi))
        promise_reused = bitset.bit_get((~keep_words)[None, None, :],
                                        st2.promise_mid)
        promise_mid = torch.where((st2.promise_mid >= 0) & promise_reused, -1,
                                  st2.promise_mid)

        # 7b. fanout slots for publishes to unjoined topics
        if cfg.fanout_slots > 0:
            fkey = prng.fold_in_rows(prng.fold_in_rows(core.key, tick), 0xFA40)
            sel = fanout_selections(cfg, net_l, st2.scores, pub_origin[None],
                                    pub_topic[None], nbr_sub_words_l, fkey, rp.thr,
                                    rp.msh)[0]
            st2 = update_fanout_on_publish(cfg, net_l, st2, pub_origin, pub_topic, sel, tick)

        # the router plane's roll: announcements accumulate at the round's
        # end from its post-throttle first receipts and are read next round
        # (the one-RTT latency of every outbox); every per-id and per-edge
        # router plane gets the keep-words recycle the mcache gets
        router_next = {}
        if router is not None:
            if router.idontwant_eligible:
                ann = dontwant_announcements(router, info.recv_new_words, joined_words)
                router_next["dontwant"] = (st.dontwant | ann) & keep_words
            if router.choke:
                router_next["choke_ema"] = choke_ema
            if router.latency_rounds > 0:
                router_next["inflight"] = ring_keep(inflight, keep_words)

        if cfg.count_events:
            events = accumulate_round_events(events, info,
                                             is_pub.sum(dtype=torch.int32))
            if router is not None:
                if router.idontwant_eligible:
                    events = add_event(events, EV.IDONTWANT_SENT,
                                       idontwant_sent_count(ann, mesh_edge))
                if n_dup_sup is not None:
                    events = add_event(events, EV.DUP_SUPPRESSED, n_dup_sup)
            if chaos is not None:
                # the live view's links, not the static topology's
                events = add_event(add_event(
                    events, EV.LINK_DOWN,
                    chaos_faults.count_links_down(net.nbr, net_l.nbr_ok, link_ok)),
                    EV.IWANT_RECOVER, n_iwant_rec)
            if n_adv_drop is not None:
                events = add_event(events, EV.ADV_DROP, n_adv_drop)
        core_next = replace(core, msgs=msgs, dlv=dlv, events=events)
        if chaos is not None and chaos.needs_state:
            core_next = replace(core_next, chaos=replace(core.chaos, ge_bad=ge_bad_next))
        st2 = replace(
            st2,
            core=core_next,
            mcache=mcache,
            ihave_out=ihave_out,
            iwant_out=iwant_out,
            served_lo=served_lo,
            served_hi=served_hi,
            promise_mid=promise_mid,
            graft_out=torch.zeros_like(st2.graft_out),
            prune_out=prune_resp,
            prune_px_out=px_resp,
            edge_live=edge_live_next,
            score=score,
            gater=gater,
            # not keep-masked: a dup bit names the message its slot held at
            # the arrival
            dup_trans=dup_plane,
            **router_next,
        )

        # congested links suppress this round's heartbeat gossip toward
        # them: a full writer queue drops the IHAVE batch, never retried
        # (gossipsub.go:1757-1764, :1155-1160)
        gossip_suppress = None
        if cfg.queue_cap > 0:
            sat_recv = bitset.popcount(info.trans) >= cfg.queue_cap
            gossip_suppress = net_l.edge_gather(sat_recv) & net_l.nbr_ok
            st2 = replace(st2, congested_in=sat_recv)

        # 8. heartbeat
        def hb(s):
            return heartbeat(cfg, net_l, s, rp.tp, rp.sc, nbr_sub_l,
                             gater_params, nbr_sub_words_l, consts.mesh_capable,
                             gossip_suppress, present_ok=net.nbr_ok, thr=rp.thr, msh=rp.msh,
                             adversary=adv)

        if cfg.heartbeat_every == 1:
            st2 = hb(st2)
        elif static_heartbeat:
            if do_heartbeat:
                st2 = hb(st2)
        else:
            due = (tick % cfg.heartbeat_every) == 0
            st2 = tree_map(lambda a, b: torch.where(due, a, b), hb(st2), st2)

        # the telemetry row: the step's last operation, after the
        # heartbeat's GRAFT/PRUNE accounting
        if telemetry is not None:
            core_f = st2.core
            telem = telemetry_panel.record_step(
                telemetry, core_f.telem, tick, ev_prev, core_f.events, net_l, core_f.msgs,
                core_f.dlv, mesh=st2.mesh, my_topics=net_l.my_topics, scores=st2.scores,
                backoff_active=st2.backoff_present & (st2.backoff_expire > tick),
                static_live=static_live)
            st2 = replace(st2, core=replace(core_f, telem=telem))
        return replace(st2, core=replace(st2.core, tick=tick + 1))

    if net.edge_layout == "csr":
        # CSR-resident state: the flat per-edge planes are densified at
        # entry and re-packed at exit; the body above stays dense-written
        _round = wrap_csr_resident(net, _round)

    # the JAX package's call forms: up_next, link_deny (a scheduled chaos
    # build) and mut_writes are required positionals in that order (a
    # default would silently run without churn, partitions or writes), and
    # a lifted step's plane comes last
    return step_form(_round, dynamic_peers=dynamic_peers,
                     chaos_sched=chaos is not None and chaos.scheduled,
                     dynamic_topo=dynamic_topo, lift_scores=lift_scores,
                     static_heartbeat=static_heartbeat and cfg.heartbeat_every > 1)


def step_form(body, *, dynamic_peers: bool, chaos_sched: bool, dynamic_topo: bool = False,
              lift_scores: bool = False, static_heartbeat: bool):
    """The call form of a step body ``body(st, pub_origin, pub_topic,
    pub_valid, up_next, mut_writes, do_heartbeat, score_plane, link_deny)``:

        step(st, pub_origin, pub_topic, pub_valid, *rows [, score_plane]
             [, *, do_heartbeat])

    ``rows`` are the build's per-dispatch rows in the JAX package's order,
    ``up_next`` (dynamic peers), ``link_deny`` (scheduled chaos),
    ``mut_writes`` (dynamic topology), each required; a lifted step takes
    its plane last; ``static_heartbeat`` makes ``do_heartbeat`` a required
    keyword. The step's ``rows`` attribute names its rows (the drivers read
    it to fill a scheduled step's deny row)."""
    rows = tuple(name for name, on in (("up_next", dynamic_peers), ("link_deny", chaos_sched),
                                      ("mut_writes", dynamic_topo)) if on)
    n_rest = len(rows) + int(lift_scores)

    def dispatch(st, pub_origin, pub_topic, pub_valid, rest, do_heartbeat=True):
        if len(rest) != n_rest:
            plane = " and the score plane" if lift_scores else ""
            raise TypeError(f"this step takes {len(rows)} row argument(s) {list(rows)}{plane} "
                            f"after the publishes, got {len(rest)}")
        got = dict(zip(rows, rest))
        return body(st, pub_origin, pub_topic, pub_valid, got.get("up_next"),
                    got.get("mut_writes"), do_heartbeat, rest[-1] if lift_scores else None,
                    got.get("link_deny"))

    if static_heartbeat:
        def step(st, pub_origin, pub_topic, pub_valid, *rest, do_heartbeat):
            return dispatch(st, pub_origin, pub_topic, pub_valid, rest, do_heartbeat)
    else:
        def step(st, pub_origin, pub_topic, pub_valid, *rest):
            return dispatch(st, pub_origin, pub_topic, pub_valid, rest)
    step.rows = rows
    return step
