"""Multi-round phase engine: r delivery rounds per call, control once.

The reference runs continuous delivery against a 1 Hz maintenance
heartbeat (gossipsub.go:1278-1301): message hops are milliseconds apart
while GRAFT/PRUNE/IHAVE/IWANT and the score refresh run about a thousand
times less often. The per-round step (``models/gossipsub.py``) runs control
every hop; this step batches ``rounds_per_phase`` (r) delivery rounds into
one call the reference's way:

* the control head — the wire exchange, GRAFT/PRUNE and IHAVE ingest,
  IWANT service — runs once a phase, and the heartbeat at most once, at
  the phase tail;
* the data plane — publish allocation, mesh and flood push, seen-cache
  dedup, first-arrival attribution, mcache insertion — runs every
  sub-round, so per-hop delivery latency and the ``first_round`` stamps
  keep one-round resolution. The outbound-queue cap and the
  async-validation pipeline apply in every sub-round's commit
  (``common.finish_delivery``); the last sub-round's link saturation
  suppresses the tail heartbeat's gossip.

Each sub-round composes what every sender pushes on each edge and crosses
the edge involution once. Under the chaos plane the crossings keep this
route: the head's link mask joins its live words and each sub-round's mask
gates its crossing's output. So under the attack plane: the IWANT service
is masked receiver-side after the head's crossing, at the head's tick, and
each sub-round's data sender-side, on ``send`` before its crossing, at its
own tick; lie-in-IHAVE, graft spam and self-promotion change the control
words and the score column the head's crossing carries. On a banded net
with K <= ``fused_round.MAX_K`` both crossings are ``edge_exchange``
launches: the control head's words (``graft | prune | ihave [| px] |
mcache window``, the score plane beside them) once a phase, the data words
once a sub-round, each under the phase's live edges
(``gossipsub.live_step_views``: under PX or ``edge_liveness`` the dormant
edges are dead; PX connects at the head). Any other net, and a CSR net
(whose state stays CSR-resident between phases), crosses with
``Net.edge_gather``. The heartbeat's selections are ``select_topk``
launches on the card. The publish schedule is allocated at the phase head
(``state.PhasePubPlan``) and the score attribution is folded over the phase
in packed word planes (``_AccStack``): every (edge, msg) pair transmits at
most once a phase, so an OR keeps the exact transmission set, and the P3
window is gated per sub-round at each arrival's own tick. Under
``trace_exact`` a plane beside the stack, which recycled slots do not
clear, ORs each sub-round's duplicate arrivals into ``dup_trans``.

The JAX package's phase engine (``go_libp2p_pubsub_tpu/models/
gossipsub_phase.py``) is the reference, leaf for leaf; the telemetry
panel's row is a phase's last operation.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from .. import prng
from ..chaos import faults as chaos_faults
from ..ops import bitset
from ..ops import fused_round as fr
from ..score.engine import (
    apply_delivery_counts,
    on_deliveries,
    per_slot_counts,
    slot_topic_words,
)
from ..state import (
    PhasePubPlan,
    allocate_publishes,
    replace,
    wire_block_words,
    wrap_csr_resident,
)
from ..telemetry import panel as telemetry_panel
from ..trace.events import EV, add_event
from .common import RoundInfo, accumulate_round_events, finish_delivery, origin_msg_words
from .gossipsub import (
    GossipSubConfig,
    GossipSubState,
    accept_gates,
    apply_peer_transitions,
    apply_validation_throttle,
    banded_cross,
    control_exchange,
    control_exchange_coalesced,
    fanout_carry_words,
    fanout_selections,
    flushed_thresholds,
    gather_cross,
    gater_outcomes,
    handle_graft_prune,
    handle_ihave,
    heartbeat,
    iwant_responses,
    joined_msg_words,
    live_step_views,
    merge_extra_tx,
    outcome_planes,
    prepare_step_consts,
    px_connect,
    round_params,
    sender_carry_words,
    step_form,
    tracks_liveness,
    update_fanout_on_publish,
)


class PhaseAdmissionError(ValueError):
    """The phase's publish schedule can re-allocate a message slot within
    one phase (``rounds_per_phase * pub_width > msg_slots``), which breaks
    the exactness of the deferred recycled-slot clears. Cap admitted
    publishes (then pass ``admission_capped=True``), raise ``msg_slots``,
    or lower the publish rate."""


class _AccStack:
    """The phase's attribution accumulators. Stacked (the default), one
    ``[N, C, W]`` tensor: an ``[N, W]`` plane is one lane, an ``[N, K, W]``
    plane K lanes, and every sub-round ORs its update into the whole stack
    and ANDs the recycled-slot keep mask into it, one wide op each. With
    ``stacked=False`` (``cfg.wire_coalesced=False``) every plane is its own
    tensor with its own folds, the JAX package's per-plane A/B form; both
    run the same updates in the same order, to the same bits."""

    def __init__(self, specs, n: int, w: int, device, stacked: bool = True):
        self.offs = {}
        self.stacked = stacked
        off = 0
        for name, lanes in specs:
            self.offs[name] = (off, lanes)
            off += lanes
        if stacked:
            self.buf = (torch.zeros((n, off, w), dtype=torch.int32, device=device)
                        if off else None)
        else:
            self.planes = {name: torch.zeros((n, w) if lanes == 1 else (n, lanes, w),
                                             dtype=torch.int32, device=device)
                           for name, lanes in specs}

    def or_(self, updates: dict) -> None:
        """OR one sub-round's update of every lane in."""
        if not self.stacked:
            for name in self.planes:
                self.planes[name] = self.planes[name] | updates[name]
            return
        if self.buf is None:
            return
        n, _, w = self.buf.shape
        self.buf = self.buf | torch.cat(
            [updates[name].reshape(n, lanes, w) for name, (_, lanes) in self.offs.items()],
            dim=1)

    def keep(self, keep_w: torch.Tensor) -> None:
        """Clear recycled slots' columns in every lane."""
        if not self.stacked:
            for name in self.planes:
                self.planes[name] = self.planes[name] & keep_w
        elif self.buf is not None:
            self.buf = self.buf & keep_w

    def get(self, name: str, default=None):
        if name not in self.offs:
            return default
        if not self.stacked:
            return self.planes[name]
        off, lanes = self.offs[name]
        return self.buf[:, off] if lanes == 1 else self.buf[:, off:off + lanes]


def _weights_live(score_params, n_topics: int) -> tuple[bool, bool]:
    """(P3 live, P4 live): whether any scored topic weights the mesh-credit
    counter (P3, or the sticky P3b with a positive threshold) or the
    invalid-delivery counter (P4), as float32 values, the way the JAX
    package's static elision reads its parameter arrays."""
    f = np.float32
    topics = [p for t, p in score_params.topics.items() if 0 <= t < n_topics]
    p3 = any(f(p.mesh_message_deliveries_weight) != 0
             or (f(p.mesh_failure_penalty_weight) != 0
                 and f(p.mesh_message_deliveries_threshold) > 0) for p in topics)
    p4 = any(f(p.invalid_message_deliveries_weight) != 0 for p in topics)
    return p3, p4


def check_admission(r: int, pub_width: int, msg_slots: int) -> None:
    """Raise when a phase can re-allocate a slot within itself (r·P > M);
    warn when it can wipe in-flight receipts of a slot's previous message
    before the phase boundary sees them (r·P > M // 2)."""
    flat_cap = r * pub_width
    if flat_cap > msg_slots:
        raise PhaseAdmissionError(
            f"phase publish capacity rounds_per_phase*pub_width = {r}*{pub_width} = "
            f"{flat_cap} exceeds msg_slots = {msg_slots}: a slot can be re-allocated "
            "within one phase, which the deferred recycled-slot clears assume never "
            f"happens. Cap admitted publishes at {msg_slots // 2} a phase (then pass "
            "admission_capped=True), raise msg_slots, or lower the publish rate.")
    if flat_cap > msg_slots // 2:
        warnings.warn(
            f"phase publish capacity rounds_per_phase*pub_width = {r}*{pub_width} "
            f"exceeds msg_slots//2 = {msg_slots // 2}: slots recycled within a phase "
            "wipe in-flight receipts. Cap admitted publishes at "
            f"{msg_slots // 2} a phase, raise msg_slots, or lower the publish rate.",
            stacklevel=4)


def make_gossipsub_phase_step(cfg: GossipSubConfig, net, rounds_per_phase: int,
                              score_params=None, heartbeat_interval: float = 1.0,
                              gater_params=None, adversary_no_forward=None,
                              score_counts: bool | None = None,
                              exact_counters: bool = False,
                              admission_capped: bool = False, dynamic_peers: bool = False,
                              sub_knowledge_holes=None, lift_scores: bool = False,
                              telemetry=None, adversary=None):
    """Build the phase step for a fixed config and topology:

        step(state, pub_origin[r,P], pub_topic[r,P], pub_valid[r,P]
             [, up_next[N]] [, link_deny[N, K]] [, score_plane], *, do_heartbeat)
             -> state (tick advances by r)

    ``pub_*[i]`` is published at tick ``t + i``, as the per-round step
    would. ``do_heartbeat`` is required: the caller owns the schedule
    (``driver.heartbeat_schedule``); the heartbeat runs at the phase tail
    with the phase's last tick. ``pub_valid`` is bool (accept or reject)
    or ``state.VERDICT_*`` codes.

    The gater (``gater_params`` with ``cfg.gater_enabled``) draws its
    accept plane once a phase, at the head, and folds the phase's outcomes
    into its counters at the tail; the validation throttle
    (``cfg.validation_capacity``) runs every sub-round; fanout slots move
    at every sub-round's publishes. ``adversary_no_forward`` ([N] bool) marks
    peers that run the control plane but never transmit data: their rows
    of every sub-round's transmit composition and their IWANT service are
    zero.

    Attribution planes whose weights are zero for every topic are not
    carried (the JAX package's static elision: scores are bit-identical,
    the unread mmd/imd counters are not); ``exact_counters=True`` carries
    them all. With ``dynamic_peers=True`` the step takes one liveness row
    ``up_next`` [N] a phase: the peer transitions
    (``gossipsub.apply_peer_transitions``) land once, at the phase head, and
    the head's and every data sub-round's crossings read that phase's live
    edges. ``sub_knowledge_holes`` [N,K,T] hides unannounced subscriptions
    from mesh, gossip and fanout selection. ``admission_capped=True``
    certifies that the caller caps admitted publishes at ``msg_slots // 2``
    a phase and drops the admission check.

    ``lift_scores=True`` takes a lifted plane (``score.params``) as the last
    positional, as the per-round step does; a lifted build carries every
    attribution plane (a weight on the device cannot drive the build's
    elision). ``score_counts=True`` reduces each sub-round's arrivals to
    per-(peer, slot, edge) counts at arrival time and folds them into the
    counters at the tail (``score.engine.apply_delivery_counts``; a cap can
    bind up to r - 1 rounds late), instead of OR-folding word planes: it
    keeps the credit of slots recycled within the phase, which the plane
    path sheds. It is off under the validation pipeline, as in the JAX
    package. ``cfg.wire_coalesced=False`` is the JAX package's per-plane
    form, to the same bits: the per-round control exchange at the head
    (``edge_exchange`` over graft | prune | ihave [| px] on a banded net)
    and the IWANT window gathered apart, ``allocate_publishes`` every
    sub-round instead of the head's plan, the mcache put a sub-round, and
    the accumulators and the tail's clears plane by plane.

    ``cfg.chaos`` flaps links as the per-round step does, at the same
    cadence: the control head crosses under round tick0's link mask (ANDed
    into its live words, so a banded net keeps its one ``edge_exchange``),
    each data sub-round gates its crossing by its own round's mask, the GE
    chain advances once a sub-round, and ``LINK_DOWN`` and ``IWANT_RECOVER``
    are the phase's totals. A ``scheduled`` config takes one ``link_deny`` a
    phase (partitions land at phase heads, as peer transitions do).

    ``adversary`` (a ``chaos.Adversary``, or an ``AttackScenario`` built
    against ``net``) arms the attack plane as in the per-round step: an
    active drop_forward or censor attacker withholds its IWANT service
    (masked receiver-side at the head's tick) and its data (masked on its
    own rows of every sub-round's transmit composition, at that sub-round's
    tick), so a banded net keeps its 1 + r ``edge_exchange`` launches;
    ``ADV_DROP`` counts the withheld bits sender-side, an upper bound, as
    the JAX engine does. The heartbeat runs the control behaviours.
    ``telemetry`` (a ``telemetry.TelemetryConfig``; the state needs
    ``GossipSubState.init(..., telemetry=)``) writes one panel row a phase
    (``rounds_per_row = r``) as its last operation. A router build
    (``cfg.router``) raises ValueError, as in the JAX package: the router
    plane runs in the per-round step alone."""
    r = int(rounds_per_phase)
    if r < 1:
        raise ValueError(f"rounds_per_phase must be >= 1, got {r}")
    if telemetry is not None:
        telemetry.validate()
    if lift_scores and not cfg.score_enabled:
        raise ValueError("lift_scores=True needs cfg.score_enabled — the lifted plane "
                         "parameterizes the v1.1 score machinery")
    if cfg.router is not None:
        raise ValueError("the phase engine predates the router plane — IDONTWANT "
                         "suppression, choking and the latency ring hook the per-round "
                         "delivery composition; use make_gossipsub_step for router builds")
    consts = prepare_step_consts(cfg, net, score_params, heartbeat_interval, gater_params,
                                 adversary_no_forward, sub_knowledge_holes, dynamic_peers,
                                 adversary)
    adv = consts.adv
    adv_self = (torch.as_tensor(np.asarray(adversary_no_forward, bool), device=net.device)
                if adversary_no_forward is not None else None)
    # whether the phase's live edges are the build's (telemetry's divisions)
    static_live = not (dynamic_peers or tracks_liveness(cfg))
    cfg = flushed_thresholds(cfg)
    n_peers, k_dim = net.n_peers, net.max_degree
    banded = net.band_off is not None and k_dim <= fr.MAX_K
    # None (or a disabled config) leaves every chaos branch below out
    chaos = chaos_faults.resolve(cfg.chaos)
    if lift_scores:
        p3_live = p4_live = True
    elif cfg.score_enabled:
        p3_live, p4_live = _weights_live(score_params, net.n_topics)
    else:
        p3_live = p4_live = False
    p3_live, p4_live = p3_live or exact_counters, p4_live or exact_counters
    count_score = cfg.score_enabled and cfg.validation_delay_rounds == 0 and bool(score_counts)
    plane_score = cfg.score_enabled and not count_score
    coalesced = cfg.wire_coalesced
    scatter_alloc = n_peers >= 20_000
    opts = dict(count_events=cfg.count_events, queue_cap=cfg.queue_cap,
                val_delay_topic=cfg.validation_delay_topic)

    def cross_data(send, gate, live_u32):
        """A sub-round's data words across the edges, zero off ``gate``
        (which lies inside the live edges ``live_u32``): one edge_exchange
        launch on a banded net, else the composite gather."""
        if banded:
            w = send.shape[-1]
            wire, _ = fr.edge_exchange(
                send.reshape(n_peers, k_dim * w), None, live_u32,
                offsets=net.band_off, revs=net.band_rev, c=w, score_enabled=False)
            return torch.where(gate[:, :, None], wire.reshape(n_peers, k_dim, w), 0)
        return torch.where(gate[:, :, None], net.edge_gather(send), 0)

    def control_head(net_l, st, live_u32):
        """(graft_in_raw, prune_in_raw, ihave_in_raw, px_in_raw,
        nbr_score_of_me, window_g): the coalesced exchange, or the per-plane
        form's control exchange with the IWANT window left to
        ``iwant_responses`` (window_g None)."""
        if coalesced:
            return control_exchange_coalesced(cfg, net_l, st, live_u32)
        cross = (functools.partial(banded_cross, net, live_u32, cfg.score_enabled) if banded
                 else functools.partial(gather_cross, net_l))
        return (*control_exchange(cfg, net_l, st, cross), None)

    def _phase(st: GossipSubState, pub_origin, pub_topic, pub_valid, up_next,
               do_heartbeat: bool, score_plane=None, link_deny=None) -> GossipSubState:
        rp = round_params(cfg, net, consts, score_plane)
        thr, msh = rp.thr, rp.msh
        # the counters at the phase's entry: the telemetry row's deltas
        # cover the whole phase, peer transitions included
        ev_prev = st.core.events if telemetry is not None else None
        # the peer transitions land once a phase, at the head
        live = None
        if dynamic_peers:
            st, live = apply_peer_transitions(cfg, net, st, up_next, rp.tp)
        net_l, nbr_sub_l, flood_from_l, nbr_sub_words_l, live_u32 = live_step_views(
            cfg, net, st, consts, live)
        core = st.core
        tick0 = core.tick
        m = core.msgs.capacity
        w = bitset.n_words(m)
        dev = tick0.device
        if not admission_capped:
            check_admission(r, pub_origin.shape[-1], m)

        # ---- control head (once a phase) --------------------------------
        acc_ok, acc_msg = accept_gates(cfg, net_l, st, consts, gater_params, tick0, thr)

        # the chaos plane: the head crosses the wire once, at round tick0,
        # under that round's link mask (the wire view ``net_w``); each data
        # sub-round applies its own round's mask, and the GE chain advances
        # once a sub-round, the per-round engine's cadence. A scheduled
        # build's ``link_deny`` holds for the whole phase.
        if chaos is not None:
            seed = chaos_faults.chaos_seed(core.key)
            ge_bad = core.chaos.ge_bad if core.chaos is not None else None
            link_ok0, ge_bad = chaos_faults.round_link_ok(chaos, seed, net.nbr, tick0,
                                                          ge_bad, link_deny)
            net_w = replace(net_l, nbr_ok=net_l.nbr_ok & link_ok0)
            live_w_u32 = net_w.nbr_ok.to(torch.int32)
            n_link_down = (chaos_faults.count_links_down(net.nbr, net_l.nbr_ok, link_ok0)
                           if cfg.count_events else None)
        else:
            net_w, live_w_u32 = net_l, live_u32
        (graft_in_raw, prune_in_raw, ihave_in_raw, px_in_raw, nbr_score_of_me,
         window_g) = control_head(net_w, st, live_w_u32)
        st2, prune_resp, px_resp, px_ok, n_graft, n_prune = handle_graft_prune(
            cfg, net_l, st, rp.tp, acc_ok, graft_in_raw, prune_in_raw, px_in_raw, thr, msh)
        events = core.events
        if cfg.count_events:
            events = add_event(add_event(events, EV.GRAFT, n_graft), EV.PRUNE, n_prune)
        edge_live_next = px_connect(cfg, net, net_l, st, px_ok, dynamic_peers)
        # the IWANT window rides the wire view: a flapped link's responses
        # are lost and its retransmission counters do not tick
        st2, iwant_resp = iwant_responses(cfg, net_w, st2, nbr_score_of_me,
                                          window_g=window_g, thr=thr)
        st2 = handle_ihave(cfg, net_l, st2, joined_msg_words(net_l, core.msgs), acc_ok,
                           ihave_in_raw, thr)
        if consts.sender_fwd_ok is not None:
            # no-forward peers serve no IWANT either
            iwant_resp = torch.where(consts.sender_fwd_ok[:, :, None], iwant_resp, 0)
        n_adv_drop = None
        if adv is not None and adv.data_plane:
            # an active drop or censor attacker withholds its IWANT service
            # too: the responses ride sub-round 0, under the head's tick, and
            # are masked receiver-side after the head's crossing
            iwant_resp, rem_resp = adv.mask_transmit_nbr(tick0, iwant_resp, core.msgs)
            if cfg.count_events:
                n_adv_drop = bitset.popcount(rem_resp).sum(dtype=torch.int32)
        iwant_resp = torch.where(acc_msg[:, :, None], iwant_resp, 0)

        # phase-fixed data-plane constants: mesh, scores and accept gates
        # hold for the whole phase (the r-round control latency)
        mesh2 = st2.mesh
        nbr_ok = net_l.nbr_ok
        send_score_ok = (st.scores >= thr.publish_threshold) if cfg.score_enabled else nbr_ok
        # floodsub-semantics edges, sender side (floodsub.go:76-100,
        # gossipsub.go:973-978)
        flood_send = (consts.i_am_floodsub[:, None] & nbr_ok) | (flood_from_l & send_score_ok)
        flood_words = torch.where(flood_send[:, :, None], bitset.ALL, 0).to(torch.int32)
        recv_gate = nbr_ok & acc_msg

        # ---- data loop: r delivery sub-rounds ---------------------------
        msgs, dlv = core.msgs, core.dlv
        mcache = st2.mcache
        keep_acc = torch.full((w,), bitset.ALL, dtype=torch.int32, device=dev)
        # the attribution planes the phase tail reads: the JAX package's
        # accepted plane is always this "new" one (the verdict cohort, which
        # the throttle leaves as the accepted receipts), and its
        # fresh-receipt plane reaches no score of a phase
        specs = []
        if plane_score or cfg.gater_enabled:
            specs.append(("new", 1))
        if plane_score and p4_live:
            specs.append(("trans", k_dim))
        if plane_score and p3_live:
            specs.append(("mcw", k_dim))
        if cfg.gater_enabled:
            specs += [("dup", k_dim), ("rejw", k_dim), ("ignw", k_dim)]
            n_validated = torch.zeros((n_peers,), dtype=torch.int32, device=dev)
            n_throttled = torch.zeros((n_peers,), dtype=torch.int32, device=dev)
        accs = _AccStack(specs, n_peers, w, dev, stacked=coalesced)
        if count_score:
            zsc = torch.zeros((n_peers, net.n_slots, k_dim), dtype=torch.float32, device=dev)
            fmd_counts = mmd_counts = imd_counts = zsc
        # the exact-trace duplicate plane, beside the stack: recycled slots do
        # not clear it, since a dup bit names the message its slot held at
        # the arrival (slots outlive a phase under the admission cap)
        dupt = (torch.zeros((n_peers, k_dim, w), dtype=torch.int32, device=dev)
                if cfg.trace_exact else None)
        # fanout: the slots' topics, peers and last publishes move at every
        # sub-round's publishes
        fanout_st = st2
        if cfg.fanout_slots > 0:
            # every sub-round's fanout selection drawn at the head, each from
            # its own tick's key: the candidates read only static views and
            # the phase-fixed scores
            ticks = tick0 + torch.arange(r, dtype=torch.int32, device=dev)
            fkeys = prng.fold_in_rows(prng.fold_in_rows(core.key, ticks), 0xFA40)
            fsel = fanout_selections(cfg, net_l, st2.scores, pub_origin, pub_topic,
                                     nbr_sub_words_l, fkeys, thr, msh)
        if cfg.count_events:
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            cnt = dict(n_deliver=zero, n_reject=zero, n_duplicate=zero, n_rpc=zero,
                       n_drop=zero)
            n_pub = zero
        plan = (PhasePubPlan(msgs, n_peers, tick0, pub_origin, pub_topic, pub_valid)
                if coalesced else None)
        slotw = slot_topic_words(net_l, msgs.topic)
        joined_w = joined_msg_words(net_l, msgs)
        # the origin plane rides the loop: (origin & keep) | pub_words is the
        # next sub-round's origin_msg_words
        origin_w = origin_msg_words(net_l, msgs)
        warange = torch.arange(w, dtype=torch.int32, device=dev)
        topics = torch.arange(net.n_topics, dtype=torch.int32, device=dev)

        n_iwant_rec = None
        for i in range(r):
            tick_i = tick0 + i
            gate_i = recv_gate
            if chaos is not None:
                # this sub-round's link mask (round tick0's is the head's)
                if i == 0:
                    link_ok_i = link_ok0
                else:
                    link_ok_i, ge_bad = chaos_faults.round_link_ok(
                        chaos, seed, net.nbr, tick_i, ge_bad, link_deny)
                    if cfg.count_events:
                        n_link_down = n_link_down + chaos_faults.count_links_down(
                            net.nbr, net_l.nbr_ok, link_ok_i)
                gate_i = recv_gate & link_ok_i
            if plan is not None:
                msgs = plan.msgs_at(i)
                valid_w_i = plan.valid_words[i]
            else:
                valid_w_i = bitset.pack(msgs.valid)

            # sender-side transmit composition, one crossing a sub-round
            carry = sender_carry_words(mesh2, slotw) | flood_words
            if cfg.fanout_slots > 0:
                carry = carry | fanout_carry_words(
                    fanout_st.fanout_peers, fanout_st.fanout_topic, msgs.topic)
            if cfg.flood_publish:
                # v1.1 flood-publish, sender side (gossipsub.go:957-963)
                carry = carry | torch.where(send_score_ok[:, :, None],
                                            origin_w[:, None, :], 0)
            send = carry & dlv.fwd[:, None, :] & ~dlv.fe_words
            if adv_self is not None:
                # no-forward peers run control but never transmit data
                send = torch.where(adv_self[:, None, None], 0, send)
            if adv is not None and adv.data_plane:
                # active drop and censor attackers mask their own rows
                # before the sub-round's one crossing, under its own tick;
                # the removed bits count sender-side (an upper bound: the
                # receivers' gates apply after the crossing)
                send, rem_send = adv.mask_transmit_self(tick_i, send, msgs)
                if cfg.count_events:
                    n_adv_drop = n_adv_drop + bitset.popcount(rem_send).sum(dtype=torch.int32)
            trans = cross_data(send, gate_i, live_u32)
            nm = ~origin_w
            block_w = wire_block_words(msgs)
            if block_w is not None:
                # oversized messages cross no edge (gossipsub.go:1126-1140)
                nm = nm & ~block_w[None, :]
            trans = trans & (joined_w & nm)[:, None, :]

            pre_have = dlv.have if cfg.gater_enabled else None
            dlv, info = finish_delivery(net_l, msgs, dlv, trans, tick_i, **opts)
            if i == 0:
                # the head's IWANT responses ride the first sub-round
                have_pre_merge = dlv.have
                dlv, info = merge_extra_tx(net_l, msgs, dlv, info, iwant_resp, tick_i,
                                           **opts)
                if chaos is not None and cfg.count_events:
                    # first arrivals that rode the IWANT service
                    n_iwant_rec = bitset.popcount(
                        (dlv.have & ~have_pre_merge) & valid_w_i[None, :]
                    ).sum(dtype=torch.int32)
            if dupt is not None:
                # before the throttle, as in the per-round step
                dupt = dupt | (info.trans & ~(dlv.fe_words & info.recv_new_words[:, None, :]))
            if cfg.validation_capacity > 0:
                dlv, info, _accepted, n_thr = apply_validation_throttle(
                    dlv, info, cfg.validation_capacity, m, valid_w_i)

            # attribution: the count path reduces the arrivals now, the
            # plane path ORs them into the stack
            if count_score or (plane_score and p3_live):
                # the P3 window at this arrival's own tick (score.go:944-974)
                window = rp.wrt[msgs.topic.clamp(min=0).long()]
                within_i = bitset.pack((dlv.first_round >= 0)
                                       & ((tick_i - dlv.first_round) <= window[None, :]))
            upd = {}
            if "new" in accs.offs:
                upd["new"] = info.new_words
            if count_score:
                valid3 = valid_w_i[None, None, :]
                ign_i = bitset.pack(msgs.ignored)
                mmd_counts = mmd_counts + per_slot_counts(
                    info.trans & valid3 & within_i[:, None, :], slotw)
                fmd_counts = fmd_counts + per_slot_counts(
                    dlv.fe_words & info.new_words[:, None, :] & valid3, slotw)
                imd_counts = imd_counts + per_slot_counts(
                    info.trans & ~(valid_w_i | ign_i)[None, None, :], slotw)
            if plane_score and p4_live:
                upd["trans"] = info.trans
            if plane_score and p3_live:
                upd["mcw"] = info.trans & within_i[:, None, :]
                if dlv.pending is not None:
                    # duplicates arriving while the message sits in the
                    # pipeline (score.go:712-718); the fresh first arrival
                    # earns its credit at its verdict instead
                    pend_post = bitset.word_or_reduce(dlv.pending, dim=1)
                    fa_i = dlv.fe_words & info.recv_new_words[:, None, :]
                    upd["mcw"] = upd["mcw"] | (info.trans & pend_post[:, None, :] & ~fa_i)
            if cfg.gater_enabled:
                upd["dup"], upd["rejw"], upd["ignw"] = outcome_planes(
                    info.trans, pre_have, valid_w_i, bitset.pack(msgs.ignored))
                n_validated = n_validated + bitset.popcount(info.new_words)
                if cfg.validation_capacity > 0:
                    n_throttled = n_throttled + n_thr
            accs.or_(upd)
            if cfg.count_events:
                for name in cnt:
                    cnt[name] = cnt[name] + getattr(info, name)

            # mcache put: validated receipts in joined topics
            put = info.new_words & valid_w_i[None, :] & joined_w
            # this sub-round's publishes and recycled-slot clears
            if plan is not None:
                slots, is_pub = plan.sidx[i], plan.is_pub[i]
                keep_w, pub_words = plan.keep_w[i], plan.pub_words[i]
                dlv = plan.apply_to_delivery(dlv, i, tick_i)
                origin_w = (origin_w & keep_w) | pub_words
            else:
                mcache = torch.cat([mcache[:, :1] | put[:, None], mcache[:, 1:]], dim=1)
                msgs, dlv, slots, is_pub, keep_w, pub_words = allocate_publishes(
                    msgs, dlv, tick_i, pub_origin[i], pub_topic[i], pub_valid[i],
                    scatter_form=scatter_alloc, stacked_clears=False)
                origin_w = origin_msg_words(net_l, msgs)
            # the membership planes, incrementally, for every topic
            # universe (the JAX package recomputes them past 8 topics; the
            # words are the same): recycled columns clear, each publish ORs
            # its one-hot word column where the peer (or its slot) has the
            # publish's topic
            if coalesced:
                slotw, joined_w, mcache = bitset.masked_keep([slotw, joined_w, mcache], keep_w)
            else:
                slotw, joined_w = slotw & keep_w, joined_w & keep_w
            t_p = pub_topic[i].clamp(min=0)
            bit = bitset.to_word(
                torch.ones_like(slots, dtype=torch.int64) << (slots % bitset.WORD).long())
            colw = torch.where((warange[None, :] == slots[:, None] // bitset.WORD)
                               & is_pub[:, None], bit[:, None], 0)        # [P, W]
            sub_p = (net_l.subscribed[:, :, None]
                     & (topics[None, :, None] == t_p[None, None, :])).any(1)  # [N, P]
            joined_w = joined_w | bitset.word_or_reduce(
                torch.where(sub_p[:, :, None], colw[None], 0), dim=1)
            slot_match = net_l.my_topics[:, :, None] == t_p[None, None, :]  # [N, S, P]
            slotw = slotw | bitset.word_or_reduce(
                torch.where(slot_match[..., None], colw[None, None], 0), dim=2)
            if coalesced:
                # one window-0 update for the put and the publish stamps (the
                # clear above precedes the slot's new message)
                mcache = torch.cat([(mcache[:, :1] | (put & keep_w)[:, None]
                                     | pub_words[:, None]), mcache[:, 1:]], dim=1)
            else:
                mcache = mcache & keep_w
                mcache = torch.cat([mcache[:, :1] | pub_words[:, None], mcache[:, 1:]], dim=1)
            # iwant_out / served / promise clears defer to the tail: nothing
            # in the loop reads them, and the admission cap keeps a recycled
            # slot from being re-allocated within the phase
            keep_acc = keep_acc & keep_w
            accs.keep(keep_w)
            if cfg.count_events:
                n_pub = n_pub + is_pub.sum(dtype=torch.int32)
            if cfg.fanout_slots > 0:
                fanout_st = update_fanout_on_publish(
                    cfg, net_l, fanout_st, pub_origin[i], pub_topic[i], fsel[i], tick_i)

        # ---- phase tail (once) ------------------------------------------
        if plan is not None:
            msgs = plan.msgs_at(r)
            iwant_out, served_lo, served_hi = bitset.masked_keep(
                [st2.iwant_out, st2.served_lo, st2.served_hi], keep_acc)
        else:
            iwant_out, served_lo, served_hi = (
                p & keep_acc for p in (st2.iwant_out, st2.served_lo, st2.served_hi))
        promise_mid = st2.promise_mid
        promise_reused = bitset.bit_get((~keep_acc)[None, None, :], promise_mid)
        promise_mid = torch.where((promise_mid >= 0) & promise_reused, -1, promise_mid)
        tick_last = tick0 + (r - 1)
        score = st2.score
        if count_score:
            score = apply_delivery_counts(score, rp.tp, fmd_counts, mmd_counts, imd_counts,
                                          mesh2)
        elif plane_score:
            zkw = torch.zeros((n_peers, k_dim, w), dtype=torch.int32, device=dev)
            score = on_deliveries(
                score, net_l, mesh2, rp.tp, accs.get("trans", zkw), accs.get("new"),
                dlv.fe_words, dlv.first_round, msgs.topic, msgs.valid, tick_last, rp.wrt,
                msg_ignored=msgs.ignored, slotw=slot_topic_words(net_l, msgs.topic),
                mesh_credit_words=accs.get("mcw", zkw))
        gater = st2.gater
        if cfg.gater_enabled:
            gater = gater_outcomes(gater, dlv.fe_words, accs.get("new"),
                                   bitset.pack(msgs.valid), accs.get("dup"), accs.get("rejw"),
                                   accs.get("ignw"), n_validated, n_throttled, tick_last)
        if cfg.count_events:
            zw = torch.zeros((n_peers, w), dtype=torch.int32, device=dev)
            events = accumulate_round_events(
                events, RoundInfo(trans=zw, new_words=zw, **cnt), n_pub)
            if chaos is not None:
                events = add_event(add_event(events, EV.LINK_DOWN, n_link_down),
                                   EV.IWANT_RECOVER, n_iwant_rec)
            if n_adv_drop is not None:
                events = add_event(events, EV.ADV_DROP, n_adv_drop)

        core_next = replace(core, msgs=msgs, dlv=dlv, events=events, tick=tick_last)
        if chaos is not None and chaos.needs_state:
            core_next = replace(core_next, chaos=replace(core.chaos, ge_bad=ge_bad))
        st2 = replace(
            st2,
            core=core_next,
            mcache=mcache,
            ihave_out=torch.zeros_like(st2.ihave_out),
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
            fanout_topic=fanout_st.fanout_topic,
            fanout_peers=fanout_st.fanout_peers,
            fanout_lastpub=fanout_st.fanout_lastpub,
            dup_trans=dupt,
        )
        # the head's state rode the loop for its fanout planes only: let its
        # other planes go before the heartbeat
        del fanout_st
        # congested links suppress this heartbeat's gossip toward them: the
        # last sub-round's saturation, as in the per-round step
        gossip_suppress = None
        if cfg.queue_cap > 0:
            sat_recv = bitset.popcount(info.trans) >= cfg.queue_cap
            gossip_suppress = net_l.edge_gather(sat_recv) & net_l.nbr_ok
            st2 = replace(st2, congested_in=sat_recv)
        if do_heartbeat:
            st2 = heartbeat(cfg, net_l, st2, rp.tp, rp.sc, nbr_sub_l, gater_params,
                            nbr_sub_words_l, consts.mesh_capable, gossip_suppress,
                            present_ok=net.nbr_ok, thr=thr, msh=msh, adversary=adv)
        # the telemetry row: one a phase, the phase's last operation (after
        # the heartbeat's GRAFT/PRUNE accounting), at the phase tail's state
        if telemetry is not None:
            core_f = st2.core
            telem = telemetry_panel.record_step(
                telemetry, core_f.telem, tick0, ev_prev, core_f.events, net_l, core_f.msgs,
                core_f.dlv, rounds_per_row=r, mesh=st2.mesh, my_topics=net_l.my_topics,
                scores=st2.scores,
                backoff_active=st2.backoff_present & (st2.backoff_expire > tick_last),
                static_live=static_live)
            st2 = replace(st2, core=replace(core_f, telem=telem))
        return replace(st2, core=replace(st2.core, tick=tick0 + r))

    if net.edge_layout == "csr":
        # CSR-resident state: flat planes between phases, dense inside
        _phase = wrap_csr_resident(net, _phase)

    # the JAX package's call forms: up_next, then a scheduled build's one
    # link_deny a phase, each required, and a lifted step's plane last
    def body(st, pub_origin, pub_topic, pub_valid, up_next, _writes, do_heartbeat,
             score_plane, link_deny):
        return _phase(st, pub_origin, pub_topic, pub_valid, up_next, bool(do_heartbeat),
                      score_plane, link_deny)

    return step_form(body, dynamic_peers=dynamic_peers,
                     chaos_sched=chaos is not None and chaos.scheduled,
                     lift_scores=lift_scores, static_heartbeat=True)
