"""RandomSub router, vectorized (randomsub.go).

Reference semantics (randomsub.go:99-160): on each publish or forward, send
to max(RandomSubD = 6, ceil(sqrt(topic size))) random *gossip-capable* peers
subscribed to the topic, while peers speaking only /floodsub/1.0.0 always
receive (randomsub.go:107-116 splits the peer list before sampling).

Vector form: each sender draws a fresh random-k edge selection per topic
slot per round over its gossip-capable neighbours (one ``select_topk``
launch on the card, the size target as each row's k) and ORs in the
floodsub-only edges; the receivers read the sender-side outbox through the
edge involution, as the GossipSub mesh push does. The delivery round is the
shared core's (``models/common.delivery_round``): ``delivery_banded`` on a
banded dense net, ``csr_delivery`` on a CSR-resident state, the composites
elsewhere and under the queue cap or the validation pipeline. The chaos
plane's link mask and the attack plane's data masks fold into the edge
mask and keep the round's route; the telemetry panel's row is the round's
last operation.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng
from ..chaos import adversary as adversary_mod
from ..chaos import faults as chaos_faults
from ..ops.select import select_random_mask
from ..score.engine import slot_topic_words
from ..state import Net, SimState, allocate_publishes, replace
from ..telemetry import panel as telemetry_panel
from ..trace.events import EV, add_event
from .common import accumulate_round_events, delivery_round
from .gossipsub import gather_nbr_subscribed, joined_msg_words, sender_carry_words

RANDOMSUB_D = 6  # randomsub.go:17


def size_targets(net: Net, d: int = RANDOMSUB_D,
                 size_estimate: int | None = None) -> np.ndarray:
    """[T] int32 fanout targets max(d, ceil(sqrt(size))) (randomsub.go:
    124-131): ``size`` is ``size_estimate`` when given (the reference's
    static network-size parameter), else each topic's count of
    gossip-capable subscribers."""
    if size_estimate is not None:
        size = np.full((net.n_topics,), size_estimate, np.int64)
    else:
        gossip = (net.protocol >= 1).cpu().numpy()
        size = (net.subscribed.cpu().numpy() & gossip[:, None]).sum(0)
    return np.maximum(d, np.ceil(np.sqrt(size))).astype(np.int32)


def make_randomsub_step(net: Net, d: int = RANDOMSUB_D,
                        size_estimate: int | None = None,
                        queue_cap: int = 0,
                        stacked: bool = True,
                        chaos=None, telemetry=None, adversary=None,
                        lift_scores: bool = False):
    """Build the per-round RandomSub step for a fixed topology:

        step(state, pub_origin[P], pub_topic[P], pub_valid[P]
             [, link_deny[N, K]] [, score_plane]) -> state

    a plain function on tensors (``driver.make_window`` captures it as it
    captures FloodSub's). ``size_estimate`` sets every topic's size, as
    NewRandomSub's ``size`` does (randomsub.go:61-67); None sizes each
    topic by its gossip-capable subscribers. ``queue_cap`` is the
    outbound-queue budget and a state built with
    ``SimState.init(val_delay=...)`` runs the async-validation pipeline,
    both in the shared delivery core. ``stacked`` is the JAX package's A/B
    switch for its recycled-slot clears (one fold, or one op a plane: the
    same bits, ``state.allocate_publishes``). ``chaos`` (a
    ``chaos.ChaosConfig``) folds the round's link mask into the edge mask
    before the shared delivery round and counts ``LINK_DOWN``; a
    ``scheduled`` config makes the step take ``link_deny``, and a GE
    generator needs ``SimState.init(..., chaos_ge=True)``. With
    ``lift_scores=True`` the step takes a lifted score plane as its last
    positional and ignores it (RandomSub has no score machinery), so all
    four engines share the lifted call convention.

    ``adversary`` (a ``chaos.Adversary`` or ``AttackScenario``) runs the
    attack plane's data behaviours, drop-on-forward and censorship, masked
    into the edge mask from neighbour views built here once (the mesh and
    score behaviours have no RandomSub counterpart), with ``ADV_DROP``
    counted. ``telemetry`` (a ``telemetry.TelemetryConfig``; the state
    needs ``SimState.init(..., telemetry=)``) writes the round's panel row
    last, the mesh and score columns zero. None leaves either plane out."""
    chaos = chaos_faults.resolve(chaos)
    chaos_sched = chaos is not None and chaos.scheduled
    adv = adversary_mod.build_consts(adversary, net)
    target_t = size_targets(net, d, size_estimate)
    my_topics = net.my_topics.cpu().numpy()
    target_ns = torch.as_tensor(
        np.where(my_topics >= 0, target_t[np.clip(my_topics, 0, None)], 0),
        dtype=torch.int32, device=net.device)                        # [N, S]

    eligible = gather_nbr_subscribed(net)                            # [N, S, K]
    # the random draw samples gossip-capable peers only; floodsub-only
    # neighbours always receive (randomsub.go:107-116)
    fs_edge = (net.protocol[net.nbr.clamp(min=0).long()] == 0) & net.nbr_ok
    elig_random = eligible & ~fs_edge[:, None, :]
    always = eligible & fs_edge[:, None, :]
    # a floodsub-only sender runs the floodsub router: it forwards to every
    # subscribed neighbour (floodsub.go:76-100)
    i_am_floodsub = (net.protocol == 0)[:, None, None]

    def _round(st: SimState, pub_origin, pub_topic, pub_valid, link_deny=None) -> SimState:
        tick = st.tick
        # a fresh random fanout per sender, slot and round
        key = prng.fold_in(st.key, tick)
        sel = select_random_mask(key, elig_random, target_ns) | always
        sel = torch.where(i_am_floodsub, eligible, sel)
        carry_out = sender_carry_words(sel, slot_topic_words(net, st.msgs.topic))
        carried = torch.where(net.nbr_ok[:, :, None], net.edge_gather(carry_out), 0)
        edge_mask = carried & joined_msg_words(net, st.msgs)[:, None, :]
        if chaos is not None:
            ge_bad = st.chaos.ge_bad if st.chaos is not None else None
            link_ok, ge_bad_next = chaos_faults.round_link_ok(
                chaos, chaos_faults.chaos_seed(st.key), net.nbr, tick, ge_bad, link_deny)
            edge_mask = torch.where(link_ok[:, :, None], edge_mask, 0)
        n_adv_drop = None
        if adv is not None and adv.data_plane:
            edge_mask, removed = adv.mask_transmit_nbr(tick, edge_mask, st.msgs)
            n_adv_drop = adversary_mod.withheld_count(net, st.dlv.fwd, removed)
        dlv, info = delivery_round(net, st.msgs, st.dlv, edge_mask, tick,
                                   queue_cap=queue_cap)
        msgs, dlv, _slots, is_pub, _keep, _pw = allocate_publishes(
            st.msgs, dlv, tick, pub_origin, pub_topic, pub_valid, stacked_clears=stacked)
        events = accumulate_round_events(st.events, info, is_pub.sum(dtype=torch.int32))
        if chaos is not None:
            events = add_event(events, EV.LINK_DOWN,
                               chaos_faults.count_links_down(net.nbr, net.nbr_ok, link_ok))
            if chaos.needs_state:
                st = replace(st, chaos=replace(st.chaos, ge_bad=ge_bad_next))
        if n_adv_drop is not None:
            events = add_event(events, EV.ADV_DROP, n_adv_drop)
        telem = st.telem
        if telemetry is not None:
            telem = telemetry_panel.record_step(telemetry, telem, tick, st.events, events,
                                                net, msgs, dlv)
        return replace(st, tick=tick + 1, msgs=msgs, dlv=dlv, events=events, telem=telem)

    # the JAX package's call forms: link_deny is a required positional of a
    # scheduled build, and a lifted step's plane comes last (and is unused)
    if lift_scores:
        n_rest = int(chaos_sched) + 1

        def step(st, pub_origin, pub_topic, pub_valid, *rest):
            if len(rest) != n_rest:
                raise TypeError(f"a lifted RandomSub step takes {n_rest - 1} row argument(s) "
                                f"and the score plane after the publishes, got {len(rest)}")
            return _round(st, pub_origin, pub_topic, pub_valid,
                          rest[0] if chaos_sched else None)
        return step
    if chaos_sched:
        def step(st, pub_origin, pub_topic, pub_valid, link_deny):
            return _round(st, pub_origin, pub_topic, pub_valid, link_deny)
        return step

    def step(st, pub_origin, pub_topic, pub_valid):
        return _round(st, pub_origin, pub_topic, pub_valid)
    return step
