"""FloodSub router, vectorized (floodsub.go, proto /floodsub/1.0.0).

Reference semantics (floodsub.go:76-100 Publish): forward each message to
every connected peer subscribed to its topic, except the peer it came from
and the origin. Dedup is the seen-cache. No mesh, no gossip, no scoring.

Vector form: the edge-carry mask is "receiver subscribes to the topic" —
one packed word-mask per receiver, broadcast over its edges; the shared
delivery engine (``models/common.delivery_round``) applies the source and
origin exclusions and dedup. The step inherits the Net's edge layout
through that seam: on CUDA a banded dense Net runs the ``delivery_banded``
kernel and a CSR-resident state (``SimState.init(..., n_edges=net.n_edges)``)
the ``csr_delivery`` kernel; other dense topologies, a CSR Net with a
dense-resident state, and any round under the queue cap or the validation
pipeline run the plain composites, as in the reference. The chaos plane's
link mask folds into the edge mask and keeps the round's route.
"""

from __future__ import annotations

import torch

from ..chaos import faults as chaos_faults
from ..state import Net, SimState, allocate_publishes, replace
from ..trace.events import EV, add_event
from .common import accumulate_round_events, delivery_round, subscribed_msg_words


def flood_edge_mask(net: Net, msgs) -> torch.Tensor:
    """[N, K, W]: every edge may carry everything its *receiver* subscribes
    to (the sender-side topics-map check of floodsub.go:77-84 seen from the
    receiving end). A broadcast view: nothing is copied per edge."""
    sub_words = subscribed_msg_words(net, msgs)  # [N, W]
    return sub_words[:, None, :].expand(net.n_peers, net.max_degree, sub_words.shape[-1])


def floodsub_step(net: Net, state: SimState, pub_origin: torch.Tensor,
                  pub_topic: torch.Tensor, pub_valid: torch.Tensor,
                  queue_cap: int = 0, stacked: bool = True, chaos=None, link_deny=None,
                  telemetry=None, adversary=None, score_plane=None) -> SimState:
    """One synchronous round: deliver in-flight messages one hop, then
    intern this round's publishes ([P] origins with -1 padding, topics,
    bool verdicts); they start propagating next round. Functional: the
    given state is not written. The parameters follow the JAX package's
    order, so a positional call written for it lands each in its place.

    The outbound-queue cap and the async-validation pipeline live below
    the router in the reference, so they apply here as in GossipSub:
    ``queue_cap`` > 0 drops (and counts) each link's overflow, and a state
    built with ``SimState.init(val_delay=...)`` runs the pipeline. Either
    takes the delivery composites, not the kernels (``common.py``).
    ``stacked`` picks the recycled-slot clears' form (one fold, or one op a
    plane: the JAX package's A/B switch, the same bits).

    ``chaos`` (a ``chaos.ChaosConfig``) flaps links below the router: the
    round's link mask is ANDed into the edge mask before the shared delivery
    round, so the round keeps its kernel route, and ``LINK_DOWN`` counts the
    undirected live links down. A ``scheduled`` config takes ``link_deny``
    ([N, K] bool, True = down); a GE generator needs
    ``SimState.init(..., chaos_ge=True)``. None or a disabled config runs the
    round without the plane. ``score_plane`` (a lifted score plane) is
    taken and unused: FloodSub has no score machinery, and the seam keeps
    the four engines' lifted call convention one. The telemetry and
    adversary planes raise ``NotImplementedError``."""
    unported = [
        (telemetry is not None, "telemetry (the per-round panel) — ROADMAP §1 item 5.3"),
        (adversary is not None, "adversary (the attack plane) — ROADMAP §1 item 5.2"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"floodsub_step: not ported yet: {what}")
    chaos = chaos_faults.resolve(chaos)
    edge_mask = flood_edge_mask(net, state.msgs)
    if chaos is not None:
        ge_bad = state.chaos.ge_bad if state.chaos is not None else None
        link_ok, ge_bad_next = chaos_faults.round_link_ok(
            chaos, chaos_faults.chaos_seed(state.key), net.nbr, state.tick, ge_bad, link_deny)
        edge_mask = torch.where(link_ok[:, :, None], edge_mask, 0)
    dlv, info = delivery_round(net, state.msgs, state.dlv, edge_mask, state.tick,
                               queue_cap=queue_cap)
    msgs, dlv, _slots, is_pub, _keep, _pub_words = allocate_publishes(
        state.msgs, dlv, state.tick, pub_origin, pub_topic, pub_valid,
        stacked_clears=stacked)
    events = accumulate_round_events(state.events, info, is_pub.sum(dtype=torch.int32))
    if chaos is not None:
        events = add_event(events, EV.LINK_DOWN,
                           chaos_faults.count_links_down(net.nbr, net.nbr_ok, link_ok))
        if chaos.needs_state:
            state = replace(state, chaos=replace(state.chaos, ge_bad=ge_bad_next))
    return replace(state, tick=state.tick + 1, msgs=msgs, dlv=dlv, events=events)


def run_rounds(net: Net, state: SimState, n_rounds: int) -> SimState:
    """Run delivery-only rounds (no new publishes)."""
    dev = state.tick.device
    p = torch.full((1,), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros((1,), dtype=torch.bool, device=dev)
    for _ in range(n_rounds):
        state = floodsub_step(net, state, p, p, valid)
    return state
