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
pipeline run the plain composites, as in the reference.
"""

from __future__ import annotations

import torch

from ..state import Net, SimState, allocate_publishes, replace
from .common import accumulate_round_events, delivery_round, subscribed_msg_words


def flood_edge_mask(net: Net, msgs) -> torch.Tensor:
    """[N, K, W]: every edge may carry everything its *receiver* subscribes
    to (the sender-side topics-map check of floodsub.go:77-84 seen from the
    receiving end). A broadcast view: nothing is copied per edge."""
    sub_words = subscribed_msg_words(net, msgs)  # [N, W]
    return sub_words[:, None, :].expand(net.n_peers, net.max_degree, sub_words.shape[-1])


def floodsub_step(net: Net, state: SimState, pub_origin: torch.Tensor,
                  pub_topic: torch.Tensor, pub_valid: torch.Tensor,
                  queue_cap: int = 0, chaos=None, link_deny=None,
                  telemetry=None, adversary=None, score_plane=None) -> SimState:
    """One synchronous round: deliver in-flight messages one hop, then
    intern this round's publishes ([P] origins with -1 padding, topics,
    bool verdicts); they start propagating next round. Functional: the
    given state is not written.

    The outbound-queue cap and the async-validation pipeline live below
    the router in the reference, so they apply here as in GossipSub:
    ``queue_cap`` > 0 drops (and counts) each link's overflow, and a state
    built with ``SimState.init(val_delay=...)`` runs the pipeline. Either
    takes the delivery composites, not the kernels (``common.py``).
    ``score_plane`` (a lifted score plane) is taken and unused: FloodSub has
    no score machinery, and the seam keeps the four engines' lifted call
    convention one. The chaos, telemetry and adversary planes raise
    ``NotImplementedError``."""
    unported = [
        (chaos is not None or link_deny is not None,
         "chaos (link-fault injection) — ROADMAP §1 item 5"),
        (telemetry is not None, "telemetry (the per-round panel) — ROADMAP §1 item 5"),
        (adversary is not None, "adversary (the attack plane) — ROADMAP §1 item 5"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"floodsub_step: not ported yet: {what}")
    edge_mask = flood_edge_mask(net, state.msgs)
    dlv, info = delivery_round(net, state.msgs, state.dlv, edge_mask, state.tick,
                               queue_cap=queue_cap)
    msgs, dlv, _slots, is_pub, _keep, _pub_words = allocate_publishes(
        state.msgs, dlv, state.tick, pub_origin, pub_topic, pub_valid)
    events = accumulate_round_events(state.events, info, is_pub.sum(dtype=torch.int32))
    return replace(state, tick=state.tick + 1, msgs=msgs, dlv=dlv, events=events)


def run_rounds(net: Net, state: SimState, n_rounds: int) -> SimState:
    """Run delivery-only rounds (no new publishes)."""
    dev = state.tick.device
    p = torch.full((1,), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros((1,), dtype=torch.bool, device=dev)
    for _ in range(n_rounds):
        state = floodsub_step(net, state, p, p, valid)
    return state
