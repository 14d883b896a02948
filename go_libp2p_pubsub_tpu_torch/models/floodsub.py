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
link mask and the attack plane's data masks fold into the edge mask and
keep the round's route; the telemetry panel's row is the round's last
operation.
"""

from __future__ import annotations

import torch

from ..chaos import adversary as adversary_mod
from ..chaos import faults as chaos_faults
from ..state import Net, SimState, allocate_publishes, replace
from ..telemetry import panel as telemetry_panel
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
    the four engines' lifted call convention one.

    ``adversary`` (a ``chaos.Adversary`` or ``AttackScenario``, whose device
    constants are built at every call as the reference builds them from its
    traced net, or an ``adversary.AdversaryConsts`` built once over this
    net, which a window needs: ``build_floodsub``'s step passes one) runs
    the attack plane's data behaviours, drop-on-forward and censorship (the
    mesh and score behaviours have no FloodSub counterpart): edges from an
    active attacker lose their bits before the shared delivery round, which
    keeps its route, and ``ADV_DROP`` counts the withheld bits within the
    senders' forward sets. ``telemetry`` (a ``telemetry.TelemetryConfig``;
    the state needs ``SimState.init(..., telemetry=)``) writes the round's
    panel row last, the mesh and score columns zero. None leaves either
    plane out."""
    chaos = chaos_faults.resolve(chaos)
    adv = adversary_mod.build_consts(adversary, net)
    edge_mask = flood_edge_mask(net, state.msgs)
    if chaos is not None:
        ge_bad = state.chaos.ge_bad if state.chaos is not None else None
        link_ok, ge_bad_next = chaos_faults.round_link_ok(
            chaos, chaos_faults.chaos_seed(state.key), net.nbr, state.tick, ge_bad, link_deny)
        edge_mask = torch.where(link_ok[:, :, None], edge_mask, 0)
    n_adv_drop = None
    if adv is not None and adv.data_plane:
        edge_mask, removed = adv.mask_transmit_nbr(state.tick, edge_mask, state.msgs)
        n_adv_drop = adversary_mod.withheld_count(net, state.dlv.fwd, removed)
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
    if n_adv_drop is not None:
        events = add_event(events, EV.ADV_DROP, n_adv_drop)
    telem = state.telem
    if telemetry is not None:
        # the JAX step takes its net as a traced argument: no net plane is
        # a build constant there
        telem = telemetry_panel.record_step(telemetry, telem, state.tick, state.events, events,
                                            net, msgs, dlv, static_live=False)
    return replace(state, tick=state.tick + 1, msgs=msgs, dlv=dlv, events=events, telem=telem)


def run_rounds(net: Net, state: SimState, n_rounds: int) -> SimState:
    """Run delivery-only rounds (no new publishes)."""
    dev = state.tick.device
    p = torch.full((1,), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros((1,), dtype=torch.bool, device=dev)
    for _ in range(n_rounds):
        state = floodsub_step(net, state, p, p, valid)
    return state
