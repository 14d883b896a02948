"""GossipSub v1.2 IDONTWANT suppression (the port's copy of the JAX
package's ``routers/idontwant.py``).

On first receipt of a message larger than IDontWantMessageThreshold, a peer
sends IDONTWANT with the message id to its mesh peers; a peer holding an
IDONTWANT for an id skips forwarding that message to the announcer
(gossipsub.go handleIDontWant, the v1.2 spec).

The announcement plane ``dontwant`` [N, W] lives at the receiver, and the
delivery edge mask is receiver-indexed [N, K, W], so "the sender was told"
is a receiver-local word AND, with no gather. The one-RTT control latency
holds: ``dontwant`` is updated at the round's end from that round's
post-throttle new receipts and read the next round.

``dontwant`` is a subset of ``dlv.have`` by construction, so every
suppressed transmission would have been a duplicate: deliveries,
``first_round`` and ``fe_words`` equal the v1.1 run's, and only the RPC and
duplicate counters drop. The suppression applies on every mesh edge of the
announcer, not only the message topic's mesh edges: exact on single-topic
builds.
"""

from __future__ import annotations

import torch

from ..ops import bitset
from .config import RouterConfig


def dontwant_announcements(router: RouterConfig, recv_new_words: torch.Tensor,
                           joined_words: torch.Tensor) -> torch.Tensor:
    """[N, W] message-id bits this round's first receipts announce:
    ``recv_new_words`` (the round's post-throttle new receipts) in joined
    topics; none when the size gate makes no message eligible."""
    if not router.idontwant_eligible:
        return torch.zeros_like(recv_new_words)
    return recv_new_words & joined_words


def dontwant_suppression(dontwant: torch.Tensor, mesh_edge: torch.Tensor) -> torch.Tensor:
    """[N, K, W] words the sender on edge (i, k) withholds: the ids
    receiver i announced, on the edges of i's mesh (where it pushed the
    announcement)."""
    return torch.where(mesh_edge[:, :, None], dontwant[:, None, :], 0)


def idontwant_sent_count(ann: torch.Tensor, mesh_edge: torch.Tensor) -> torch.Tensor:
    """0-d int32: the round's announced-id pushes, one per (message, mesh
    neighbour) pair (the popcount of each announcement times the
    announcer's mesh degree)."""
    n_ids = bitset.popcount(ann)                        # [N]
    deg = mesh_edge.sum(-1, dtype=torch.int32)          # [N]
    return (n_ids * deg).sum(dtype=torch.int32)
