"""Shared delivery observables and per-message word masks.

The transmit tensor ``trans[N, K, W]`` (packed words) is the round's wire
traffic; popcounts of it give the SendRPC/RecvRPC trace counters, and the
score engine consumes it for delivery attribution.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import bitset
from ..state import MsgTable, Net
from ..trace.events import EV, add_event


@dataclasses.dataclass
class RoundInfo:
    """Per-round delivery observables consumed by tracing and scoring."""

    trans: torch.Tensor        # [N, K, W] words transmitted to j on edge k
    new_words: torch.Tensor    # [N, W] first receipts this round
    n_deliver: torch.Tensor    # i32 receipts of valid messages
    n_reject: torch.Tensor     # i32 receipts of invalid messages
    n_duplicate: torch.Tensor  # i32 arrivals beyond the first
    n_rpc: torch.Tensor        # i32 total (edge, msg) transmissions


def member_msg_words(member: torch.Tensor, msg_topic: torch.Tensor) -> torch.Tensor:
    """[N, W] packed mask: messages whose topic satisfies member[n, topic]
    (padding topics (-1) match nothing) — a masked OR over the topics'
    message words."""
    topics = torch.arange(member.shape[1], dtype=torch.int32, device=msg_topic.device)
    tw = bitset.pack(msg_topic[None, :] == topics[:, None])  # [T, W]
    contrib = torch.where(member[:, :, None], tw[None, :, :], 0)
    return bitset.word_or_reduce(contrib, dim=1)


def subscribed_msg_words(net: Net, msgs: MsgTable) -> torch.Tensor:
    """[N, W] packed mask: messages whose topic peer n subscribes to."""
    return member_msg_words(net.subscribed, msgs.topic)


def origin_msg_words(net: Net, msgs: MsgTable) -> torch.Tensor:
    """[N, W] packed mask: messages peer n originated (never sent back to
    the origin, floodsub.go:87, gossipsub.go:1007) — an M-element scatter
    of single-bit words (distinct bits per (row, word), so add == or)."""
    n = net.n_peers
    m = msgs.capacity
    w = bitset.n_words(m)
    slot = torch.arange(m, dtype=torch.int64, device=msgs.origin.device)
    upd = torch.ones_like(slot) << (slot % 32)
    row = torch.where(msgs.origin >= 0, msgs.origin.long(), n)
    flat = torch.zeros(((n + 1) * w,), dtype=torch.int64, device=slot.device)
    flat = flat.index_add(0, row * w + slot // 32, upd)
    return bitset.to_word(flat[: n * w]).reshape(n, w)


def accumulate_round_events(events: torch.Tensor, info: RoundInfo,
                            n_publish) -> torch.Tensor:
    """Fold a round's delivery observables into the cumulative counters
    (the EventTracer accounting, trace_test.go:26-195)."""
    ev = add_event(events, EV.PUBLISH_MESSAGE, n_publish)
    ev = add_event(ev, EV.DELIVER_MESSAGE, info.n_deliver)
    ev = add_event(ev, EV.REJECT_MESSAGE, info.n_reject)
    ev = add_event(ev, EV.DUPLICATE_MESSAGE, info.n_duplicate)
    ev = add_event(ev, EV.SEND_RPC, info.n_rpc)
    return add_event(ev, EV.RECV_RPC, info.n_rpc)
