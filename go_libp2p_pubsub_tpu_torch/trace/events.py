"""Trace event schema: the protocol event codes of pb/trace.proto plus the
simulator's counter-only events, as integer codes for on-device counting.
Same names and order as the JAX package's ``trace/events.py``."""

from __future__ import annotations

import enum

import torch


class EV(enum.IntEnum):
    # pb/trace.proto TraceEvent.Type (trace.proto:9-24)
    PUBLISH_MESSAGE = 0
    REJECT_MESSAGE = 1
    DUPLICATE_MESSAGE = 2
    DELIVER_MESSAGE = 3
    ADD_PEER = 4
    REMOVE_PEER = 5
    RECV_RPC = 6
    SEND_RPC = 7
    DROP_RPC = 8
    JOIN = 9
    LEAVE = 10
    GRAFT = 11
    PRUNE = 12
    # counter-only events of the chaos, adversary and router planes
    LINK_DOWN = 13
    IWANT_RECOVER = 14
    ADV_DROP = 15
    ADV_IHAVE_LIE = 16
    ADV_GRAFT_SPAM = 17
    IDONTWANT_SENT = 18
    DUP_SUPPRESSED = 19
    CHOKE = 20
    UNCHOKE = 21


N_EVENTS = len(EV)

_NAMES = {e: e.name for e in EV}


def event_name(code: int) -> str:
    return _NAMES[EV(code)]


def zero_counters(device=None) -> torch.Tensor:
    """int32 cumulative counters, one per event code."""
    return torch.zeros((N_EVENTS,), dtype=torch.int32, device=device)


def add_event(events: torch.Tensor, ev: EV, value) -> torch.Tensor:
    """events with ``value`` (a 0-dim tensor or int) added at ``ev``."""
    out = events.clone()
    if isinstance(value, torch.Tensor):
        out[int(ev)] += value.to(device=events.device, dtype=torch.int32)
    else:
        out[int(ev)] += int(value)   # a host int: no copy to the device
    return out
