"""Carry a GossipSub state between the JAX package and the port.

Leaves are keyed by their STATE_SCHEMA.json path (``.core.dlv.have``,
``.score.bp``, ...) and held as numpy arrays with the JAX package's dtypes:
word planes are ``uint32`` (the port stores the same bits as int32) and
``.core.key`` is the key's two ``uint32`` words (its ``key_data``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.gossipsub import GossipSubState
from .score.engine import ScoreState
from .score.gater import GaterState
from .state import Delivery, MsgTable, SimState, resolve_device

#: packed 32-bit word planes (uint32 in the JAX package, int32 here)
WORD_LEAVES = frozenset({
    ".core.dlv.have", ".core.dlv.fwd", ".core.dlv.fe_words", ".mcache",
    ".ihave_out", ".iwant_out", ".served_lo", ".served_hi",
})
KEY_LEAF = ".core.key"

_NESTED = {
    "": GossipSubState,
    ".core": SimState,
    ".core.msgs": MsgTable,
    ".core.dlv": Delivery,
    ".score": ScoreState,
    ".gater": GaterState,
}


def _to_tensor(path: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if path == KEY_LEAF:
        return torch.as_tensor(a.astype(np.int64), device=device)
    if path in WORD_LEAVES:
        a = a.astype(np.uint32).view(np.int32)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def state_from_reference(leaves: dict, device=None) -> GossipSubState:
    """A port state from the JAX state's leaves (every schema path of the
    gossipsub manifest must be present)."""
    dev = resolve_device(device)

    def build(prefix):
        cls = _NESTED[prefix]
        kw = {}
        for f in dataclasses.fields(cls):
            p = f"{prefix}.{f.name}"
            kw[f.name] = build(p) if p in _NESTED else _to_tensor(p, leaves[p], dev)
        return cls(**kw)

    return build("")


def state_leaves(st: GossipSubState) -> dict:
    """The port state's leaves as numpy arrays with the JAX dtypes."""
    out = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            p = f"{prefix}.{f.name}"
            if dataclasses.is_dataclass(v):
                walk(v, p)
                continue
            a = v.detach().cpu().numpy()
            if p in WORD_LEAVES:
                a = a.view(np.uint32)
            elif p == KEY_LEAF:
                a = a.astype(np.uint32)
            out[p] = a

    walk(st, "")
    return out
