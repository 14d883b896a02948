"""Carry a state between the JAX package and the port: a GossipSub state
or the router-agnostic ``SimState`` FloodSub steps, dense or CSR-resident
(the same leaves; on a CSR net ``fe_words``, ``served_lo``/``served_hi``
are flat ``[E, W]`` and ``peerhave``/``iasked`` ``[E]``), with or without
the async-validation pipeline (``.dlv.pending``), the exact-trace
duplicate plane (``.dup_trans``) and the transmit block
(``.msgs.wire_block``), each a leaf only when the state has one,
on both sides, and the Gilbert–Elliott link-fault chain of a GE chaos
state (``.core.chaos``, ``ChaosState``) and the mutable overlay of a
dynamic-topology state (``.core.topo``, ``TopoState``), the telemetry
panel and flight recorder of a recording state (``.core.telem.panel``,
``.core.telem.flight``, ``TelemetryState``) and the router plane's leaves
(``.dontwant``, ``.choked``, ``.choke_ema`` and the latency ring
``.inflight``, flat ``[E, L, W]`` on a CSR net) likewise. Narrowed int16
counters keep their dtype both ways.

``score_plane_from_reference`` carries a lifted score plane the same way
(a JAX ``ScoreParams`` or ``CandidateParams``'s leaves, keyed ``.w2``,
``.score.w2``, ``.mesh.D``, ...), so both packages can run one plane.

Leaves are keyed by their STATE_SCHEMA.json path (``.core.dlv.have``,
``.score.bp``, ... for GossipSub; ``.dlv.have``, ``.msgs.origin``, ... for a
``SimState``) and held as numpy arrays with the JAX package's dtypes: word
planes are ``uint32`` (the port stores the same bits as int32) and the key
is its two ``uint32`` words (its ``key_data``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.gossipsub import GossipSubState
from .score.engine import ScoreState
from .score.gater import GaterState
from .score.params import CandidateParams, MeshParams, ScoreParams
from .state import ChaosState, Delivery, MsgTable, SimState, TopoState, resolve_device
from .telemetry.panel import TelemetryState

#: packed 32-bit word planes (uint32 in the JAX package, int32 here)
_SIM_WORDS = (".dlv.have", ".dlv.fwd", ".dlv.fe_words", ".dlv.pending")
WORD_LEAVES = frozenset({
    *_SIM_WORDS, *(".core" + p for p in _SIM_WORDS), ".mcache",
    ".ihave_out", ".iwant_out", ".served_lo", ".served_hi", ".dup_trans",
    ".dontwant", ".inflight",
})
KEY_LEAVES = frozenset({".key", ".core.key"})
#: leaves a state may lack (None): the pipeline's stages, the exact-trace
#: duplicate plane, the transmit block, the flight recorder and the router
#: plane's four
OPTIONAL_LEAVES = frozenset({".dlv.pending", ".core.dlv.pending", ".dup_trans",
                             ".msgs.wire_block", ".core.msgs.wire_block",
                             ".telem.flight", ".core.telem.flight",
                             ".dontwant", ".choked", ".choke_ema", ".inflight"})
#: nested states a state may lack (None): the GE chain, the telemetry panel
#: and the mutable overlay
OPTIONAL_NESTED = frozenset({".chaos", ".core.chaos", ".telem", ".core.telem",
                             ".topo", ".core.topo"})

_SIM_NESTED = {"": SimState, ".msgs": MsgTable, ".dlv": Delivery, ".chaos": ChaosState,
               ".telem": TelemetryState, ".topo": TopoState}
_NESTED = {
    "": GossipSubState,
    **{".core" + p: cls for p, cls in _SIM_NESTED.items()},
    ".score": ScoreState,
    ".gater": GaterState,
}


def _to_tensor(path: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if path in KEY_LEAVES:
        return torch.as_tensor(a.astype(np.int64), device=device)
    if path in WORD_LEAVES:
        a = a.astype(np.uint32).view(np.int32)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def state_from_reference(leaves: dict, device=None):
    """A port state from the JAX state's leaves: a ``GossipSubState`` when
    they are a GossipSub state's (``.core.*`` paths), else a ``SimState``.
    Every field must be present but an ``OPTIONAL_LEAVES`` or
    ``OPTIONAL_NESTED`` one, which is None when absent."""
    dev = resolve_device(device)
    nested = _NESTED if any(p.startswith(".core.") for p in leaves) else _SIM_NESTED

    def build(prefix):
        cls = nested[prefix]
        kw = {}
        for f in dataclasses.fields(cls):
            p = f"{prefix}.{f.name}"
            if p in OPTIONAL_NESTED and not any(q.startswith(p + ".") for q in leaves):
                kw[f.name] = None
            elif p in nested:
                kw[f.name] = build(p)
            elif p in OPTIONAL_LEAVES and p not in leaves:
                kw[f.name] = None
            else:
                kw[f.name] = _to_tensor(p, leaves[p], dev)
        return cls(**kw)

    return build("")


def _walk(obj, prefix: str = ""):
    """(path, tensor) of every leaf of a port state, in dataclass field
    order, nested states in place, None leaves and absent nested states
    skipped: the JAX tree's flatten order."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        p = f"{prefix}.{f.name}"
        if dataclasses.is_dataclass(v):
            yield from _walk(v, p)
        elif v is not None:
            yield p, v


def _reference_dtype(path: str, t: torch.Tensor) -> np.dtype:
    """The JAX package's dtype of the leaf at ``path`` (``uint32`` for a
    word plane and for the key's words)."""
    if path in WORD_LEAVES or path in KEY_LEAVES:
        return np.dtype(np.uint32)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def leaf_specs(st) -> dict:
    """{path: (shape, JAX dtype)} of a port state's leaves, in the JAX
    tree's order, without a copy to the host."""
    return {p: (tuple(v.shape), _reference_dtype(p, v)) for p, v in _walk(st)}


def state_leaves(st) -> dict:
    """The port state's leaves as numpy arrays with the JAX dtypes, in the
    JAX tree's order (a None leaf has no entry, as in a JAX tree)."""
    out = {}
    for p, v in _walk(st):
        a = v.detach().cpu().numpy()
        if p in WORD_LEAVES:
            a = a.view(np.uint32)
        elif p in KEY_LEAVES:
            a = a.astype(np.uint32)
        out[p] = a
    return out


def score_plane_from_reference(leaves: dict, device=None, app_specific_weight: float = 0.0):
    """The port's lifted plane from a JAX plane's leaves (``{".w2": array,
    ...}`` of a ``ScoreParams``, ``{".score.w2": ..., ".mesh.D": ...}`` of
    a ``CandidateParams``), with the JAX dtypes kept. ``app_specific_weight``
    is the plane's host weight, which rides the JAX plane as static data,
    not as a leaf."""
    dev = resolve_device(device)

    def build(cls, prefix, **extra):
        kw = {f.name: torch.as_tensor(np.array(leaves[f"{prefix}.{f.name}"], copy=True),
                                      device=dev)
              for f in dataclasses.fields(cls) if f.name not in extra}
        return cls(**kw, **extra)

    def score(prefix):
        return build(ScoreParams, prefix, app_specific_weight=float(app_specific_weight))

    if any(p.startswith(".mesh.") for p in leaves):
        return CandidateParams(score=score(".score"), mesh=build(MeshParams, ".mesh"))
    return score("")


def plane_leaves(plane) -> dict:
    """A port plane's leaves as numpy arrays, keyed as
    ``score_plane_from_reference`` takes them."""
    out = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                walk(v, f"{prefix}.{f.name}")
            elif isinstance(v, torch.Tensor):
                out[f"{prefix}.{f.name}"] = v.detach().cpu().numpy()

    walk(plane, "")
    return out
