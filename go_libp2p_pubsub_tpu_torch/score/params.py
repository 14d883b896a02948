"""The lifted score plane: score and mesh parameters as device tensors.

A static build reads every score weight, threshold and mesh degree as a
Python number fixed at build time (``GossipSubConfig``'s fields,
``TopicParamsArrays`` rows, ``PeerScoreParams`` scalars). A lifted build
(``lift_scores=True`` in every engine) reads them from a plane passed to
each step call instead, so one built step, and one captured window on the
card (``driver.make_window``'s ``consts``), runs any weight set: a replay
under another plane copies the plane's leaves into the window's buffers
and captures nothing new.

* :class:`ScoreParams` — the ``[T]`` per-topic rows, the PeerScoreParams
  scalars and the v1.1 thresholds, named as the fields they replace, so a
  plane stands in for the config's thresholds and for the score scalars;
  ``gather`` gives the per-(peer, slot) views ``TopicParamsArrays.gather``
  gives. ``app_specific_weight`` stays a host float: a non-zero weight
  adds P5's cross-peer gather, which is the build's structure.
* :class:`MeshParams` — D, Dlo, Dhi, Dscore, Dout, Dlazy (int32) and the
  gossip factor (float32) as 0-d tensors; every width reaches a selection
  clipped into ``[0, K]`` (``ops/select._clip_width``).
* :class:`CandidateParams` — one of each; the engines detect it by its
  ``mesh`` attribute.

The JAX package's ``score/params.py`` is the reference; its leaves carry
the same names, dtypes and values (``convert.score_plane_from_reference``
turns one into the other). The rows are built by the port's own
``TopicParamsArrays.build``, so a plane of a config's values (the
``from_config`` constructors) holds the static build's numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import PeerScoreParams, PeerScoreThresholds
from ..ops.fnum import flush_subnormals
from ..state import resolve_device
from .engine import TopicParamsArrays

#: the [T] per-topic rows, one leaf per TopicParamsArrays field
TOPIC_ROW_FIELDS = (
    "scored", "topic_weight", "w1", "quantum_ticks", "cap1",
    "w2", "decay2", "cap2", "w3", "decay3", "cap3", "thr3",
    "window_rounds", "activation_ticks", "w3b", "decay3b", "w4", "decay4",
)

#: the PeerScoreParams scalars the plane carries
PEER_SCALAR_FIELDS = (
    "topic_score_cap", "ip_colocation_factor_weight",
    "behaviour_penalty_weight", "behaviour_penalty_threshold",
    "behaviour_penalty_decay", "decay_to_zero",
)

#: the GossipSubConfig thresholds the plane carries
THRESHOLD_FIELDS = (
    "gossip_threshold", "publish_threshold", "graylist_threshold",
    "accept_px_threshold", "opportunistic_graft_threshold",
)

#: each row's TopicScoreParams field (``scored`` is topic-map membership)
TOPIC_ROW_PROVENANCE = {
    "scored": None,
    "topic_weight": "topic_weight",
    "w1": "time_in_mesh_weight",
    "quantum_ticks": "time_in_mesh_quantum",
    "cap1": "time_in_mesh_cap",
    "w2": "first_message_deliveries_weight",
    "decay2": "first_message_deliveries_decay",
    "cap2": "first_message_deliveries_cap",
    "w3": "mesh_message_deliveries_weight",
    "decay3": "mesh_message_deliveries_decay",
    "cap3": "mesh_message_deliveries_cap",
    "thr3": "mesh_message_deliveries_threshold",
    "window_rounds": "mesh_message_deliveries_window",
    "activation_ticks": "mesh_message_deliveries_activation",
    "w3b": "mesh_failure_penalty_weight",
    "decay3b": "mesh_failure_penalty_decay",
    "w4": "invalid_message_deliveries_weight",
    "decay4": "invalid_message_deliveries_decay",
}

#: the config fields a ScoreParams plane carries, by their owners' names
#: (the bench fingerprint's ``params`` block lists them)
LIFTED_FIELD_NAMES = tuple(sorted(
    [f"GossipSubConfig.{f}" for f in THRESHOLD_FIELDS]
    + [f"PeerScoreParams.{f}" for f in PEER_SCALAR_FIELDS]
    + [f"TopicScoreParams.{TOPIC_ROW_PROVENANCE[r]}"
       for r in TOPIC_ROW_FIELDS if TOPIC_ROW_PROVENANCE[r]]
    + ["TopicParamsArrays.scored"]
))

#: the mesh degree fields a MeshParams plane carries: int32 widths and the
#: float32 gossip factor
MESH_INT_FIELDS = ("D", "Dlo", "Dhi", "Dscore", "Dout", "Dlazy")
MESH_FLOAT_FIELDS = ("gossip_factor",)

MESH_LIFTED_FIELD_NAMES = tuple(sorted(
    f"GossipSubConfig.{f}" for f in MESH_INT_FIELDS + MESH_FLOAT_FIELDS))


def _moved(obj, device):
    """``obj`` (a plane) with every tensor leaf on ``device``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _moved(v, device)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass
class ScoreParams:
    """The score plane: ``[T]`` per-topic rows (TopicParamsArrays dtypes:
    float32, int32 ticks, the bool ``scored``), the PeerScoreParams
    scalars and the thresholds (float32 0-d), and ``app_specific_weight``
    as a host float."""

    scored: torch.Tensor
    topic_weight: torch.Tensor
    w1: torch.Tensor
    quantum_ticks: torch.Tensor
    cap1: torch.Tensor
    w2: torch.Tensor
    decay2: torch.Tensor
    cap2: torch.Tensor
    w3: torch.Tensor
    decay3: torch.Tensor
    cap3: torch.Tensor
    thr3: torch.Tensor
    window_rounds: torch.Tensor
    activation_ticks: torch.Tensor
    w3b: torch.Tensor
    decay3b: torch.Tensor
    w4: torch.Tensor
    decay4: torch.Tensor
    topic_score_cap: torch.Tensor
    ip_colocation_factor_weight: torch.Tensor
    behaviour_penalty_weight: torch.Tensor
    behaviour_penalty_threshold: torch.Tensor
    behaviour_penalty_decay: torch.Tensor
    decay_to_zero: torch.Tensor
    gossip_threshold: torch.Tensor
    publish_threshold: torch.Tensor
    graylist_threshold: torch.Tensor
    accept_px_threshold: torch.Tensor
    opportunistic_graft_threshold: torch.Tensor
    app_specific_weight: float = 0.0

    lifted = True   # a class marker, not a field

    @classmethod
    def build(cls, score_params: PeerScoreParams,
              thresholds: PeerScoreThresholds | None = None, n_topics: int = 1,
              heartbeat_interval: float = 1.0, device=None) -> "ScoreParams":
        """The plane of these host parameters, on ``device`` (the card by
        default). ``thresholds=None`` gives all-zero thresholds."""
        dev = resolve_device(device)
        tpa = TopicParamsArrays.build(score_params, n_topics, heartbeat_interval)
        kw = {name: torch.as_tensor(getattr(tpa, name), device=dev)
              for name in TOPIC_ROW_FIELDS}
        f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
        for f in PEER_SCALAR_FIELDS:
            kw[f] = f32(getattr(score_params, f))
        for f in THRESHOLD_FIELDS:
            kw[f] = f32(getattr(thresholds, f) if thresholds is not None else 0.0)
        return cls(app_specific_weight=float(score_params.app_specific_weight), **kw)

    @classmethod
    def from_config(cls, cfg, score_params: PeerScoreParams, n_topics: int = 1,
                    heartbeat_interval: float = 1.0, device=None) -> "ScoreParams":
        """The plane of a built config's values: a lifted step fed it
        computes what the static build of ``cfg`` computes."""
        return cls.build(score_params, cfg, n_topics, heartbeat_interval, device)

    def to(self, device) -> "ScoreParams":
        return _moved(self, torch.device(device))

    def flushed(self) -> "ScoreParams":
        """The plane as the JAX package's platforms read it: every float32
        leaf with its subnormals as zeros of their sign (on the device;
        ``ops/fnum.py``)."""
        return dataclasses.replace(self, **{
            f.name: flush_subnormals(v) for f in dataclasses.fields(self)
            if isinstance(v := getattr(self, f.name), torch.Tensor)
            and v.dtype == torch.float32})

    def gather(self, my_topics: torch.Tensor) -> dict:
        """The per-(peer, slot) ``[N, S]`` views of the rows (slots with no
        topic zeroed and unscored), as ``TopicParamsArrays.gather`` makes
        them."""
        t = my_topics.clamp(min=0).long()
        live = my_topics >= 0
        out = {}
        for name in TOPIC_ROW_FIELDS:
            v = getattr(self, name)[t]
            out[name] = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=v.device))
        return out


@dataclasses.dataclass
class MeshParams:
    """The mesh-degree plane: int32 widths and the float32 gossip factor,
    0-d each, named as GossipSubConfig's fields."""

    D: torch.Tensor
    Dlo: torch.Tensor
    Dhi: torch.Tensor
    Dscore: torch.Tensor
    Dout: torch.Tensor
    Dlazy: torch.Tensor
    gossip_factor: torch.Tensor

    lifted = True

    @classmethod
    def from_config(cls, cfg, device=None) -> "MeshParams":
        dev = resolve_device(device)
        kw = {f: torch.tensor(int(getattr(cfg, f)), dtype=torch.int32, device=dev)
              for f in MESH_INT_FIELDS}
        for f in MESH_FLOAT_FIELDS:
            kw[f] = torch.tensor(float(getattr(cfg, f)), dtype=torch.float32, device=dev)
        return cls(**kw)

    def to(self, device) -> "MeshParams":
        return _moved(self, torch.device(device))


@dataclasses.dataclass
class CandidateParams:
    """A score plane and a mesh plane together."""

    score: ScoreParams
    mesh: MeshParams

    lifted = True

    @property
    def app_specific_weight(self) -> float:
        return self.score.app_specific_weight

    @classmethod
    def from_config(cls, cfg, score_params: PeerScoreParams, n_topics: int = 1,
                    heartbeat_interval: float = 1.0, device=None) -> "CandidateParams":
        return cls(score=ScoreParams.from_config(cfg, score_params, n_topics,
                                                 heartbeat_interval, device),
                   mesh=MeshParams.from_config(cfg, device))

    def to(self, device) -> "CandidateParams":
        return _moved(self, torch.device(device))


def split_plane(plane):
    """(score plane, mesh plane or None) of a ScoreParams or a
    CandidateParams."""
    mesh = getattr(plane, "mesh", None)
    return (plane.score if mesh is not None else plane), mesh
