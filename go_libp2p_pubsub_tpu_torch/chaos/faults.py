"""Link-fault injection: the chaos plane's generators (the port's copy of
the JAX package's ``chaos/faults.py``).

GossipSub's IHAVE/IWANT machinery exists to recover lost messages, and the
mesh heals itself after failures; this module supplies the faults:

* **link flaps** — a per-link, per-round outage mask ANDed into the
  receiver side of every crossing. The whole link (data and control, both
  directions) drops for the round, as a stalled connection does.
* **generators** — i.i.d. (each link down with probability ``loss_rate``
  a round) and Gilbert–Elliott (a two-state chain per link: good to bad
  with ``ge_p_down``, bad to good with ``ge_p_up``; bad is a full outage).
* **schedules** — a ``scheduled=True`` step also takes a ``link_deny``
  ``[N, K]`` bool argument (True = forced down), the seat of the
  partitions ``chaos/scenario.py`` compiles.

Masks are functions of (the state's PRNG key, the tick): a counter-mode
murmur3 hash over the canonical undirected link id, seeded from
``key_data(fold_in(key, CHAOS_TAG))``. Both directions of a link hash the
same input, so a mask is symmetric over the edge involution by
construction, and a checkpoint (key, tick and the GE ``ge_bad`` plane)
resumes the exact fault stream. The hash runs in int64 masked to 32 bits,
as ``prng.py`` does; every product splits its constant in 16-bit halves so
that no int64 product overflows, and no value is read on the host, so a
step with faults is captured in a CUDA graph as one without.

A config that is None or disabled (``resolve``) leaves every engine on its
code without faults: no mask, no counter, no extra op or launch.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import prng

#: fold_in tag deriving the chaos seed from the state's key (apart from the
#: gater's 0x6A7E and the fanout's 0xFA40)
CHAOS_TAG = 0xC4A05

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF


class ChaosConfigError(ValueError):
    """Raised by ChaosConfig.validate() on invalid parameters."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Build-time configuration of the chaos plane.

    ``generator`` picks the random fault process: ``"iid"`` (each live link
    down with probability ``loss_rate`` each round) or ``"ge"``
    (Gilbert–Elliott: good to bad with ``ge_p_down``, bad to good with
    ``ge_p_up`` a round; mean burst 1/ge_p_up rounds). ``scheduled=True``
    makes the built step take a trailing ``link_deny [N, K]`` bool
    argument; it composes with either generator (deny or generator-down
    drops the link)."""

    generator: str = "iid"
    loss_rate: float = 0.0
    ge_p_down: float = 0.0
    ge_p_up: float = 0.25
    scheduled: bool = False

    def validate(self) -> None:
        if self.generator not in ("iid", "ge"):
            raise ChaosConfigError(
                f"unknown chaos generator {self.generator!r}; expected 'iid' or 'ge'")
        for name in ("loss_rate", "ge_p_down", "ge_p_up"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ChaosConfigError(f"{name} must be in [0, 1], got {v}")
        if self.generator == "ge" and self.ge_p_down > 0 and self.ge_p_up <= 0:
            raise ChaosConfigError(
                "ge_p_up must be > 0 when ge_p_down > 0 (links would never recover)")

    @property
    def generator_enabled(self) -> bool:
        if self.generator == "ge":
            return self.ge_p_down > 0.0
        return self.loss_rate > 0.0

    @property
    def enabled(self) -> bool:
        """False: the build leaves the chaos plane out entirely."""
        return self.generator_enabled or self.scheduled

    @property
    def needs_state(self) -> bool:
        """The Gilbert–Elliott chain carries the ``[N, K]`` bad plane in the
        state (``state.ChaosState``); i.i.d. and schedule-only chaos are
        stateless."""
        return self.generator == "ge" and self.generator_enabled

    def fingerprint(self) -> dict:
        """The generator's self-description (the JAX package's artifact
        chaos block)."""
        fp = {"generator": self.generator if self.generator_enabled else "off",
              "loss_rate": float(self.loss_rate),
              "scheduled": bool(self.scheduled)}
        if self.needs_state:
            fp["ge_p_down"] = float(self.ge_p_down)
            fp["ge_p_up"] = float(self.ge_p_up)
        return fp


def resolve(chaos: ChaosConfig | None) -> ChaosConfig | None:
    """None when the plane is off (the one decision every engine shares).
    Validation comes first: a misspelt generator raises instead of running
    the experiment on a lossless wire."""
    if chaos is None:
        return None
    chaos.validate()
    return chaos if chaos.enabled else None


# ---------------------------------------------------------------------------
# the counter-mode hash (murmur3 finalizer steps, u32 wraparound)


def _mul(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) (int64 tensor or Python int) and
    a constant c < 2^32, through 16-bit halves of c: no product reaches
    2^63."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(h):
    h = h ^ (h >> 16)
    h = _mul(h, _C1)
    h = h ^ (h >> 13)
    h = _mul(h, _C2)
    return h ^ (h >> 16)


def chaos_seed(key: torch.Tensor) -> torch.Tensor:
    """The u32 seed (a 0-dim int64 tensor) of the state's threefry key,
    computed on the key's device."""
    kd = prng.key_data(prng.fold_in(key, CHAOS_TAG))
    s = torch.full((), _GOLD, dtype=torch.int64, device=key.device)
    for i in range(kd.shape[0]):
        s = _mix(s ^ kd[i])
    return s


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's values read as u32, held in int64."""
    return x.to(torch.int64) & _M32


def _link_key_planes(nbr: torch.Tensor, topo=None):
    """The canonical symmetric link identity each draw hashes: (lo, hi,
    eps) planes ``[N, K]``.

    Static topology (``topo`` None): the undirected peer pair
    (min(i, j), max(i, j)), eps None. Mutable overlay (``topo`` a
    ``state.TopoState``): the canonical slot pair (the flat slot and its
    involution partner) plus the two slots' write-epoch sum, so a rewired
    slot re-keys its stream while untouched links keep theirs; the
    partner's epoch is read through the state leaf's int32 ``edge_perm``."""
    if topo is None:
        n = nbr.shape[0]
        i = torch.arange(n, dtype=torch.int64, device=nbr.device)[:, None]
        j = nbr.to(torch.int64).clamp(min=0)
        return torch.minimum(i, j), torch.maximum(i, j), None
    n, k = topo.nbr.shape
    own = torch.arange(n * k, dtype=torch.int64, device=topo.nbr.device).reshape(n, k)
    p = topo.edge_perm.to(torch.int64)
    lo = _u32(torch.minimum(own, p))
    hi = _u32(torch.maximum(own, p))
    ep_partner = topo.epoch.reshape(-1)[p.reshape(-1)].reshape(n, k)
    eps = _u32(topo.epoch + ep_partner)
    return lo, hi, eps


def _tick_u32(tick, device):
    if isinstance(tick, torch.Tensor):
        return _u32(tick.to(device))
    return int(tick) & _M32


def _link_uniform_keyed(seed, lo, hi, eps, tick, salt: int) -> torch.Tensor:
    h = _mix(seed ^ salt)
    h = h ^ _mul(_tick_u32(tick, lo.device), _GOLD)
    u = _mix(h ^ _mul(lo, _C1))
    u = _mix(u ^ _mul(hi, _C2))
    if eps is not None:
        u = _mix(u ^ _mul(eps, _GOLD))
    return u


def link_uniform(seed: torch.Tensor, nbr: torch.Tensor, tick, salt: int,
                 topo=None) -> torch.Tensor:
    """``[N, K]`` per-link u32 draws (int64) for one round; both directions
    of an edge hash the same link identity, so the plane is symmetric over
    the edge involution. ``salt`` separates the streams (i.i.d. and the
    two GE transition draws)."""
    lo, hi, eps = _link_key_planes(nbr, topo)
    return _link_uniform_keyed(seed, lo, hi, eps, tick, salt)


def _threshold(p: float) -> int:
    """The u32 compare threshold t with P(u < t) == p (clamped)."""
    return min(int(round(p * 4294967296.0)), _M32)


def iid_link_down(seed, nbr, tick, loss_rate: float, topo=None) -> torch.Tensor:
    """``[N, K]`` bool: link down this round under the i.i.d. generator."""
    return link_uniform(seed, nbr, tick, salt=0x11D, topo=topo) < _threshold(loss_rate)


def ge_advance(seed, nbr, tick, bad: torch.Tensor, p_down: float, p_up: float,
               topo=None) -> torch.Tensor:
    """One Gilbert–Elliott transition of every link: the new ``[N, K]`` bad
    plane (symmetric whenever ``bad`` is). Under a mutable overlay a
    rewired slot keeps its chain state for the round its draws re-key."""
    lo, hi, eps = _link_key_planes(nbr, topo)
    go_down = _link_uniform_keyed(seed, lo, hi, eps, tick, 0x6E0D) < _threshold(p_down)
    go_up = _link_uniform_keyed(seed, lo, hi, eps, tick, 0x75E1) < _threshold(p_up)
    return torch.where(bad, ~go_up, go_down)


def round_link_ok(chaos: ChaosConfig, seed, nbr, tick, ge_bad: torch.Tensor | None,
                  link_deny: torch.Tensor | None, topo=None):
    """The round's link mask: ``(link_ok [N, K] bool, ge_bad')``.

    ``link_ok`` is True where the link carries traffic this round; callers
    AND it into the receiver side of the data and the control crossings.
    ``ge_bad'`` is the advanced chain (the input unchanged for the other
    generators). Down is deny or generator-down. ``topo`` (the
    post-mutation ``TopoState``) switches to the slot-and-epoch keying."""
    down = None
    if chaos.needs_state:
        if ge_bad is None:
            raise ValueError("GE chaos needs ChaosState in the state: build it with "
                             "SimState.init(..., chaos_ge=True) (GossipSubState.init does "
                             "this from cfg.chaos)")
        ge_bad = ge_advance(seed, nbr, tick, ge_bad, chaos.ge_p_down, chaos.ge_p_up,
                            topo=topo)
        down = ge_bad
    elif chaos.generator_enabled:
        down = iid_link_down(seed, nbr, tick, chaos.loss_rate, topo=topo)
    if link_deny is not None:
        deny = link_deny.to(device=nbr.device, dtype=torch.bool)
        down = deny if down is None else (down | deny)
    if down is None:
        # a scheduled build driven without a deny plane this round
        return torch.ones(tuple(nbr.shape), dtype=torch.bool, device=nbr.device), ge_bad
    return ~down, ge_bad


def count_links_down(nbr: torch.Tensor, nbr_ok: torch.Tensor,
                     link_ok: torch.Tensor) -> torch.Tensor:
    """int32 scalar: undirected live links down this round, each counted
    once at its lower-id endpoint (the LINK_DOWN counter)."""
    i = torch.arange(nbr.shape[0], dtype=nbr.dtype, device=nbr.device)[:, None]
    return (nbr_ok & ~link_ok & (i < nbr)).sum(dtype=torch.int32)
