"""The attack plane: the GossipSub v1.1 attack suite as masked variants of
the step math (the port's copy of the JAX package's ``chaos/adversary.py``).

The v1.1 hardening paper (arXiv:2007.02754) attacks the protocol — sybil
flood, eclipse, cold boot, covert flash, censorship — and shows that the
score machinery isolates the attackers while honest delivery survives.
This module supplies those attackers as planes over the peers: an
``is_sybil`` plane and one mask a behaviour drive the attackers inside the
same steps the honest network runs, with no attacker loop on the host.

Behaviours (each a maskable plane):

* **drop_forward** — run the whole control plane but never transmit
  message data (mesh push, flood publish, fanout, IWANT service): the
  ``sybilSquatter`` of gossipsub_test.go:1777-1811, caught by P3's mesh
  deficit and P7's broken promises.
* **lie_ihave** — advertise every live message id on every edge, held or
  not (IHAVE spam, gossipsub_spam_test.go:290): the victims' IWANTs go
  unserved, promises break, P7 accrues.
* **graft_spam** — GRAFT every (live slot, edge) every heartbeat, ignoring
  PRUNE backoff (the GRAFT flood, gossipsub_spam_test.go:365). A spam
  attacker keeps no backoff bookkeeping of its own (the reference's
  attacker is a raw-wire fake): its backoff planes are zero.
* **self_promo** — cooperating sybils pin their held scores of fellow
  sybils at ``promo_score``; honest peers' scores of sybils are untouched.
* **censor** — forward everything but the messages the ``censor_origins``
  set originated.

Every mask ANDs into a plane the step already builds: the per-peer planes
and their ``[N, K]`` neighbour views are device tensors built once, at step
build (``AdversaryConsts``), and a round's activity is an elementwise
compare of them against the device tick, so the plane reads nothing on the
host and a window captures an attacked step as any other. ``onset`` and
``stop`` are per-peer tick planes; ``AttackScenario`` compiles declarative
attack windows (onset, ramp, stop, sybil fraction, eclipse targets) into
them with numpy draws, the JAX package's placements exactly. The plane has
no state: a checkpoint (the tick) resumes the attack with no new leaf.

``resolve`` is the one elision decision: None, or a population whose every
behaviour is off or empty, leaves every engine on its code without the
plane (no mask, no counter, no extra op or launch).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..ops import bitset

#: the maskable behaviour planes (one [N] bool mask each; None = the
#: behaviour is off for the whole population)
BEHAVIORS = ("drop_forward", "lie_ihave", "graft_spam", "self_promo", "censor")

#: "never stops" tick sentinel (beyond any simulated horizon, inside int32)
NEVER = 2 ** 30


class AdversaryError(ValueError):
    """Raised on invalid adversary populations and attack scenarios."""


def _host(x) -> np.ndarray:
    """A numpy view of a host array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Adversary:
    """A build-time adversary population: numpy planes a step builds its
    device constants from (``AdversaryConsts``). Hashable by identity.

    ``is_sybil`` names the attacker faction; each behaviour defaults to the
    whole faction and a per-behaviour mask (``masks={"graft_spam": ...}``)
    restricts it — every mask must lie inside ``is_sybil``. ``onset`` and
    ``stop`` are ticks (a scalar or a per-peer [N] plane): peer i runs a
    behaviour exactly when ``mask[i] and onset[i] <= tick < stop[i]``.
    ``censor_origins`` is the [N] bool target set whose messages ``censor``
    drops; ``graft_targets`` optionally restricts ``graft_spam`` to edges
    toward a victim set (the eclipse shape; None spams every edge)."""

    def __init__(self, n_peers: int, is_sybil, behaviors=("drop_forward",), *,
                 masks: dict | None = None, onset=0, stop=None,
                 promo_score: float = 20.0, censor_origins=None, graft_targets=None):
        self.n_peers = int(n_peers)
        self.is_sybil = _host(is_sybil).astype(bool).reshape(-1)
        self.behaviors = tuple(behaviors)
        self.masks = {k: _host(v).astype(bool).reshape(-1) for k, v in (masks or {}).items()}
        self.onset = np.broadcast_to(np.asarray(onset, np.int32), (self.n_peers,)).copy()
        self.stop = np.broadcast_to(np.asarray(NEVER if stop is None else stop, np.int32),
                                    (self.n_peers,)).copy()
        self.promo_score = float(promo_score)
        self.censor_origins = (None if censor_origins is None
                               else _host(censor_origins).astype(bool).reshape(-1))
        self.graft_targets = (None if graft_targets is None
                              else _host(graft_targets).astype(bool).reshape(-1))
        self.validate()

    def validate(self) -> None:
        n = self.n_peers
        if self.is_sybil.shape != (n,):
            raise AdversaryError(f"is_sybil has shape {self.is_sybil.shape} for {n} peers")
        unknown = [b for b in self.behaviors if b not in BEHAVIORS]
        if unknown:
            raise AdversaryError(f"unknown behaviors {unknown}; known: {BEHAVIORS}")
        for k, m in self.masks.items():
            if k not in BEHAVIORS:
                raise AdversaryError(f"mask for unknown behavior {k!r}; known: {BEHAVIORS}")
            if k not in self.behaviors:
                raise AdversaryError(
                    f"mask[{k!r}] given but the behavior is not enabled "
                    f"(behaviors={self.behaviors}) — a silently ignored mask would run "
                    "the experiment without the attack")
            if m.shape != (n,):
                raise AdversaryError(f"mask[{k!r}] has shape {m.shape} for {n} peers")
            if (m & ~self.is_sybil).any():
                raise AdversaryError(
                    f"mask[{k!r}] marks peers outside is_sybil — behavior masks restrict "
                    "the faction, they cannot extend it")
        for name in ("onset", "stop"):
            v = getattr(self, name)
            if v.shape != (n,):
                raise AdversaryError(f"{name} has shape {v.shape} for {n} peers")
        if (self.onset < 0).any():
            raise AdversaryError("onset ticks must be >= 0")
        if "censor" in self.behaviors and self.censor_origins is None:
            raise AdversaryError(
                "the censor behavior needs censor_origins (the [N] bool target set whose "
                "messages are dropped)")
        for name, v in (("censor_origins", self.censor_origins),
                        ("graft_targets", self.graft_targets)):
            if v is not None and v.shape != (n,):
                raise AdversaryError(f"{name} has shape {v.shape} for {n} peers")

    def mask(self, behavior: str) -> np.ndarray | None:
        """[N] bool plane of ``behavior``, or None when it is off."""
        if behavior not in self.behaviors:
            return None
        m = self.masks.get(behavior, self.is_sybil)
        return m if m.any() else None

    @property
    def enabled(self) -> bool:
        """False: a build leaves the plane out entirely."""
        return any(self.mask(b) is not None for b in self.behaviors)

    def fingerprint(self) -> dict:
        """The population's self-description (the JAX package's artifact
        ``adversary`` block, the same hash)."""
        h = hashlib.sha256()
        h.update(self.is_sybil.tobytes())
        h.update(self.onset.tobytes())
        h.update(self.stop.tobytes())
        for b in BEHAVIORS:
            m = self.mask(b)
            h.update(b"-" if m is None else m.tobytes())
        for v in (self.censor_origins, self.graft_targets):
            h.update(b"-" if v is None else v.tobytes())
        any_sybil = self.is_sybil.any()
        stop = int(self.stop[self.is_sybil].max()) if any_sybil else NEVER
        return {
            "enabled": bool(self.enabled),
            "n_sybils": int(self.is_sybil.sum()),
            "behaviors": [b for b in self.behaviors if self.mask(b) is not None],
            "onset": int(self.onset[self.is_sybil].min()) if any_sybil else 0,
            "stop": None if stop >= NEVER else stop,
            "promo_score": self.promo_score,
            "population": h.hexdigest()[:12],
        }


def resolve(adversary, net=None) -> Adversary | None:
    """None when the plane is off: the one elision decision every engine
    shares (as ``chaos.faults.resolve``). An ``AttackScenario`` is built
    first (``net`` is its topology, which a surround placement needs).
    Validation runs first: a misspelt behaviour raises, it does not run
    the experiment against an honest network."""
    if adversary is None:
        return None
    if isinstance(adversary, AttackScenario):
        adversary = adversary.build(net)
    adversary.validate()
    return adversary if adversary.enabled else None


def build_consts(adversary, net) -> "AdversaryConsts | None":
    """A step's attack-plane constants over ``net``: None when the plane is
    off (``resolve``), an ``AdversaryConsts`` as it is, else the resolved
    population's constants, built here (host planes copied to the card)."""
    if isinstance(adversary, AdversaryConsts):
        return adversary
    adversary = resolve(adversary, net)
    return AdversaryConsts(adversary, net) if adversary is not None else None


class AdversaryConsts:
    """The per-(population, topology) device constants of a step, built once
    at step build: the per-peer planes and their neighbour views, so a
    round's activity tests are elementwise compares against the tick."""

    __slots__ = ("adv", "onset", "stop", "onset_nbr", "stop_nbr", "self_masks",
                 "nbr_masks", "sybil_nbr", "spam_edges", "censor_origin", "promo_score")

    def __init__(self, adv: Adversary, net):
        dev = net.nbr.device
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        self.adv = adv
        # the float32 value the JAX package's jnp.float32 constant holds
        self.promo_score = float(np.float32(adv.promo_score))
        nbr = net.nbr.clamp(min=0).long()
        self.onset = as_t(adv.onset)
        self.stop = as_t(adv.stop)
        self.onset_nbr = self.onset[nbr]
        self.stop_nbr = self.stop[nbr]
        self.self_masks = {}
        self.nbr_masks = {}
        for b in BEHAVIORS:
            m = adv.mask(b)
            if m is None:
                continue
            mt = as_t(m)
            self.self_masks[b] = mt
            self.nbr_masks[b] = mt[nbr] & net.nbr_ok
        self.sybil_nbr = as_t(adv.is_sybil)[nbr] & net.nbr_ok
        # graft-spam edges: present, never to self, optionally only toward
        # the eclipse victim set
        n = net.nbr.shape[0]
        not_self = net.nbr != torch.arange(n, dtype=net.nbr.dtype, device=dev)[:, None]
        spam = net.nbr_ok & not_self
        if adv.graft_targets is not None:
            spam = spam & as_t(adv.graft_targets)[nbr]
        self.spam_edges = spam
        self.censor_origin = (as_t(adv.censor_origins) if adv.censor_origins is not None
                              else None)

    def has(self, behavior: str) -> bool:
        return behavior in self.self_masks

    @property
    def data_plane(self) -> bool:
        """True when a data-plane behaviour (drop_forward, censor) is live:
        the engines' one gate for the transmit masks."""
        return self.has("drop_forward") or self.has("censor")

    def active_self(self, behavior: str, tick) -> torch.Tensor:
        """[N] bool: the peers running ``behavior`` this round."""
        return self.self_masks[behavior] & (tick >= self.onset) & (tick < self.stop)

    def active_nbr(self, behavior: str, tick) -> torch.Tensor:
        """[N, K] bool: edge (j, k) has an active ``behavior`` sender at its
        far end this round (the receiver-side gate)."""
        return self.nbr_masks[behavior] & (tick >= self.onset_nbr) & (tick < self.stop_nbr)

    def censor_words(self, msgs) -> torch.Tensor:
        """[W] packed words of the message slots an active censor drops (live
        messages the target set originated)."""
        hit = self.censor_origin[msgs.origin.clamp(min=0).long()] & (msgs.origin >= 0)
        return bitset.pack(hit)

    def mask_transmit_nbr(self, tick, plane: torch.Tensor, msgs):
        """Receiver-side data gate: clear the bits of a gathered [N, K, W]
        transmit plane on edges whose sender is an active ``drop_forward``
        or ``censor`` attacker this round. Returns ``(masked, removed)``;
        callers popcount ``removed`` (within the forwardable set) into
        ``EV.ADV_DROP``."""
        out = plane
        if self.has("drop_forward"):
            dn = self.active_nbr("drop_forward", tick)
            out = torch.where(dn[:, :, None], 0, out)
        if self.has("censor"):
            cn = self.active_nbr("censor", tick)
            cw = self.censor_words(msgs)
            out = torch.where(cn[:, :, None], out & ~cw[None, None, :], out)
        return out, plane & ~out

    def mask_transmit_self(self, tick, plane: torch.Tensor, msgs):
        """The sender-side form of the same gate (the phase engine composes
        each sender's transmissions before its one crossing, so an attacker
        masks its own rows). Returns ``(masked, removed)``."""
        out = plane
        if self.has("drop_forward"):
            ds = self.active_self("drop_forward", tick)
            out = torch.where(ds[:, None, None], 0, out)
        if self.has("censor"):
            cs = self.active_self("censor", tick)
            cw = self.censor_words(msgs)
            out = torch.where(cs[:, None, None], out & ~cw[None, None, :], out)
        return out, plane & ~out


def withheld_count(net, fwd: torch.Tensor, removed: torch.Tensor) -> torch.Tensor:
    """int32 0-d ``EV.ADV_DROP`` attribution: the suppressed receiver-side
    bits within the senders' forward sets."""
    return bitset.popcount(removed & net.peer_gather(fwd)).sum(dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class AttackScenario:
    """A declarative, reproducible attack schedule over one run, compiled to
    the per-peer planes the engines consume (``build`` gives an
    ``Adversary``): the attack counterpart of ``chaos.Scenario``.

    Sybil recruitment, one of:

    * ``sybils`` — explicit peer indices;
    * ``sybil_fraction`` — the top fraction of the id space (peers
      ``[ceil(N·(1-f)), N)``);
    * ``surround_targets=True`` — the topology neighbours of ``targets``
      become sybils (the eclipse placement; needs ``build(net=...)``);
      ``surround_fraction < 1`` recruits that fraction of each target's
      neighbours (seeded). A full surround leaves a victim no honest edge.

    ``ramp_rounds`` staggers the sybils' onsets uniformly (seeded) over
    ``[onset, onset + ramp_rounds)``. ``stop=None`` never stops."""

    n_peers: int
    behaviors: tuple = ("drop_forward",)
    sybils: tuple = ()
    sybil_fraction: float = 0.0
    onset: int = 0
    stop: int | None = None
    ramp_rounds: int = 0
    targets: tuple = ()
    surround_targets: bool = False
    surround_fraction: float = 1.0
    censor_origins: tuple = ()
    promo_score: float = 20.0
    seed: int = 0

    def validate(self) -> None:
        if not (0.0 <= self.sybil_fraction < 1.0):
            raise AdversaryError(f"sybil_fraction must be in [0, 1), got {self.sybil_fraction}")
        if self.onset < 0 or self.ramp_rounds < 0:
            raise AdversaryError("onset/ramp_rounds must be >= 0")
        if self.stop is not None and self.stop <= self.onset:
            raise AdversaryError(f"stop ({self.stop}) must be > onset ({self.onset})")
        for name in ("sybils", "targets", "censor_origins"):
            for i in getattr(self, name):
                if not (0 <= int(i) < self.n_peers):
                    raise AdversaryError(f"{name} index {i} out of range")
        if self.surround_targets and not self.targets:
            raise AdversaryError("surround_targets needs a target set")
        if not (0.0 < self.surround_fraction <= 1.0):
            raise AdversaryError(
                f"surround_fraction must be in (0, 1], got {self.surround_fraction}")

    def _sybil_plane(self, net=None) -> np.ndarray:
        n = self.n_peers
        sybil = np.zeros((n,), bool)
        if self.sybils:
            sybil[list(self.sybils)] = True
        if self.sybil_fraction > 0.0:
            sybil[int(np.ceil(n * (1.0 - self.sybil_fraction))):] = True
        if self.surround_targets:
            if net is None:
                raise AdversaryError("surround_targets recruits the targets' topology "
                                     "neighbors — pass build(net=...)")
            nbr, ok = _host(net.nbr), _host(net.nbr_ok)
            rng = np.random.default_rng(self.seed + 0x5A11)
            for t in self.targets:
                nbrs = np.unique(nbr[int(t)][ok[int(t)]])
                if self.surround_fraction < 1.0:
                    keep = max(1, int(np.floor(self.surround_fraction * nbrs.size)))
                    nbrs = rng.permutation(nbrs)[:keep]
                sybil[nbrs] = True
        sybil[list(self.targets)] = False  # a victim is never a sybil
        return sybil

    def build(self, net=None) -> Adversary:
        """The static per-peer planes (an ``Adversary``)."""
        self.validate()
        n = self.n_peers
        sybil = self._sybil_plane(net)
        onset = np.full((n,), self.onset, np.int32)
        if self.ramp_rounds > 0:
            rng = np.random.default_rng(self.seed)
            idx = np.nonzero(sybil)[0]
            onset[idx] = self.onset + rng.integers(0, self.ramp_rounds, size=idx.size)
        censor = None
        if self.censor_origins:
            censor = np.zeros((n,), bool)
            censor[list(self.censor_origins)] = True
        targets = None
        if self.targets:
            targets = np.zeros((n,), bool)
            targets[list(self.targets)] = True
        return Adversary(
            n, sybil, self.behaviors, onset=onset,
            stop=NEVER if self.stop is None else self.stop,
            promo_score=self.promo_score, censor_origins=censor,
            graft_targets=targets if "graft_spam" in self.behaviors else None)

    def events(self) -> list:
        """The schedule as (tick, kind, detail) rows, known on the host."""
        out = [(self.onset, "AttackOnset",
                {"behaviors": list(self.behaviors), "ramp_rounds": self.ramp_rounds})]
        if self.stop is not None:
            out.append((self.stop, "AttackStop", {}))
        return out

    def scenario_hash(self) -> str:
        """A stable short hash of the whole schedule (the JAX package's)."""
        h = hashlib.sha256()
        h.update(repr((self.n_peers, self.behaviors, tuple(self.sybils),
                       self.sybil_fraction, self.onset, self.stop, self.ramp_rounds,
                       tuple(self.targets), self.surround_targets, self.surround_fraction,
                       tuple(self.censor_origins), self.promo_score, self.seed)).encode())
        return h.hexdigest()[:12]
