"""Invariant oracle plane: the verification literature's safety and
liveness properties as tensor predicates over the engines' states (the JAX
package's ``oracle/invariants.py``).

The ACL2s GossipSub verification (arXiv:2311.08859) and the FloodSub
correctness formalization (arXiv:2507.19013) state what these protocols
must always satisfy: no self-graft, mesh within topology and subscription,
backoff respected, graylisted peers excluded, seen-cache consistency,
eventual delivery after a heal. Each property here is one masked predicate
over the state planes reduced to a 0-d bool tensor; the checker stacks
them into a ``[P]`` verdict vector (True = the property holds).

Every predicate is device ops only: no ``.item()``, no host copy, no
boolean-mask indexing. So a checker runs inside a captured CUDA graph
(``driver.make_window(check=...)``), and its constants (the static mesh
eligibility plane, the padding-bit mask, the aranges) are made once per
checker (``make_checker``, ``ScanInvariants``) before any capture.

Fault composition (the grace/due contract): faults relax exactly the
clauses the papers scope out. Mesh degree bounds suspend while a scheduled
partition or churn storm is active and for a declared grace window after
(``due[DUE_GRACE]``); eventual delivery applies only to messages whose
whole propagation window ``[birth, birth + W]`` lies inside a declared
QUIET interval, plus the heal-liveness clause: partition-era messages still
in the mcache history at heal are delivered by a post-heal deadline
(``due[DUE_R_*]``). Under sustained flaps every safety property stays live
and the delivery clause is vacuous, by design.

The checker is an observer: it reads the live state and writes nothing,
and a run without one runs the same steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: the engines a property may declare applicability for; "phase" is the
#: multi-round gossipsub engine (it shares GossipSubState, so every
#: gossipsub-state property applies, checked at phase boundaries)
ENGINES = ("gossipsub", "phase", "floodsub", "randomsub")

#: applicability aliases
CORE_ENGINES = ("gossipsub", "phase", "floodsub", "randomsub")
GOSSIP_ENGINES = ("gossipsub", "phase")

#: due-vector layout (int32 [DUE_LEN]): the host-known schedule context a
#: check runs under. -1 sentinels disable a clause.
#:   QUIET_LO/QUIET_HI — fresh-publish eventual-delivery window: a valid
#:       message is due iff birth >= QUIET_LO and birth + W <= QUIET_HI
#:       and birth + W <= tick;
#:   R_LO/R_HI/R_DEADLINE — heal-recovery clause: messages born in
#:       [R_LO, R_HI] are due once tick >= R_DEADLINE;
#:   GRACE — 1 suspends the fault-scoped clauses (mesh degree bounds);
#:   MUT_GRACE — 1 while a topology-mutation batch landed inside this
#:       check's window: the mutation-aware properties (mesh-in-topology,
#:       first-edge-wf) grace the one-check re-peering transient.
DUE_QUIET_LO = 0
DUE_QUIET_HI = 1
DUE_R_LO = 2
DUE_R_HI = 3
DUE_R_DEADLINE = 4
DUE_GRACE = 5
DUE_MUT_GRACE = 6
DUE_LEN = 7


def due_vector(quiet=None, recover=None, grace: bool = False,
               mut_grace: bool = False) -> np.ndarray:
    """Host-side due-vector builder. ``quiet`` is ``(lo, hi)``, the quiet
    interval of the fresh-publish delivery clause; ``recover`` is
    ``(born_lo, born_hi, deadline)``, the heal-recovery clause; ``grace``
    suspends the fault-scoped safety clauses; ``mut_grace`` the
    mutation-scoped ones (``topo/dynamics.MutationSchedule.due_fn`` sets
    it)."""
    out = np.full((DUE_LEN,), -1, np.int32)
    if quiet is not None:
        out[DUE_QUIET_LO], out[DUE_QUIET_HI] = int(quiet[0]), int(quiet[1])
    if recover is not None:
        out[DUE_R_LO] = int(recover[0])
        out[DUE_R_HI] = int(recover[1])
        out[DUE_R_DEADLINE] = int(recover[2])
    out[DUE_GRACE] = 1 if grace else 0
    out[DUE_MUT_GRACE] = 1 if mut_grace else 0
    return out


class InvariantConfigError(ValueError):
    """Raised by InvariantConfig.validate() on invalid parameters."""


@dataclasses.dataclass(frozen=True)
class InvariantConfig:
    """Static checker configuration. ``delivery_window`` is W, the rounds a
    due message gets to reach every subscribed up peer; ``check_every`` is
    the cadence in dispatches (rounds for the per-round engines, phases for
    the phase engine); ``names`` restricts the checked properties (None =
    all that apply to the engine)."""

    delivery_window: int = 12
    check_every: int = 8
    names: tuple | None = None

    def validate(self) -> None:
        if self.delivery_window < 1:
            raise InvariantConfigError(
                f"delivery_window must be >= 1, got {self.delivery_window}")
        if self.check_every < 1:
            raise InvariantConfigError(
                f"check_every must be >= 1, got {self.check_every}")
        if self.names is not None:
            unknown = [n for n in self.names if n not in REGISTRY]
            if unknown:
                raise InvariantConfigError(
                    f"unknown invariant names: {unknown}; registered: "
                    f"{list(REGISTRY)}")


@dataclasses.dataclass(frozen=True)
class Invariant:
    """One registered property: a predicate over a check context that
    reduces to a 0-d bool tensor (True = the property holds)."""

    name: str
    kind: str        # "safety" | "liveness"
    engines: tuple   # subset of ENGINES
    doc: str         # one-line statement + paper citation
    fn: object = dataclasses.field(compare=False, repr=False)


#: the ordered property registry (insertion order is the checker's output
#: order)
REGISTRY: dict[str, Invariant] = {}


def invariant(name: str, *, kind: str, engines: tuple, doc: str):
    """Register a property; ``engines`` declares where it applies."""
    if kind not in ("safety", "liveness"):
        raise ValueError(f"{name}: kind must be safety|liveness, got {kind}")
    bad = [e for e in engines if e not in ENGINES]
    if bad or not engines:
        raise ValueError(f"{name}: engine applicability {engines!r} must be "
                         f"a non-empty subset of {ENGINES}")

    def deco(fn):
        if name in REGISTRY:
            raise ValueError(f"duplicate invariant {name!r}")
        REGISTRY[name] = Invariant(name=name, kind=kind,
                                   engines=tuple(engines), doc=doc, fn=fn)
        return fn

    return deco


def invariant_names(engine: str, names: tuple | None = None) -> tuple:
    """The ordered property names the checker evaluates for ``engine``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    return tuple(n for n, inv in REGISTRY.items()
                 if engine in inv.engines and (names is None or n in names))


# ---------------------------------------------------------------------------
# check context


@dataclasses.dataclass
class Consts:
    """The checker's build-time constants on one device, made before any
    capture: ``true`` (a 0-d True), ``ones_n`` ([N] True: the liveness of
    an engine without ``up``), ``ar_n`` (int32 arange(N)), ``ar_e`` (int64
    arange(N*K), the involution's), ``pad`` (the [W] padding-bit mask as
    int32 words, or None), ``default_due`` (the all-disabled due row)."""

    true: torch.Tensor
    ones_n: torch.Tensor
    ar_n: torch.Tensor
    ar_e: torch.Tensor
    pad: torch.Tensor | None
    default_due: torch.Tensor

    @classmethod
    def build(cls, n: int, k: int, m: int, device) -> "Consts":
        pad = _pad_word_mask(m)
        return cls(
            true=torch.ones((), dtype=torch.bool, device=device),
            ones_n=torch.ones((n,), dtype=torch.bool, device=device),
            ar_n=torch.arange(n, dtype=torch.int32, device=device),
            ar_e=torch.arange(n * k, dtype=torch.int64, device=device),
            pad=None if pad is None else torch.as_tensor(pad.view(np.int32), device=device),
            default_due=torch.as_tensor(due_vector(), device=device),
        )


@dataclasses.dataclass
class Ctx:
    """Per-check context (a plain container, built fresh at each check)."""

    engine: str
    net: object              # state.Net (overlay-rebound for dynamic states)
    cfg: object              # GossipSubConfig | None (mesh engines)
    inv: "InvariantConfig"
    state: object            # SimState | GossipSubState
    core: object             # SimState
    gs: object               # GossipSubState | None
    tick: torch.Tensor       # 0-d i32 (post-step: rounds executed so far)
    due: torch.Tensor        # i32[DUE_LEN]
    prev_events: torch.Tensor  # [N_EVENTS] i32 (last check's counters)
    nbr_sub: object          # [N,S,K] bool static mesh-eligibility const
    up: torch.Tensor         # [N] bool effective liveness
    consts: Consts


def _mesh_eligible_const(net) -> torch.Tensor:
    """[N,S,K]: neighbor k is a legal mesh member for my slot s — present
    edge, both ends mesh-capable (/meshsub/*), neighbor subscribed to the
    slot's topic, slot live. The receiver-side transcription of the
    heartbeat candidate filter's static part (gossipsub.go:1374-1380)."""
    from ..models.gossipsub import gather_nbr_subscribed

    mesh_capable = (net.protocol[net.nbr.clamp(min=0).long()] >= 1) & net.nbr_ok
    return (gather_nbr_subscribed(net) & mesh_capable[:, None, :]
            & (net.protocol >= 1)[:, None, None])


def _core_of(state):
    return state.core if hasattr(state, "core") else state


def _pad_word_mask(m: int) -> np.ndarray | None:
    """[W] u32 mask of padding bits (bit positions >= m) in a packed word
    plane, or None when m fills its words exactly."""
    from ..ops import bitset

    w = bitset.n_words(m)
    if m == w * bitset.WORD:
        return None
    valid = np.zeros((w * bitset.WORD,), bool)
    valid[:m] = True
    words = np.zeros((w,), np.uint32)
    for i in range(w * bitset.WORD):
        if not valid[i]:
            words[i // bitset.WORD] |= np.uint32(1) << np.uint32(
                i % bitset.WORD)
    return words


def _expected_receivers(ctx) -> torch.Tensor:
    """[N, M] bool: peer n is an expected receiver of live message m —
    subscribed to its topic, currently up, and not the origin (the origin's
    copy is its own; floodsub.go:85-88)."""
    msgs = ctx.core.msgs
    n = ctx.net.subscribed.shape[0]
    live = msgs.birth >= 0
    topic = msgs.topic.clamp(min=0).long()
    origin = msgs.origin.clamp(0, n - 1)
    sub = ctx.net.subscribed[:, topic]                       # [N, M]
    is_origin = ctx.consts.ar_n[:, None] == origin[None, :]
    return sub & live[None, :] & ~is_origin & ctx.up[:, None]


def _nbr_up(ctx) -> torch.Tensor:
    """[N, K]: the neighbor on slot k is up (absent slots read peer 0)."""
    return ctx.up[ctx.net.nbr.clamp(min=0).long()]


# ---------------------------------------------------------------------------
# core-state properties (all four engines)


@invariant(
    "msgtable-wf", kind="safety", engines=CORE_ENGINES,
    doc="message-table slot consistency: live slots carry a legal "
        "(topic, origin, birth) triple, verdicts are exclusive, and "
        "first-receipt stamps lie in [birth, tick] (the interned "
        "message-id space FloodSub's dedup argument relies on, "
        "arXiv:2507.19013 §seen-cache)")
def _msgtable_wf(ctx) -> torch.Tensor:
    msgs = ctx.core.msgs
    n = ctx.net.subscribed.shape[0]
    t_dim = ctx.net.subscribed.shape[1]
    live = msgs.birth >= 0
    ok = ((msgs.topic >= 0) == live).all()
    ok = ok & ((msgs.origin >= 0) == live).all()
    ok = ok & ((msgs.topic < t_dim) | ~live).all()
    ok = ok & ((msgs.origin < n) | ~live).all()
    ok = ok & ~(msgs.valid & msgs.ignored).any()
    fr = ctx.core.dlv.first_round
    stamped = fr >= 0
    ok = ok & (live[None, :] | ~stamped).all()
    ok = ok & ((fr >= msgs.birth[None, :]) | ~stamped).all()
    ok = ok & ((fr <= ctx.tick) | ~stamped).all()
    return ok


@invariant(
    "fwd-subset-have", kind="safety", engines=CORE_ENGINES,
    doc="no forward of an unseen slot: the forward set is a subset of "
        "the seen-cache (markSeen precedes any forward, "
        "validation.go:285-293; arXiv:2507.19013 dedup soundness)")
def _fwd_subset_have(ctx) -> torch.Tensor:
    dlv = ctx.core.dlv
    return ~(dlv.fwd & ~dlv.have).any()


def _or_and_pairs(fe: torch.Tensor):
    """(acc, multi) over the edge axis of ``fe`` [N, K, W]: acc the OR of
    the K words, multi the bits set on two edges or more. A tree of
    pairwise merges: a merged group's multi is either half's multi or a bit
    both halves hold."""
    if fe.shape[1] == 0:
        z = torch.zeros(fe.shape[:1] + fe.shape[2:], dtype=fe.dtype, device=fe.device)
        return z, z
    acc, multi = fe, torch.zeros_like(fe)
    while acc.shape[1] > 1:
        if acc.shape[1] % 2:
            acc = torch.cat([acc, torch.zeros_like(acc[:, :1])], dim=1)
            multi = torch.cat([multi, torch.zeros_like(multi[:, :1])], dim=1)
        a, b = acc[:, 0::2], acc[:, 1::2]
        multi = multi[:, 0::2] | multi[:, 1::2] | (a & b)
        acc = a | b
    return acc[:, 0], multi[:, 0]


@invariant(
    "first-edge-wf", kind="safety", engines=CORE_ENGINES,
    doc="first-arrival attribution well-formedness: at most one "
        "first-arrival edge per (peer, message), and every attributed "
        "message is in the seen-cache (the delivery-attribution plane "
        "P3/P7 scoring reads); mutation-aware — graced inside the "
        "DUE_MUT_GRACE window around topology-mutation ticks")
def _first_edge_wf(ctx) -> torch.Tensor:
    dlv = ctx.core.dlv
    fe = dlv.fe_words                    # [N, K, W] ([E, W] CSR-resident)
    if fe.dim() == 2:
        fe = ctx.net.unpack_edges(fe)
    acc, multi = _or_and_pairs(fe)
    ok = ~multi.any() & ~(acc & ~dlv.have).any()
    return (ctx.due[DUE_MUT_GRACE] != 0) | ok


@invariant(
    "edge-involution-wf", kind="safety", engines=CORE_ENGINES,
    doc="the edge pool is structurally sound: edge_perm is a "
        "self-inverse permutation, absent slots self-point, present "
        "slots are partner-consistent (reverse present and pointing "
        "back, no self-edges, indices in range) — the involution "
        "contract every masked gather assumes, which dynamic-overlay "
        "mutation must preserve batch by batch (arXiv:1507.08417 "
        "dynamic-complex-network dissemination regime)")
def _edge_involution_wf(ctx) -> torch.Tensor:
    from ..ops import edges as _ops_edges

    topo = getattr(ctx.core, "topo", None)
    if topo is None:
        # a frozen overlay: the planes were validated once at Net.build and
        # nothing on the device writes them
        return ctx.consts.true
    net = ctx.net  # already overlay-rebound for dynamic states
    ok = _ops_edges.involution_wf(net.nbr, net.rev, net.nbr_ok, net.edge_perm,
                                  ar=ctx.consts.ar_e)
    return ok & (topo.epoch >= 0).all()


@invariant(
    "word-padding-wf", kind="safety", engines=CORE_ENGINES,
    doc="packed-word bitset well-formedness: padding bits beyond the "
        "message capacity are zero in every word plane (a set padding "
        "bit silently corrupts popcounts and keep-folds)")
def _word_padding_wf(ctx) -> torch.Tensor:
    pad = ctx.consts.pad
    if pad is None:
        return ctx.consts.true
    dlv = ctx.core.dlv
    planes = [dlv.have, dlv.fwd, dlv.fe_words]
    if dlv.pending is not None:
        planes.append(dlv.pending)
    if ctx.gs is not None:
        planes += [ctx.gs.mcache, ctx.gs.ihave_out, ctx.gs.iwant_out,
                   ctx.gs.served_lo, ctx.gs.served_hi]
    ok = ctx.consts.true
    for p in planes:
        ok = ok & ~(p & pad).any()
    return ok


@invariant(
    "events-monotone", kind="safety", engines=CORE_ENGINES,
    doc="cumulative trace counters never decrease between checks — the "
        "runtime face of 'score/misbehaviour counters are monotone on "
        "recorded events' (arXiv:2311.08859 counter lemmas)")
def _events_monotone(ctx) -> torch.Tensor:
    return (ctx.core.events >= ctx.prev_events).all()


@invariant(
    "eventual-delivery", kind="liveness", engines=CORE_ENGINES,
    doc="window-checked eventual delivery: a validated publish whose "
        "whole W-round propagation window was fault-quiet has reached "
        "every subscribed up peer; partition-era messages still in "
        "mcache at heal deliver by the post-heal deadline "
        "(arXiv:2507.19013 fair-loss delivery; arXiv:2311.08859 "
        "heal-liveness, scoped per docs/DESIGN.md §12)")
def _eventual_delivery(ctx) -> torch.Tensor:
    msgs = ctx.core.msgs
    w = int(ctx.inv.delivery_window)
    due = ctx.due
    birth = msgs.birth
    quiet_on = due[DUE_QUIET_LO] >= 0
    quiet_due = (quiet_on
                 & (birth >= due[DUE_QUIET_LO])
                 & (birth + w <= due[DUE_QUIET_HI])
                 & (birth + w <= ctx.tick))
    rec_on = due[DUE_R_LO] >= 0
    rec_due = (rec_on
               & (birth >= due[DUE_R_LO])
               & (birth <= due[DUE_R_HI])
               & (ctx.tick >= due[DUE_R_DEADLINE]))
    due_m = (quiet_due | rec_due) & (birth >= 0) & msgs.valid
    if msgs.wire_block is not None:
        # oversized messages are never transmitted on any edge: the spec
        # scopes delivery to transmissible publishes
        due_m = due_m & ~msgs.wire_block
    delivered = ctx.core.dlv.first_round >= 0        # [N, M]
    expected = _expected_receivers(ctx)
    return ~(expected & due_m[None, :] & ~delivered).any()


# ---------------------------------------------------------------------------
# gossipsub-state properties (per-round + phase engines)


@invariant(
    "no-self-mesh", kind="safety", engines=GOSSIP_ENGINES,
    doc="no self-graft: the mesh and the GRAFT outbox never target the "
        "peer itself (arXiv:2311.08859 'a node never grafts itself')")
def _no_self_mesh(ctx) -> torch.Tensor:
    gs = ctx.gs
    self_edge = ctx.net.nbr == ctx.consts.ar_n[:, None]
    bad = (gs.mesh | gs.graft_out) & self_edge[:, None, :]
    return ~bad.any()


@invariant(
    "mesh-in-topology", kind="safety", engines=GOSSIP_ENGINES,
    doc="mesh edges exist: every mesh member rides a present topology "
        "edge whose both endpoints are up and unblacklisted (dead-peer "
        "cleanup, pubsub.go:648-689); mutation-aware — reads the "
        "overlay-rebound net and is graced inside the DUE_MUT_GRACE "
        "window around topology-mutation ticks")
def _mesh_in_topology(ctx) -> torch.Tensor:
    gs = ctx.gs
    edge_ok = ctx.net.nbr_ok & _nbr_up(ctx) & ctx.up[:, None]
    ok = ~(gs.mesh & ~edge_ok[:, None, :]).any()
    # ctx.net is overlay-rebound, so mesh state keyed to a just-rewired
    # slot is cleared in the round the edge changes; DUE_MUT_GRACE covers
    # the checks whose window saw a mutation batch
    return (ctx.due[DUE_MUT_GRACE] != 0) | ok


@invariant(
    "mesh-subscribed", kind="safety", engines=GOSSIP_ENGINES,
    doc="mesh ⊆ topology ∩ subscription: a mesh member is mesh-capable "
        "and subscribed to the slot's topic, and the slot is live "
        "(arXiv:2311.08859 mesh-subset invariant; gossipsub.go:1374)")
def _mesh_subscribed(ctx) -> torch.Tensor:
    return ~(ctx.gs.mesh & ~ctx.nbr_sub).any()


def _slot_live(ctx) -> torch.Tensor:
    """[N, S]: slots whose degree clauses apply — topic joined, peer
    mesh-capable and currently up."""
    return ((ctx.net.my_topics >= 0)
            & (ctx.net.protocol >= 1)[:, None]
            & ctx.up[:, None])


def _degree_lower_ok(ctx) -> torch.Tensor:
    """[N, S]: the degree LOWER clause — ``deg >= Dlo`` unless no eligible
    candidate remains. The candidate set is the heartbeat's own filter
    (connected, subscribed, not in the mesh, no backoff, not direct, score
    >= 0; gossipsub.go:1374-1380), one source for `mesh-degree-bounds` and
    `mesh-reform-after-heal`."""
    gs, cfg = ctx.gs, ctx.cfg
    deg = gs.mesh.sum(dim=-1, dtype=torch.int32)             # [N, S]
    cand = ctx.nbr_sub & ~gs.mesh & ~gs.backoff_present
    cand = cand & ~ctx.net.direct[:, None, :]
    cand = cand & (_nbr_up(ctx) & ctx.up[:, None])[:, None, :]
    if cfg.score_enabled:
        cand = cand & (gs.scores >= 0.0)[:, None, :]
    n_cand = cand.sum(dim=-1, dtype=torch.int32)             # [N, S]
    return (deg >= cfg.Dlo) | (n_cand == 0)


@invariant(
    "mesh-degree-bounds", kind="safety", engines=GOSSIP_ENGINES,
    doc="heartbeat-boundary mesh degree bounds: deg <= Dhi plus the "
        "reference's own outbound-quota/opportunistic overshoot "
        "(gossipsub.go:1451-1510), and deg >= Dlo unless no eligible "
        "candidate remains; suspended inside fault grace windows "
        "(arXiv:2311.08859 degree bounds)")
def _mesh_degree_bounds(ctx) -> torch.Tensor:
    gs, cfg = ctx.gs, ctx.cfg
    deg = gs.mesh.sum(dim=-1, dtype=torch.int32)             # [N, S]
    overshoot = cfg.Dout + (cfg.opportunistic_graft_peers
                            if cfg.score_enabled else 0)
    upper = deg <= (cfg.Dhi + overshoot)
    ok = ((upper & _degree_lower_ok(ctx)) | ~_slot_live(ctx)).all()
    return (ctx.due[DUE_GRACE] != 0) | ok


@invariant(
    "no-graft-under-backoff", kind="safety", engines=GOSSIP_ENGINES,
    doc="backoff respected: GRAFT is never sent to a peer whose prune "
        "backoff is still present (the candidate filter tests presence, "
        "gossipsub.go:1374-1380; arXiv:2311.08859 backoff lemma)")
def _no_graft_under_backoff(ctx) -> torch.Tensor:
    gs = ctx.gs
    return ~(gs.graft_out & gs.backoff_present).any()


@invariant(
    "graylist-not-in-mesh", kind="safety", engines=GOSSIP_ENGINES,
    doc="graylisted (negatively scored) peers are absent from the mesh "
        "under the memoized score plane the router acts on "
        "(gossipsub.go:1361-1368, :772-783; graylist_threshold <= 0 "
        "makes score >= 0 the stricter bound; arXiv:2311.08859 "
        "score-exclusion)")
def _graylist_not_in_mesh(ctx) -> torch.Tensor:
    if not ctx.cfg.score_enabled:
        return ctx.consts.true
    return ~(ctx.gs.mesh & (ctx.gs.scores < 0.0)[:, None, :]).any()


@invariant(
    "mcache-subset-seen", kind="safety", engines=GOSSIP_ENGINES,
    doc="mcache slot consistency: every message cached for IWANT "
        "service was seen by this peer (mcache.Put happens on "
        "validated receipt or own publish, gossipsub.go:946)")
def _mcache_subset_seen(ctx) -> torch.Tensor:
    from ..ops import bitset

    window = bitset.word_or_reduce(ctx.gs.mcache, dim=1)     # [N, W]
    return ~(window & ~ctx.core.dlv.have).any()


@invariant(
    "score-counters-wf", kind="safety", engines=GOSSIP_ENGINES,
    doc="score counters well-formed: every delivery/penalty counter is "
        "finite and non-negative (the domain the arXiv:2311.08859 "
        "counter-monotonicity lemmas quantify over)")
def _score_counters_wf(ctx) -> torch.Tensor:
    if not ctx.cfg.score_enabled:
        return ctx.consts.true
    sc = ctx.gs.score
    ok = ctx.consts.true
    for plane in (sc.fmd, sc.mmd, sc.mfp, sc.imd, sc.bp):
        ok = ok & (torch.isfinite(plane) & (plane >= 0.0)).all()
    ok = ok & (sc.mesh_time >= 0).all()
    ok = ok & (sc.graft_tick >= -1).all()
    ok = ok & torch.isfinite(ctx.gs.scores).all()
    return ok


@invariant(
    "backoff-wf", kind="safety", engines=GOSSIP_ENGINES,
    doc="backoff bookkeeping: an unexpired backoff is always present "
        "(presence outlives expiry until the lazy clear, never the "
        "reverse; gossipsub.go:1585-1604)")
def _backoff_wf(ctx) -> torch.Tensor:
    gs = ctx.gs
    ok = (gs.backoff_expire >= 0).all()
    active = gs.backoff_expire > ctx.tick
    return ok & ~(active & ~gs.backoff_present).any()


@invariant(
    "backoff-clears", kind="liveness", engines=GOSSIP_ENGINES,
    doc="backoff eventually clears: no backoff presence survives past "
        "its expiry plus the slack and one full lazy-clear period "
        "(clearBackoff cadence, gossipsub.go:1585-1604)")
def _backoff_clears(ctx) -> torch.Tensor:
    gs, cfg = ctx.gs, ctx.cfg
    bound = (gs.backoff_expire + (cfg.backoff_slack_ticks + cfg.backoff_clear_ticks
                                  + cfg.heartbeat_every + 1))
    return ~(gs.backoff_present & (ctx.tick > bound)).any()


@invariant(
    "promise-wf", kind="safety", engines=GOSSIP_ENGINES,
    doc="gossip-promise well-formedness: a live IWANT promise names an "
        "in-range message slot on a present edge with a valid expiry "
        "(gossip_tracer.go:48-75)")
def _promise_wf(ctx) -> torch.Tensor:
    gs = ctx.gs
    m = ctx.core.msgs.capacity
    live = gs.promise_mid >= 0
    ok = (gs.promise_mid >= -1).all() & (gs.promise_mid < m).all()
    ok = ok & ((gs.promise_expire >= 0) | ~live).all()
    ok = ok & (ctx.net.nbr_ok | ~live).all()
    return ok


@invariant(
    "mesh-reform-after-heal", kind="liveness", engines=GOSSIP_ENGINES,
    doc="partition heal is followed by mesh re-formation: once the "
        "post-heal deadline passes, the degree lower bound holds again "
        "(the arXiv:2311.08859 heal-then-re-form liveness clause)")
def _mesh_reform_after_heal(ctx) -> torch.Tensor:
    active = (ctx.due[DUE_R_LO] >= 0) & (ctx.tick >= ctx.due[DUE_R_DEADLINE])
    ok = (_degree_lower_ok(ctx) | ~_slot_live(ctx)).all()
    return ~active | ok


@invariant(
    "choke-wf", kind="safety", engines=GOSSIP_ENGINES,
    doc="router choke well-formedness: choked ⊆ mesh — a choked link is "
        "a DEMOTED mesh link, never a non-mesh edge (episub lazy links "
        "keep mesh membership; arXiv:2312.06800 §3, routers/choke.py "
        "guard, docs/DESIGN.md §24b); vacuously true off router builds")
def _choke_wf(ctx) -> torch.Tensor:
    gs = ctx.gs
    if getattr(gs, "choked", None) is None:
        return ctx.consts.true
    return ~(gs.choked & ~gs.mesh).any()


@invariant(
    "no-choke-below-dlo", kind="safety", engines=GOSSIP_ENGINES,
    doc="choke degree floor: a topic slot holding any choked link keeps "
        "at least Dlo unchoked mesh members — lazy demotion must never "
        "starve a slot's eager delivery (the arXiv:2312.06800 safety "
        "bound the choke budget + guard enforce at every mesh mutation "
        "site, docs/DESIGN.md §24b); vacuously true off router builds")
def _no_choke_below_dlo(ctx) -> torch.Tensor:
    gs, cfg = ctx.gs, ctx.cfg
    if getattr(gs, "choked", None) is None:
        return ctx.consts.true
    unchoked = (gs.mesh & ~gs.choked).sum(dim=-1, dtype=torch.int32)
    any_choked = gs.choked.any(dim=-1)
    return ~(any_choked & (unchoked < cfg.Dlo)).any()


# ---------------------------------------------------------------------------
# the checker


def check_state(engine: str, net, state, cfg=None,
                inv: InvariantConfig | None = None,
                *, prev_events=None, due=None,
                nbr_sub=None, consts: Consts | None = None) -> torch.Tensor:
    """Evaluate every applicable property on one state. Returns a ``[P]``
    bool tensor on the state's device, ordered by :func:`invariant_names`
    (True = the property holds). Device ops only.

    ``prev_events`` defaults to the state's own counters (the monotone
    check is then a tautology); ``due`` defaults to the all-disabled
    vector (liveness clauses vacuous, no grace); ``nbr_sub`` and
    ``consts`` let a caller reuse the build-time constants across checks
    (``make_checker`` does; inside a capture they must be given)."""
    inv = inv or InvariantConfig()
    inv.validate()
    names = invariant_names(engine, inv.names)
    if not names:
        raise InvariantConfigError(
            f"no registered property applies to engine {engine!r} with "
            f"names={inv.names!r} — the effective property set is empty")
    core = _core_of(state)
    gs = state if hasattr(state, "core") else None
    if gs is None and engine in GOSSIP_ENGINES:
        raise ValueError(
            f"engine {engine!r} checks GossipSubState trees; got a bare "
            "SimState")
    if gs is not None and cfg is None:
        raise ValueError("gossipsub-state checks need the GossipSubConfig")
    dev = core.events.device
    if consts is None:
        consts = Consts.build(net.n_peers, net.max_degree, core.msgs.capacity, dev)
    if due is None:
        due = consts.default_due
    if getattr(core, "topo", None) is not None:
        # a dynamic overlay: the state carries the current edge pool, so
        # every topology-reading property sees it, and a hoisted
        # mesh-eligibility constant is stale by construction
        net = net.with_overlay(core.topo)
        nbr_sub = None
    if nbr_sub is None and gs is not None:
        nbr_sub = _mesh_eligible_const(net)
    up = gs.up & ~gs.blacklist if gs is not None else consts.ones_n
    ctx = Ctx(
        engine=engine, net=net, cfg=cfg, inv=inv, state=state, core=core,
        gs=gs, tick=core.tick,
        due=torch.as_tensor(due, dtype=torch.int32, device=dev),
        prev_events=(torch.as_tensor(prev_events, dtype=core.events.dtype, device=dev)
                     if prev_events is not None else core.events),
        nbr_sub=nbr_sub, up=up, consts=consts,
    )
    return torch.stack([REGISTRY[n_].fn(ctx) for n_ in names])


def sim_state(states, s: int):
    """Sim ``s`` of a state whose every tensor leaf carries a leading S
    axis."""
    from ..driver import _leaves, _rebuild

    return _rebuild(states, iter([t[s] for t in _leaves(states)]))


def make_checker(engine: str, net, cfg=None,
                 inv: InvariantConfig | None = None,
                 *, batched: bool = False):
    """Build the invariant checker of one engine build: ``(fn, names)``
    with ``fn(state, prev_events, due) -> [P] bool`` (``[S, P]`` with
    ``batched=True``: state and prev_events carry a leading S axis, the due
    row is shared, and the sims are checked one after another and stacked).

    A plain function, not compiled. Its constants are built on the net's
    device before it runs in a capture: the static mesh-eligibility plane
    here, the padding mask and the aranges at its first check (a window's
    warm-up makes that before its capture). It writes nothing: it reads
    the live state the run keeps using."""
    inv = inv or InvariantConfig()
    inv.validate()
    names = invariant_names(engine, inv.names)
    nbr_sub = _mesh_eligible_const(net) if engine in GOSSIP_ENGINES else None
    held = {}    # Consts by message capacity

    def one(state, prev_events, due):
        m = _core_of(state).msgs.capacity
        if m not in held:
            held[m] = Consts.build(net.n_peers, net.max_degree, m, net.device)
        return check_state(engine, net, state, cfg, inv, prev_events=prev_events,
                           due=due, nbr_sub=nbr_sub, consts=held[m])

    if not batched:
        return one, names

    def check(states, prev_events, due):
        s_dim = _core_of(states).events.shape[0]
        return torch.stack([one(sim_state(states, s), prev_events[s], due)
                            for s in range(s_dim)])

    return check, names


# ---------------------------------------------------------------------------
# the runner hook + report


@dataclasses.dataclass
class InvariantReport:
    """Host-side summary of a checked run (read back after the run: the
    device verdicts transfer once)."""

    engine: str
    names: tuple
    ticks: tuple                 # tick per check (post-dispatch rounds)
    ok: np.ndarray               # [n_checks, S, P] bool
    check_every: int
    rounds_per_step: int

    @property
    def n_checks(self) -> int:
        return int(self.ok.shape[0])

    @property
    def n_sims(self) -> int:
        return int(self.ok.shape[1])

    @property
    def all_ok(self) -> bool:
        return bool(self.ok.all())

    @property
    def checked(self) -> int:
        """Total property evaluations (checks x sims x properties)."""
        return int(self.ok.size)

    @property
    def violated(self) -> int:
        return int((~self.ok).sum())

    @property
    def last_checked_round(self) -> int:
        return int(self.ticks[-1]) if self.ticks else -1

    def violations(self, limit: int = 32) -> list:
        """(tick, sim, property) triples of failed evaluations."""
        out = []
        bad = np.argwhere(~self.ok)
        for ci, si, pi in bad[:limit]:
            out.append((int(self.ticks[ci]), int(si), self.names[pi]))
        return out

    def per_property(self) -> dict:
        """name -> (evaluations, violations) over the whole run."""
        return {
            name: (int(self.ok[:, :, i].size), int((~self.ok[:, :, i]).sum()))
            for i, name in enumerate(self.names)
        }

    def artifact_block(self) -> dict:
        """The schema-v3 ``invariants`` artifact block."""
        return {
            "enabled": True,
            "engine": self.engine,
            "properties": list(self.names),
            "checked": self.checked,
            "violated": self.violated,
            "n_checks": self.n_checks,
            "n_sims": self.n_sims,
            "check_every": int(self.check_every),
            "rounds_per_step": int(self.rounds_per_step),
            "last_checked_round": self.last_checked_round,
            "violations": [
                {"round": t, "sim": s, "property": p}
                for t, s, p in self.violations()
            ],
        }


def _due_row(due_fn, tick: int) -> np.ndarray:
    return np.asarray(due_fn(tick) if due_fn is not None else due_vector(), np.int32)


class ScanInvariants:
    """The window-folded face of the oracle plane: the same registry, due
    contract and report as :class:`InvariantHook`, evaluated inside a run
    window (``driver.make_window(check=spec.check, check_every=
    spec.check_every)``) instead of once a dispatch from the host. On the
    card the checks are part of the window's captured graph, so a checked
    window is still one graph replay a block.

    Two differences from the hook:

    * the first check's ``events-monotone`` compares against the
      window-entry counters instead of the hook's first-observation
      tautology (stronger, never weaker: counters are born monotone);
    * the counters snapshot needs no copy on the CPU (the window holds the
      last check's counters); on the card it is a static buffer of the
      capture.

    ``check`` is the predicate ``(state, prev_events, due_row) -> [P]``
    (``[S, P]`` when ``batched``); :meth:`precompute` makes the stacked
    ``[n_checks, DUE_LEN]`` due rows on the device before the window runs;
    :meth:`report` turns the window's ``ys["ok"]`` into the standard
    :class:`InvariantReport`."""

    def __init__(self, engine: str, net, cfg=None,
                 inv: InvariantConfig | None = None, *,
                 batched: bool = True, due_fn=None,
                 rounds_per_step: int = 1):
        self.engine = engine
        self.inv = inv or InvariantConfig()
        self.inv.validate()
        self.names = invariant_names(engine, self.inv.names)
        self.batched = batched
        self.due_fn = due_fn
        self.rounds_per_step = max(int(rounds_per_step), 1)
        self.device = net.device
        self.check, _ = make_checker(engine, net, cfg, self.inv, batched=batched)
        self._due = None
        self._ticks: tuple = ()

    @property
    def check_every(self) -> int:
        return self.inv.check_every

    def n_checks(self, n_steps: int) -> int:
        return int(n_steps) // self.inv.check_every

    def precompute(self, n_steps: int) -> torch.Tensor:
        """The stacked ``[n_checks, DUE_LEN]`` int32 due rows of an
        ``n_steps``-dispatch window on the device (the host-to-device copy
        happens here, not inside the window), and the tick labels."""
        ce = self.inv.check_every
        rows, ticks = [], []
        for i in range(int(n_steps)):
            if (i + 1) % ce:
                continue
            tick = (i + 1) * self.rounds_per_step
            rows.append(_due_row(self.due_fn, tick))
            ticks.append(tick)
        self._ticks = tuple(ticks)
        self._due = torch.as_tensor(
            np.stack(rows) if rows else np.zeros((0, DUE_LEN), np.int32),
            device=self.device)
        return self._due

    def due_rows(self, n_steps: int) -> torch.Tensor:
        if self._due is None or self._due.shape[0] != self.n_checks(n_steps):
            self.precompute(n_steps)
        return self._due

    def report(self, ok, ticks=None) -> InvariantReport:
        """Summarize the window's stacked ``ys["ok"]`` (``[n_checks, P]``
        unbatched, ``[n_checks, S, P]`` batched) as an
        :class:`InvariantReport`."""
        ok = np.asarray(ok.cpu() if isinstance(ok, torch.Tensor) else ok)
        if ok.ndim == 2:
            ok = ok[:, None, :]
        if ok.size and ok.shape[-1] != len(self.names):
            raise ValueError(
                f"ok mask property axis {ok.shape[-1]} != "
                f"{len(self.names)} registered for {self.engine!r}")
        return InvariantReport(
            engine=self.engine, names=self.names,
            ticks=tuple(ticks) if ticks is not None else self._ticks,
            ok=ok, check_every=self.inv.check_every,
            rounds_per_step=self.rounds_per_step,
        )


class InvariantHook:
    """The ``check_every=k`` observer a dispatch loop drives: every k
    dispatches it evaluates the checker on the live state and keeps the
    ``[P]`` (``[S, P]`` batched) verdict on the device, so the loop copies
    nothing to the host; :meth:`report` reads everything back afterwards.
    (:class:`ScanInvariants` is the window-folded equivalent.)

    ``due_fn(tick) -> int32[DUE_LEN]`` supplies the schedule context of
    each check (see :func:`due_vector`); :meth:`precompute` makes every
    check's row on the device before the run. ``rounds_per_step`` is the
    engine cadence (1 for per-round engines, r for the phase engine), used
    only to label ticks."""

    def __init__(self, engine: str, net, cfg=None,
                 inv: InvariantConfig | None = None, *,
                 batched: bool = True, due_fn=None,
                 rounds_per_step: int = 1):
        self.engine = engine
        self.inv = inv or InvariantConfig()
        self.checker, self.names = make_checker(
            engine, net, cfg, self.inv, batched=batched)
        self.batched = batched
        self.due_fn = due_fn
        self.rounds_per_step = max(int(rounds_per_step), 1)
        self.device = net.device
        self._due_rows: list | None = None
        self._results: list = []
        self._ticks: list = []
        self._prev_events = None

    @property
    def compiles(self) -> int:
        """The checker's compile count: -1, unknown (the checker is a plain
        function; a checked window's one capture is ``Window.captures``)."""
        return -1

    def reset(self) -> None:
        """Clear the accumulated results and the counters snapshot (not the
        precomputed due rows), to reuse one hook across independent runs: a
        previous run's final counters would read a fresh run's as a bogus
        events-monotone violation."""
        self._results = []
        self._ticks = []
        self._prev_events = None

    def precompute(self, n_steps: int) -> None:
        """Every check's due row on the device, made before the run."""
        if self._due_rows is not None:
            return
        rows = []
        for i in range(int(n_steps)):
            if (i + 1) % self.inv.check_every:
                rows.append(None)
                continue
            tick = (i + 1) * self.rounds_per_step
            rows.append(torch.as_tensor(_due_row(self.due_fn, tick), device=self.device))
        self._due_rows = rows

    def on_step(self, i: int, states) -> None:
        """Called after dispatch ``i`` with the live (batched) state."""
        if self._due_rows is None or i >= len(self._due_rows):
            # a dispatch past precompute: the row is made now
            if (i + 1) % self.inv.check_every:
                return
            tick = (i + 1) * self.rounds_per_step
            due = torch.as_tensor(_due_row(self.due_fn, tick), device=self.device)
        else:
            due = self._due_rows[i]
            if due is None:
                return
        core = _core_of(states)
        prev = self._prev_events
        if prev is None:
            prev = core.events       # first check: tautological monotone
        ok = self.checker(states, prev, due)
        self._results.append(ok)
        self._ticks.append((i + 1) * self.rounds_per_step)
        # a copy, never an alias: a window reuses its state buffers, so
        # core.events itself would hold the next dispatch's counters
        self._prev_events = core.events.clone()

    def report(self) -> InvariantReport:
        """Copy the accumulated verdicts to the host and summarize."""
        if self._results:
            ok = torch.stack(self._results).cpu().numpy()
            if ok.ndim == 2:     # unbatched checker: [n_checks, P]
                ok = ok[:, None, :]
        else:
            ok = np.zeros((0, 1, len(self.names)), bool)
        return InvariantReport(
            engine=self.engine, names=self.names,
            ticks=tuple(self._ticks), ok=ok,
            check_every=self.inv.check_every,
            rounds_per_step=self.rounds_per_step,
        )
