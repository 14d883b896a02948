"""Device-resident simulation state (struct-of-arrays) as dataclasses of
tensors.

Message ids are interned to slots of a rotating global table of capacity
M; per-peer message sets (seen-cache, forward sets) are packed 32-bit word
planes over those slots (stored as int32, see ``ops/bitset.py``). A slot is
recycled when the cursor wraps; recycling clears its bit column everywhere.

Every entry point takes an explicit ``device``. None means the card: with
no CUDA device it raises instead of running on the CPU, so a measurement can
never land on the wrong device by accident. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import graph as graphlib
from . import prng
from .ops import bitset, csr, edges
from .telemetry.panel import TelemetryState
from .trace.events import zero_counters


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    card — raising when no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda")


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over matching dataclass trees (None leaves
    stay None)."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)
        })
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    return t0


@dataclasses.dataclass
class Net:
    """Static network: topology + subscriptions + identity (see graph.py
    for field semantics), in the dense layout or, with
    ``edge_layout="csr"``, with the flat edge space of ``ops/csr.py``
    beside it."""

    nbr: torch.Tensor         # [N, K] i32
    nbr_ok: torch.Tensor      # [N, K] bool
    rev: torch.Tensor         # [N, K] i32
    outbound: torch.Tensor    # [N, K] bool
    subscribed: torch.Tensor  # [N, T] bool
    my_topics: torch.Tensor   # [N, S] i32
    slot_of: torch.Tensor     # [N, T] i32
    ip_group: torch.Tensor    # [N] i32 (P6 colocation key)
    direct: torch.Tensor      # [N, K] bool — direct peering edges
    edge_perm: torch.Tensor   # [N, K] i32 flat (nbr*K + rev) involution
    protocol: torch.Tensor    # [N] i8 — 0 floodsub, 1 meshsub/1.0, 2 /1.1
    # banded-regular structure (ops/edges.detect_banded): static; when set,
    # cross-peer gathers are K static rolls and the banded kernels apply
    # (never set on a CSR build)
    band_off: tuple | None = None
    band_rev: tuple | None = None
    # capacity-bounded CSR layout (ops/csr.py), present only when built
    # with edge_layout="csr"; the flat planes are over the E present edges
    edge_layout: str = "dense"
    csr_col: torch.Tensor | None = None           # [E] i32 neighbor per edge
    csr_row: torch.Tensor | None = None           # [E] i32 owner (sorted)
    csr_slot: torch.Tensor | None = None          # [E] i32 dense slot
    csr_eperm: torch.Tensor | None = None         # [E] i32 flat involution
    csr_e_of_nk: torch.Tensor | None = None       # [N, K] i32, -1 absent
    csr_row_ptr: torch.Tensor | None = None       # [N+1] i32
    csr_seg_start: torch.Tensor | None = None     # [E] bool
    csr_row_last: torch.Tensor | None = None      # [N] i32
    csr_row_nonempty: torch.Tensor | None = None  # [N] bool
    # the full-capacity layout of a dynamic build (ops/csr.build_csr_full):
    # every slot owns a flat edge (E = N*K, ``csr_identity``) and
    # ``csr_e_valid`` marks the present ones; None on a static CSR build
    csr_e_valid: torch.Tensor | None = None       # [E] bool
    csr_identity: bool = False
    # the reference's bandwidth-lean composite set; the port's selection
    # has one form in both builds (its ranks equal the reference's sort
    # form), and the CSR delivery round takes the same kernel either way
    # (every row segment has at most K edges in both builds)
    fused: bool = False

    @property
    def device(self) -> torch.device:
        return self.nbr.device

    @property
    def n_edges(self) -> int | None:
        """Present (directed) edge count E of a CSR build; None on a dense
        build."""
        return None if self.csr_col is None else self.csr_col.shape[0]

    # -- flat edge space (edge_layout="csr" only) -------------------------

    def pack_edges(self, x: torch.Tensor) -> torch.Tensor:
        """[N, K, ...] -> [E, ...]: the present slots, row-major (every
        slot, a reshape, on the full-capacity layout)."""
        if self.csr_identity:
            return x.reshape((-1,) + tuple(x.shape[2:]))
        return csr.pack_edges(x, self.csr_row, self.csr_slot)

    def unpack_edges(self, x_e: torch.Tensor, fill=None) -> torch.Tensor:
        """[E, ...] -> [N, K, ...]; absent slots take ``fill`` (zero); a
        reshape on the full-capacity layout."""
        if self.csr_identity:
            return x_e.reshape(tuple(self.csr_e_of_nk.shape) + tuple(x_e.shape[1:]))
        return csr.unpack_edges(x_e, self.csr_e_of_nk, fill)

    def edge_gather_flat(self, x_e: torch.Tensor) -> torch.Tensor:
        """The involution on a flat edge plane: out[e] = x_e[eperm[e]]."""
        return csr.edge_permute_flat(x_e, self.csr_eperm)

    def owner_gather(self, v: torch.Tensor) -> torch.Tensor:
        """v[N, ...] read at each edge's owner row: out[e] = v[row[e]]."""
        return v[self.csr_row]

    def peer_gather_flat(self, v: torch.Tensor) -> torch.Tensor:
        """Flat neighbor view: out[e] = v[col[e]]."""
        return csr.peer_gather_flat(v, self.csr_col)

    def edge_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x[N, K, ...] -> x[nbr[j,k], rev[j,k], ...] (the edge involution);
        callers mask with nbr_ok."""
        if self.band_off is not None:
            return edges.edge_permute_banded(x, self.band_off, self.band_rev)
        return edges.edge_permute(x, self.edge_perm)

    def peer_gather(self, v: torch.Tensor) -> torch.Tensor:
        """v[N, ...] -> [N, K, ...] neighbor view v[nbr[j,k]] (absent slots
        read v[0])."""
        if self.band_off is not None:
            return edges.peer_gather_banded(v, self.band_off)
        got = v[self.nbr.clamp(min=0).long()]
        if self.csr_e_valid is None:
            return got
        # the full-capacity layout reads zero on absent slots, as its
        # flat gather masked by e_valid does
        ok = self.csr_e_valid.reshape(tuple(self.nbr.shape) + (1,) * (v.dim() - 1))
        return torch.where(ok, got, torch.zeros((), dtype=v.dtype, device=v.device))

    def with_overlay(self, topo: "TopoState") -> "Net":
        """The net with its mutable overlay planes (nbr, nbr_ok, rev,
        edge_perm, and on a CSR build the flat col, eperm and e_valid)
        rebound from ``topo``; shapes are unchanged. Needs a
        ``Net.build(..., dynamic=True)`` net: no banded structure, and on
        CSR the full-capacity layout (E = N*K)."""
        if self.band_off is not None:
            raise ValueError("with_overlay: banded structure is static — build the net "
                             "with Net.build(..., dynamic=True)")
        kw = dict(nbr=topo.nbr, nbr_ok=topo.nbr_ok, rev=topo.rev,
                  edge_perm=topo.edge_perm.long())
        if self.edge_layout == "csr":
            e = self.n_peers * self.max_degree
            if not self.csr_identity or self.n_edges != e:
                raise ValueError("with_overlay: the CSR face must be the full-capacity "
                                 "layout (E == N*K) — build the net with Net.build(..., "
                                 "dynamic=True)")
            kw.update(csr_col=topo.nbr.clamp(min=0).reshape(e),
                      csr_eperm=topo.edge_perm.reshape(e),
                      csr_e_valid=topo.nbr_ok.reshape(e))
        return replace(self, **kw)

    @classmethod
    def build(cls, topo: graphlib.Topology, subs: graphlib.Subscriptions,
              ip_group: np.ndarray | None = None,
              direct: np.ndarray | None = None,
              protocol: np.ndarray | None = None,
              edge_layout: str = "dense", fused: bool = False,
              device=None, dynamic: bool = False) -> "Net":
        """``edge_layout="csr"`` adds the flat edge space (the
        reference's static CSR build, without edge-shard padding);
        ``fused`` is carried as the reference carries it. ``dynamic=True``
        builds for the mutable overlay (``TopoState``, ``with_overlay``):
        no banded structure on either layout, and on CSR the full-capacity
        layout (``ops/csr.build_csr_full``)."""
        if edge_layout not in ("dense", "csr"):
            raise ValueError(
                f"edge_layout must be 'dense' or 'csr', got {edge_layout!r}")
        if dynamic and fused:
            raise ValueError("dynamic=True is incompatible with the fused kernel set "
                             "(cfg.fused) — the composites assume a static edge list")
        dev = resolve_device(device)
        n = topo.n_peers
        if ip_group is None:
            ip_group = np.arange(n, dtype=np.int32)
        if direct is None:
            direct = np.zeros(topo.nbr.shape, bool)
        if protocol is None:
            protocol = np.full((n,), 2, np.int8)
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        csr_kw: dict = {}
        if edge_layout == "csr":
            i32 = torch.int32
            if dynamic:
                ct, e_valid = csr.build_csr_full(topo.nbr, topo.rev, topo.nbr_ok)
                # every row owns its K-slot segment: an empty row may gain
                # edges mid-run
                nonempty = np.ones((n,), bool)
                csr_kw = dict(csr_e_valid=t(e_valid, torch.bool), csr_identity=True)
            else:
                ct = csr.build_csr(topo.nbr, topo.rev, topo.nbr_ok)
                nonempty = topo.degree > 0
            csr_kw.update(
                csr_col=t(ct.col, i32), csr_row=t(ct.row, i32),
                csr_slot=t(ct.slot, i32), csr_eperm=t(ct.eperm, i32),
                csr_e_of_nk=t(ct.e_of_nk, i32),
                csr_row_ptr=t(ct.row_ptr, i32),
                csr_seg_start=t(ct.seg_start, torch.bool),
                csr_row_last=t(ct.row_last, i32),
                csr_row_nonempty=t(nonempty, torch.bool),
            )
            # the banded fast paths key off band_off; a CSR build never
            # falls into them
            band = None
        else:
            band = None if dynamic else edges.detect_banded(topo.nbr, topo.rev, topo.nbr_ok)
        return cls(
            edge_layout=edge_layout,
            fused=bool(fused),
            **csr_kw,
            nbr=t(topo.nbr, torch.int32),
            nbr_ok=t(topo.nbr_ok, torch.bool),
            rev=t(topo.rev, torch.int32),
            outbound=t(topo.outbound, torch.bool),
            subscribed=t(subs.subscribed, torch.bool),
            my_topics=t(subs.my_topics, torch.int32),
            slot_of=t(subs.slot_of, torch.int32),
            ip_group=t(ip_group, torch.int32),
            direct=t(direct, torch.bool),
            edge_perm=t(edges.build_edge_perm(topo.nbr, topo.rev, topo.nbr_ok),
                        torch.int64),
            protocol=t(protocol, torch.int8),
            band_off=band[0] if band else None,
            band_rev=band[1] if band else None,
        )

    @property
    def n_peers(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]

    @property
    def n_topics(self) -> int:
        return self.subscribed.shape[1]

    @property
    def n_slots(self) -> int:
        return self.my_topics.shape[1]


@dataclasses.dataclass
class MsgTable:
    """Rotating global message table (the interned message-id space)."""

    topic: torch.Tensor    # [M] i32, -1 = never used
    origin: torch.Tensor   # [M] i32
    birth: torch.Tensor    # [M] i32 round of publish, -1 = never used
    valid: torch.Tensor    # [M] bool — ValidationAccept
    ignored: torch.Tensor  # [M] bool — ValidationIgnore
    cursor: torch.Tensor   # i32 — next slot to allocate (mod M)
    # [M] bool: oversized messages, never transmitted on any edge
    # (VERDICT_WIRE_BLOCK; WithMaxMessageSize pubsub.go:480, the sendRPC
    # drop gossipsub.go:1126-1140); None when the network does not check
    wire_block: torch.Tensor | None = None

    @classmethod
    def empty(cls, m: int, device, wire_block: bool = False) -> "MsgTable":
        full = lambda v: torch.full((m,), v, dtype=torch.int32, device=device)
        zeros = lambda: torch.zeros((m,), dtype=torch.bool, device=device)
        return cls(
            topic=full(-1), origin=full(-1), birth=full(-1),
            valid=zeros(), ignored=zeros(),
            cursor=torch.zeros((), dtype=torch.int32, device=device),
            wire_block=zeros() if wire_block else None,
        )

    @property
    def capacity(self) -> int:
        return self.topic.shape[0]


@dataclasses.dataclass
class Delivery:
    """Per-peer message-delivery state: ``have`` the seen-cache, ``fwd``
    what this peer transmits next round, ``first_round`` the round of first
    receipt (-1 never), ``fe_words`` the packed first-arrival edge plane
    (bit m of row (n, k) set iff m first arrived at n on edge k)."""

    have: torch.Tensor         # [N, W] i32 words
    fwd: torch.Tensor          # [N, W] i32 words
    first_round: torch.Tensor  # [N, M] i32
    fe_words: torch.Tensor     # [N, K, W] i32 words; [E, W] flat on a
                               # CSR-resident state (ndim tells them apart)
    # the async-validation pipeline (validation.go:123-135): receipts sit
    # in V shift stages between arrival and their verdict; None when
    # validation is inline (V = 0)
    pending: torch.Tensor | None = None  # [N, V, W] i32 words

    @property
    def first_edge(self) -> torch.Tensor:
        """[N, M] int8: first-arrival edge slot per message, -1 when none
        (local publish or never received). Needs the dense plane."""
        if self.fe_words.dim() == 2:
            raise ValueError(
                "first_edge needs the dense [N, K, W] plane, but this state "
                "is CSR-resident (flat [E, W] fe_words)")
        return bitset.first_edge_of(self.fe_words, self.first_round.shape[-1])

    @classmethod
    def empty(cls, n: int, m: int, k: int, device, val_delay: int = 0,
              n_edges: int | None = None) -> "Delivery":
        """``n_edges`` selects the CSR-resident first-arrival plane:
        ``fe_words`` is flat ``[E, W]`` instead of ``[N, K, W]`` (pass
        ``net.n_edges``, None on a dense build); ``val_delay`` > 0 adds
        the pipeline's stages."""
        w = bitset.n_words(m)
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return cls(
            have=z(n, w), fwd=z(n, w),
            first_round=torch.full((n, m), -1, dtype=torch.int32, device=device),
            fe_words=z(n, k, w) if n_edges is None else z(n_edges, w),
            pending=z(n, val_delay, w) if val_delay > 0 else None,
        )


@dataclasses.dataclass
class ChaosState:
    """The chaos plane's Gilbert–Elliott chain (``chaos/faults.py``): each
    link's bad state, symmetric over the edge involution by construction.
    Present only in states built for a GE generator
    (``ChaosConfig.needs_state``); the i.i.d. generator and schedules are
    stateless (their masks are functions of the key and the tick)."""

    ge_bad: torch.Tensor  # [N, K] bool, link in the bad state

    @classmethod
    def empty(cls, n: int, k: int, device) -> "ChaosState":
        return cls(ge_bad=torch.zeros((n, k), dtype=torch.bool, device=device))


@dataclasses.dataclass
class TopoState:
    """The mutable overlay of a dynamic-topology build: the state's
    mirror of the net's edge planes, rebound into the net every round
    (``Net.with_overlay``) after the round's writes land
    (``topo/dynamics.apply_mutation``). ``epoch`` counts the writes to
    each slot. The static per-slot flags (``Net.outbound``,
    ``Net.direct``) are not mirrored: a written slot keeps its build-time
    flags, as in the JAX package."""

    nbr: torch.Tensor        # [N, K] i32, -1 absent
    nbr_ok: torch.Tensor     # [N, K] bool
    rev: torch.Tensor        # [N, K] i32
    edge_perm: torch.Tensor  # [N, K] i32 flat involution, absent self-point
    epoch: torch.Tensor      # [N, K] i32 writes per slot

    @classmethod
    def from_net(cls, net: Net) -> "TopoState":
        """Copies of the net's planes (the state is written, the net is
        not); ``edge_perm`` as int32, the JAX leaf's dtype (the net keeps
        it as int64 for indexing)."""
        return cls(
            nbr=net.nbr.to(torch.int32, copy=True),
            nbr_ok=net.nbr_ok.clone(),
            rev=net.rev.to(torch.int32, copy=True),
            edge_perm=net.edge_perm.to(torch.int32, copy=True),
            epoch=torch.zeros(net.nbr.shape, dtype=torch.int32, device=net.device),
        )


@dataclasses.dataclass
class SimState:
    """Router-agnostic core of the step state."""

    tick: torch.Tensor    # i32 current round
    key: torch.Tensor     # threefry key: int64 [2] holding two u32 words
    msgs: MsgTable
    dlv: Delivery
    events: torch.Tensor  # [N_EVENTS] i32 cumulative trace counters
    # the Gilbert–Elliott link-fault chain (GE chaos builds), None otherwise
    chaos: ChaosState | None = None
    # the telemetry panel and flight recorder (telemetry/panel.py), None
    # when telemetry is off
    telem: TelemetryState | None = None
    # the mutable overlay (dynamic-topology builds), None otherwise
    topo: TopoState | None = None

    @classmethod
    def init(cls, n_peers: int, msg_slots: int, seed: int = 0, k: int = 0,
             device=None, n_edges: int | None = None,
             val_delay: int = 0, topo: TopoState | None = None,
             wire_block: bool = False, chaos_ge: bool = False,
             telemetry=None) -> "SimState":
        """``k`` is the topology's padded max degree; ``n_edges`` (pass
        ``net.n_edges``) selects the CSR-resident ``[E, W]`` first-arrival
        plane; ``val_delay`` > 0 adds the async-validation pipeline's
        stages (its presence in the state is the configuration); ``topo``
        (``TopoState.from_net(net)``) installs the mutable overlay;
        ``wire_block`` adds the per-message transmit block
        (``MsgTable.wire_block``, behind ``api.Network(max_message_size=)``);
        ``chaos_ge`` the Gilbert–Elliott link-fault chain (``ChaosState``),
        which a build whose ``ChaosConfig.needs_state`` requires;
        ``telemetry`` (a ``telemetry.TelemetryConfig``) the panel
        (``TelemetryState``) a recording step writes."""
        dev = resolve_device(device)
        return cls(
            tick=torch.zeros((), dtype=torch.int32, device=dev),
            key=prng.key(seed, device=dev),
            msgs=MsgTable.empty(msg_slots, dev, wire_block=wire_block),
            dlv=Delivery.empty(n_peers, msg_slots, k, dev, val_delay, n_edges=n_edges),
            events=zero_counters(dev),
            chaos=ChaosState.empty(n_peers, k, dev) if chaos_ge else None,
            telem=TelemetryState.empty(telemetry, dev) if telemetry is not None else None,
            topo=topo,
        )


def densify_edge_planes(net: Net, st):
    """A GossipSub state's CSR-resident flat planes -> their dense forms:
    ``fe_words``, ``served_lo``/``served_hi`` ``[E, W] -> [N, K, W]``,
    ``peerhave``/``iasked`` ``[E] -> [N, K]`` and the router's latency ring
    ``inflight`` ``[E, L, W] -> [N, K, L, W]``, absent slots zero. A dense
    state passes through unchanged. The ring has its own rank check: it
    exists on another branch of the build (``cfg.router``) than the served
    planes."""
    if st.served_lo.dim() == 2:
        dlv = st.core.dlv
        st = replace(st, core=replace(st.core, dlv=replace(
            dlv, fe_words=net.unpack_edges(dlv.fe_words))),
            served_lo=net.unpack_edges(st.served_lo),
            served_hi=net.unpack_edges(st.served_hi),
            peerhave=net.unpack_edges(st.peerhave),
            iasked=net.unpack_edges(st.iasked))
    if getattr(st, "inflight", None) is not None and st.inflight.dim() == 3:
        st = replace(st, inflight=net.unpack_edges(st.inflight))
    return st


def flatten_edge_planes(net: Net, st):
    """Dense per-edge planes -> the CSR-resident flat forms (the inverse of
    ``densify_edge_planes``, exact because a dense plane is zero on absent
    slots). A flat state passes through unchanged."""
    if st.served_lo.dim() == 3:
        dlv = st.core.dlv
        st = replace(st, core=replace(st.core, dlv=replace(
            dlv, fe_words=net.pack_edges(dlv.fe_words))),
            served_lo=net.pack_edges(st.served_lo),
            served_hi=net.pack_edges(st.served_hi),
            peerhave=net.pack_edges(st.peerhave),
            iasked=net.pack_edges(st.iasked))
    if getattr(st, "inflight", None) is not None and st.inflight.dim() == 4:
        st = replace(st, inflight=net.pack_edges(st.inflight))
    return st


def wrap_csr_resident(net: Net, fn):
    """Wrap a step for a CSR-resident state: densify the flat planes at
    entry, run the dense-written ``fn`` unchanged, re-pack at exit, so the
    state between steps holds only the present edges."""
    import functools

    @functools.wraps(fn)
    def wrapped(st, *args, **kwargs):
        return flatten_edge_planes(net, fn(densify_edge_planes(net, st), *args, **kwargs))

    return wrapped


def _scatter_drop(tbl: torch.Tensor, sidx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """tbl.at[sidx].set(vals, mode="drop") for sidx in [0, M]: index M is a
    spill slot that is cut away."""
    ext = torch.cat([tbl, tbl[:1]])
    ext = ext.index_put((sidx.long(),), vals.to(tbl.dtype))
    return ext[: tbl.shape[0]]


# publish verdict codes (validation.go ValidationAccept/Reject/Ignore), and
# the wire-block flag bit a max_message_size network ORs into an oversized
# publish's code (a table without the block plane decodes it away)
VERDICT_ACCEPT, VERDICT_REJECT, VERDICT_IGNORE = 0, 1, 2
VERDICT_WIRE_BLOCK = 4


def decode_verdicts(pub_valid: torch.Tensor):
    """(accept, ignored) bool planes of a publish-verdict array: bool (True
    accept, False reject) or integer ``VERDICT_*`` codes."""
    if pub_valid.dtype == torch.bool:
        return pub_valid, torch.zeros_like(pub_valid)
    base = pub_valid & ~VERDICT_WIRE_BLOCK
    return base == VERDICT_ACCEPT, base == VERDICT_IGNORE


def decode_wire_block(pub_valid: torch.Tensor) -> torch.Tensor:
    """Bool plane of the ``VERDICT_WIRE_BLOCK`` flag (False for bool
    verdicts)."""
    if pub_valid.dtype == torch.bool:
        return torch.zeros_like(pub_valid)
    return (pub_valid & VERDICT_WIRE_BLOCK) != 0


def wire_block_words(msgs: MsgTable) -> torch.Tensor | None:
    """[W] packed words of the table's blocked messages, None when the
    table carries no block plane."""
    return None if msgs.wire_block is None else bitset.pack(msgs.wire_block)


class PhasePubPlan:
    """A phase's ``[r, P]`` publish schedule allocated at once, at the phase
    head: every sub-round's slots, recycled-slot masks, origin publish
    words and message-table snapshots come from (cursor, schedule) alone,
    so they are a few wide ops instead of r ``allocate_publishes`` calls.

    * ``sidx``/``is_pub`` ``[r, P]``: the slot of each publish (M on an
      empty entry);
    * ``keep_w`` ``[r, W]`` and ``reused`` ``[r, M]``: recycled-slot masks;
    * ``pub_words`` ``[r, N, W]``: each origin's bit of its publishes;
    * ``msgs_at(i)``: the table ``allocate_publishes`` leaves after the
      publishes of sub-rounds < i (last write wins over the flattened
      schedule); ``msgs_at(r)`` is the phase's final table.

    ``apply_to_delivery`` is the delivery half of ``allocate_publishes``
    for one sub-round, fed by these masks."""

    def __init__(self, msgs: MsgTable, n_peers: int, tick0: torch.Tensor,
                 pub_origin: torch.Tensor, pub_topic: torch.Tensor,
                 pub_valid: torch.Tensor):
        r, p = pub_origin.shape
        m = msgs.capacity
        if m < p:
            raise ValueError(f"msg_slots {m} < publish width {p}")
        dev = pub_origin.device
        i32 = torch.int32
        w = bitset.n_words(m)
        self.m = m
        accept, ignored = decode_verdicts(pub_valid)
        rp = r * p
        flat_pub = (pub_origin >= 0).reshape(-1)
        self.is_pub = flat_pub.reshape(r, p)
        gpos = torch.cumsum(flat_pub.to(i32), 0, dtype=i32) - 1
        sidx_flat = torch.where(flat_pub, (msgs.cursor + gpos) % m, m)
        self.sidx = sidx_flat.reshape(r, p)
        counts = self.is_pub.sum(1, dtype=i32)
        self.cursor_at = msgs.cursor + torch.cat(
            [torch.zeros((1,), dtype=i32, device=dev),
             torch.cumsum(counts, 0, dtype=i32)])                       # [r+1]

        # last-write-wins snapshots over the flattened schedule
        eq = sidx_flat[:, None] == torch.arange(m, dtype=i32, device=dev)[None, :]
        jidx = torch.where(eq, torch.arange(rp, dtype=i32, device=dev)[:, None], -1)
        incl = torch.cummax(jidx.reshape(r, p, m).amax(1), dim=0).values
        self._lastw = torch.cat(
            [torch.full((1, m), -1, dtype=i32, device=dev), incl])      # [r+1, M]
        self.reused = eq.reshape(r, p, m).any(1)                        # [r, M]
        self.keep_w = ~bitset.pack(self.reused)                         # [r, W]

        flat_tick = tick0 + torch.arange(rp, dtype=i32, device=dev) // p
        self._topic = self._snap(msgs.topic, pub_topic.reshape(-1))
        self._origin = self._snap(msgs.origin, pub_origin.reshape(-1))
        self._birth = self._snap(msgs.birth, flat_tick)
        self._valid = self._snap(msgs.valid, accept.reshape(-1))
        self._ignored = self._snap(msgs.ignored, ignored.reshape(-1))
        self._wire_block = (
            self._snap(msgs.wire_block, decode_wire_block(pub_valid).reshape(-1))
            if msgs.wire_block is not None else None)
        self.valid_words = bitset.pack(self._valid)                     # [r+1, W]

        # the origins' publish bits, one scatter for the phase: a
        # sub-round's slots are distinct, so its bits are and add == or;
        # an empty entry lands on the spill row N, which is cut away
        row_flat = torch.where(flat_pub, pub_origin.reshape(-1), n_peers).long()
        i_flat = torch.arange(rp, device=dev) // p
        sidx64 = sidx_flat.long()
        words = torch.zeros((r, n_peers + 1, w), dtype=torch.int64, device=dev)
        words = words.index_put((i_flat, row_flat, (sidx64 // bitset.WORD).clamp(max=w - 1)),
                                torch.ones_like(sidx64) << (sidx64 % bitset.WORD),
                                accumulate=True)
        self.pub_words = bitset.to_word(words[:, :n_peers])             # [r, N, W]

    def _snap(self, tbl0: torch.Tensor, vals_flat: torch.Tensor) -> torch.Tensor:
        picked = vals_flat.to(tbl0.dtype)[self._lastw.clamp(min=0).long()]
        return torch.where(self._lastw >= 0, picked, tbl0[None, :])

    def msgs_at(self, i: int) -> MsgTable:
        """The message table as of sub-round ``i`` (after the publishes of
        sub-rounds < i)."""
        return MsgTable(topic=self._topic[i], origin=self._origin[i],
                        birth=self._birth[i], valid=self._valid[i],
                        ignored=self._ignored[i], cursor=self.cursor_at[i],
                        wire_block=(self._wire_block[i] if self._wire_block is not None
                                    else None))

    def apply_to_delivery(self, dlv: Delivery, i: int, tick_i) -> Delivery:
        """Sub-round ``i``'s recycled-slot clears and the origins'
        seen/forward/``first_round`` stamps (the plane form of
        ``allocate_publishes``' delivery half)."""
        keep = self.keep_w[i]
        pw = self.pub_words[i]
        pub_bits = bitset.unpack(pw, self.m)
        first_round = torch.where(
            pub_bits, tick_i, torch.where(self.reused[i][None, :], -1, dlv.first_round))
        fe_words, pending = bitset.masked_keep([dlv.fe_words, dlv.pending], keep)
        return Delivery(have=(dlv.have & keep) | pw, fwd=(dlv.fwd & keep) | pw,
                        first_round=first_round, fe_words=fe_words, pending=pending)


def allocate_publishes(msgs: MsgTable, dlv: Delivery, tick: torch.Tensor,
                       pub_origin: torch.Tensor, pub_topic: torch.Tensor,
                       pub_valid: torch.Tensor, scatter_form: bool = False,
                       stacked_clears: bool = True):
    """Intern this round's publishes (``pub_valid`` bool: accept or
    reject, or ``VERDICT_*`` codes) into table slots (rotating cursor),
    clearing recycled slots' bit columns everywhere (the pipeline's stages
    too), and mark each origin's own message seen and scheduled for
    forwarding.

    ``stacked_clears`` runs the four keep-clears (have, fwd, fe_words,
    pending) as one fold (``bitset.masked_keep``), False as one op a plane
    (the JAX package's per-plane A/B form); ``scatter_form`` does the
    recycled columns' ``first_round`` clear and the origins' stamps as one
    column scatter and the origins' words as a word scatter, instead of
    whole-plane selects (the JAX phase engine's choice at N >= 20,000).
    Every form gives the same bits.

    Returns (msgs, dlv, slots, is_pub, keep_words, pub_words)."""
    accept, ignored = decode_verdicts(pub_valid)
    m = msgs.capacity
    dev = dlv.have.device
    is_pub = pub_origin >= 0
    pos = torch.cumsum(is_pub.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = (msgs.cursor + pos) % m
    count = is_pub.sum(dtype=torch.int32)
    sidx = torch.where(is_pub, slots, m)

    n_peers = dlv.have.shape[0]
    reused = _scatter_drop(torch.zeros((m,), dtype=torch.bool, device=dev),
                           sidx, torch.ones_like(is_pub))
    keep = ~bitset.pack(reused)
    if stacked_clears:
        have_c, fwd_c, fe_c, pending_c = bitset.masked_keep(
            [dlv.have, dlv.fwd, dlv.fe_words, dlv.pending], keep)
    else:
        have_c, fwd_c, fe_c = dlv.have & keep, dlv.fwd & keep, dlv.fe_words & keep
        pending_c = dlv.pending & keep if dlv.pending is not None else None

    msgs = replace(
        msgs,
        topic=_scatter_drop(msgs.topic, sidx, pub_topic),
        origin=_scatter_drop(msgs.origin, sidx, pub_origin),
        birth=_scatter_drop(msgs.birth, sidx, tick.expand(pub_topic.shape)),
        valid=_scatter_drop(msgs.valid, sidx, accept),
        ignored=_scatter_drop(msgs.ignored, sidx, ignored),
        cursor=msgs.cursor + count,
        wire_block=(_scatter_drop(msgs.wire_block, sidx, decode_wire_block(pub_valid))
                    if msgs.wire_block is not None else None),
    )

    row = torch.where(is_pub, pub_origin, n_peers).long()
    if scatter_form:
        # column j of the update: -1 everywhere but the publishing origin's
        # row, which takes the tick (the clear-then-stamp pair in one
        # scatter; an empty entry lands on the spill column M)
        col_vals = torch.where(
            torch.arange(n_peers, device=dev)[:, None] == row[None, :], tick, -1)
        ext = torch.cat([dlv.first_round, dlv.first_round[:, :1]], dim=1)
        first_round = ext.index_copy(1, sidx.long(), col_vals.to(ext.dtype))[:, :m]
        w = bitset.n_words(m)
        sidx64 = sidx.long()
        # distinct slots make distinct bits, so the word add is an OR
        words = torch.zeros((n_peers + 1, w), dtype=torch.int64, device=dev)
        words = words.index_put((row, (sidx64 // bitset.WORD).clamp(max=w - 1)),
                                torch.ones_like(sidx64) << (sidx64 % bitset.WORD),
                                accumulate=True)
        pub_words = bitset.to_word(words[:n_peers])
    else:
        pub_bits = torch.zeros((n_peers + 1, m + 1), dtype=torch.bool, device=dev)
        pub_bits = pub_bits.index_put((row, sidx.long()), torch.ones_like(is_pub))
        pub_bits = pub_bits[:n_peers, :m]
        pub_words = bitset.pack(pub_bits)
        first_round = torch.where(pub_bits, tick,
                                  torch.where(reused[None, :], -1, dlv.first_round))
    dlv = Delivery(
        have=have_c | pub_words,
        fwd=fwd_c | pub_words,
        first_round=first_round,
        fe_words=fe_c,
        pending=pending_c,
    )
    return msgs, dlv, slots, is_pub, keep, pub_words


def hops(msgs: MsgTable, dlv: Delivery) -> torch.Tensor:
    """[N, M] int32 propagation hop count per (peer, msg): 0 at the origin,
    k for a peer first reached k rounds after the publish, -1 where never
    received. A message published at round r reaches its 1-hop neighbours
    in round r + 1."""
    h = dlv.first_round - msgs.birth[None, :]
    return torch.where((dlv.first_round >= 0) & (msgs.birth >= 0)[None, :], h, -1)
