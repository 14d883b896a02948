"""Batched peer-score engine — the v1.1 security plane (score.go).

Every peer n scores each of its neighbor slots k; topic-local counters live
at [N, S, K]. The weighted P1..P7 sum (score.go:258-335), the decay pass
(refreshScores, score.go:497-558) and the delivery-attribution updates
(score.go:892-974) are elementwise passes. Each float expression keeps the
JAX package's operation order term by term, so the f32 planes agree bit for
bit (``p1`` divides by the quantum; it never multiplies by a reciprocal).
Where XLA:CPU's fused score loop contracts a product into its add, the port
rounds once too (``ops/fnum.fma_f32``), site by site as its vector loop
does (``compute_scores``), and the one-topic scalar loop's tail columns
too; the scalar rows around P5's banded gather are the residue ROADMAP §3
names.

Subnormals are flushed as the JAX package's platforms flush them
(``ops/fnum.py``): the parameters once, where they are built
(``TopicParamsArrays.build``, ``ScoreScalars.build``), and every product
and every sum of mixed signs as it is computed. Two kinds of result need
no flush and get none: a whole number over a whole quantum (``p1``), and
the sum of a flushed non-negative counter and a non-negative whole count
or another flushed non-negative term, which is zero, the counter itself,
or at least as large as a normal operand.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import PeerScoreParams, ticks_for
from ..ops import bitset
from ..ops.fnum import flush_f32, fma_f32
from ..ops.fnum import flush_subnormals as fl
from ..state import Net, replace


@dataclasses.dataclass(frozen=True)
class TopicParamsArrays:
    """Per-topic score params as dense [T] numpy arrays (row t zeroed when
    topic t is unscored, score.go:269-273, 881-884), float32 subnormals
    flushed to zeros of their sign."""

    scored: np.ndarray
    topic_weight: np.ndarray
    w1: np.ndarray
    quantum_ticks: np.ndarray
    cap1: np.ndarray
    w2: np.ndarray
    decay2: np.ndarray
    cap2: np.ndarray
    w3: np.ndarray
    decay3: np.ndarray
    cap3: np.ndarray
    thr3: np.ndarray
    window_rounds: np.ndarray     # [T] i32
    activation_ticks: np.ndarray  # [T] i32
    w3b: np.ndarray
    decay3b: np.ndarray
    w4: np.ndarray
    decay4: np.ndarray

    @classmethod
    def build(cls, params: PeerScoreParams, n_topics: int,
              heartbeat_interval: float = 1.0):
        def arr(fn, dtype=np.float32):
            out = np.zeros((n_topics,), dtype)
            for t, tp in params.topics.items():
                if 0 <= t < n_topics:
                    out[t] = fn(tp)
            return flush_f32(out) if dtype == np.float32 else out

        scored = np.zeros((n_topics,), bool)
        for t in params.topics:
            if 0 <= t < n_topics:
                scored[t] = True
        hb = heartbeat_interval
        return cls(
            scored=scored,
            topic_weight=arr(lambda p: p.topic_weight),
            w1=arr(lambda p: p.time_in_mesh_weight),
            quantum_ticks=arr(lambda p: max(1, ticks_for(p.time_in_mesh_quantum, hb))),
            cap1=arr(lambda p: p.time_in_mesh_cap),
            w2=arr(lambda p: p.first_message_deliveries_weight),
            decay2=arr(lambda p: p.first_message_deliveries_decay),
            cap2=arr(lambda p: p.first_message_deliveries_cap),
            w3=arr(lambda p: p.mesh_message_deliveries_weight),
            decay3=arr(lambda p: p.mesh_message_deliveries_decay),
            cap3=arr(lambda p: p.mesh_message_deliveries_cap),
            thr3=arr(lambda p: p.mesh_message_deliveries_threshold),
            window_rounds=arr(
                lambda p: ticks_for(p.mesh_message_deliveries_window, hb) - 1
                if p.mesh_message_deliveries_window >= hb else 0,
                np.int32,
            ),
            activation_ticks=arr(
                lambda p: ticks_for(p.mesh_message_deliveries_activation, hb),
                np.int32),
            w3b=arr(lambda p: p.mesh_failure_penalty_weight),
            decay3b=arr(lambda p: p.mesh_failure_penalty_decay),
            w4=arr(lambda p: p.invalid_message_deliveries_weight),
            decay4=arr(lambda p: p.invalid_message_deliveries_decay),
        )

    def gather(self, my_topics: torch.Tensor) -> dict:
        """Per-(peer, slot) [N, S] views; slots with no topic come out
        zeroed/unscored. ``out["uniform"]`` maps each float field to its one
        value when every (peer, slot) view holds the same value (the JAX
        package's step embeds these views as constants, and XLA folds a
        constant whose elements are all equal), else None."""
        t = my_topics.clamp(min=0).long()
        live = my_topics >= 0
        used = np.unique(my_topics.cpu().numpy())
        out, uniform = {}, {}
        for f in dataclasses.fields(self):
            a = getattr(self, f.name)
            v = torch.as_tensor(a, device=my_topics.device)[t]
            out[f.name] = torch.where(live, v, torch.zeros((), dtype=v.dtype,
                                                            device=v.device))
            if a.dtype == np.float32:
                vals = {float(a[u]) if u >= 0 else 0.0 for u in used.tolist()}
                uniform[f.name] = vals.pop() if len(vals) == 1 else None
        out["uniform"] = uniform
        return out


@dataclasses.dataclass(frozen=True)
class ScoreScalars:
    """The PeerScoreParams scalars the step reads, as the float32 constants
    the JAX package computes with: subnormals flushed once, here.
    ``cap_on`` and ``app_on`` are the JAX package's static branches, taken
    on the unflushed values as it takes them (a subnormal cap still clamps,
    at zero, as XLA's minimum reads it as +0.0)."""

    decay_to_zero: float
    behaviour_penalty_decay: float
    behaviour_penalty_threshold: float
    behaviour_penalty_weight: float
    ip_colocation_factor_weight: float
    app_specific_weight: float
    topic_score_cap: float
    cap_on: bool
    app_on: bool

    @classmethod
    def build(cls, params: PeerScoreParams) -> "ScoreScalars":
        p = params
        return cls(
            decay_to_zero=flush_f32(p.decay_to_zero),
            behaviour_penalty_decay=flush_f32(p.behaviour_penalty_decay),
            behaviour_penalty_threshold=flush_f32(p.behaviour_penalty_threshold),
            behaviour_penalty_weight=flush_f32(p.behaviour_penalty_weight),
            ip_colocation_factor_weight=flush_f32(p.ip_colocation_factor_weight),
            app_specific_weight=flush_f32(p.app_specific_weight),
            topic_score_cap=flush_f32(p.topic_score_cap),
            cap_on=p.topic_score_cap > 0,
            app_on=p.app_specific_weight != 0.0,
        )


@dataclasses.dataclass
class ScoreState:
    """Counters the score is computed from, per (peer, topic-slot,
    neighbor-slot) (peerStats/topicStats, score.go:17-62)."""

    fmd: torch.Tensor          # [N,S,K] f32 firstMessageDeliveries
    mmd: torch.Tensor          # [N,S,K] f32 meshMessageDeliveries
    mfp: torch.Tensor          # [N,S,K] f32 meshFailurePenalty (P3b)
    imd: torch.Tensor          # [N,S,K] f32 invalidMessageDeliveries
    graft_tick: torch.Tensor   # [N,S,K] i32 (-1 never)
    mesh_time: torch.Tensor    # [N,S,K] i32
    mmd_active: torch.Tensor   # [N,S,K] bool P3 activation latch
    bp: torch.Tensor           # [N,K] f32 behaviourPenalty (P7)

    @classmethod
    def empty(cls, n: int, s: int, k: int, device) -> "ScoreState":
        f = lambda: torch.zeros((n, s, k), dtype=torch.float32, device=device)
        return cls(
            fmd=f(), mmd=f(), mfp=f(), imd=f(),
            graft_tick=torch.full((n, s, k), -1, dtype=torch.int32, device=device),
            mesh_time=torch.zeros((n, s, k), dtype=torch.int32, device=device),
            mmd_active=torch.zeros((n, s, k), dtype=torch.bool, device=device),
            bp=torch.zeros((n, k), dtype=torch.float32, device=device),
        )


def ip_colocation_surplus_sq(net: Net, threshold: int, whitelist=()) -> torch.Tensor:
    """[N, K] f32: (peersInIP - threshold)^2 where the count of my connected
    neighbors sharing neighbor k's ip-group exceeds the threshold
    (score.go:337-381)."""
    groups = net.peer_gather(net.ip_group)
    same = (groups[:, :, None] == groups[:, None, :]) & net.nbr_ok[:, None, :]
    count = same.sum(-1, dtype=torch.int32)
    surplus = (count - threshold).to(torch.float32)
    p6 = torch.where(count > threshold, surplus * surplus, 0.0)
    if len(whitelist):
        wl = torch.isin(groups, torch.as_tensor(list(whitelist), dtype=groups.dtype,
                                                device=groups.device))
        p6 = torch.where(wl, 0.0, p6)
    return torch.where(net.nbr_ok, p6, 0.0)


def _mul_add(a: torch.Tensor, w: torch.Tensor, w_uniform, c: torch.Tensor) -> torch.Tensor:
    """``c + a * w`` as XLA:CPU's fused score loop computes it: one rounding
    (a fused multiply-add, the weight a host float when it is uniform).
    Under a uniform weight of 0 or 1 the rounded product is exact, so the
    two-rounding form gives the same bits in fewer launches."""
    if w_uniform in (0.0, 1.0):
        return fl(c + fl(a * w))
    return fl(fma_f32(a, w if w_uniform is None else w_uniform, c))


def scalar_tail_start(k_dim: int, n_slots: int) -> int:
    """The first neighbour column XLA:CPU's fused score loop leaves to its
    scalar loop (``k_dim`` when none): the columns past the last whole
    8-column chunk of a row of K >= 9 columns, except that rows of 20 to 23
    columns take columns 16-19 in a 4-wide vector chunk; with several
    topic slots only rows of K > 16 have such columns. Mapped on random
    counters for every K from 9 to 41 at N = 64, 96 and 256 with one topic
    slot, and at N = 64 with two and three: the form depends on K, the
    column and whether there are several slots alone (ROADMAP §3)."""
    if k_dim < 9 or k_dim % 8 == 0 or (n_slots != 1 and k_dim < 16):
        return k_dim
    return 20 if 20 <= k_dim <= 23 else k_dim // 8 * 8


def _fuse_square(acc: torch.Tensor, x: torch.Tensor, tail: int) -> torch.Tensor:
    """``acc - x * x`` as XLA:CPU's fused score loop computes a
    select-guarded square at a weight of -1: one rounding in its vector
    chunks, the square rounded apart in the scalar loop's columns from
    ``tail`` on (``scalar_tail_start``)."""
    fused = fl(fma_f32(x, -x, acc))
    if tail >= x.shape[-1]:
        return fused
    sl = (..., slice(tail, None))
    return torch.cat([fused[..., :tail], fl(acc[sl] - fl(x[sl] * x[sl]))], dim=-1)


def _guarded_mul_add(x: torch.Tensor, w, w_uniform, acc: torch.Tensor,
                     tail: int) -> torch.Tensor:
    """``acc + x * w`` for a select-guarded product ``x`` (zero where its
    guard is off) at a weight other than -1: fused in XLA:CPU's vector
    chunks, the product rounded apart in the scalar loop's columns from
    ``tail`` on."""
    fused = _mul_add(x, w, w_uniform, acc)
    if tail >= x.shape[-1]:
        return fused
    sl = (..., slice(tail, None))
    w_t = w if w_uniform is None else w_uniform
    return torch.cat([fused[..., :tail], fl(acc[sl] + fl(x[sl] * w_t))], dim=-1)


def compute_scores(st: ScoreState, in_mesh: torch.Tensor, tp: dict,
                   sc: ScoreScalars, p6: torch.Tensor,
                   app_score: torch.Tensor, net: Net) -> torch.Tensor:
    """[N, K] f32 — peer n's score of neighbor slot k (score.go:258-335).

    Every product that XLA:CPU's vector loop contracts into the add that
    consumes it is one fused multiply-add here: P2, P3 (its rounded square
    times the weight; at a uniform weight of -1 the square itself), P3b,
    P4 (likewise, but with one topic slot its square is rounded apart at -1
    in rows of 5 to 8 neighbour slots),
    each topic slot's weighted term into the slot sum, P5, P6 and P7. Where
    both operands of an add are products (one topic slot, no cap, P5 off:
    the slot's weighted term meets P6's product) the compiler fuses the
    first, the slot's term, and rounds the other (in a row of 9 neighbour
    slots its one scalar column fuses P6's product instead). The columns
    its scalar loop takes (``scalar_tail_start``) round the select-guarded
    products of P3 and P7 apart: the square at a weight of -1, the
    weighted square at any other."""
    e = lambda a: a[..., None]
    u = tp["uniform"]
    tail = scalar_tail_start(in_mesh.shape[-1], in_mesh.shape[1])
    p1 = torch.minimum(st.mesh_time.to(torch.float32) / e(tp["quantum_ticks"]),
                       e(tp["cap1"]))
    topic = torch.where(in_mesh, fl(p1 * e(tp["w1"])), 0.0)
    topic = _mul_add(st.fmd, e(tp["w2"]), u["w2"], topic)
    deficit = fl(e(tp["thr3"]) - st.mmd)
    p3_on = st.mmd_active & (deficit > 0)
    if u["w3"] == -1.0:
        topic = torch.where(p3_on, _fuse_square(topic, deficit, tail), topic)
    else:
        p3 = torch.where(p3_on, fl(deficit * deficit), 0.0)
        topic = _guarded_mul_add(p3, e(tp["w3"]), u["w3"], topic, tail)
    topic = _mul_add(st.mfp, e(tp["w3b"]), u["w3b"], topic)
    # at -1 XLA:CPU fuses P4's square past one topic slot; with one slot it
    # rounds the square apart in rows of 5 to 8 neighbour slots and fuses
    # it in narrower and wider rows, the scalar loop's columns too
    k_dim = topic.shape[-1]
    if u["w4"] == -1.0 and (topic.shape[1] > 1 or not 5 <= k_dim <= 8):
        topic = fl(fma_f32(st.imd, -st.imd, topic))
    else:
        topic = _mul_add(fl(st.imd * st.imd), e(tp["w4"]), u["w4"], topic)
    tw, tw_u = e(tp["topic_weight"]), u["topic_weight"]
    # the sum over topic slots as XLA reduces: in slot order from 0.0, each
    # partial sum flushed; one slot is the slot's weighted term itself, a
    # bare product unless the weight is a uniform 1 (folded away)
    bare = topic.shape[1] == 1 and not sc.cap_on and tw_u != 1.0
    score = fl(topic[:, 0] * tw[:, 0])
    if topic.shape[1] > 1:
        score = score + 0.0
        for s in range(1, topic.shape[1]):
            score = _mul_add(topic[:, s], tw[:, s], tw_u, score)
    if sc.cap_on:
        score = torch.clamp(score, max=sc.topic_score_cap)

    def add_term(score, x, w):
        """score + x * w for P5 and P6: the product fused, unless the score
        is still the bare slot term, which is fused in its stead (but in
        the scalar column of a row of 9)."""
        if not bare:
            return _mul_add(x, w, w, score)
        if w == 0.0:
            return fl(score + fl(x * w))
        w_t = tw[:, 0] if tw_u is None else tw_u
        out = fl(fma_f32(topic[:, 0], w_t, fl(x * w)))
        if k_dim == 9:
            # a row of 9: its one scalar column fuses the product into
            # the rounded slot term instead
            out = torch.cat([out[:, :8], fl(fma_f32(x[:, 8:], w, score[:, 8:]))], dim=-1)
        return out

    if sc.app_on:
        app_w = sc.app_specific_weight
        score = _mul_add(fl(net.peer_gather(app_score)), app_w, app_w, score)
        bare = False
    score = add_term(score, p6, sc.ip_colocation_factor_weight)
    excess = fl(st.bp - sc.behaviour_penalty_threshold)
    # at a weight of -1 the compiler first folds the weight into the
    # square, so the square itself is fused: score - excess * excess
    # (rounded apart in the scalar loop's columns)
    if sc.behaviour_penalty_weight == -1.0:
        score = torch.where(excess > 0, _fuse_square(score, excess, tail), score)
    else:
        p7 = torch.where(excess > 0, fl(excess * excess), 0.0)
        w7 = sc.behaviour_penalty_weight
        score = _guarded_mul_add(p7, w7, w7, score, tail)
    return torch.where(net.nbr_ok, score, 0.0)


def lifted_scalar_columns(k_dim: int, n_slots: int,
                          app_on: bool = False) -> tuple[list, bool]:
    """(columns, narrow): the neighbour columns XLA:CPU's lifted score loop
    leaves to its scalar form, and whether P2 and P3b round apart there.
    Only one topic slot has them: columns 0-1 of a row of 3 and every
    column of a row of 4 (narrow), and column 8 of a row of 9. With P5
    live (``app_on``) only the row of 3 keeps its columns 0-1, not
    narrow. Mapped on random counters for every K from 1 to 41 with one
    to three slots at N = 64, 96 and 256, with P5 off and on (ROADMAP
    §3)."""
    if n_slots != 1:
        return [], False
    if k_dim == 3:
        return [0, 1], not app_on
    if app_on:
        return [], False
    if k_dim == 4:
        return [0, 1, 2, 3], True
    if k_dim == 9:
        return [8], False
    return [], False


def compute_scores_lifted(st: ScoreState, in_mesh: torch.Tensor, tp: dict, sc,
                          p6: torch.Tensor, app_score: torch.Tensor,
                          net: Net) -> torch.Tensor:
    """``compute_scores`` under a lifted plane (``score/params.py``): ``tp``
    the plane's gathered rows and ``sc`` the plane, flushed. The weights
    are runtime operands, so nothing folds and XLA:CPU's score loop fuses
    every weighted product into the add that consumes it, the
    select-guarded squares of P3 and P7 too; the topic-score cap is a
    select on its value and P5's weight stays a host float. The scalar
    columns of a one-slot row (``lifted_scalar_columns``) take the slot's
    weighted term fused into P6's rounded product where the cap is off,
    and in the narrow rows P2's and P3b's products rounded apart; with P5
    live they take P5's product fused after the cap's select and P6's
    rounded apart, whatever the cap."""
    e = lambda a: a[..., None]
    k_dim = in_mesh.shape[-1]
    app_on = sc.app_specific_weight != 0.0
    cols, narrow = lifted_scalar_columns(k_dim, in_mesh.shape[1], app_on)

    def mul_add(x, w, acc):
        return fl(fma_f32(x, w, acc))

    def apart(x, w, acc):
        return fl(acc + fl(x * w))

    def at_cols(vec, sca):
        if not cols:
            return vec
        m = torch.zeros(k_dim, dtype=torch.bool, device=vec.device)
        m[cols] = True
        return torch.where(m, sca, vec)

    p1 = torch.minimum(st.mesh_time.to(torch.float32) / e(tp["quantum_ticks"]),
                       e(tp["cap1"]))
    topic = torch.where(in_mesh, fl(p1 * e(tp["w1"])), 0.0)
    if narrow:
        topic = at_cols(mul_add(st.fmd, e(tp["w2"]), topic), apart(st.fmd, e(tp["w2"]), topic))
    else:
        topic = mul_add(st.fmd, e(tp["w2"]), topic)
    deficit = fl(e(tp["thr3"]) - st.mmd)
    p3 = torch.where(st.mmd_active & (deficit > 0), fl(deficit * deficit), 0.0)
    topic = mul_add(p3, e(tp["w3"]), topic)
    if narrow:
        topic = at_cols(mul_add(st.mfp, e(tp["w3b"]), topic), apart(st.mfp, e(tp["w3b"]), topic))
    else:
        topic = mul_add(st.mfp, e(tp["w3b"]), topic)
    topic = mul_add(fl(st.imd * st.imd), e(tp["w4"]), topic)
    tw = e(tp["topic_weight"])
    prod = fl(topic[:, 0] * tw[:, 0])
    score = prod
    if topic.shape[1] > 1:
        score = score + 0.0
        for s in range(1, topic.shape[1]):
            score = mul_add(topic[:, s], tw[:, s], score)
    cap = sc.topic_score_cap
    capped = torch.where(cap > 0, torch.minimum(score, cap), score)
    w6 = sc.ip_colocation_factor_weight
    if app_on:
        app_w = flush_f32(sc.app_specific_weight)
        capped = mul_add(fl(net.peer_gather(app_score)), app_w, capped)
    score = mul_add(p6, w6, capped)
    if cols and app_on:
        score = at_cols(score, apart(p6, w6, capped))
    elif cols:
        # the cap's select sinks past the add: where the cap is off the
        # slot's term fuses into P6's rounded product
        score = at_cols(score, torch.where(cap > 0, score,
                                           fl(fma_f32(topic[:, 0], tw[:, 0], fl(p6 * w6)))))
    excess = fl(st.bp - sc.behaviour_penalty_threshold)
    p7 = torch.where(excess > 0, fl(excess * excess), 0.0)
    score = mul_add(p7, sc.behaviour_penalty_weight, score)
    return torch.where(net.nbr_ok, score, 0.0)


def refresh_scores(st: ScoreState, in_mesh: torch.Tensor, tick, tp: dict,
                   sc: ScoreScalars) -> ScoreState:
    """The decay pass (refreshScores, score.go:497-558)."""
    dtz = sc.decay_to_zero
    e = lambda a: a[..., None]

    def dec(x, d):
        y = fl(x * d)
        return torch.where(y < dtz, 0.0, y)

    mesh_time = torch.where(in_mesh, tick - st.graft_tick, st.mesh_time)
    active = st.mmd_active | (in_mesh & (mesh_time > e(tp["activation_ticks"])))
    return replace(
        st,
        fmd=dec(st.fmd, e(tp["decay2"])),
        mmd=dec(st.mmd, e(tp["decay3"])),
        mfp=dec(st.mfp, e(tp["decay3b"])),
        imd=dec(st.imd, e(tp["decay4"])),
        mesh_time=mesh_time, mmd_active=active,
        bp=dec(st.bp, sc.behaviour_penalty_decay),
    )


def on_graft(st: ScoreState, graft_mask: torch.Tensor, tick) -> ScoreState:
    """Newly grafted edges: reset mesh time and the P3 latch
    (score.go:642-660)."""
    return replace(
        st,
        graft_tick=torch.where(graft_mask, tick, st.graft_tick),
        mesh_time=torch.where(graft_mask, 0, st.mesh_time),
        mmd_active=st.mmd_active & ~graft_mask,
    )


def clear_edges(st: ScoreState, mask: torch.Tensor) -> ScoreState:
    """Reset every per-edge stat where ``mask`` [N,K]: removePeer's delete
    (score.go:604-637). The caller leaves negative-score edges out of the
    mask (retention: their stats keep decaying, so a disconnect cannot wash
    a bad score)."""
    m3 = mask[:, None, :]
    z = lambda a: torch.where(m3, 0.0, a)
    return replace(
        st, fmd=z(st.fmd), mmd=z(st.mmd), mfp=z(st.mfp), imd=z(st.imd),
        graft_tick=torch.where(m3, -1, st.graft_tick),
        mesh_time=torch.where(m3, 0, st.mesh_time),
        mmd_active=st.mmd_active & ~m3,
        bp=torch.where(mask, 0.0, st.bp),
    )


def clear_mesh_status(st: ScoreState, mask: torch.Tensor) -> ScoreState:
    """Clear the in-mesh bookkeeping (graft tick, mesh time, P3 latch) on
    every edge in ``mask`` [N,K]: removePeer's "no longer in any mesh" step
    (score.go:614-625), for retained and deleted stats alike, so a retained
    peer's P3 deficit converts once (``on_prune``) instead of staying
    latched."""
    m3 = mask[:, None, :]
    return replace(
        st, graft_tick=torch.where(m3, -1, st.graft_tick),
        mesh_time=torch.where(m3, 0, st.mesh_time),
        mmd_active=st.mmd_active & ~m3,
    )


def on_prune(st: ScoreState, prune_mask: torch.Tensor, tp: dict) -> ScoreState:
    """Edges leaving the mesh: the sticky mesh failure penalty when pruned
    while active and below threshold (score.go:662-684)."""
    deficit = fl(tp["thr3"][..., None] - st.mmd)
    add = torch.where(prune_mask & st.mmd_active & (deficit > 0),
                      fl(deficit * deficit), 0.0)
    return replace(st, mfp=st.mfp + add)   # two flushed non-negatives


def per_slot_counts(words: torch.Tensor, slotw: torch.Tensor) -> torch.Tensor:
    """[N,K,W] packed words -> [N,S,K] f32 popcounts per topic slot."""
    return torch.stack(
        [bitset.popcount(words & slotw[:, s: s + 1, :], axis=-1)
         for s in range(slotw.shape[1])], dim=1
    ).to(torch.float32)


def slot_topic_words(net: Net, msg_topic: torch.Tensor) -> torch.Tensor:
    """[N, S, W] packed: messages belonging to the topic of my slot s."""
    n_topics = net.subscribed.shape[1]
    topics = torch.arange(n_topics, dtype=torch.int32, device=msg_topic.device)
    tw = bitset.pack(msg_topic[None, :] == topics[:, None])      # [T, W]
    stw = tw[net.my_topics.clamp(min=0).long()]                    # [N, S, W]
    return torch.where((net.my_topics >= 0)[:, :, None], stw, 0)


def on_deliveries(st: ScoreState, net: Net, in_mesh: torch.Tensor, tp: dict,
                  trans_words: torch.Tensor, new_words: torch.Tensor,
                  fe_words: torch.Tensor, first_round: torch.Tensor,
                  msg_topic: torch.Tensor, msg_valid: torch.Tensor, tick,
                  window_rounds_t: torch.Tensor,
                  msg_ignored: torch.Tensor | None = None,
                  slotw: torch.Tensor | None = None,
                  mesh_credit_words: torch.Tensor | None = None,
                  pending_words: torch.Tensor | None = None,
                  recv_new_words: torch.Tensor | None = None) -> ScoreState:
    """Fold one delivery round into the counters (score.go:892-974):
    first receipts credit P2 (and P3 on mesh edges), in-window duplicates
    credit P3, arrivals of rejected messages charge P4; ignored messages
    move nothing. Each counter is flushed, non-negative and gains a whole
    count, so no sum here needs a flush.

    Phase mode (``models/gossipsub_phase.py``): ``mesh_credit_words``
    [N,K,W] is the in-window mesh credit the caller gated at each
    arrival's own tick and OR-folded over the phase's sub-rounds (exact:
    an (edge, msg) pair transmits at most once a phase); the credit is
    then that plane on valid messages plus the first arrivals, and no
    window is recomputed here.

    With the async-validation pipeline (the per-round step: ``new_words``
    the verdict cohort, ``pending_words`` [N,W] what sits in the stages,
    ``recv_new_words`` this round's fresh receipts) the first-arrival edge
    earns its mesh credit at the verdict, and duplicates arriving while a
    message is pending are credited unconditionally (DeliverMessage's
    drec.peers loop, score.go:712-718), the fresh first arrival itself
    excluded."""
    t = msg_topic.clamp(min=0).long()
    if slotw is None:
        slotw = slot_topic_words(net, msg_topic)
    valid_w = bitset.pack(msg_valid)
    first_arrival = fe_words & new_words[:, None, :] & valid_w[None, None, :]
    e = lambda a: a[..., None]
    fmd = torch.minimum(st.fmd + per_slot_counts(first_arrival, slotw), e(tp["cap2"]))

    if mesh_credit_words is not None:
        mesh_credit = (mesh_credit_words & valid_w[None, None, :]) | first_arrival
    else:
        msg_window = window_rounds_t[t]
        within_w = bitset.pack(
            (first_round >= 0) & ((tick - first_round) <= msg_window[None, :]))
        mesh_credit = trans_words & valid_w[None, None, :] & within_w[:, None, :]
        if pending_words is not None:
            first_fresh = (fe_words & recv_new_words[:, None, :]
                           if recv_new_words is not None else 0)
            pend_dup = (trans_words & pending_words[:, None, :] & valid_w[None, None, :]
                        & ~first_fresh)
            mesh_credit = mesh_credit | pend_dup | first_arrival
    mmd_inc = per_slot_counts(mesh_credit, slotw) * in_mesh.to(torch.float32)
    mmd = torch.minimum(st.mmd + mmd_inc, e(tp["cap3"]))

    penalize_w = ~valid_w
    if msg_ignored is not None:
        penalize_w = penalize_w & ~bitset.pack(msg_ignored)
    imd = st.imd + per_slot_counts(trans_words & penalize_w[None, None, :], slotw)

    scored = e(tp["scored"])
    return replace(
        st,
        fmd=torch.where(scored, fmd, st.fmd),
        mmd=torch.where(scored, mmd, st.mmd),
        imd=torch.where(scored, imd, st.imd),
    )


def apply_delivery_counts(st: ScoreState, tp: dict, fmd_counts: torch.Tensor,
                          mmd_counts: torch.Tensor, imd_counts: torch.Tensor,
                          in_mesh: torch.Tensor) -> ScoreState:
    """Fold a phase's pre-reduced delivery counts ([N,S,K] f32: first
    deliveries, in-window mesh deliveries, invalid arrivals) into the
    counters: the phase engine's count path, which reduces each sub-round
    at arrival time. The caps apply once a fold, as ``on_deliveries``
    applies them once a round, so a cap can bind up to r - 1 rounds late,
    as in the JAX package. Whole counts on flushed non-negative counters
    need no flush."""
    e = lambda a: a[..., None]
    fmd = torch.minimum(st.fmd + fmd_counts, e(tp["cap2"]))
    mmd = torch.minimum(st.mmd + mmd_counts * in_mesh.to(torch.float32), e(tp["cap3"]))
    imd = st.imd + imd_counts
    scored = e(tp["scored"])
    return replace(
        st,
        fmd=torch.where(scored, fmd, st.fmd),
        mmd=torch.where(scored, mmd, st.mmd),
        imd=torch.where(scored, imd, st.imd),
    )


def add_penalties(st: ScoreState, counts: torch.Tensor) -> ScoreState:
    """behaviourPenalty += counts [N,K] (AddPenalty, score.go:384-398): a
    flushed non-negative counter plus whole counts needs no flush."""
    return replace(st, bp=st.bp + counts.to(torch.float32))
