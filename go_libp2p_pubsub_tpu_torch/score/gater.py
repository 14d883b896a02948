"""Peer gater — random-early-drop admission control (peer_gater.go).

When the validation pipeline is overloaded (throttled/validated ratio above
threshold, peer_gater.go:320-363), incoming *messages* from a peer are
accepted with probability (1 + deliver) / (1 + weighted total of its
delivery outcomes); control traffic still flows (AcceptControl).

Vector form: per-edge outcome counters [N,K] with per-source-IP sharing
(stats are aggregated over edges whose far end shares an ip-group —
peer_gater.go:133-137 keys stats by source IP) and a per-peer global
validate/throttle pair. One bernoulli draw per edge per round.

The float32 arithmetic keeps the JAX package's compiled order bit for bit
(``tests/test_torch_gater.py`` holds every function against the jitted
reference on random counters): the per-source share is XLA:CPU's batched
matrix-vector dot, whose sums ``share`` repeats; the weighted total is the
fused multiply-add chain XLA:CPU contracts it to; and every product,
quotient and sum a subnormal could come out of is flushed as XLA flushes
it (``ops/fnum.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import prng
from ..ops.fnum import flush_f32, flush_subnormals, fma_f32

#: the lanes of XLA:CPU's dot loop. A row of the contraction is summed in
#: 8-wide vector chunks, one after the other; the lanes are then added
#: pairwise — adjacent lanes for the output rows of whole 8-row tiles,
#: halves (lane i and i + 4, then i + 2, then 1) for the rows past the last
#: whole tile — and the columns past the last whole chunk, summed in a
#: scalar loop, are added to that
_DOT_LANES = 8


@dataclasses.dataclass
class GaterState:
    validate: torch.Tensor       # [N] f32 — messages entering validation
    throttle: torch.Tensor       # [N] f32 — throttle events
    last_throttle: torch.Tensor  # [N] i32 — tick of the last throttle
    deliver: torch.Tensor        # [N,K] f32 per-edge outcome counters
    duplicate: torch.Tensor
    ignore: torch.Tensor
    reject: torch.Tensor

    @classmethod
    def empty(cls, n: int, k: int, device) -> "GaterState":
        z = lambda: torch.zeros((n, k), dtype=torch.float32, device=device)
        return cls(
            validate=torch.zeros((n,), dtype=torch.float32, device=device),
            throttle=torch.zeros((n,), dtype=torch.float32, device=device),
            last_throttle=torch.full((n,), -(2**30), dtype=torch.int32,
                                     device=device),
            deliver=z(), duplicate=z(), ignore=z(), reject=z(),
        )


def source_share(net, static: bool = True):
    """The per-source share of the outcome counters (peer_gater.go:261-278:
    stats keyed by source IP) as a function ``share(x [N,K], live=None) ->
    [N,K]``: ``einsum("nkj,nj->nk", same, x)`` with ``same[n, k, j]`` =
    neighbours k and j share an ip-group, both edges live — ``nbr_ok``, or
    the round's ``live`` view ([N, K] bool inside ``nbr_ok``) where edge
    liveness moves. The groups are static, so the plane is built once, with
    the step; when no two present neighbours of any peer share a group
    (unique IPs, as in the bench) it is the identity on live edges and the
    share is ``x`` there, exactly (a sum of ``x`` and zeros) — a choice
    made once, on the host, at build. ``static=False`` (a net rebuilt every
    round, whose groups move with its edges) always takes the general
    form, with no host read."""
    groups = net.peer_gather(net.ip_group)
    same = ((groups[:, :, None] == groups[:, None, :])
            & net.nbr_ok[:, None, :] & net.nbr_ok[:, :, None])
    k = same.shape[-1]
    eye = torch.eye(k, dtype=torch.bool, device=same.device)
    ok = net.nbr_ok
    if static and bool(torch.equal(same, eye & net.nbr_ok[:, :, None])):
        return lambda x, live=None: torch.where(ok if live is None else live, x, 0.0)

    def shared(x, live=None):
        if live is None:
            return share(same, x)
        return share(same & live[:, None, :] & live[:, :, None], x)

    return shared


def share(same: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("nkj,nj->nk", same, x)`` summed in XLA:CPU's order (see
    ``_DOT_LANES``). The products are exact (``same`` is 0 or 1) and the
    counters non-negative and never subnormal, so no sum needs a flush."""
    k = x.shape[-1]
    prod = torch.where(same, x[:, None, :], 0.0)              # [N,K,J]
    main = k - k % _DOT_LANES
    out = None
    if main:
        acc = prod[..., :_DOT_LANES]
        for c in range(_DOT_LANES, main, _DOT_LANES):
            acc = acc + prod[..., c:c + _DOT_LANES]
        tiled = acc[:, :main]
        while tiled.shape[-1] > 1:                 # adjacent lanes
            tiled = tiled[..., 0::2] + tiled[..., 1::2]
        tail = acc[:, main:]
        while tail.shape[-1] > 1:                  # halves
            h = tail.shape[-1] // 2
            tail = tail[..., :h] + tail[..., h:]
        out = torch.cat([tiled, tail], dim=1)[..., 0]
    if main < k:
        rest = prod[..., main]
        for j in range(main + 1, k):
            rest = rest + prod[..., j]
        out = rest if out is None else out + rest
    return out


def gater_decay(gs: GaterState, params) -> GaterState:
    """Per-decay-interval counter decay (peer_gater.go:219-259)."""
    dtz = flush_f32(params.decay_to_zero)

    def dec(x, d):
        y = flush_subnormals(x * float(d))
        return torch.where(y < dtz, 0.0, y)

    return dataclasses.replace(
        gs,
        validate=dec(gs.validate, params.global_decay),
        throttle=dec(gs.throttle, params.global_decay),
        deliver=dec(gs.deliver, params.source_decay),
        duplicate=dec(gs.duplicate, params.source_decay),
        ignore=dec(gs.ignore, params.source_decay),
        reject=dec(gs.reject, params.source_decay),
    )


def gater_accept(gs: GaterState, share_fn, params, quiet_ticks: int, tick,
                 key: torch.Tensor, live=None) -> torch.Tensor:
    """[N,K] bool: True = AcceptAll, False = AcceptControl (drop messages)
    for this round (peer_gater.go:320-363). ``share_fn`` is the net's
    ``source_share``; ``live`` the round's live edges where they move."""
    # circuit breaker off: quiet period elapsed, no throttle pressure, or
    # ratio below threshold
    calm = (tick - gs.last_throttle) > quiet_ticks
    calm = calm | (gs.throttle == 0.0)
    ratio = flush_subnormals(gs.throttle / gs.validate.clamp(min=1e-9))
    calm = calm | ((gs.validate != 0.0) & (ratio < flush_f32(params.threshold)))

    deliver = share_fn(gs.deliver, live)
    total = deliver
    for w, x in ((params.duplicate_weight, gs.duplicate),
                 (params.ignore_weight, gs.ignore), (params.reject_weight, gs.reject)):
        total = flush_subnormals(fma_f32(share_fn(x, live), flush_f32(w), total))
    p = flush_subnormals((1.0 + deliver) / (1.0 + total))
    u = prng.uniform(key, p.shape)
    accept = (u < p) | (total == 0.0)
    return calm[:, None] | accept


def gater_on_round(gs: GaterState, n_validated, n_throttled, deliver_inc,
                   duplicate_inc, reject_inc, tick, ignore_inc=None) -> GaterState:
    """Fold a round's validation outcomes into the counters (the RawTracer
    hooks, peer_gater.go:365-443)."""
    return dataclasses.replace(
        gs,
        validate=gs.validate + n_validated.to(torch.float32),
        throttle=gs.throttle + n_throttled.to(torch.float32),
        last_throttle=torch.where(n_throttled > 0, tick, gs.last_throttle),
        deliver=gs.deliver + deliver_inc,
        duplicate=gs.duplicate + duplicate_inc,
        reject=gs.reject + reject_inc,
        ignore=gs.ignore if ignore_inc is None else gs.ignore + ignore_inc,
    )
