"""The per-round telemetry panel and the sampled flight recorder (the port's
copy of the JAX package's ``telemetry/panel.py``).

A state built with a :class:`TelemetryConfig` carries a ``[rows,
N_METRICS]`` float32 panel (``SimState.telem``); every engine step's last
operation writes one row — the event-counter deltas, the delivery ratio,
the mesh degree's min, mean and max, score quantiles and the link-down
occupancy — as device ops, so a window captures a recording step with no
host read. The phase engine writes one row a phase (``rounds_per_row =
r``). Rows past the panel's capacity drop: the row index is a device
scalar, so the write goes into a panel one row longer whose last row takes
every dropped write and is cut away (the port's pad-and-cut idiom, as
``state._scatter_drop``).

Exactness: the event columns are deltas of the int32 counters cast to
float32, exact while one observation's delta stays below 2**24, so
:func:`reconcile` demands summed deltas == drained counters bit for bit.
The float columns take the JAX package's float forms on XLA:CPU, measured
against its compiled recorder: a row sum over the neighbour axis adds left
to right from 0.0 up to 32 wide and as XLA's tree-reduction windows of
32 above (``_row_sum``, every width mapped); a row min ranks -0.0 below
+0.0 (``_row_min``); a division by a value the
JAX program holds as a build constant (the slot count, the live-edge
counts, the link total of a static net) is a multiplication by the
divisor's reciprocal, any other a true division (``_div``); the quantile
interpolation ``vlo * (1 - frac) + vhi * frac`` contracts into one fused
multiply-add, around ``vhi * frac`` where the interpolation position is a
build constant (a static net's live-peer count) and around ``vlo * (1 -
frac)`` where it is not; the sort orders -0.0 and +0.0 as equal
and keeps ties in place (``_sort_as_reference``); and every float result
is flushed as XLA flushes subnormals (``ops/fnum.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import bitset
from ..ops.fnum import flush_subnormals, fma_f32
from ..trace.events import EV, N_EVENTS

#: per-event delta columns: one per ``trace/events.py`` EV member, in enum
#: order (literal, as in the JAX package, whose lint pins it to the enum)
EV_METRICS = (
    "ev_publish_message",
    "ev_reject_message",
    "ev_duplicate_message",
    "ev_deliver_message",
    "ev_add_peer",
    "ev_remove_peer",
    "ev_recv_rpc",
    "ev_send_rpc",
    "ev_drop_rpc",
    "ev_join",
    "ev_leave",
    "ev_graft",
    "ev_prune",
    "ev_link_down",
    "ev_iwant_recover",
    "ev_adv_drop",
    "ev_adv_ihave_lie",
    "ev_adv_graft_spam",
    "ev_idontwant_sent",
    "ev_dup_suppressed",
    "ev_choke",
    "ev_unchoke",
)

#: EV columns whose summed deltas must equal the drained counters bit for
#: bit (``reconcile``): every recorded one
RECONCILED = EV_METRICS

#: state readings at the end of each observation. Engines without a mesh or
#: score plane (FloodSub, RandomSub) record zeros there, so panels of every
#: engine stack into one [S, T, M] band. The score_p* columns are quantiles
#: across peers of each peer's mean held neighbour score.
STATE_METRICS = (
    "mesh_deg_min",
    "mesh_deg_mean",
    "mesh_deg_max",
    "score_p5",
    "score_p50",
    "score_p95",
    "links_down_frac",
)

METRICS = ("delivery_ratio",) + EV_METRICS + STATE_METRICS
N_METRICS = len(METRICS)
_EV_COL0 = METRICS.index(EV_METRICS[0])

#: flight-recorder columns (the tracked peers, every observation)
FLIGHT_METRICS = (
    "mesh_degree",      # directed mesh edges this peer holds (all slots)
    "score_mean",       # mean score it holds of its live neighbours
    "score_min",        # worst neighbour score
    "backoff_active",   # neighbour/slot pairs under active prune backoff
    "msgs_held",        # seen-cache population (popcount of have)
)
N_FLIGHT = len(FLIGHT_METRICS)

#: the float32 stand-in for "no value" in the masked min/max (jnp.float32(3.4e38))
_BIG = float(np.float32(3.4e38))


def metric_index(name: str) -> int:
    """Column index of a panel metric by catalog name."""
    return METRICS.index(name)


class TelemetryConfigError(ValueError):
    """Raised by TelemetryConfig.validate() on invalid parameters."""


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Build-time telemetry configuration; None leaves an engine on its code
    without the plane (no leaf, no op).

    ``rows`` is the panel's capacity in observations (one a round in the
    per-round engines, one a phase in the phase engine); observations past
    it drop (no wrap: a wrapped panel would break the reconciliation sums),
    so size it to the run. ``tracked`` is the flight recorder's tuple of
    peer indices (empty: no flight plane, no extra leaf)."""

    rows: int
    tracked: tuple = ()

    def validate(self) -> None:
        if self.rows < 1:
            raise TelemetryConfigError(f"rows must be >= 1, got {self.rows}")
        if not isinstance(self.tracked, tuple):
            raise TelemetryConfigError(
                "tracked must be a (hashable) tuple of peer indices, got "
                f"{type(self.tracked).__name__}")
        if any(int(t) < 0 for t in self.tracked):
            raise TelemetryConfigError(
                f"tracked peer indices must be >= 0, got {self.tracked}")

    @property
    def n_tracked(self) -> int:
        return len(self.tracked)


@dataclasses.dataclass
class TelemetryState:
    """The telemetry carry: the time-series panel and, with tracked peers,
    the flight recorder. A state holds one only when built with a
    TelemetryConfig (``SimState.init(telemetry=)``), so a checkpoint's
    template must be built with the same setting."""

    panel: torch.Tensor                  # [rows, N_METRICS] f32
    flight: torch.Tensor | None = None   # [rows, n_tracked, N_FLIGHT] f32

    @classmethod
    def empty(cls, cfg: TelemetryConfig, device=None) -> "TelemetryState":
        cfg.validate()
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return cls(panel=z(cfg.rows, N_METRICS),
                   flight=z(cfg.rows, len(cfg.tracked), N_FLIGHT) if cfg.tracked else None)


# ---------------------------------------------------------------------------
# device-side metrics


def _div(a: torch.Tensor, b: torch.Tensor, folded: bool) -> torch.Tensor:
    """``a / b`` as XLA computes it: a divisor that is a build constant of
    the JAX program is folded into a multiplication by its float32
    reciprocal (XLA's algebraic simplifier, ``A / Const => A * (1 /
    Const)``); any other divisor divides."""
    return a * (1.0 / b) if folded else a / b


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in XLA:CPU's order, every width
    (read from the compiled HLO and held on random rows): a row of up to
    32 left to right from 0.0. A wider row is XLA's tree-reduction
    rewrite: padded with zeros to ``W = ceil(K / 32)`` windows of 32, the
    padding split ``floor(P / 2)`` before and the rest after (``P = 32W -
    K``), each window summed left to right from 0.0, then the ``W``
    window sums reduced the same way (recursively past 32 windows). So a
    row of 33-64 is its first ``ceil(K / 2)`` and the rest, K = 65 is 17,
    32 and 16, and a multiple of 32 is windows of 32. The padding adds
    +0.0 to a sum that is never -0.0, so the windows are cut without it.
    Each partial sum is flushed."""
    k = x.shape[-1]
    if k > 32:
        w = -(-k // 32)
        first = 32 - (32 * w - k) // 2
        cuts = [0] + [first + 32 * i for i in range(w - 1)] + [k]
        return _row_sum(torch.stack([_row_sum(x[..., a:b]) for a, b in zip(cuts, cuts[1:])],
                                    dim=-1))
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(k):
        acc = flush_subnormals(acc + x[..., j])
    return acc


def _row_min(x: torch.Tensor) -> torch.Tensor:
    """float32 min over the last axis as XLA:CPU computes it: -0.0 ranks
    below +0.0 (IEEE minimum), so a row whose least value is a zero of
    both signs gives -0.0, whatever its order (measured on random rows;
    ``amin`` picks either)."""
    m = x.amin(-1)
    negz = ((x == 0.0) & torch.signbit(x)).any(-1)
    return torch.where((m == 0.0) & negz, -0.0, m)


def _sort_as_reference(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sort`` of a float32 vector: ascending, stable, -0.0 and +0.0
    equal (torch orders -0.0 first). The keys add +0.0, which maps -0.0 to
    +0.0 and keeps every other bit; the values keep their own bits."""
    _, idx = torch.sort(x + 0.0, stable=True)
    return x[idx]


def _delivery_ratio(net, msgs, dlv) -> torch.Tensor:
    """Cumulative delivery ratio over the expected (subscriber, live message)
    pairs (``chaos.metrics.delivery_stats``' exclusions: live slots only,
    the origin's own copy excluded), counted per message."""
    live = msgs.birth >= 0
    n = net.subscribed.shape[0]
    m = msgs.birth.shape[0]
    cols = torch.arange(m, device=live.device)
    topic = msgs.topic.clamp(min=0).long()
    origin = msgs.origin.clamp(0, n - 1).long()
    sub_t = net.subscribed[:, topic]                              # [N, M]
    orig_sub = sub_t[origin, cols]
    nsub = net.subscribed.sum(0, dtype=torch.int32)
    exp_m = torch.where(live, nsub[topic] - orig_sub.to(torch.int32), 0)
    got_all = ((dlv.first_round >= 0) & sub_t & live[None, :]).sum(0, dtype=torch.int32)
    fr_o = dlv.first_round[origin, cols]
    got_m = got_all - ((fr_o >= 0) & orig_sub & live).to(torch.int32)
    n_exp = exp_m.sum(dtype=torch.int32)
    ratio = got_m.sum(dtype=torch.int32).float() / n_exp.clamp(min=1).float()
    return torch.where(n_exp > 0, ratio, 1.0)


def _mesh_stats(mesh, my_topics):
    """(min, mean, max) float32 of the per-(peer, live topic slot) mesh
    degree. The sums are of small integers, exact in any order; the slot
    count is a build constant of every engine with a mesh, so it divides
    as one."""
    deg = mesh.sum(-1, dtype=torch.int32)                          # [N, S]
    valid = my_topics >= 0
    n_valid = valid.sum(dtype=torch.int32)
    degf = deg.float()
    mmin = torch.where(valid, degf, _BIG).min()
    mmax = torch.where(valid, degf, -_BIG).max()
    mmean = _div(torch.where(valid, degf, 0.0).sum(), n_valid.clamp(min=1).float(), True)
    ok = n_valid > 0
    return (torch.where(ok, mmin, 0.0), torch.where(ok, mmean, 0.0),
            torch.where(ok, mmax, 0.0))


def _peer_mean_scores(scores, edge_ok, static_live: bool):
    """([N] mean held score over each peer's live edges, [N] live-edge
    count), float32; the count divides as a constant when
    ``static_live``."""
    cnt = edge_ok.float().sum(-1)                                   # exact
    total = _row_sum(torch.where(edge_ok, scores.float(), 0.0))
    return flush_subnormals(_div(total, cnt.clamp(min=1.0), static_live)), cnt


def _score_quantiles(scores, edge_ok, static_live: bool):
    """(p5, p50, p95) float32 across peers of each peer's mean held score
    over its live edges; peers with no live edge are left out (sorted past
    the live prefix), linear interpolation between order statistics (the
    numpy default)."""
    mean, cnt = _peer_mean_scores(scores, edge_ok, static_live)
    has = cnt > 0.0
    order = _sort_as_reference(torch.where(has, mean, float("inf")))
    n = has.sum(dtype=torch.int32)
    last = order.shape[0] - 1
    nm1 = (n - 1).clamp(min=0)

    def q(p):
        pos = flush_subnormals(nm1.float() * float(np.float32(p)))
        lo = torch.floor(pos).to(torch.int32)
        hi = torch.minimum(lo + 1, nm1)
        frac = flush_subnormals(pos - lo.float())
        # gathers at device positions (a 0-d tensor index would read the
        # position on the host)
        vlo = order.gather(0, lo.clamp(0, last).long().reshape(1)).reshape(())
        vhi = order.gather(0, hi.clamp(0, last).long().reshape(1)).reshape(())
        a_mul = flush_subnormals(1.0 - frac)
        if static_live:
            # the position is a build constant there: the sum contracts
            # around the upper order statistic's product
            return flush_subnormals(fma_f32(vlo, a_mul, flush_subnormals(vhi * frac)))
        return flush_subnormals(fma_f32(vhi, frac, flush_subnormals(vlo * a_mul)))

    any_edge = n > 0
    return tuple(torch.where(any_edge, q(p), 0.0) for p in (0.05, 0.5, 0.95))


@functools.lru_cache(maxsize=64)
def _tracked_index(tracked: tuple, device) -> torch.Tensor:
    """The tracked peers as a device index, made once a (tuple, device): a
    copy to the card inside a step would sync, and a window's capture
    fails on a sync."""
    return torch.as_tensor(np.asarray(tracked, np.int64), device=device)


def _flight_row(cfg: TelemetryConfig, dlv, mesh, scores, edge_ok, backoff_active,
                static_live: bool) -> torch.Tensor:
    """[n_tracked, N_FLIGHT] float32 snapshot of the tracked peers."""
    dev = dlv.have.device
    idx = _tracked_index(cfg.tracked, dev)
    zerok = torch.zeros((len(cfg.tracked),), dtype=torch.float32, device=dev)
    mesh_deg = mesh[idx].float().sum((-2, -1)) if mesh is not None else zerok
    if scores is not None:
        ok = edge_ok[idx]
        s_mean, cnt = _peer_mean_scores(scores[idx], ok, static_live)
        s_min = _row_min(torch.where(ok, scores[idx].float(), _BIG))
        has = cnt > 0
        s_mean = torch.where(has, s_mean, 0.0)
        s_min = torch.where(has, s_min, 0.0)
    else:
        s_mean = s_min = zerok
    bo = (backoff_active[idx].float().sum((-2, -1)) if backoff_active is not None
          else zerok)
    held = bitset.popcount(dlv.have[idx]).float()
    return torch.stack([mesh_deg, s_mean, s_min, bo, held], dim=-1)


def _write_row(table: torch.Tensor, row: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``table.at[row].set(vals, mode="drop")`` for a device scalar ``row``
    >= 0: the write lands in a table one row longer, whose last row takes a
    row past the capacity and is cut away (no host read, no device
    assert)."""
    rows = table.shape[0]
    idx = row.clamp(max=rows).reshape(1).long()
    ext = torch.cat([table, table[:1]])
    ext = ext.index_put((idx,), vals[None].to(table.dtype))
    return ext[:rows]


def record_step(cfg: TelemetryConfig, telem: TelemetryState, tick0, ev_prev, ev_next,
                net, msgs, dlv, *, rounds_per_row: int = 1, mesh=None, my_topics=None,
                scores=None, backoff_active=None, static_live: bool = True) -> TelemetryState:
    """Compute and write one panel row (and flight row): device ops only,
    called as a step's last operation so the event deltas cover everything
    the step counted. ``tick0`` is the observation's first round (its row
    is ``tick0 // rounds_per_row``), ``ev_prev``/``ev_next`` the [N_EVENTS]
    counters at the step's entry and exit, ``net`` the round's live view;
    ``mesh`` [N,S,K] with ``my_topics`` [N,S], ``scores`` [N,K] and
    ``backoff_active`` [N,S,K] are None in engines without them.

    ``static_live`` says whether the JAX program holds the round's live
    edges as build constants: not in FloodSub, which takes its net as a
    traced argument, nor under dynamic peers, PX or the mutable overlay.
    XLA folds a division by a constant into a multiplication by its
    reciprocal, so the per-peer score mean and the link-down share take
    that form there, and the quantile's fused multiply-add takes the form
    the constants leave."""
    rpr = max(int(rounds_per_row), 1)
    row = torch.div(torch.as_tensor(tick0, dtype=torch.int32), rpr, rounding_mode="floor")
    delta = (ev_next.to(torch.int32) - ev_prev.to(torch.int32)).float()
    dev = delta.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    dr = _delivery_ratio(net, msgs, dlv)
    edge_ok = net.nbr_ok
    mmin = mmean = mmax = zero
    if mesh is not None:
        mmin, mmean, mmax = _mesh_stats(mesh, my_topics)
    p5 = p50 = p95 = zero
    if scores is not None:
        p5, p50, p95 = _score_quantiles(scores, edge_ok, static_live)
    # link-down occupancy: the observation's LINK_DOWN delta over the live
    # undirected links times the rounds it covers (0 without chaos)
    links_total = (edge_ok & (net.nbr >= 0)).sum(dtype=torch.int32).float() / 2.0
    ldf = _div(delta[int(EV.LINK_DOWN)], (links_total * float(rpr)).clamp(min=1.0),
               static_live)

    row_vec = torch.cat([dr.reshape(1), delta,
                         torch.stack([mmin, mmean, mmax, p5, p50, p95, ldf])])
    panel = _write_row(telem.panel, row, row_vec)
    flight = telem.flight
    if flight is not None:
        flight = _write_row(flight, row, _flight_row(cfg, dlv, mesh, scores, edge_ok,
                                                     backoff_active, static_live))
    return TelemetryState(panel=panel, flight=flight)


# ---------------------------------------------------------------------------
# host-side reconciliation and readers


def panel_ev_totals(panel) -> np.ndarray:
    """[N_EVENTS] int64 sums of one sim's per-observation event deltas
    (float64 sums of exact-integer float32 deltas: exact while each delta
    < 2**24 and the totals < 2**53)."""
    p = _np(panel).astype(np.float64)
    if p.ndim != 2 or p.shape[1] != N_METRICS:
        raise ValueError(f"expected a [rows, {N_METRICS}] panel, got shape {p.shape}")
    return p[:, _EV_COL0:_EV_COL0 + len(EV_METRICS)].sum(axis=0).astype(np.int64)


def reconcile(panel, events) -> list:
    """Drain-against-timeline reconciliation for one sim: the summed event
    deltas must equal the drained counters exactly. Returns the mismatches
    (empty: reconciled)."""
    totals = panel_ev_totals(panel)
    ev = _np(events).astype(np.int64)
    return [f"{EV_METRICS[e]}: timeline total {int(totals[e])} != drained counter "
            f"{int(ev[e])} ({e.name})"
            for e in EV if int(totals[e]) != int(ev[e])]


def reconcile_batched(panels, events) -> list:
    """``reconcile`` per sim over ``[S, rows, N_METRICS]`` panels and
    ``[S, N_EVENTS]`` counters; each mismatch names its sim."""
    p, ev = _np(panels), _np(events)
    return [f"sim {i}: {m}" for i in range(p.shape[0]) for m in reconcile(p[i], ev[i])]


def rows_used(panel, rounds: int, rounds_per_row: int = 1) -> int:
    """Observations a ``rounds``-round run wrote (capped at the capacity)."""
    cap = int(_np(panel).shape[-2])
    return min(cap, int(rounds) // max(int(rounds_per_row), 1))


def timeline_block(panels, rounds_per_row: int = 1, rows: int | None = None,
                   qs=(0.25, 0.5, 0.75), ndigits: int = 5) -> dict:
    """The JAX package's ``timeline`` artifact block from a run's panel(s):
    one sim's ``[T, N_METRICS]`` panel or an ``[S, T, N_METRICS]`` stack, as
    per-metric, per-observation quantile bands across sims (S = 1 bands
    are the single trajectory). ``rows`` truncates to the observations a
    run wrote (``rows_used``); values are rounded to ``ndigits``."""
    p = _np(panels).astype(np.float64)
    if p.ndim == 2:
        p = p[None]
    if p.ndim != 3 or p.shape[-1] != N_METRICS:
        raise ValueError(f"expected [T, {N_METRICS}] or [S, T, {N_METRICS}] panels, "
                         f"got shape {p.shape}")
    if rows is not None:
        p = p[:, : int(rows), :]
    bands = np.quantile(p, np.asarray(qs, np.float64), axis=0)   # [Q, T, M]
    series = {
        name: {f"q{int(round(q * 100))}": [round(float(v), ndigits) for v in bands[qi, :, mi]]
               for qi, q in enumerate(qs)}
        for mi, name in enumerate(METRICS)
    }
    return {"enabled": True, "rounds_per_row": int(rounds_per_row), "rows": int(p.shape[1]),
            "n_sims": int(p.shape[0]), "metrics": list(METRICS), "series": series}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


assert N_METRICS == 1 + N_EVENTS + len(STATE_METRICS)
