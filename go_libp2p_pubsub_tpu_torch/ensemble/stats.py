"""Cross-sim reductions over an ensemble's final states (the JAX package's
``ensemble/stats.py``).

The per-sim summaries (delivery counts, latency histograms) reduce on the
device over the batched planes, so the ``[S, N, M]`` delivery plane never
crosses to the host. The bands (quantiles, pooled CDF envelopes) are small
``[S]`` or ``[S, L]`` reductions; the bootstrap CIs resample the per-sim
summaries on the host (numpy: S values, not S states).

Everything takes the raw batched planes (``first_round [S, N, M]``,
``birth/topic/origin [S, M]``, ``events [S, N_EVENTS]``) rather than a
state, so the same functions serve every engine's state; per sim they
equal ``chaos.metrics``' host versions.
"""

from __future__ import annotations

import numpy as np
import torch

# the batched chaos metric lives with its unbatched sibling; every
# cross-sim reduction is reached through this module
from ..chaos.metrics import batched_iwant_shares  # noqa: F401
from ..ops.fnum import flush_subnormals, fma_f32

_NO_BOUND = (0, 2**31 - 1)


def _as(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device).to(dtype)


def _expected_mask(birth, topic, origin, subscribed, born_lo: int, born_hi: int,
                   receivers=None) -> torch.Tensor:
    """``[S, N, M]`` bool: the (subscriber, message) pairs a delivery is
    expected for, each sim. The one source of the eligibility rule
    (``chaos.metrics.delivery_stats``'s: only live, in-window slots count,
    and the origin has its own copy), shared by the ratio and the latency
    histogram so they never disagree on which pairs count."""
    birth = birth.to(torch.int32)
    live = (birth >= 0) & (birth >= born_lo) & (birth < born_hi)        # [S, M]
    n = subscribed.shape[0]
    exp = subscribed[:, topic.clamp(min=0).long()].permute(1, 0, 2) & live[:, None, :]
    peers = torch.arange(n, dtype=torch.int32, device=birth.device)
    is_origin = (peers[None, :, None] == origin.clamp(0, n - 1)[:, None, :]) & live[:, None, :]
    exp = exp & ~is_origin
    if receivers is not None:
        exp = exp & receivers[None, :, None]
    return exp


def sim_delivery_ratios(first_round, birth, topic, origin, subscribed,
                        born_in: tuple | None = None, receivers=None) -> torch.Tensor:
    """``[S]`` float32 per-sim delivery ratios on the device.
    ``subscribed [N, T]`` is shared by the sims; the message planes carry
    the leading S axis. ``born_in`` restricts to messages born in ``[lo,
    hi)``; ``receivers`` (``[N]`` bool, shared) restricts the expected
    receivers (the attack bands' honest/attacker split). A sim with no
    expected pair reads 1.0; the ratio is a float32 division."""
    fr = torch.as_tensor(first_round)
    dev = fr.device
    lo, hi = born_in if born_in is not None else _NO_BOUND
    sub = _as(subscribed, torch.bool, dev)
    recv = None if receivers is None else _as(receivers, torch.bool, dev)
    exp = _expected_mask(_as(birth, torch.int32, dev), _as(topic, torch.int64, dev),
                         _as(origin, torch.int32, dev), sub, lo, hi, receivers=recv)
    got = ((fr >= 0) & exp).sum((1, 2), dtype=torch.int32)
    n_exp = exp.sum((1, 2), dtype=torch.int32)
    ratio = got.to(torch.float32) / n_exp.clamp(min=1).to(torch.float32)
    return torch.where(n_exp > 0, ratio, torch.ones_like(ratio))


def latency_cdf_counts(first_round, birth, topic, origin, subscribed,
                       max_lat: int, born_in: tuple | None = None) -> torch.Tensor:
    """``[S, max_lat + 1]`` int32 per-sim delivery-latency histograms over
    the expected (subscriber, message) pairs: bucket ``l`` counts first
    deliveries ``l`` rounds after publish (clipped into the last bucket).
    Feed ``cdf_bands``."""
    fr = torch.as_tensor(first_round)
    dev = fr.device
    lo, hi = born_in if born_in is not None else _NO_BOUND
    b = _as(birth, torch.int32, dev)
    exp = _expected_mask(b, _as(topic, torch.int64, dev), _as(origin, torch.int32, dev),
                         _as(subscribed, torch.bool, dev), lo, hi)
    got = (fr >= 0) & exp
    n_sims, width = fr.shape[0], int(max_lat) + 1
    lat = (fr - b[:, None, :]).clamp(0, int(max_lat))
    # one scatter-add over the sims' buckets laid end to end
    idx = (torch.arange(n_sims, dtype=torch.int64, device=dev)[:, None, None] * width
           + lat.long()).reshape(-1)
    counts = torch.zeros(n_sims * width, dtype=torch.int32, device=dev)
    return counts.index_add(0, idx, got.to(torch.int32).reshape(-1)).reshape(n_sims, width)


def cdf_bands(counts, qs=(0.1, 0.5, 0.9)) -> dict:
    """Latency-CDF percentile bands across sims, from ``counts [S, L]``
    per-sim histograms:

    * ``pooled [L]``: the CDF of all sims' deliveries pooled (the
      many-trial estimate a one-seed run approximates);
    * ``bands [len(qs), L]``: at each latency, the ``qs`` quantiles of the
      per-sim CDF values (the envelope the evaluation literature draws
      around its percentile plots).

    Host numpy (the inputs are ``[S, L]`` summaries, not state planes)."""
    c = np.asarray(counts.cpu() if isinstance(counts, torch.Tensor) else counts, np.float64)
    tot = c.sum(axis=1, keepdims=True)
    per_sim = np.cumsum(c, axis=1) / np.maximum(tot, 1.0)
    pooled = np.cumsum(c.sum(axis=0)) / max(float(c.sum()), 1.0)
    bands = np.quantile(per_sim, np.asarray(qs), axis=0)
    return {"pooled": pooled, "bands": bands, "qs": tuple(qs)}


def panel_bands(panels, qs=(0.25, 0.5, 0.75)) -> np.ndarray:
    """``[len(qs), T, n_metrics]`` per-observation quantile bands over a
    batched telemetry panel stack ``[S, T, n_metrics]`` (``telemetry/``:
    each sim records one float32 row a round or phase), reduced on the
    device: ``jnp.quantile``'s linear interpolation in float32 (a sort
    over the sims, the positions ``q * (S - 1)``, the two neighbours
    weighted by ``1 - frac`` and ``frac``; the jitted reference's XLA:CPU
    loop fuses the low neighbour's product into the add, one rounding,
    and reads subnormals as zeros; a column holding a NaN gives NaN). A
    single sim's ``[T, M]`` panel is taken and gives identical bands."""
    p = torch.as_tensor(panels)
    if p.dim() == 2:
        p = p[None]
    if p.dim() != 3:
        raise ValueError(f"expected [S, T, n_metrics] panels, got {tuple(p.shape)}")
    p = p.to(torch.float32)
    nan_col = torch.isnan(p).any(dim=0, keepdim=True)
    a = torch.sort(torch.where(nan_col, torch.full_like(p, float("nan")), p), dim=0).values
    n = float(p.shape[0])
    q = torch.as_tensor(np.asarray(qs, np.float32), device=p.device) * np.float32(n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    low = low.clamp(0.0, n - 1.0).long()
    high = high.clamp(0.0, n - 1.0).long()
    lo_v, hi_v = flush_subnormals(a[low]), flush_subnormals(a[high])
    out = fma_f32(lo_v, lw[:, None, None], flush_subnormals(hi_v * hw[:, None, None]))
    return flush_subnormals(out).cpu().numpy()


def quantile_band(values, qs=(0.25, 0.5, 0.75)) -> dict:
    """Median/IQR-style summary of one per-sim metric: ``{q: value}`` plus
    ``n`` and min/max. Takes ``[S]`` device or host arrays; NaNs (sims
    where the metric is undefined, e.g. an unrecovered partition) are left
    out and counted in ``n_undefined``."""
    v = np.asarray(values.cpu() if isinstance(values, torch.Tensor) else values,
                   np.float64).ravel()
    finite = v[np.isfinite(v)]
    out = {"n": int(v.size), "n_undefined": int(v.size - finite.size)}
    if finite.size:
        for q in qs:
            out[f"q{int(round(q * 100))}"] = float(np.quantile(finite, q))
        out["min"] = float(finite.min())
        out["max"] = float(finite.max())
    return out


def bootstrap_ci(values, n_boot: int = 2000, alpha: float = 0.05,
                 seed: int = 0, stat=np.median) -> tuple[float, float]:
    """Host bootstrap CI of ``stat`` over the per-sim summaries (resampling
    S scalars, not S states). Returns (lo, hi)."""
    v = np.asarray(values.cpu() if isinstance(values, torch.Tensor) else values,
                   np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        return (float("nan"), float("nan"))
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, v.size, size=(n_boot, v.size))
    boots = stat(v[idx], axis=1)
    return (float(np.quantile(boots, alpha / 2)),
            float(np.quantile(boots, 1 - alpha / 2)))
