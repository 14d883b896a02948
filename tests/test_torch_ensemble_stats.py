"""The port's cross-sim reductions (``go_libp2p_pubsub_tpu_torch.ensemble.
stats``, ``trace.drain.batched_counter_events``, ``chaos.metrics``)
against the JAX package's on the same planes, on the CPU: the device
reductions bit for bit (``sim_delivery_ratios`` a float32 division, the
latency histograms integer counts, ``panel_bands`` ``jnp.quantile``'s
float32 interpolation), the host ones (``cdf_bands``, ``quantile_band``,
``bootstrap_ci``) equal as numpy gives them; ``sim_delivery_ratios`` also
against ``chaos.metrics.delivery_stats`` sim by sim. The planes come from
a port FloodSub ensemble under loss (S = 3), the JAX package's
``tests/test_ensemble.py`` cells."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_libp2p_pubsub_tpu.chaos import mesh_reform_latency as jreform
from go_libp2p_pubsub_tpu.ensemble import stats as jstats
from go_libp2p_pubsub_tpu.trace.drain import batched_counter_events as jbatched_events

from go_libp2p_pubsub_tpu_torch import ensemble
from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig, delivery_stats, mesh_reform_latency
from go_libp2p_pubsub_tpu_torch.ensemble import stats
from go_libp2p_pubsub_tpu_torch.state import SimState
from go_libp2p_pubsub_tpu_torch.trace.drain import batched_counter_events
from go_libp2p_pubsub_tpu_torch.trace.events import EV
from test_torch_ensemble import M, N, ROUNDS, nets, port_margs, schedule


def planes(seed: int, s: int = 3, loss: float = 0.4):
    """A port FloodSub ensemble's final planes and the shared subscription
    table (numpy)."""
    _jnet, tnet = nets(seed)
    po, pt, pv = schedule(ROUNDS, seed=seed)
    st0 = SimState.init(N, M, seed=seed + 1, k=tnet.max_degree, device="cpu")
    ens = ensemble.lift_floodsub(tnet, chaos=ChaosConfig(loss_rate=loss) if loss else None)
    run = ensemble.run_rounds(ens, ensemble.batch_states(st0, s), port_margs(po, pt, pv, s),
                              ROUNDS)
    st = run.states
    return {"first_round": st.dlv.first_round.numpy(), "birth": st.msgs.birth.numpy(),
            "topic": st.msgs.topic.numpy(), "origin": st.msgs.origin.numpy(),
            "subscribed": tnet.subscribed.numpy(), "events": st.events.numpy()}


def both(fn_port, fn_jax, p, **kw):
    got = fn_port(*(torch.from_numpy(p[k]) for k in ("first_round", "birth", "topic",
                                                      "origin")), p["subscribed"], **kw)
    want = fn_jax(*(jnp.asarray(p[k]) for k in ("first_round", "birth", "topic", "origin")),
                  p["subscribed"], **kw)
    return got.numpy(), np.asarray(want)


def test_sim_delivery_ratios_equal_the_reference_and_the_host_metrics():
    p = planes(21)
    got, want = both(stats.sim_delivery_ratios, jstats.sim_delivery_ratios, p)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    for i in range(3):
        ds = delivery_stats(p["first_round"][i], p["birth"][i], p["topic"][i], p["origin"][i],
                            p["subscribed"])
        assert got[i] == pytest.approx(ds.ratio, abs=1e-6)
    assert len(set(got.tolist())) > 1       # the flaps made the sims differ
    # a birth window and a receiver split, on both packages
    recv = np.arange(N) % 3 != 0
    for kw in (dict(born_in=(1, 3)), dict(receivers=recv), dict(born_in=(50, 60))):
        got, want = both(stats.sim_delivery_ratios, jstats.sim_delivery_ratios, p, **kw)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), kw
    # an empty window reads 1.0
    assert (got == 1.0).all()


def test_latency_histograms_and_bands_equal_the_reference():
    p = planes(23, loss=0.0)
    for kw in (dict(max_lat=8), dict(max_lat=3, born_in=(0, 2))):
        got, want = both(stats.latency_cdf_counts, jstats.latency_cdf_counts, p, **kw)
        assert got.dtype == np.int32 and np.array_equal(got, want), kw
    hist, _ = both(stats.latency_cdf_counts, jstats.latency_cdf_counts, p, max_lat=8)
    for i in range(2):
        ds = delivery_stats(p["first_round"][i], p["birth"][i], p["topic"][i], p["origin"][i],
                            p["subscribed"])
        assert hist[i].sum() == ds.delivered       # lossless: every expected pair delivers
    for qs in ((0.1, 0.5, 0.9), (0.0, 0.5, 1.0)):
        a, b = stats.cdf_bands(torch.from_numpy(hist), qs), jstats.cdf_bands(hist, qs)
        assert a["qs"] == b["qs"]
        for k in ("pooled", "bands"):
            assert np.array_equal(a[k], b[k]), (qs, k)
    counts = np.zeros((2, 5), np.int64)
    counts[0, 1] = counts[1, 3] = 10
    out = stats.cdf_bands(counts, qs=(0.0, 0.5, 1.0))
    assert out["pooled"][1] == pytest.approx(0.5) and out["bands"][2, 1] == 1.0


@pytest.mark.parametrize("shape", [(5, 7, 4), (1, 3, 2), (4, 6, 3), (7, 12)])
def test_panel_bands_equal_jnp_quantile(shape):
    """``panel_bands`` against the JAX one (``jnp.quantile``, float32
    linear interpolation) bit for bit but NaN's sign and payload: random
    panels with ties, signed zeros, infinities and a NaN column; a 2-D
    panel is one sim."""
    rng = np.random.default_rng(sum(shape))
    p = rng.choice(np.array([-2.5, -0.0, 0.0, 0.1, 1.0 / 3.0, 7.0, np.inf], np.float32),
                   size=shape)
    p = np.where(rng.random(shape) < 0.5, rng.normal(size=shape).astype(np.float32), p)
    if len(shape) == 3 and shape[0] > 1:
        p[2 % shape[0], 1, 0] = np.nan
    for qs in ((0.25, 0.5, 0.75), (0.1, 0.9), (0.0, 1.0, 0.33)):
        got = stats.panel_bands(torch.from_numpy(p), qs)
        want = np.asarray(jstats.panel_bands(p, qs))
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        # NaN where the reference has NaN (its sign and payload bits are
        # not compared), every other value bit for bit
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan), qs
        assert np.array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan]), qs
    with pytest.raises(ValueError, match="S, T, n_metrics"):
        stats.panel_bands(np.zeros((2, 2, 2, 2), np.float32))


def test_quantile_band_and_bootstrap_equal_the_reference():
    v = np.array([0.91, np.nan, 0.95, 0.97, 0.5, np.inf], np.float64)
    assert stats.quantile_band(torch.tensor(v)) == jstats.quantile_band(v)
    assert stats.quantile_band(v, qs=(0.1, 0.9)) == jstats.quantile_band(v, qs=(0.1, 0.9))
    assert stats.bootstrap_ci(v, n_boot=300, seed=4) == jstats.bootstrap_ci(v, n_boot=300, seed=4)
    ratios = stats.sim_delivery_ratios(*(torch.from_numpy(planes(21)[k]) for k in (
        "first_round", "birth", "topic", "origin", "subscribed")))
    band = stats.quantile_band(ratios)
    assert band["n"] == 3 and band["n_undefined"] == 0
    assert band["min"] <= band["q50"] <= band["max"]
    lo, hi = stats.bootstrap_ci(ratios, n_boot=200)
    assert lo <= float(ratios.median()) <= hi
    assert np.isnan(stats.bootstrap_ci([np.nan])).all()


def test_batched_counter_events_and_iwant_shares():
    p = planes(25, s=2, loss=0.5)
    ev = p["events"]
    per_sim, totals = batched_counter_events(torch.from_numpy(ev))
    assert (per_sim, totals) == jbatched_events(ev)
    for i in range(2):
        assert per_sim[i]["LINK_DOWN"] == int(ev[i][EV.LINK_DOWN])
        assert per_sim[i]["PUBLISH_MESSAGE"] == int(ev[i][EV.PUBLISH_MESSAGE])
    assert totals["LINK_DOWN"] == sum(d["LINK_DOWN"] for d in per_sim)
    assert per_sim[0]["LINK_DOWN"] > 0 and per_sim[0]["LINK_DOWN"] != per_sim[1]["LINK_DOWN"]
    with pytest.raises(ValueError, match="batched"):
        batched_counter_events(ev[0])
    shares = np.zeros((2, 15), np.int64)
    shares[0, EV.DELIVER_MESSAGE], shares[0, EV.IWANT_RECOVER] = 100, 25
    got = stats.batched_iwant_shares(shares)
    from go_libp2p_pubsub_tpu.ensemble.stats import batched_iwant_shares as jshares

    assert np.array_equal(got, jshares(shares)) and got[0] == 0.25 and got[1] == 0.0


@pytest.mark.parametrize("arc,heal", [
    ([(10, 30), (12, 8), (14, 1), (18, 2), (22, 9)], 10),
    ([(10, 30), (14, 12), (18, 15)], 10),
    ([(10, 30), (14, 0), (18, 3)], 10),
    ([(10, 30), (14, 4), (18, 5)], 10),
    ([(2, 0), (10, 30), (12, 1), (16, 7)], 10),
])
def test_mesh_reform_latency_semantics(arc, heal):
    """The band-robust partition-repair metric: a trough (<= prune floor)
    then a re-formation (>= min edges), as the JAX package reads it."""
    assert mesh_reform_latency(arc, heal_tick=heal) == jreform(arc, heal_tick=heal)
