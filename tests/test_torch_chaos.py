"""The port's chaos plane host and primitive modules against the JAX
package's: ``chaos/faults.py`` (the config, the seed, every draw and mask
on a static net and on a rewired overlay, the LINK_DOWN count),
``chaos/scenario.py`` (masks, liveness rows, events, the hash) and
``chaos/metrics.py`` (every function on the same arrays, the device
observer against the JAX one). Every comparison is bit for bit; the
port runs on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.chaos import faults as jfaults
from go_libp2p_pubsub_tpu.chaos import metrics as jmetrics
from go_libp2p_pubsub_tpu.chaos import scenario as jscenario
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import TopoState as JTopo
from go_libp2p_pubsub_tpu.topo import dynamics as jdyn
from go_libp2p_pubsub_tpu_torch import chaos as tchaos
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import prng
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.chaos import faults as tfaults
from go_libp2p_pubsub_tpu_torch.chaos import metrics as tmetrics
from go_libp2p_pubsub_tpu_torch.chaos import scenario as tscenario
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import TopoState as TTopo
from go_libp2p_pubsub_tpu_torch.topo import dynamics as tdyn
from go_libp2p_pubsub_tpu_torch.trace.events import EV, N_EVENTS

N = 48
#: the config cases of the JAX package's tests/test_chaos.py:65-95, and more
CONFIGS = [dict(), dict(generator="ge"), dict(scheduled=True), dict(loss_rate=0.35),
           dict(generator="ge", ge_p_down=0.15, ge_p_up=0.4),
           dict(generator="ge", ge_p_down=0.2, ge_p_up=0.4, scheduled=True),
           dict(loss_rate=1.0), dict(loss_rate=1.5), dict(generator="nope"),
           dict(generator="gilbert", loss_rate=0.3),
           dict(generator="ge", ge_p_down=0.2, ge_p_up=0.0), dict(ge_p_up=-0.1)]


def _outcome(cls, resolve, kw):
    c = cls(**kw)
    try:
        c.validate()
    except ValueError as e:
        return ("invalid", type(e).__name__, str(e))
    r = resolve(c)
    return ("valid", c.generator_enabled, c.enabled, c.needs_state, c.fingerprint(),
            r is None)


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(k) for k in CONFIGS])
def test_config_validate_resolve_fingerprint(kw):
    assert (_outcome(tchaos.ChaosConfig, tfaults.resolve, kw)
            == _outcome(jfaults.ChaosConfig, jfaults.resolve, kw))
    assert tfaults.resolve(None) is None
    assert tfaults.CHAOS_TAG == jfaults.CHAOS_TAG


def test_build_refuses_an_invalid_enabled_config():
    from go_libp2p_pubsub_tpu_torch.config import GossipSubParams, PeerScoreThresholds
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig

    with pytest.raises(tchaos.ChaosConfigError):
        GossipSubConfig.build(GossipSubParams(), PeerScoreThresholds(),
                              chaos=tchaos.ChaosConfig(loss_rate=2.0))
    cfg = GossipSubConfig.build(chaos=tchaos.ChaosConfig(loss_rate=0.1))
    assert cfg.chaos.loss_rate == 0.1


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 0xFFFFFFFF])
def test_chaos_seed_equals_reference(seed):
    want = int(jfaults.chaos_seed(jax.random.key(seed)))
    got = tfaults.chaos_seed(prng.key(seed, device="cpu"))
    assert got.dim() == 0 and int(got) == want


def _static_nets():
    jt, tt = jgraph.random_connect(N, d=5, seed=3), tgraph.random_connect(N, d=5, seed=3)
    return (JNet.build(jt, jgraph.subscribe_all(N, 1)),
            TNet.build(tt, tgraph.subscribe_all(N, 1), device="cpu"))


def _rewired_overlays():
    """Both packages' overlays of a power-law net after 8 dispatches of a
    churn storm (rewires and joins bump the written slots' epochs)."""
    kw = dict(n_dispatches=12, kill_frac=0.2, rewires=6, joins=2, join_links=2, seed=1)
    jt = jtopo.to_topology(jtopo.powerlaw(N, max_degree=6, seed=1), max_degree=10)
    tt = ttopo.to_topology(ttopo.powerlaw(N, max_degree=6, seed=1), max_degree=10)
    jw, _ = jdyn.churn_storm(jt, **kw).build()
    jn = JNet.build(jt, jgraph.subscribe_all(N, 1), dynamic=True)
    tn = TNet.build(tt, tgraph.subscribe_all(N, 1), device="cpu", dynamic=True)
    j1, t1 = JTopo.from_net(jn), TTopo.from_net(tn)
    for batch in jw[:8]:
        j1 = jdyn.apply_mutation(j1, jnp.asarray(batch))
        t1 = tdyn.apply_mutation(t1, torch.from_numpy(batch))
    assert int(t1.epoch.sum()) > 0
    return (jn.with_overlay(j1), j1), (tn.with_overlay(t1), t1)


@pytest.mark.parametrize("keying", ["static", "overlay"])
def test_link_draws_equal_reference(keying):
    """``link_uniform`` on three salts, ``iid_link_down``, a GE chain over
    12 ticks (from a random bad plane), ``round_link_ok`` for every
    generator with and without a deny plane and ``count_links_down``, at
    ticks given as ints and as tensors, on several seeds."""
    if keying == "static":
        jn, tn = _static_nets()
        jtp = ttp = None
    else:
        (jn, jtp), (tn, ttp) = _rewired_overlays()
    rng = np.random.default_rng(5)
    deny = rng.random(tuple(tn.nbr.shape)) < 0.2
    cfgs = [dict(loss_rate=0.35), dict(generator="ge", ge_p_down=0.15, ge_p_up=0.4),
            dict(scheduled=True), dict(loss_rate=0.2, scheduled=True)]
    for key in (3, 2**31 + 11):
        js, ts = jfaults.chaos_seed(jax.random.key(key)), tfaults.chaos_seed(prng.key(key))
        jbad = tbad = rng.random(tuple(tn.nbr.shape)) < 0.3
        jbad, tbad = jnp.asarray(jbad), torch.from_numpy(tbad)
        for tick in (0, 1, 5, 1000, 2**31 - 1):
            t_tick = torch.tensor(tick, dtype=torch.int32) if tick % 2 else tick
            for salt in (0x11D, 0x6E0D, 0x75E1):
                want = np.asarray(jfaults.link_uniform(js, jn.nbr, tick, salt, topo=jtp))
                got = tfaults.link_uniform(ts, tn.nbr, t_tick, salt, topo=ttp).numpy()
                np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=str(tick))
            np.testing.assert_array_equal(
                tfaults.iid_link_down(ts, tn.nbr, t_tick, 0.35, topo=ttp).numpy(),
                np.asarray(jfaults.iid_link_down(js, jn.nbr, tick, 0.35, topo=jtp)))
            jbad = jfaults.ge_advance(js, jn.nbr, tick, jbad, 0.15, 0.4, topo=jtp)
            tbad = tfaults.ge_advance(ts, tn.nbr, t_tick, tbad, 0.15, 0.4, topo=ttp)
            np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
            for kw in cfgs:
                for d in (None, deny):
                    jok, jge = jfaults.round_link_ok(
                        jfaults.ChaosConfig(**kw), js, jn.nbr, tick, jbad,
                        None if d is None else jnp.asarray(d), topo=jtp)
                    tok, tge = tfaults.round_link_ok(
                        tchaos.ChaosConfig(**kw), ts, tn.nbr, t_tick, tbad,
                        None if d is None else torch.from_numpy(d), topo=ttp)
                    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
                    np.testing.assert_array_equal(tge.numpy(), np.asarray(jge))
                    got = tfaults.count_links_down(tn.nbr, tn.nbr_ok, tok)
                    assert got.dtype == torch.int32
                    assert int(got) == int(jfaults.count_links_down(jn.nbr, jn.nbr_ok, jok))


def test_masks_symmetric_and_rekey_locally():
    """Both directions of a link draw the same value (static and overlay
    keying), and bumping one link's two epochs redraws that link alone."""
    _j, tn = _static_nets()
    ts = tfaults.chaos_seed(prng.key(9))
    nbr, rev, ok = tn.nbr.numpy(), tn.rev.numpy(), tn.nbr_ok.numpy()
    jj, kk = np.nonzero(ok)
    u = tfaults.link_uniform(ts, tn.nbr, 4, 0x11D).numpy()
    np.testing.assert_array_equal(u[jj, kk], u[nbr[jj, kk], rev[jj, kk]])
    _jo, (tnet, t1) = _rewired_overlays()
    nbr, rev, ok = tnet.nbr.numpy(), tnet.rev.numpy(), tnet.nbr_ok.numpy()
    u1 = tfaults.link_uniform(ts, tnet.nbr, 4, 0x11D, topo=t1).numpy()
    jj, kk = np.nonzero(ok)
    np.testing.assert_array_equal(u1[jj, kk], u1[nbr[jj, kk], rev[jj, kk]])
    i, k = int(jj[0]), int(kk[0])
    j, kr = int(nbr[i, k]), int(rev[i, k])
    ep = t1.epoch.clone()
    ep[i, k] += 1
    ep[j, kr] += 1
    from go_libp2p_pubsub_tpu_torch.state import replace

    u2 = tfaults.link_uniform(ts, tnet.nbr, 4, 0x11D, topo=replace(t1, epoch=ep)).numpy()
    changed = u2 != u1
    assert changed[i, k] and changed[j, kr] and u2[i, k] == u2[j, kr]
    changed[i, k] = changed[j, kr] = False
    assert not changed.any()


def test_ge_needs_its_state():
    _j, tn = _static_nets()
    with pytest.raises(ValueError, match="chaos_ge=True"):
        tfaults.round_link_ok(tchaos.ChaosConfig(generator="ge", ge_p_down=0.1),
                              tfaults.chaos_seed(prng.key(0)), tn.nbr, 0, None, None)


# ---------------------------------------------------------------------------
# scenarios


def _scenarios(mod):
    groups = tuple(int(g) for g in np.random.default_rng(2).integers(0, 3, N))
    return [
        mod.two_group_partition(N, start=5, rounds=10),
        mod.two_group_partition(N, start=5, rounds=11),
        mod.Scenario(n_peers=N, partitions=(
            mod.Partition(start=0, rounds=4, groups=mod.halves(N)),
            mod.Partition(start=2, rounds=9, groups=groups)),
            crashes=(mod.CrashStorm(start=3, rounds=5, peers=(1, 4, 40)),
                     mod.CrashStorm(start=6, rounds=1, peers=(2,)))),
        mod.Scenario(n_peers=N, crashes=(mod.CrashStorm(start=2, rounds=3, peers=(1, 4)),)),
        mod.Scenario(n_peers=N),
    ]


def test_scenarios_equal_reference():
    nbr = _static_nets()[1].nbr.numpy()
    assert tscenario.halves(N) == jscenario.halves(N)
    for js, ts in zip(_scenarios(jscenario), _scenarios(tscenario)):
        ts.validate()
        assert ts.scenario_hash() == js.scenario_hash()
        assert ts.events() == js.events()
        assert (ts.scheduled, ts.dynamic, ts.horizon()) == (js.scheduled, js.dynamic,
                                                             js.horizon())
        for tick in range(-1, js.horizon() + 2):
            want, got = js.link_deny_at(tick, nbr), ts.link_deny_at(tick, nbr)
            assert (want is None) == (got is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(ts.up_at(tick), js.up_at(tick))
    bad = [dict(n_peers=4, partitions=(tscenario.Partition(0, 2, (0, 1)),)),
           dict(n_peers=4, partitions=(tscenario.Partition(0, 0, (0, 1, 0, 1)),)),
           dict(n_peers=4, crashes=(tscenario.CrashStorm(0, 0, (1,)),)),
           dict(n_peers=4, crashes=(tscenario.CrashStorm(0, 2, (4,)),))]
    for kw in bad:
        with pytest.raises(ValueError):
            tscenario.Scenario(**kw).validate()


# ---------------------------------------------------------------------------
# metrics


def _delivery_arrays(seed=0, n=N, m=40):
    rng = np.random.default_rng(seed)
    birth = np.where(rng.random(m) < 0.8, rng.integers(0, 30, m), -1).astype(np.int32)
    topic = np.where(birth >= 0, rng.integers(0, 2, m), -1).astype(np.int32)
    origin = np.where(birth >= 0, rng.integers(0, n, m), -1).astype(np.int32)
    fr = np.where(rng.random((n, m)) < 0.85, rng.integers(0, 40, (n, m)), -1).astype(np.int32)
    subscribed = rng.random((n, 2)) < 0.7
    up = rng.random(n) < 0.9
    return fr, birth, topic, origin, subscribed, up


def test_metrics_equal_reference():
    fr, birth, topic, origin, sub, up = _delivery_arrays()
    full = np.where(fr < 0, 35, fr)
    for kw in (dict(), dict(up=up), dict(born_in=(5, 20)), dict(up=up, born_in=(0, 12))):
        np.testing.assert_array_equal(
            tmetrics.expected_receivers(birth, topic, origin, sub, **kw),
            jmetrics.expected_receivers(birth, topic, origin, sub, **kw))
        got = tmetrics.delivery_stats(fr, birth, topic, origin, sub, **kw)
        want = jmetrics.delivery_stats(fr, birth, topic, origin, sub, **kw)
        assert (got.delivered, got.expected, got.ratio) == (want.delivered, want.expected,
                                                            want.ratio)
        for f in (fr, full):
            assert (tmetrics.time_to_recover(f, birth, topic, origin, sub, 10, **kw)
                    == jmetrics.time_to_recover(f, birth, topic, origin, sub, 10, **kw))
    assert tmetrics.DeliveryStats(3, 0).ratio == 1.0
    rng = np.random.default_rng(1)
    ev = rng.integers(0, 500, N_EVENTS).astype(np.int32)
    for e in (ev, np.zeros_like(ev)):
        assert tmetrics.iwant_recovery_share(e) == jmetrics.iwant_recovery_share(e)
        assert tmetrics.links_down_total(e) == jmetrics.links_down_total(e)
    batch = rng.integers(0, 50, (5, N_EVENTS)).astype(np.int32)
    batch[2, EV.DELIVER_MESSAGE] = 0
    np.testing.assert_array_equal(tmetrics.batched_iwant_shares(batch),
                                  jmetrics.batched_iwant_shares(batch))
    series = [(t, int(c)) for t, c in enumerate(rng.integers(0, 10, 40))]
    for heal in (0, 7, 20, 45):
        for args in ((), (3,)):
            assert (tmetrics.mesh_repair_latency(series, heal, *args)
                    == jmetrics.mesh_repair_latency(series, heal, *args))
        for kw in (dict(), dict(prune_floor=4, min_edges=8), dict(prune_floor=0)):
            assert (tmetrics.mesh_reform_latency(series, heal, **kw)
                    == jmetrics.mesh_reform_latency(series, heal, **kw))
    assert tmetrics.mesh_reform_latency([(0, 9), (1, 8)], 0) == 0


def test_cross_mesh_counts_and_observer_equal_reference():
    jn, tn = _static_nets()
    rng = np.random.default_rng(4)
    groups = rng.integers(0, 3, N)
    nbr, ok = tn.nbr.numpy(), tn.nbr_ok.numpy()
    mesh = rng.random((N, 2, nbr.shape[1])) < 0.5
    meshes = rng.random((3, N, 2, nbr.shape[1])) < 0.5
    assert (tmetrics.cross_group_mesh_count(mesh, nbr, ok, groups)
            == jmetrics.cross_group_mesh_count(mesh, nbr, ok, groups))
    np.testing.assert_array_equal(
        tmetrics.batched_cross_group_mesh_counts(meshes, nbr, ok, groups),
        jmetrics.batched_cross_group_mesh_counts(meshes, nbr, ok, groups))
    tobs = tmetrics.make_cross_mesh_observer(nbr, ok, groups)
    jobs = jmetrics.make_cross_mesh_observer(nbr, ok, groups)

    class _St:
        def __init__(self, mesh):
            self.mesh = mesh

    for m in (mesh, meshes):
        got = tobs(_St(torch.from_numpy(m)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jobs(_St(jnp.asarray(m)))))
