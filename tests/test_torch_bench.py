"""The port's bench line (``python -m go_libp2p_pubsub_tpu_torch.bench``)
against the JAX package's: the metric names and the workload fingerprints
of the ``default``, ``eth2`` and ``sybil`` configs equal the JAX package's
field for field, apart from ``platform``, ``prng_impl`` and ``n_devices``
and the fields ``PORT_FIELDS`` names; ``measure_rate`` and the whole line
run on the CPU at a small N, for every config; the generators the port
does not carry raise.

The JAX test harness has eight virtual devices, under which the JAX
package records a peer mesh for an N that is a multiple of 8; an N that is
not keeps its execution block the one-device block the port writes."""

from __future__ import annotations

import json

import numpy as np
import pytest

from go_libp2p_pubsub_tpu.perf import sweep as jsweep
from go_libp2p_pubsub_tpu_torch import bench
from go_libp2p_pubsub_tpu_torch.perf import artifacts as tart
from go_libp2p_pubsub_tpu_torch.perf import sweep as tsweep

OWN_FIELDS = ("platform", "prng_impl", "n_devices")

#: fields where the port's phase engine differs from the JAX package's, by
#: config: ``incr_members`` (the port carries the membership planes
#: incrementally for any topic universe, the JAX package up to 8 topics)
#: and ``permute_sets_per_phase`` (the JAX package crosses the edges once
#: more a phase, for the heartbeat's neighbour-protocol view with fanout or
#: the gater's source groups; the port builds both once, with the step; in
#: the per-plane form it crosses once more again, ``_check_fingerprint``)
PORT_FIELDS = {"default": (), "eth2": ("incr_members", "permute_sets_per_phase"),
               "sybil": ("permute_sets_per_phase",)}


@pytest.mark.parametrize("config", ["default", "eth2", "sybil"])
@pytest.mark.parametrize("n,r", [(100_000, 8), (12_345, 16), (50_000, 1)])
def test_metric_name_equals_reference(n, r, config):
    assert tsweep.metric_name(config, n, r) == jsweep.metric_name(config, n, r)


@pytest.mark.parametrize("config", ["default", "eth2", "sybil"])
@pytest.mark.parametrize("r,he,seg,unroll", [(8, 8, 1600, 16), (1, 1, None, None),
                                             (4, 8, 800, 16)])
def test_fingerprint_equals_reference(r, he, seg, unroll, config):
    n = 50_001 if config == "sybil" else 100_001
    _check_fingerprint(config, n, r, he, seg, unroll, {})


def _check_fingerprint(config, n, r, he, seg, unroll, kw):
    want = jsweep.workload_fingerprint(config, n, 64, he, r, seg_rounds=seg, unroll=unroll,
                                       **kw)
    got = tsweep.workload_fingerprint(config, n, 64, he, r, seg_rounds=seg, unroll=unroll,
                                      device="cpu", **kw)
    assert got["platform"] == "cpu" and got["prng_impl"] == "threefry2x32"
    assert got["n_devices"] == 1
    for f in OWN_FIELDS:
        want.pop(f, None)
        got.pop(f)
    if r > 1:
        # the port's own fields, named above: the port's values
        for f in PORT_FIELDS[config]:
            if f == "incr_members":
                assert got["engine"][f] and not want["engine"][f]
                want["engine"][f] = got["engine"][f]
        # the per-plane head: the port carries the score plane in the
        # control words' crossing, the JAX package in a crossing of its own
        coalesced = kw.get("wire_coalesced", True)
        f = "permute_sets_per_phase"
        assert got[f] == r + (1 if coalesced else 2)
        assert want[f] - got[f] == ("permute_sets_per_phase" in PORT_FIELDS[config]) + (
            not coalesced)
        want[f] = got[f]
    assert got == want


@pytest.mark.parametrize("config,coalesced,lift", [
    ("default", True, False), ("default", True, True), ("default", False, False),
    ("default", False, True), ("sybil", False, True)])
def test_fingerprint_of_wire_form_and_lift_equals_reference(config, coalesced, lift):
    """The ``engine.wire_coalesced`` field and the ``params`` block (the
    lifted fields by name) equal the JAX package's, in both engines; the
    per-plane phase head crosses twice, the coalesced one once."""
    n = 50_001 if config == "sybil" else 100_001
    kw = dict(wire_coalesced=coalesced, lift_scores=lift)
    for r, he, seg in ((8, 8, 1600), (1, 1, None)):
        _check_fingerprint(config, n, r, he, seg, 16 if seg else None, kw)
    got = tsweep.workload_fingerprint(config, n, 64, 8, 8, device="cpu", **kw)
    assert got["engine"]["wire_coalesced"] == coalesced
    assert got["params"]["lifted"] == lift and len(got["params"]["traced"]) == (29 if lift else 0)
    assert got["permute_sets_per_phase"] == (9 if coalesced else 10)


def test_bench_line_per_plane_on_the_cpu():
    """``BENCH_WIRE_COALESCED=0`` runs the per-plane form and says so."""
    env = {"BENCH_N": "512", "BENCH_ROUNDS": "8", "BENCH_CONTINUITY": "0",
           "BENCH_WIRE_COALESCED": "0"}
    line = bench.bench_line(env, device="cpu")
    assert line["value"] > 0
    assert line["fingerprint"]["engine"]["wire_coalesced"] is False


@pytest.mark.parametrize("config", ["eth2", "sybil"])
def test_bench_line_of_each_config_on_the_cpu(config):
    """The eth2 and sybil lines at a small N: schema 3, the metric the JAX
    bench names, the config's fingerprint; the sybil line's N defaults to
    50,000 as the root bench's does."""
    env = {"BENCH_CONFIG": config, "BENCH_N": "512", "BENCH_ROUNDS": "8",
           "BENCH_CONTINUITY": "0"}
    line = bench.bench_line(env, device="cpu")
    assert line["schema"] == 3 and line["value"] > 0
    assert line["metric"] == jsweep.metric_name(config, 512, 8)
    fp = line["fingerprint"]
    assert fp["config"] == config and fp["n_peers"] == 512
    assert fp["engine"]["gater"] == (config == "sybil")
    assert fp["engine"]["fanout_slots"] == (2 if config == "eth2" else 0)


def test_sybil_default_n(monkeypatch):
    seen = {}

    def fake_measure(config, n_peers, *a, **kw):
        seen[config] = n_peers
        return None

    monkeypatch.setattr(tsweep, "measure_rate", fake_measure)
    for config in ("default", "eth2", "sybil"):
        bench.bench_line({"BENCH_CONFIG": config, "BENCH_CONTINUITY": "0"}, device="cpu")
    assert seen == {"default": 100_000, "eth2": 100_000, "sybil": 50_000}


def test_build_bench_configs_equal_the_reference():
    """The eth2 and sybil builds take the JAX package's settings: the
    same subscriptions, gater parameters, throttle capacity, fanout slots
    and TTL, and (sybil) the same adversary draw, so the same honest
    publish origins."""
    import dataclasses

    from go_libp2p_pubsub_tpu import config as jconfig
    from go_libp2p_pubsub_tpu import graph as jgraph
    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
    from go_libp2p_pubsub_tpu_torch import config as tconfig
    from go_libp2p_pubsub_tpu_torch import graph as tgraph
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg

    js, ts = jgraph.subscribe_random(300, 64, 2, seed=3), tgraph.subscribe_random(300, 64, 2, seed=3)
    for f in ("subscribed", "my_topics", "slot_of"):
        assert np.array_equal(np.asarray(getattr(js, f)), getattr(ts, f)), f
    jg, tg = jconfig.PeerGaterParams(), tconfig.PeerGaterParams()
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    jc = JCfg.build(jconfig.GossipSubParams(), jconfig.PeerScoreThresholds(), score_enabled=True,
                    gater_params=jg, validation_capacity=8)
    tc = TCfg.build(tconfig.GossipSubParams(), tconfig.PeerScoreThresholds(), score_enabled=True,
                    gater_params=tg, validation_capacity=8)
    for f in dataclasses.fields(TCfg):
        assert getattr(jc, f.name) == getattr(tc, f.name), f.name
    for config, slots in (("eth2", 2), ("sybil", 0), ("default", 0)):
        _jst, _jstep, jt, jhonest = jsweep.build_bench(256, 64, config=config)
        tst, _tstep, tt, thonest = tsweep.build_bench(256, 64, config=config, device="cpu")
        assert jt == tt and tst.fanout_topic.shape == (256, slots)
        assert (jhonest is None) == (thonest is None) == (config != "sybil")
        if config == "sybil":
            assert np.array_equal(jhonest, thonest) and 0.7 < len(thonest) / 256 < 0.9


def test_bench_line_on_the_cpu():
    """The whole line at N=512 with its continuity rate: schema 3, the
    unit, a positive rate, the fingerprint of what ran."""
    env = {"BENCH_N": "512", "BENCH_ROUNDS": "12", "BENCH_CONTINUITY": "1"}
    line = json.loads(json.dumps(bench.bench_line(env, device="cpu")))
    assert line["schema"] == tart.SCHEMA_VERSION == 3
    assert line["metric"] == "gossipsub_v1.1_delivery_rounds_per_sec_n512_phase8"
    assert line["unit"] == "delivery-rounds/s" and line["value"] > 0
    # the line rounds each figure from the unrounded rate
    assert abs(line["vs_baseline"] - line["value"] / tart.NORTH_STAR_RATE) <= 0.51e-4
    assert abs(line["heartbeats_per_sec"] - line["value"] / 8) <= 0.51e-2 + 0.005 / 8
    assert line["continuity_r1_ticks_per_sec"] > 0 and line["continuity_r1_n"] == 512
    fp = line["fingerprint"]
    assert fp["seg_rounds"] == 8 and fp["unroll"] == 16
    assert fp["execution"]["segment_rounds"] == 8


def test_measure_rate_on_the_cpu():
    """Three windows after the warm one, each from where the last ended."""
    rate, n, u, scan = tsweep.measure_rate("default", 1024, 64, 2, 1, 6, reps=3,
                                           device="cpu")
    assert rate > 0 and n == 1024 and u == 4
    assert scan.window.replays == 0        # the CPU runs the plain loop


@pytest.mark.parametrize("prng", ["unsafe_rbg", "rbg"])
def test_unported_prng_raises(prng):
    with pytest.raises(NotImplementedError, match="threefry2x32"):
        bench.bench_line({"BENCH_PRNG": prng, "BENCH_N": "1024"}, device="cpu")
