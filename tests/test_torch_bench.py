"""The port's bench line (``python -m go_libp2p_pubsub_tpu_torch.bench``)
against the JAX package's: the metric name and the workload fingerprint of
the ``default`` config equal the JAX package's field for field, apart from
``platform``, ``prng_impl`` and ``n_devices``; ``measure_rate`` and the
whole line run on the CPU at a small N; the configs and generators the
port does not carry raise.

The JAX test harness has eight virtual devices, under which the JAX
package records a peer mesh for an N that is a multiple of 8; an N that is
not keeps its execution block the one-device block the port writes."""

from __future__ import annotations

import json

import pytest

from go_libp2p_pubsub_tpu.perf import sweep as jsweep
from go_libp2p_pubsub_tpu_torch import bench
from go_libp2p_pubsub_tpu_torch.perf import artifacts as tart
from go_libp2p_pubsub_tpu_torch.perf import sweep as tsweep

OWN_FIELDS = ("platform", "prng_impl", "n_devices")


@pytest.mark.parametrize("n,r", [(100_000, 8), (12_345, 16), (50_000, 1)])
def test_metric_name_equals_reference(n, r):
    assert tsweep.metric_name("default", n, r) == jsweep.metric_name("default", n, r)


@pytest.mark.parametrize("r,he,seg,unroll", [(8, 8, 1600, 16), (1, 1, None, None),
                                             (4, 8, 800, 16)])
def test_fingerprint_equals_reference(r, he, seg, unroll):
    n = 100_001
    want = jsweep.workload_fingerprint("default", n, 64, he, r, seg_rounds=seg, unroll=unroll)
    got = tsweep.workload_fingerprint("default", n, 64, he, r, seg_rounds=seg, unroll=unroll,
                                      device="cpu")
    assert got["platform"] == "cpu" and got["prng_impl"] == "threefry2x32"
    assert got["n_devices"] == 1
    for f in OWN_FIELDS:
        want.pop(f, None)
        got.pop(f)
    assert got == want


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


@pytest.mark.parametrize("config", ["eth2", "sybil"])
def test_unported_configs_raise(config):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench.bench_line({"BENCH_CONFIG": config, "BENCH_N": "1024"}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsweep.workload_fingerprint(config, 1024, 64, 8, 8, device="cpu")


@pytest.mark.parametrize("prng", ["unsafe_rbg", "rbg"])
def test_unported_prng_raises(prng):
    with pytest.raises(NotImplementedError, match="threefry2x32"):
        bench.bench_line({"BENCH_PRNG": prng, "BENCH_N": "1024"}, device="cpu")
