"""The port's ``perf/artifacts.py`` against the JAX package's: both
packages' readers give equal records on every committed ``BENCH_r*.json``
(``load_bench_artifact``, ``load_bench_lines``, ``load_bench_variants``,
``load_bench_trajectory``) and ``MULTICHIP_r*.json``; every fingerprint
block and off or legacy sentinel equals the JAX package's and round-trips
through the line format; the port's CPU bench line reads back equal
through both readers. The twins of the JAX package's
tests/test_perf.py:27-105 and :443-560."""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import pytest

from go_libp2p_pubsub_tpu.perf import artifacts as jart
from go_libp2p_pubsub_tpu_torch import bench
from go_libp2p_pubsub_tpu_torch.perf import artifacts as tart
from go_libp2p_pubsub_tpu_torch.routers.config import RouterConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = sorted(glob.glob(os.path.join(ROOT, "BENCH_r*.json")))
MULTICHIP = sorted(glob.glob(os.path.join(ROOT, "MULTICHIP_r*.json")))

SENTINELS = ("SCHEMA_VERSION", "NORTH_STAR_RATE", "CHAOS_OFF", "ENSEMBLE_OFF",
             "SIM_KEY_DERIVATION", "TELEMETRY_OFF", "INVARIANTS_OFF", "ADVERSARY_OFF",
             "SCORE_WEIGHTS_UNKNOWN", "SCAN_OFF", "PARAMS_STATIC", "SERVICE_OFF",
             "TOPOLOGY_BANDED", "COST_UNAUDITED", "DYNAMICS_OFF", "ROUTER_V11")

#: every derived view of a record
VIEWS = ("rounds_per_phase", "n_peers", "config", "ms_per_round", "wire_coalesced",
         "edge_layout", "chaos", "chaos_off", "ensemble", "n_sims", "adversary",
         "adversary_on", "score_weights", "timeline", "telemetry_on", "invariants",
         "invariants_on", "params", "params_lifted", "execution", "service", "service_on",
         "topology", "topology_recorded", "cost", "cost_audited", "dynamics", "dynamics_on",
         "router", "router_on", "scanned", "dispatches_per_round", "permute_sets_per_phase")


def _same(a, b, where):
    assert type(a).__name__ == type(b).__name__ == "BenchRecord", where
    assert dataclasses.asdict(a) == dataclasses.asdict(b), where
    for v in VIEWS:
        assert getattr(a, v) == getattr(b, v), (where, v)
    assert a.to_line() == b.to_line() and tart.dump_record(a) == jart.dump_record(b), where


def test_sentinels_equal_reference():
    for name in SENTINELS:
        assert getattr(tart, name) == getattr(jart, name), name


@pytest.mark.parametrize("path", BENCH, ids=os.path.basename)
def test_readers_equal_reference_on_committed_bench_artifacts(path):
    _same(tart.load_bench_artifact(path), jart.load_bench_artifact(path), path)
    tl, jl = tart.load_bench_lines(path), jart.load_bench_lines(path)
    assert len(tl) == len(jl) >= 1
    for a, b in zip(tl, jl):
        _same(a, b, path)
    tv, jv = tart.load_bench_variants(path), jart.load_bench_variants(path)
    assert list(tv) == list(jv) and "parsed" in tv
    for k in tv:
        _same(tv[k], jv[k], f"{path} {k}")


def test_trajectory_equals_reference():
    tt, jt = tart.load_bench_trajectory(ROOT), jart.load_bench_trajectory(ROOT)
    assert len(tt) == len(jt) == len(BENCH) >= 5
    for a, b in zip(tt, jt):
        _same(a, b, a.round_index)
    assert [r.round_index for r in tt[:5]] == [1, 2, 3, 4, 5]
    assert [r.rounds_per_phase for r in tt[:5]] == [1, 1, 1, 8, 8]
    assert all(r.n_peers == 100_000 for r in tt[:5])


@pytest.mark.parametrize("path", MULTICHIP, ids=os.path.basename)
def test_multichip_reader_equals_reference(path):
    assert tart.load_multichip_artifact(path) == jart.load_multichip_artifact(path)


def test_bad_artifacts_raise_as_reference(tmp_path):
    bad = tmp_path / "x.json"
    bad.write_text(json.dumps({"foo": 1}))
    for mod in (tart, jart):
        with pytest.raises(ValueError):
            mod.load_multichip_artifact(str(bad))
        with pytest.raises(ValueError, match="not a bench metric line"):
            mod.record_from_line({"value": 1.0})
    # a wrapper whose parse failed keeps its line in the tail
    line = {"schema": 2, "metric": "gossipsub_v1.1_heartbeat_ticks_per_sec_n100000",
            "value": 400.0, "unit": "ticks/s", "vs_baseline": 0.04}
    p = tmp_path / "BENCH_rXX.json"
    p.write_text(json.dumps({"n": 9, "cmd": "python bench.py", "rc": 0,
                             "tail": "WARNING: something\n" + json.dumps(line) + "\n"}))
    rec = tart.load_bench_artifact(str(p))
    assert rec.value == 400.0 and rec.round_index == 9 and rec.schema == 2
    _same(rec, jart.load_bench_artifact(str(p)), "tail")


class _Fake:
    """A duck-typed chaos config, adversary or scenario (both modules read
    them through ``fingerprint()`` and ``scenario_hash()``)."""

    enabled = True

    def __init__(self, fp):
        self._fp = fp

    def fingerprint(self):
        return dict(self._fp)

    def scenario_hash(self):
        return "0123abcd"


def _blocks(mod):
    """Every fingerprint block of ``mod`` on the same arguments."""
    return {
        "dynamics": mod.dynamics_fingerprint(mutation_dispatches=5, writes_per_dispatch=16,
                                             kills=3, joins=2, rewires=7,
                                             schedule_hash="feed"),
        "router_off": mod.router_fingerprint(),
        "router": mod.router_fingerprint(RouterConfig(idontwant=True, choke=True,
                                                      latency_rounds=3)),
        "cost": mod.cost_fingerprint(build="phase", flops_per_round=1234.56,
                                     hbm_bytes_per_round=789.01, halo_bytes_per_round=12.3,
                                     rng_bits_per_round=4.5),
        "cost0": mod.cost_fingerprint(build="x", flops_per_round=1.0, hbm_bytes_per_round=0.0,
                                      halo_bytes_per_round=0.0, rng_bits_per_round=0.0),
        "topology": mod.topology_fingerprint(
            generator="powerlaw", family="power-law",
            params={"exponent": 2.2, "d_min": 2, "max_degree": 64}, n_edges=10186,
            mean_degree=4.97123, max_degree=61, density=0.0781234, seed=0,
            link_classes={"local": 100, "regional": 40}, workload_pattern="storm"),
        "service": mod.service_fingerprint(segment_rounds=8, keep_last=3, keep_every=4,
                                           probes=("finite-state", "events-monotone"),
                                           recoveries=2, segments=40, resumes=1),
        "params": mod.params_fingerprint(True, ("b", "a")),
        "params_off": mod.params_fingerprint(lifted=False),
        "execution": mod.execution_fingerprint(scan=True, segment_rounds=1600,
                                               dispatches_per_window=1, rounds_per_dispatch=8,
                                               mesh_shape={"peers": 8}, unroll=16,
                                               check_every=2),
        "adversary_off": mod.adversary_fingerprint(),
        "adversary": mod.adversary_fingerprint(
            _Fake({"enabled": True, "n_sybils": 7, "behaviors": ["drop_forward"],
                   "onset": 3, "stop": None, "promo_score": 1.0, "population": "abc"}),
            _Fake({})),
        "score_weights": mod.score_weights_fingerprint(invalid_message_deliveries_weight=-1,
                                                       behaviour_penalty_weight=-10.0),
        "ensemble": mod.ensemble_fingerprint(8, "pooled_cdf"),
        "chaos_off": mod.chaos_fingerprint(),
        "chaos": mod.chaos_fingerprint(_Fake({"generator": "iid", "loss_rate": 0.1}),
                                       _Fake({})),
    }


def test_fingerprint_blocks_equal_reference_and_round_trip():
    tb, jb = _blocks(tart), _blocks(jart)
    assert json.dumps(tb) == json.dumps(jb)
    fp = {k: v for k, v in tb.items() if not k.endswith(("_off", "0"))}
    for mod in (tart, jart):
        rec = mod.BenchRecord(metric="service_loop_rounds_per_sec", value=32.0,
                              unit="rounds/s", vs_baseline=0.0, schema=3, fingerprint=fp,
                              extras={"heartbeats_per_sec": 4.0},
                              timeline_raw={"enabled": True, "rows": 2},
                              invariants_raw={"enabled": True, "checked": 4})
        back = mod.record_from_line(json.loads(mod.dump_record(rec)))
        assert back == rec
        assert back.service_on and back.service["retention"] == {"keep_last": 3,
                                                                  "keep_every": 4}
        assert back.topology_recorded and back.cost_audited and back.dynamics_on
        assert back.router_on and back.router["protocol"] == "v1.2"
        assert back.adversary_on and back.adversary["scenario"] == "0123abcd"
        assert back.telemetry_on and back.invariants_on and back.params_lifted
        assert back.dispatches_per_round == 1 / 1600
    _same(tart.record_from_line(json.loads(tart.dump_record(tart.BenchRecord(
        metric="m", value=2.0, unit="u", vs_baseline=0.0, schema=3, fingerprint=fp)))),
        jart.record_from_line(json.loads(jart.dump_record(jart.BenchRecord(
            metric="m", value=2.0, unit="u", vs_baseline=0.0, schema=3, fingerprint=fp)))),
        "blocks")


def test_legacy_lines_read_the_sentinels():
    line = {"metric": "gossipsub_v1.1_delivery_rounds_per_sec_n100000_eth2_phase8",
            "value": 400.0, "unit": "x"}
    rec = tart.record_from_line(dict(line))
    _same(rec, jart.record_from_line(dict(line)), "legacy")
    assert rec.vs_baseline == 400.0 / tart.NORTH_STAR_RATE and rec.schema == 1
    assert (rec.rounds_per_phase, rec.n_peers, rec.config) == (8, 100_000, "eth2")
    assert rec.service == tart.SERVICE_OFF and not rec.service_on
    assert rec.topology == tart.TOPOLOGY_BANDED and rec.cost == tart.COST_UNAUDITED
    assert rec.router == tart.ROUTER_V11 and rec.dynamics == tart.DYNAMICS_OFF
    assert rec.adversary == tart.ADVERSARY_OFF and rec.chaos_off
    assert rec.score_weights == tart.SCORE_WEIGHTS_UNKNOWN
    assert rec.params == tart.PARAMS_STATIC and rec.execution == tart.SCAN_OFF
    assert rec.timeline == tart.TELEMETRY_OFF and rec.invariants == tart.INVARIANTS_OFF
    assert rec.scanned is None and rec.dispatches_per_round is None
    # the nested service sentinel is copied, never shared
    rec.service["retention"]["keep_last"] = 99
    rec.service["probes"].append("x")
    assert tart.SERVICE_OFF == jart.SERVICE_OFF


def test_port_bench_line_reads_back_in_both_packages(tmp_path):
    """The port's bench line on the CPU (N=512), written as a raw line, a
    JSON-lines file and a driver wrapper: both readers give equal records
    whose views read the line's own fingerprint."""
    env = {"BENCH_N": "512", "BENCH_ROUNDS": "8", "BENCH_CONTINUITY": "0"}
    line = bench.bench_line(env, device="cpu")
    raw, lines, wrap = (tmp_path / n for n in ("raw.json", "lines.jsonl", "BENCH_r99.json"))
    raw.write_text(json.dumps(line))
    lines.write_text("note\n" + json.dumps(line) + "\n" + json.dumps(line) + "\n")
    wrap.write_text(json.dumps({"n": 99, "cmd": "bench", "rc": 0, "tail": "", "parsed": line}))
    for p in (raw, lines, wrap):
        rec = tart.load_bench_artifact(str(p))
        _same(rec, jart.load_bench_artifact(str(p)), p.name)
        assert rec.to_line() == line
        assert rec.n_peers == 512 and rec.rounds_per_phase == 8 and rec.scanned
        assert rec.execution["segment_rounds"] == 8 and rec.params == line["fingerprint"][
            "params"]
        assert not rec.service_on and not rec.router_on and rec.chaos_off
    assert len(tart.load_bench_lines(str(lines))) == 2
    assert tart.load_bench_variants(str(wrap))["parsed"].round_index == 99
