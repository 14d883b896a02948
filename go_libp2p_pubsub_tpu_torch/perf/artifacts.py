"""Versioned, self-describing bench artifacts (schema v3) and their
readers: the port's copy of the JAX package's ``perf/artifacts.py``,
field for field, so either package reads the other's lines.

A bench line carries its metric, value and a config fingerprint whose
blocks (``chaos``, ``ensemble``, ``adversary``, ``score_weights``,
``params``, ``execution``, ``service``, ``topology``, ``cost``,
``dynamics``, ``router``) are built here; a line without a block reads
back its explicit off or legacy sentinel (``CHAOS_OFF``, ``SERVICE_OFF``,
``TOPOLOGY_BANDED``, ...), so a reader can ask any artifact any question.
Schema v3 adds the optional top-level ``timeline`` (the telemetry panel's
bands) and ``invariants`` (the oracle's accounting) blocks.

Three on-disk shapes are read:

  * a v2/v3 line: the metric fields plus ``"schema"`` and
    ``"fingerprint"``;
  * a v1 line: bare ``{"metric", "value", "unit", "vs_baseline", ...}``;
  * a run wrapper, the committed ``BENCH_r*.json`` files: ``{"n",
    "cmd", "rc", "tail", "parsed": <line>}`` (``MULTICHIP_r*.json``
    wrappers carry ``{"n_devices", "rc", "ok", "skipped", "tail"}``).

``load_bench_artifact`` takes any of the three and returns a
:class:`BenchRecord`; ``load_bench_lines`` reads every metric line of a
JSON-lines artifact; ``load_bench_variants`` every ``parsed*`` record of
a wrapper; ``load_bench_trajectory`` the committed ``BENCH_r*.json``
series of a checkout in round order; ``load_multichip_artifact`` a
multichip wrapper.

The cost block prices a build from the JAX package's static cost model,
which the port does not carry (ROADMAP §1, item 8): only the function
that formats the block is here.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re

SCHEMA_VERSION = 3

#: the north-star denominator every ``vs_baseline`` in the series uses:
#: 10k simulated delivery rounds (heartbeat ticks at r=1) per wall second
#: (BASELINE.json)
NORTH_STAR_RATE = 10_000.0

#: the chaos-plane defaults every artifact WITHOUT a chaos block reads
#: back as (self-describing, per the ADVICE round-5 pattern): the whole
#: committed BENCH_r* trajectory was measured on a lossless wire
CHAOS_OFF = {"generator": "off", "loss_rate": 0.0, "scheduled": False,
             "scenario": None}

#: the ensemble-plane defaults every artifact WITHOUT an ensemble block
#: reads back as: one sim, the base key unfolded, a point estimate (the
#: whole pre-round-10 trajectory is single-seed)
ENSEMBLE_OFF = {"n_sims": 1, "sim_key": "base", "aggregation": "point"}

#: the one sim-key derivation the ensemble plane implements
#: (ensemble/batch.py): sim i's PRNG key is fold_in(sim_key, i)
SIM_KEY_DERIVATION = "fold_in(sim_key, sim_idx)"

#: the telemetry-plane defaults every artifact WITHOUT a timeline block
#: reads back as (every line up to schema v2 — the whole committed
#: trajectory predates the telemetry plane): no panel was recorded, so
#: readers asking for the trajectory get an explicit empty-but-typed
#: answer instead of a KeyError
TELEMETRY_OFF = {"enabled": False, "rounds_per_row": 1, "rows": 0,
                 "n_sims": 0, "metrics": [], "series": {}}

#: the invariant-oracle defaults every artifact WITHOUT an invariants
#: block reads back as (every line that predates the oracle plane):
#: nothing was property-checked — readers (tracestat --json, gates) get
#: an explicit typed answer, never a KeyError
INVARIANTS_OFF = {"enabled": False, "engine": None, "properties": [],
                  "checked": 0, "violated": 0, "n_checks": 0, "n_sims": 0,
                  "check_every": 0, "rounds_per_step": 1,
                  "last_checked_round": -1, "violations": []}


#: the adversary-plane defaults every artifact WITHOUT an adversary
#: block reads back as (the whole pre-round-13 trajectory was measured
#: against an honest population; the static bench `sybil` config's
#: no-forward vector predates the plane and is fingerprinted as
#: ``adversary_fraction`` in the workload block instead)
ADVERSARY_OFF = {"enabled": False, "n_sybils": 0, "behaviors": [],
                 "onset": 0, "stop": None, "promo_score": 0.0,
                 "population": None, "scenario": None}

#: the score-weight defaults every artifact WITHOUT a
#: fingerprint["score_weights"] block reads back as (ADVICE round 5
#: item 1: the P4-weight-zeroing that enables trans-plane elision must
#: be visible in the JSON itself — a legacy line can only answer
#: "unrecorded", never silently "zero")
SCORE_WEIGHTS_UNKNOWN = {"recorded": False}

#: the execution defaults every artifact WITHOUT a
#: fingerprint["execution"] block reads back as (round 14): nothing is
#: known about how the run window was dispatched — the sentinel is
#: explicit ("scan": None = unrecorded, NOT False), because the
#: rounds-4..13 bench already scanned its segments while the report
#: cells dispatched per round; a legacy line cannot say which it was.
SCAN_OFF = {"scan": None, "segment_rounds": None,
            "dispatches_per_window": None, "rounds_per_dispatch": None,
            "mesh_shape": None, "unroll": None, "check_every": None}

#: the params defaults every artifact WITHOUT a fingerprint["params"]
#: block reads back as (round 16): the whole pre-lift trajectory baked
#: every config knob into the compiled program as a static — an
#: explicit sentinel ("recorded": False), so readers can ask any
#: artifact "which knobs were traced inputs" without special-casing
#: age; the legacy answer is "all static, unrecorded split".
PARAMS_STATIC = {"recorded": False, "lifted": False, "traced": []}

#: the service defaults every artifact WITHOUT a fingerprint["service"]
#: block reads back as (round 17): the run was NOT driven by the
#: supervised service loop — no checkpoint retention, no health probes,
#: no recoveries to report. Explicit sentinel so readers can ask any
#: artifact "was this number cut under supervision, and did the run
#: recover mid-flight" without special-casing age.
SERVICE_OFF = {"enabled": False, "segment_rounds": 0,
               "retention": {"keep_last": 0, "keep_every": 0},
               "probes": [], "recoveries": 0, "segments": 0, "resumes": 0}


#: the topology defaults every artifact WITHOUT a
#: fingerprint["topology"] block reads back as (round 18): the whole
#: pre-round-18 bench trajectory was cut on the banded bench ring
#: (graph.ring_lattice d=8) — an explicit sentinel naming that shape,
#: so readers can ask any artifact "what graph did this number run on"
#: without special-casing age. ``recorded: False`` marks the answer as
#: the historical default, not a measured emission.
TOPOLOGY_BANDED = {"recorded": False, "generator": "ring_lattice",
                   "family": "banded-regular", "params": {},
                   "n_edges": None, "mean_degree": None,
                   "max_degree": None, "density": None, "seed": None,
                   "link_classes": None, "workload_pattern": None}


#: the cost defaults every artifact WITHOUT a fingerprint["cost"] block
#: reads back as (round 19): the producing build was never priced by
#: the static device-cost audit (analysis/costmodel.py) — an explicit
#: COST_UNAUDITED sentinel, so readers can ask any artifact "what does
#: one round of this build cost, statically" without special-casing
#: age; the legacy answer is "unrecorded", never a silently-assumed
#: zero.
COST_UNAUDITED = {"recorded": False, "build": None,
                  "flops_per_round": None, "hbm_bytes_per_round": None,
                  "halo_bytes_per_round": None, "rng_bits_per_round": None,
                  "arithmetic_intensity": None}


#: the dynamics defaults every artifact WITHOUT a
#: fingerprint["dynamics"] block reads back as (round 22): the overlay
#: was FROZEN for the whole window — no device-side topology mutation,
#: no kills/joins/rewires, no mutation schedule riding the scan xs.
#: Explicit sentinel so readers can ask any artifact "did the graph
#: move under this number, and how hard" without special-casing age;
#: the legacy answer is "static overlay", which is exactly what every
#: pre-round-22 run was.
DYNAMICS_OFF = {"enabled": False, "mutation_dispatches": 0,
                "writes_per_dispatch": 0, "kills": 0, "joins": 0,
                "rewires": 0, "schedule_hash": None}


#: the router defaults every artifact WITHOUT a fingerprint["router"]
#: block reads back as (round 24): the producing build ran plain
#: GossipSub v1.1 semantics — no IDONTWANT suppression, no lazy
#: choking, no latency ring — which is exactly what every pre-round-24
#: build was (``router=None`` is the one spelling of v1.1; see
#: routers/config.py). Explicit sentinel so readers can ask any
#: artifact "which protocol generation cut this number, and was the
#: latency plane load-bearing" without special-casing age.
ROUTER_V11 = {"enabled": False, "protocol": "v1.1",
              "idontwant": False, "idontwant_threshold": None,
              "choke": False, "choke_ema_alpha": None,
              "choke_threshold": None, "unchoke_threshold": None,
              "choke_max_per_hb": None, "latency_rounds": 0}


def dynamics_fingerprint(*, mutation_dispatches: int,
                         writes_per_dispatch: int, kills: int = 0,
                         joins: int = 0, rewires: int = 0,
                         schedule_hash: str | None = None) -> dict:
    """The schema-v3 ``fingerprint["dynamics"]`` block (round 22): the
    dynamic-overlay plane's self-description — how many dispatches of
    the window carried a non-empty mutation batch, the padded write-row
    budget per dispatch (the ``[B, 4]`` xs width), the churn
    composition (peers killed/joined, edges rewired), and the
    MutationSchedule's content hash so two runs can be matched on the
    exact mutation stream. Emitted by ``MutationSchedule``-driven
    producers (``make churn-smoke``); readers go through
    :attr:`BenchRecord.dynamics`, which defaults legacy lines to
    :data:`DYNAMICS_OFF`."""
    return {
        "enabled": True,
        "mutation_dispatches": int(mutation_dispatches),
        "writes_per_dispatch": int(writes_per_dispatch),
        "kills": int(kills),
        "joins": int(joins),
        "rewires": int(rewires),
        "schedule_hash": (None if schedule_hash is None
                          else str(schedule_hash)),
    }


def router_fingerprint(router=None) -> dict:
    """The schema-v3 ``fingerprint["router"]`` block (round 24): the
    router plane's self-description — protocol generation ("v1.1" |
    "v1.2", the latter iff IDONTWANT is armed per the spec's version
    gate), every choke knob (EMA alpha, hysteresis pair, per-heartbeat
    budget) so two choke cells can be matched on the exact decision
    rule, and the latency ring depth L (0 = every edge commits
    immediately, the v1.1 data plane). Duck-typed over
    routers.RouterConfig so this module stays jax-free; ``None`` (the
    one spelling of v1.1 semantics) returns the explicit off block new
    router-less artifacts carry. Readers go through
    :attr:`BenchRecord.router`, which defaults legacy lines to
    :data:`ROUTER_V11`."""
    if router is None:
        return dict(ROUTER_V11)
    idw = bool(getattr(router, "idontwant", False))
    choke = bool(getattr(router, "choke", False))
    return {
        "enabled": True,
        "protocol": "v1.2" if idw else "v1.1",
        "idontwant": idw,
        "idontwant_threshold": (float(router.idontwant_threshold)
                                if idw else None),
        "choke": choke,
        "choke_ema_alpha": (float(router.choke_ema_alpha)
                            if choke else None),
        "choke_threshold": (float(router.choke_threshold)
                            if choke else None),
        "unchoke_threshold": (float(router.unchoke_threshold)
                              if choke else None),
        "choke_max_per_hb": (int(router.choke_max_per_hb)
                             if choke else None),
        "latency_rounds": int(getattr(router, "latency_rounds", 0)),
    }


def cost_fingerprint(*, build: str, flops_per_round: float,
                     hbm_bytes_per_round: float,
                     halo_bytes_per_round: float,
                     rng_bits_per_round: float) -> dict:
    """The schema-v3 ``fingerprint["cost"]`` block (round 19): the
    statically-priced per-round cost of the producing build — the
    COST_AUDIT.json fit evaluated at the artifact's own N (flops, the
    unfused-traffic hbm bytes, the audited halo bytes, rng bits), plus
    the derived arithmetic intensity (flops over hbm bytes). Readers go through
    :attr:`BenchRecord.cost`, which defaults legacy lines to
    :data:`COST_UNAUDITED`."""
    flops = float(flops_per_round)
    hbm = float(hbm_bytes_per_round)
    return {
        "recorded": True,
        "build": str(build),
        "flops_per_round": round(flops, 1),
        "hbm_bytes_per_round": round(hbm, 1),
        "halo_bytes_per_round": round(float(halo_bytes_per_round), 1),
        "rng_bits_per_round": round(float(rng_bits_per_round), 1),
        "arithmetic_intensity": round(flops / hbm, 6) if hbm else None,
    }


def topology_fingerprint(*, generator: str, family: str, params: dict,
                         n_edges: int, mean_degree: float,
                         max_degree: int, density: float,
                         seed: int | None = None,
                         link_classes: dict | None = None,
                         workload_pattern: str | None = None) -> dict:
    """The schema-v3 ``fingerprint["topology"]`` block (round 18): the
    generated graph a cell ran on — generator name + parameters, the
    edge count / degree statistics that price the sparse plane
    (``density`` = E/(N·K) IS the dense-vs-csr byte ratio), optional
    geo link-class counts, and the workload pattern riding the publish
    xs. Legacy lines read back :data:`TOPOLOGY_BANDED` via
    ``BenchRecord.topology``."""
    return {
        "recorded": True,
        "generator": str(generator),
        "family": str(family),
        "params": dict(params),
        "n_edges": int(n_edges),
        "mean_degree": round(float(mean_degree), 4),
        "max_degree": int(max_degree),
        "density": round(float(density), 6),
        "seed": None if seed is None else int(seed),
        "link_classes": dict(link_classes) if link_classes else None,
        "workload_pattern": workload_pattern,
    }


def service_fingerprint(*, segment_rounds: int, keep_last: int,
                        keep_every: int, probes=(), recoveries: int = 0,
                        segments: int = 0, resumes: int = 0) -> dict:
    """The schema-v3 ``fingerprint["service"]`` block (round 17): the
    supervised service loop's self-description — checkpoint quantum in
    rounds, the retention policy pair, which health probes were armed,
    and how eventful the run was (recoveries performed, segments
    committed, resumes from disk). Emitted by ``ServiceReport.
    fingerprint()`` (serve/supervisor.py) and the service-smoke gate;
    readers go through :attr:`BenchRecord.service`, which defaults
    legacy lines to :data:`SERVICE_OFF`."""
    return {
        "enabled": True,
        "segment_rounds": int(segment_rounds),
        "retention": {"keep_last": int(keep_last),
                      "keep_every": int(keep_every)},
        "probes": [str(p) for p in probes],
        "recoveries": int(recoveries),
        "segments": int(segments),
        "resumes": int(resumes),
    }


def params_fingerprint(lifted: bool, traced=()) -> dict:
    """The schema-v3 ``fingerprint["params"]`` block (round 16): the
    traced-vs-static config split of the producing build. ``traced``
    names the audit-namespace fields riding the lifted ScoreParams
    plane (score.params.LIFTED_FIELD_NAMES for a lifted build; empty
    when everything is static). Readers go through
    :attr:`BenchRecord.params`, which defaults legacy lines to
    :data:`PARAMS_STATIC`."""
    return {"recorded": True, "lifted": bool(lifted),
            "traced": sorted(str(t) for t in traced)}


def execution_fingerprint(*, scan: bool, segment_rounds: int,
                          dispatches_per_window: int,
                          rounds_per_dispatch: int,
                          mesh_shape=None, unroll: int | None = None,
                          check_every: int | None = None) -> dict:
    """The schema-v3 ``fingerprint["execution"]`` block (round 14): how
    the run window was dispatched — whole-window scan vs per-dispatch
    loop, segment length, dispatches per window, the device-mesh shape
    (a ``{axis: size}`` dict — 2-D sims×peers meshes record both axes)
    and the folded invariant cadence. This is what lets the projection
    engine price dispatch overhead from the artifact alone
    (perf.projection ``dispatch_overhead_ms``). Readers go through
    :attr:`BenchRecord.execution`, which defaults legacy lines to
    :data:`SCAN_OFF` (explicitly unrecorded)."""
    return {
        "scan": bool(scan),
        "segment_rounds": int(segment_rounds),
        "dispatches_per_window": int(dispatches_per_window),
        "rounds_per_dispatch": int(rounds_per_dispatch),
        "mesh_shape": (None if mesh_shape is None
                       else {str(k): int(v)
                             for k, v in dict(mesh_shape).items()}),
        "unroll": None if unroll is None else int(unroll),
        "check_every": None if check_every is None else int(check_every),
    }


def adversary_fingerprint(adversary=None, scenario=None) -> dict:
    """The schema-v3 ``fingerprint["adversary"]`` block: the attacker
    population's self-description (duck-typed via ``fingerprint()`` —
    chaos.adversary.Adversary — so this module stays jax-free) plus the
    AttackScenario schedule hash. No arguments = the explicit off block
    new honest-population artifacts carry."""
    out = dict(ADVERSARY_OFF)
    if adversary is not None and getattr(adversary, "enabled", False):
        out.update(adversary.fingerprint())
    if scenario is not None:
        out["scenario"] = scenario.scenario_hash()
    return out


def score_weights_fingerprint(**weights) -> dict:
    """The ``fingerprint["score_weights"]`` block for a producer that
    knows its weights (``recorded: True`` + the named weight values) —
    the self-description satellite of ADVICE round 5 item 1. Readers go
    through :attr:`BenchRecord.score_weights`, which defaults legacy
    lines to :data:`SCORE_WEIGHTS_UNKNOWN`."""
    out = {"recorded": True}
    out.update({k: float(v) for k, v in weights.items()})
    return out


def ensemble_fingerprint(n_sims: int = 1,
                         aggregation: str = "quantile_band") -> dict:
    """The schema-v2 ``fingerprint["ensemble"]`` block for an
    ENSEMBLE-EXECUTED run: how many sims the number aggregates over,
    how their keys were derived, and the aggregation mode
    (``"quantile_band"`` median + IQR over per-sim summaries,
    ``"pooled_cdf"`` sims' events pooled before the reduction).

    The derivation is reported even at S=1: a batched single-sim run
    samples the ``fold_in(sim_key, 0)`` stream, which is a DIFFERENT
    stream from the base key's — labeling it ``"base"`` would send a
    replayer to the wrong numbers. Non-ensemble producers simply omit
    the block; readers default it to :data:`ENSEMBLE_OFF` via
    :attr:`BenchRecord.ensemble`."""
    return {"n_sims": int(n_sims), "sim_key": SIM_KEY_DERIVATION,
            "aggregation": str(aggregation)}


def chaos_fingerprint(chaos=None, scenario=None) -> dict:
    """The schema-v2 ``fingerprint["chaos"]`` block: generator kind +
    rates (from a chaos.ChaosConfig — duck-typed via its
    ``fingerprint()`` so this module stays jax-free) and the scenario
    schedule hash (from a chaos.Scenario). ``chaos_fingerprint()`` with
    no arguments is the explicit off block new lossless artifacts
    carry."""
    out = dict(CHAOS_OFF)
    if chaos is not None and getattr(chaos, "enabled", False):
        out.update(chaos.fingerprint())
    if scenario is not None:
        out["scenario"] = scenario.scenario_hash()
    return out


@dataclasses.dataclass
class BenchRecord:
    """One normalized bench measurement.

    ``schema`` is 1 for legacy lines (no fingerprint), 2 for
    self-describing lines. ``round_index`` is the wrapper's round number
    when the record came from a committed ``BENCH_r0N.json`` wrapper
    (None for a raw line). ``extras`` keeps every field the schema does
    not model (heartbeats_per_sec, continuity metrics, unit notes) so a
    v2 round-trip is lossless."""

    metric: str
    value: float
    unit: str
    vs_baseline: float
    schema: int = 1
    fingerprint: dict | None = None
    round_index: int | None = None
    extras: dict = dataclasses.field(default_factory=dict)
    #: schema-v3 telemetry block (telemetry.timeline_block); None when
    #: the producing run recorded no panel — read through .timeline
    timeline_raw: dict | None = None
    #: schema-v3 invariant-oracle block (oracle.InvariantReport
    #: .artifact_block); None when the run checked nothing — read
    #: through .invariants
    invariants_raw: dict | None = None

    # -- derived views ----------------------------------------------------

    @property
    def rounds_per_phase(self) -> int:
        """Cadence of the headline metric (1 = per-round heavy tick).
        v2 reads the fingerprint; v1 falls back to the ``_phaseR`` metric
        name suffix rounds 4-5 used."""
        if self.fingerprint and "rounds_per_phase" in self.fingerprint:
            return int(self.fingerprint["rounds_per_phase"])
        m = re.search(r"_phase(\d+)$", self.metric)
        return int(m.group(1)) if m else 1

    @property
    def n_peers(self) -> int | None:
        if self.fingerprint and "n_peers" in self.fingerprint:
            return int(self.fingerprint["n_peers"])
        m = re.search(r"_n(\d+)", self.metric)
        return int(m.group(1)) if m else None

    @property
    def config(self) -> str:
        if self.fingerprint and "config" in self.fingerprint:
            return str(self.fingerprint["config"])
        for tag in ("eth2", "sybil"):
            if f"_{tag}" in self.metric:
                return tag
        return "default"

    @property
    def ms_per_round(self) -> float:
        return 1000.0 / self.value

    @property
    def wire_coalesced(self) -> bool | None:
        """The engine's round-7 stacked/coalesced data-plane switch;
        None for artifacts that predate the field (rounds 1-6)."""
        fp = self.fingerprint or {}
        eng = fp.get("engine") or {}
        v = eng.get("wire_coalesced")
        return None if v is None else bool(v)

    @property
    def edge_layout(self) -> str:
        """The engine's round-15 edge-exchange layout ("dense" |
        "csr"); every artifact that predates the field measured the
        dense involution, so legacy lines read back "dense"."""
        fp = self.fingerprint or {}
        eng = fp.get("engine") or {}
        return str(eng.get("edge_layout") or "dense")

    @property
    def chaos(self) -> dict:
        """The chaos-plane block of the fingerprint. LEGACY artifacts
        (rounds 1-7 — every line that predates the chaos plane) read
        back with the chaos=off defaults, so readers can filter or
        group the whole trajectory on fault parameters without
        special-casing age."""
        fp = self.fingerprint or {}
        out = dict(CHAOS_OFF)
        out.update(fp.get("chaos") or {})
        return out

    @property
    def chaos_off(self) -> bool:
        c = self.chaos
        return (c["generator"] == "off" and c["scenario"] is None
                and not c.get("scheduled", False))

    @property
    def ensemble(self) -> dict:
        """The ensemble block of the fingerprint. LEGACY artifacts
        (every line that predates the ensemble plane) read back as the
        single-sim point-estimate defaults, so readers can ask "how
        many trials is this number over" across the whole trajectory."""
        fp = self.fingerprint or {}
        out = dict(ENSEMBLE_OFF)
        out.update(fp.get("ensemble") or {})
        return out

    @property
    def n_sims(self) -> int:
        return int(self.ensemble["n_sims"])

    @property
    def adversary(self) -> dict:
        """The adversary block of the fingerprint. LEGACY artifacts
        (every line that predates the adversary plane) read back as
        :data:`ADVERSARY_OFF`, so readers can ask any artifact "was
        this measured under attack, by whom" without special-casing
        age; ``adversary["enabled"]`` says whether one was armed."""
        fp = self.fingerprint or {}
        out = dict(ADVERSARY_OFF)
        out.update(fp.get("adversary") or {})
        return out

    @property
    def adversary_on(self) -> bool:
        return bool(self.adversary["enabled"])

    @property
    def score_weights(self) -> dict:
        """The score-weight block of the fingerprint (ADVICE round 5
        item 1). Producers that record their weights carry
        ``recorded: True`` plus the named values (the sweep's workload
        fingerprint and the chaos/attack report lines do); LEGACY
        artifacts read back :data:`SCORE_WEIGHTS_UNKNOWN` — an explicit
        "unrecorded" sentinel, never a silently-assumed zero."""
        fp = self.fingerprint or {}
        sw = fp.get("score_weights")
        if not sw:
            return dict(SCORE_WEIGHTS_UNKNOWN)
        out = {"recorded": True}
        out.update(sw)
        return out

    @property
    def timeline(self) -> dict:
        """The schema-v3 timeline block. LEGACY artifacts (every line
        that predates the telemetry plane) read back as
        :data:`TELEMETRY_OFF`, so readers — the run report, gates —
        can ask any artifact for its trajectory without special-casing
        age; ``timeline["enabled"]`` says whether one was recorded."""
        out = dict(TELEMETRY_OFF)
        out.update(self.timeline_raw or {})
        return out

    @property
    def telemetry_on(self) -> bool:
        return bool(self.timeline["enabled"])

    @property
    def invariants(self) -> dict:
        """The schema-v3 invariants block (checked/violated counts,
        last-checked round, property catalog). LEGACY artifacts — every
        line that predates the invariant oracle plane — read back as
        :data:`INVARIANTS_OFF`; ``invariants["enabled"]`` says whether
        the producing run was property-checked."""
        out = dict(INVARIANTS_OFF)
        out.update(self.invariants_raw or {})
        return out

    @property
    def invariants_on(self) -> bool:
        return bool(self.invariants["enabled"])

    @property
    def params(self) -> dict:
        """The params block of the fingerprint (round 16): which config
        knobs rode the compiled program as TRACED inputs (the lifted
        ScoreParams plane) versus baked statics. LEGACY artifacts —
        every line that predates the score lift — read back
        :data:`PARAMS_STATIC` (recorded: False), an explicit
        "all-static, split unrecorded" sentinel."""
        fp = self.fingerprint or {}
        out = dict(PARAMS_STATIC)
        out.update(fp.get("params") or {})
        return out

    @property
    def params_lifted(self) -> bool:
        return bool(self.params["lifted"])

    @property
    def execution(self) -> dict:
        """The execution block of the fingerprint (round 14). LEGACY
        artifacts — every line that predates whole-run windows — read
        back :data:`SCAN_OFF` (``scan: None`` = unrecorded), so readers
        can ask any artifact "how many dispatches did this window pay"
        without special-casing age."""
        fp = self.fingerprint or {}
        out = dict(SCAN_OFF)
        out.update(fp.get("execution") or {})
        return out

    @property
    def service(self) -> dict:
        """The service block of the fingerprint (round 17). LEGACY
        artifacts — every line that predates the supervised loop — read
        back :data:`SERVICE_OFF`, so readers can ask any artifact "was
        this cut under supervision / did it recover mid-run" without
        special-casing age."""
        fp = self.fingerprint or {}
        out = dict(SERVICE_OFF)
        # the only sentinel with a NESTED dict: copy it too, or a caller
        # mutating rec.service["retention"] corrupts the module default
        # for every later legacy read
        out["retention"] = dict(SERVICE_OFF["retention"])
        out["probes"] = list(SERVICE_OFF["probes"])
        out.update(fp.get("service") or {})
        return out

    @property
    def service_on(self) -> bool:
        return bool(self.service["enabled"])

    @property
    def topology(self) -> dict:
        """The topology block of the fingerprint (round 18). LEGACY
        artifacts — the whole pre-round-18 trajectory — read back
        :data:`TOPOLOGY_BANDED` (the banded bench ring, explicitly
        marked unrecorded), so readers can ask any artifact "what
        graph did this run on" without special-casing age."""
        fp = self.fingerprint or {}
        out = dict(TOPOLOGY_BANDED)
        out.update(fp.get("topology") or {})
        return out

    @property
    def topology_recorded(self) -> bool:
        return bool(self.topology["recorded"])

    @property
    def cost(self) -> dict:
        """The cost block of the fingerprint (round 19): the static
        per-round flop/byte price of the producing build
        (analysis/costmodel.py). LEGACY artifacts — every line that
        predates the cost audit — read back :data:`COST_UNAUDITED`,
        an explicit "never statically priced" sentinel."""
        fp = self.fingerprint or {}
        out = dict(COST_UNAUDITED)
        out.update(fp.get("cost") or {})
        return out

    @property
    def cost_audited(self) -> bool:
        return bool(self.cost["recorded"])

    @property
    def dynamics(self) -> dict:
        """The dynamics block of the fingerprint (round 22): whether —
        and how hard — the overlay mutated under the measurement
        (kills/joins/rewires per window, schedule hash). LEGACY
        artifacts — every line that predates the dynamic overlay —
        read back :data:`DYNAMICS_OFF`: the graph was frozen, which is
        literally true of every pre-round-22 run."""
        fp = self.fingerprint or {}
        out = dict(DYNAMICS_OFF)
        out.update(fp.get("dynamics") or {})
        return out

    @property
    def dynamics_on(self) -> bool:
        return bool(self.dynamics["enabled"])

    @property
    def router(self) -> dict:
        """The router block of the fingerprint (round 24): which
        protocol generation cut the number (v1.1 | v1.2-IDONTWANT),
        the choke decision rule, and the latency ring depth. LEGACY
        artifacts — every line that predates the router plane — read
        back :data:`ROUTER_V11`: plain v1.1 semantics, which is
        literally what every pre-round-24 build ran."""
        fp = self.fingerprint or {}
        out = dict(ROUTER_V11)
        out.update(fp.get("router") or {})
        return out

    @property
    def router_on(self) -> bool:
        return bool(self.router["enabled"])

    @property
    def scanned(self) -> bool | None:
        return self.execution["scan"]

    @property
    def dispatches_per_round(self) -> float | None:
        """Dispatches paid per simulated round — the projection's
        ``dispatch_overhead_ms`` multiplier; None when unrecorded."""
        ex = self.execution
        if not ex["dispatches_per_window"] or not ex["segment_rounds"]:
            return None
        return float(ex["dispatches_per_window"]) / float(
            ex["segment_rounds"])

    @property
    def permute_sets_per_phase(self) -> int | None:
        """MEASURED halo gather sets per phase (16 rolled permutes each)
        recorded by round-7+ fingerprints; None for legacy artifacts —
        the projection then falls back to its 16·(r+4) formula."""
        fp = self.fingerprint or {}
        v = fp.get("permute_sets_per_phase")
        return None if v is None else int(v)

    def to_line(self) -> dict:
        """The JSON-line object (what bench.py prints) — stamped with
        the record's OWN schema so v2 lines round-trip losslessly; a
        timeline block forces at least v3 (the version that defines
        it)."""
        out = {
            "schema": (max(int(self.schema), SCHEMA_VERSION)
                       if (self.timeline_raw is not None
                           or self.invariants_raw is not None)
                       else int(self.schema)),
            "metric": self.metric,
            "value": self.value,
            "unit": self.unit,
            "vs_baseline": self.vs_baseline,
        }
        out.update(self.extras)
        if self.fingerprint is not None:
            out["fingerprint"] = self.fingerprint
        if self.timeline_raw is not None:
            out["timeline"] = self.timeline_raw
        if self.invariants_raw is not None:
            out["invariants"] = self.invariants_raw
        return out


def dump_record(rec: BenchRecord) -> str:
    """Serialize one record as the single bench JSON line."""
    return json.dumps(rec.to_line())


def record_from_line(obj: dict, round_index: int | None = None) -> BenchRecord:
    """Normalize a parsed v1/v2/v3 metric line into a BenchRecord."""
    if "metric" not in obj:
        raise ValueError(f"not a bench metric line: keys={sorted(obj)}")
    known = {"schema", "metric", "value", "unit", "vs_baseline",
             "fingerprint", "timeline", "invariants"}
    return BenchRecord(
        metric=str(obj["metric"]),
        value=float(obj["value"]),
        unit=str(obj.get("unit", "")),
        vs_baseline=float(obj.get("vs_baseline", float(obj["value"]) / NORTH_STAR_RATE)),
        schema=int(obj.get("schema", 1)),
        fingerprint=obj.get("fingerprint"),
        round_index=round_index,
        extras={k: v for k, v in obj.items() if k not in known},
        timeline_raw=obj.get("timeline"),
        invariants_raw=obj.get("invariants"),
    )


def _last_json_line(text: str) -> dict | None:
    """A wrapper's tail holds stderr warnings around the one JSON line; take
    the last parseable object line of a tail blob."""
    out = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                out = json.loads(line)
            except json.JSONDecodeError:
                continue
    return out


def load_bench_artifact(path: str) -> BenchRecord:
    """Read one bench artifact file (raw line, JSON-lines, or run
    wrapper) into a BenchRecord."""
    with open(path) as f:
        text = f.read()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        # JSON-lines: last metric line wins (bench prints exactly one)
        obj = _last_json_line(text)
        if obj is None:
            raise ValueError(f"{path}: no parseable JSON line")
    if isinstance(obj, dict) and "parsed" in obj:  # a run wrapper
        return record_from_line(obj["parsed"], round_index=obj.get("n"))
    if isinstance(obj, dict) and "metric" not in obj and "tail" in obj:
        # a wrapper whose line was not parsed; recover it from the tail
        inner = _last_json_line(obj["tail"])
        if inner is None:
            raise ValueError(f"{path}: wrapper has no parseable tail line")
        return record_from_line(inner, round_index=obj.get("n"))
    return record_from_line(obj)


def load_bench_lines(path: str) -> list[BenchRecord]:
    """Every metric line of a JSON-lines artifact, in file order
    (timeline artifacts carry one line per experiment cell; single-line
    and wrapper files come back as a one-element list)."""
    with open(path) as f:
        text = f.read()
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and "parsed" in obj:
            obj, ridx = obj["parsed"], obj.get("n")
        else:
            ridx = None
        if isinstance(obj, dict) and "metric" in obj:
            out.append(record_from_line(obj, round_index=ridx))
    if not out:  # single non-line JSON (wrapper or object): delegate
        return [load_bench_artifact(path)]
    return out


def load_bench_variants(path: str) -> dict[str, BenchRecord]:
    """Every engine-variant record a run-wrapper artifact carries,
    keyed by wrapper field: ``"parsed"`` (the headline — what
    ``load_bench_artifact`` returns) plus any ``parsed_*`` sibling
    (round 15: ``parsed_csr``, the CSR edge-layout cell measured at the
    same shape so the dense-vs-csr tradeoff stays a READABLE committed
    number, not write-only data). Non-wrapper artifacts come back as
    ``{"parsed": <record>}``."""
    with open(path) as f:
        text = f.read()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        # JSON-lines artifact: no variant fields by construction
        return {"parsed": load_bench_artifact(path)}
    if not (isinstance(obj, dict) and "parsed" in obj):
        # single bare record — already parsed, don't re-read the file
        return {"parsed": record_from_line(obj)}
    out = {}
    for key, val in obj.items():
        if key == "parsed" or key.startswith("parsed_"):
            if isinstance(val, dict) and "metric" in val:
                out[key] = record_from_line(val, round_index=obj.get("n"))
    return out


def load_bench_trajectory(repo_root: str | None = None) -> list[BenchRecord]:
    """All committed ``BENCH_r*.json`` records, in round order."""
    root = repo_root or _repo_root()
    recs = [
        load_bench_artifact(p)
        for p in sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))
    ]
    recs.sort(key=lambda r: (r.round_index is None, r.round_index))
    return recs


def load_multichip_artifact(path: str) -> dict:
    """Read a ``MULTICHIP_r0N.json`` run wrapper: ``{"n_devices",
    "rc", "ok", "skipped", "tail"}``. The ``ok`` flag is what the
    projection engine gates on — it certifies the sharded step (incl.
    the phase engine) ran on the virtual mesh, which is what validates
    the collective-count model the ICI term is built from."""
    with open(path) as f:
        obj = json.load(f)
    for key in ("ok", "rc"):
        if key not in obj:
            raise ValueError(f"{path}: not a multichip artifact (no {key!r})")
    return obj


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
