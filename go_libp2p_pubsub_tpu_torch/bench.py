"""The port's bench: GossipSub v1.1 delivery rounds per wall second at
scale on one NVIDIA GPU.

    python -m go_libp2p_pubsub_tpu_torch.bench

Prints ONE JSON line of the JAX package's bench (``bench.py`` at the
repository root), schema 3, in the same unit: simulated delivery rounds
(hop-quanta) per wall second, of the phase engine at r=8 by default
(control every r rounds, a heartbeat every phase), driven through
``driver.make_scan``, whose windows run as captured CUDA graphs. With
``BENCH_CONTINUITY=1`` (the default) the line also carries
``continuity_r1_ticks_per_sec``, the per-round step (control every round)
measured in its own window in the same process.

It reads the root bench's variables: ``BENCH_CONFIG`` (``default``,
``eth2`` or ``sybil``), ``BENCH_N`` (100000; 50000 for ``sybil``), ``BENCH_M`` (64),
``BENCH_PHASE_R`` (8), ``BENCH_HB`` (r, or 1 at r=1), ``BENCH_ROUNDS`` (1600
rounds a timed window), ``BENCH_UNROLL`` (rounds a captured block),
``BENCH_CONTINUITY``, ``BENCH_EDGE_LAYOUT`` (``dense`` or ``csr``) and
``BENCH_WIRE_COALESCED`` (``0`` runs the per-plane wire form, which the
fingerprint's ``engine.wire_coalesced`` records).
``BENCH_PRNG`` may be empty or ``threefry2x32``, the port's one generator;
``BENCH_PLATFORM`` does not apply (the port runs on the card).
"""

from __future__ import annotations

import json
import math
import os


def bench_line(env=None, device=None) -> dict:
    """Measure and return the bench line the CLI prints (``env`` defaults
    to ``os.environ``)."""
    from .perf.artifacts import NORTH_STAR_RATE, SCHEMA_VERSION
    from .perf.sweep import measure_rate, metric_name, workload_fingerprint

    env = os.environ if env is None else env
    prng = env.get("BENCH_PRNG", "")
    if prng not in ("", "threefry2x32"):
        raise NotImplementedError(
            f"BENCH_PRNG={prng!r}: the port carries threefry2x32 alone (the JAX bench's "
            "default unsafe_rbg cannot be reproduced; ROADMAP 'Held against the reference')")
    config = env.get("BENCH_CONFIG", "default")
    n_peers = int(env.get("BENCH_N", 50_000 if config == "sybil" else 100_000))
    msg_slots = int(env.get("BENCH_M", 64))
    r = int(env.get("BENCH_PHASE_R", 8))
    he = int(env.get("BENCH_HB", r if r > 1 else 1))
    seg = int(env.get("BENCH_ROUNDS", 1600))
    seg -= seg % math.lcm(he, r)
    unroll = int(env["BENCH_UNROLL"]) if env.get("BENCH_UNROLL") else None
    layout = env.get("BENCH_EDGE_LAYOUT", "dense")
    if layout not in ("dense", "csr"):
        raise ValueError(f"BENCH_EDGE_LAYOUT must be 'dense' or 'csr', got {layout!r}")
    coalesced = env.get("BENCH_WIRE_COALESCED", "1") != "0"

    res = measure_rate(config, n_peers, msg_slots, he, r, seg, reps=3, unroll=unroll,
                       edge_layout=layout, device=device, wire_coalesced=coalesced)
    if res is None:
        return {"metric": "error", "value": 0, "unit": "", "vs_baseline": 0}
    value, n_peers, unroll_used, _scan = res
    out = {
        "schema": SCHEMA_VERSION,
        "metric": metric_name(config, n_peers, r),
        "value": round(value, 2),
        "unit": "ticks/s" if r == 1 else "delivery-rounds/s",
        "vs_baseline": round(value / NORTH_STAR_RATE, 4),
    }
    if r > 1:
        out["heartbeats_per_sec"] = round(value / he, 2)
        out["unit_note"] = (
            "value counts simulated delivery rounds (hop-quanta)/s; control runs once per "
            "%d rounds, heartbeat once per %d — see BASELINE.md equivalence rule" % (r, he))
        if env.get("BENCH_CONTINUITY", "1") == "1":
            cont = measure_rate(config, n_peers, msg_slots, 1, 1, seg, reps=2,
                                edge_layout=layout, device=device, wire_coalesced=coalesced)
            if cont is not None:
                out["continuity_r1_ticks_per_sec"] = round(cont[0], 2)
                out["continuity_r1_n"] = cont[1]
    out["fingerprint"] = workload_fingerprint(config, n_peers, msg_slots, he, r,
                                              seg_rounds=seg, unroll=unroll_used,
                                              edge_layout=layout, device=device,
                                              wire_coalesced=coalesced)
    return out


def main():
    print(json.dumps(bench_line()))


if __name__ == "__main__":
    main()
