"""Rates to compare in turns, one fresh process a turn.

    python go_libp2p_pubsub_tpu_torch/perf/turns.py cells [--tree DIR]
    python go_libp2p_pubsub_tpu_torch/perf/turns.py eager-bench [--tree DIR]
    python go_libp2p_pubsub_tpu_torch/perf/turns.py options [--tree DIR]

``cells`` times the host-bound cells of ``chip_smoke.py`` as it does
(phases 4, 6, 10 and 13: the per-round bench and the CSR bench, 16 + 64
rounds; the phase bench, ``form_mesh`` + 2 + 8 phases; FloodSub on the
lattice, 80 rounds) and the peak device memory of each (``<cell>_peak``,
reset before the cell's build), with the port of the checkout at
``--tree`` (this one by default), so a parent checkout (``git archive``) and this one can
be run in alternation on one card. ``eager-bench`` runs the bench line's
measurement (``perf/sweep.measure_rate``: the same build, schedule,
1600-round windows, a warm window, the best of 3, each ending in the tick
and score readback) with the eager loops in place of ``driver.make_scan``,
and the per-round step over 320-round windows (best of 2). ``options``
times the phase bench under the delivery core's two options
(``queue_cap=2``, ``validation_delay_rounds=2``) as ``chip_smoke.py``
phase 25 does: eager, then through ``driver.make_scan`` (a segment that
captures, then a timed one), with the peak of each. Each prints
one JSON line. Run it as a file, so that ``--tree`` decides which port is
imported. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

N, M = 100_000, 64


def cells(sweep, driver, torch) -> dict:
    dev = torch.device("cuda")
    out = {}
    f, t = 16, 64
    po, pt, pv = sweep.publish_schedule(f + t + 1, N, 1, None)
    for name, kw in (("bench", {}), ("csr_bench", dict(edge_layout="csr", fused=True))):
        torch.cuda.reset_peak_memory_stats()
        st, step, _t, _h = sweep.build_bench(N, M, device=dev, **kw)
        st = sweep.run_rounds(st, step, po[:f], pt[:f], pv[:f])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sweep.run_rounds(st, step, po[f:f + t], pt[f:f + t], pv[f:f + t])
        torch.cuda.synchronize()
        out[name] = t / (time.perf_counter() - t0)
        out[f"{name}_peak"] = torch.cuda.max_memory_allocated()
        del st, step
    r = 8
    po, pt, pv = sweep.publish_schedule(11 * r, N, 1, None)
    torch.cuda.reset_peak_memory_stats()
    st, step, _t, _h = sweep.build_bench(N, M, rounds_per_phase=r, device=dev)

    def run(st, sl):
        return sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=r,
                                heartbeat_every=r)

    st = run(driver.form_mesh(step, st, rounds_per_phase=r), slice(0, 2 * r))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st, slice(2 * r, 10 * r))
    torch.cuda.synchronize()
    out["phase_bench"] = 8 * r / (time.perf_counter() - t0)
    out["phase_bench_peak"] = torch.cuda.max_memory_allocated()
    del st, step
    po, pt, pv = sweep.publish_schedule(80, N, 1, None)
    st, step = sweep.build_floodsub(N, M, graph="lattice", layout="dense", device=dev)
    st = sweep.run_rounds(st, step, po[:8], pt[:8], pv[:8])
    st = type(st).init(N, M, k=step.net.max_degree, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sweep.run_rounds(st, step, po, pt, pv)
    torch.cuda.synchronize()
    out["floodsub_lattice"] = 80 / (time.perf_counter() - t0)
    return out


def eager_bench(sweep, torch) -> dict:
    def rates(r, seg, reps):
        st, step, n_topics, honest = sweep.build_bench(N, M, heartbeat_every=r,
                                                       rounds_per_phase=r)
        po, pt, pv = sweep.publish_schedule(seg, N, n_topics, honest)

        def run(st):
            if r > 1:
                st = sweep.run_phases(st, step, po, pt, pv, rounds_per_phase=r,
                                      heartbeat_every=r)
            else:
                st = sweep.run_rounds(st, step, po, pt, pv)
            _ = (int(st.core.tick), float(st.scores.sum()))
            return st

        st = run(st)
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            st = run(st)
            out.append(seg / (time.perf_counter() - t0))
        return out

    return {"eager_phase_r8_seg1600": rates(8, 1600, 3),
            "eager_per_round_seg320": rates(1, 320, 2)}


def options(sweep, driver, torch) -> dict:
    dev = torch.device("cuda")
    r, f, m = 8, 16, 64
    po, pt, pv = sweep.publish_schedule(f + 2 * m, N, 1, None)
    out = {}
    for mode in ("eager", "window"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st, step, _t, _h = sweep.build_bench(N, M, rounds_per_phase=r, device=dev,
                                             queue_cap=2, validation_delay_rounds=2)
        st = driver.form_mesh(step, st, rounds_per_phase=r)
        if mode == "eager":
            def run(st, sl):
                return sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=r,
                                        heartbeat_every=r)
        else:
            scan = driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r, unroll=2)

            def run(st, sl):
                return scan(st, po[sl], pt[sl], pv[sl])
        st = run(run(st, slice(0, f)), slice(f, f + m))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = run(st, slice(f + m, f + 2 * m))
        torch.cuda.synchronize()
        out[f"options_phase_{mode}"] = m / (time.perf_counter() - t0)
        out[f"options_phase_{mode}_peak"] = torch.cuda.max_memory_allocated()
        del st, step
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("cells", "eager-bench", "options"))
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="the checkout whose port is timed")
    args = ap.parse_args(argv)
    tree = str(pathlib.Path(args.tree).resolve())
    # run as a file, this directory heads sys.path, and its profile.py
    # would shadow the standard library's: the checkout takes its place
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [tree] + [p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    import torch

    from go_libp2p_pubsub_tpu_torch import driver
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    if not torch.cuda.is_available():
        raise SystemExit("turns: needs a CUDA device")
    if args.what == "cells":
        out = cells(sweep, driver, torch)
    elif args.what == "options":
        out = options(sweep, driver, torch)
    else:
        out = eager_bench(sweep, torch)
    print(json.dumps({"tree": tree, **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
