"""Where a round spends its time on the card.

    python -m go_libp2p_pubsub_tpu_torch.perf.profile [--n 100000]
        [--engine gossipsub|floodsub] [--config default|eth2|sybil]
        [--layout dense|csr] [--px]
        [--rounds-per-phase 1] [--warm 16] [--rounds 16] [--window]
        [--check-every K] [--out PATH]

Builds a bench GossipSub config (``--config``, the default one unless
given; its publish schedule with the config's topics and honest origins;
``--px`` its PX cell, ``sweep.build_bench(px=True)``) —
banded dense, or with
``--layout csr`` the bench's CSR variant (CSR-resident, ``fused=True``);
the per-round step, or with ``--rounds-per-phase`` r > 1 the phase engine
(its mesh formed first, then whole phases: ``--warm`` and ``--rounds``
multiples of r) — or, with ``--engine floodsub``, FloodSub over ``ring_lattice(n, d=8)``
dense or over the power-law graph CSR-resident with ``--layout csr``, on
the card, runs
``--warm`` rounds,
times ``--rounds`` untraced rounds, then traces ``--rounds`` more with
``torch.profiler`` and prints: ms per round untraced and traced, device
kernel time per round, the device's busy time per round (union of kernel
intervals) and its share of the untraced round (the profiler stretches
the host's dispatch, so the share of the traced window is printed beside
it only for reference), kernel launches per round (an eager run's
counted at the host's launch and copy calls, a window's from the device's
records; in the JSON also the device's records and the kernels per
launching host op), the kernels by device
time (each with the host op and input shapes whose launches of it took
the most device time), and
the host-side ops by launch count. ``--out`` also writes the numbers as
JSON. With ``--window`` the untraced and the traced rounds run as
``driver.make_scan`` windows (captured CUDA graphs, the bench's way; the
window is captured on a window of ``--rounds`` rounds after the warm-up):
the report adds the graph replays a window and the wrapper launches a
captured block, and reads the kernels off a traced replay (the host ops
of a replay are graph launches, so no kernel is attributed to one). With
``--check-every K`` as well the windows are checked ones
(``driver.make_window(check=...)``, the bench's invariant oracle every K
dispatches under a quiet due row, ``sweep.bench_invariants``), and the
report adds the checker's own cost (``check_cost``): its launches and
device time a check, traced eagerly, and its device time a check replayed
alone from a CUDA graph. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..driver import form_mesh, heartbeat_schedule, make_scan, make_window
from ..oracle.invariants import due_vector
from . import sweep


def _events_on(prof, kind: str):
    from torch.autograd import DeviceType

    dt = DeviceType.CUDA if kind == "cuda" else DeviceType.CPU
    return [e for e in prof.events() if e.device_type == dt]


#: the host-side CUDA calls that each put one operation (a kernel, a copy
#: or a fill) on the device
_DEVICE_OP_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cuMemcpy",
                    "cudaMemset", "cuMemset")


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def check_cost(check, state, prev_events, due_row, reps: int = 5) -> dict:
    """The invariant checker's own cost on the card, for one check of
    ``state``: ``reps`` eager checks traced with ``torch.profiler`` (the
    host's launch calls a check, the device's kernel time and busy time a
    check), then the check captured alone in a CUDA graph and replayed
    ``reps * 4`` times between CUDA events (its device time a check as a
    window replays it)."""
    check(state, prev_events, due_row)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            check(state, prev_events, due_row)
        torch.cuda.synchronize()
    kev = _events_on(prof, "cuda")
    calls = sum(1 for e in _events_on(prof, "cpu") if e.name.startswith(_DEVICE_OP_CALLS))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        check(state, prev_events, due_row)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        check(state, prev_events, due_row)
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps * 4):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return {
        "launches_per_check": calls / reps,
        "device_ops_per_check": len(kev) / reps,
        "device_kernel_ms_per_check": sum(e.time_range.end - e.time_range.start
                                          for e in kev) / 1e3 / reps,
        "device_busy_ms_per_check": _union_us([(e.time_range.start, e.time_range.end)
                                               for e in kev]) / 1e3 / reps,
        "graph_ms_per_check": start.elapsed_time(end) / (reps * 4),
    }


def profile_rounds(n: int, warm: int, rounds: int, engine: str = "gossipsub",
                   layout: str = "dense", rounds_per_phase: int = 1,
                   window: bool = False, config: str = "default", px: bool = False,
                   check_every: int = 0) -> dict:
    r = int(rounds_per_phase)
    if check_every and not (window and engine == "gossipsub"):
        raise ValueError("--check-every needs --window and the GossipSub engine")
    if engine == "gossipsub":
        st, step, n_topics, honest = sweep.build_bench(
            n, 64, config=config, edge_layout=layout, fused=layout == "csr",
            rounds_per_phase=r, device="cuda", px=px)
    else:
        if r > 1:
            raise ValueError("the phase engine is GossipSub's")
        graph = "lattice" if layout == "dense" else "powerlaw"
        st, step = sweep.build_floodsub(n, 64, graph=graph, layout=layout, device="cuda")
        n_topics, honest = 1, None
    if r > 1:
        if warm % r or rounds % r:
            raise ValueError(f"--warm and --rounds must be whole phases of {r} rounds")
        st = form_mesh(step, st, rounds_per_phase=r)

        def run(st, po, pt, pv):
            return sweep.run_phases(st, step, po, pt, pv, rounds_per_phase=r,
                                    heartbeat_every=r)
    else:
        def run(st, po, pt, pv):
            return sweep.run_rounds(st, step, po, pt, pv)
    po, pt, pv = sweep.publish_schedule(warm + (3 if window else 2) * rounds, n, n_topics,
                                        honest)
    st = run(st, po[:warm], pt[:warm], pv[:warm])
    win = spec = None
    if window:
        # captured on one window of `rounds` rounds before the timed ones
        if check_every:
            # a checked window: a block of check_every dispatches
            spec = sweep.bench_invariants(
                n, check_every=check_every, delivery_window=24,
                due_fn=lambda tick: due_vector(quiet=(0, 1 << 30)), config=config,
                edge_layout=layout, fused=layout == "csr", rounds_per_phase=r,
                device="cuda", px=px)
            win = make_window(step, heartbeat=heartbeat_schedule(r, r) if r > 1 else None,
                              check=spec.check, check_every=check_every)

            def run(st, po, pt, pv):
                d = po.shape[0] // r
                xs = tuple(torch.as_tensor(a, device="cuda").reshape(
                    (d, r, -1) if r > 1 else (d, -1)) for a in (po, pt, pv))
                return win(st, xs, spec.precompute(d))[0]
        else:
            # the bench's windows: a block of 2 phases (r > 1) or 4 rounds
            if engine == "gossipsub" and r > 1:
                run = make_scan(step, heartbeat_every=r, rounds_per_phase=r, unroll=2)
            else:
                run = make_scan(step, static_heartbeat=False, unroll=4)
            win = run.window
        st = run(st, *(a[warm:warm + rounds] for a in (po, pt, pv)))
        warm += rounds
    torch.cuda.synchronize()
    replays0 = 0 if win is None else win.replays
    # an untraced window first: the profiler stretches the host's dispatch
    # time, so the busy share is also read against this window's rounds
    t0 = time.perf_counter()
    plain = slice(warm, warm + rounds)
    st = run(st, po[plain], pt[plain], pv[plain])
    torch.cuda.synchronize()
    untraced_us = 1e6 * (time.perf_counter() - t0)
    replays = None if win is None else win.replays - replays0
    traced = slice(warm + rounds, warm + 2 * rounds)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        st = run(st, po[traced], pt[traced], pv[traced])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kev = _events_on(prof, "cuda")
    cpu_events = _events_on(prof, "cpu")
    # an eager run's launches are counted at the host's launch calls, which
    # the profiler records exactly; the device's activity records can come
    # back short (55 of 3,730 missing in one of four traced phases on an
    # H100), while a graph replay's kernels exist only as device records
    calls = sum(1 for e in cpu_events if e.name.startswith(_DEVICE_OP_CALLS))
    launches = len(kev) if win is not None else calls
    by_name: dict = {}
    for e in kev:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in kev])
    kernel_us = sum(v[1] for v in by_name.values())
    host_ops: dict = {}
    launched_by: dict = {}    # kernel name -> {host op and shapes: device us}
    op_launches: dict = {}    # host op -> kernels it launched
    for e in cpu_events:
        if e.name.startswith("aten::"):
            host_ops[e.name] = host_ops.get(e.name, 0) + 1
        if e.kernels:
            op_launches[e.name] = op_launches.get(e.name, 0) + len(e.kernels)
        for kern in e.kernels:
            by = launched_by.setdefault(kern.name, {})
            op = f"{e.name} {e.input_shapes}"
            by[op] = by.get(op, 0.0) + kern.duration
    check = None
    if spec is not None:
        check = dict(check_cost(spec.check, st, st.core.events, spec.precompute(check_every)[0]),
                     check_every=check_every, checks_per_window=rounds // r // check_every)
    return {
        "engine": engine, "config": config, "layout": layout, "n_peers": n, "rounds": rounds,
        "rounds_per_phase": r, "window": bool(window),
        "graph_replays_per_window": replays,
        "block_launches": None if win is None else dict(win.block_launches),
        "capture_seconds": None if win is None else win.capture_seconds,
        "check": check,
        "host_ms_per_round": wall_us / 1e3 / rounds,
        "untraced_ms_per_round": untraced_us / 1e3 / rounds,
        "device_kernel_ms_per_round": kernel_us / 1e3 / rounds,
        "device_busy_ms_per_round": busy / 1e3 / rounds,
        "device_busy_share": busy / wall_us,
        "device_busy_share_untraced": busy / untraced_us,
        "kernel_launches_per_round": launches / rounds,
        "device_ops_per_round": len(kev) / rounds,
        "kernels": sorted(
            ({"name": k, "launches_per_round": v[0] / rounds,
              "us_per_round": v[1] / rounds,
              "launched_by": max(launched_by.get(k, {"": 0}).items(),
                                 key=lambda kv: kv[1])[0]}
             for k, v in by_name.items()),
            key=lambda r: -r["us_per_round"]),
        "launches_by_op_per_round": {k: v / rounds for k, v in sorted(op_launches.items())},
        "host_ops_per_round": sorted(
            ({"op": k, "calls_per_round": c / rounds} for k, c in host_ops.items()),
            key=lambda r: -r["calls_per_round"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--engine", choices=("gossipsub", "floodsub"), default="gossipsub")
    ap.add_argument("--config", choices=sweep.CONFIGS, default="default")
    ap.add_argument("--layout", choices=("dense", "csr"), default="dense")
    ap.add_argument("--px", action="store_true", help="the config's PX cell")
    ap.add_argument("--rounds-per-phase", type=int, default=1)
    ap.add_argument("--warm", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--window", action="store_true",
                    help="run the timed rounds as driver.make_scan windows (CUDA graphs)")
    ap.add_argument("--check-every", type=int, default=0,
                    help="with --window: check the invariant oracle every K dispatches")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rep = profile_rounds(args.n, args.warm, args.rounds, args.engine, args.layout,
                         args.rounds_per_phase, window=args.window, config=args.config,
                         px=args.px, check_every=args.check_every)
    rep["card"] = card
    print(card)
    print(f"{rep['engine']} {rep['layout']} r={rep['rounds_per_phase']} N={rep['n_peers']} over {rep['rounds']} rounds: untraced "
          f"{rep['untraced_ms_per_round']:.3f} ms/round, traced "
          f"{rep['host_ms_per_round']:.3f} ms/round, device kernels "
          f"{rep['device_kernel_ms_per_round']:.3f} ms/round, device busy "
          f"{rep['device_busy_ms_per_round']:.3f} ms/round, busy share "
          f"{rep['device_busy_share_untraced']:.4f} of the untraced round "
          f"({rep['device_busy_share']:.4f} of the traced one), "
          f"{rep['kernel_launches_per_round']:.1f} kernel launches/round")
    if rep["window"]:
        print(f"windows: {rep['graph_replays_per_window']} graph replays a window of "
              f"{rep['rounds']} rounds, wrapper launches a captured block "
              f"{rep['block_launches']}, capture {rep['capture_seconds']:.3f} s")
    if rep["check"]:
        c = rep["check"]
        print(f"checker every {c['check_every']} dispatches ({c['checks_per_window']} a "
              f"window): {c['launches_per_check']:.1f} launches a check, device kernels "
              f"{c['device_kernel_ms_per_check']:.4f} ms a check (busy "
              f"{c['device_busy_ms_per_check']:.4f} ms), {c['graph_ms_per_check']:.4f} ms a "
              "check replayed from a graph")
    for r in rep["kernels"][: args.top]:
        print(f"  {r['us_per_round']:10.1f} us/round {r['launches_per_round']:7.1f}x  "
              f"{r['name'][:110]}")
        print(f"{'':34}from {r['launched_by'][:140]}")
    print("host ops by calls/round:")
    for r in rep["host_ops_per_round"][: args.top]:
        print(f"  {r['calls_per_round']:8.1f}  {r['op']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
