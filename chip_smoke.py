#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (go_libp2p_pubsub_tpu_torch) on one NVIDIA
GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line is printed:

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — nvcc builds every kernel source of the port from csrc/ for
   sm_90a, one nvcc per source, all started together;
3. GossipSub kernels — at the bench's shapes (N=100k, K=16, W=2, C=4), on
   inputs captured from a real round and on random words, edge_exchange and
   fused_delivery must equal their plain PyTorch versions exactly;
   CUDA-event medians of the kernel, the plain version and (edge_exchange)
   the one-call library gather, beside the bytes bound;
4. GossipSub at full width — the bench's default config at N=100k,
   formation rounds then 64 rounds of the bench's publish schedule; both
   launch counters must equal the round count, mesh degrees lie in
   [Dlo, Dhi], fwd is a subset of have; rounds/s and peak device memory;
5. GossipSub card against CPU — the same step from the same seed on the
   card and on the CPU (plain versions) for 32 rounds at N=8192, every leaf
   equal after every round;
6. FloodSub, banded dense — ring_lattice(100k, d=8): delivery_banded
   against its plain version (captured and random inputs, medians, bound),
   then 80 rounds with 4 publishes a round: host set-up seconds, rounds/s,
   peak memory, state bytes, launches equal to rounds, fwd a subset of
   have, every message older than 4 rounds past its origin;
7. FloodSub, CSR-resident — powerlaw(1M, 2.2, d_min=2, max_degree=64,
   seed=0): csr_delivery the same way, with the link-deny mask on and off,
   then the same 80-round run;
8. FloodSub card against CPU — both layouts at N=8192 for 32 rounds, every
   leaf equal after every round.

It prints the ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. It imports neither JAX nor the JAX
package, and exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM outside the tensor cores
N_FULL, M_SLOTS = 100_000, 64
FORMATION_ROUNDS, MEASURED_ROUNDS = 16, 64
N_PARITY, PARITY_ROUNDS = 8192, 32
N_CSR, FLOOD_ROUNDS = 1_000_000, 80
KERNEL_SOURCES = ("fused_round", "delivery")
KERNEL_SOURCE = "go_libp2p_pubsub_tpu_torch/csrc/fused_round.cu"
DELIVERY_SOURCE = "go_libp2p_pubsub_tpu_torch/csrc/delivery.cu"
REPLACES = {
    "edge_exchange": "go_libp2p_pubsub_tpu/ops/fused_round.py:197",
    "fused_delivery": "go_libp2p_pubsub_tpu/ops/fused_round.py:424",
    "delivery_banded": "go_libp2p_pubsub_tpu/ops/pallas_delivery.py:162",
    "csr_delivery": "go_libp2p_pubsub_tpu/ops/pallas_csr.py:229,244,260",
}


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median CUDA-event time of one call, in milliseconds."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_abs_err(ref, got) -> float:
    """Largest |ref - got| over matching tensors (words compared as
    integers, floats as floats)."""
    import torch

    worst = 0.0
    for a, b in zip(ref, got):
        if a is None:
            assert b is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.is_floating_point:
            d = (a.double() - b.double()).abs().max()
        else:
            d = (a.long() - b.long()).abs().max().double()
        worst = max(worst, float(d))
        if not torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b):
            raise AssertionError("kernel output differs bitwise from its plain version")
    return worst


def capture_round(step, st, module, names=("edge_exchange", "fused_delivery")):
    """Run one round, recording each named kernel wrapper's call."""
    captured = {}
    originals = {name: getattr(module, name) for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            captured[name] = (args, kwargs)
            return originals[name](*args, **kwargs)
        return call

    try:
        for name in originals:
            setattr(module, name, recorder(name))
        st = step(st)
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)
    return st, captured


def randomize_words(args, gen):
    """The same call with every 2-D int32 word plane and every f32 plane
    refilled at random (callers redraw planes that need a structure)."""
    import torch

    out = []
    for a in args:
        if isinstance(a, torch.Tensor) and a.dtype == torch.int32 and a.dim() == 2:
            r = torch.randint(-2**31, 2**31, a.shape, generator=gen, dtype=torch.int64,
                              device="cpu").to(torch.int32).to(a.device)
            out.append(r)
        elif isinstance(a, torch.Tensor) and a.dtype == torch.float32:
            out.append((torch.randn(a.shape, generator=gen) * 20).to(a.device))
        else:
            out.append(a)
    return out


def check_kernels(fr, captured, gen):
    """Phase 3: each kernel against its plain version on the card, and its
    time. Returns the per-kernel records (launches filled in later)."""
    import torch

    records = []
    # --- edge_exchange -----------------------------------------------------
    args, kw = captured["edge_exchange"]
    wire, scores, live = args
    n, k, c = wire.shape[0], len(kw["offsets"]), kw["c"]
    err = 0.0
    for trial in ("captured", "random"):
        a = list(args) if trial == "captured" else randomize_words(args, gen)
        if trial == "random":
            a[2] = (torch.rand(live.shape, generator=gen) < 0.9).to(torch.int32).to(live.device)
        ref = fr.edge_exchange_plain(*a, **kw)
        got = fr.edge_exchange(*a, **kw)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(ref, got))
    out_w, out_s = fr.edge_exchange(*args, **kw)
    io = nbytes(wire, scores, live, out_w, out_s)
    ops = n * k * c + n * k            # one select per output element
    perm = (((torch.arange(n, device=wire.device)[:, None]
              + torch.tensor(kw["offsets"], device=wire.device)[None, :]) % n) * k
            + torch.tensor(kw["revs"], device=wire.device)[None, :]).reshape(-1)
    flat = wire.view(n * k, c)
    rec = {
        "name": "edge_exchange", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["edge_exchange"], "launches": 0,
        "max_abs_err": err,
        "ms": time_ms(lambda: fr.edge_exchange(*args, **kw)),
        "plain_ms": time_ms(lambda: fr.edge_exchange_plain(*args, **kw)),
        **bound(io, ops),
        "library_ms": time_ms(lambda: flat[perm]),
    }
    records.append(rec)
    say(f"kernel edge_exchange: N={n} K={k} C={c} exact (max_abs_err {err}) "
        f"kernel_ms={rec['ms']:.6f} plain_ms={rec['plain_ms']:.6f} "
        f"bound_ms={rec['bound_ms']:.6f} library_ms={rec['library_ms']:.6f} "
        f"({io} bytes moved)")

    # --- fused_delivery ----------------------------------------------------
    args, kw = captured["fused_delivery"]
    n, k, w = args[2].shape[0], len(kw["offsets"]), kw["w"]
    err = 0.0
    for trial, cohorts in (("captured", kw["want_cohorts"]), ("random", True),
                           ("random", False)):
        a = list(args) if trial == "captured" else randomize_words(args, gen)
        if trial == "random":
            # flag words: random patterns of the five flag bits
            a[8] = torch.randint(0, 32, args[8].shape, generator=gen,
                                 dtype=torch.int32).to(args[8].device)
        kk = dict(kw, want_cohorts=cohorts)
        ref = fr.fused_delivery_plain(*a, **kk)
        got = fr.fused_delivery(*a, **kk)
        torch.cuda.synchronize()
        names = sorted(ref)
        assert names == sorted(got)
        err = max(err, max_abs_err([ref[x] for x in names], [got[x] for x in names]))
    res = fr.fused_delivery(*args, **kw)
    io = nbytes(*[t for t in args if hasattr(t, "numel")], *res.values())
    ops = 40 * n * k * w               # word ops per (peer, edge, word)
    rec = {
        "name": "fused_delivery", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["fused_delivery"], "launches": 0,
        "max_abs_err": err,
        "ms": time_ms(lambda: fr.fused_delivery(*args, **kw)),
        "plain_ms": time_ms(lambda: fr.fused_delivery_plain(*args, **kw)),
        **bound(io, ops),
        "library_ms": None,
    }
    records.append(rec)
    say(f"kernel fused_delivery: N={n} K={k} W={w} want_cohorts={kw['want_cohorts']} "
        f"exact (max_abs_err {err}) kernel_ms={rec['ms']:.6f} "
        f"plain_ms={rec['plain_ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
        f"library_ms=null ({io} bytes moved)")
    say("kernels: " + ", ".join(r["name"] for r in records))
    return records


def bound(io: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the integer operations over the non-tensor-core rate,
    and which of the two it is."""
    t_io, t_ops = io / HBM_BYTES_PER_S, ops / NON_TENSOR_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_io, t_ops),
            "bound_by": "bytes" if t_io >= t_ops else "operations"}


def check_flood_kernel(module, name, args, kw, gen):
    """A FloodSub delivery kernel against its plain version on the card, on
    the captured call and on random words (the CSR kernel with its
    link-deny mask off and on). Returns (max_abs_err, io bytes, ops)."""
    import torch

    plain = getattr(module, name + "_plain")
    kernel = getattr(module, name)
    trials = [("captured", None), ("random", None)]
    if name == "csr_delivery":
        trials += [("captured", 0.7), ("random", 0.7)]
    err = 0.0
    for trial, deny in trials:
        a = list(args) if trial == "captured" else randomize_words(args, gen)
        k2 = dict(kw)
        if deny is not None:
            e = args[1].shape[0]
            k2["link_ok_e"] = (torch.rand(e, generator=gen) < deny).to(args[0].device)
        ref, got = plain(*a, **k2), kernel(*a, **k2)
        torch.cuda.synchronize()
        names = sorted(ref)
        assert names == sorted(got)
        err = max(err, max_abs_err([ref[x] for x in names], [got[x] for x in names]))
    res = kernel(*args, **kw)
    if name == "csr_delivery":
        # what the kernel reads: the peer and edge planes, col, eperm, row_ptr
        reads = [*args[:9], args[10], args[14]]
        e, w = args[1].shape
        ops = 12 * e * w
    else:
        reads = list(args)
        n, w = args[0].shape
        ops = 12 * n * len(kw["offsets"]) * w
    io = nbytes(*reads, *res.values())
    return err, io, ops


def flood_run(sweep, convert, module, name, spec, card, gen, dev):
    """Phases 6 and 7: one FloodSub configuration at full size. Its kernel
    against the plain version on a real round's inputs, then the main path:
    80 rounds from a fresh state with the launch counter set to 0 just
    before and read just after. Returns the kernel's record."""
    import torch

    from go_libp2p_pubsub_tpu_torch.state import SimState

    n = spec["n"]
    st, step = sweep.build_floodsub(n, M_SLOTS, graph=spec["graph"], layout=spec["layout"],
                                    device=dev)
    net = step.net
    say(f"floodsub {spec['graph']}/{spec['layout']} N={n} K={net.max_degree} "
        f"E={net.n_edges if net.n_edges is not None else n * net.max_degree}: "
        f"host set-up {step.setup_seconds:.3f} s")
    po, pt, pv = sweep.publish_schedule(FLOOD_ROUNDS, n, 1, None)
    st = sweep.run_rounds(st, step, po[:8], pt[:8], pv[:8])
    sched = [torch.as_tensor(a[8], device=dev) for a in (po, pt, pv)]
    st, captured = capture_round(lambda s: step(s, *sched), st, module, (name,))
    args, kw = captured[name]
    err, io, ops = check_flood_kernel(module, name, args, kw, gen)
    rec = {
        "name": name, "route": "cuda", "source": DELIVERY_SOURCE,
        "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
        "ms": time_ms(lambda: getattr(module, name)(*args, **kw)),
        "plain_ms": time_ms(lambda: getattr(module, name + "_plain")(*args, **kw)),
        **bound(io, ops), "library_ms": None,
    }
    say(f"kernel {name}: exact (max_abs_err {err}) kernel_ms={rec['ms']:.6f} "
        f"plain_ms={rec['plain_ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}, {io} bytes moved) library_ms=null")
    del st, captured, args

    # the main path: 80 rounds from a fresh state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = SimState.init(n, M_SLOTS, k=net.max_degree, device=dev, n_edges=net.n_edges)
    module.reset_launch_counts()
    t0 = time.perf_counter()
    st = sweep.run_rounds(st, step, po, pt, pv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec["launches"] = module.LAUNCHES[name]
    if rec["launches"] != FLOOD_ROUNDS or int(st.tick) != FLOOD_ROUNDS:
        raise AssertionError(f"{name} launched {rec['launches']} times in {FLOOD_ROUNDS} rounds")
    if bool(((st.dlv.fwd & ~st.dlv.have) != 0).any()):
        raise AssertionError("fwd is not a subset of have")
    reach = (st.dlv.first_round >= 0).sum(0)
    born = st.msgs.birth
    old = (born >= 0) & (born <= FLOOD_ROUNDS - 4)
    if not bool(old.any()) or not bool((reach[old] > 1).all()):
        raise AssertionError("a message published 4+ rounds ago reached only its origin")
    peak = torch.cuda.max_memory_allocated()
    leaves = convert.state_leaves(st)
    state_bytes = sum(a.nbytes for a in leaves.values())
    say(f"floodsub {spec['graph']}/{spec['layout']} N={n}: {FLOOD_ROUNDS} rounds, "
        f"{name} launches {rec['launches']}, fwd subset of have, old messages past "
        f"their origin (median reach {int(reach[old].median())} peers); events "
        f"{leaves['.events'][:9].tolist()}")
    say(f"floodsub {spec['graph']}/{spec['layout']} rate: {FLOOD_ROUNDS / dt:.3f} rounds/s "
        f"({1e3 * dt / FLOOD_ROUNDS:.3f} ms/round), peak memory {peak} bytes "
        f"({peak / 2**20:.1f} MiB), state {state_bytes} bytes, on {card}")
    return rec


def flood_parity(sweep, convert, spec):
    """Phase 8: FloodSub from the same seed on the card and on the CPU
    (plain versions) at N=8192, every leaf equal after every round."""
    po, pt, pv = sweep.publish_schedule(PARITY_ROUNDS, N_PARITY, 1, None, seed=5)
    sides = {d: sweep.build_floodsub(N_PARITY, M_SLOTS, device=d, **spec)
             for d in ("cuda", "cpu")}
    t0 = time.perf_counter()
    for r in range(PARITY_ROUNDS):
        for d, (s, stp) in list(sides.items()):
            sides[d] = (sweep.run_rounds(s, stp, po[r:r + 1], pt[r:r + 1], pv[r:r + 1]), stp)
        leaves_equal(convert.state_leaves(sides["cpu"][0]),
                     convert.state_leaves(sides["cuda"][0]), f"round {r}")
    ev = convert.state_leaves(sides["cuda"][0])[".events"]
    say(f"floodsub {spec['graph']}/{spec['layout']} card == CPU: every leaf equal after "
        f"each of {PARITY_ROUNDS} rounds at N={N_PARITY} "
        f"({time.perf_counter() - t0:.1f} s; events {ev[:9].tolist()})")


def leaves_equal(a: dict, b: dict, where: str):
    import numpy as np

    assert sorted(a) == sorted(b), where
    for p in a:
        x, y = a[p], b[p]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{where}: leaf {p} dtype/shape differ")
        if x.dtype.kind == "f":
            x, y = x.view(np.uint32), y.view(np.uint32)
        if not np.array_equal(x, y):
            raise AssertionError(f"{where}: leaf {p} differs between card and CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from go_libp2p_pubsub_tpu_torch import convert
    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
    from go_libp2p_pubsub_tpu_torch.ops import kernels
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    # 1. environment
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {name} count {torch.cuda.device_count()}")
    say(card)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = dict(zip(KERNEL_SOURCES, pool.map(kernels.build, KERNEL_SOURCES)))
    for src, built in builds.items():
        kernels.load(src)
        say(f"build: {src}.cu nvcc {built['seconds']:.2f} s -> {kernels.library_path(src)}")
        for line in built["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("  " + line.strip())
    say(f"build phase {time.perf_counter() - t0:.2f} s")

    # 3. kernels at the main path's shapes, inputs from a real round
    st, step, n_topics, honest = sweep.build_bench(N_FULL, M_SLOTS, device=dev)
    po, pt, pv = sweep.publish_schedule(FORMATION_ROUNDS + MEASURED_ROUNDS + 1,
                                        N_FULL, n_topics, honest)
    st = sweep.run_rounds(st, step, po[:8], pt[:8], pv[:8])
    sched = [torch.as_tensor(a[8], device=dev) for a in (po, pt, pv)]
    st, captured = capture_round(lambda s: step(s, *sched), st, fr)
    gen = torch.Generator().manual_seed(0)
    records = check_kernels(fr, captured, gen)
    del st, captured

    # 4. the slice at full width
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, step, n_topics, honest = sweep.build_bench(N_FULL, M_SLOTS, device=dev)
    fr.reset_launch_counts()
    st = sweep.run_rounds(st, step, po[:FORMATION_ROUNDS], pt[:FORMATION_ROUNDS],
                          pv[:FORMATION_ROUNDS])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sl = slice(FORMATION_ROUNDS, FORMATION_ROUNDS + MEASURED_ROUNDS)
    st = sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fr.LAUNCHES)
    total = FORMATION_ROUNDS + MEASURED_ROUNDS
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["launches"] != total:
            raise AssertionError(f"{r['name']} launched {r['launches']} times in "
                                 f"{total} rounds")
    assert int(st.core.tick) == total
    deg = st.mesh.sum(-1)
    dmin, dmax = int(deg.min()), int(deg.max())
    if not (5 <= dmin and dmax <= 12):
        raise AssertionError(f"mesh degrees [{dmin}, {dmax}] outside [Dlo, Dhi] = [5, 12]")
    if bool(((st.core.dlv.fwd & ~st.core.dlv.have) != 0).any()):
        raise AssertionError("fwd is not a subset of have")
    reach = (st.core.dlv.first_round >= 0).sum(0)
    born = st.core.msgs.birth
    old = (born >= 0) & (born <= total - 4)
    if not bool((reach[old] > 1).all()):
        raise AssertionError("a message published 4+ rounds ago reached only its origin")
    peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(a.nbytes for a in convert.state_leaves(st).values())
    say(f"slice N={N_FULL} M={M_SLOTS} K=16: {total} rounds, launches {launches}, "
        f"mesh degree [{dmin}, {dmax}], fwd subset of have")
    say(f"slice rate: {MEASURED_ROUNDS / dt:.3f} rounds/s over {MEASURED_ROUNDS} rounds "
        f"({1e3 * dt / MEASURED_ROUNDS:.3f} ms/round), peak memory {peak} bytes "
        f"({peak / 2**20:.1f} MiB), state {state_bytes} bytes, on {card}")
    del st

    # 5. card against CPU from the same seed
    po5, pt5, pv5 = sweep.publish_schedule(PARITY_ROUNDS, N_PARITY, 1, None, seed=5)
    sides = {}
    for d in ("cuda", "cpu"):
        s, stp, _, _ = sweep.build_bench(N_PARITY, M_SLOTS, count_events=True, device=d)
        sides[d] = (s, stp)
    t0 = time.perf_counter()
    for r in range(PARITY_ROUNDS):
        for d, (s, stp) in list(sides.items()):
            s = sweep.run_rounds(s, stp, po5[r:r + 1], pt5[r:r + 1], pv5[r:r + 1])
            sides[d] = (s, stp)
        leaves_equal(convert.state_leaves(sides["cpu"][0]),
                     convert.state_leaves(sides["cuda"][0]), f"round {r}")
    ev = convert.state_leaves(sides["cuda"][0])[".core.events"]
    say(f"card == CPU: every leaf equal after each of {PARITY_ROUNDS} rounds at "
        f"N={N_PARITY} ({time.perf_counter() - t0:.1f} s; events {ev.tolist()})")

    # 6-8. FloodSub over the shared delivery core, both layouts
    from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as cd
    from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as db

    records.append(flood_run(sweep, convert, db, "delivery_banded", dict(
        n=N_FULL, graph="lattice", layout="dense"), card, gen, dev))
    records.append(flood_run(sweep, convert, cd, "csr_delivery", dict(
        n=N_CSR, graph="powerlaw", layout="csr"), card, gen, dev))
    for kw in (dict(graph="lattice", layout="dense"), dict(graph="powerlaw", layout="csr")):
        flood_parity(sweep, convert, kw)

    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
