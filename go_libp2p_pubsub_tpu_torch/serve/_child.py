"""The deterministic supervised cell that crash-recovery runs SIGKILL
(the JAX package's ``serve/_child.py``).

``python -m go_libp2p_pubsub_tpu_torch.serve._child --root DIR ...``
builds a small GossipSub workload (fixed topology, schedule and seeds:
every process given the same arguments runs the same run) and drives the
supervisor over it on ``--device`` (``cuda`` by default; the CPU tests
pass ``cpu``). A parent kills it at a scheduled point (through the
in-process ``FaultPlan``, so the kill lands in the crash window under
test, mid-checkpoint-write included), then runs the same command line
again: the resumed run must end bit-exact against an uninterrupted
control, which the ``state_digest`` in ``<root>/FINAL.json`` witnesses.
The digest equals the JAX package's cell's for the same arguments.

The JAX cell reads two environment variables that have nothing to select
here and are deliberately not read: ``SERVE_CHILD_PRNG`` (the port
carries threefry only) and ``SERVE_CHILD_CACHE`` (the port has no XLA
compile cache).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_cell(n: int, rounds: int, seed: int, loss: float, pub_width: int = 2,
               msg_slots: int = 64, device=None):
    """The fixed workload: a random 4-regular-ish net of GossipSub peers
    under i.i.d. link loss, live scoring and event counters (the probes'
    food), a seeded publish schedule. Returns ``(step, make_args,
    template_fn, net, cfg)``; the publish rows are made on the net's
    device once."""
    import numpy as np
    import torch

    from .. import graph
    from ..chaos import ChaosConfig
    from ..config import GossipSubParams, PeerScoreThresholds
    from ..models.gossipsub import GossipSubConfig, GossipSubState, make_gossipsub_step
    from ..perf.sweep import bench_score_params
    from ..state import Net

    # the oracle's known-good GossipSub cell: a heartbeat every round, the
    # bench's score parameters; every property holds
    topo = graph.random_connect(n, d=4, seed=seed)
    net = Net.build(topo, graph.subscribe_all(n, 1), device=device)
    cfg = GossipSubConfig.build(
        GossipSubParams(D=3, Dlo=2, Dhi=4, Dscore=2, Dout=1,
                        history_length=6, history_gossip=4),
        PeerScoreThresholds(), score_enabled=True,
        chaos=ChaosConfig(loss_rate=loss) if loss > 0 else None,
    )
    cfg = dataclasses.replace(cfg, count_events=True)
    sp = bench_score_params("default", 1)[1]
    step = make_gossipsub_step(cfg, net, score_params=sp)

    rng = np.random.default_rng(seed + 1)
    dev = net.nbr_ok.device
    po_all = torch.as_tensor(rng.integers(0, n, size=(rounds, pub_width)).astype(np.int32),
                             device=dev)
    pt_all = torch.zeros((rounds, pub_width), dtype=torch.int32, device=dev)
    pv_all = torch.ones((rounds, pub_width), dtype=torch.bool, device=dev)

    def make_args(i):
        return po_all[i], pt_all[i], pv_all[i]

    def template_fn():
        return GossipSubState.init(net, msg_slots, cfg, score_params=sp, seed=seed)

    return step, make_args, template_fn, net, cfg


def build_supervisor(args):
    from ..oracle import HealthConfig, InvariantConfig, ScanInvariants
    from ..state import resolve_device
    from . import FaultPlan, RetentionPolicy, ServiceConfig, Supervisor

    # "cuda" resolves through resolve_device(None), which raises without a card
    device = resolve_device(None if args.device == "cuda" else args.device)
    step, make_args, template_fn, net, cfg = build_cell(
        args.n, args.rounds, args.seed, args.loss, device=device)
    invariants = None
    if args.invariants:
        invariants = ScanInvariants(
            "gossipsub", net, cfg,
            InvariantConfig(check_every=args.check_every, delivery_window=16),
            batched=False)
    health = HealthConfig(delivery_floor=args.floor) if args.probes else None
    faults = None
    if (args.kill_segment is not None or args.fail_segment is not None
            or args.corrupt_segment is not None):
        faults = FaultPlan(
            kill_segment=args.kill_segment,
            kill_site=args.kill_site,
            fail_dispatches=({args.fail_segment: args.fail_count}
                             if args.fail_segment is not None else {}),
            corrupt_segment=args.corrupt_segment,
            corrupt_dispatch=args.corrupt_dispatch,
            corrupt_leaf=args.corrupt_leaf,
            corrupt_kind=args.corrupt_kind,
            corrupt_max_fires=args.corrupt_max_fires,
        )
    svc = ServiceConfig(
        n_dispatches=args.rounds,
        segment_len=args.segment,
        health=health,
        retention=RetentionPolicy(keep_last=args.keep_last, keep_every=args.keep_every),
        checkpoint_every_segments=args.checkpoint_every,
        max_retries=args.max_retries,
        backoff_base_s=0.01,
        report_name="service" if args.report else None,
    )
    return Supervisor(step, make_args, template_fn, args.root, svc,
                      invariants=invariants, faults=faults)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card) or cpu")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--segment", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--loss", type=float, default=0.1)
    ap.add_argument("--invariants", action="store_true")
    ap.add_argument("--check-every", type=int, default=4)
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--floor", type=int, default=0)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--keep-every", type=int, default=0)
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints (the control run)")
    ap.add_argument("--kill-segment", type=int, default=None)
    ap.add_argument("--kill-site", default="post-segment")
    ap.add_argument("--fail-segment", type=int, default=None)
    ap.add_argument("--fail-count", type=int, default=1)
    ap.add_argument("--corrupt-segment", type=int, default=None)
    ap.add_argument("--corrupt-dispatch", type=int, default=-1)
    ap.add_argument("--corrupt-leaf", default="scores")
    ap.add_argument("--corrupt-kind", default="nan")
    ap.add_argument("--corrupt-max-fires", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from . import ServiceHalted, state_digest

    # nothing here takes a gradient
    torch.set_grad_enabled(False)
    sup = build_supervisor(args)
    try:
        report = sup.run(fresh=args.fresh)
    except ServiceHalted as e:
        out = {"status": "halted", "error": str(e),
               "bundle": (e.bundle or {}).get("path")}
        with open(os.path.join(args.root, "FINAL.json"), "w") as f:
            json.dump(out, f)
        print(json.dumps(out))
        return 3
    out = {
        "status": "done",
        "digest": state_digest(report.states),
        "segments": report.segments,
        "recoveries": report.recoveries,
        "retries": report.retries,
        "resumed_from": report.resumed_from,
        "degradations": report.degradations,
        "window_compiles": report.window_compiles,
        "checkpoints": [e["ordinal"] for e in report.checkpoints],
        "bundles": [b["path"] for b in report.bundles],
        "first_bad": [b["first_bad_dispatch"] for b in report.bundles],
        "service": report.fingerprint(),
    }
    with open(os.path.join(args.root, "FINAL.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
