"""Rounds/s of the two FloodSub cells' main path, as chip_smoke.py phases
10-11 time them (80 rounds from a fresh state after 8 warm-up rounds): the
N=100k lattice banded dense and the N=1M power-law graph CSR-resident.

    python3 go_libp2p_pubsub_tpu_torch/perf/flood_rate.py [ROOT]

ROOT is the checkout whose port is imported (default: this one), so two
commits compare in turns, one fresh process a run, on one card (e.g. a
parent unpacked with ``git archive`` into a directory .gitignore lists).
Prints one line: ROOT, then rounds/s of each cell. Needs a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys
import time


def main() -> int:
    root = sys.argv[1] if len(sys.argv) > 1 else str(pathlib.Path(__file__).resolve().parents[2])
    # in place of this script's directory, whose profile.py would shadow the stdlib's
    sys.path[0] = root
    import torch

    from go_libp2p_pubsub_tpu_torch.perf import sweep
    from go_libp2p_pubsub_tpu_torch.state import SimState

    if not torch.cuda.is_available():
        print("flood_rate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = []
    for graph, layout, n in (("lattice", "dense", 100_000), ("powerlaw", "csr", 1_000_000)):
        st, step = sweep.build_floodsub(n, 64, graph=graph, layout=layout, device=dev)
        net = step.net
        po, pt, pv = sweep.publish_schedule(80, n, 1, None)
        st = sweep.run_rounds(st, step, po[:8], pt[:8], pv[:8])
        torch.cuda.synchronize()
        st = SimState.init(n, 64, k=net.max_degree, device=dev, n_edges=net.n_edges)
        t0 = time.perf_counter()
        st = sweep.run_rounds(st, step, po, pt, pv)
        torch.cuda.synchronize()
        out.append(f"{graph}/{layout} {80 / (time.perf_counter() - t0):.3f}")
    print(root, " | ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
