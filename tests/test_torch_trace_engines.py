"""The trace drain on churn, PX, FloodSub and RandomSub against the JAX
package's, byte for byte (split from tests/test_torch_trace.py, whose
runners it uses): dynamic peers' REMOVE_PEER and ADD_PEER records, PX's
GRAFT and PRUNE from the mesh diffs with dormant edges, and a bare
``SimState`` (no mesh, no liveness) on the banded lattice and a power-law
graph CSR-resident. A fresh JAX state is built for every run: the JAX
steps donate their buffers."""

from __future__ import annotations

import jax.numpy as jnp
import pytest
import torch
from test_torch_churn import DYN, up_schedule
from test_torch_px import px_builds
from test_torch_randomsub import nets as rs_nets
from test_torch_trace import ROUNDS, TYPE, _both, _gossip_run, _types
from torch_parity import bench_builds, jinit, phase_schedule, reference_leaves

from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models import randomsub as jrs
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models import randomsub as trs


def test_churn_traces_equal_reference(tmp_path):
    """Dynamic peers (the churn tests' schedule): REMOVE_PEER and ADD_PEER
    records one for each transition the device counted."""
    from test_torch_churn import topologies

    n = 64
    up = up_schedule(18, n)
    builds = bench_builds(n=n, topologies=topologies("lattice"))
    snap, sess, (evs, _) = _both(tmp_path, *_gossip_run(builds, 18, up=up, step_kw=DYN))
    kinds = [TYPE.Type.Name(e.type) for e in evs]
    count = sess.counter_events(snap)
    assert kinds.count("REMOVE_PEER") == count["REMOVE_PEER"] > 0
    assert kinds.count("ADD_PEER") == count["ADD_PEER"] + n


def test_px_traces_equal_reference(tmp_path):
    """PX with dormant edges on the lattice: GRAFT and PRUNE records from
    the mesh diffs, over-subscription prunes every heartbeat."""
    builds, dormant = px_builds("lattice")
    snap, _, (evs, _) = _both(tmp_path, *_gossip_run(builds, 16, dormant=dormant))
    kinds = [TYPE.Type.Name(e.type) for e in evs]
    assert kinds.count("PRUNE") > 0 and kinds.count("GRAFT") > kinds.count("PRUNE")


@pytest.mark.parametrize("router,layout", [("floodsub", "lattice"), ("floodsub", "csr"),
                                           ("randomsub", "lattice"), ("randomsub", "csr")])
def test_sim_state_traces_equal_reference(tmp_path, router, layout):
    """FloodSub and RandomSub (a bare ``SimState``: no mesh, no liveness)
    on the banded lattice and a power-law graph CSR-resident."""
    kind, lay = ("lattice", "dense") if layout == "lattice" else ("powerlaw", "csr")
    n = 128
    jnet, tnet = rs_nets(kind, lay, n=n)
    resident = layout == "csr"
    jst = jinit(JSim.init, n, 64, seed=0, k=jnet.max_degree,
                    n_edges=jnet.n_edges if resident else None)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    po, pt, pv = phase_schedule(n, ROUNDS)
    if router == "floodsub":
        jstep = lambda s, *a: jflood.floodsub_step(jnet, s, *a)
        tstep = lambda s, *a: tflood.floodsub_step(tnet, s, *a)
    else:
        jstep, tstep = jrs.make_randomsub_step(jnet), trs.make_randomsub_step(tnet)
    jcall = lambda s, i: jstep(s, jnp.asarray(po[i]), jnp.asarray(pt[i]), jnp.asarray(pv[i]))
    tcall = lambda s, i: tstep(s, torch.from_numpy(po[i]), torch.from_numpy(pt[i]),
                               torch.from_numpy(pv[i]))
    snap, sess, (evs, q1) = _both(tmp_path, (jnet, tnet), (jst, tst), (jcall, tcall),
                                  lambda i: (po[i], pt[i], pv[i]), ROUNDS, resident=resident)
    kinds = [TYPE.Type.Name(e.type) for e in evs]
    assert kinds.count("DELIVER_MESSAGE") == sess.counter_events(snap)["DELIVER_MESSAGE"] > 0
    assert "GRAFT" not in kinds and "DROP_RPC" in _types(q1)
