"""Shared helpers of the port's parity tests: the JAX package's state as
schema-path leaves, and the bench-default GossipSub builds of both
packages on the same small topology (the banded lattice by default)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def reference_leaves(jst) -> dict:
    """{schema path: numpy array} of a JAX state tree (keys as key_data)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jst)[0]:
        if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


def diff_leaves(ref: dict, got: dict, where: str = "") -> None:
    """Assert the two leaf dicts hold the same paths, dtypes, shapes and
    bits (float leaves compared bitwise, so -0.0 != 0.0)."""
    assert sorted(ref) == sorted(got), (sorted(set(ref) ^ set(got)), where)
    for p in ref:
        a, b = ref[p], got[p]
        assert a.dtype == b.dtype and a.shape == b.shape, (p, a.dtype, b.dtype,
                                                           a.shape, b.shape, where)
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        if not np.array_equal(a, b):
            bad = np.argwhere(a != b)
            raise AssertionError(
                f"{where}: leaf {p} differs at {len(bad)} entries, first "
                f"{bad[:3].tolist()}: {a[tuple(bad[0])]} vs {b[tuple(bad[0])]}")


def bench_builds(n=96, d=4, msg_slots=64, heartbeat_every=1,
                 count_events=True, seed=0, topologies=None,
                 edge_layout="dense", fused=False):
    """(jax_cfg, jax_net, sp, torch_cfg, torch_net, torch_sp) for the
    bench's default params on ring_lattice(n, d), or on ``topologies``, a
    (JAX Topology, port Topology) pair of the same graph, in
    ``edge_layout`` with the ``fused`` flag on both the net and the
    config."""
    from go_libp2p_pubsub_tpu import config as jconfig
    from go_libp2p_pubsub_tpu import graph as jgraph
    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
    from go_libp2p_pubsub_tpu.perf.sweep import bench_score_params as jbsp
    from go_libp2p_pubsub_tpu.state import Net as JNet

    from go_libp2p_pubsub_tpu_torch import config as tconfig
    from go_libp2p_pubsub_tpu_torch import graph as tgraph
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg
    from go_libp2p_pubsub_tpu_torch.perf.sweep import bench_score_params as tbsp
    from go_libp2p_pubsub_tpu_torch.state import Net as TNet

    if topologies is None:
        topologies = jgraph.ring_lattice(n, d=d), tgraph.ring_lattice(n, d=d)
    layout = dict(edge_layout=edge_layout, fused=fused)
    jnet = JNet.build(topologies[0], jgraph.subscribe_all(n, 1), **layout)
    jcfg = JCfg.build(dataclasses.replace(jconfig.GossipSubParams(), flood_publish=False),
                      jconfig.PeerScoreThresholds(), score_enabled=True,
                      heartbeat_every=heartbeat_every, **layout)
    jcfg = dataclasses.replace(jcfg, count_events=count_events, fanout_slots=0)
    _, jsp = jbsp("default", 1)
    tnet = TNet.build(topologies[1], tgraph.subscribe_all(n, 1), device="cpu", **layout)
    tcfg = TCfg.build(dataclasses.replace(tconfig.GossipSubParams(), flood_publish=False),
                      tconfig.PeerScoreThresholds(), score_enabled=True,
                      heartbeat_every=heartbeat_every, **layout)
    tcfg = dataclasses.replace(tcfg, count_events=count_events, fanout_slots=0)
    _, tsp = tbsp(1)
    return jcfg, jnet, jsp, tcfg, tnet, tsp
