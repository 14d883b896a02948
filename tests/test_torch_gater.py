"""The port's peer gater (score/gater.py) against the JAX package's, jitted,
on random counters (numpy, from a seed), bit for bit.

``share`` is the per-source share of the outcome counters, an
``einsum("nkj,nj->nk")`` that XLA:CPU compiles to a batched dot: its sums
run in 8-wide vector chunks, the lanes added in adjacent pairs, the
columns past the last whole chunk in a scalar loop. Held here against the
jitted einsum at every K from 1 to 40 and at 64, where any other order
differs on some rows. ``gater_accept`` is held on nets whose peers share
ip groups (the share's order shows) and on unique groups (the identity
share), with weights that are not powers of two (the weighted total is a
fused multiply-add chain on XLA:CPU; a written-out multiply and add
differs on some rows), random throttle state and ticks across the quiet
window. ``gater_decay`` is held with the default decays and with a
subnormal ``decay_to_zero`` and decays that make subnormal products,
which XLA flushes. No tolerance on any leaf."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import config as jconfig
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.score import gater as jgater
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import config as tconfig
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import prng
from go_libp2p_pubsub_tpu_torch.score import gater as tgater
from go_libp2p_pubsub_tpu_torch.state import Net as TNet

N = 120
FIELDS = ("validate", "throttle", "last_throttle", "deliver", "duplicate", "ignore", "reject")


def _bits_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    bad = np.argwhere(a != b)
    assert len(bad) == 0, f"{what}: {len(bad)} entries differ, first {bad[:3].tolist()}"


def _counters(rng, shape):
    """Non-negative f32 counters over many magnitudes, a fifth of them 0."""
    x = rng.random(shape) * rng.choice([1e-3, 1.0, 100.0, 1e5], size=shape)
    x[rng.random(shape) < 0.2] = 0.0
    return x.astype(np.float32)


def _states(k: int, seed: int):
    """(JAX GaterState, port GaterState) with the same random counters."""
    rng = np.random.default_rng(seed)
    kk = {f: _counters(rng, (N, k)) for f in ("deliver", "duplicate", "ignore", "reject")}
    validate = _counters(rng, (N,))
    throttle = np.where(rng.random(N) < 0.5, validate * rng.random(N).astype(np.float32),
                        _counters(rng, (N,))).astype(np.float32)
    last = rng.integers(-5, 40, size=N).astype(np.int32)
    last[rng.random(N) < 0.2] = -(2**30)
    vals = dict(kk, validate=validate, throttle=throttle, last_throttle=last)
    j = jgater.GaterState(**{f: jnp.asarray(vals[f]) for f in FIELDS})
    t = tgater.GaterState(**{f: torch.from_numpy(vals[f].copy()) for f in FIELDS})
    return j, t


@pytest.mark.parametrize("k", list(range(1, 41)) + [64])
def test_share_equals_the_jitted_einsum(k):
    rng = np.random.default_rng(k)
    same = rng.random((64, k, k)) < 0.6
    x = (rng.random((64, k)) * 2.0 ** rng.integers(-20, 20, size=(64, k))).astype(np.float32)
    want = jax.jit(lambda s, v: jnp.einsum("nkj,nj->nk", s, v))(
        jnp.asarray(same, jnp.float32), jnp.asarray(x))
    got = tgater.share(torch.from_numpy(same), torch.from_numpy(x))
    _bits_equal(want, got.numpy(), f"share K={k}")


def _nets(kind: str):
    n = N
    if kind == "random":
        jt, tt = jgraph.random_connect(n, d=6, seed=1), tgraph.random_connect(n, d=6, seed=1)
    else:
        d = {"K8": 4, "K10": 5, "K16": 8, "K20": 10}[kind]
        jt, tt = jgraph.ring_lattice(n, d=d), tgraph.ring_lattice(n, d=d)
    return jt, tt


@pytest.mark.parametrize("kind,group", [
    ("K8", 4), ("K10", 3), ("K16", 3), ("K16", 8), ("K16", 1), ("K20", 5), ("random", 4),
])
def test_accept_equals_reference(kind, group):
    """Shared groups of ``group`` consecutive ids (1: unique ip groups, the
    identity share), random state and weights, ticks inside and past the
    quiet window; also the intermediate total read back through a
    drop probability of zero."""
    jt, tt = _nets(kind)
    ip = (np.arange(N) // group).astype(np.int32)
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 1), ip_group=ip)
    tnet = TNet.build(tt, tgraph.subscribe_all(N, 1), ip_group=ip, device="cpu")
    share = tgater.source_share(tnet)
    for seed, weights in enumerate([{}, dict(duplicate_weight=0.3, ignore_weight=1.7,
                                              reject_weight=13.3, threshold=0.21)]):
        jp, tp = jconfig.PeerGaterParams(**weights), tconfig.PeerGaterParams(**weights)
        jgs, tgs = _states(jnet.max_degree, 100 * seed + group)
        for tick in (0, 7, 30, 70):
            key = jax.random.fold_in(jax.random.key(seed), tick)
            fn = jax.jit(lambda g, t, kk, jp=jp: jgater.gater_accept(g, jnet, jp, 60, t, kk))
            want = fn(jgs, jnp.int32(tick), key)
            got = tgater.gater_accept(tgs, share, tp, 60, torch.tensor(tick, dtype=torch.int32),
                                      prng.fold_in(prng.key(seed), tick))
            _bits_equal(want, got.numpy(), f"{kind} group {group} seed {seed} tick {tick}")
            # the bernoulli plane is live: some edges drop, some pass
            if tick == 0:
                assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("params", [
    {},
    # a subnormal decay_to_zero (read as zero) and decays whose products
    # turn subnormal within a few steps (flushed)
    dict(decay_to_zero=1e-40, global_decay=1e-10, source_decay=1e-12),
], ids=["defaults", "subnormal"])
def test_decay_and_on_round_equal_reference(params):
    jp, tp = jconfig.PeerGaterParams(**params), tconfig.PeerGaterParams(**params)
    jgs, tgs = _states(16, 5)
    rng = np.random.default_rng(9)
    jdecay = jax.jit(lambda g: jgater.gater_decay(g, jp))
    jround = jax.jit(jgater.gater_on_round)
    for step in range(6):
        jgs, tgs = jdecay(jgs), tgater.gater_decay(tgs, tp)
        inc = [rng.integers(0, 5, size=(N, 16)).astype(np.float32) for _ in range(4)]
        nv = rng.integers(0, 9, size=N).astype(np.int32)
        nt = np.where(rng.random(N) < 0.3, rng.integers(1, 4, size=N), 0).astype(np.int32)
        jgs = jround(jgs, jnp.asarray(nv), jnp.asarray(nt), *map(jnp.asarray, inc[:3]),
                     jnp.int32(step), ignore_inc=jnp.asarray(inc[3]))
        tgs = tgater.gater_on_round(tgs, torch.from_numpy(nv), torch.from_numpy(nt),
                                    *(torch.from_numpy(a) for a in inc[:3]),
                                    torch.tensor(step, dtype=torch.int32),
                                    ignore_inc=torch.from_numpy(inc[3]))
        for f in FIELDS:
            _bits_equal(getattr(jgs, f), getattr(tgs, f).numpy(), f"{f} after step {step}")
    if params:
        # the decays cleared what the increments did not refill
        assert float(tgs.deliver.min()) == 0.0
