"""The port's fused data-plane kernels (go_libp2p_pubsub_tpu_torch/ops/
fused_round.py) against the JAX package's Pallas kernels.

On the CPU the port's wrappers take the plain PyTorch versions; they must
equal ``fr.edge_exchange`` / ``fr.fused_delivery`` run in interpret mode
bit for bit, on a small banded topology with random words and on the
hazard bands of tests/torch_parity.py (``fused_delivery``'s in
tests/test_torch_fused_round_hazards.py, so that each file stays within a
loadfile worker's share of the suite). The CUDA kernels are held against
the plain versions on the card (the ``cuda`` marked tests here and in
tests/test_torch_kernels_cuda.py, and chip_smoke.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.ops import fused_round as jfr
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch.ops import fused_round as tfr
from torch_parity import HAZARD_C, hazard_bands, hazard_exchange_args, hazard_fused_args

N, D, W, C = 64, 4, 2, 4
FUSED_BANDS = [b for b in hazard_bands() if len(b["offsets"]) <= tfr.MAX_K]


@pytest.fixture(scope="module")
def band():
    net = JNet.build(jgraph.ring_lattice(N, d=D), jgraph.subscribe_all(N, 1))
    assert net.band_off is not None
    return net.band_off, net.band_rev, jfr.pick_block(N, net.band_off)


def _words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _u(t):
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _scores(rng, n, k):
    s = rng.normal(0.0, 20.0, size=(n, k)).astype(np.float32)
    s[rng.random((n, k)) < 0.1] = -0.0
    s[rng.random((n, k)) < 0.1] = -10.0   # exactly at the gossip threshold
    return s


@pytest.mark.parametrize("score_enabled", [True, False])
def test_edge_exchange_plain_equals_pallas(band, score_enabled):
    off, rev, block = band
    k = len(off)
    rng = np.random.default_rng(1)
    wire = _words(rng, N, k * C)
    scores = _scores(rng, N, k)
    live = (rng.random((N, k)) < 0.8).astype(np.uint32)
    ref_w, ref_s = jfr.edge_exchange(
        jnp.asarray(wire), jnp.asarray(scores) if score_enabled else None,
        jnp.asarray(live), block=block, offsets=off, revs=rev, c=C,
        score_enabled=score_enabled, interpret=True)
    got_w, got_s = tfr.edge_exchange(
        _t(wire), _t(scores) if score_enabled else None, _t(live),
        offsets=off, revs=rev, c=C, score_enabled=score_enabled)
    np.testing.assert_array_equal(np.asarray(ref_w), _u(got_w))
    if score_enabled:
        np.testing.assert_array_equal(np.asarray(ref_s).view(np.uint32),
                                      _u(got_s).view(np.uint32))
    else:
        assert got_s is None


@pytest.mark.parametrize("band", FUSED_BANDS, ids=[b["name"] for b in FUSED_BANDS])
@pytest.mark.parametrize("c", HAZARD_C)
def test_edge_exchange_plain_equals_pallas_on_hazard_bands(band, c):
    """The hazard bands (tests/torch_parity.hazard_bands, K <= 16: N=17
    under the staged window, N not a multiple of the block, a circulant
    with steps 333 and 500 = N/2) at C = 1 to 7 words a slot (the PX widths
    5 and 7 with a symmetric live mask), with dead edges and scores holding -0.0, subnormals of both signs and NaN:
    the exchange copies every score bit, a subnormal as it is, as the
    Pallas kernel does in interpret mode."""
    n, off, rev = band["n"], band["offsets"], band["revs"]
    wire, scores, live = hazard_exchange_args(n + c, band, c)
    block = jfr.pick_block(n, off) or n    # a halo past every block: one block of N
    ref_w, ref_s = jfr.edge_exchange(jnp.asarray(wire), jnp.asarray(scores),
                                     jnp.asarray(live), block=block, offsets=off, revs=rev,
                                     c=c, score_enabled=True, interpret=True)
    got_w, got_s = tfr.edge_exchange(_t(wire), _t(scores), _t(live), offsets=off,
                                     revs=rev, c=c, score_enabled=True)
    np.testing.assert_array_equal(np.asarray(ref_w), _u(got_w))
    np.testing.assert_array_equal(np.asarray(ref_s).view(np.uint32), _u(got_s).view(np.uint32))


def _delivery_inputs(k, seed):
    rng = np.random.default_rng(seed)
    sparse = lambda *s: _words(rng, *s) & _words(rng, *s) & _words(rng, *s)
    flags = jfr.make_flags(
        jnp.asarray(rng.random((N, k)) < 0.9),
        jnp.asarray(rng.random((N, k)) < 0.1),
        jnp.asarray(rng.random(N) < 0.1),
        jnp.asarray(rng.random((N, k)) < 0.9),
        jnp.asarray(rng.random((N, k)) < 0.9),
    )
    return dict(
        carry_out=_words(rng, N, k * W), fe_words=sparse(N, k * W),
        fwd=_words(rng, N, W), mcache_win=_words(rng, N, W),
        nbr_score=_scores(rng, N, k), asked=_words(rng, N, k * W),
        served_lo=_words(rng, N, k * W), served_hi=sparse(N, k * W),
        flags=np.asarray(flags), have=sparse(N, W), origin_w=sparse(N, W),
        joined_w=~sparse(N, W), valid_row=_words(rng, 1, W),
    )


@pytest.mark.parametrize("score_enabled,want_cohorts,retrans_cap", [
    (True, True, 0), (True, True, 1), (True, True, 2), (True, True, 3),
    (True, False, 3), (False, True, 3), (False, False, 1),
])
def test_fused_delivery_plain_equals_pallas(band, score_enabled, want_cohorts,
                                            retrans_cap):
    off, rev, block = band
    k = len(off)
    inp = _delivery_inputs(k, seed=retrans_cap + 7)
    if not score_enabled:
        inp["nbr_score"] = None
    static = dict(offsets=off, revs=rev, w=W, score_enabled=score_enabled,
                  want_cohorts=want_cohorts, retrans_cap=retrans_cap)
    args = [inp[nm] for nm in ("carry_out", "fe_words", "fwd", "mcache_win",
                               "nbr_score", "asked", "served_lo", "served_hi",
                               "flags", "have", "origin_w", "joined_w",
                               "valid_row")]
    ref = jfr.fused_delivery(
        *[None if a is None else jnp.asarray(a) for a in args], -10.0, -50.0,
        block=block, interpret=True, **static)
    got = tfr.fused_delivery(*[None if a is None else _t(a) for a in args],
                             -10.0, -50.0, **static)
    assert sorted(ref) == sorted(got)
    for name in ref:
        np.testing.assert_array_equal(np.asarray(ref[name]), _u(got[name]),
                                      err_msg=name)


@pytest.mark.parametrize("thr", [0.0, -0.0])
def test_fused_delivery_gates_read_subnormal_scores_as_zeros(thr):
    """Neighbour scores of +-1e-45 and +-1e-40 at gossip and publish
    thresholds of 0.0 and -0.0: the Pallas kernel (XLA in interpret mode)
    reads a subnormal as a zero of its sign, so -1e-45 passes a 0.0 gate,
    and the plain version must gate the same."""
    band = next(b for b in FUSED_BANDS if b["n"] == 300)
    n, off, rev = band["n"], band["offsets"], band["revs"]
    args = hazard_fused_args(5, band, 64)
    rng = np.random.default_rng(6)
    args[4] = rng.choice(np.array([1e-45, -1e-45, 1e-40, -1e-40, -0.0, 0.0, -1.0, 1.0],
                                  np.float32), size=args[4].shape)
    static = dict(offsets=off, revs=rev, w=2, score_enabled=True, want_cohorts=True,
                  retrans_cap=3)
    ref = jfr.fused_delivery(*[jnp.asarray(a) for a in args], thr, thr,
                             block=jfr.pick_block(n, off), interpret=True, **static)
    got = tfr.fused_delivery(*[_t(a) for a in args], thr, thr, **static)
    assert sorted(ref) == sorted(got)
    for name in ref:
        np.testing.assert_array_equal(np.asarray(ref[name]), _u(got[name]), err_msg=name)


def test_make_flags_and_capped_mask_equal_reference():
    rng = np.random.default_rng(3)
    masks = [rng.random((N, 8)) < 0.5 for _ in range(5)]
    masks[2] = rng.random(N) < 0.5
    ref = jfr.make_flags(*[jnp.asarray(m) for m in masks])
    got = tfr.make_flags(*[torch.from_numpy(m) for m in masks])
    np.testing.assert_array_equal(np.asarray(ref), _u(got))
    lo, hi = _words(rng, N, 8), _words(rng, N, 8)
    for cap in (-1, 0, 1, 2, 3, 4):
        np.testing.assert_array_equal(
            np.asarray(jfr.served_capped_mask(cap, jnp.asarray(lo), jnp.asarray(hi))),
            _u(tfr.served_capped_mask(cap, _t(lo), _t(hi))), err_msg=str(cap))


def test_cpu_tensors_take_the_plain_version(band):
    off, rev, _ = band
    k = len(off)
    tfr.reset_launch_counts()
    rng = np.random.default_rng(4)
    tfr.edge_exchange(_t(_words(rng, N, k * C)), None,
                      _t(np.ones((N, k), np.uint32)), offsets=off, revs=rev,
                      c=C, score_enabled=False)
    assert tfr.LAUNCHES == {"edge_exchange": 0, "fused_delivery": 0}


@pytest.mark.cuda
def test_kernels_equal_plain_on_the_card(band):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    off, rev, _ = band
    k = len(off)
    rng = np.random.default_rng(5)
    wire, live = _words(rng, N, k * C), (rng.random((N, k)) < 0.8).astype(np.uint32)
    scores = _scores(rng, N, k)
    ref = tfr.edge_exchange_plain(_t(wire), _t(scores), _t(live), offsets=off,
                                  revs=rev, c=C, score_enabled=True)
    got = tfr.edge_exchange(_t(wire).cuda(), _t(scores).cuda(), _t(live).cuda(),
                            offsets=off, revs=rev, c=C, score_enabled=True)
    for a, b in zip(ref, got):
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))
    inp = _delivery_inputs(k, seed=9)
    names = ("carry_out", "fe_words", "fwd", "mcache_win", "nbr_score", "asked",
             "served_lo", "served_hi", "flags", "have", "origin_w", "joined_w",
             "valid_row")
    static = dict(offsets=off, revs=rev, w=W, score_enabled=True,
                  want_cohorts=True, retrans_cap=3)
    ref = tfr.fused_delivery_plain(*[_t(inp[nm]) for nm in names], -10.0, -50.0,
                                   **static)
    got = tfr.fused_delivery(*[_t(inp[nm]).cuda() for nm in names], -10.0, -50.0,
                             **static)
    for name in ref:
        assert torch.equal(ref[name], got[name].cpu()), name
