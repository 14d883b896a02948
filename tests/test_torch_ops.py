"""The port's ops (bitset, edges, select), graph builders and Net against
the JAX package on random inputs made with numpy."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.ops import bitset as jbs
from go_libp2p_pubsub_tpu.ops import edges as jed
from go_libp2p_pubsub_tpu.ops import select as jsel
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import prng
from go_libp2p_pubsub_tpu_torch.ops import bitset as tbs
from go_libp2p_pubsub_tpu_torch.ops import edges as ted
from go_libp2p_pubsub_tpu_torch.ops import select as tsel
from go_libp2p_pubsub_tpu_torch.state import Net as TNet


def _words(rng, *shape, density=0.5):
    bits = rng.random(shape + (32,)) < density
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a).copy())


def _eq(ref, got, msg=""):
    ref = np.asarray(ref)
    got = got.numpy()
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype, msg)
    if ref.dtype.kind == "f":
        ref, got = ref.view(np.uint32), got.view(np.uint32)
    np.testing.assert_array_equal(ref, got, err_msg=msg)


# ---------------------------------------------------------------------------
# bitset


@pytest.mark.parametrize("m", [1, 31, 32, 33, 64, 70])
def test_pack_unpack_popcount(m):
    rng = np.random.default_rng(m)
    bits = rng.random((9, 5, m)) < 0.4
    bits[0] = False
    bits[1] = True
    words = jbs.pack(jnp.asarray(bits))
    _eq(words, tbs.pack(torch.from_numpy(bits)))
    w = np.asarray(words)
    _eq(jbs.unpack(jnp.asarray(w), m), tbs.unpack(_t(w), m))
    for axis in (None, -1, 1):
        _eq(jbs.popcount(jnp.asarray(w), axis=axis), tbs.popcount(_t(w), axis=axis))
    assert tbs.n_words(m) == jbs.n_words(m)


def test_lowest_bit_take_word_bit_get():
    rng = np.random.default_rng(2)
    w = _words(rng, 40, 3, density=0.05)
    w[0] = 0
    w[1, 0] = 0
    w[2] = np.uint32(0x80000000)
    ref_i, ref_a = jbs.lowest_bit(jnp.asarray(w))
    got_i, got_a = tbs.lowest_bit(_t(w))
    _eq(ref_i, got_i)
    _eq(ref_a, got_a)
    idx = rng.integers(-40, 100, size=(40,)).astype(np.int32)
    _eq(jbs.take_word(jnp.asarray(w), jnp.asarray(idx % 5 - 1)),
        tbs.take_word(_t(w), torch.from_numpy(idx % 5 - 1)))
    _eq(jbs.bit_get(jnp.asarray(w), jnp.asarray(idx)),
        tbs.bit_get(_t(w), torch.from_numpy(idx)))
    # the heartbeat's broadcast form: [N,1,W] words against [N,K] indices
    pm = rng.integers(-1, 96, size=(40, 16)).astype(np.int32)
    _eq(jbs.bit_get(jnp.asarray(w)[:, None, :], jnp.asarray(pm)),
        tbs.bit_get(_t(w)[:, None, :], torch.from_numpy(pm)))


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_or_reduce_first_set_masked_keep(dim):
    rng = np.random.default_rng(dim)
    w = _words(rng, 6, 5, 2, density=0.2)
    _eq(jbs.word_or_reduce(jnp.asarray(w), axis=dim), tbs.word_or_reduce(_t(w), dim))
    if dim == 1:
        _eq(jbs.first_set_per_bit(jnp.asarray(w), axis=1), tbs.first_set_per_bit(_t(w), 1))
    keep = _words(rng, 2)
    a, b = _words(rng, 6, 2), _words(rng, 6, 4, 2)
    ra, rb, rn = jbs.masked_keep([jnp.asarray(a), jnp.asarray(b), None], jnp.asarray(keep))
    ga, gb, gn = tbs.masked_keep([_t(a), _t(b), None], _t(keep))
    _eq(ra, ga)
    _eq(rb, gb)
    assert rn is None and gn is None


def test_prefix_cap_bits():
    rng = np.random.default_rng(5)
    w = _words(rng, 12, 16, 2, density=0.3)
    cap = rng.integers(-2, 40, size=(12, 16)).astype(np.int32)
    _eq(jbs.prefix_cap_bits(jnp.asarray(w), jnp.asarray(cap), 64),
        tbs.prefix_cap_bits(_t(w), torch.from_numpy(cap), 64))


@pytest.mark.parametrize("w_dim,m", [(1, 32), (1, 20), (2, 64), (2, 48), (3, 96),
                                     (3, 80), (10, 320), (10, 300)])
def test_keep_lowest_bits(w_dim, m):
    """Every form of the static-cap chain (one word, two words as one 64-bit
    number, the word chain past two, the cap > 64 form) against the JAX
    package: its prefix_cap_bits over caps 0..70 and m, its keep_lowest_bits
    at a few caps. Where m is not a multiple of 32 the last word's padding
    bits are set, which ``m`` must clear before the chain counts them."""
    rng = np.random.default_rng(w_dim * 1000 + m)
    caps = list(range(71)) + [m]
    for density in (0.0, 0.1, 0.5, 0.95):
        w = _words(rng, 9, w_dim, density=density)
        if m % 32:
            w[..., -1] |= np.uint32(0xFFFFFFFF) << np.uint32(m % 32)
        jw = jnp.asarray(w)
        ref = np.asarray(jbs.prefix_cap_bits(
            jnp.broadcast_to(jw, (len(caps),) + w.shape),
            jnp.asarray(np.array(caps, np.int32)[:, None].repeat(9, 1)), m))
        for i, cap in enumerate(caps):
            _eq(ref[i], tbs.keep_lowest_bits(_t(w), cap, m), (w_dim, m, density, cap))
        for cap in (0, 1, 3, 33, 64, 65):
            _eq(jbs.keep_lowest_bits(jw, cap, m), tbs.keep_lowest_bits(_t(w), cap, m),
                (w_dim, m, density, cap))


@pytest.mark.parametrize("w_dim,m,cap", [(1, 20, 2), (2, 64, 1), (2, 48, 3), (3, 80, 2),
                                         (10, 300, 4), (2, 64, 70)])
def test_keep_lowest_bits_by_row(w_dim, m, cap):
    """Per-row caps in [0, cap] (the IWANT merge's share of a link's queue
    budget) against the JAX package's prefix_cap_bits, the padding bits
    set, on every form of the chain."""
    rng = np.random.default_rng(w_dim * 100 + cap)
    for density in (0.1, 0.5, 0.95):
        w = _words(rng, 40, w_dim, density=density)
        if m % 32:
            w[..., -1] |= np.uint32(0xFFFFFFFF) << np.uint32(m % 32)
        rows = rng.integers(0, cap + 1, size=(40,)).astype(np.int32)
        _eq(jbs.prefix_cap_bits(jnp.asarray(w), jnp.asarray(rows), m),
            tbs.keep_lowest_bits(_t(w), cap, m, rows=torch.from_numpy(rows)),
            (w_dim, m, density, cap))


# ---------------------------------------------------------------------------
# graph, Net and edges


@pytest.mark.parametrize("n,d", [(64, 4), (96, 4), (40, 8), (7, 4)])
def test_ring_lattice_and_net(n, d):
    jt, tt = jgraph.ring_lattice(n, d=d), tgraph.ring_lattice(n, d=d)
    for f in ("nbr", "nbr_ok", "rev", "outbound", "degree"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)
    js, ts = jgraph.subscribe_all(n, 1), tgraph.subscribe_all(n, 1)
    for f in ("subscribed", "my_topics", "slot_of"):
        np.testing.assert_array_equal(getattr(js, f), getattr(ts, f), err_msg=f)
    jn = JNet.build(jt, js)
    tn = TNet.build(tt, ts, device="cpu")
    assert (jn.band_off, jn.band_rev) == (tn.band_off, tn.band_rev)
    for f in ("nbr", "nbr_ok", "rev", "outbound", "subscribed", "my_topics",
              "slot_of", "ip_group", "direct", "protocol"):
        _eq(getattr(jn, f), getattr(tn, f), f)
    np.testing.assert_array_equal(np.asarray(jn.edge_perm), tn.edge_perm.numpy())


def test_random_connect_and_general_gathers():
    jt, tt = jgraph.random_connect(50, d=3, seed=4), tgraph.random_connect(50, d=3, seed=4)
    for f in ("nbr", "nbr_ok", "rev", "outbound", "degree"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)
    jn = JNet.build(jt, jgraph.subscribe_all(50, 1))
    tn = TNet.build(tt, tgraph.subscribe_all(50, 1), device="cpu")
    assert jn.band_off is None and tn.band_off is None
    rng = np.random.default_rng(6)
    x = _words(rng, 50, tn.max_degree, 3)
    _eq(jn.edge_gather(jnp.asarray(x)), tn.edge_gather(_t(x)))
    v = _words(rng, 50, 2)
    _eq(jn.peer_gather(jnp.asarray(v)), tn.peer_gather(_t(v)))


def test_banded_gathers_and_topic_words():
    topo = jgraph.ring_lattice(48, d=4)
    off, rev = jed.detect_banded(topo.nbr, topo.rev, topo.nbr_ok)
    assert (off, rev) == ted.detect_banded(topo.nbr, topo.rev, topo.nbr_ok)
    rng = np.random.default_rng(7)
    x = _words(rng, 48, 8, 3)
    _eq(jed.edge_permute_banded(jnp.asarray(x), off, rev),
        ted.edge_permute_banded(_t(x), off, rev))
    perm = ted.build_edge_perm(topo.nbr, topo.rev, topo.nbr_ok)
    _eq(jed.edge_permute(jnp.asarray(x), jnp.asarray(perm)),
        ted.edge_permute(_t(x), torch.from_numpy(perm).long()))
    v = rng.normal(size=(48, 3)).astype(np.float32)
    _eq(jed.peer_gather_banded(jnp.asarray(v), off), ted.peer_gather_banded(_t(v), off))
    # topic words over a 40-topic universe (two words), slots with -1 pads
    my_topics = rng.integers(-1, 40, size=(48, 3)).astype(np.int32)
    xs = rng.random((48, 3, 8)) < 0.5
    packed = jed.topic_pack(jnp.asarray(xs), jnp.asarray(my_topics), 40)
    _eq(packed, ted.topic_pack(torch.from_numpy(xs), torch.from_numpy(my_topics), 40))
    pw = np.asarray(packed)
    _eq(jed.topic_unpack(jnp.asarray(pw), jnp.asarray(my_topics)),
        ted.topic_unpack(_t(pw), torch.from_numpy(my_topics)))


# ---------------------------------------------------------------------------
# select


def _tie_values(rng, shape):
    v = rng.choice(np.array([-1.5, -0.0, 0.0, 0.5, 2.0, 7.25], np.float32), size=shape)
    return v.astype(np.float32)


@pytest.mark.parametrize("use_key", [False, True])
def test_rank_desc_and_topk(use_key):
    rng = np.random.default_rng(8)
    shape = (30, 2, 16)
    vals = _tie_values(rng, shape)
    mask = rng.random(shape) < 0.6
    mask[0] = False   # empty rows
    jk = jax.random.fold_in(jax.random.key(3), 5) if use_key else None
    tk = prng.fold_in(prng.key(3), 5) if use_key else None
    _eq(jsel.rank_desc(jnp.asarray(vals), jnp.asarray(mask), jk),
        tsel.rank_desc(_t(vals), torch.from_numpy(mask), tk))
    ks = rng.integers(-2, 20, size=shape[:-1]).astype(np.int32)
    for k in (0, 1, 5, 16, 40, ks):
        kj = jnp.asarray(k) if isinstance(k, np.ndarray) else k
        kt = torch.from_numpy(k) if isinstance(k, np.ndarray) else k
        _eq(jsel.select_topk_mask(jnp.asarray(vals), jnp.asarray(mask), kj, jk),
            tsel.select_topk_mask(_t(vals), torch.from_numpy(mask), kt, tk), str(k))
        _eq(jsel.masked_width_topk(jnp.asarray(vals), jnp.asarray(mask), kj, 16, key=jk),
            tsel.masked_width_topk(_t(vals), torch.from_numpy(mask), kt, 16, key=tk))


def test_random_selection_median_count():
    rng = np.random.default_rng(9)
    shape = (25, 1, 16)
    mask = rng.random(shape) < 0.5
    mask[:3] = False
    width = rng.integers(-1, 20, size=shape[:-1]).astype(np.int32)
    jk, tk = jax.random.key(11), prng.key(11)
    _eq(jsel.select_random_mask(jk, jnp.asarray(mask), jnp.asarray(width)),
        tsel.select_random_mask(tk, torch.from_numpy(mask), torch.from_numpy(width)))
    _eq(jsel.masked_width_random(jk, jnp.asarray(mask), jnp.asarray(width), 16),
        tsel.masked_width_random(tk, torch.from_numpy(mask), torch.from_numpy(width), 16))
    vals = _tie_values(rng, shape)
    _eq(jsel.median_masked(jnp.asarray(vals), jnp.asarray(mask)) + 0.0,
        tsel.median_masked(_t(vals), torch.from_numpy(mask)) + 0.0)
    _eq(jsel.count_true(jnp.asarray(mask)), tsel.count_true(torch.from_numpy(mask)))
