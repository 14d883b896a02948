"""The port's shared delivery round and its two kernels' plain versions
against the JAX package.

* ``delivery_banded_plain`` (go_libp2p_pubsub_tpu_torch/ops/
  delivery_banded.py) against the TPU kernel ``delivery_round_banded``
  run in interpret mode, both directly and through ``delivery_round`` on
  random banded states with live and dead edges, directly on the hazard
  bands of tests/torch_parity.py, and against the JAX ``delivery_round``
  composite for the packed first-arrival plane.

The hazard bands with K = 16 and 24 run in
tests/test_torch_delivery_hazards.py, K = 40 in
tests/test_torch_delivery_hazards_wide.py, and the CSR half (``csr_delivery``,
``ops/csr``, ``finish_delivery`` and ``finish_delivery_flat``) in
tests/test_torch_delivery_csr.py, so that no file holds a loadfile worker
for more than its share of the suite.

Inputs are made with numpy from a seed and handed to both packages. Every
comparison is bitwise. On the CPU the wrappers take the plain versions;
tests/test_torch_kernels_cuda.py holds the CUDA kernels against them on
the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models import common as jcommon
from go_libp2p_pubsub_tpu.ops import bitset as jbs
from go_libp2p_pubsub_tpu.ops import fused_round as jfr
from go_libp2p_pubsub_tpu.ops.pallas_delivery import delivery_round_banded as jbanded
from go_libp2p_pubsub_tpu.state import Delivery as JDelivery
from go_libp2p_pubsub_tpu.state import MsgTable as JMsgTable
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models import common as tcommon
from go_libp2p_pubsub_tpu_torch.ops import bitset as tbs
from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as tdb
from go_libp2p_pubsub_tpu_torch.state import Delivery as TDelivery
from go_libp2p_pubsub_tpu_torch.state import MsgTable as TMsgTable
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import replace
from torch_parity import HAZARD_BAND_M, hazard_banded_args, hazard_bands


# the reference's bit helpers jitted: one compile a shape instead of an
# eager compile per op (integer ops: the same bits either way)
_edge_eq_words = jax.jit(jbs.edge_eq_words, static_argnums=1)
_first_edge_of = jax.jit(jbs.first_edge_of, static_argnums=1)
_pack = jax.jit(jbs.pack)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _eq(ref, got, msg=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    assert ref.dtype == got.dtype and ref.shape == got.shape, (msg, ref.dtype, got.dtype,
                                                              ref.shape, got.shape)
    np.testing.assert_array_equal(ref, got, err_msg=msg)


# ---------------------------------------------------------------------------
# banded: random states as tests/test_pallas.py builds them


def _random_banded(n, m, k, rng):
    """(JAX Delivery, JAX MsgTable, edge mask) with the padding bits of the
    last word clear and a one-hot first-arrival plane."""
    w = (m + 31) // 32

    def words(shape):
        flat = rng.integers(0, 2**32, size=shape + (w,), dtype=np.uint64).astype(np.uint32)
        if m % 32:
            flat[..., -1] &= np.uint32((1 << (m % 32)) - 1)
        return flat

    dlv = JDelivery(
        have=jnp.asarray(words((n,))), fwd=jnp.asarray(words((n,))),
        first_round=jnp.asarray(rng.integers(-1, 5, size=(n, m)).astype(np.int32)),
        fe_words=_edge_eq_words(
            jnp.asarray(rng.integers(-1, k, size=(n, m)).astype(np.int8)), k),
    )
    msgs = JMsgTable(
        topic=jnp.asarray(rng.integers(0, 2, size=(m,)).astype(np.int32)),
        origin=jnp.asarray(rng.integers(-1, n, size=(m,)).astype(np.int32)),
        birth=jnp.zeros((m,), jnp.int32), valid=jnp.asarray(rng.random(m) < 0.8),
        ignored=jnp.zeros((m,), bool), cursor=jnp.int32(0),
    )
    return dlv, msgs, words((n, k))


def _port_state(jdlv, jmsgs):
    dlv = TDelivery(have=_t(jdlv.have), fwd=_t(jdlv.fwd),
                    first_round=_t(jdlv.first_round), fe_words=_t(jdlv.fe_words))
    msgs = TMsgTable(topic=_t(jmsgs.topic), origin=_t(jmsgs.origin),
                     birth=_t(jmsgs.birth), valid=_t(jmsgs.valid),
                     ignored=_t(jmsgs.ignored),
                     cursor=torch.tensor(int(jmsgs.cursor), dtype=torch.int32))
    return dlv, msgs


@pytest.mark.parametrize("n,m,d,live_frac", [
    (64, 40, 4, 1.0), (32, 33, 3, 0.6), (48, 64, 8, 0.7),
])
def test_banded_round_equals_pallas_and_composite(n, m, d, live_frac):
    rng = np.random.default_rng(n + m + d)
    jnet = JNet.build(jgraph.ring_lattice(n, d=d), jgraph.subscribe_all(n, 1))
    tnet = TNet.build(tgraph.ring_lattice(n, d=d), tgraph.subscribe_all(n, 1), device="cpu")
    assert jnet.band_off == tnet.band_off and tnet.band_off is not None
    k = jnet.max_degree
    if live_frac < 1.0:
        live = rng.random((n, k)) < live_frac
        jnet = jnet.replace(nbr_ok=jnp.asarray(live))
        tnet = replace(tnet, nbr_ok=torch.from_numpy(live))
    tick = 3
    jdlv, jmsgs, emask = _random_banded(n, m, k, rng)
    args = (jmsgs, jdlv, jnp.asarray(emask), jnp.int32(tick))
    ref_p, info_p = jax.jit(lambda *a: jcommon._delivery_round_pallas(jnet, *a,
                                                                      interpret=True))(*args)
    ref_x, info_x = jax.jit(lambda *a: jcommon.delivery_round(jnet, *a))(*args)
    tdlv, tmsgs = _port_state(jdlv, jmsgs)
    tdb.reset_launch_counts()
    got, info = tcommon.delivery_round(tnet, tmsgs, tdlv, _t(emask),
                                       torch.tensor(tick, dtype=torch.int32))
    assert tdb.LAUNCHES["delivery_banded"] == 0   # CPU: the plain version
    for name in ("have", "fwd", "first_round", "first_edge"):
        _eq(getattr(ref_p, name), getattr(got, name), f"{name} vs pallas")
    _eq(ref_x.fe_words, got.fe_words, "fe_words vs composite")
    _eq(info_p.trans, info.trans, "trans")
    _eq(info_p.new_words, info.new_words, "new_words")
    _eq(info_x.new_bits, info.new_bits, "new_bits")
    for c in ("n_rpc", "n_deliver", "n_reject", "n_duplicate"):
        assert int(getattr(info_p, c)) == int(getattr(info, c)), c


def test_banded_plain_equals_the_tpu_kernel_directly():
    """The kernel-level call: delivery_banded_plain against
    delivery_round_banded on the same words (the TPU kernel's int8
    first-edge form converted with bitset.first_edge_of/edge_eq_words)."""
    n, m, d = 64, 64, 4
    rng = np.random.default_rng(7)
    jnet = JNet.build(jgraph.ring_lattice(n, d=d), jgraph.subscribe_all(n, 1))
    k, w = jnet.max_degree, 2
    jdlv, jmsgs, emask = _random_banded(n, m, k, rng)
    valid = jbs.pack(jmsgs.valid)
    ref = jbanded(jdlv.fwd, jbs.first_edge_of(jdlv.fe_words, m),
                  jnp.asarray(emask).reshape(n, k * w), jdlv.have, jdlv.first_round,
                  jmsgs.origin, valid, jnp.int32(9), block=16, m=m,
                  offsets=jnet.band_off, revs=jnet.band_rev, interpret=True)
    not_mine = ~jcommon.origin_msg_words(jnet, jmsgs)
    got = tdb.delivery_banded(
        _t(jdlv.fwd), _t(jdlv.fe_words).reshape(n, k * w), _t(emask).reshape(n, k * w),
        _t(not_mine), _t(jdlv.have), _t(jdlv.first_round), _t(valid)[None, :],
        torch.tensor(9, dtype=torch.int32), offsets=jnet.band_off,
        revs=jnet.band_rev, w=w)
    trans, have2, fwd2, fr2, fe2 = ref
    _eq(np.asarray(trans).reshape(n, k * w), got["trans"], "trans")
    _eq(have2, got["have"], "have")
    _eq(fwd2, got["fwd"], "fwd")
    _eq(fr2, got["first_round"], "first_round")
    _eq(fe2, tbs.first_edge_of(got["fe"].reshape(n, k, w), m), "first_edge")
    _eq(jbs.edge_eq_words(fe2, k).reshape(n, k * w), got["fe"], "fe words")
    _eq(np.asarray(have2) & ~np.asarray(jdlv.have), got["new"], "new")


def hazard_file(band) -> str:
    """Which file runs a hazard band's cases: here the bands with K <= 6
    (the circulant among them), ``hazards`` K = 16
    (tests/test_torch_delivery_hazards.py), ``wide`` K = 24 and 40
    (tests/test_torch_delivery_hazards_wide.py), so that each file stays
    within a loadfile worker's share of the suite."""
    k = len(band["offsets"])
    return "delivery" if k <= 6 else "hazards" if k <= 16 else "wide"


def hazard_cases(name: str) -> dict:
    """``parametrize`` keywords for the hazard bands that file ``name``
    runs."""
    bands = [b for b in hazard_bands() if hazard_file(b) == name]
    return dict(argvalues=bands, ids=[b["name"] for b in bands])


def check_banded_hazard(band, m):
    """The hazard bands of the card's delivery_banded tests
    (tests/torch_parity.hazard_bands): ring lattices with K = 2, 6, 16, 24
    and 40, N not a multiple of the kernel's block, N=17 under the staged
    window, a circulant with steps 333 and 500 = N/2, at W = 1, 2, 3 and
    10. delivery_banded_plain equals delivery_round_banded in interpret
    mode on a one-hot first-arrival plane and messages of random origins."""
    n, off, rev = band["n"], band["offsets"], band["revs"]
    k, w = len(off), (m + 31) // 32
    fwd, fe, emask, _nm, have, first_round, valid_row, tick = hazard_banded_args(
        m + k, band, m,
        first_edge=lambda fe8: np.asarray(_edge_eq_words(jnp.asarray(fe8), k)).reshape(n, k * w))
    origin = np.random.default_rng(n + m).integers(-1, n, size=m).astype(np.int32)
    not_mine = ~np.asarray(_pack(jnp.asarray(origin[None, :] == np.arange(n)[:, None])))
    block = jfr.pick_block(n, off) or n    # a halo past every block: one block of N
    trans, have2, fwd2, fr2, fe2 = jbanded(
        jnp.asarray(fwd), _first_edge_of(jnp.asarray(fe).reshape(n, k, w), m),
        jnp.asarray(emask), jnp.asarray(have), jnp.asarray(first_round), jnp.asarray(origin),
        jnp.asarray(valid_row[0]), jnp.int32(tick), block=block, m=m, offsets=off, revs=rev,
        interpret=True)
    got = tdb.delivery_banded(
        _t(fwd), _t(fe), _t(emask), _t(not_mine), _t(have), _t(first_round), _t(valid_row),
        torch.tensor(int(tick), dtype=torch.int32), offsets=off, revs=rev, w=w)
    at = f"{band['name']} M={m}"
    _eq(np.asarray(trans).reshape(n, k * w), got["trans"], f"{at} trans")
    _eq(have2, got["have"], f"{at} have")
    _eq(fwd2, got["fwd"], f"{at} fwd")
    _eq(fr2, got["first_round"], f"{at} first_round")
    _eq(_edge_eq_words(fe2, k).reshape(n, k * w), got["fe"], f"{at} fe words")
    _eq(np.asarray(have2) & ~have, got["new"], f"{at} new")


@pytest.mark.parametrize("band", **hazard_cases("delivery"))
@pytest.mark.parametrize("m", HAZARD_BAND_M)
def test_banded_plain_equals_the_tpu_kernel_on_hazard_bands(band, m):
    check_banded_hazard(band, m)


def test_first_edge_forms_equal_reference():
    rng = np.random.default_rng(2)
    for n, k, m in ((16, 8, 40), (8, 16, 64), (4, 128, 33)):
        fe8 = rng.integers(-1, k, size=(n, m)).astype(np.int8)
        words = jbs.edge_eq_words(jnp.asarray(fe8), k)
        _eq(words, tbs.edge_eq_words(torch.from_numpy(fe8), k), "edge_eq_words")
        raw = rng.integers(0, 2**32, size=(n, k, (m + 31) // 32),
                           dtype=np.uint64).astype(np.uint32)
        raw &= rng.integers(0, 2**32, size=raw.shape, dtype=np.uint64).astype(np.uint32)
        _eq(jbs.first_edge_of(jnp.asarray(raw), m), tbs.first_edge_of(_t(raw), m),
            "first_edge_of")


def test_unported_delivery_options_raise():
    tnet = TNet.build(tgraph.ring_lattice(16, d=2), tgraph.subscribe_all(16, 1),
                      device="cpu")
    rng = np.random.default_rng(0)
    jdlv, jmsgs, emask = _random_banded(16, 64, tnet.max_degree, rng)
    tdlv, tmsgs = _port_state(jdlv, jmsgs)
    tick = torch.tensor(1, dtype=torch.int32)
    # the forward gate is ported (tests/test_torch_forward_mask.py): it
    # leaves at most the mask in the forward set
    gated, _ = tcommon.delivery_round(tnet, tmsgs, tdlv, _t(emask), tick,
                                      forward_mask=_t(jdlv.have))
    assert torch.equal(gated.fwd & ~_t(jdlv.have), torch.zeros_like(gated.fwd))
    # the queue cap and the per-topic delays are ported: a cap of 4 leaves
    # at most 4 messages on a link, and a state without a pipeline takes
    # per-topic delays as inline validation
    plain = tcommon.delivery_round(tnet, tmsgs, tdlv, _t(emask), tick)
    _, capped = tcommon.delivery_round(tnet, tmsgs, tdlv, _t(emask), tick, queue_cap=4)
    assert int(tbs.popcount(capped.trans).max()) <= 4
    assert int(capped.n_drop) == int(plain[1].n_rpc) - int(capped.n_rpc)
    topical = tcommon.delivery_round(tnet, tmsgs, tdlv, _t(emask), tick, val_delay_topic=(1,))
    for f in ("have", "fwd", "first_round", "fe_words"):
        _eq(getattr(plain[0], f), getattr(topical[0], f), f)
    with pytest.raises(ValueError, match="max_degree"):
        tcommon.delivery_round(tnet, tmsgs, replace(tdlv, fe_words=tdlv.fe_words[:, :2]),
                               _t(emask), tick)
