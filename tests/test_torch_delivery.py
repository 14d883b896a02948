"""The port's shared delivery round and its two kernels' plain versions
against the JAX package.

* ``delivery_banded_plain`` (go_libp2p_pubsub_tpu_torch/ops/
  delivery_banded.py) against the TPU kernel ``delivery_round_banded``
  run in interpret mode, both directly and through ``delivery_round`` on
  random banded states with live and dead edges, directly on the hazard
  bands of tests/torch_parity.py, and against the JAX ``delivery_round``
  composite for the packed first-arrival plane.
* ``csr_delivery_plain`` (ops/csr_delivery.py) against the three
  ``pallas_csr.csr_delivery`` kernels in interpret mode on ragged, banded
  and power-law nets, with the link-deny mask on and off.
* ``ops/csr``'s scans and relayouts, ``finish_delivery`` and
  ``finish_delivery_flat`` against their JAX twins.

Inputs are made with numpy from a seed and handed to both packages. Every
comparison is bitwise. On the CPU the wrappers take the plain versions;
tests/test_torch_kernels_cuda.py holds the CUDA kernels against them on
the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.models import common as jcommon
from go_libp2p_pubsub_tpu.ops import bitset as jbs
from go_libp2p_pubsub_tpu.ops import csr as jcsr
from go_libp2p_pubsub_tpu.ops import fused_round as jfr
from go_libp2p_pubsub_tpu.ops import pallas_csr as jpcsr
from go_libp2p_pubsub_tpu.ops.pallas_delivery import delivery_round_banded as jbanded
from go_libp2p_pubsub_tpu.state import Delivery as JDelivery
from go_libp2p_pubsub_tpu.state import MsgTable as JMsgTable
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.models import common as tcommon
from go_libp2p_pubsub_tpu_torch.ops import bitset as tbs
from go_libp2p_pubsub_tpu_torch.ops import csr as tcsr
from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as tcd
from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as tdb
from go_libp2p_pubsub_tpu_torch.state import Delivery as TDelivery
from go_libp2p_pubsub_tpu_torch.state import MsgTable as TMsgTable
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import replace
from torch_parity import (
    HAZARD_BAND_M,
    HAZARD_M,
    hazard_banded_args,
    hazard_bands,
    hazard_graph,
    hazard_planes,
)


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
        fe_words=jbs.edge_eq_words(
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
    ref_p, info_p = jcommon._delivery_round_pallas(
        jnet, jmsgs, jdlv, jnp.asarray(emask), jnp.int32(tick), interpret=True)
    ref_x, info_x = jcommon.delivery_round(jnet, jmsgs, jdlv, jnp.asarray(emask),
                                           jnp.int32(tick))
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


@pytest.mark.parametrize("band", hazard_bands(), ids=[b["name"] for b in hazard_bands()])
@pytest.mark.parametrize("m", HAZARD_BAND_M)
def test_banded_plain_equals_the_tpu_kernel_on_hazard_bands(band, m):
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
        first_edge=lambda fe8: np.asarray(jbs.edge_eq_words(jnp.asarray(fe8), k)).reshape(n, k * w))
    origin = np.random.default_rng(n + m).integers(-1, n, size=m).astype(np.int32)
    not_mine = ~np.asarray(jbs.pack(jnp.asarray(origin[None, :] == np.arange(n)[:, None])))
    block = jfr.pick_block(n, off) or n    # a halo past every block: one block of N
    trans, have2, fwd2, fr2, fe2 = jbanded(
        jnp.asarray(fwd), jbs.first_edge_of(jnp.asarray(fe).reshape(n, k, w), m),
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
    _eq(jbs.edge_eq_words(fe2, k).reshape(n, k * w), got["fe"], f"{at} fe words")
    _eq(np.asarray(have2) & ~have, got["new"], f"{at} new")


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


# ---------------------------------------------------------------------------
# CSR: the nets of tests/test_pallas_csr.py


def _nets(kind):
    if kind == "ragged":
        jt, tt = jgraph.random_connect(96, d=4, seed=2), tgraph.random_connect(96, d=4, seed=2)
    elif kind == "banded":
        jt, tt = jgraph.ring_lattice(64, d=8), tgraph.ring_lattice(64, d=8)
    else:
        jt = jtopo.to_topology(jtopo.powerlaw(128, 2.2, 2, 16, seed=0), max_degree=16)
        tt = ttopo.to_topology(ttopo.powerlaw(128, 2.2, 2, 16, seed=0), max_degree=16)
    n = jt.n_peers
    jnet = JNet.build(jt, jgraph.subscribe_all(n, 1), edge_layout="csr", fused=True)
    tnet = TNet.build(tt, tgraph.subscribe_all(n, 1), edge_layout="csr", fused=True,
                      device="cpu")
    return jnet, tnet


def _csr_args(net):
    """The index planes of a port CSR net, in csr_delivery's order."""
    return (net.csr_col, net.csr_row, net.csr_eperm, net.csr_seg_start,
            net.csr_row_last, net.csr_row_nonempty, net.csr_row_ptr)


def _rand_flat(rng, n, k, e, m):
    w = (m + 31) // 32
    u32 = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return {
        "fwd": u32(n, w), "fe_e": u32(e, w), "edge_mask": u32(n, k, w),
        "not_mine": u32(n, w), "have": u32(n, w),
        "first_round": rng.integers(-1, 50, size=(n, m)).astype(np.int32),
        "valid": rng.random(m) < 0.8,
    }


@pytest.mark.parametrize("kind", ["ragged", "banded", "powerlaw"])
@pytest.mark.parametrize("deny", [False, True])
def test_csr_plain_equals_pallas_csr(kind, deny):
    jnet, tnet = _nets(kind)
    e, cap, n = jnet.n_edges, jnet.max_degree, jnet.n_peers
    assert tnet.n_edges == e
    block = jcommon._pick_div(e, cap, 256)
    block_rows = jcommon._pick_div(n, 1, 256)
    rng = np.random.default_rng({"ragged": 1, "banded": 2, "powerlaw": 3}[kind] * 2 + deny)
    m = 32
    p = _rand_flat(rng, n, cap, e, m)
    link_ok = rng.random(e) < 0.7 if deny else None
    valid = jbs.pack(jnp.asarray(p["valid"]))
    ref = jpcsr.csr_delivery(
        jnp.asarray(p["fwd"]), jnp.asarray(p["fe_e"]),
        jnet.pack_edges(jnp.asarray(p["edge_mask"])), jnp.asarray(p["not_mine"]),
        jnp.asarray(p["have"]), jnp.asarray(p["first_round"]), valid[None, :],
        jnp.int32(7), jnet.csr_col, jnet.csr_row, jnet.csr_eperm, jnet.csr_seg_start,
        jnet.csr_row_last, jnet.csr_row_nonempty, cap=cap, block=block,
        block_rows=block_rows, interpret=True,
        link_ok_e=None if link_ok is None else jnp.asarray(link_ok))
    tcd.reset_launch_counts()
    got = tcd.csr_delivery(
        _t(p["fwd"]), _t(p["fe_e"]), tnet.pack_edges(_t(p["edge_mask"])),
        _t(p["not_mine"]), _t(p["have"]), _t(p["first_round"]), _t(valid)[None, :],
        torch.tensor(7, dtype=torch.int32), *_csr_args(tnet), cap=cap,
        link_ok_e=None if link_ok is None else torch.from_numpy(link_ok))
    assert tcd.LAUNCHES["csr_delivery"] == 0
    assert sorted(ref) == sorted(got) == sorted(tcd.OUTPUTS)
    for key in ref:
        _eq(ref[key], got[key], f"{kind} deny={deny} {key}")


def _hazard_call(g, p, deny, *, jax_side):
    """csr_delivery's arguments for the hazard graph ``g`` and the planes
    ``p``, as JAX arrays or port tensors."""
    as_arr = jnp.asarray if jax_side else _t
    words = ("fwd", "fe_e", "mask_e", "not_mine", "have", "first_round", "valid_row")
    tick = jnp.int32(p["tick"]) if jax_side else torch.tensor(int(p["tick"]), dtype=torch.int32)
    idx = [as_arr(g[f]) for f in ("col", "row", "eperm", "seg_start", "row_last",
                                  "row_nonempty")]
    link = as_arr(p["link_ok_e"]) if deny else None
    return [as_arr(p[f]) for f in words] + [tick] + idx, link


@pytest.mark.parametrize("m,long_row", [(m, 0) for m in HAZARD_M] + [(64, 200)])
@pytest.mark.parametrize("deny", [False, True])
def test_csr_plain_equals_pallas_csr_on_hazard_graph(m, deny, long_row):
    """The hazard graph of the card's csr_delivery tests (empty rows, rows
    of 1, 31, 32, 33 and 64 edges, runs of long rows, rows on both sides of
    every warp boundary, N=300; with ``long_row`` one row of 200 edges),
    W = 1, 2, 3 and the deny mask off and on: the port's plain version
    equals the three Pallas kernels in interpret mode on every output."""
    g = hazard_graph(long_row=long_row)
    n, e, cap = g["n"], g["e"], g["cap"]
    p = hazard_planes(m + deny, n, e, m)
    args, link = _hazard_call(g, p, deny, jax_side=True)
    ref = jpcsr.csr_delivery(*args, cap=cap, block=jcommon._pick_div(e, cap, 256),
                             block_rows=jcommon._pick_div(n, 1, 256), interpret=True,
                             link_ok_e=link)
    args, link = _hazard_call(g, p, deny, jax_side=False)
    got = tcd.csr_delivery(*args, _t(g["row_ptr"]), cap=cap, link_ok_e=link)
    assert sorted(ref) == sorted(got) == sorted(tcd.OUTPUTS)
    for key in ref:
        _eq(ref[key], got[key], f"M={m} deny={deny} long_row={long_row} {key}")


@pytest.mark.parametrize("kind", ["ragged", "powerlaw"])
def test_csr_net_faces_equal_reference(kind):
    jnet, tnet = _nets(kind)
    for f in ("csr_col", "csr_row", "csr_eperm", "csr_e_of_nk", "csr_seg_start",
              "csr_row_last", "csr_row_nonempty"):
        _eq(getattr(jnet, f), getattr(tnet, f), f)
    n, k, e = jnet.n_peers, jnet.max_degree, jnet.n_edges
    _eq(jnet.csr_e2nk, tnet.csr_row * k + tnet.csr_slot, "e2nk = row*K + slot")
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 32, size=(n, k, 2), dtype=np.uint64).astype(np.uint32)
    xe = rng.integers(0, 1 << 32, size=(e, 2), dtype=np.uint64).astype(np.uint32)
    v = rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint64).astype(np.uint32)
    _eq(jnet.pack_edges(jnp.asarray(x)), tnet.pack_edges(_t(x)), "pack_edges")
    # a broadcast view packs without a copy and gives the same rows
    _eq(jnet.pack_edges(jnp.broadcast_to(jnp.asarray(v)[:, None, :], (n, k, 2))),
        tnet.pack_edges(_t(v)[:, None, :].expand(n, k, 2)), "pack_edges broadcast")
    _eq(jnet.unpack_edges(jnp.asarray(xe)), tnet.unpack_edges(_t(xe)), "unpack_edges")
    _eq(jnet.edge_gather_flat(jnp.asarray(xe)), tnet.edge_gather_flat(_t(xe)), "eperm")
    _eq(jnet.owner_gather(jnp.asarray(v)), tnet.owner_gather(_t(v)), "owner")
    _eq(jnet.peer_gather_flat(jnp.asarray(v)), tnet.peer_gather_flat(_t(v)), "col")
    # the dense-form gathers of a CSR net equal the reference's too
    _eq(jnet.peer_gather(jnp.asarray(v)), tnet.peer_gather(_t(v)), "peer_gather")
    _eq(jnet.edge_gather(jnp.asarray(x)), tnet.edge_gather(_t(x)), "edge_gather")


def test_segment_reductions_equal_reference():
    rng = np.random.default_rng(11)
    e = 120   # one shape: the reference's eager ops compile once per shape
    for cap in (1, 5, 17):
        flags = np.zeros(e, bool)
        i = 0
        while i < e:
            flags[i] = True
            i += int(rng.integers(1, cap + 1))
        x = rng.integers(0, 1 << 32, size=(e, 2), dtype=np.uint64).astype(np.uint32)
        for c in (None, cap):
            ri, rx = jcsr.segment_or_scan(jnp.asarray(x), jnp.asarray(flags), cap=c)
            gi, gx = tcsr.segment_or_scan(_t(x), torch.from_numpy(flags), cap=c)
            _eq(ri, gi, f"inc cap={c}")
            _eq(rx, gx, f"exc cap={c}")
        row = np.cumsum(flags).astype(np.int32) - 1
        n = int(row[-1]) + 2     # one trailing empty row
        row_last = np.maximum(np.searchsorted(row, np.arange(n), side="right") - 1,
                              0).astype(np.int32)
        nonempty = np.bincount(row, minlength=n) > 0
        _eq(jcsr.segment_or_words(jnp.asarray(x), jnp.asarray(flags),
                                  jnp.asarray(row_last), jnp.asarray(nonempty), cap=cap),
            tcsr.segment_or_words(_t(x), torch.from_numpy(flags), _t(row_last),
                                  torch.from_numpy(nonempty), cap=cap), "or_words")
        vals = rng.integers(-50, 50, size=(e,)).astype(np.int32)
        _eq(jcsr.segment_sum_edges(jnp.asarray(vals), jnp.asarray(row), n),
            tcsr.segment_sum_edges(_t(vals), _t(row), n), "segment_sum")


@pytest.mark.parametrize("fused", [False, True])
def test_finish_delivery_tails_equal_reference(fused):
    """finish_delivery (dense [N, K, W] transmit tensor) and
    finish_delivery_flat (flat [E, W]) on the same random transmit words."""
    jt = jtopo.to_topology(jtopo.powerlaw(96, 2.2, 2, 16, seed=1), max_degree=16)
    tt = ttopo.to_topology(ttopo.powerlaw(96, 2.2, 2, 16, seed=1), max_degree=16)
    n, m = 96, 64
    jnet = JNet.build(jt, jgraph.subscribe_all(n, 1), edge_layout="csr", fused=fused)
    tnet = TNet.build(tt, tgraph.subscribe_all(n, 1), edge_layout="csr", fused=fused,
                      device="cpu")
    rng = np.random.default_rng(5)
    k, e = jnet.max_degree, jnet.n_edges
    jdlv, jmsgs, _ = _random_banded(n, m, k, rng)
    trans_e = rng.integers(0, 1 << 32, size=(e, 2), dtype=np.uint64).astype(np.uint32)
    trans_e &= rng.integers(0, 1 << 32, size=(e, 2), dtype=np.uint64).astype(np.uint32)
    tdlv, tmsgs = _port_state(jdlv, jmsgs)
    tick_j, tick_t = jnp.int32(4), torch.tensor(4, dtype=torch.int32)

    trans = jnet.unpack_edges(jnp.asarray(trans_e))
    ref, rinfo = jcommon.finish_delivery(jnet, jmsgs, jdlv, trans, tick_j)
    got, ginfo = tcommon.finish_delivery(tnet, tmsgs, tdlv, _t(np.asarray(trans)), tick_t)
    for f in ("have", "fwd", "first_round", "fe_words"):
        _eq(getattr(ref, f), getattr(got, f), f"dense {f}")
    for c in ("n_rpc", "n_deliver", "n_reject", "n_duplicate"):
        assert int(getattr(rinfo, c)) == int(getattr(ginfo, c)), c

    jflat = jdlv.replace(fe_words=jnet.pack_edges(jdlv.fe_words))
    tflat = replace(tdlv, fe_words=tnet.pack_edges(tdlv.fe_words))
    ref, rinfo = jcommon.finish_delivery_flat(jnet, jmsgs, jflat, jnp.asarray(trans_e), tick_j)
    got, ginfo = tcommon.finish_delivery_flat(tnet, tmsgs, tflat, _t(trans_e), tick_t)
    for f in ("have", "fwd", "first_round", "fe_words"):
        _eq(getattr(ref, f), getattr(got, f), f"flat {f}")
    _eq(rinfo.trans, ginfo.trans, "flat trans")
    _eq(rinfo.recv_new_words, ginfo.recv_new_words, "recv_new_words")
    for c in ("n_rpc", "n_deliver", "n_reject", "n_duplicate", "n_drop"):
        assert int(getattr(rinfo, c)) == int(getattr(ginfo, c)), c


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
