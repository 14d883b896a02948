"""The CSR half of the port's shared delivery round against the JAX
package (split from tests/test_torch_delivery.py, whose helpers it uses):

* ``csr_delivery_plain`` (ops/csr_delivery.py) against the three
  ``pallas_csr.csr_delivery`` kernels in interpret mode on ragged, banded
  and power-law nets and on the hazard graph, with the link-deny mask on
  and off;
* ``ops/csr``'s net faces, scans and relayouts, ``finish_delivery`` and
  ``finish_delivery_flat`` against their JAX twins.

Inputs are made with numpy from a seed and handed to both packages. Every
comparison is bitwise."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_delivery import _eq, _port_state, _random_banded, _t
from torch_parity import HAZARD_M, hazard_graph, hazard_planes

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu import topo as jtopo
from go_libp2p_pubsub_tpu.models import common as jcommon
from go_libp2p_pubsub_tpu.ops import bitset as jbs
from go_libp2p_pubsub_tpu.ops import csr as jcsr
from go_libp2p_pubsub_tpu.ops import pallas_csr as jpcsr
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch import topo as ttopo
from go_libp2p_pubsub_tpu_torch.models import common as tcommon
from go_libp2p_pubsub_tpu_torch.ops import csr as tcsr
from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as tcd
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import replace


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
            # jitted: one compile of each scan instead of one an op (integer
            # ops: the same bits either way)
            ri, rx = jax.jit(lambda a, f, c=c: jcsr.segment_or_scan(a, f, cap=c))(
                jnp.asarray(x), jnp.asarray(flags))
            gi, gx = tcsr.segment_or_scan(_t(x), torch.from_numpy(flags), cap=c)
            _eq(ri, gi, f"inc cap={c}")
            _eq(rx, gx, f"exc cap={c}")
        row = np.cumsum(flags).astype(np.int32) - 1
        n = int(row[-1]) + 2     # one trailing empty row
        row_last = np.maximum(np.searchsorted(row, np.arange(n), side="right") - 1,
                              0).astype(np.int32)
        nonempty = np.bincount(row, minlength=n) > 0
        _eq(jax.jit(lambda *a, cap=cap: jcsr.segment_or_words(*a, cap=cap))(
                jnp.asarray(x), jnp.asarray(flags), jnp.asarray(row_last),
                jnp.asarray(nonempty)),
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

    # the reference's bit algebra jitted: one compile of each tail instead of
    # an eager compile per op (integer ops: the same bits either way)
    trans = jnet.unpack_edges(jnp.asarray(trans_e))
    ref, rinfo = jax.jit(lambda *a: jcommon.finish_delivery(jnet, *a))(jmsgs, jdlv, trans,
                                                                      tick_j)
    got, ginfo = tcommon.finish_delivery(tnet, tmsgs, tdlv, _t(np.asarray(trans)), tick_t)
    for f in ("have", "fwd", "first_round", "fe_words"):
        _eq(getattr(ref, f), getattr(got, f), f"dense {f}")
    for c in ("n_rpc", "n_deliver", "n_reject", "n_duplicate"):
        assert int(getattr(rinfo, c)) == int(getattr(ginfo, c)), c

    jflat = jdlv.replace(fe_words=jnet.pack_edges(jdlv.fe_words))
    tflat = replace(tdlv, fe_words=tnet.pack_edges(tdlv.fe_words))
    ref, rinfo = jax.jit(lambda *a: jcommon.finish_delivery_flat(jnet, *a))(
        jmsgs, jflat, jnp.asarray(trans_e), tick_j)
    got, ginfo = tcommon.finish_delivery_flat(tnet, tmsgs, tflat, _t(trans_e), tick_t)
    for f in ("have", "fwd", "first_round", "fe_words"):
        _eq(getattr(ref, f), getattr(got, f), f"flat {f}")
    _eq(rinfo.trans, ginfo.trans, "flat trans")
    _eq(rinfo.recv_new_words, ginfo.recv_new_words, "recv_new_words")
    for c in ("n_rpc", "n_deliver", "n_reject", "n_duplicate", "n_drop"):
        assert int(getattr(rinfo, c)) == int(getattr(ginfo, c)), c
