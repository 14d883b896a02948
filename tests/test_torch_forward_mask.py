"""The shared delivery core's ``forward_mask`` against the JAX package.

``delivery_round(..., forward_mask=[N, W])`` gates what each receiver
re-forwards: its next ``fwd`` is ANDed with the mask, on every route. On a
banded net the mask takes the round off ``delivery_banded`` (the JAX
package's banded kernel refuses it) to the dense composite; on a
CSR-resident state ``csr_delivery`` still runs and the mask is ANDed into
the forward set it returns. Both packages take the same numpy-seeded
states, masks and edge masks on the lattice, a random dense net and
CSR-resident, and every output plane and counter must be equal bit for
bit."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_delivery import _eq, _port_state, _random_banded, _t

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models import common as jcommon
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models import common as tcommon
from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as tcd
from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as tdb
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import replace

N, M = 64, 40

NETS = {
    "lattice": lambda: (jgraph.ring_lattice(N, d=4), tgraph.ring_lattice(N, d=4), "dense"),
    "random": lambda: (jgraph.random_connect(N, d=3, seed=4),
                       tgraph.random_connect(N, d=3, seed=4), "dense"),
    "csr": lambda: (jgraph.random_connect(N, d=3, seed=4),
                    tgraph.random_connect(N, d=3, seed=4), "csr"),
    "csr_lattice": lambda: (jgraph.ring_lattice(N, d=4), tgraph.ring_lattice(N, d=4), "csr"),
}


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("net", sorted(NETS))
def test_forward_mask_equals_reference(net, with_mask, monkeypatch):
    jt, tt, layout = NETS[net]()
    kw = dict(edge_layout="csr", fused=True) if layout == "csr" else {}
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 1), **kw)
    tnet = TNet.build(tt, tgraph.subscribe_all(N, 1), device="cpu", **kw)
    rng = np.random.default_rng(7)
    jdlv, jmsgs, emask = _random_banded(N, M, tnet.max_degree, rng)
    fm = rng.integers(0, 2**32, size=(N, (M + 31) // 32), dtype=np.uint64).astype(np.uint32)
    tdlv, tmsgs = _port_state(jdlv, jmsgs)
    if layout == "csr":
        # CSR-resident: the first-arrival plane flat on both sides
        jdlv = jdlv.replace(fe_words=jnet.pack_edges(jdlv.fe_words))
        tdlv = replace(tdlv, fe_words=_t(np.asarray(jdlv.fe_words)))
    # the route: a mask leaves delivery_banded, and csr_delivery still runs
    calls = {"csr": 0}
    real_csr = tcd.csr_delivery

    def counted(*a, **k):
        calls["csr"] += 1
        return real_csr(*a, **k)

    monkeypatch.setattr(tcd, "csr_delivery", counted)
    if with_mask:
        def refuse(*a, **k):
            raise AssertionError("a forward mask reached delivery_banded")
        monkeypatch.setattr(tdb, "delivery_banded", refuse)
    tick = 3
    jd, ji = jcommon.delivery_round(jnet, jmsgs, jdlv, jnp.asarray(emask), jnp.int32(tick),
                                    forward_mask=jnp.asarray(fm) if with_mask else None)
    td, ti = tcommon.delivery_round(tnet, tmsgs, tdlv, _t(emask),
                                    torch.tensor(tick, dtype=torch.int32),
                                    forward_mask=_t(fm) if with_mask else None)
    assert calls["csr"] == (1 if layout == "csr" else 0)
    for f in ("have", "fwd", "first_round", "fe_words"):
        _eq(getattr(jd, f), getattr(td, f), f"{net} {f}")
    _eq(ji.trans, ti.trans, f"{net} trans")
    _eq(ji.new_words, ti.new_words, f"{net} new_words")
    for c in ("n_rpc", "n_deliver", "n_reject", "n_duplicate"):
        assert int(getattr(ji, c)) == int(getattr(ti, c)), c
    if with_mask:
        assert not (td.fwd & ~_t(fm)).any()
        assert (td.fwd != 0).any()


@pytest.mark.parametrize("resident", [True, False])
def test_finish_delivery_forms_gate_the_forward_set(resident):
    """``finish_delivery`` and ``finish_delivery_flat`` (the phase engine's
    and the CSR composites' commits) apply the mask as the JAX twins do."""
    jt, tt = jgraph.random_connect(N, d=3, seed=5), tgraph.random_connect(N, d=3, seed=5)
    jnet = JNet.build(jt, jgraph.subscribe_all(N, 1), edge_layout="csr", fused=True)
    tnet = TNet.build(tt, tgraph.subscribe_all(N, 1), edge_layout="csr", fused=True,
                      device="cpu")
    rng = np.random.default_rng(9)
    jdlv, jmsgs, _ = _random_banded(N, M, tnet.max_degree, rng)
    tdlv, tmsgs = _port_state(jdlv, jmsgs)
    w = (M + 31) // 32
    fm = rng.integers(0, 2**32, size=(N, w), dtype=np.uint64).astype(np.uint32)
    tick = jnp.int32(2)
    if resident:
        trans = rng.integers(0, 2**32, size=(int(tnet.n_edges), w),
                             dtype=np.uint64).astype(np.uint32)
        jdlv = jdlv.replace(fe_words=jnet.pack_edges(jdlv.fe_words))
        tdlv = replace(tdlv, fe_words=_t(np.asarray(jdlv.fe_words)))
        jd, _ = jcommon.finish_delivery_flat(jnet, jmsgs, jdlv, jnp.asarray(trans), tick,
                                             forward_mask=jnp.asarray(fm))
        td, _ = tcommon.finish_delivery_flat(tnet, tmsgs, tdlv, _t(trans),
                                             torch.tensor(2, dtype=torch.int32),
                                             forward_mask=_t(fm))
    else:
        trans = rng.integers(0, 2**32, size=(N, tnet.max_degree, w),
                             dtype=np.uint64).astype(np.uint32)
        jd, _ = jcommon.finish_delivery(jnet, jmsgs, jdlv, jnp.asarray(trans), tick,
                                        forward_mask=jnp.asarray(fm))
        td, _ = tcommon.finish_delivery(tnet, tmsgs, tdlv, _t(trans),
                                        torch.tensor(2, dtype=torch.int32),
                                        forward_mask=_t(fm))
    for f in ("have", "fwd", "first_round", "fe_words"):
        _eq(getattr(jd, f), getattr(td, f), f)
