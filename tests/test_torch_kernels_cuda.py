"""The port's kernels against their plain versions on the card: the
GossipSub data plane (edge_exchange, fused_delivery), the delivery kernels
(delivery_banded, csr_delivery) and the heartbeat's select_topk.

This file imports only the port (no JAX package), so it also runs on a
machine that has PyTorch with CUDA and nothing of the JAX stack:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Each test skips when no CUDA device is present. The plain versions are
held against the JAX package on the CPU in tests/test_torch_fused_round.py
(and _hazards), tests/test_torch_delivery.py (and _csr, _hazards,
_hazards_wide) and tests/test_torch_select.py, on the same
hazard inputs (tests/torch_parity.py).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import graph, topo
from go_libp2p_pubsub_tpu_torch.ops import bitset
from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as cd
from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as db
from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk
from go_libp2p_pubsub_tpu_torch.state import Net
from torch_parity import (
    FUSED_CONFIGS,
    HAZARD_BAND_M,
    HAZARD_C,
    HAZARD_K,
    HAZARD_M,
    hazard_banded_args,
    dead_peers_live,
    hazard_bands,
    hazard_exchange_args,
    hazard_fused_args,
    hazard_graph,
    hazard_planes,
    hazard_rows,
    with_dead_peers,
)

BANDS = hazard_bands()
FUSED_BANDS = [b for b in BANDS if len(b["offsets"]) <= fr.MAX_K]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _words(rng, *shape):
    return torch.from_numpy(
        rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32))


def _equal_on_card(plain, kernel, args, kw, cuda, counter, name):
    ref = plain(*args, **kw)
    on_card = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    counter[name] = 0
    got = kernel(*[a.to(cuda) for a in args], **on_card)
    torch.cuda.synchronize()
    assert counter[name] == 1
    assert sorted(ref) == sorted(got)
    for key in ref:
        assert torch.equal(ref[key], got[key].cpu()), key


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,m", [(256, 8, 64), (100, 3, 40)])
def test_delivery_banded_kernel_equals_plain(cuda, n, d, m):
    net = Net.build(graph.ring_lattice(n, d=d), graph.subscribe_all(n, 1), device="cpu")
    k, w = net.max_degree, bitset.n_words(m)
    rng = np.random.default_rng(n + m)
    args = [_words(rng, n, w), _words(rng, n, k * w), _words(rng, n, k * w),
            _words(rng, n, w), _words(rng, n, w),
            torch.from_numpy(rng.integers(-1, 9, size=(n, m)).astype(np.int32)),
            _words(rng, 1, w), torch.tensor(5, dtype=torch.int32)]
    _equal_on_card(db.delivery_banded_plain, db.delivery_banded, args,
                   dict(offsets=net.band_off, revs=net.band_rev, w=w), cuda,
                   db.LAUNCHES, "delivery_banded")


def _np_tensor(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32 else a))


@pytest.mark.cuda
@pytest.mark.parametrize("band", BANDS, ids=[b["name"] for b in BANDS])
@pytest.mark.parametrize("m", HAZARD_BAND_M)
def test_delivery_banded_kernel_on_hazard_bands(cuda, band, m):
    """tests/torch_parity.hazard_bands: ring lattices with K = 2, 6, 16, 24
    and 40 (past one 32-edge chunk), N not a multiple of the 64-row block,
    N=17 under a staged window of 33 rows, a circulant whose steps 333 and
    500 = N/2 lie beyond the halo (the global-memory path), at W = 1, 2, 3
    and 10 (two word blocks)."""
    args = [_np_tensor(a) for a in hazard_banded_args(m, band, m)]
    args[7] = torch.tensor(int(args[7]), dtype=torch.int32)
    _equal_on_card(db.delivery_banded_plain, db.delivery_banded, args,
                   dict(offsets=band["offsets"], revs=band["revs"], w=(m + 31) // 32), cuda,
                   db.LAUNCHES, "delivery_banded")


def _fused_on_card(cuda, band, m, seed, score_enabled, want_cohorts, retrans_cap):
    args = [_np_tensor(a) for a in hazard_fused_args(seed, band, m)]
    if not score_enabled:
        args[4] = None
    kw = dict(offsets=band["offsets"], revs=band["revs"], w=(m + 31) // 32,
              score_enabled=score_enabled, want_cohorts=want_cohorts, retrans_cap=retrans_cap)
    ref = fr.fused_delivery_plain(*args, -10.0, -50.0, **kw)
    fr.LAUNCHES["fused_delivery"] = 0
    got = fr.fused_delivery(*[None if a is None else a.to(cuda) for a in args], -10.0, -50.0,
                            **kw)
    torch.cuda.synchronize()
    assert fr.LAUNCHES["fused_delivery"] == 1
    assert sorted(ref) == sorted(got)
    for key in ref:
        assert torch.equal(ref[key], got[key].cpu()), (band["name"], m, key)


@pytest.mark.cuda
@pytest.mark.parametrize("config", FUSED_CONFIGS,
                         ids=[f"score={s}-cohorts={c}-cap={r}" for s, c, r in FUSED_CONFIGS])
def test_fused_delivery_kernel_equals_plain(cuda, config):
    """The bench's layout (ring lattice d=8: K=16, W=2) on random words, at
    every retrans_cap 0-3, the cohort planes on and off, scores on and off."""
    band = next(b for b in BANDS if b["name"] == "ring N=1000 K=16")
    _fused_on_card(cuda, band, 64, 5, *config)


@pytest.mark.cuda
@pytest.mark.parametrize("band", FUSED_BANDS, ids=[b["name"] for b in FUSED_BANDS])
@pytest.mark.parametrize("m", HAZARD_BAND_M)
def test_fused_delivery_kernel_on_hazard_bands(cuda, band, m):
    """The hazard bands with K <= 16 at W = 1, 2, 3 and 10, each under every
    config of FUSED_CONFIGS: scores on the thresholds, at -0.0 and at
    subnormals, every pattern of the five flag bits."""
    for i, config in enumerate(FUSED_CONFIGS):
        _fused_on_card(cuda, band, m, m + i, *config)


@pytest.mark.cuda
@pytest.mark.parametrize("band", FUSED_BANDS, ids=[b["name"] for b in FUSED_BANDS])
@pytest.mark.parametrize("score_enabled", [True, False])
def test_edge_exchange_kernel_equals_plain(cuda, band, score_enabled):
    n, k, c = band["n"], len(band["offsets"]), 4
    rng = np.random.default_rng(n + k)
    wire = _words(rng, n, k * c)
    scores = torch.from_numpy(rng.normal(0.0, 20.0, size=(n, k)).astype(np.float32))
    live = torch.from_numpy((rng.random((n, k)) < 0.8).astype(np.int32))
    kw = dict(offsets=band["offsets"], revs=band["revs"], c=c, score_enabled=score_enabled)
    ref = fr.edge_exchange_plain(wire, scores, live, **kw)
    fr.LAUNCHES["edge_exchange"] = 0
    got = fr.edge_exchange(wire.to(cuda), scores.to(cuda), live.to(cuda), **kw)
    torch.cuda.synchronize()
    assert fr.LAUNCHES["edge_exchange"] == 1
    for a, b in zip(ref, got):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("band", FUSED_BANDS, ids=[b["name"] for b in FUSED_BANDS])
@pytest.mark.parametrize("c", HAZARD_C)
def test_edge_exchange_kernel_on_hazard_bands(cuda, band, c):
    """The hazard bands at C = 1 to 7 words a slot (the 4-, 8- and 16-byte
    word forms; the PX widths 5 and 7 with a symmetric live mask), dead
    edges, scores holding -0.0, subnormals of
    both signs and NaN (copied bit for bit), scores on and off, and from
    wire planes one word into their storage (not 8- or 16-byte aligned:
    the 4-byte form)."""
    n, k = band["n"], len(band["offsets"])
    wire, scores, live = (_np_tensor(a) for a in hazard_exchange_args(n + c, band, c))
    kw = dict(offsets=band["offsets"], revs=band["revs"], c=c)
    shifted = torch.zeros(n * k * c + 1, dtype=torch.int32, device=cuda)
    shifted[1:] = wire.view(-1).to(cuda)
    for on_card_wire, score_enabled in ((wire.to(cuda), True), (wire.to(cuda), False),
                                        (shifted[1:].view(n, k * c), True)):
        ref = fr.edge_exchange_plain(wire, scores, live, score_enabled=score_enabled, **kw)
        fr.LAUNCHES["edge_exchange"] = 0
        got = fr.edge_exchange(on_card_wire, scores.to(cuda), live.to(cuda),
                               score_enabled=score_enabled, **kw)
        torch.cuda.synchronize()
        assert fr.LAUNCHES["edge_exchange"] == 1
        assert (ref[1] is None) == (got[1] is None) == (not score_enabled)
        for a, b in zip(ref, got):
            if a is not None:
                assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("band", FUSED_BANDS, ids=[b["name"] for b in FUSED_BANDS])
def test_fused_kernels_with_dead_peers(cuda, band):
    """A churn round's live mask on the hazard bands: a tenth of the peers
    down, their rows and mirrored columns dead (tests/torch_parity.
    dead_peers_live). edge_exchange at every C with scores, and
    fused_delivery under every FUSED_CONFIGS entry with F_LIVE cleared
    there, equal their plain versions bit for bit."""
    n = band["n"]
    live = torch.from_numpy(dead_peers_live(n, band).view(np.int32))
    assert int((live == 0).sum()) > 0
    for c in HAZARD_C:
        wire, scores, _live = (_np_tensor(a) for a in hazard_exchange_args(n + c, band, c))
        kw = dict(offsets=band["offsets"], revs=band["revs"], c=c, score_enabled=True)
        ref = fr.edge_exchange_plain(wire, scores, live, **kw)
        got = fr.edge_exchange(wire.to(cuda), scores.to(cuda), live.to(cuda), **kw)
        torch.cuda.synchronize()
        for a, b in zip(ref, got):
            assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32)), c
    for i, (score, cohorts, cap) in enumerate(FUSED_CONFIGS):
        args = [_np_tensor(a) for a in hazard_fused_args(n + i, band, 64)]
        args[8] = torch.from_numpy(with_dead_peers(n, band, args[8].numpy()))
        if not score:
            args[4] = None
        kw = dict(offsets=band["offsets"], revs=band["revs"], w=2, score_enabled=score,
                  want_cohorts=cohorts, retrans_cap=cap)
        ref = fr.fused_delivery_plain(*args, -10.0, -50.0, **kw)
        got = fr.fused_delivery(*[None if a is None else a.to(cuda) for a in args], -10.0,
                                -50.0, **kw)
        torch.cuda.synchronize()
        for key in ref:
            assert torch.equal(ref[key], got[key].cpu()), (i, key)


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, -0.0])
def test_fused_delivery_kernel_reads_subnormal_scores_as_zeros(cuda, thr):
    """Neighbour scores of +-1e-45 and +-1e-40 at gossip and publish
    thresholds of 0.0 and -0.0: the kernel gates a subnormal as a zero of
    its sign, as its plain version does (and the JAX package's platforms)."""
    band = next(b for b in BANDS if b["name"] == "ring N=300 K=6")
    args = [_np_tensor(a) for a in hazard_fused_args(5, band, 64)]
    rng = np.random.default_rng(6)
    args[4] = torch.from_numpy(rng.choice(
        np.array([1e-45, -1e-45, 1e-40, -1e-40, -0.0, 0.0, -1.0, 1.0], np.float32),
        size=tuple(args[4].shape)))
    kw = dict(offsets=band["offsets"], revs=band["revs"], w=2, score_enabled=True,
              want_cohorts=True, retrans_cap=3)
    ref = fr.fused_delivery_plain(*args, thr, thr, **kw)
    got = fr.fused_delivery(*[a.to(cuda) for a in args], thr, thr, **kw)
    torch.cuda.synchronize()
    for key in ref:
        assert torch.equal(ref[key], got[key].cpu()), key


@pytest.mark.cuda
@pytest.mark.parametrize("deny", [False, True])
def test_csr_delivery_kernel_equals_plain(cuda, deny):
    n, m = 512, 64
    net = Net.build(topo.to_topology(topo.powerlaw(n, 2.2, 2, 64, seed=0), max_degree=64),
                    graph.subscribe_all(n, 1), edge_layout="csr", device="cpu")
    e, w = net.n_edges, 2
    rng = np.random.default_rng(22 + deny)
    args = [_words(rng, n, w), _words(rng, e, w), _words(rng, e, w), _words(rng, n, w),
            _words(rng, n, w), torch.from_numpy(rng.integers(-1, 50, size=(n, m)).astype(np.int32)),
            _words(rng, 1, w), torch.tensor(3, dtype=torch.int32), net.csr_col, net.csr_row,
            net.csr_eperm, net.csr_seg_start, net.csr_row_last, net.csr_row_nonempty,
            net.csr_row_ptr]
    kw = dict(cap=net.max_degree)
    if deny:
        kw["link_ok_e"] = torch.from_numpy(rng.random(e) < 0.7)
    _equal_on_card(cd.csr_delivery_plain, cd.csr_delivery, args, kw, cuda,
                   cd.LAUNCHES, "csr_delivery")


@pytest.mark.cuda
@pytest.mark.parametrize("m,long_row", [(m, 0) for m in HAZARD_M] + [(64, 200)])
@pytest.mark.parametrize("deny", [False, True])
def test_csr_delivery_kernel_on_hazard_graph(cuda, m, deny, long_row):
    """The hazard graph (tests/torch_parity.hazard_graph): empty rows, rows
    of 1, 31, 32, 33 and 64 edges, a run of 64-edge rows longer than one
    batch of a warp, rows on both sides of every warp boundary, N=300 (not
    a multiple of the 32-row warp or the 128-row block), W = 1, 2, 3 with M
    = 20, 64, 96, the deny mask off and on, and a row of 200 edges (the
    kernel's long-row path at W=2)."""
    g = hazard_graph(long_row=long_row)
    p = hazard_planes(m + deny, g["n"], g["e"], m)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a))
    args = [t(p[f]) for f in ("fwd", "fe_e", "mask_e", "not_mine", "have", "first_round",
                              "valid_row")]
    args += [torch.tensor(int(p["tick"]), dtype=torch.int32)]
    args += [t(g[f]) for f in ("col", "row", "eperm", "seg_start", "row_last",
                               "row_nonempty", "row_ptr")]
    kw = dict(cap=g["cap"])
    if deny:
        kw["link_ok_e"] = t(p["link_ok_e"])
    _equal_on_card(cd.csr_delivery_plain, cd.csr_delivery, args, kw, cuda,
                   cd.LAUNCHES, "csr_delivery")


@pytest.mark.cuda
def test_unsupported_shapes_raise_on_the_card(cuda):
    """A CUDA tensor launches the kernel or raises: a plane of the wrong
    shape, dtype or device never falls back to the plain version."""
    n, w = 64, 2
    net = Net.build(graph.ring_lattice(n, d=4), graph.subscribe_all(n, 1), device="cpu")
    k = net.max_degree
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda)
    args = [z(n, w), z(n, k * w), z(n, k * w), z(n, w), z(n, w), z(n, 64), z(1, w),
            torch.tensor(0, dtype=torch.int32, device=cuda)]
    static = dict(offsets=net.band_off, revs=net.band_rev, w=w)
    db.LAUNCHES["delivery_banded"] = 0
    for i, bad in ((1, z(n, k * w + 1)), (5, z(n, 64).float()), (2, z(n, k * w).cpu())):
        a = list(args)
        a[i] = bad
        with pytest.raises((ValueError, TypeError)):
            db.delivery_banded(*a, **static)
    with pytest.raises(ValueError, match="W = ceil"):
        db.delivery_banded(*args[:5], z(n, 96), *args[6:], **static)
    assert db.LAUNCHES["delivery_banded"] == 0
    fr.LAUNCHES["fused_delivery"] = 0
    words = lambda c: z(n, k * c)
    fargs = [words(w), words(w), z(n, w), z(n, w), None, words(w), words(w), words(w),
             z(n, k), z(n, w), z(n, w), z(n, w), z(1, w)]
    fkw = dict(offsets=net.band_off, revs=net.band_rev, w=w, score_enabled=False,
               want_cohorts=False, retrans_cap=3)
    for i, bad in ((0, words(w)[:, 1:]), (8, z(n, k).float()), (9, z(n, w).cpu())):
        a = list(fargs)
        a[i] = bad
        with pytest.raises((ValueError, TypeError)):
            fr.fused_delivery(*a, **fkw)
    assert fr.LAUNCHES["fused_delivery"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [(4096, 16), (1000, 64), (333, 5), (64, 256)])
def test_select_topk_kernel_equals_plain(cuda, r, k):
    """Bit for bit, on quantized values and noise (ties), signed zeros,
    all-masked rows and widths from -1 to K + 1."""
    rng = np.random.default_rng(r + k)
    values = rng.choice(np.array([-1.5, -0.0, 0.0, 0.5, 2.0], np.float32), size=(r, k))
    mask = rng.random((r, k)) < 0.7
    mask[:3] = False
    noise = rng.choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), size=(r, k))
    k_rows = rng.integers(-1, k + 2, size=(r,)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (values, mask, k_rows, noise)]
    ref = sk.select_topk_plain(*args)
    sk.LAUNCHES["select_topk"] = 0
    got = sk.select_topk(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert sk.LAUNCHES["select_topk"] == 1
    assert torch.equal(ref, got.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k", HAZARD_K)
def test_select_topk_kernel_on_hazard_rows(cuda, k):
    """Bit for bit on tests/torch_parity.hazard_rows: masked +-inf and NaN
    values, NaN noise, subnormals, ties and signed zeros, equal rows, empty
    and full masks, widths -1 to K+1; for every layout of the kernel (one
    lane a row, several rows a warp, a warp a row, several slots a lane)
    and from aligned and unaligned pointers (the scalar-load form)."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in hazard_rows(k, 300, k)]
    ref = sk.select_topk_plain(*args)
    sk.LAUNCHES["select_topk"] = 0
    got = sk.select_topk(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert sk.LAUNCHES["select_topk"] == 1
    assert torch.equal(ref, got.cpu())
    # views one element into their storage: not 16-byte aligned
    r = 299
    cut = [a.to(cuda).view(-1)[1:1 + r * k].view(r, k) for a in (args[0], args[1], args[3])]
    shifted = [cut[0], cut[1], args[2][:r].to(cuda), cut[2]]
    ref = sk.select_topk_plain(*[a.cpu() for a in shifted])
    got = sk.select_topk(*shifted)
    torch.cuda.synchronize()
    assert torch.equal(ref, got.cpu())


@pytest.mark.cuda
def test_select_topk_refuses_on_the_card(cuda):
    z = torch.zeros((8, 16), device=cuda)
    m = torch.ones((8, 16), dtype=torch.bool, device=cuda)
    kr = torch.full((8,), 2, dtype=torch.int32, device=cuda)
    sk.LAUNCHES["select_topk"] = 0
    for bad in ((z, m.cpu(), kr, z), (z, m, kr.long(), z), (z, m, kr, z[:, :15]),
                (torch.zeros((8, sk.MAX_K + 1), device=cuda), m, kr, z)):
        with pytest.raises((ValueError, TypeError)):
            sk.select_topk(*bad)
    assert sk.LAUNCHES["select_topk"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_run_phases_on_the_card_equals_the_cpu(cuda, layout):
    """The phase engine (r=8, a heartbeat every phase) on the card against
    the same build on the CPU, every leaf after every phase: on the banded
    lattice each phase is one control-head and r data edge_exchange
    launches, on CSR none; every heartbeat is 8 select_topk launches."""
    from go_libp2p_pubsub_tpu_torch import convert, driver
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, r, phases = 2048, 8, 3
    po, pt, pv = sweep.publish_schedule(phases * r, n, 1, None, seed=2)
    sides = {}
    for d in ("cpu", cuda):
        st, step, _t, _h = sweep.build_bench(n, 64, count_events=True, edge_layout=layout,
                                             fused=layout == "csr", rounds_per_phase=r,
                                             device=d)
        sides[str(d)] = (st, step)
    fr.reset_launch_counts()
    sk.reset_launch_counts()
    for p in range(phases + 1):
        for d, (st, step) in list(sides.items()):
            if p == 0:
                st = driver.form_mesh(step, st, rounds_per_phase=r)
            else:
                sl = slice((p - 1) * r, p * r)
                st = sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=r,
                                      heartbeat_every=r)
            sides[d] = (st, step)
        a = convert.state_leaves(sides["cpu"][0])
        b = convert.state_leaves(sides[str(cuda)][0])
        for path in a:
            x, y = a[path], b[path]
            if x.dtype.kind == "f":
                x, y = x.view(np.uint32), y.view(np.uint32)
            assert np.array_equal(x, y), (p, path)
    assert fr.LAUNCHES["edge_exchange"] == (0 if layout == "csr" else (phases + 1) * (1 + r))
    assert sk.LAUNCHES["select_topk"] == 8 * (phases + 1)
    assert int(sides[str(cuda)][0].core.tick) == (phases + 1) * r


@pytest.mark.cuda
@pytest.mark.parametrize("w7", [0.0, -0.7, -1.0])
def test_compute_scores_makes_no_host_sync(cuda, w7):
    """The score sum runs on the card with no host synchronisation under
    any P7 weight (the default 0, the bench's -1, any other): torch's sync
    debug mode raises on one, e.g. on a weight copied to the card as a
    tensor every call."""
    import dataclasses

    from go_libp2p_pubsub_tpu_torch.config import PeerScoreParams, TopicScoreParams
    from go_libp2p_pubsub_tpu_torch.score import engine as te

    n, k = 512, 8
    net = Net.build(graph.ring_lattice(n, d=4), graph.subscribe_all(n, 1), device=cuda)
    sp = PeerScoreParams(topics={0: TopicScoreParams()}, skip_app_specific=True,
                         behaviour_penalty_weight=w7, behaviour_penalty_threshold=1.0,
                         behaviour_penalty_decay=0.9)
    tp = te.TopicParamsArrays.build(sp, 1).gather(net.my_topics)
    gen = torch.Generator(device=cuda).manual_seed(0)
    st = dataclasses.replace(te.ScoreState.empty(n, 1, k, cuda),
                             bp=torch.rand((n, k), generator=gen, device=cuda) * 3)
    in_mesh = torch.rand((n, 1, k), generator=gen, device=cuda) < 0.5
    p6 = torch.zeros((n, k), device=cuda)
    app = torch.zeros((n,), device=cuda)
    sc = te.ScoreScalars.build(sp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = te.compute_scores(st, in_mesh, tp, sc, p6, app, net)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == (n, k) and bool(torch.isfinite(out).all())
    assert bool((out[st.bp > 1.0] != 0).any()) == (w7 != 0.0)


# ---------------------------------------------------------------------------
# CUDA graphs: the kernels and the steps inside captured windows

def _capture_cases(cuda):
    """One call of each of the five kernels on the card, on hazard inputs."""
    band = next(b for b in FUSED_BANDS if len(b["offsets"]) == 16)
    n, k = band["n"], len(band["offsets"])
    rng = np.random.default_rng(7)
    to = lambda a: None if a is None else a.to(cuda)
    wire = to(_words(rng, n, k * 6))
    scores = to(torch.from_numpy(rng.normal(0.0, 20.0, size=(n, k)).astype(np.float32)))
    live = to(torch.from_numpy((rng.random((n, k)) < 0.8).astype(np.int32)))
    ex_kw = dict(offsets=band["offsets"], revs=band["revs"], c=6, score_enabled=True)
    fused = [to(_np_tensor(a)) for a in hazard_fused_args(3, band, 64)]
    fused_kw = dict(offsets=band["offsets"], revs=band["revs"], w=2, score_enabled=True,
                    want_cohorts=True, retrans_cap=2)
    banded = [to(_np_tensor(a)) for a in hazard_banded_args(64, band, 64)]
    banded[7] = torch.tensor(int(banded[7]), dtype=torch.int32, device=cuda)
    net = Net.build(topo.to_topology(topo.powerlaw(512, 2.2, 2, 64, seed=0), max_degree=64),
                    graph.subscribe_all(512, 1), edge_layout="csr", device=cuda)
    e = net.n_edges
    csr = [to(x) for x in (_words(rng, 512, 2), _words(rng, e, 2), _words(rng, e, 2),
                           _words(rng, 512, 2), _words(rng, 512, 2),
                           torch.from_numpy(rng.integers(-1, 50, size=(512, 64)).astype(np.int32)),
                           _words(rng, 1, 2))]
    csr += [torch.tensor(3, dtype=torch.int32, device=cuda), net.csr_col, net.csr_row,
            net.csr_eperm, net.csr_seg_start, net.csr_row_last, net.csr_row_nonempty,
            net.csr_row_ptr]
    rows = [to(torch.from_numpy(a)) for a in (
        rng.normal(size=(4096, 16)).astype(np.float32), rng.random((4096, 16)) < 0.7,
        rng.integers(-1, 18, size=(4096,)).astype(np.int32),
        rng.random((4096, 16)).astype(np.float32))]
    return {
        "edge_exchange": lambda: fr.edge_exchange(wire, scores, live, **ex_kw),
        "fused_delivery": lambda: fr.fused_delivery(*fused, -10.0, -50.0, **fused_kw),
        "delivery_banded": lambda: db.delivery_banded(
            *banded, offsets=band["offsets"], revs=band["revs"], w=2),
        "csr_delivery": lambda: cd.csr_delivery(*csr, cap=net.max_degree),
        "select_topk": lambda: sk.select_topk(*rows),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["edge_exchange", "fused_delivery", "delivery_banded",
                                  "csr_delivery", "select_topk"])
def test_kernel_captured_alone_equals_eager(cuda, name):
    """Each kernel's launch recorded into a CUDA graph on torch's capturing
    stream and replayed writes what the eager launch writes."""
    from torch_parity import graph_replay_equals_eager

    assert graph_replay_equals_eager(_capture_cases(cuda)[name]) == 1


def _one_step(cuda, engine):
    """(state, call) of one step of ``engine`` at N=512 on the card, warmed
    (``phase`` and ``per-round`` take a bench config after a dash)."""
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n = 512
    kind, _, config = engine.partition("-")
    if kind in ("phase", "per"):
        config = config.replace("round", "").lstrip("-") or "default"
        opts = {}
        if config == "px":
            config, opts = "default", dict(px=True)
        n_topics = sweep.bench_topics(config)
        r = 8 if kind == "phase" else 1
        st, step, _t, honest = sweep.build_bench(n, 64, config=config, rounds_per_phase=r,
                                                 device=cuda, **opts)
    else:
        n_topics, honest = 1, None
    po, pt, pv = (torch.as_tensor(a, device=cuda)
                  for a in sweep.publish_schedule(16, n, n_topics, honest))
    if kind == "phase":
        call = lambda s, i: step(s, po[8 * i:8 * i + 8], pt[8 * i:8 * i + 8],
                                 pv[8 * i:8 * i + 8], do_heartbeat=True)
    elif kind == "per":
        call = lambda s, i: step(s, po[i], pt[i], pv[i])
    else:
        layout, g = ("dense", "lattice") if engine == "floodsub" else ("csr", "powerlaw")
        st, step = sweep.build_floodsub(n, 64, graph=g, layout=layout, device=cuda)
        call = lambda s, i: step(s, po[i], pt[i], pv[i])
    return call(st, 0), call


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["phase", "per-round", "floodsub", "floodsub-csr",
                                    "phase-px", "per-round-px",
                                    "phase-eth2", "phase-sybil", "per-round-eth2",
                                    "per-round-sybil"])
def test_step_makes_no_host_sync(cuda, engine):
    """A phase, a per-round step (the default, eth2 and sybil configs) and
    a FloodSub round (lattice and CSR) run on the card with no host
    synchronisation, so they can be captured: torch's sync debug mode
    raises on one (an .item(), a copy of a host value to the card)."""
    st, call = _one_step(cuda, engine)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = call(st, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["churn-per-round", "churn-phase", "overlay-dense",
                                  "overlay-csr"])
def test_dynamic_step_makes_no_host_sync(cuda, cell):
    """A churn round or phase (peers going down) and a mutating-overlay
    round (a storm's kill dispatch, writes landing) run on the card with no
    host synchronisation, so their windows capture."""
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n = 512
    po, pt, pv = (torch.as_tensor(a, device=cuda) for a in sweep.publish_schedule(16, n, 1))
    kind, _, what = cell.partition("-")
    if kind == "churn":
        r = 8 if what == "phase" else 1
        st, step, _t, _h = sweep.build_bench(n, 64, rounds_per_phase=r, device=cuda,
                                             dynamic_peers=True)
        up = torch.as_tensor(sweep.churn_up(n, rounds=16, down_at=1, up_at=12), device=cuda)
        if r > 1:
            call = lambda s, i: step(s, po[8 * i:8 * i + 8], pt[8 * i:8 * i + 8],
                                     pv[8 * i:8 * i + 8], up[8 * i + 1], do_heartbeat=True)
        else:
            call = lambda s, i: step(s, po[i], pt[i], pv[i], up[i])
    else:
        st, step, storm, _s = sweep.build_overlay(n, 64, 8, edge_layout=what, device=cuda)
        writes, upw = (torch.as_tensor(a, device=cuda) for a in storm.build())
        call = lambda s, i: step(s, po[i], pt[i], pv[i], upw[i], writes[i])
        st = call(call(st, 0), 1)     # dispatch 2 is the storm's kill dispatch
    st = call(st, 0 if kind == "churn" else 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = call(st, 1 if kind == "churn" else 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert not bool(st.up.all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_cuda_window_replays_a_graph(cuda, layout):
    """A phase-engine window on the card is a captured graph, replayed once
    a block: it counts its replays (a quiet eager loop would count none),
    its wrappers launched only while the block was captured, and it ends
    where the eager loop ends, also when a second call continues the
    first."""
    from go_libp2p_pubsub_tpu_torch import convert, driver
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, r = 1024, 8
    po, pt, pv = sweep.publish_schedule(6 * r, n, 1, None, seed=4)

    def build():
        return sweep.build_bench(n, 64, edge_layout=layout, fused=layout == "csr",
                                 rounds_per_phase=r, device=cuda)[:2]

    st, step = build()
    eager = sweep.run_phases(st, step, po, pt, pv, rounds_per_phase=r, heartbeat_every=r)
    st, step = build()
    scan = driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r, unroll=2)
    fr.reset_launch_counts()
    sk.reset_launch_counts()
    st = scan(st, po[:4 * r], pt[:4 * r], pv[:4 * r])
    launched = fr.LAUNCHES["edge_exchange"] + sk.LAUNCHES["select_topk"]
    st = scan(st, po[4 * r:], pt[4 * r:], pv[4 * r:])
    win = scan.window
    assert win.captures == 1 and win.replays == 2 + 1     # the shorter window reuses it
    # warm-up and capture launched the block twice; the replays launch
    # nothing from the host
    assert fr.LAUNCHES["edge_exchange"] + sk.LAUNCHES["select_topk"] == launched > 0
    assert launched == 2 * (2 * 8 + (2 * (1 + r) if layout == "dense" else 0))
    assert win.block_launches["select_topk"] == 2 * 8
    assert win.block_launches["edge_exchange"] == (2 * (1 + r) if layout == "dense" else 0)
    a, b = convert.state_leaves(eager), convert.state_leaves(st)
    for path in a:
        assert np.array_equal(np.atleast_1d(a[path]).view(np.uint8),
                              np.atleast_1d(b[path]).view(np.uint8)), path


@pytest.mark.cuda
def test_cuda_window_observe_equals_the_eager_series(cuda):
    """``observe``'s per-dispatch stack from a captured FloodSub window
    equals the series of the eager loop, dispatch for dispatch."""
    from go_libp2p_pubsub_tpu_torch import driver
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, rounds = 1024, 12
    po, pt, pv = sweep.publish_schedule(rounds, n, 1, None, seed=3)

    def observe(s):
        return {"tick": s.tick, "have": s.dlv.have.sum(0, dtype=torch.int32)}

    st, step = sweep.build_floodsub(n, 64, device=cuda)
    series = []
    for i in range(rounds):
        st = step(st, *(torch.as_tensor(a[i], device=cuda) for a in (po, pt, pv)))
        series.append(observe(st))
    st, step = sweep.build_floodsub(n, 64, device=cuda)
    win = driver.make_window(step, observe=observe, unroll=4)
    _, ys = win(st, (po, pt, pv))
    assert win.replays == rounds // 4
    for name in ("tick", "have"):
        assert torch.equal(ys["obs"][name], torch.stack([x[name] for x in series])), name


ROUNDS_ON_CARD = 20


def _config_build(config: str, n: int, device):
    """(state, step, schedule) of a bench config's per-round step at N
    peers, ``ROUNDS_ON_CARD`` rounds; ``sybil`` with a validation capacity
    of 2 (the bench's 8 never throttles at 4 publishes a round) and a
    fifth of the publishes rejected, so the gater's random-early drop
    clears acc_msg bits within the run."""
    import dataclasses

    from go_libp2p_pubsub_tpu_torch.config import (
        GossipSubParams, PeerGaterParams, PeerScoreThresholds)
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
        GossipSubConfig, GossipSubState, make_gossipsub_step)
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    if config == "eth2":
        st, step, n_topics, honest = sweep.build_bench(n, 64, config="eth2", device=device)
        return st, step, sweep.publish_schedule(ROUNDS_ON_CARD, n, n_topics, honest, seed=3)
    net = Net.build(graph.ring_lattice(n, d=8), graph.subscribe_all(n, 1), device=device)
    gater = PeerGaterParams()
    cfg = GossipSubConfig.build(dataclasses.replace(GossipSubParams(), flood_publish=False),
                                PeerScoreThresholds(), score_enabled=True,
                                gater_params=gater, validation_capacity=2)
    cfg = dataclasses.replace(cfg, count_events=False, fanout_slots=0)
    sp = sweep.bench_score_params("sybil", 1)[1]
    adversary = np.random.default_rng(0).random(n) < sweep.SYBIL_FRACTION
    step = make_gossipsub_step(cfg, net, score_params=sp, gater_params=gater,
                               adversary_no_forward=adversary)
    st = GossipSubState.init(net, 64, cfg, score_params=sp)
    po, pt, pv = sweep.publish_schedule(ROUNDS_ON_CARD, n, 1, np.flatnonzero(~adversary), seed=3)
    pv = pv & (np.random.default_rng(4).random(pv.shape) >= 0.2)
    return st, step, (po, pt, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["eth2", "sybil"])
def test_config_kernels_equal_plain(cuda, config):
    """fused_delivery and select_topk on every call of 20 rounds of the
    eth2 and sybil per-round steps on the card, each against its plain
    version on the same arguments: eth2's fanout words in the carry, 64
    topics with 2 slots a peer; sybil's F_SENDER_FWD bit off on edges from
    sybils and acc_msg bits the gater cleared."""
    n = 2048
    st, step, (po, pt, pv) = _config_build(config, n, cuda)
    calls = {"fused_delivery": [], "select_topk": []}
    orig = {"fused_delivery": fr.fused_delivery, "select_topk": sk.select_topk}

    def recorder(name):
        def call(*args, **kw):
            calls[name].append((args, kw))
            return orig[name](*args, **kw)
        return call

    fr.fused_delivery, sk.select_topk = recorder("fused_delivery"), recorder("select_topk")
    try:
        for i in range(ROUNDS_ON_CARD):
            st = step(st, *(torch.as_tensor(a[i], device=cuda) for a in (po, pt, pv)))
    finally:
        fr.fused_delivery, sk.select_topk = orig["fused_delivery"], orig["select_topk"]
    assert len(calls["fused_delivery"]) == ROUNDS_ON_CARD
    assert len(calls["select_topk"]) >= ROUNDS_ON_CARD * 8
    flags_seen = torch.zeros((), dtype=torch.int32, device=cuda)
    for args, kw in calls["fused_delivery"]:
        ref = fr.fused_delivery_plain(*args, **kw)
        got = orig["fused_delivery"](*args, **kw)
        for key in ref:
            assert torch.equal(ref[key], got[key]), key
        live = (args[8] >> fr.F_LIVE) & 1
        off = live & ~(args[8] >> (fr.F_SENDER_FWD if config == "sybil" else fr.F_ACC_MSG)) & 1
        flags_seen = flags_seen + off.sum(dtype=torch.int32)
    for args, kw in calls["select_topk"]:
        assert torch.equal(sk.select_topk_plain(*args, **kw), orig["select_topk"](*args, **kw))
    if config == "sybil":
        assert int(flags_seen) > 0                       # edges from sybils
        acc_off = sum(int((((a[8] >> fr.F_LIVE) & ~(a[8] >> fr.F_ACC_MSG)) & 1).sum())
                      for a, _ in calls["fused_delivery"])
        assert acc_off > 0                               # the gater dropped
    else:
        assert int((st.fanout_topic >= 0).sum()) > 0


# ---------------------------------------------------------------------------
# RandomSub and the delivery core's options on the card

def _record(module, name, calls):
    """Wrap ``module.name`` so every call's arguments land in ``calls``;
    returns the original."""
    orig = getattr(module, name)

    def call(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, call)
    return orig


@pytest.mark.cuda
def test_select_topk_on_randomsub_size_targets(cuda):
    """RandomSub's draw: uniform noise, per-row k the topic's size target,
    including rows whose target reaches or passes their eligible count
    (every eligible slot chosen) and rows with no eligible slot or no
    topic (k = 0)."""
    rng = np.random.default_rng(11)
    r, k = 5000, 32
    mask = rng.random((r, k)) < rng.random((r, 1))
    mask[:200] = False                          # no eligible neighbour
    k_rows = np.full((r,), 32, np.int32)
    k_rows[200:1200] = mask[200:1200].sum(1)    # target == eligible count
    k_rows[1200:1400] = 0                       # a slot with no topic
    k_rows[1400:2000] = 6
    args = [torch.from_numpy(a) for a in (rng.random((r, k)).astype(np.float32), mask,
                                          k_rows, np.zeros((r, k), np.float32))]
    ref = sk.select_topk_plain(*args)
    got = sk.select_topk(*[a.to(cuda) for a in args])
    assert torch.equal(ref, got.cpu())
    assert torch.equal(ref[200:1200], args[1][200:1200]) and not ref[1200:1400].any()


@pytest.mark.cuda
@pytest.mark.parametrize("graph_name", ["lattice", "powerlaw"])
def test_randomsub_round_kernels_equal_plain(cuda, graph_name):
    """Every select_topk and delivery call of 12 RandomSub rounds on the
    card against its plain version on the captured arguments: the lattice
    runs delivery_banded, the power-law graph CSR-resident csr_delivery;
    one draw and one delivery launch a round."""
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, rounds = 4096, 12
    layout = "csr" if graph_name == "powerlaw" else "dense"
    st, run = sweep.build_randomsub(n, 64, graph=graph_name, device=cuda, layout=layout,
                                    size_estimate=36 if layout == "dense" else 1000)
    po, pt, pv = sweep.publish_schedule(rounds, n, 1, None, seed=5)
    mod, name = (cd, "csr_delivery") if layout == "csr" else (db, "delivery_banded")
    dcalls, scalls = [], []
    orig_d, orig_s = _record(mod, name, dcalls), _record(sk, "select_topk", scalls)
    try:
        st = sweep.run_rounds(st, run, po, pt, pv)
    finally:
        setattr(mod, name, orig_d)
        sk.select_topk = orig_s
    assert len(dcalls) == len(scalls) == rounds
    plain = getattr(mod, name + "_plain")
    for args, kw in dcalls:
        ref = plain(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args],
                    **{k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()})
        got = orig_d(*args, **kw)
        for key in ref:
            assert torch.equal(ref[key], got[key].cpu()), key
    for args, kw in scalls:
        assert torch.equal(sk.select_topk_plain(*args, **kw), orig_s(*args, **kw))
    reach = (st.dlv.first_round >= 0).sum(0)
    old = (st.msgs.birth >= 0) & (st.msgs.birth <= rounds - 4)
    assert bool((reach[old] > 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["floodsub", "randomsub", "per-round"])
def test_options_leave_the_delivery_kernels(cuda, engine):
    """Under the queue cap or the validation pipeline the card launches
    neither delivery_banded nor the fused round: FloodSub with a cap of 2,
    RandomSub with a pipeline of 1 and the per-round GossipSub step with
    both, on the banded lattice; and the card's state equals the CPU's."""
    from go_libp2p_pubsub_tpu_torch import convert
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, rounds = 1024, 8
    po, pt, pv = sweep.publish_schedule(rounds, n, 1, None, seed=6)

    def build(dev):
        if engine == "floodsub":
            return sweep.build_floodsub(n, 64, device=dev, queue_cap=2)
        if engine == "randomsub":
            return sweep.build_randomsub(n, 64, size_estimate=36, device=dev, val_delay=1)
        st, step, _t, _h = sweep.build_bench(n, 64, count_events=True, device=dev,
                                             queue_cap=2, validation_delay_rounds=1)
        return st, step

    out = []
    for dev in ("cpu", cuda):
        for lib in (db, cd, fr, sk):
            lib.reset_launch_counts()
        st, step = build(dev)
        out.append(convert.state_leaves(sweep.run_rounds(st, step, po, pt, pv)))
        if dev != "cpu":
            assert db.LAUNCHES["delivery_banded"] == cd.LAUNCHES["csr_delivery"] == 0
            assert fr.LAUNCHES["edge_exchange"] == fr.LAUNCHES["fused_delivery"] == 0
            assert (sk.LAUNCHES["select_topk"] > 0) == (engine != "floodsub")
    for path in out[0]:
        assert np.array_equal(np.atleast_1d(out[0][path]).view(np.uint8),
                              np.atleast_1d(out[1][path]).view(np.uint8)), path


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["per-round", "phase"])
def test_px_steps_on_the_card_equal_the_cpu(cuda, engine):
    """The PX cell (``sweep.build_bench(px=True)``: 30% dormant edges, the
    exact-trace plane, the int16 counters) on the banded lattice: the card
    equals the CPU every leaf after every round or phase, some edges
    activate, and the kernels read the live view: a PX round launches one
    edge_exchange (C = 5) and one fused_delivery, a phase 1 + r
    edge_exchange (C = 7 at its head)."""
    from go_libp2p_pubsub_tpu_torch import convert, driver
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, r = 1024, (8 if engine == "phase" else 1)
    po, pt, pv = sweep.publish_schedule(48, n, 1, None, seed=3)
    sides = {}
    for dev in ("cpu", cuda):
        st, step, _t, _h = sweep.build_bench(n, 64, count_events=True, rounds_per_phase=r,
                                             device=dev, px=True)
        if r > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=r)
        sides[dev] = [st, step]
    live0 = int(sides["cpu"][0].edge_live.sum())
    for i in range(0, 48, r):
        sl = slice(i, i + r)
        fr.reset_launch_counts()
        for dev, (st, step) in sides.items():
            if r > 1:
                sides[dev][0] = sweep.run_phases(st, step, po[sl], pt[sl], pv[sl],
                                                 rounds_per_phase=r, heartbeat_every=r)
            else:
                sides[dev][0] = sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl])
        want = {"edge_exchange": 1 + r if r > 1 else 1, "fused_delivery": 0 if r > 1 else 1}
        assert fr.LAUNCHES == want, (i, fr.LAUNCHES)
        a, b = (convert.state_leaves(sides[d][0]) for d in ("cpu", cuda))
        for path in a:
            assert np.array_equal(np.atleast_1d(a[path]).view(np.uint8),
                                  np.atleast_1d(b[path]).view(np.uint8)), (i, path)
    st = sides[cuda][0]
    assert int(st.edge_live.sum()) > live0 and st.peerhave.dtype == torch.int16
    assert st.dup_trans is not None


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [(-10.0, -50.0), (0.0, -0.0), (1e-40, -1e-40)])
def test_fused_delivery_kernel_reads_a_device_threshold_row(cuda, thr):
    """A lifted plane's (gossip, publish) row as a float32 ``[1, 2]`` tensor
    on the card: the kernel reads it as it reads the host floats' row, and
    equals its plain version on the same row (subnormal thresholds read as
    zeros of their sign)."""
    band = next(b for b in BANDS if b["name"] == "ring N=1000 K=16")
    args = [_np_tensor(a) for a in hazard_fused_args(5, band, 64)]
    kw = dict(offsets=band["offsets"], revs=band["revs"], w=2, score_enabled=True,
              want_cohorts=True, retrans_cap=3)
    row = torch.tensor([list(thr)], dtype=torch.float32)
    ref = fr.fused_delivery_plain(*args, thr_row=row, **kw)
    host = fr.fused_delivery_plain(*args, *thr, **kw)
    fr.LAUNCHES["fused_delivery"] = 0
    got = fr.fused_delivery(*[a.to(cuda) for a in args], thr_row=row.to(cuda), **kw)
    torch.cuda.synchronize()
    assert fr.LAUNCHES["fused_delivery"] == 1
    for key in ref:
        assert torch.equal(ref[key], host[key]), key
        assert torch.equal(ref[key], got[key].cpu()), key


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8])
def test_lifted_window_replays_another_plane_without_a_capture(cuda, r):
    """One captured lifted window (the bench default config at N = 512),
    called under the config's plane, then a moved plane, then a candidate
    plane with moved degrees: ``captures`` stays 1, the state of each call
    equals the eager loop under the same plane, and the moved plane's
    differs from the first's (a replay does not keep the captured plane)."""
    import dataclasses

    from go_libp2p_pubsub_tpu_torch import driver
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n = 512
    st0, step, _t, _h = sweep.build_bench(n, 64, rounds_per_phase=r, device=cuda,
                                          lift_scores=True)
    plane_a = sweep.bench_plane(device=cuda, mesh=True)
    sc = plane_a.score
    plane_b = dataclasses.replace(plane_a, score=dataclasses.replace(
        sc, w1=sc.w1 * 0.5, w2=torch.full_like(sc.w2, 2.0),
        gossip_threshold=torch.tensor(-4.0, device=cuda),
        publish_threshold=torch.tensor(-20.0, device=cuda),
        graylist_threshold=torch.tensor(-40.0, device=cuda)))
    plane_c = dataclasses.replace(plane_b, mesh=dataclasses.replace(
        plane_b.mesh, D=torch.tensor(8, dtype=torch.int32, device=cuda),
        Dlo=torch.tensor(6, dtype=torch.int32, device=cuda),
        Dhi=torch.tensor(12, dtype=torch.int32, device=cuda)))
    po, pt, pv = (torch.as_tensor(a, device=cuda) for a in sweep.publish_schedule(32, n, 1))
    scan = driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r,
                            static_heartbeat=r > 1, donate=False)
    clone = lambda s: driver._rebuild(s, iter([t.clone() for t in driver._leaves(s)]))
    finals = []
    for plane in (plane_a, plane_b, plane_c):
        win = scan(clone(st0), po, pt, pv, consts=(plane,))
        eager = clone(st0)
        for p in range(32 // r):
            if r > 1:
                sl = slice(p * r, (p + 1) * r)
                eager = step(eager, po[sl], pt[sl], pv[sl], plane, do_heartbeat=True)
            else:
                eager = step(eager, po[p], pt[p], pv[p], plane)
        for a, b in zip(driver._leaves(eager), driver._leaves(win)):
            assert torch.equal(a, b)
        finals.append(win)
    assert scan.window.captures == 1
    assert not torch.equal(finals[0].scores, finals[1].scores)


@pytest.mark.cuda
def test_snapshot_refuses_a_capture(cuda):
    """A trace snapshot copies to the host, which a CUDA graph capture
    cannot hold: it raises before touching the card."""
    from go_libp2p_pubsub_tpu_torch.perf import sweep
    from go_libp2p_pubsub_tpu_torch.trace import drain

    st = sweep.build_bench(256, 64, device=cuda)[0]
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            drain.snapshot(st)
    assert drain.snapshot(st).first_edge.dtype == np.int8


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["per-round", "phase"])
def test_trace_and_checkpoint_on_the_card_equal_the_cpu(cuda, engine, tmp_path):
    """The default config traced on the card and on the CPU writes the
    same protobuf file; a checkpoint the CPU run writes restores on the
    card and continues equal to the CPU run."""
    from go_libp2p_pubsub_tpu_torch import checkpoint, convert, driver, graph
    from go_libp2p_pubsub_tpu_torch.perf import sweep
    from go_libp2p_pubsub_tpu_torch.trace import drain, sinks

    n, r = 512, (8 if engine == "phase" else 1)
    po, pt, pv = sweep.publish_schedule(24, n, 1, None, seed=3)
    out, finals = {}, {}
    for dev in ("cpu", cuda):
        st, step, _t, _h = sweep.build_bench(n, 64, count_events=True, rounds_per_phase=r,
                                             device=dev)
        if r > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=r)
        net = Net.build(graph.ring_lattice(n, d=8), graph.subscribe_all(n, 1), device=dev)
        path = str(tmp_path / f"{torch.device(dev).type}.pb")
        sess = drain.TraceSession(net, [sinks.PBTracer(path)])
        prev = drain.snapshot(st)
        sess.emit_init(prev)
        for i in range(0, 16, r):
            sl = slice(i, i + r)
            if r > 1:
                st = sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=r,
                                      heartbeat_every=r)
            else:
                st = sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl])
            new = drain.snapshot(st)
            sess.observe(prev, new, po[i] if r == 1 else po[sl], pt[i] if r == 1 else pt[sl],
                         pv[i] if r == 1 else pv[sl])
            prev = new
        sess.close(prev)
        out[torch.device(dev).type] = open(path, "rb").read()
        if dev == "cpu":
            checkpoint.save(str(tmp_path / "cpu.npz"), st)
            run = sweep.run_phases if r > 1 else sweep.run_rounds
            kw = dict(rounds_per_phase=r, heartbeat_every=r) if r > 1 else {}
            finals["cpu"] = convert.state_leaves(run(st, step, po[16:], pt[16:], pv[16:], **kw))
        else:
            st = checkpoint.restore(str(tmp_path / "cpu.npz"), st)
            assert st.core.tick.device.type == "cuda"
            finals["cuda"] = convert.state_leaves(run(st, step, po[16:], pt[16:], pv[16:], **kw))
    assert out["cpu"] == out["cuda"] and len(out["cpu"]) > 0
    for p in finals["cpu"]:
        assert np.array_equal(np.atleast_1d(finals["cpu"][p]).view(np.uint8),
                              np.atleast_1d(finals["cuda"][p]).view(np.uint8)), p


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["per-round", "phase"])
def test_checked_window_on_the_card_equals_the_cpu(cuda, engine):
    """The bench default config at N = 512 through a checked window (the
    phase engine at r = 8 with a check every 2 phases, the per-round step
    every 8 rounds) on the card and on the CPU: equal verdicts and final
    states, one capture over two calls, and the checked block launches
    each kernel as often as the same block unchecked. On the card the
    checker launches no kernel and makes no host sync, and an eager hook
    over the same dispatches gives the window's verdicts (but at the first
    check's events-monotone, which the window holds to the entry
    counters)."""
    from go_libp2p_pubsub_tpu_torch import convert, driver
    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, r = 512, (8 if engine == "phase" else 1)
    ce, dispatches = (2, 8) if r > 1 else (8, 32)
    po, pt, pv = sweep.publish_schedule(dispatches * r, n, 1, seed=1)
    xs = tuple(a.reshape((dispatches, r, -1)) if r > 1 else a for a in (po, pt, pv))
    bench = dict(rounds_per_phase=r, count_events=True)
    due_fn = lambda tick: inv.due_vector(quiet=(0, 10_000))     # noqa: E731
    hb = driver.heartbeat_schedule(r, r) if r > 1 else None
    clone = lambda s: driver._rebuild(s, iter([t.clone() for t in driver._leaves(s)]))  # noqa: E731
    out = {}
    for dev in ("cpu", cuda):
        st, step, _t, _h = sweep.build_bench(n, 64, device=dev, **bench)
        if r > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=r)
        spec = sweep.bench_invariants(n, check_every=ce, due_fn=due_fn, delivery_window=24,
                                      device=dev, **bench)
        due = spec.precompute(dispatches)
        win = driver.make_window(step, heartbeat=hb, check=spec.check, check_every=ce,
                                 donate=False)
        plain = driver.make_window(step, heartbeat=hb, unroll=ce, donate=False)
        end, ys = win(clone(st), xs, due)
        end2, ys2 = win(clone(st), xs, due)
        out[torch.device(dev).type] = (convert.state_leaves(end), ys["ok"].cpu())
        assert torch.equal(ys["ok"], ys2["ok"]) and ys["ok"].all()
        assert ys["ok"].shape == (dispatches // ce, len(spec.names))
        if dev == "cpu":
            continue
        plain_end, _ = plain(clone(st), xs)
        for a, b in zip(driver._leaves(plain_end), driver._leaves(end)):
            assert torch.equal(a, b)
        assert win.captures == 1 and win.block_dispatches == plain.block_dispatches == ce
        assert win.block_launches == plain.block_launches
        assert sum(win.block_launches.values()) > 0
        before = driver.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ok = spec.check(end, end.core.events, due[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert driver.launch_counts() == before and ok.all()
        net, cfg, _sp, _g, _nf = sweep.bench_parts(n, device=dev, **bench)
        hook = inv.InvariantHook(spec.engine, net, cfg,
                                 inv.InvariantConfig(delivery_window=24, check_every=ce),
                                 batched=False, due_fn=due_fn, rounds_per_step=r)
        hook.precompute(dispatches)
        eager = st
        for d in range(dispatches):
            row = [torch.as_tensor(a[d], device=dev) for a in xs]
            eager = step(eager, *row, **({"do_heartbeat": True} if r > 1 else {}))
            hook.on_step(d, eager)
        got = torch.from_numpy(hook.report().ok[:, 0])
        mono = spec.names.index("events-monotone")
        got[0, mono] = ys["ok"][0, mono]
        assert torch.equal(got, ys["ok"].cpu())
    for p, a in out["cpu"][0].items():
        assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                              np.atleast_1d(out["cuda"][0][p]).view(np.uint8)), p
    assert torch.equal(out["cpu"][1], out["cuda"][1])


# ---------------------------------------------------------------------------
# the sim axis: one launch for S sims under torch.func.vmap

SIMS = 3


def _sims_case(cuda, name: str, seed: int):
    """(fn, one sim's args, the positions every sim shares) of one kernel
    wrapper on hazard inputs of ``seed``: each sim draws its own arguments
    but the shared ones, which the vmap leaves unbatched (sim stride 0)."""
    band = next(b for b in FUSED_BANDS if len(b["offsets"]) == 16)
    rng = np.random.default_rng(seed)
    to = lambda a: None if a is None else a.to(cuda)   # noqa: E731
    n, k = band["n"], len(band["offsets"])
    if name == "edge_exchange":
        args = [to(_words(rng, n, k * 6)),
                to(torch.from_numpy(rng.normal(0.0, 20.0, size=(n, k)).astype(np.float32))),
                to(torch.from_numpy((np.random.default_rng(1).random((n, k)) < 0.8)
                                    .astype(np.int32)))]
        kw = dict(offsets=band["offsets"], revs=band["revs"], c=6, score_enabled=True)
        return (lambda *a: fr.edge_exchange(*a, **kw)), args, {2}
    if name == "fused_delivery":
        args = [to(_np_tensor(a)) for a in hazard_fused_args(seed, band, 64)]
        args[8] = to(_np_tensor(hazard_fused_args(1, band, 64)[8]))
        kw = dict(offsets=band["offsets"], revs=band["revs"], w=2, score_enabled=True,
                  want_cohorts=True, retrans_cap=2)
        return (lambda *a: fr.fused_delivery(*a, -10.0, -50.0, **kw)), args, {8, 12}
    if name == "delivery_banded":
        args = [to(_np_tensor(a)) for a in hazard_banded_args(seed, band, 64)]
        args[7] = torch.tensor(5, dtype=torch.int32, device=cuda)
        return (lambda *a: db.delivery_banded(*a, offsets=band["offsets"], revs=band["revs"],
                                              w=2)), args, {2, 7}
    if name == "csr_delivery":
        net = Net.build(topo.to_topology(topo.powerlaw(512, 2.2, 2, 64, seed=0), max_degree=64),
                        graph.subscribe_all(512, 1), edge_layout="csr", device=cuda)
        e = net.n_edges
        args = [to(x) for x in (_words(rng, 512, 2), _words(rng, e, 2), _words(rng, e, 2),
                                _words(rng, 512, 2), _words(rng, 512, 2),
                                torch.from_numpy(rng.integers(-1, 50, size=(512, 64))
                                                 .astype(np.int32)),
                                _words(np.random.default_rng(2), 1, 2))]
        args += [torch.tensor(seed, dtype=torch.int32, device=cuda),
                 to(torch.from_numpy(rng.random(e) < 0.7))]
        topo_args = (net.csr_col, net.csr_row, net.csr_eperm, net.csr_seg_start,
                     net.csr_row_last, net.csr_row_nonempty, net.csr_row_ptr)

        def fn(*a):
            return cd.csr_delivery(*a[:8], *topo_args, cap=net.max_degree, link_ok_e=a[8])
        return fn, args, {6}
    if name.startswith("select_topk"):
        args = [to(torch.from_numpy(a)) for a in (
            rng.choice(np.array([-1.5, -0.0, 0.0, 0.5, 2.0], np.float32), size=(1000, 16)),
            rng.random((1000, 16)) < 0.7,
            np.random.default_rng(3).integers(-1, 18, size=(1000,)).astype(np.int32),
            rng.choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), size=(1000, 16)))]
        # shared k_rows: the strided launch; every argument batched: S*R rows
        return (lambda *a: sk.select_topk(*a)), args, ({2} if name == "select_topk" else set())
    raise KeyError(name)


def _flat_out(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["edge_exchange", "fused_delivery", "delivery_banded",
                                  "csr_delivery", "select_topk", "select_topk-folded"])
def test_batched_launch_equals_single_launches(cuda, name):
    """Each kernel vmapped over S = 3 sims launches once and writes, sim for
    sim, what three one-sim launches write, bit for bit; the shared
    arguments (left unbatched by the vmap) are read at sim stride 0. Also
    inside a captured graph."""
    from torch_parity import graph_replay_equals_eager

    from go_libp2p_pubsub_tpu_torch.driver import launch_counts

    cases = [_sims_case(cuda, name, 10 + z) for z in range(SIMS)]
    fn, _, shared = cases[0]
    for _, args, _ in cases[1:]:
        for i in shared:
            args[i] = cases[0][1][i]
    singles = [_flat_out(fn(*args)) for _, args, _ in cases]
    base = cases[0][1]
    in_dims = tuple(None if i in shared else 0 for i in range(len(base)))
    stacked = [base[i] if i in shared else torch.stack([c[1][i] for c in cases])
               for i in range(len(base))]
    before = dict(launch_counts())
    got = _flat_out(torch.func.vmap(fn, in_dims=in_dims)(*stacked))
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    assert moved == {name.partition("-")[0]: 1}
    for z in range(SIMS):
        for i, (a, b) in enumerate(zip(singles[z], got)):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                               b[z].view(torch.int32) if b.is_floating_point() else b[z]), (z, i)
    batched = lambda: torch.func.vmap(fn, in_dims=in_dims)(*stacked)   # noqa: E731
    assert graph_replay_equals_eager(batched) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["per-round", "phase"])
def test_lifted_window_equals_eager_loop(cuda, engine):
    """A lifted ensemble step (S = 3) on the card: its eager loop makes no
    host sync, launches each kernel as often as the one-sim step does, and
    a run window over it (one capture) ends where the eager loop ends."""
    from go_libp2p_pubsub_tpu_torch import driver, ensemble
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, r = 512, (8 if engine == "phase" else 1)
    dispatches = 4
    po, pt, pv = (torch.as_tensor(a, device=cuda)
                  for a in sweep.publish_schedule(dispatches * r, n, 1, seed=2))
    if r > 1:
        po, pt, pv = (a.reshape(dispatches, r, -1) for a in (po, pt, pv))
    hb = [True] if r > 1 else None
    kw = {"do_heartbeat": True} if r > 1 else {}
    st, step, _t, _h = sweep.build_bench(n, 64, rounds_per_phase=r, device=cuda)
    ens = ensemble.lift_step(step)
    row = lambda d: tuple(ensemble.tile(a[d], SIMS) for a in (po, pt, pv))  # noqa: E731
    eager = ensemble.batch_states(st, SIMS)
    eager = ens(eager, *row(0), **kw)
    torch.cuda.synchronize()
    before = dict(driver.launch_counts())
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = ens(eager, *row(1), **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    batched = {k: v - before[k] for k, v in driver.launch_counts().items()}
    one = ensemble.with_sim_key(st, st.core.key, 0)
    one = step(one, po[0], pt[0], pv[0], **kw)
    before = dict(driver.launch_counts())
    one = step(one, po[1], pt[1], pv[1], **kw)
    assert batched == {k: v - before[k] for k, v in driver.launch_counts().items()}
    for d in range(2, dispatches):
        eager = ens(eager, *row(d), **kw)
    win = driver.make_window(ens, heartbeat=hb)
    xs = tuple(torch.stack([ensemble.tile(a[d], SIMS) for d in range(dispatches)])
               for a in (po, pt, pv))
    end, _ = win(ensemble.batch_states(st, SIMS), xs)
    assert win.captures == 1
    for a, b in zip(driver._leaves(eager), driver._leaves(end)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["churn-per-round", "churn-phase", "overlay-dense",
                                  "overlay-csr", "px"])
def test_lifted_dynamic_steps_on_the_card(cuda, cell):
    """Dynamic peers (a fifth of the peers down and back), the mutating
    overlay (a churn storm's writes) and PX as S = 2 ensembles on the card:
    each sim equals its one-sim run under ``with_sim_key`` on every leaf
    (the scatters with a spill slot, ``state._scatter_drop`` and
    ``topo.dynamics._drop_index``, batched)."""
    from go_libp2p_pubsub_tpu_torch import driver, ensemble
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    n, s, rounds = 512, 2, 16
    po, pt, pv = (torch.as_tensor(a, device=cuda) for a in sweep.publish_schedule(rounds, n, 1))
    kind, _, what = cell.partition("-")
    kw = {}
    if kind == "churn":
        r = 8 if what == "phase" else 1
        st, step, _t, _h = sweep.build_bench(n, 64, rounds_per_phase=r, device=cuda,
                                             dynamic_peers=True)
        up = torch.as_tensor(sweep.churn_up(n, rounds=rounds, down_at=2, up_at=10), device=cuda)
        if r > 1:
            kw = {"do_heartbeat": True}
            rows = [(po[8 * p:8 * p + 8], pt[8 * p:8 * p + 8], pv[8 * p:8 * p + 8], up[8 * p])
                    for p in range(rounds // 8)]
        else:
            rows = [(po[i], pt[i], pv[i], up[i]) for i in range(rounds)]
    elif kind == "overlay":
        st, step, storm, _s = sweep.build_overlay(n, 64, rounds, edge_layout=what, device=cuda)
        writes, upw = (torch.as_tensor(a, device=cuda) for a in storm.build())
        rows = [(po[i], pt[i], pv[i], upw[i], writes[i]) for i in range(rounds)]
    else:
        st, step, _t, _h = sweep.build_bench(n, 64, px=True, device=cuda)
        rows = [(po[i], pt[i], pv[i]) for i in range(rounds)]
    ens = ensemble.lift_step(step)
    batched = ensemble.batch_states(st, s)
    for row in rows:
        batched = ens(batched, *(ensemble.tile(x, s) for x in row), **kw)
    for i in range(s):
        one = ensemble.with_sim_key(st, st.core.key, i)
        for row in rows:
            one = step(one, *row, **kw)
        for a, b in zip(driver._leaves(one), driver._leaves(ensemble.unbatch(batched, i))):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_every_launch_takes_the_one_sims_entry(cuda):
    """Each kernel library exports one C entry a kernel, ``{name}_sims``; a
    one-sim launch is that entry with S = 1 and null strides, and equals
    the kernel's plain version."""
    for mod, names in ((fr, ("edge_exchange", "fused_delivery")), (db, ("delivery_banded",)),
                       (cd, ("csr_delivery",)), (sk, ("select_topk",))):
        lib = mod._lib()
        for name in names:
            with pytest.raises(AttributeError):
                getattr(lib, f"{name}_launch")
            assert getattr(lib, f"{name}_sims").restype is not None
    lib = sk._lib()
    orig, seen = lib.select_topk_sims, []

    def record(*args):
        seen.append(args)
        return orig(*args)

    rng = np.random.default_rng(5)
    values = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    mask = torch.from_numpy(rng.random((300, 16)) < 0.7)
    k_rows = torch.from_numpy(rng.integers(0, 17, 300).astype(np.int32))
    noise = torch.from_numpy(rng.random((300, 16)).astype(np.float32))
    lib.select_topk_sims = record
    try:
        got = sk.select_topk(*(t.to(cuda) for t in (values, mask, k_rows, noise)))
        torch.cuda.synchronize()
    finally:
        lib.select_topk_sims = orig
    assert len(seen) == 1 and seen[0][-3] == 1 and seen[0][-2] is None
    assert torch.equal(got.cpu(), sk.select_topk(values, mask, k_rows, noise))


@pytest.mark.cuda
def test_supervised_window_on_the_card_equals_the_bare_window(cuda, tmp_path):
    """The ``_child`` cell supervised on the card (probes, the checker every
    4 dispatches, a checkpoint every segment) ends in the bare segmented
    window's state and the CPU run's, with one capture a window shape; a
    NaN injected after dispatch 2 of segment 1 is rolled back and localised
    to dispatch 6, with the same final state (the evidence is read before
    the rollback's replay reuses the window's buffers); so is a counter
    corrupted there, which only a cloned counters snapshot shows (an
    aliased one would hold the window's own buffer, the corruption
    compared with itself)."""
    from go_libp2p_pubsub_tpu_torch import ensemble, serve
    from go_libp2p_pubsub_tpu_torch.oracle import InvariantConfig, ScanInvariants
    from go_libp2p_pubsub_tpu_torch.serve import _child

    n, rounds, seg = 256, 16, 4
    digests = {}
    for dev in (cuda, "cpu"):
        step, make_args, template_fn, net, cfg = _child.build_cell(n, rounds, 7, 0.1,
                                                                   device=dev)
        bare = ensemble.WindowRunner(step, rounds, segment_len=seg).run(template_fn(),
                                                                       make_args)
        digests[(str(dev), "bare")] = serve.state_digest(bare.states)
        for name, plan in (("clean", None),
                           ("nan", serve.FaultPlan(corrupt_segment=1, corrupt_dispatch=2)),
                           ("events", serve.FaultPlan(corrupt_segment=1, corrupt_dispatch=2,
                                                      corrupt_kind="events"))):
            spec = ScanInvariants("gossipsub", net, cfg,
                                  InvariantConfig(check_every=4, delivery_window=16),
                                  batched=False)
            sup = serve.Supervisor(step, make_args, template_fn,
                                   str(tmp_path / f"{dev}-{name}"),
                                   serve.ServiceConfig(n_dispatches=rounds, segment_len=seg,
                                                       report_name=None),
                                   invariants=spec, faults=plan)
            rep = sup.run()
            digests[(str(dev), name)] = serve.state_digest(rep.states)
            if plan is not None:
                b = rep.bundles[0]
                assert rep.recoveries == 1 and b["first_bad_dispatch"] == 6
                assert os.path.isfile(os.path.join(b["path"], "bundle.json"))
            if name == "nan":
                assert b["nan_census"] == {".scores": 1}
            if name == "events":
                assert "events-monotone" in b["window_probe_failures"]
                assert b["nan_census"] == {}
            if dev is cuda:
                assert rep.window_compiles == {f"L{seg}": 1}
    assert len(set(digests.values())) == 1, digests
