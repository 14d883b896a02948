"""The delivery kernels and the heartbeat's select_topk kernel against
their plain versions on the card.

This file imports only the port (no JAX package), so it also runs on a
machine that has PyTorch with CUDA and nothing of the JAX stack:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Each test skips when no CUDA device is present. The plain versions are
held against the JAX package on the CPU in tests/test_torch_delivery.py
and tests/test_torch_select.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import graph, topo
from go_libp2p_pubsub_tpu_torch.ops import bitset
from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as cd
from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as db
from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk
from go_libp2p_pubsub_tpu_torch.state import Net
from torch_parity import HAZARD_K, HAZARD_M, hazard_graph, hazard_planes, hazard_rows


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
