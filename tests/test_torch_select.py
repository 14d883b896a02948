"""The heartbeat selection of the port against the JAX package's: the plain
version of the ``select_topk`` kernel against ``select_topk_pallas`` (run
in interpret mode), the port's one pairwise rank against both of the JAX
package's forms (the pairwise count and the sort composite of
``fused=True``), and every selection function against its JAX twin under
either ``fused`` value and the same threefry key. Inputs are made
with numpy and hold the hazards of the order: quantized values and noise
(ties), -0.0 beside +0.0, all-masked rows, and widths below 0 and above K.
The kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py and by chip_smoke.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu.ops import pallas_csr as jpcsr
from go_libp2p_pubsub_tpu.ops import select as jsel
from go_libp2p_pubsub_tpu_torch import prng
from go_libp2p_pubsub_tpu_torch.ops import select as tsel
from go_libp2p_pubsub_tpu_torch.ops import select_topk as tsk
from torch_parity import HAZARD_K, hazard_rows

ZEROS = np.array([-1.5, -0.0, 0.0, 0.5, 2.0], np.float32)


def _rows(rng, r, k):
    """(values, mask, k_rows, noise) with ties, signed zeros, all-masked
    rows and widths from -1 to K + 1."""
    values = rng.choice(ZEROS, size=(r, k))
    mask = rng.random((r, k)) < 0.7
    mask[:2] = False
    mask[2] = True
    noise = rng.choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), size=(r, k))
    k_rows = rng.integers(-1, k + 2, size=(r,)).astype(np.int32)
    return values, mask, k_rows, noise


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _eq(ref, got, msg=""):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype, msg)
    np.testing.assert_array_equal(ref, got, err_msg=msg)


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_plain_equals_pallas_on_its_test_inputs(trial):
    """The inputs of the JAX package's own select_topk_pallas test."""
    rng = np.random.default_rng(5)
    r, k = 64, 16
    for _ in range(trial + 1):
        values = rng.integers(0, 4, size=(r, k)).astype(np.float32)
        mask = rng.random((r, k)) < 0.7
        noise = rng.integers(0, 3, size=(r, k)).astype(np.float32) / 2.0
        k_arr = rng.integers(0, k + 1, size=(r,)).astype(np.int32)
    want = jpcsr.select_topk_pallas(jnp.asarray(values), jnp.asarray(mask),
                                    jnp.asarray(k_arr), jnp.asarray(noise),
                                    block=16, interpret=True)
    _eq(want, tsk.select_topk(*_torch(values, mask, k_arr, noise)))


@pytest.mark.parametrize("k", [5, 16, 64])
def test_plain_equals_pallas_at_heartbeat_widths(k):
    rng = np.random.default_rng(k)
    values, mask, k_rows, noise = _rows(rng, 32, k)
    want = jpcsr.select_topk_pallas(jnp.asarray(values), jnp.asarray(mask),
                                    jnp.asarray(k_rows), jnp.asarray(noise),
                                    block=8, interpret=True)
    before = tsk.LAUNCHES["select_topk"]
    got = tsk.select_topk(*_torch(values, mask, k_rows, noise))
    _eq(want, got)
    assert tsk.LAUNCHES["select_topk"] == before   # a CPU tensor: no launch
    # all-masked-out rows select nothing; a width past K selects every
    # masked slot
    assert not got[:2].any()
    wide = k_rows >= k
    assert torch.equal(got[wide], torch.from_numpy(mask[wide]))


@pytest.mark.parametrize("k", [5, 16, 64])
def test_pairwise_rank_equals_both_reference_forms(k):
    rng = np.random.default_rng(100 + k)
    values, mask, _k, noise = _rows(rng, 40, k)
    primary = np.where(mask, values, np.float32(-np.inf)).astype(np.float32)
    got = tsk.rank_desc_pairwise(*_torch(primary, noise))
    _eq(jsel._rank_desc_sorted(jnp.asarray(primary), jnp.asarray(noise)), got)
    _eq(jsel._rank_desc_pairwise(jnp.asarray(primary), jnp.asarray(noise)), got)
    # every row's ranks are a permutation of 0..K-1
    assert torch.equal(got.sort(-1).values,
                       torch.arange(k, dtype=torch.int32).expand(40, k))
    # every row's ranks are a permutation of 0..K-1
    assert torch.equal(got.sort(-1).values,
                       torch.arange(k, dtype=torch.int32).expand(40, k))


@pytest.mark.parametrize("k", HAZARD_K)
def test_plain_equals_pallas_on_hazard_rows(k):
    """The hazard rows the card's select_topk tests use (masked +-inf and
    NaN, NaN noise, subnormal values and noise, equal rows, empty and full
    masks, widths -1 to K+1): the port's plain version equals
    select_topk_pallas, both given the same unflushed rows."""
    values, mask, k_rows, noise = hazard_rows(k, 40, k)
    assert (np.abs(values[np.isfinite(values)]) < np.finfo(np.float32).tiny).any()
    want = jpcsr.select_topk_pallas(jnp.asarray(values), jnp.asarray(mask),
                                    jnp.asarray(k_rows), jnp.asarray(noise),
                                    block=8, interpret=True)
    _eq(want, tsk.select_topk(*_torch(values, mask, k_rows, noise)), f"K={k}")


def _one_row(values, mask, noise, k):
    v, m, nz = (np.asarray(x)[None] for x in (values, mask, noise))
    kr = np.array([k], np.int32)
    got = tsk.select_topk(*_torch(v.astype(np.float32), m, kr, nz.astype(np.float32)))[0]
    want = jpcsr.select_topk_pallas(jnp.asarray(v, jnp.float32), jnp.asarray(m),
                                    jnp.asarray(kr), jnp.asarray(nz, jnp.float32),
                                    block=1, interpret=True)[0]
    _eq(want, got)
    return got.numpy()


def test_masked_nan_ranks_first_and_outranks_nothing():
    """A masked NaN value compares false both ways: nothing outranks it
    (rank 0, selected from k=1) and it outranks nothing (the other masked
    slots keep the ranks they have without it)."""
    values = [1.0, np.nan, 3.0, 2.0, 0.0]
    mask = [True, True, True, True, False]
    noise = [0.0] * 5
    assert _one_row(values, mask, noise, 1).tolist() == [False, True, True, False, False]
    assert _one_row(values, mask, noise, 2).tolist() == [False, True, True, True, False]
    assert _one_row(values, mask, noise, 3).tolist() == [True, True, True, True, False]


def test_masked_neg_inf_is_outranked_by_unmasked_slots():
    """A masked -inf value ties with every unmasked slot (-inf as well), so
    unmasked slots of higher noise, or equal noise and lower index, outrank
    it: a width equal to the masked count need not select it."""
    values = [-np.inf, 5.0, 7.0, 1.0]
    mask = [False, True, False, True]
    noise = [0.5, 0.0, 0.0, 0.0]
    mask[0] = True
    # slot 0 (masked, -inf, noise 0.5) against unmasked slot 2 (-inf, 0.0)
    assert _one_row(values, mask, noise, 3).tolist() == [True, True, False, True]
    values = [3.0, -np.inf, 1.0, 2.0]
    mask = [False, True, False, True]
    noise = [0.9, 0.1, 0.0, 0.0]
    # unmasked slot 0 (-inf, noise 0.9) outranks masked slot 1: rank 2 there
    assert _one_row(values, mask, noise, 2).tolist() == [False, False, False, True]
    assert _one_row(values, mask, noise, 3).tolist() == [False, True, False, True]


def test_subnormals_rank_exactly_where_the_reference_flushes_them():
    """XLA on the CPU (as a TPU) flushes float32 subnormals to zero, so the
    reference ties 1e-45 with 0.0 and breaks the tie on noise; the port
    flushes them too and selects the same slot. Subnormal noise ties with
    zero noise the same way, and the tie falls to the lower index."""
    values = np.array([[1e-45, 0.0], [-1e-40, -0.0], [2.0, 2.0]], np.float32)
    mask = np.ones((3, 2), bool)
    noise = np.array([[0.0, 0.5], [0.0, 0.25], [0.0, 1e-45]], np.float32)
    kr = np.array([1, 1, 1], np.int32)
    want = jpcsr.select_topk_pallas(jnp.asarray(values), jnp.asarray(mask), jnp.asarray(kr),
                                    jnp.asarray(noise), block=1, interpret=True)
    got = tsk.select_topk(*_torch(values, mask, kr, noise))
    assert np.asarray(want).tolist() == [[False, True], [False, True], [True, False]]
    _eq(want, got)


def _select_case(name, fused, vals, mask, width, jk, tk):
    """(JAX result under ``fused``, port result) of one selection
    function."""
    jv, jm, jw = jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(width)
    tv, tm, tw = _torch(vals, mask, width)
    if name == "topk_key":
        return (jsel.select_topk_mask(jv, jm, jw, jk, fused=fused),
                tsel.select_topk_mask(tv, tm, tw, tk))
    if name == "topk_scalar":
        return (jsel.select_topk_mask(-jv, jm, 3, fused=fused),
                tsel.select_topk_mask(-tv, tm, 3))
    if name == "random":
        return (jsel.select_random_mask(jk, jm, jw, fused=fused),
                tsel.select_random_mask(tk, tm, tw))
    if name == "width_topk":
        return (jsel.masked_width_topk(jv, jm, jw, 12, key=jk, fused=fused),
                tsel.masked_width_topk(tv, tm, tw, 12, key=tk))
    return (jsel.masked_width_random(jk, jm, jw, 12, fused=fused),
            tsel.masked_width_random(tk, tm, tw, 12))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["topk_key", "topk_scalar", "random", "width_topk",
                                  "width_random"])
def test_selections_equal_reference(name, fused):
    rng = np.random.default_rng(7)
    shape = (24, 2, 16)
    vals = rng.choice(ZEROS, size=shape)
    mask = rng.random(shape) < 0.6
    mask[0] = False
    width = rng.integers(-2, 20, size=shape[:-1]).astype(np.int32)
    jk = jax.random.fold_in(jax.random.key(3), 9)
    tk = prng.fold_in(prng.key(3), 9)
    want, got = _select_case(name, fused, vals, mask, width, jk, tk)
    _eq(want, got, name)


def _good(r=8, k=16):
    return [torch.zeros((r, k)), torch.ones((r, k), dtype=torch.bool),
            torch.full((r,), 3, dtype=torch.int32), torch.zeros((r, k))]


@pytest.mark.parametrize("bad", [
    "int_values", "values_3d", "no_rows", "k_too_wide", "mask_dtype", "k_rows_int64",
    "noise_shape", "noise_f64", "not_contiguous", "other_device",
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args = _good()
    if bad == "int_values":
        args[0] = torch.zeros((8, 16), dtype=torch.int32)
    elif bad == "values_3d":
        args[0] = torch.zeros((8, 1, 16))
    elif bad == "no_rows":
        args = _good(r=0)
    elif bad == "k_too_wide":
        args = _good(k=tsk.MAX_K + 1)
    elif bad == "mask_dtype":
        args[1] = args[1].to(torch.uint8)
    elif bad == "k_rows_int64":
        args[2] = args[2].long()
    elif bad == "noise_shape":
        args[3] = torch.zeros((8, 15))
    elif bad == "noise_f64":
        args[3] = args[3].double()
    elif bad == "not_contiguous":
        args[1] = torch.ones((16, 8), dtype=torch.bool).t()
    else:
        args[3] = torch.zeros((8, 16), device="meta")
    with pytest.raises((ValueError, TypeError)):
        tsk.select_topk(*args)


def test_half_precision_values_rank_as_float32():
    rng = np.random.default_rng(1)
    values, mask, k_rows, noise = _rows(rng, 16, 16)
    v, m, kr, nz = _torch(values, mask, k_rows, noise)
    half = v.to(torch.bfloat16)
    assert torch.equal(tsk.select_topk(half, m, kr, nz),
                       tsk.select_topk(half.to(torch.float32), m, kr, nz))


@pytest.mark.parametrize("width", ["scalar", "rows", "tensor0d"])
def test_kernel_route_arguments_select_what_the_cpu_route_does(width):
    """On the card select_topk_mask hands select_topk its [R, K] rows
    (kernel_rows); on the CPU it ranks in place. Both give the same mask,
    here with the kernel's plain version standing in for it."""
    rng = np.random.default_rng(11)
    shape = (20, 3, 16)
    vals = torch.from_numpy(rng.choice(ZEROS, size=shape))
    base = vals[:, :1, :].expand(shape)            # a broadcast view, as scores_b
    mask = torch.from_numpy(rng.random(shape) < 0.6)
    k = {"scalar": 4, "rows": torch.from_numpy(rng.integers(-1, 18, size=shape[:-1])),
         "tensor0d": torch.tensor(6, dtype=torch.int32)}[width]
    key = prng.fold_in(prng.key(5), 2)
    for v in (vals, base):
        want = tsel.select_topk_mask(v, mask, k, key)
        rows = tsel.kernel_rows(v, mask, k, key)
        assert all(t.is_contiguous() for t in rows)
        assert torch.equal(tsk.select_topk(*rows).reshape(shape), want)
