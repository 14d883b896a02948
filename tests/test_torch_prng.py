"""The port's threefry2x32 (go_libp2p_pubsub_tpu_torch/prng.py) against
``jax.random`` with its default threefry implementation."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import prng


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.uint32)


def _pk(k):
    return k.numpy().astype(np.uint32)


def test_golden_values():
    assert prng.fold_in(prng.key(0), 7).tolist() == [2716826189, 292468403]
    np.testing.assert_array_equal(
        prng.uniform(prng.key(0), (3,)).numpy(),
        np.array([0.947667, 0.9785799, 0.33229148], np.float32))


def test_runs_under_threefry_partitionable():
    assert "threefry" in str(jax.config.jax_default_prng_impl)
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 5, 2**31 - 1, 4_000_000_000])
def test_key_and_fold_in(seed):
    jk, tk = jax.random.key(seed % 2**32 if seed < 2**31 else seed - 2**32), prng.key(seed)
    np.testing.assert_array_equal(_kd(jk), _pk(tk))
    for data in (0, 1, 7, 123, 2**31 - 1):
        np.testing.assert_array_equal(_kd(jax.random.fold_in(jk, data)),
                                      _pk(prng.fold_in(tk, data)))


def test_fold_in_takes_a_tensor_tick():
    import torch

    k = prng.key(3)
    np.testing.assert_array_equal(
        _pk(prng.fold_in(k, torch.tensor(41, dtype=torch.int32))),
        _pk(prng.fold_in(k, 41)))


@pytest.mark.parametrize("num", [1, 2, 6, 11])
def test_split(num):
    jk = jax.random.fold_in(jax.random.key(9), 17)
    tk = prng.fold_in(prng.key(9), 17)
    got = prng.split(tk, num)
    ref = jax.random.split(jk, num)
    assert len(got) == num
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_kd(r), _pk(g))


@pytest.mark.parametrize("shape", [(7,), (96, 1, 16), (5, 3, 4), (1,), (2, 33)])
def test_uniform(shape):
    for seed, tick in ((0, 0), (1, 12), (42, 999)):
        jk = jax.random.split(jax.random.fold_in(jax.random.key(seed), tick), 6)[4]
        tk = prng.split(prng.fold_in(prng.key(seed), tick), 6)[4]
        ref = np.asarray(jax.random.uniform(jk, shape))
        got = prng.uniform(tk, shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_rows_forms_equal_the_scalar_forms():
    """fold_in_rows and uniform_rows, row for row, equal fold_in and
    uniform (the phase engine draws a phase's fanout selections with them
    at its head) and the JAX package's threefry draws."""
    ticks = torch.arange(5, 13, dtype=torch.int32)
    base = prng.fold_in(prng.key(3), 77)
    rows = prng.fold_in_rows(prng.fold_in_rows(base, ticks), 0xFA40)
    got = prng.uniform_rows(rows, (4, 16))
    jbase = jax.random.fold_in(jax.random.key(3), 77)
    for i, t in enumerate(ticks.tolist()):
        k = prng.fold_in(prng.fold_in(base, t), 0xFA40)
        assert torch.equal(rows[i], k)
        assert torch.equal(got[i], prng.uniform(k, (4, 16)))
        jk = jax.random.fold_in(jax.random.fold_in(jbase, t), 0xFA40)
        want = np.asarray(jax.random.uniform(jk, (4, 16)))
        np.testing.assert_array_equal(got[i].numpy().view(np.uint32), want.view(np.uint32))
