"""The lifted per-round step under each subnormal cell
(``tests/torch_parity.SUBNORMAL_CELLS``) against the JAX package's lifted
build, every leaf every round, the plane's leaves carrying the raw
subnormal values, which the port flushes on the device (split from
tests/test_torch_lift.py, whose bench size it uses)."""

from __future__ import annotations

import numpy as np
import pytest
from test_torch_lift import N
from torch_parity import (
    SUBNORMAL_CELLS,
    bench_builds,
    lifted_planes,
    rounds_against_reference,
    subnormal_overrides,
)

from go_libp2p_pubsub_tpu_torch import convert


@pytest.mark.parametrize("cell", sorted(SUBNORMAL_CELLS))
def test_lifted_step_flushes_subnormals_as_the_reference(cell):
    """The lifted step under each subnormal cell, the plane's leaves
    carrying the raw subnormal values (flushed on the device): every leaf
    after every round."""
    builds = bench_builds(n=N, d=4, **subnormal_overrides(cell, N))
    rng = np.random.default_rng(2)
    po = rng.integers(0, N, size=(16, 4)).astype(np.int32)
    pv = rng.random((16, 4)) < 0.8
    st = rounds_against_reference(builds, 16, schedule=(po, np.zeros_like(po), pv),
                                  step_kw={"lift_scores": True}, plane=lifted_planes(builds))
    scores = convert.state_leaves(st)[".scores"]
    assert not np.any((scores != 0) & (np.abs(scores) < np.finfo(np.float32).tiny))
