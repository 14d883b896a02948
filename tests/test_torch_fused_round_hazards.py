"""``fused_delivery_plain`` against the JAX package's Pallas
``fused_delivery`` in interpret mode on the hazard bands at M = 20 and 64
(split from tests/test_torch_fused_round.py, whose helpers it uses, so that
each file stays within a loadfile worker's share of the suite; M = 96 and
300 are tests/test_torch_fused_round_hazards_wide.py). Each case compiles
the interpreted kernel once: the cost is the case count."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_fused_round import FUSED_BANDS, _t, _u
from torch_parity import HAZARD_BAND_M, hazard_fused_args

from go_libp2p_pubsub_tpu.ops import fused_round as jfr
from go_libp2p_pubsub_tpu_torch.ops import fused_round as tfr


#: the slot counts of this file's cases (W = 1, 2); the wide file takes the
#: rest of HAZARD_BAND_M
NARROW_M = HAZARD_BAND_M[:2]


@pytest.mark.parametrize("band", FUSED_BANDS, ids=[b["name"] for b in FUSED_BANDS])
@pytest.mark.parametrize("m", NARROW_M)
def test_fused_delivery_plain_equals_pallas_on_hazard_bands(band, m):
    check_fused_hazard(band, m)


def check_fused_hazard(band, m):
    """The hazard bands of the card's fused_delivery tests
    (tests/torch_parity.hazard_bands, K <= 16): ring lattices with K = 2, 6
    and 16, N not a multiple of the kernel's block, N=17 under the staged
    window, a circulant with steps 333 and 500 = N/2, at W = 1, 2, 3 and 10,
    with scores on the thresholds and at subnormals. The plain version
    equals the Pallas kernel in interpret mode, under a config that turns
    with the case (scores, cohorts, retrans_cap 0-3)."""
    n, off, rev = band["n"], band["offsets"], band["revs"]
    i = FUSED_BANDS.index(band) + HAZARD_BAND_M.index(m)
    score_enabled, want_cohorts, cap = i % 2 == 0, i % 3 != 2, i % 4
    args = hazard_fused_args(m + i, band, m)
    if not score_enabled:
        args[4] = None
    static = dict(offsets=off, revs=rev, w=(m + 31) // 32, score_enabled=score_enabled,
                  want_cohorts=want_cohorts, retrans_cap=cap)
    block = jfr.pick_block(n, off) or n    # a halo past every block: one block of N
    ref = jfr.fused_delivery(*[None if a is None else jnp.asarray(a) for a in args],
                             -10.0, -50.0, block=block, interpret=True, **static)
    got = tfr.fused_delivery(*[None if a is None else _t(a) for a in args], -10.0, -50.0,
                             **static)
    assert sorted(ref) == sorted(got)
    for name in ref:
        np.testing.assert_array_equal(np.asarray(ref[name]), _u(got[name]),
                                      err_msg=f"{band['name']} M={m} {name}")
