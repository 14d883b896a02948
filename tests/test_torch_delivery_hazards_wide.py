"""The K = 24 and K = 40 hazard bands (rings with N = 250, not a multiple
of the kernel's block, and N = 200) of tests/test_torch_delivery.py's
``delivery_banded_plain`` check, at W = 1, 2, 3 and 10, against
delivery_round_banded in interpret mode (split from it so that each file
stays within a loadfile worker's share of the suite)."""

from __future__ import annotations

import pytest
from test_torch_delivery import check_banded_hazard, hazard_cases
from torch_parity import HAZARD_BAND_M


@pytest.mark.parametrize("band", **hazard_cases("wide"))
@pytest.mark.parametrize("m", HAZARD_BAND_M)
def test_banded_plain_equals_the_tpu_kernel_on_hazard_bands(band, m):
    check_banded_hazard(band, m)
