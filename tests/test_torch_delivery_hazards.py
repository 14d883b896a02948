"""Hazard bands of tests/test_torch_delivery.py's ``delivery_banded_plain``
check (split from it so that each file stays within a loadfile worker's
share of the suite): the ring lattices with K = 16 (N = 17 under the
staged window, N = 1000), at W = 1, 2, 3 and 10, against
delivery_round_banded in interpret mode (K = 24 and 40 are
tests/test_torch_delivery_hazards_wide.py)."""

from __future__ import annotations

import pytest
from test_torch_delivery import check_banded_hazard, hazard_cases
from torch_parity import HAZARD_BAND_M


@pytest.mark.parametrize("band", **hazard_cases("hazards"))
@pytest.mark.parametrize("m", HAZARD_BAND_M)
def test_banded_plain_equals_the_tpu_kernel_on_hazard_bands(band, m):
    check_banded_hazard(band, m)
