"""``fused_delivery_plain`` against the JAX package's Pallas
``fused_delivery`` in interpret mode on the hazard bands at M = 96 and 300
(W = 3, 10): the cases of tests/test_torch_fused_round_hazards.py's test
past two words a row, split off so that each file stays within a loadfile
worker's share of the suite; every case keeps its name and its config."""

from __future__ import annotations

import pytest
from test_torch_fused_round import FUSED_BANDS
from test_torch_fused_round_hazards import NARROW_M, check_fused_hazard
from torch_parity import HAZARD_BAND_M


@pytest.mark.parametrize("band", FUSED_BANDS, ids=[b["name"] for b in FUSED_BANDS])
@pytest.mark.parametrize("m", [m for m in HAZARD_BAND_M if m not in NARROW_M])
def test_fused_delivery_plain_equals_pallas_on_hazard_bands(band, m):
    check_fused_hazard(band, m)
