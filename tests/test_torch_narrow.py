"""The int16 IHAVE flood-protection counters (``cfg.narrow_counters``) of
the port, against the JAX package's.

Under ``narrow_counters`` ``peerhave`` and ``iasked`` are int16, ``[N, K]``
dense and ``[E]`` CSR-resident. The narrowing is exact: both counters clear
every heartbeat, ``iasked`` saturates at the MaxIHaveLength cap it gates
on, and ``peerhave`` grows at most once a round, so ``build`` refuses a cap
or a heartbeat cadence outside int16, as the JAX package's does. Every
write must land as int16 (torch promotes ``int16 + int32`` and integer
sums), which the leaf comparison checks by dtype, every round or phase:
the per-round step with a heartbeat every 3 rounds on the banded lattice,
and the phase engine CSR-resident. The port
runs with ``device="cpu"``; no tolerance on any leaf."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (
    bench_builds,
    jinit,
    phases_against_reference,
    reference_leaves,
    rounds_against_reference,
)

from go_libp2p_pubsub_tpu import config as jconfig
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu_torch import config as tconfig
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg

N = 96
NARROW = dict(narrow_counters=True)


class CounterLog:
    """An ``observe`` callback: the counters' dtype and largest values."""

    def __init__(self):
        self.peerhave = self.iasked = 0

    def __call__(self, st):
        assert st.peerhave.dtype == st.iasked.dtype == torch.int16
        self.peerhave = max(self.peerhave, int(st.peerhave.max()))
        self.iasked = max(self.iasked, int(st.iasked.max()))


def test_narrow_rounds_equal_reference():
    builds = bench_builds(n=N, d=4, heartbeat_every=3, options=NARROW)
    log = CounterLog()
    rounds_against_reference(builds, 16, observe=log)
    assert log.peerhave > 0 and log.iasked > 1, (log.peerhave, log.iasked)


def test_narrow_phases_csr_equal_reference():
    builds = bench_builds(n=N, d=4, heartbeat_every=4, edge_layout="csr", fused=True,
                          options=NARROW)
    log = CounterLog()
    st = phases_against_reference(builds, 2, 4, 16, observe=log)
    assert st.peerhave.shape == (builds[4].n_edges,) and log.peerhave > 0


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_narrow_state_converts_both_ways(layout):
    """The int16 leaves keep their dtype from the JAX state to the port's
    and back."""
    jcfg, jnet, jsp, _tcfg, _tnet, _tsp = bench_builds(
        n=N, d=4, edge_layout=layout, fused=layout == "csr", options=NARROW)
    want = reference_leaves(jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=1))
    st = convert.state_from_reference(want, device="cpu")
    assert st.peerhave.dtype == st.iasked.dtype == torch.int16
    got = convert.state_leaves(st)
    for p in (".peerhave", ".iasked"):
        assert got[p].dtype == want[p].dtype == np.int16
        np.testing.assert_array_equal(got[p], want[p])


@pytest.mark.parametrize("field,value", [
    ("max_ihave_length", 32768), ("heartbeat_every", 32768),
    ("max_ihave_length", 32767), ("heartbeat_every", 32767),
])
def test_build_refuses_out_of_range(field, value):
    """Both packages refuse a cap or a cadence an int16 counter cannot
    hold, and build one it can."""
    refused = value >= 32768
    for cfg_cls, cfgmod in ((JCfg, jconfig), (TCfg, tconfig)):
        kw = dict(narrow_counters=True)
        params = cfgmod.GossipSubParams()
        if field == "heartbeat_every":
            kw["heartbeat_every"] = value
        else:
            params = dataclasses.replace(params, max_ihave_length=value)
        if refused:
            with pytest.raises(ValueError, match="narrow_counters needs"):
                cfg_cls.build(params, **kw)
        else:
            assert cfg_cls.build(params, **kw).narrow_counters
        # without the narrowing any value builds
        kw["narrow_counters"] = False
        assert not cfg_cls.build(params, **kw).narrow_counters
