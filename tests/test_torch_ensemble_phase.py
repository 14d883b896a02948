"""The phase engine as an ensemble (``go_libp2p_pubsub_tpu_torch.ensemble``)
against the JAX package's on the CPU, bit for bit, on the stacked coalesced
wire path (N=48, M=64, 2 phases; the twin of ``tests/test_ensemble.py``'s
``test_s1_parity_phase_stacked_wire``): at r = 1 and r = 8 the port's S = 3
ensemble equals the JAX ensemble on every leaf, sim ``i`` equals the port's
one-sim run from ``with_sim_key(state, sim_key, i)``, and an S = 1 ensemble
equals sim 0 (which the JAX package's own tests hold equal to its S = 1
run). The JAX run is ``run_rounds`` with a heartbeat every phase, its
rounds ``2 r``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu import ensemble as jens
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake

from go_libp2p_pubsub_tpu_torch import convert, ensemble
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from test_torch_ensemble import M, S, gossip_builds, port_state, schedule
from torch_parity import diff_leaves, jinit, reference_leaves

PHASES = 2


@pytest.mark.parametrize("r", [1, 8])
def test_ensemble_phase_stacked_wire(r):
    jcfg, jnet, jsp, tcfg, tnet, tsp = gossip_builds(None, seed=7, heartbeat_every=r)
    assert jcfg.wire_coalesced and tcfg.wire_coalesced
    po, pt, pv = (a.reshape(PHASES, r, -1) for a in schedule(PHASES * r, seed=7))
    init = lambda: jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=8)  # noqa: E731
    jrun = jens.run_rounds(
        jens.lift_step(jmake(jcfg, jnet, r, score_params=jsp)), jens.batch_states(init(), S),
        lambda p: (jens.tile(po[p], S), jens.tile(pt[p], S), jens.tile(pv[p], S)), PHASES,
        rounds_per_phase=r, heartbeat_fn=lambda p: True)
    tst0 = port_state(init())
    step = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp)
    ens = ensemble.lift_step(step)

    def margs(s):
        return lambda p: tuple(ensemble.tile(torch.from_numpy(a[p]), s) for a in (po, pt, pv))

    trun = ensemble.run_rounds(ens, ensemble.batch_states(tst0, S), margs(S), PHASES,
                               rounds_per_phase=r, heartbeat_fn=lambda p: True)
    assert trun.rounds == PHASES * r and trun.compiles == -1
    diff_leaves(reference_leaves(jrun.states), convert.state_leaves(trun.states),
                f"phase r={r} S={S}")
    key = tst0.core.key
    for i in range(S):
        one = ensemble.with_sim_key(tst0, key, i)
        for p in range(PHASES):
            one = step(one, *(torch.from_numpy(a[p]) for a in (po, pt, pv)), do_heartbeat=True)
        diff_leaves(convert.state_leaves(one),
                    convert.state_leaves(ensemble.unbatch(trun.states, i)),
                    f"phase r={r} sim {i}")
    run1 = ensemble.run_rounds(ens, ensemble.batch_states(tst0, 1), margs(1), PHASES,
                               rounds_per_phase=r, heartbeat_fn=lambda p: True)
    diff_leaves(convert.state_leaves(ensemble.unbatch(trun.states, 0)),
                convert.state_leaves(ensemble.unbatch(run1.states, 0)), f"phase r={r} S=1")
    fr = trun.states.core.dlv.first_round.numpy()
    assert not np.array_equal(fr[0], fr[1])
