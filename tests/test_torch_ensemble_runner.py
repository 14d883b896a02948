"""The port's ensemble runner (``go_libp2p_pubsub_tpu_torch.ensemble.
runner``) with the invariant oracle, against the JAX package's on the CPU
(the twins of ``tests/test_window.py``'s folded-invariant cases): the
per-dispatch ``run_rounds`` with a batched ``InvariantHook`` and the
window-folded ``WindowRunner`` with ``ScanInvariants`` over two segments
(``on_segment`` between them, device observations stacked) give the JAX
package's final states, verdicts, ticks, observations and segment states
bit for bit, clean and with a seeded violation; the runner's refusals;
``compiles``: -1 for ``run_rounds`` (no compile cache), the window's
capture growth (0 on the CPU, where a window is the plain loop; one
capture on the card, ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` phase 44); ``shard_ensemble_state`` refused."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_libp2p_pubsub_tpu import ensemble as jens
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu.oracle import invariants as jinv

from go_libp2p_pubsub_tpu_torch import convert, ensemble
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
from test_torch_ensemble import M, gossip_builds, port_margs, port_state, schedule
from torch_parity import diff_leaves, jinit, reference_leaves

S = 2
ROUNDS = 8
SEG = 4


def flap_cell(seed: int = 11):
    """``tests/test_window.py``'s flap cell on both packages: the per-round
    step under i.i.d. loss 0.4, S = 2 sims, 8 rounds."""
    jcfg, jnet, jsp, tcfg, tnet, tsp = gossip_builds(dict(loss_rate=0.4), seed=seed)
    po, pt, pv = schedule(ROUNDS, seed=seed)
    jst = jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=seed + 1)
    tst = port_state(jst)
    jstep = jens.lift_step(jmake(jcfg, jnet, score_params=jsp))
    tstep = ensemble.lift_step(make_gossipsub_step(tcfg, tnet, score_params=tsp))
    jmargs = lambda i: (jens.tile(po[i], S), jens.tile(pt[i], S),   # noqa: E731
                        jens.tile(pv[i], S))
    return (jcfg, jnet, jst, jstep, jmargs), (tcfg, tnet, tst, tstep, port_margs(po, pt, pv, S))


def corrupt_jax(states):
    """A first-receipt stamp on a never-born slot (``msgtable-wf``'s
    negative shape), every sim."""
    dlv = states.core.dlv
    fr = dlv.first_round.at[:, 0, -1].set(0)
    return states.replace(core=states.core.replace(dlv=dlv.replace(first_round=fr)))


def corrupt_port(states):
    from go_libp2p_pubsub_tpu_torch.state import replace

    dlv = states.core.dlv
    fr = dlv.first_round.clone()
    fr[:, 0, -1] = 0
    return replace(states, core=replace(states.core, dlv=replace(dlv, first_round=fr)))


def same_report(got, want, where):
    assert got.names == want.names, where
    assert got.ticks == want.ticks, where
    assert np.array_equal(got.ok, want.ok), where


@pytest.mark.parametrize("seeded", [False, True])
def test_run_rounds_and_window_with_the_oracle(seeded):
    (jcfg, jnet, jst, jstep, jmargs), (tcfg, tnet, tst, tstep, tmargs) = flap_cell()
    jb, tb = jens.batch_states(jst, S), ensemble.batch_states(tst, S)
    if seeded:
        jb, tb = corrupt_jax(jb), corrupt_port(tb)
    icfg = dict(check_every=SEG)

    # the per-dispatch hook
    jhook = jinv.InvariantHook("gossipsub", jnet, jcfg, jinv.InvariantConfig(**icfg))
    jrun = jens.run_rounds(jstep, jb, jmargs, ROUNDS, invariants=jhook)
    thook = inv.InvariantHook("gossipsub", tnet, tcfg, inv.InvariantConfig(**icfg))
    trun = ensemble.run_rounds(tstep, tb, tmargs, ROUNDS, invariants=thook)
    assert trun.compiles == -1 and trun.dispatches == ROUNDS
    same_report(trun.invariant_report, jhook.report(), "hook")
    same_report(thook.report(), jhook.report(), "hook report()")
    assert trun.invariant_report.all_ok != seeded
    diff_leaves(reference_leaves(jrun.states), convert.state_leaves(trun.states), "run_rounds")

    # the window, two segments, the checker folded in, observations stacked
    def jobs(s):
        return {"deliver": s.core.events[:, 3], "mesh": s.mesh.sum((1, 2, 3), dtype=jnp.int32)}

    def tobs(s):
        return {"deliver": s.core.events[:, 3], "mesh": s.mesh.sum((1, 2, 3), dtype=torch.int32)}

    segs = {"jax": [], "port": []}
    jspec = jinv.ScanInvariants("gossipsub", jnet, jcfg, jinv.InvariantConfig(**icfg))
    jwin = jens.WindowRunner(jstep, ROUNDS, invariants=jspec, observe=jobs,
                             segment_len=SEG).run(
        corrupt_jax(jens.batch_states(jst, S)) if seeded else jens.batch_states(jst, S),
        jmargs, on_segment=lambda g, s: segs["jax"].append((g, reference_leaves(s))))
    tspec = inv.ScanInvariants("gossipsub", tnet, tcfg, inv.InvariantConfig(**icfg))
    twin = ensemble.WindowRunner(tstep, ROUNDS, invariants=tspec, observe=tobs,
                                 segment_len=SEG).run(
        corrupt_port(ensemble.batch_states(tst, S)) if seeded else ensemble.batch_states(tst, S),
        tmargs, on_segment=lambda g, s: segs["port"].append((g, convert.state_leaves(s))))
    assert twin.dispatches == ROUNDS // SEG and twin.compiles == 0     # no capture on the CPU
    assert twin.n_sims == S and twin.rounds == ROUNDS
    same_report(twin.invariant_report, jwin.invariant_report, "window")
    # the folded checker agrees with the hook (its first monotone check
    # compares against the window-entry counters, a tautology both ways here)
    assert np.array_equal(twin.invariant_report.ok, trun.invariant_report.ok)
    diff_leaves(reference_leaves(jwin.states), convert.state_leaves(twin.states), "window")
    diff_leaves(convert.state_leaves(trun.states), convert.state_leaves(twin.states),
                "window against run_rounds")
    assert [g for g, _ in segs["port"]] == [g for g, _ in segs["jax"]] == [0]
    diff_leaves(segs["jax"][0][1], segs["port"][0][1], "on_segment state")
    for k in ("deliver", "mesh"):
        assert np.array_equal(twin.observations[k], np.asarray(jwin.observations[k])), k
        assert twin.observations[k].shape == (ROUNDS, S)


def test_window_runner_dispatch():
    """``dispatch`` runs one segment's window call with this runner's due
    rows, and equals ``run``'s segment."""
    _j, (tcfg, tnet, tst, tstep, tmargs) = flap_cell(seed=13)
    spec = inv.ScanInvariants("gossipsub", tnet, tcfg, inv.InvariantConfig(check_every=SEG))
    runner = ensemble.WindowRunner(tstep, ROUNDS, invariants=spec, segment_len=SEG)
    st, ys = runner.dispatch(ensemble.batch_states(tst, S), runner.stack_args(tmargs, 0, SEG))
    assert ys["ok"].shape == (1, S, len(spec.names)) and bool(ys["ok"].all())
    gold = ensemble.run_rounds(tstep, ensemble.batch_states(tst, S), tmargs, SEG)
    diff_leaves(convert.state_leaves(gold.states), convert.state_leaves(st), "dispatch")


def test_runner_refusals():
    _j, (tcfg, tnet, tst, tstep, tmargs) = flap_cell(seed=15)
    with pytest.raises(ValueError, match="does not divide the 8-dispatch window"):
        ensemble.WindowRunner(tstep, ROUNDS, segment_len=3)
    with pytest.raises(ValueError, match="minimal period 8 does not divide segment_len=4"):
        ensemble.WindowRunner(tstep, ROUNDS, segment_len=4,
                              heartbeat_fn=lambda i: i % 3 == 0)
    spec = inv.ScanInvariants("gossipsub", tnet, tcfg, inv.InvariantConfig(check_every=8))
    with pytest.raises(ValueError, match="must be a multiple of the invariant check_every 8"):
        ensemble.WindowRunner(tstep, ROUNDS, segment_len=4, invariants=spec)
    runner = ensemble.WindowRunner(tstep, ROUNDS)
    with pytest.raises(ValueError, match="ragged tuples"):
        runner.stack_args(lambda i: tmargs(i)[: 2 + i % 2], 0, 2)
    with pytest.raises(NotImplementedError, match="item 7"):
        ensemble.shard_ensemble_state(ensemble.batch_states(tst, S), None, tnet.n_peers)
