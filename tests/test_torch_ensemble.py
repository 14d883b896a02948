"""The port's ensemble plane (``go_libp2p_pubsub_tpu_torch.ensemble``)
against the JAX package's (``go_libp2p_pubsub_tpu.ensemble``) on the CPU,
bit for bit, the twins of ``tests/test_ensemble.py`` (N=48, M=64, 6
rounds):

* the batched builders: ``sim_keys``, ``with_sim_key``, ``tile``,
  ``batch_states`` and ``unbatch`` give the JAX package's leaves;
* each engine (FloodSub, RandomSub, the per-round GossipSub step; the phase
  engine in ``test_torch_ensemble_phase.py``) run as an S = 3 ensemble
  equals the JAX ensemble on every leaf, sim ``i`` equals the port's
  unbatched run from ``with_sim_key(state, sim_key, i)``, and an S = 1
  ensemble equals sim 0 (which the JAX package's own tests hold equal to
  its S = 1 run: one JAX compile an engine serves both);
* the fault, GE and sampler streams differ between sims;
* a per-sim ``[S, N, K]`` ``link_deny`` runs S scenarios in one dispatch;
* a batched state round-trips through the v6 checkpoint with no version
  bump, a sim's slice loads as a plain v6 state, and the JAX package
  restores the port's batched file.

The port runs on the CPU, where every kernel wrapper takes its plain
version under ``torch.func.vmap``; the kernels' batching rules are held to
three one-sim launches on the card (``tests/test_torch_kernels_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from go_libp2p_pubsub_tpu import checkpoint as jcheckpoint
from go_libp2p_pubsub_tpu import ensemble as jens
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.chaos import ChaosConfig as JChaos
from go_libp2p_pubsub_tpu.chaos import faults as jfaults
from go_libp2p_pubsub_tpu.config import (
    GossipSubParams as JParams,
    PeerScoreParams as JScore,
    PeerScoreThresholds as JThr,
    TopicScoreParams as JTopic,
)
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu.models.randomsub import make_randomsub_step as jmake_random
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim

from go_libp2p_pubsub_tpu_torch import checkpoint, convert, ensemble, graph, prng
from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig
from go_libp2p_pubsub_tpu_torch.chaos import faults
from go_libp2p_pubsub_tpu_torch.config import (
    GossipSubParams,
    PeerScoreParams,
    PeerScoreThresholds,
    TopicScoreParams,
)
from go_libp2p_pubsub_tpu_torch.models.floodsub import floodsub_step
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig, make_gossipsub_step
from go_libp2p_pubsub_tpu_torch.models.randomsub import make_randomsub_step
from go_libp2p_pubsub_tpu_torch.state import Net
from torch_parity import diff_leaves, jinit, reference_leaves

N = 48
M = 64
ROUNDS = 6
S = 3


def nets(seed: int):
    """Both packages' Net of ``random_connect(N, 4, seed)`` (the generators
    are equal byte for byte), one topic every peer joins."""
    return (JNet.build(jgraph.random_connect(N, d=4, seed=seed), jgraph.subscribe_all(N, 1)),
            Net.build(graph.random_connect(N, d=4, seed=seed), graph.subscribe_all(N, 1),
                      device="cpu"))


def schedule(rounds: int, seed: int = 0, width: int = 4):
    """``tests/test_ensemble.py``'s schedule: publishes the first half."""
    rng = np.random.default_rng(seed)
    po = rng.integers(0, N, size=(rounds, width)).astype(np.int32)
    po[rounds // 2:] = -1
    pt = np.zeros((rounds, width), np.int32)
    pv = np.ones((rounds, width), bool)
    return po, pt, pv


def port_state(jst):
    """The port's state from a JAX state's leaves (the same bits)."""
    return convert.state_from_reference(reference_leaves(jst), device="cpu")


def key_of(st) -> torch.Tensor:
    return st.core.key if hasattr(st, "core") else st.key


def jax_margs(po, pt, pv, s, extra=()):
    return lambda i: (jens.tile(po[i], s), jens.tile(pt[i], s), jens.tile(pv[i], s),
                      *(jnp.asarray(x[i]) for x in extra))


def port_margs(po, pt, pv, s, extra=()):
    return lambda i: (ensemble.tile(torch.from_numpy(po[i]), s),
                      ensemble.tile(torch.from_numpy(pt[i]), s),
                      ensemble.tile(torch.from_numpy(pv[i]), s),
                      *(torch.from_numpy(np.asarray(x[i])) for x in extra))


def unbatched_run(step, st, po, pt, pv, rounds: int, extra=()):
    for i in range(rounds):
        st = step(st, *(torch.from_numpy(a[i]) for a in (po, pt, pv)),
                  *(torch.from_numpy(np.asarray(x[i])) for x in extra))
    return st


def hold(jrun_states, trun_states, step, tst0, po, pt, pv, where: str, extra=(),
         s1_step=None):
    """The port's S-sim ensemble equals the JAX one on every leaf, sim i
    equals the port's one-sim run from ``with_sim_key(state, key, i)``, and
    an S = 1 ensemble (``s1_step``, the lifted step) equals sim 0."""
    diff_leaves(reference_leaves(jrun_states), convert.state_leaves(trun_states),
                f"{where} S={S}")
    base = key_of(tst0)
    for i in range(S):
        one = unbatched_run(step, ensemble.with_sim_key(tst0, base, i), po, pt, pv,
                            po.shape[0], extra)
        diff_leaves(convert.state_leaves(one),
                    convert.state_leaves(ensemble.unbatch(trun_states, i)), f"{where} sim {i}")
    if s1_step is not None:
        run1 = ensemble.run_rounds(s1_step, ensemble.batch_states(tst0, 1),
                                   port_margs(po, pt, pv, 1, [x[:, :1] for x in extra]),
                                   po.shape[0])
        assert run1.n_sims == 1 and run1.compiles == -1
        diff_leaves(convert.state_leaves(ensemble.unbatch(trun_states, 0)),
                    convert.state_leaves(ensemble.unbatch(run1.states, 0)), f"{where} S=1")


# ---------------------------------------------------------------------------
# the builders


def test_exports_every_name_of_the_reference():
    want = {n for n in vars(jens) if not n.startswith("_")} - {"batch", "runner", "stats"}
    assert want <= set(vars(ensemble)), sorted(want - set(vars(ensemble)))


def test_batch_builders_equal_the_reference():
    jnet, tnet = nets(1)
    jst = jinit(JSim.init, N, M, seed=2, k=jnet.max_degree, chaos_ge=True)
    tst = port_state(jst)
    keys = ensemble.sim_keys(tst.key, 5)
    want = np.asarray(jax.random.key_data(jens.sim_keys(jst.key, 5)))
    assert keys.dtype == torch.int64 and np.array_equal(keys.numpy().astype(np.uint32), want)
    diff_leaves(reference_leaves(jens.batch_states(jst, S)),
                convert.state_leaves(ensemble.batch_states(tst, S)), "batch_states")
    other = jax.random.key(9)
    diff_leaves(reference_leaves(jens.batch_states(jst, 2, other)),
                convert.state_leaves(ensemble.batch_states(tst, 2, prng.key(9))),
                "batch_states(base_key)")
    for i in (0, 2):
        diff_leaves(reference_leaves(jens.with_sim_key(jst, jst.key, i)),
                    convert.state_leaves(ensemble.with_sim_key(tst, tst.key, i)),
                    f"with_sim_key {i}")
    b = ensemble.batch_states(tst, S)
    diff_leaves(reference_leaves(jens.unbatch(jens.batch_states(jst, S), 1)),
                convert.state_leaves(ensemble.unbatch(b, 1)), "unbatch")
    t = ensemble.tile(torch.arange(6, dtype=torch.int32).reshape(2, 3), 4)
    assert t.shape == (4, 2, 3) and t.is_contiguous()
    assert np.array_equal(t.numpy(), np.asarray(jens.tile(np.arange(6).reshape(2, 3), 4)))
    # the key leaves are found by path, not by dtype: an int64 [2] leaf
    # elsewhere stays tiled
    assert torch.equal(ensemble.batch_states(tst, 2).events[1], tst.events)


def test_stack_planes_refuses_mixed_static_weight():
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    a = sweep.bench_plane(device="cpu")
    b = sweep.bench_plane(device="cpu")
    stacked = ensemble.stack_planes([a, b])
    from go_libp2p_pubsub_tpu_torch.driver import _leaves

    for x, y in zip(_leaves(stacked), _leaves(a)):
        assert x.shape == (2,) + y.shape and torch.equal(x[1], y)
    assert stacked.app_specific_weight == a.app_specific_weight
    import dataclasses

    c = dataclasses.replace(b, app_specific_weight=a.app_specific_weight + 1.0)
    with pytest.raises(ValueError, match="app_specific_weight is a STATIC"):
        ensemble.stack_planes([a, c])


# ---------------------------------------------------------------------------
# the engines at S = 3 and S = 1


def test_ensemble_floodsub_under_loss():
    jnet, tnet = nets(0)
    po, pt, pv = schedule(ROUNDS)
    jcc, tcc = JChaos(loss_rate=0.3), ChaosConfig(loss_rate=0.3)
    init = lambda: jinit(JSim.init, N, M, seed=2, k=jnet.max_degree)   # noqa: E731
    jrun = jens.run_rounds(jens.lift_floodsub(jnet, chaos=jcc), jens.batch_states(init(), S),
                           jax_margs(po, pt, pv, S), ROUNDS)
    tst0 = port_state(init())
    tstep = ensemble.lift_floodsub(tnet, chaos=tcc)
    trun = ensemble.run_rounds(tstep, ensemble.batch_states(tst0, S),
                               port_margs(po, pt, pv, S), ROUNDS)
    assert trun.n_sims == S and trun.rounds == ROUNDS and trun.dispatches == ROUNDS
    assert trun.compiles == -1 and trun.aggregate_rounds_per_sec > 0
    step = lambda st, *a: floodsub_step(tnet, st, *a, chaos=tcc)   # noqa: E731
    hold(jrun.states, trun.states, step, tst0, po, pt, pv, "floodsub", s1_step=tstep)
    # the fault streams differ between sims: LINK_DOWN tallies and planes
    ev = trun.states.events.numpy()
    assert len({int(x) for x in ev[:, 13]}) > 1
    fr = trun.states.dlv.first_round.numpy()
    assert not np.array_equal(fr[0], fr[1])


def test_ensemble_randomsub_sampler_streams():
    jnet, tnet = nets(3)
    po, pt, pv = schedule(ROUNDS, seed=3)
    init = lambda: jinit(JSim.init, N, M, seed=4, k=jnet.max_degree)   # noqa: E731
    jrun = jens.run_rounds(jens.lift_step(jmake_random(jnet)), jens.batch_states(init(), S),
                           jax_margs(po, pt, pv, S), ROUNDS)
    tst0 = port_state(init())
    step = make_randomsub_step(tnet)
    trun = ensemble.run_rounds(ensemble.lift_step(step), ensemble.batch_states(tst0, S),
                               port_margs(po, pt, pv, S), ROUNDS)
    hold(jrun.states, trun.states, step, tst0, po, pt, pv, "randomsub",
         s1_step=ensemble.lift_step(step))
    # RandomSub's fanout draw is fold_in(st.key, tick): per-sim keys
    # decorrelate it (no chaos in this run)
    fr = trun.states.dlv.first_round.numpy()
    assert not np.array_equal(fr[0], fr[1])


def gossip_builds(chaos: dict | None, seed: int, **build):
    jnet, tnet = nets(seed)
    jsp = JScore(topics={0: JTopic()}, skip_app_specific=True)
    tsp = PeerScoreParams(topics={0: TopicScoreParams()}, skip_app_specific=True)
    jcfg = JCfg.build(JParams(D=3, Dlo=2, Dhi=4, Dscore=2, Dout=1), JThr(), score_enabled=True,
                      chaos=None if chaos is None else JChaos(**chaos), **build)
    tcfg = GossipSubConfig.build(GossipSubParams(D=3, Dlo=2, Dhi=4, Dscore=2, Dout=1),
                                 PeerScoreThresholds(), score_enabled=True,
                                 chaos=None if chaos is None else ChaosConfig(**chaos), **build)
    return jcfg, jnet, jsp, tcfg, tnet, tsp


def test_ensemble_gossipsub_per_round_ge():
    """GE chaos (0.25/0.4): sim-i parity and the per-sim GE chains."""
    jcfg, jnet, jsp, tcfg, tnet, tsp = gossip_builds(
        dict(generator="ge", ge_p_down=0.25, ge_p_up=0.4), seed=9)
    po, pt, pv = schedule(ROUNDS, seed=9)
    init = lambda: jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=10)  # noqa: E731
    jrun = jens.run_rounds(jens.lift_step(jmake(jcfg, jnet, score_params=jsp)),
                           jens.batch_states(init(), S), jax_margs(po, pt, pv, S), ROUNDS)
    tst0 = port_state(init())
    step = make_gossipsub_step(tcfg, tnet, score_params=tsp)
    ens = ensemble.lift_step(step)
    trun = ensemble.run_rounds(ens, ensemble.batch_states(tst0, S),
                               port_margs(po, pt, pv, S), ROUNDS)
    hold(jrun.states, trun.states, step, tst0, po, pt, pv, "gossipsub GE", s1_step=ens)
    ge = trun.states.core.chaos.ge_bad.numpy()
    assert not np.array_equal(ge[0], ge[1])
    fr = trun.states.core.dlv.first_round.numpy()
    assert not np.array_equal(fr[0], fr[1])


def test_fault_hash_streams_independent_per_sim():
    """The chaos counter-mode hash is keyed on the sim key: fold_in alone
    separates the sims' i.i.d. flap streams, with the JAX package's
    values."""
    jnet, tnet = nets(11)
    keys = ensemble.sim_keys(prng.key(0), 2)
    jkeys = jens.sim_keys(jax.random.key(0), 2)
    seeds = [faults.chaos_seed(keys[i]) for i in range(2)]
    assert int(seeds[0]) != int(seeds[1])
    for i in range(2):
        assert int(seeds[i]) & 0xFFFFFFFF == int(jfaults.chaos_seed(jkeys[i])) & 0xFFFFFFFF
    tick = torch.tensor(3, dtype=torch.int32)
    m = [faults.iid_link_down(s, tnet.nbr, tick, 0.5) for s in seeds]
    assert not torch.equal(m[0], m[1])
    want = jfaults.iid_link_down(jfaults.chaos_seed(jkeys[1]), jnet.nbr, jnp.int32(3), 0.5)
    assert np.array_equal(m[1].numpy(), np.asarray(want))


def test_per_sim_scenario_inputs():
    """One dispatch, S different scenarios: sim 0 has every link denied
    (nothing delivers), sim 1 a lossless wire; a [S, N, K] deny mask."""
    jnet, tnet = nets(14)
    po, pt, pv = schedule(ROUNDS, seed=14)
    deny = np.stack([np.ones(tnet.nbr.shape, bool), np.zeros(tnet.nbr.shape, bool)])
    deny_rows = np.broadcast_to(deny, (ROUNDS,) + deny.shape)
    init = lambda: jinit(JSim.init, N, M, seed=15, k=jnet.max_degree)   # noqa: E731
    jrun = jens.run_rounds(jens.lift_floodsub(jnet, chaos=JChaos(scheduled=True)),
                           jens.batch_states(init(), 2),
                           jax_margs(po, pt, pv, 2, extra=[deny_rows]), ROUNDS)
    tst0 = port_state(init())
    trun = ensemble.run_rounds(ensemble.lift_floodsub(tnet, chaos=ChaosConfig(scheduled=True)),
                               ensemble.batch_states(tst0, 2),
                               port_margs(po, pt, pv, 2, extra=[deny_rows]), ROUNDS)
    diff_leaves(reference_leaves(jrun.states), convert.state_leaves(trun.states), "deny")
    fr = trun.states.dlv.first_round.numpy().copy()
    for sim in range(2):
        o = trun.states.msgs.origin[sim].numpy()
        live = o >= 0
        fr[sim][np.clip(o, 0, N - 1)[live], np.nonzero(live)[0]] = -1
    assert (fr[0] < 0).all()      # total outage: no deliveries
    assert (fr[1] >= 0).any()     # lossless: traffic flowed


# ---------------------------------------------------------------------------
# checkpoints


def test_checkpoint_batched_roundtrip_no_version_bump(tmp_path):
    assert checkpoint._FORMAT_VERSION == 6
    jnet, tnet = nets(16)
    po, pt, pv = schedule(ROUNDS, seed=16)
    cc = ChaosConfig(generator="ge", ge_p_down=0.3, ge_p_up=0.5)
    tst0 = port_state(jinit(JSim.init, N, M, seed=17, k=jnet.max_degree, chaos_ge=True))
    ens = ensemble.lift_floodsub(tnet, chaos=cc)
    run = ensemble.run_rounds(ens, ensemble.batch_states(tst0, 2), port_margs(po, pt, pv, 2),
                              ROUNDS)
    path = str(tmp_path / "batched.npz")
    checkpoint.save(path, run.states)
    template = ensemble.batch_states(tst0, 2)
    restored = checkpoint.restore(path, template)
    diff_leaves(convert.state_leaves(run.states), convert.state_leaves(restored), "roundtrip")
    assert restored.key.shape == (2, 2)
    # the JAX package reads the port's batched file into its batched tree
    jtemplate = jens.batch_states(jinit(JSim.init, N, M, seed=17, k=jnet.max_degree,
                                        chaos_ge=True), 2)
    diff_leaves(reference_leaves(jcheckpoint.restore(path, jtemplate)),
                convert.state_leaves(run.states), "JAX restore")
    # resuming the restored ensemble equals the uninterrupted one
    po2, pt2, pv2 = schedule(3, seed=18)
    cont = ensemble.run_rounds(ens, restored, port_margs(po2, pt2, pv2, 2), 3)
    gold = ensemble.run_rounds(ens, run.states, port_margs(po2, pt2, pv2, 2), 3)
    diff_leaves(convert.state_leaves(gold.states), convert.state_leaves(cont.states), "resume")


def test_checkpoint_per_sim_slice_v6_compatible(tmp_path):
    jnet, tnet = nets(19)
    po, pt, pv = schedule(ROUNDS, seed=19)
    tst0 = port_state(jinit(JSim.init, N, M, seed=20, k=jnet.max_degree))
    run = ensemble.run_rounds(ensemble.lift_floodsub(tnet), ensemble.batch_states(tst0, 2),
                              port_margs(po, pt, pv, 2), ROUNDS)
    sim1 = ensemble.unbatch(run.states, 1)
    path = str(tmp_path / "sim1.npz")
    checkpoint.save(path, sim1)
    restored = checkpoint.restore(path, tst0)
    diff_leaves(convert.state_leaves(sim1), convert.state_leaves(restored), "slice")
    # a batched file refuses an unbatched template, naming the shapes
    bpath = str(tmp_path / "batched.npz")
    checkpoint.save(bpath, run.states)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(bpath, tst0)
