"""The oracle on the mutable overlay, the port against the JAX package:
``ops/edges.involution_wf``, the checker's overlay branch (``Net.with_overlay``
from the state's ``core.topo``), the mutation-aware properties and
``topo/dynamics.MutationSchedule.due_fn``.

The cases are ``tests/test_invariants_dynamics.py``'s: a lived-in dynamic
GossipSub state (``random_connect(48, 4)`` built ``dynamic=True``, all-pad
write batches) passes every property; an edge_perm slot that stops being
partner-consistent and a negative epoch trip exactly
``edge-involution-wf`` (checked as each engine: the GossipSub state for
the mesh engines, its core for FloodSub and RandomSub); a schedule kill
without the mesh cleanup trips ``mesh-in-topology`` outside
``DUE_MUT_GRACE`` and not inside it; and the double attribution that trips
``first-edge-wf`` is graced inside it. A churn storm runs through both
packages' dynamic steps with a hook whose due rows come from each
package's ``due_fn``, and the reports are equal. Bools throughout: no
tolerance.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dynamics import storms
from test_torch_invariants import PARAMS, configs, jax_state, port_state
from torch_parity import (
    bench_builds,
    corrupt_negative_epoch,
    corrupt_perm_self_point,
    jinit,
    reference_leaves,
)

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake_step
from go_libp2p_pubsub_tpu.ops import edges as jedges
from go_libp2p_pubsub_tpu.oracle import invariants as jinv
from go_libp2p_pubsub_tpu.perf.sweep import bench_score_params as jbsp
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake_step
from go_libp2p_pubsub_tpu_torch.ops import edges as tedges
from go_libp2p_pubsub_tpu_torch.oracle import invariants as tinv
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import replace
from go_libp2p_pubsub_tpu_torch.topo import dynamics as tdyn

N, M, ROUNDS, W, PAD_B = 48, 64, 24, 12, 4
QUIET = jinv.due_vector(quiet=(0, ROUNDS))


def _pad_writes() -> np.ndarray:
    w = np.zeros((PAD_B, 4), np.int32)
    w[:, 0] = tdyn.PAD_SLOT
    return w


@pytest.fixture(scope="module")
def lived():
    """(JAX topology, JAX net, port net, JAX config, port config, JAX
    state) after ROUNDS dynamic rounds of the JAX step from a fresh state."""
    topo = jgraph.random_connect(N, d=4, seed=0)
    jnet = JNet.build(topo, jgraph.subscribe_all(N, 1), dynamic=True)
    tnet = TNet.build(tgraph.random_connect(N, d=4, seed=0), tgraph.subscribe_all(N, 1),
                      dynamic=True, device="cpu")
    jcfg, tcfg = configs()
    sp = jbsp("default", 1)[1]
    st = jinit(JState.init, jnet, M, jcfg, score_params=sp, seed=0, dynamic_topo=True)
    step = jmake_step(jcfg, jnet, score_params=sp, dynamic_peers=True, dynamic_topo=True)
    rng = np.random.default_rng(0)
    up, writes = jnp.ones((N,), bool), jnp.asarray(_pad_writes())
    for t in range(ROUNDS):
        po = np.full((4,), -1, np.int32)
        if 2 <= t < 5:
            po[:] = rng.integers(0, N, size=4)
        st = step(st, jnp.asarray(po), jnp.zeros((4,), jnp.int32), jnp.ones((4,), bool),
                  up, writes)
    return topo, jnet, tnet, jcfg, tcfg, st


def _verdicts(lived, leaves, engine="gossipsub", due=None) -> dict:
    """Both checkers on the state of ``leaves`` (the whole GossipSub state
    for the mesh engines, its core for FloodSub and RandomSub): equal
    verdicts, returned by name."""
    _topo, jnet, tnet, jcfg, tcfg, jst = lived
    jstate = jax_state(jst, leaves)
    tstate = port_state(leaves)
    if engine in ("floodsub", "randomsub"):
        jstate, tstate, jcfg, tcfg = jstate.core, tstate.core, None, None
    want = np.asarray(jinv.check_state(engine, jnet, jstate, jcfg,
                                       jinv.InvariantConfig(delivery_window=W), due=due))
    got = tinv.check_state(engine, tnet, tstate, tcfg,
                           tinv.InvariantConfig(delivery_window=W), due=due)
    np.testing.assert_array_equal(got.numpy(), want)
    return dict(zip(tinv.invariant_names(engine), want.tolist()))


def _failed(res) -> set:
    return {k for k, v in res.items() if not v}


ENGINES = ("gossipsub", "phase", "floodsub", "randomsub")


@pytest.mark.parametrize("engine", ENGINES)
def test_clean_dynamic_state_equals_reference(lived, engine):
    leaves = reference_leaves(lived[-1])
    assert ".core.topo.edge_perm" in leaves
    res = _verdicts(lived, leaves, engine, due=QUIET)
    assert all(res.values()), _failed(res)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("corrupt", [corrupt_perm_self_point, corrupt_negative_epoch],
                         ids=["perm-self-point", "negative-epoch"])
def test_involution_violation_equals_reference(lived, engine, corrupt):
    res = _verdicts(lived, corrupt(reference_leaves(lived[-1])), engine)
    assert _failed(res) == {"edge-involution-wf"}


def test_mutation_kill_trips_mesh_in_topology(lived):
    """A schedule kill of a mesh neighbour without the same-round cleanup
    trips exactly mesh-in-topology; DUE_MUT_GRACE suspends it."""
    topo = lived[0]
    leaves = reference_leaves(lived[-1])
    i, s, k = (int(v) for v in np.argwhere(leaves[".mesh"])[0])
    j = int(leaves[".core.topo.nbr"][i, k])
    sched = tdyn.MutationSchedule(topo.nbr, topo.nbr_ok, topo.rev, n_dispatches=1)
    sched.kill(0, j)
    _, up_rows = sched.build()
    bad = dict(leaves, **{".up": up_rows[0]})
    assert _failed(_verdicts(lived, bad)) == {"mesh-in-topology"}
    assert _verdicts(lived, bad, due=jinv.due_vector(mut_grace=True))["mesh-in-topology"]


def test_first_edge_wf_graced_under_mutation(lived):
    leaves = reference_leaves(lived[-1])
    slot = int(np.argwhere(leaves[".core.msgs.valid"])[0][0])
    w, b = slot // 32, np.uint32(1) << np.uint32(slot % 32)
    have = np.array(leaves[".core.dlv.have"])
    fe = np.array(leaves[".core.dlv.fe_words"])
    have[0, w] |= b
    fe[0, 0, w] |= b
    fe[0, 1, w] |= b
    bad = dict(leaves, **{".core.dlv.have": have, ".core.dlv.fe_words": fe})
    assert _failed(_verdicts(lived, bad)) == {"first-edge-wf"}
    assert _verdicts(lived, bad, due=jinv.due_vector(mut_grace=True))["first-edge-wf"]


def test_involution_wf_equals_reference_on_corruptions():
    """``involution_wf`` on a well-formed pool and on each clause's
    corruption: the JAX verdict, with the port's int64 ``Net.edge_perm``
    and with an int32 one alike."""
    topo = jgraph.random_connect(32, d=4, seed=3)
    perm = jedges.build_edge_perm(topo.nbr, topo.rev, topo.nbr_ok)
    k = topo.nbr.shape[1]
    i, kk = (int(v) for v in np.argwhere(topo.nbr_ok)[0])
    absent = np.argwhere(~topo.nbr_ok)
    cases = {"clean": {}}
    p = perm.copy()
    p[i, kk] = 32 * k                                  # out of range
    cases["range"] = {"edge_perm": p}
    p = perm.copy()
    p[i, kk] = i * k + kk                              # not an involution
    cases["involution"] = {"edge_perm": p}
    nbr = topo.nbr.copy()
    nbr[i, kk] = i                                     # a self-edge
    cases["self-edge"] = {"nbr": nbr}
    rev = topo.rev.copy()
    rev[i, kk] = k + 2                                 # rev out of range
    cases["rev-range"] = {"rev": rev}
    if absent.size:
        a, ak = (int(v) for v in absent[0])
        p = perm.copy()
        p[a, ak] = perm[i, kk]                         # an absent slot points away
        cases["absent"] = {"edge_perm": p}
        ok = topo.nbr_ok.copy()
        ok[int(topo.nbr[i, kk]), int(topo.rev[i, kk])] = False   # partner absent
        cases["partner"] = {"nbr_ok": ok}
    base = dict(nbr=topo.nbr, rev=topo.rev, nbr_ok=topo.nbr_ok, edge_perm=perm)
    seen = set()
    for name, over in cases.items():
        planes = dict(base, **over)
        want = bool(jedges.involution_wf(*(jnp.asarray(planes[f]) for f in (
            "nbr", "rev", "nbr_ok", "edge_perm"))))
        for dt in (torch.int64, torch.int32):
            got = tedges.involution_wf(torch.as_tensor(planes["nbr"]),
                                       torch.as_tensor(planes["rev"]),
                                       torch.as_tensor(planes["nbr_ok"]),
                                       torch.as_tensor(planes["edge_perm"], dtype=dt))
            assert got.dim() == 0 and got.dtype == torch.bool
            assert bool(got) == want, (name, dt)
        seen.add(want)
        assert want == (name == "clean"), name
    assert seen == {True, False}


def test_due_fn_rows_equal_reference():
    """``MutationSchedule.due_fn``'s rows over every tick of a storm, at
    several cadences and grace spans, with and without the quiet and
    recover clauses."""
    js, ts = storms(0, d=16, rounds_per_dispatch=2)
    assert ts.mutation_dispatches == js.mutation_dispatches
    for kw in (dict(check_every=1), dict(check_every=2, grace_checks=2),
               dict(check_every=4, quiet=(0, 32)), dict(check_every=3, recover=(4, 9, 20))):
        jfn, tfn = js.due_fn(**kw), ts.due_fn(**kw)
        for tick in range(0, 36):
            got, want = tfn(tick), jfn(tick)
            assert got.dtype == want.dtype and got.tolist() == want.tolist(), (kw, tick)
        assert any(tfn(t)[tinv.DUE_MUT_GRACE] for t in range(36))
        assert not all(tfn(t)[tinv.DUE_MUT_GRACE] for t in range(36))


def test_storm_hook_reports_equal_reference():
    """A churn storm through both packages' dynamic per-round steps (the
    power-law cell of ``tests/test_torch_dynamics.py``), checked every 2
    rounds with each package's ``due_fn`` rows: equal reports, every check
    ok. The storm's kill row applied to the state before it, without the
    step's same-round cleanup, trips mesh-in-topology under a bare due row
    and not under the kill tick's ``due_fn`` row. A storm is no quiet
    interval, so the delivery clause is off."""
    from test_torch_dynamics import topologies

    js, ts = storms(0)
    jt, tt = topologies(0)
    rounds = js.n_dispatches
    builds = bench_builds(n=jt.n_peers, topologies=(jt, tt), dynamic=True,
                          params=dict(PARAMS, D=3), heartbeat_every=1)
    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    jst = jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=0, dynamic_topo=True)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    jstep = jmake_step(jcfg, jnet, score_params=jsp, dynamic_peers=True, dynamic_topo=True)
    tstep = tmake_step(tcfg, tnet, score_params=tsp, dynamic_peers=True, dynamic_topo=True)
    (writes, up), n = ts.build(), tnet.n_peers
    rng = np.random.default_rng(1)
    po = np.full((rounds, 4), -1, np.int32)
    po[1:4] = rng.integers(0, n, size=(3, 4))
    icfg = dict(check_every=2, delivery_window=8)
    hooks = [tinv.InvariantHook("gossipsub", tnet, tcfg, tinv.InvariantConfig(**icfg),
                                batched=False, due_fn=ts.due_fn(2)),
             jinv.InvariantHook("gossipsub", jnet, jcfg, jinv.InvariantConfig(**icfg),
                                batched=False, due_fn=js.due_fn(2))]
    for h in hooks:
        h.precompute(rounds)
    kill = rounds // 4          # churn_storm's default kill dispatch
    for t in range(rounds):
        row = (po[t], np.zeros(4, np.int32), np.ones(4, bool), up[t], writes[t])
        tst = tstep(tst, *(torch.from_numpy(np.asarray(a)) for a in row))
        jst = jstep(jst, *(jnp.asarray(a) for a in row))
        hooks[0].on_step(t, tst)
        hooks[1].on_step(t, jst)
        if t == kill - 1:
            before = (tst, reference_leaves(jst))
    trep, jrep = (h.report() for h in hooks)
    assert trep.ticks == jrep.ticks and len(trep.ticks) == rounds // 2
    np.testing.assert_array_equal(trep.ok, jrep.ok)
    assert trep.all_ok, trep.violations()
    tbad = replace(before[0], up=torch.from_numpy(up[kill]))
    jbad = jax_state(jst, dict(before[1], **{".up": up[kill]}))
    for due, want in ((tinv.due_vector(), False), (ts.due_fn(2)(kill + 1), True)):
        assert due[tinv.DUE_MUT_GRACE] == int(want)
        got = tinv.check_state("gossipsub", tnet, tbad, tcfg, due=due)
        ref = jinv.check_state("gossipsub", jnet, jbad, jcfg, due=due)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        res = dict(zip(tinv.invariant_names("gossipsub"), got.tolist()))
        assert res["mesh-in-topology"] is want and sum(not v for v in res.values()) == (not want)
    assert ts.n_kills > 0 and ts.n_joins > 0 and ts.n_rewires > 0
