"""The port's invariant oracle (``oracle/invariants.py``) against the JAX
package's, verdict for verdict.

Lived-in states of all four engines (the per-round GossipSub step, the
phase engine at r = 4, FloodSub and RandomSub on ``random_connect(48, 4)``)
are made by the JAX engines from one numpy-seeded schedule, each from a
fresh reference state, and carried to the port with
``convert.state_from_reference``. Both checkers then read the same states:
clean, and under every seeded violation of ``tests/test_invariants.py``
(property by engine, each corruption applied to the leaves both packages'
states are built from), and the verdict vectors must be equal (bools: no
tolerance) and trip exactly the seeded property. The registry, the due
layout, the config validation, the batched checker and the hook's report
are held against the JAX objects.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    SEEDED,
    corrupt_degree,
    corrupt_graylist,
    corrupt_word_padding,
    jinit,
    oracle_net,
    oracle_state,
    reference_leaves,
    seeded_violation,
)

from go_libp2p_pubsub_tpu import config as jconfig
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models.floodsub import floodsub_step as jflood
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake_step
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake_phase
from go_libp2p_pubsub_tpu.models.randomsub import make_randomsub_step as jmake_random
from go_libp2p_pubsub_tpu.oracle import invariants as jinv
from go_libp2p_pubsub_tpu.perf.sweep import bench_score_params as jbsp
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import config as tconfig
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg
from go_libp2p_pubsub_tpu_torch.oracle import invariants as tinv
from go_libp2p_pubsub_tpu_torch.state import Net as TNet
from go_libp2p_pubsub_tpu_torch.state import SimState as TSim

N, M, ROUNDS = 48, 64, 24
PHASE_R, PHASE_ROUNDS = 4, 40
PARAMS = dict(D=3, Dlo=2, Dhi=4, Dscore=2, Dout=1, history_length=6, history_gossip=4)


@dataclasses.dataclass
class Cell:
    """One engine's lived-in state on both sides: the JAX net, config and
    state, the port's, the quiet due row and delivery window under which
    the clean state passes every property."""

    engine: str
    jnet: object
    jcfg: object
    jst: object
    tnet: object
    tcfg: object
    window: int
    quiet: np.ndarray

    @property
    def leaves(self) -> dict:
        return reference_leaves(self.jst)

    # what the seeded violations read of the cell (torch_parity.seeded_violation)
    @property
    def nbr(self) -> np.ndarray:
        return np.asarray(self.jnet.nbr)

    @property
    def protocol(self) -> np.ndarray:
        return np.asarray(self.jnet.protocol)

    dlo = PARAMS["Dlo"]


def nets(seed: int = 0):
    jnet = JNet.build(jgraph.random_connect(N, d=4, seed=seed), jgraph.subscribe_all(N, 1))
    tnet = TNet.build(tgraph.random_connect(N, d=4, seed=seed), tgraph.subscribe_all(N, 1),
                      device="cpu")
    return jnet, tnet


def configs():
    jcfg = JCfg.build(jconfig.GossipSubParams(**PARAMS), jconfig.PeerScoreThresholds(),
                      score_enabled=True)
    tcfg = TCfg.build(tconfig.GossipSubParams(**PARAMS), tconfig.PeerScoreThresholds(),
                      score_enabled=True)
    return jcfg, tcfg


def schedule(rounds: int = ROUNDS, pub_at=(2, 5), seed: int = 0):
    """``tests/test_invariants.py``'s schedule: 4 valid publishes a round
    from random origins in rounds [pub_at), none elsewhere."""
    rng = np.random.default_rng(seed)
    po = np.full((rounds, 4), -1, np.int32)
    po[pub_at[0]:pub_at[1]] = rng.integers(0, N, size=(pub_at[1] - pub_at[0], 4))
    return po, np.zeros((rounds, 4), np.int32), np.ones((rounds, 4), bool)


def lived_in(engine: str) -> Cell:
    """The JAX engine's state after its schedule, from a fresh state."""
    jnet, tnet = nets()
    jcfg, tcfg = configs()
    sp = jbsp("default", 1)[1]
    window, rounds, quiet = 12, ROUNDS, jinv.due_vector(quiet=(0, ROUNDS))
    if engine == "phase":
        window, rounds = 24, PHASE_ROUNDS
        quiet = jinv.due_vector(quiet=(0, rounds))
        po, pt, pv = schedule(rounds, pub_at=(8, 11))
        st = jinit(JState.init, jnet, M, jcfg, score_params=sp, seed=0)
        step = jmake_phase(jcfg, jnet, PHASE_R, score_params=sp)
        for p in range(rounds // PHASE_R):
            sl = slice(p * PHASE_R, (p + 1) * PHASE_R)
            st = step(st, jnp.asarray(po[sl]), jnp.asarray(pt[sl]), jnp.asarray(pv[sl]),
                      do_heartbeat=True)
        return Cell(engine, jnet, jcfg, st, tnet, tcfg, window, quiet)
    po, pt, pv = schedule()
    if engine == "gossipsub":
        st = jinit(JState.init, jnet, M, jcfg, score_params=sp, seed=0)
        step = jmake_step(jcfg, jnet, score_params=sp)
    else:
        st = jinit(JSim.init, N, M, seed=0, k=jnet.max_degree)
        step = (jmake_random(jnet) if engine == "randomsub"
                else (lambda s, a, b, c: jflood(jnet, s, a, b, c)))
        jcfg = tcfg = None
    for t in range(rounds):
        st = step(st, jnp.asarray(po[t]), jnp.asarray(pt[t]), jnp.asarray(pv[t]))
    return Cell(engine, jnet, jcfg, st, tnet, tcfg, window, quiet)


_CELLS: dict = {}


def cell(engine: str) -> Cell:
    if engine not in _CELLS:
        _CELLS[engine] = lived_in(engine)
    return _CELLS[engine]


def jax_state(template, leaves: dict):
    """A JAX state of ``template``'s tree with the leaves of ``leaves``
    (``reference_leaves``' paths; key leaves as key data)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in flat:
        a = leaves[jax.tree_util.keystr(path)]
        if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            out.append(jax.random.wrap_key_data(jnp.asarray(a), impl=jax.random.key_impl(leaf)))
        else:
            out.append(jnp.asarray(a, dtype=leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def port_state(leaves: dict):
    return oracle_state(leaves, "cpu")


def verdicts(c: Cell, leaves: dict | None = None, net: dict | None = None, due=None,
             prev_events=None, template=None, engine: str | None = None) -> dict:
    """Both checkers on the state of ``leaves`` (default: the cell's) with
    net field overrides ``net``: asserts the verdict vectors equal and
    returns {name: verdict}."""
    engine = engine or c.engine
    leaves = c.leaves if leaves is None else leaves
    net = net or {}
    jst = jax_state(template or c.jst, leaves)
    jnet = c.jnet.replace(**{k: jnp.asarray(v, dtype=getattr(c.jnet, k).dtype)
                             for k, v in net.items()})
    icfg_j = jinv.InvariantConfig(delivery_window=c.window)
    icfg_t = tinv.InvariantConfig(delivery_window=c.window)
    want = np.asarray(jinv.check_state(engine, jnet, jst, c.jcfg, icfg_j,
                                       prev_events=prev_events, due=due))
    got = tinv.check_state(engine, oracle_net(c.tnet, **net), port_state(leaves), c.tcfg, icfg_t,
                           prev_events=prev_events, due=due)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    names = tinv.invariant_names(engine)
    assert names == jinv.invariant_names(engine)
    return dict(zip(names, want.tolist()))


# ---------------------------------------------------------------------------
# clean lived-in states


@pytest.mark.parametrize("engine", ["gossipsub", "phase", "floodsub", "randomsub"])
def test_clean_state_verdicts_equal_reference(engine):
    c = cell(engine)
    res = verdicts(c, due=c.quiet)
    assert all(res.values()), {k: v for k, v in res.items() if not v}
    # the quiet delivery clause was not vacuous: publishes aged past W
    births = c.leaves[(".core" if engine in ("gossipsub", "phase") else "") + ".msgs.birth"]
    tick = PHASE_ROUNDS if engine == "phase" else ROUNDS
    assert ((births >= 0) & (births + c.window <= tick)).any()
    # the defaults: no due row, no counters snapshot
    assert all(verdicts(c).values())


# ---------------------------------------------------------------------------
# seeded violations: one corruption of the leaves (plus a doctored net, a
# due row or a counters snapshot where the property is about a relation),
# the exact failure set expected


def seeded(c: Cell, name: str):
    """(leaves, net overrides, check kwargs, template) of ``name``'s seeded
    violation on the cell's state."""
    L, net, kw = seeded_violation(name, c, c.leaves)
    template = c.jst
    if ".choked" in L:
        template = c.jst.replace(choked=jnp.zeros(c.jst.mesh.shape, bool))
    return L, net, kw, template


@pytest.mark.parametrize("name,engine", SEEDED, ids=[f"{n}-{e}" for n, e in SEEDED])
def test_seeded_violation_verdicts_equal_reference(name, engine):
    c = cell(engine)
    L, net, kw, template = seeded(c, name)
    res = verdicts(c, L, net, template=template, **kw)
    failed = {k for k, v in res.items() if not v}
    assert failed == {name}, f"corrupting for {name!r} tripped {sorted(failed)}"


@pytest.mark.parametrize("engine", ["gossipsub", "phase", "floodsub", "randomsub"])
def test_word_padding_violation_equals_reference(engine):
    """word-padding-wf needs a capacity that does not fill its words (M =
    48 leaves 16 padding bits): a fresh state passes, a set padding bit
    trips exactly it (the fresh GossipSub state has no mesh yet, so its
    degree bounds are graced)."""
    jnet, tnet = nets()
    jcfg, tcfg = configs()
    if engine in ("gossipsub", "phase"):
        jst = jinit(JState.init, jnet, 48, jcfg, score_params=jbsp("default", 1)[1], seed=0)
    else:
        jst = jinit(JSim.init, N, 48, seed=0, k=jnet.max_degree)
        jcfg = tcfg = None
    c = Cell(engine, jnet, jcfg, jst, tnet, tcfg, 12, jinv.due_vector())
    grace = jinv.due_vector(grace=True)
    assert all(verdicts(c, due=grace).values())
    L = corrupt_word_padding(c.leaves)
    failed = {k for k, v in verdicts(c, L, due=grace).items() if not v}
    assert failed == {"word-padding-wf"}


def test_grace_suspends_degree_bounds():
    c = cell("gossipsub")
    L, _net, _kw = corrupt_degree(c, c.leaves)
    assert not verdicts(c, L)["mesh-degree-bounds"]
    assert verdicts(c, L, due=jinv.due_vector(grace=True))["mesh-degree-bounds"]


# ---------------------------------------------------------------------------
# registry and config surface


def test_registry_equals_reference():
    assert list(tinv.REGISTRY) == list(jinv.REGISTRY)
    assert len(tinv.REGISTRY) == 21
    for name, prop in tinv.REGISTRY.items():
        ref = jinv.REGISTRY[name]
        assert (prop.kind, prop.engines, prop.doc) == (ref.kind, ref.engines, ref.doc), name
    assert tinv.ENGINES == jinv.ENGINES
    for engine in tinv.ENGINES:
        assert tinv.invariant_names(engine) == jinv.invariant_names(engine)
        sub = ("fwd-subset-have", "no-self-mesh")
        assert tinv.invariant_names(engine, sub) == jinv.invariant_names(engine, sub)
    with pytest.raises(ValueError):
        tinv.invariant_names("no-such-engine")


def test_due_vector_layout_equals_reference():
    assert tinv.DUE_LEN == jinv.DUE_LEN == 7
    for kw in ({}, dict(quiet=(3, 9), recover=(5, 7, 40), grace=True), dict(mut_grace=True),
               dict(quiet=(0, 24), mut_grace=True)):
        got, want = tinv.due_vector(**kw), jinv.due_vector(**kw)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
    for name in ("DUE_QUIET_LO", "DUE_QUIET_HI", "DUE_R_LO", "DUE_R_HI", "DUE_R_DEADLINE",
                 "DUE_GRACE", "DUE_MUT_GRACE"):
        assert getattr(tinv, name) == getattr(jinv, name)


def test_invariant_config_validation_equals_reference():
    for kw in (dict(delivery_window=0), dict(check_every=0), dict(names=("no-such-property",))):
        with pytest.raises(jinv.InvariantConfigError) as jerr:
            jinv.InvariantConfig(**kw).validate()
        with pytest.raises(tinv.InvariantConfigError) as terr:
            tinv.InvariantConfig(**kw).validate()
        assert str(terr.value) == str(jerr.value)
    assert tinv.InvariantConfig() == tinv.InvariantConfig(12, 8, None)
    jnet, tnet = nets()
    st = TSim.init(N, M, seed=0, k=tnet.max_degree, device="cpu")
    with pytest.raises(tinv.InvariantConfigError, match="empty"):
        tinv.check_state("floodsub", tnet, st,
                         inv=tinv.InvariantConfig(names=("no-self-mesh",)))
    # a bare SimState is refused for the mesh engines, a GossipSub state
    # without its config too
    with pytest.raises(ValueError, match="bare SimState"):
        tinv.check_state("gossipsub", tnet, st)
    c = cell("gossipsub")
    with pytest.raises(ValueError, match="GossipSubConfig"):
        tinv.check_state("gossipsub", tnet, port_state(c.leaves))


def _stacked(states):
    from go_libp2p_pubsub_tpu_torch.driver import _leaves, _rebuild

    cols = zip(*[_leaves(s) for s in states])
    return _rebuild(states[0], iter([torch.stack(col) for col in cols]))


def test_batched_checker_equals_per_sim_and_reference():
    """The batched checker's [S, P] rows equal the per-sim checks and the
    JAX package's vmapped checker on the same three states (clean, a
    graylist and a degree violation)."""
    c = cell("gossipsub")
    variants = [c.leaves] + [fn(c, c.leaves)[0] for fn in (corrupt_graylist, corrupt_degree)]
    tsts = [port_state(L) for L in variants]
    jsts = [jax_state(c.jst, L) for L in variants]
    prev = np.stack([L[".core.events"] for L in variants])
    prev[2] += 1            # the third sim's counters went backwards too
    chk, names = tinv.make_checker("gossipsub", c.tnet, c.tcfg, batched=True)
    got = chk(_stacked(tsts), torch.from_numpy(prev), torch.from_numpy(c.quiet))
    assert got.shape == (3, len(names))
    for i, st in enumerate(tsts):
        want = tinv.check_state("gossipsub", c.tnet, st, c.tcfg, prev_events=prev[i],
                                due=c.quiet)
        assert torch.equal(got[i], want), f"sim {i} diverges"
    jchk, jnames = jinv.make_checker("gossipsub", c.jnet, c.jcfg, batched=True)
    jb = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jsts)
    assert jnames == names
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jchk(jb, jnp.asarray(prev), jnp.asarray(c.quiet))))
    assert got[0].all() and not got[1].all() and not got[2].all()
    one, _ = tinv.make_checker("gossipsub", c.tnet, c.tcfg)
    assert torch.equal(one(tsts[1], torch.from_numpy(prev[1]), torch.from_numpy(c.quiet)),
                       got[1])


def test_hook_report_equals_reference():
    """The hook over a clean and a violating state, unbatched: the same
    report as the JAX hook's (ticks, masks, violations, the artifact
    block), read back once; ``compiles`` is unknown (-1)."""
    c = cell("gossipsub")
    bad, _net, _kw = corrupt_graylist(c, c.leaves)
    reports = []
    for mod, state_of in ((jinv, lambda L: jax_state(c.jst, L)), (tinv, port_state)):
        net = c.jnet if mod is jinv else c.tnet
        cfg = c.jcfg if mod is jinv else c.tcfg
        hook = mod.InvariantHook("gossipsub", net, cfg, mod.InvariantConfig(check_every=1),
                                 batched=False, due_fn=lambda t: mod.due_vector(quiet=(0, 24)))
        hook.precompute(2)
        hook.on_step(0, state_of(c.leaves))
        hook.on_step(1, state_of(bad))
        hook.on_step(2, state_of(c.leaves))      # past precompute: a row made then
        reports.append(hook.report())
        if mod is tinv:
            assert hook.compiles == -1
            hook.reset()
            assert hook.report().n_checks == 0
    jrep, trep = reports
    assert trep.ticks == jrep.ticks == (1, 2, 3)
    np.testing.assert_array_equal(trep.ok, jrep.ok)
    assert trep.violations() == jrep.violations() == [(2, 0, "graylist-not-in-mesh")]
    assert trep.per_property() == jrep.per_property()
    assert trep.artifact_block() == jrep.artifact_block()
    assert (trep.n_checks, trep.n_sims, trep.all_ok, trep.last_checked_round) == (3, 1, False, 3)
