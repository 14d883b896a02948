"""Checked run windows (``driver.make_window(check=..., check_every=...)``)
in the port against the JAX package's, and against the port's eager hook.

Each cell runs one numpy-made schedule from one state through three
paths: the port's checked window (on the CPU the plain loop over
dispatches, checks folded in), the port's eager loop with an
``InvariantHook``, and the JAX package's checked window (a scan with the
checker in its body), each from a fresh state. ``ys["ok"]`` must equal the
JAX window's, and the hook's wherever the two forms agree by definition
(every check but the first's ``events-monotone``, which a window holds to
the window-entry counters and the hook to none); the final states equal
leaf for leaf. The cells: FloodSub on the lattice with ``check_every`` 4
(a multiple of the one-dispatch period: the JAX package's nested scan),
the per-round GossipSub step with a static heartbeat every 2 rounds and
``check_every`` 4 and 3 (a multiple of the period and not one), the phase
engine at r = 4 with a check every 2 phases, a violation seeded between
two windows of one run, and a window over a batch of sims. Bools: no
tolerance.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_invariants import _stacked, jax_state
from torch_parity import bench_builds, diff_leaves, jinit, phase_schedule, reference_leaves

from go_libp2p_pubsub_tpu import driver as jdriver
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake_step
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake_phase
from go_libp2p_pubsub_tpu.oracle import invariants as jinv
from go_libp2p_pubsub_tpu.state import Net as JNet
from go_libp2p_pubsub_tpu.state import SimState as JSim
from go_libp2p_pubsub_tpu_torch import convert, driver
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake_step
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step as tmake_phase
from go_libp2p_pubsub_tpu_torch.oracle import invariants as tinv
from go_libp2p_pubsub_tpu_torch.state import Net as TNet

N, M = 64, 64


def _flood():
    jnet = JNet.build(jgraph.ring_lattice(N, d=4), jgraph.subscribe_all(N, 1))
    tnet = TNet.build(tgraph.ring_lattice(N, d=4), tgraph.subscribe_all(N, 1), device="cpu")
    return dict(engine="floodsub", jnet=jnet, tnet=tnet, jcfg=None, tcfg=None,
                jstep=lambda s, a, b, c: jflood.floodsub_step(jnet, s, a, b, c),
                tstep=lambda s, a, b, c: tflood.floodsub_step(tnet, s, a, b, c),
                init=lambda: jinit(JSim.init, N, M, seed=0, k=jnet.max_degree), heartbeat=None, r=1)


def _gossip(he: int = 2, r: int = 1):
    jcfg, jnet, jsp, tcfg, tnet, tsp = bench_builds(n=N, d=4, heartbeat_every=he)
    if r > 1:
        jstep = jmake_phase(jcfg, jnet, r, score_params=jsp)
        tstep = tmake_phase(tcfg, tnet, r, score_params=tsp)
    else:
        jstep = jmake_step(jcfg, jnet, score_params=jsp, static_heartbeat=True)
        tstep = tmake_step(tcfg, tnet, score_params=tsp, static_heartbeat=True)
    return dict(engine="phase" if r > 1 else "gossipsub", jnet=jnet, tnet=tnet, jcfg=jcfg,
                tcfg=tcfg, jstep=jstep, tstep=tstep,
                init=lambda: jinit(JState.init, jnet, M, jcfg, score_params=jsp, seed=0),
                heartbeat=driver.heartbeat_schedule(he, r), r=r)


def _xs(cell, dispatches: int):
    """The per-dispatch publish rows ([D, P], or [D, r, P] for a phase)."""
    r = cell["r"]
    po, pt, pv = phase_schedule(N, dispatches * r)
    if r > 1:
        return tuple(a.reshape((dispatches, r) + a.shape[1:]) for a in (po, pt, pv))
    return po, pt, pv


def _due_fn(rounds: int):
    return lambda tick: tinv.due_vector(quiet=(0, rounds))


def _windows(cell, dispatches: int, ce: int, corrupt=None):
    """The port's checked window, the port's hook loop and the JAX checked
    window over ``dispatches`` from the cell's fresh state, with
    ``corrupt(leaves) -> leaves`` applied to the state before the second
    half when given (two windows of half the dispatches each). Returns
    (port ok, hook ok, JAX ok, port final leaves, JAX final leaves)."""
    r = cell["r"]
    rounds = dispatches * r
    xs = _xs(cell, dispatches)
    # the phase engine's first heartbeat is at its first phase's tail, so
    # its first publishes take longer (tests/test_invariants.py's W = 24)
    icfg = dict(delivery_window=24 if r > 1 else 16, check_every=ce)
    names = tinv.invariant_names(cell["engine"])
    tspec = tinv.ScanInvariants(cell["engine"], cell["tnet"], cell["tcfg"],
                                tinv.InvariantConfig(**icfg), batched=False,
                                due_fn=_due_fn(rounds), rounds_per_step=r)
    jspec = jinv.ScanInvariants(cell["engine"], cell["jnet"], cell["jcfg"],
                                jinv.InvariantConfig(**icfg), batched=False,
                                due_fn=lambda t: jinv.due_vector(quiet=(0, rounds)),
                                rounds_per_step=r)
    halves = [(0, dispatches)] if corrupt is None else [(0, dispatches // 2),
                                                       (dispatches // 2, dispatches)]
    twin = driver.make_window(cell["tstep"], heartbeat=cell["heartbeat"], check=tspec.check,
                              check_every=ce)
    jwin = jdriver.make_window(cell["jstep"], heartbeat=cell["heartbeat"], check=jspec.check,
                               check_every=ce)
    hook = tinv.InvariantHook(cell["engine"], cell["tnet"], cell["tcfg"],
                              tinv.InvariantConfig(**icfg), batched=False,
                              due_fn=_due_fn(rounds), rounds_per_step=r)
    hook.precompute(dispatches)
    jst = cell["init"]()
    tst = hst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    tok, jok = [], []
    due = tspec.precompute(dispatches)
    ticks = tspec._ticks
    for lo, hi in halves:
        if lo:
            jl = corrupt(reference_leaves(jst))
            jst = jax_state(jst, jl)
            tst = hst = convert.state_from_reference(jl, device="cpu")
        part = tuple(a[lo:hi] for a in xs)
        rows = due[lo // ce:hi // ce]
        tst, ys = twin(tst, part, rows)
        assert ys["ok"].shape == (len(rows), len(names)) and ys["ok"].dtype == torch.bool
        tok.append(ys["ok"].numpy())
        jst, jys = jwin(jst, tuple(jnp.asarray(a) for a in part), jnp.asarray(rows.numpy()))
        jok.append(np.asarray(jys["ok"]))
        for d in range(lo, hi):
            hst = cell["tstep"](hst, *(torch.from_numpy(a[d]) for a in xs),
                                **({} if cell["heartbeat"] is None else {
                                    "do_heartbeat": cell["heartbeat"][d % len(cell["heartbeat"])]}))
            hook.on_step(d, hst)
    rep = hook.report()
    assert rep.ticks == ticks == tuple((c + 1) * ce * r for c in range(dispatches // ce))
    hok = rep.ok[:, 0]
    diff_leaves(convert.state_leaves(tst), convert.state_leaves(hst), "window vs hook loop")
    return np.concatenate(tok), hok, np.concatenate(jok), convert.state_leaves(tst), \
        reference_leaves(jst)


def _hold(cell, tok, hok, jok, tleaves, jleaves, first_checks):
    """``ys["ok"]`` equals the JAX window's; the hook's too, apart from
    ``events-monotone`` at each window's first check (``first_checks``)."""
    np.testing.assert_array_equal(tok, jok)
    diff_leaves(jleaves, tleaves, "port window vs JAX window")
    mono = tinv.invariant_names(cell["engine"]).index("events-monotone")
    keep = np.ones(tok.shape, bool)
    keep[list(first_checks), mono] = False
    np.testing.assert_array_equal(tok[keep], hok[keep])


@pytest.mark.parametrize("kind,ce,dispatches", [
    ("floodsub", 4, 16), ("gossipsub", 4, 16), ("gossipsub", 3, 12), ("phase", 2, 8)],
    ids=["floodsub-ce4", "gossipsub-he2-ce4", "gossipsub-he2-ce3", "phase-r4-ce2"])
def test_checked_window_equals_reference_and_hook(kind, ce, dispatches):
    cell = {"floodsub": _flood, "gossipsub": _gossip,
            "phase": lambda: _gossip(he=4, r=4)}[kind]()
    tok, hok, jok, tl, jl = _windows(cell, dispatches, ce)
    _hold(cell, tok, hok, jok, tl, jl, [0])
    assert tok.shape[0] == dispatches // ce and tok.all(), tinv.invariant_names(cell["engine"])


def test_violation_seeded_mid_run_trips_the_same_checks():
    """A first-receipt stamp on a never-born slot (msgtable-wf's "stamped
    implies live"), written between two windows of one FloodSub run, trips
    msgtable-wf at every check of the second window in all three paths,
    and nothing before it."""
    cell = _flood()

    def corrupt(leaves):
        fr = np.array(leaves[".dlv.first_round"])
        fr[:, M - 1] = 0
        return dict(leaves, **{".dlv.first_round": fr})

    tok, hok, jok, tl, jl = _windows(cell, 16, 4, corrupt=corrupt)
    _hold(cell, tok, hok, jok, tl, jl, [0, 2])
    mt = tinv.invariant_names("floodsub").index("msgtable-wf")
    assert tok[:2].all() and not tok[2:, mt].any()
    assert tok[2:, np.arange(tok.shape[1]) != mt].all()


def test_window_checks_a_batch_of_sims():
    """A batched check over a state with a leading sim axis (a FloodSub
    step applied sim by sim): ``ys["ok"]`` is [n_checks, S, P] and sim s's
    rows equal a window over sim s alone."""
    from go_libp2p_pubsub_tpu_torch.oracle.invariants import sim_state

    cell = _flood()
    s_dim, dispatches, ce = 2, 16, 4
    k = cell["tnet"].max_degree
    starts = [convert.state_from_reference(reference_leaves(jinit(JSim.init, N, M, seed=s, k=k)),
                                           device="cpu")
              for s in range(s_dim)]
    xs = _xs(cell, dispatches)
    tnet = cell["tnet"]

    def step(st, po, pt, pv):
        return _stacked([tflood.floodsub_step(tnet, sim_state(st, s), po[s], pt[s], pv[s])
                         for s in range(s_dim)])

    spec = tinv.ScanInvariants("floodsub", tnet, None, tinv.InvariantConfig(check_every=ce),
                               due_fn=_due_fn(dispatches))
    assert spec.batched
    win = driver.make_window(step, check=spec.check, check_every=ce)
    # sim 1 publishes on other rounds than sim 0
    bxs = tuple(np.stack([a, np.roll(a, 3, axis=0)], axis=1) for a in xs)
    _st, ys = win(_stacked(starts), bxs, spec.precompute(dispatches))
    assert ys["ok"].shape == (dispatches // ce, s_dim, len(spec.names))
    one = tinv.ScanInvariants("floodsub", tnet, None, tinv.InvariantConfig(check_every=ce),
                              batched=False, due_fn=_due_fn(dispatches))
    for s in range(s_dim):
        w1 = driver.make_window(cell["tstep"], check=one.check, check_every=ce)
        _st, y1 = w1(starts[s], tuple(a[:, s] for a in bxs), one.precompute(dispatches))
        assert torch.equal(ys["ok"][:, s], y1["ok"])
    rep = spec.report(ys["ok"])
    assert rep.n_sims == s_dim and rep.all_ok and rep.ticks == (4, 8, 12, 16)


def test_checked_window_rejects_misaligned_lengths_and_rows():
    cell = _gossip()
    spec = tinv.ScanInvariants("gossipsub", cell["tnet"], cell["tcfg"],
                               tinv.InvariantConfig(check_every=3), batched=False)
    win = driver.make_window(cell["tstep"], heartbeat=cell["heartbeat"], check=spec.check,
                             check_every=3)
    assert win.unit == 6
    leaves = reference_leaves(cell["init"]())
    fresh = lambda: convert.state_from_reference(leaves, device="cpu")  # noqa: E731
    xs = _xs(cell, 12)
    with pytest.raises(ValueError, match=r"lcm\(heartbeat period=2, check_every=3\) = 6"):
        win(fresh(), tuple(a[:4] for a in xs), spec.precompute(4))
    with pytest.raises(ValueError, match="due rows"):
        win(fresh(), xs, spec.precompute(6))
    with pytest.raises(ValueError, match="due rows"):
        win(fresh(), xs)
    with pytest.raises(ValueError, match="check_every"):
        driver.make_window(cell["tstep"], check=spec.check, check_every=0)
