"""The port's health probes (``oracle/probes.py``) against the JAX
package's: ``health_check``'s verdicts on a clean GossipSub state and a
lived-in FloodSub state, on NaN- and Inf-seeded float leaves,
counters that went backwards, a delivery floor above the segment's
deliveries, and the opt-in ``topo-involution`` probe on a dynamic overlay
(clean and corrupted, and refused on a static state); the batched probe
against the per-sim one and the JAX package's vmapped probe. The states
are the JAX package's (FloodSub's lived-in cell of
``tests/test_torch_invariants.py``, a fresh GossipSub state for the float
planes) carried to the port with ``convert.state_from_reference``. Bools:
no tolerance."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_invariants import Cell, _stacked, cell, configs, jax_state, nets, port_state
from torch_parity import corrupt_negative_epoch, corrupt_perm_self_point, jinit

from go_libp2p_pubsub_tpu.oracle import probes as jprobes
from go_libp2p_pubsub_tpu_torch.oracle import probes as tprobes
from go_libp2p_pubsub_tpu_torch.trace.events import EV

CONFIGS = [dict(), dict(finite_state=False), dict(events_monotone=False),
           dict(delivery_floor=5), dict(delivery_floor=10_000)]


def _both(c, leaves, prev, **cfg):
    """Both packages' ``health_check`` on the state of ``leaves``: equal
    verdicts and names, returned by name."""
    jcfg, tcfg = jprobes.HealthConfig(**cfg), tprobes.HealthConfig(**cfg)
    assert tcfg.names == jcfg.names
    want = np.asarray(jprobes.health_check(jax_state(c.jst, leaves), jnp.asarray(prev), jcfg))
    got = tprobes.health_check(port_state(leaves), torch.from_numpy(prev), tcfg)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    return dict(zip(tcfg.names, want.tolist()))


def _events(leaves):
    return np.array(leaves[(".core" if ".core.tick" in leaves else "") + ".events"])


def _seeded(leaves, path, value):
    a = np.array(leaves[path])
    a.reshape(-1)[0] = value
    return dict(leaves, **{path: a})


def fresh_gossip() -> Cell:
    """A fresh GossipSub state of both packages (its float planes: the
    scores, the score counters, P6, P5)."""
    from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
    from go_libp2p_pubsub_tpu.perf.sweep import bench_score_params

    jnet, tnet = nets()
    jcfg, tcfg = configs()
    jst = jinit(JState.init, jnet, 64, jcfg, score_params=bench_score_params("default", 1)[1], seed=0)
    return Cell("gossipsub", jnet, jcfg, jst, tnet, tcfg, 12, None)


@pytest.mark.parametrize("engine", ["gossipsub", "floodsub"])
def test_health_check_equals_reference(engine):
    c = cell(engine) if engine == "floodsub" else fresh_gossip()
    clean = c.leaves
    ev = _events(clean)
    start = np.zeros_like(ev)
    for cfg in CONFIGS:
        res = _both(c, clean, start, **cfg)
        assert res.get("finite-state", True) and res.get("events-monotone", True)
        assert res["delivery-floor"] == (ev[EV.DELIVER_MESSAGE] >= cfg.get("delivery_floor", 0))
    assert ev[EV.DELIVER_MESSAGE] > (5 if engine == "floodsub" else -1)
    back = ev.copy()
    back[EV.DELIVER_MESSAGE] += 1           # the counters went backwards
    res = _both(c, clean, back)
    assert not res["events-monotone"] and not res["delivery-floor"]
    if engine != "gossipsub":
        return
    for path, bad in ((".scores", np.nan), (".score.fmd", np.inf), (".p6", -np.inf),
                      (".app_score", np.nan)):
        seeded = _seeded(clean, path, bad)
        res = _both(c, seeded, start)
        assert not res["finite-state"] and res["events-monotone"], path
        assert _both(c, seeded, start, finite_state=False) == {
            "events-monotone": True, "delivery-floor": True}


def test_topo_involution_probe_equals_reference():
    c = fresh_gossip()
    with pytest.raises(ValueError, match="dynamic"):
        tprobes.health_check(port_state(c.leaves), torch.from_numpy(_events(c.leaves)),
                             tprobes.HealthConfig(topo_involution=True))
    # the same state with an overlay plane: the net's edges
    tp = dict(nbr=np.asarray(c.jnet.nbr), nbr_ok=np.asarray(c.jnet.nbr_ok),
              rev=np.asarray(c.jnet.rev), edge_perm=np.asarray(c.jnet.edge_perm),
              epoch=np.zeros(c.jnet.nbr.shape, np.int32))
    leaves = dict(c.leaves, **{f".core.topo.{k}": v for k, v in tp.items()})
    from go_libp2p_pubsub_tpu.state import TopoState

    template = c.jst.replace(core=c.jst.core.replace(topo=TopoState(
        **{k: jnp.asarray(v) for k, v in tp.items()})))
    dyn = type(c)(**{**c.__dict__, "jst": template})
    ev = _events(leaves)
    for fn, want in ((lambda x: x, True), (corrupt_perm_self_point, False),
                     (corrupt_negative_epoch, True)):
        res = _both(dyn, fn(leaves), ev, topo_involution=True)
        # the probe reads the involution alone: a negative epoch is the
        # deep oracle's clause, not the probe's
        assert res["topo-involution"] is want, fn


def test_batched_probe_equals_per_sim_and_reference():
    c = fresh_gossip()
    variants = [c.leaves, _seeded(c.leaves, ".scores", np.nan), c.leaves]
    prev = np.stack([_events(L) for L in variants])
    prev[2, EV.DELIVER_MESSAGE] += 3
    cfg = dict(delivery_floor=0)
    fn, names = tprobes.make_health_probe(tprobes.HealthConfig(**cfg), batched=True)
    got = fn(_stacked([port_state(L) for L in variants]), torch.from_numpy(prev))
    assert got.shape == (3, len(names))
    one, _ = tprobes.make_health_probe(tprobes.HealthConfig(**cfg))
    for i, L in enumerate(variants):
        assert torch.equal(got[i], one(port_state(L), torch.from_numpy(prev[i])))
    jfn, jnames = jprobes.make_health_probe(jprobes.HealthConfig(**cfg), batched=True)
    jb = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[jax_state(c.jst, L)
                                                          for L in variants])
    assert jnames == names
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jb, jnp.asarray(prev))))
    assert got[0].all() and not got[1, 0] and not got[2, 2]
    assert tprobes.PROBE_NAMES == jprobes.PROBE_NAMES
