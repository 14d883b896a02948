"""The async-validation pipeline in every engine of the port, against the
JAX package's, leaf by leaf, every round or phase.

A state built with the pipeline (``SimState.init(val_delay=V)``, or a
GossipSub config's ``validation_delay_rounds``) marks receipts seen on
arrival and holds them V rounds, or each topic's own delay
(``validation_delay_topic``), before their verdict: forwarding,
Deliver/Reject, ``first_round`` and the score credit land at pipeline exit.
Cells: FloodSub and RandomSub with a uniform pipeline (V = 1, 2) on the
banded lattice and CSR-resident, FloodSub with the queue cap as well
(tests/test_pipeline_all_routers.py:101), and the per-round GossipSub step
and the phase engine (r = 1, 8) with uniform and per-topic delays over
three topics, under the validation throttle at a capacity of 2, so that
refused receipts clear from every stage. The port runs with
``device="cpu"``; no tolerance on any leaf."""

from __future__ import annotations

import functools

import pytest
from test_torch_randomsub import nets, randomsub_steps, run_against_reference
from torch_parity import bench_builds, phases_against_reference, rounds_against_reference

from go_libp2p_pubsub_tpu import config as jconfig
from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models import floodsub as jflood
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubConfig as JCfg
from go_libp2p_pubsub_tpu_torch import config as tconfig
from go_libp2p_pubsub_tpu_torch.models import floodsub as tflood
from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig as TCfg

DROP_RPC, REJECT = 8, 1


@pytest.mark.parametrize("engine,kind,val_delay,queue_cap", [
    ("floodsub", "lattice", 1, 0), ("floodsub", "powerlaw", 2, 0),
    ("floodsub", "lattice", 1, 1),
    ("randomsub", "lattice", 2, 0), ("randomsub", "powerlaw", 1, 0),
])
def test_router_pipeline_equals_reference(engine, kind, val_delay, queue_cap):
    layout = "csr" if kind == "powerlaw" else "dense"
    jnet, tnet = nets(kind, layout)
    if engine == "floodsub":
        steps = (functools.partial(jflood.floodsub_step, jnet, queue_cap=queue_cap),
                 functools.partial(tflood.floodsub_step, tnet, queue_cap=queue_cap))
    else:
        steps = randomsub_steps(jnet, tnet, size_estimate=30, queue_cap=queue_cap)
    leaves = run_against_reference(jnet, tnet, *steps, resident=kind == "powerlaw",
                                   val_delay=val_delay)
    assert leaves[".dlv.pending"].shape[1] == val_delay
    assert leaves[".dlv.pending"].any() and leaves[".events"][3] > 0
    assert (leaves[".events"][DROP_RPC] > 0) == (queue_cap > 0)


def _pipeline_builds(delays, n=96):
    """bench_builds on the K=8 lattice with the throttle at 2, over three
    topics (each peer in two) with per-topic ``delays``, or one topic with
    a uniform pipeline of depth ``delays``."""
    kw = dict(n=n, d=4, validation_capacity=2)
    if isinstance(delays, tuple):
        kw.update(subscriptions=jgraph.subscribe_random(n, 3, 2, seed=0),
                  validation_delay_topic=delays)
    else:
        kw.update(validation_delay_rounds=delays)
    return bench_builds(**kw)


class PipelineLog:
    """An ``observe`` callback: whether a stage ever held a receipt and
    the throttle's reject count grew."""

    def __init__(self):
        self.pending = 0
        self.rejects = 0

    def __call__(self, st):
        self.pending = max(self.pending, int((st.core.dlv.pending != 0).sum()))
        self.rejects = int(st.core.events[REJECT])


@pytest.mark.parametrize("engine,delays", [
    pytest.param("round", 2, id="round-uniform2"),
    pytest.param("round", (1, 2, 3), id="round-topics123"),
    pytest.param("phase1", (3, 1, 2), id="phase1-topics312"),
    pytest.param("phase8", (2, 1, 3), id="phase8-topics213"),
])
def test_gossipsub_pipeline_equals_reference(engine, delays):
    builds = _pipeline_builds(delays)
    log = PipelineLog()
    if engine == "round":
        rounds_against_reference(builds, 16, observe=log)
    else:
        r = 1 if engine == "phase1" else 8
        phases_against_reference(builds, r, 1, 16 if r == 1 else 24, observe=log)
    assert log.pending > 0 and log.rejects > 0


@pytest.mark.parametrize("kw", [
    dict(validation_delay_rounds=2),
    dict(validation_delay_topic=(1, 3)),
    dict(validation_delay_rounds=4, validation_delay_topic=(1, 3), validator_timeout_rounds=2),
    dict(validation_delay_rounds=3, validator_timeout_rounds=3),
])
def test_config_fields_equal_reference(kw):
    """``build``'s derived depth and ``validation_timed_out`` per topic, as
    the JAX config has them; out-of-range delays and a negative timeout
    raise on both sides."""
    j = JCfg.build(jconfig.GossipSubParams(), **kw)
    t = TCfg.build(tconfig.GossipSubParams(), **kw)
    for f in ("validation_delay_rounds", "validation_delay_topic", "validator_timeout_rounds"):
        assert getattr(j, f) == getattr(t, f), f
    assert [j.validation_timed_out(i) for i in range(2)] == [
        t.validation_timed_out(i) for i in range(2)]
    for bad in (dict(validation_delay_rounds=1, validation_delay_topic=(2,)),
                dict(validator_timeout_rounds=-1)):
        for cls, params in ((JCfg, jconfig.GossipSubParams), (TCfg, tconfig.GossipSubParams)):
            with pytest.raises(ValueError):
                cls.build(params(), **bad)
