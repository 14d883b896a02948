"""The port's application API (``api.py``) against the JAX package's, on
scripted sessions drawn from the JAX package's API tests (``test_api.py``,
``test_runtime_connect.py``, ``test_dynamic_topics.py``,
``test_max_message_size.py``, ``test_connmgr.py``).

Each session is one script written once against a package's modules and
run twice, through the JAX package and through the port on the CPU, in
lockstep. At every observation point (after every ``run``) the two must
agree on:

* the bytes each ``Subscription`` yields (the signed ``pb.Message``s);
* the events each ``TopicEventHandler`` yields;
* every node's ``peer_scores()``, bit for bit;
* the device state, leaf by leaf through ``convert.py`` (no leaf needs a
  tolerance);
* the session's host observables (validator errors, ``oversized_publishes``,
  the connmgr tags, score snapshots, the trace file's bytes).

Sessions: GossipSub at ``rounds_per_phase`` 1 (scores, a rejecting
validator, a traced and tag-tracked network, a checkpoint taken through
``keep_last``/``keep_every`` and resumed in a fresh port network, the
blacklist, runtime Join and Leave, score snapshots) and 8 (``max_message_size``,
runtime ``connect()`` of a dormant pair, a spare row claimed by a post-start
``add_node``); FloodSub with ``max_message_size`` and runtime Join/Leave;
RandomSub with runtime Join. A JAX network is built fresh for every
session (its steps donate their buffers)."""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import pytest
from torch_parity import diff_leaves, package_modules, reference_leaves

from go_libp2p_pubsub_tpu_torch import convert


def package(side: str):
    return package_modules(side, ("api", "config", "serve", "trace.sinks"))


def drain_events(h) -> list:
    out = []
    while (ev := h.next_event()) is not None:
        out.append(ev)
    return out


def observe(M, net, subs, handlers, extra=None) -> dict:
    """Everything the two runs must agree on at one point; drains the
    subscriptions and the handlers."""
    leaves = (reference_leaves(net.state) if M.side == "jax"
              else convert.state_leaves(net.state))
    scores = [[(pid, struct.pack("<d", v)) for pid, v in sorted(nd.peer_scores().items())]
              for nd in net.nodes]
    return dict(
        subs=[[m.SerializeToString() for m in s] for s in subs],
        events=[drain_events(h) for h in handlers],
        scores=scores,
        leaves={p: np.array(a, copy=True) for p, a in leaves.items()},
        extra=extra or {},
    )


def lockstep(session, tmp_path, **kw) -> list:
    """Run ``session`` through both packages in lockstep, comparing every
    observation; returns the port's observations."""
    runs = {side: session(package(side), tmp_path / side, **kw) for side in ("jax", "port")}
    seen = []
    for i, (ref, got) in enumerate(zip(runs["jax"], runs["port"], strict=True)):
        where = f"{session.__name__} point {i}"
        for key in ("subs", "events", "scores", "extra"):
            assert ref[key] == got[key], (where, key, ref[key], got[key])
        diff_leaves(ref["leaves"], got["leaves"], where)
        seen.append(got)
    return seen


def publish_or_error(topic, data):
    """(message id, None) or (None, the error's class name)."""
    try:
        return topic.publish(data), None
    except Exception as e:  # the two packages' error classes differ
        return None, type(e).__name__


def snapshots(nd) -> list:
    return [(pid, dataclasses.asdict(s)) for pid, s in sorted(nd.peer_score_snapshots().items())]


# ---------------------------------------------------------------------------
# sessions


def _gossip_build(M, path, n=24):
    sp = M.config.default_peer_score_params(2)
    net = M.api.Network(score_params=sp, seed=5, track_tags=True,
                        trace_sinks=[M.sinks.PBTracer(str(path / "trace.pb"))], **M.net_kw)
    nodes = net.add_nodes(n)
    net.dense_connect(d=5, seed=1)
    ta = [nd.join("a") for nd in nodes]
    tb = [nd.join("b") for nd in nodes[: n // 2]]
    return net, nodes, ta, tb


def gossip_r1(M, path):
    path.mkdir(parents=True)
    net, nodes, ta, tb = _gossip_build(M, path)
    subs = [t.subscribe() for t in ta] + [t.subscribe() for t in tb[:4]]
    handlers = [ta[0].event_handler(), tb[1].event_handler()]
    nodes[3].register_topic_validator("b", lambda pid, m: not m.data.startswith(b"bad"))
    net.start()
    yield observe(M, net, subs, handlers)

    mids = [ta[i].publish(b"a-%d" % i) for i in range(3)] + [tb[2].publish(b"b-0")]
    net.run(6)
    yield observe(M, net, subs, handlers, dict(mids=mids))

    # a validator that rejects: the local publish fails, nothing is queued
    bad = publish_or_error(tb[4], b"bad-1")
    ok = publish_or_error(tb[5], b"good-1")
    store = str(path / "store")
    net.run(4, checkpoint_every=2, checkpoint_path=store, keep_last=2, keep_every=2)
    entries = [(e["ordinal"], e["tick"], e["file"]) for e in M.serve.CheckpointStore(store).entries()]
    yield observe(M, net, subs, handlers, dict(bad=bad, ok=ok, entries=entries))
    net.run(2)
    yield observe(M, net, subs, handlers)

    # the blacklist cuts node 23 off; its handler neighbours see it leave
    nodes[0].blacklist_peer(nodes[23].peer_id)
    net.run(1)
    ta[23].publish(b"from-banned")
    net.run(3)
    yield observe(M, net, subs, handlers)

    # runtime Join of an existing topic, and Leave
    sub_new = nodes[20].join("b").subscribe()
    subs.append(sub_new)
    nodes[2].leave("a")
    net.run(3)
    tb[1].publish(b"b-after-join")
    ta[5].publish(b"a-after-leave")
    net.run(4)
    net.stop()
    extra = dict(
        tags=net.tag_tracer.cm.tags.tolist(),
        snaps=[snapshots(nodes[i]) for i in (0, 7, 20)],
        trace=(path / "trace.pb").read_bytes(),
        topics=[nd.get_topics() for nd in nodes[:4]],
        peers=nodes[1].list_peers("b"),
    )
    yield observe(M, net, subs, handlers, extra)


def gossip_r8(M, path):
    net = M.api.Network(rounds_per_phase=8, max_message_size=256, seed=7, **M.net_kw)
    nodes = net.add_nodes(20)
    net.dense_connect(d=5, seed=7)
    bridge = (nodes[0], nodes[19])
    if not net.are_connected(*bridge):
        net.connect(*bridge, dormant=True)
    net.connect(nodes[1], nodes[18], dormant=True)
    subs = [nd.join("x").subscribe() for nd in nodes]
    spare = net.provision_spare_nodes(1, topics=("x",), degree=3, seed=7)[0]
    handlers = [nodes[0].topics["x"].event_handler()]
    net.start()
    yield observe(M, net, subs, handlers)

    nodes[2].topics["x"].publish(b"s" * 16)
    nodes[3].topics["x"].publish(b"L" * 1024)   # over the limit: origin only
    net.run(16)
    yield observe(M, net, subs, handlers, dict(oversized=net.oversized_publishes))

    net.connect(nodes[1], nodes[18])           # runtime activation
    nodes[4].topics["x"].publish(b"after-connect")
    net.run(8)
    yield observe(M, net, subs, handlers)

    newcomer = net.add_node()                  # claims the spare row
    assert newcomer is spare
    subs.append(newcomer.topics["x"].subscribe())
    nbr = net._nh["nbr"] if M.side == "port" else np.asarray(net.net.nbr)
    ok = net._nh["nbr_ok"] if M.side == "port" else np.asarray(net.net.nbr_ok)
    for j in nbr[newcomer.idx][ok[newcomer.idx]]:
        net.connect(newcomer, net.nodes[int(j)])
    nodes[5].topics["x"].publish(b"to-newcomer")
    net.run(16)
    newcomer.topics["x"].publish(b"from-newcomer")
    net.run(8)
    yield observe(M, net, subs, handlers, dict(snaps=snapshots(nodes[0])))


def floodsub(M, path):
    net = M.api.Network(router="floodsub", max_message_size=256, seed=2, **M.net_kw)
    nodes = net.add_nodes(14)
    net.dense_connect(d=4, seed=2)
    subs = [nd.join("t").subscribe() for nd in nodes[:10]]
    net.start()
    nodes[3].topics["t"].publish(b"x" * 1024)
    nodes[4].topics["t"].publish(b"small")
    net.run(6)
    yield observe(M, net, subs, [], dict(oversized=net.oversized_publishes))
    subs.append(nodes[12].join("t").subscribe())
    nodes[1].leave("t")
    nodes[5].topics["t"].publish(b"after")
    net.run(6)
    yield observe(M, net, subs, [])


def randomsub(M, path):
    net = M.api.Network(router="randomsub", seed=4, **M.net_kw)
    nodes = net.add_nodes(16)
    net.dense_connect(d=5, seed=4)
    subs = [nd.join("t").subscribe() for nd in nodes[:12]]
    net.start()
    nodes[0].topics["t"].publish(b"rnd")
    net.run(5)
    yield observe(M, net, subs, [])
    subs.append(nodes[14].join("t").subscribe())
    nodes[2].topics["t"].publish(b"rnd-2")
    net.run(5)
    yield observe(M, net, subs, [])


# ---------------------------------------------------------------------------
# tests


def test_gossipsub_session_equals_reference(tmp_path):
    seen = lockstep(gossip_r1, tmp_path)
    assert seen[2]["extra"]["bad"] == (None, "ValidationError")
    assert len(seen[2]["extra"]["entries"]) == 2
    assert any(seen[-1]["subs"]) and any(any(o["events"]) for o in seen[1:])
    assert np.asarray(seen[-1]["extra"]["tags"]).sum() > 0
    # the retention store resumes in a freshly built port network: the
    # newest snapshot is the state at its point, and two rounds on equal
    # the lockstep run's next point
    M = package("port")
    (tmp_path / "resume").mkdir()
    net, _nodes, _ta, _tb = _gossip_build(M, tmp_path / "resume")
    net.start()
    net.load_checkpoint(str(tmp_path / "port" / "store"))
    diff_leaves(seen[2]["leaves"], convert.state_leaves(net.state), "restored")
    net.run(2)
    diff_leaves(seen[3]["leaves"], convert.state_leaves(net.state), "resumed")


def test_phase_session_equals_reference(tmp_path):
    seen = lockstep(gossip_r8, tmp_path)
    assert seen[1]["extra"]["oversized"] == 1
    assert [any(b"L" * 1024 in m for m in s) for s in seen[1]["subs"]].count(True) == 1
    delivered = [any(b"from-newcomer" in m for m in s) for s in seen[-1]["subs"]]
    assert sum(delivered) >= 15


@pytest.mark.parametrize("session", [floodsub, randomsub], ids=["floodsub", "randomsub"])
def test_sim_router_sessions_equal_reference(tmp_path, session):
    seen = lockstep(session, tmp_path)
    assert any(seen[0]["subs"])
