"""The port's trace drain and sinks (``trace/drain.py``, ``trace/sinks.py``,
``wire/``, ``pb/``) against the JAX package's.

Every cell runs one numpy-seeded schedule through both packages: the JAX
step under the JAX ``TraceSession`` writing through the JAX sinks, the
port's step (on the CPU) under the port's session writing through the
port's sinks. The ndjson files (``JSONTracer``), the delimited protobuf
files (``PBTracer``), the collector streams (``RemoteTracer``) and a
second protobuf file written under ``queue_cap=1`` (so DROP_RPC records
appear) must be equal byte for byte, and the device counters and the
sessions' accounting caveats equal. Cells: the per-round GossipSub step
on the lattice, a random dense net and CSR-resident (``snapshot(st,
net)`` densifies the flat first-arrival plane); the phase engine at r =
8; exact mode on a ``trace_exact`` build. Churn, PX, FloodSub and
RandomSub are tests/test_torch_trace_engines.py, which uses this file's
runners (split so that each file stays within a loadfile worker's share of
the suite). A fresh JAX state is built for every run: the JAX steps donate
their buffers.

The sink, framing, fragmentation and schema tests of the JAX package's
``tests/test_trace.py`` and ``tests/test_pb.py`` run here on the port's
modules, and the port's generated schema modules are the JAX package's
(equal serialized descriptors: both register in one descriptor pool)."""

from __future__ import annotations

import gzip
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bench_builds, jinit, phase_schedule, reference_leaves

from go_libp2p_pubsub_tpu import graph as jgraph
from go_libp2p_pubsub_tpu.models.gossipsub import GossipSubState as JState
from go_libp2p_pubsub_tpu.models.gossipsub import make_gossipsub_step as jmake
from go_libp2p_pubsub_tpu.models.gossipsub_phase import make_gossipsub_phase_step as jmake_phase
from go_libp2p_pubsub_tpu.pb import compat_pb2 as jcompat_pb2
from go_libp2p_pubsub_tpu.pb import rpc_pb2 as jrpc_pb2
from go_libp2p_pubsub_tpu.pb import trace_pb2 as jtrace_pb2
from go_libp2p_pubsub_tpu.trace import drain as jdrain
from go_libp2p_pubsub_tpu.trace import sinks as jsinks
from go_libp2p_pubsub_tpu_torch import convert, trace
from go_libp2p_pubsub_tpu_torch import graph as tgraph
from go_libp2p_pubsub_tpu_torch.driver import heartbeat_schedule
from go_libp2p_pubsub_tpu_torch.models.gossipsub import make_gossipsub_step as tmake
from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
from go_libp2p_pubsub_tpu_torch.pb import compat_pb2, rpc_pb2, trace_pb2
from go_libp2p_pubsub_tpu_torch.trace import drain as tdrain
from go_libp2p_pubsub_tpu_torch.trace import sinks as tsinks
from go_libp2p_pubsub_tpu_torch.trace.events import EV, event_name
from go_libp2p_pubsub_tpu_torch.wire import fragment, framing

TYPE = trace_pb2.TraceEvent


# ---------------------------------------------------------------------------
# schemas


@pytest.mark.parametrize("port,ref", [(trace_pb2, jtrace_pb2), (rpc_pb2, jrpc_pb2),
                                      (compat_pb2, jcompat_pb2)],
                         ids=["trace", "rpc", "compat"])
def test_schema_descriptors_equal_the_reference(port, ref):
    """One file, one descriptor: the port's generated module registers the
    JAX package's serialized file, so the pool hands back its classes."""
    assert port.DESCRIPTOR.serialized_pb == ref.DESCRIPTOR.serialized_pb
    assert port.DESCRIPTOR is ref.DESCRIPTOR


def test_event_names_and_lazy_modules():
    assert [event_name(e) for e in EV] == [e.name for e in EV]
    assert [event_name(int(e)) for e in EV if e <= EV.PRUNE] == [
        TYPE.Type.Name(int(e)) for e in EV if e <= EV.PRUNE]
    assert trace.sinks is tsinks and trace.drain is tdrain


def test_rpc_roundtrip_full():
    rpc = rpc_pb2.RPC()
    rpc.subscriptions.add(subscribe=True, topicid="news")
    rpc.subscriptions.add(subscribe=False, topicid="olds")
    m = rpc.publish.add()
    setattr(m, "from", b"\x01peerA")  # `from` is a Python keyword
    m.data, m.seqno, m.topic, m.signature, m.key = (
        b"payload", (7).to_bytes(8, "big"), "news", b"sig", b"key")
    rpc.control.ihave.add(topicID="news", messageIDs=["m1", "m2"])
    rpc.control.iwant.add(messageIDs=["m1"])
    rpc.control.graft.add(topicID="news")
    pr = rpc.control.prune.add(topicID="news", backoff=60)
    pr.peers.add(peerID=b"\x01peerB", signedPeerRecord=b"rec")
    out = rpc_pb2.RPC()
    out.ParseFromString(rpc.SerializeToString())
    assert out == rpc and out.control.prune[0].backoff == 60


@pytest.mark.parametrize("topics,want", [(["a"], "a"), (["a", "b"], "b")])
def test_compat_old_to_new(topics, want):
    """Old-form messages parse as the new single ``topic`` (proto2
    last-wins for a repeated field read as optional); a new-form message
    parses as old-form with one topic id."""
    m = rpc_pb2.Message()
    m.ParseFromString(compat_pb2.Message(data=b"d", topicIDs=topics).SerializeToString())
    assert m.topic == want
    old = compat_pb2.Message()
    old.ParseFromString(rpc_pb2.Message(data=b"d", seqno=b"\0" * 8, topic=want)
                        .SerializeToString())
    assert list(old.topicIDs) == [want] and old.data == b"d"


def test_trace_event_schema_and_batch():
    ev = TYPE(type=TYPE.GRAFT, peerID=b"p0", timestamp=123)
    ev.graft.peerID, ev.graft.topic = b"p1", "t"
    out = TYPE()
    out.ParseFromString(ev.SerializeToString())
    assert out.type == TYPE.GRAFT and out.graft.topic == "t"
    assert TYPE.PUBLISH_MESSAGE == 0 and TYPE.PRUNE == 12
    b = trace_pb2.TraceEventBatch()
    for i in range(3):
        b.batch.add(timestamp=i)
    back = trace_pb2.TraceEventBatch()
    back.ParseFromString(b.SerializeToString())
    assert len(back.batch) == 3


# ---------------------------------------------------------------------------
# framing and fragmentation


def test_uvarint_and_delimited_roundtrip():
    for n in [0, 1, 127, 128, 300, 2**21 - 1, 2**35, 2**63 - 1]:
        buf = framing.encode_uvarint(n)
        assert framing.decode_uvarint(buf) == (n, len(buf))
    buf = io.BytesIO()
    evs = [TYPE(type=TYPE.JOIN, timestamp=i) for i in range(10)]
    for i, ev in enumerate(evs):
        ev.join.topic = f"t{i}"
        framing.write_delimited(buf, ev)
    buf.seek(0)
    assert list(framing.read_delimited_messages(buf, TYPE)) == evs
    cut = buf.getvalue()[:-1]
    with pytest.raises(EOFError):
        list(framing.read_delimited_messages(io.BytesIO(cut), TYPE))


def test_read_rpc_caps_the_frame():
    buf = io.BytesIO()
    framing.write_delimited(buf, _mk_rpc(n_msgs=2, msg_size=100))
    buf.seek(0)
    with pytest.raises(framing.FrameTooLargeError):
        framing.read_rpc(buf, max_size=64)
    buf.seek(0)
    assert len(framing.read_rpc(buf).publish) == 2


def _mk_rpc(n_msgs=0, msg_size=0, n_ids=0, subs=("a",), grafts=(), id_size=20):
    rpc = rpc_pb2.RPC()
    for t in subs:
        rpc.subscriptions.add(subscribe=True, topicid=t)
    for i in range(n_msgs):
        m = rpc.publish.add()
        m.data, m.seqno, m.topic = bytes(msg_size), i.to_bytes(8, "big"), "a"
    for t in grafts:
        rpc.control.graft.add(topicID=t)
    if n_ids:
        ih = rpc.control.ihave.add()
        ih.topicID = "a"
        ih.messageIDs.extend("m%0*d" % (id_size - 1, i) for i in range(n_ids))
    return rpc


def _mixed_rpc():
    rpc = _mk_rpc(n_msgs=7, msg_size=1400)  # lands near the limit boundary
    rpc.control.iwant.add().messageIDs.extend(["x" * 500, "y" * 500])
    return rpc


#: name -> (rpc, limit, fragments expected, dropped messages expected)
FRAGMENT_CASES = {
    "under_limit": (lambda: _mk_rpc(n_msgs=3, msg_size=100), 1 << 20, 1, 0),
    "messages": (lambda: _mk_rpc(n_msgs=40, msg_size=4000), 20_000, None, 0),
    "oversize_message": (lambda: _mk_rpc(n_msgs=2, msg_size=50_000), 10_000, None, 2),
    "ihave_ids": (lambda: _mk_rpc(n_ids=5000, grafts=("a", "b")), 30_000, None, 0),
    "publish_then_control": (_mixed_rpc, 10_000, None, 0),
}


@pytest.mark.parametrize("case", sorted(FRAGMENT_CASES))
def test_fragment_rpc(case):
    """fragmentRPC (gossipsub.go:1162-1251): every fragment within the
    limit, messages and id lists in order, subscriptions in the first
    fragment only, graft lists whole, a message over the limit dropped;
    the same fragments as the JAX package's."""
    from go_libp2p_pubsub_tpu.wire.fragment import fragment_rpc as jfragment

    make, limit, n_frags, n_dropped = FRAGMENT_CASES[case]
    rpc = make()
    frags, dropped = fragment.fragment_rpc(rpc, limit=limit)
    jfrags, jdropped = jfragment(make(), limit=limit)
    assert [f.SerializeToString() for f in frags] == [f.SerializeToString() for f in jfrags]
    assert len(dropped) == len(jdropped) == n_dropped
    assert all(f.ByteSize() <= limit for f in frags)
    if n_frags is not None:
        assert frags == [rpc]
        return
    assert len(frags) > 1 or n_dropped
    assert [m.seqno for f in frags for m in f.publish] == [
        m.seqno for m in rpc.publish if m.ByteSize() + 8 <= limit]
    for name in ("ihave", "iwant"):
        got = [m for f in frags for e in getattr(f.control, name) for m in e.messageIDs]
        assert got == [m for e in getattr(rpc.control, name) for m in e.messageIDs]
    assert sum(len(f.control.graft) for f in frags) == len(rpc.control.graft)
    assert len(frags[0].subscriptions) == 1 and all(not f.subscriptions for f in frags[1:])


def test_write_rpc_fragments_on_stream():
    rpc = _mk_rpc(n_ids=3000)
    buf = io.BytesIO()
    n, dropped = framing.write_rpc(buf, rpc, limit=20_000)
    assert not dropped and n == len(buf.getvalue())
    buf.seek(0)
    got = list(framing.read_delimited_messages(buf, rpc_pb2.RPC))
    assert len(got) > 1
    ids = [m for f in got for ih in f.control.ihave for m in ih.messageIDs]
    assert ids == list(rpc.control.ihave[0].messageIDs)


# ---------------------------------------------------------------------------
# sinks


def _mk_event(i):
    ev = TYPE(type=TYPE.DELIVER_MESSAGE, peerID=b"p%d" % i, timestamp=i)
    ev.deliverMessage.messageID = b"m%d" % i
    return ev


@pytest.mark.parametrize("kind", ["json", "pb", "remote"])
def test_sink_roundtrip_and_reference_bytes(tmp_path, kind):
    """Each sink reads back what it wrote and writes the JAX sink's bytes."""
    evs = [_mk_event(i) for i in range(40)]
    out = {}
    for tag, mod in (("port", tsinks), ("jax", jsinks)):
        path = str(tmp_path / f"{tag}.{kind}")
        frames: list[bytes] = []
        t = {"json": lambda: mod.JSONTracer(path),
             "pb": lambda: mod.PBTracer(path, use_native=False),
             "remote": lambda: mod.RemoteTracer(frames.append, min_batch=16)}[kind]()
        t.trace_many(evs)
        t.close()
        out[tag] = b"".join(frames) if kind == "remote" else open(path, "rb").read()
        if tag == "port":
            back = {"json": lambda: list(tsinks.read_json_trace(path)),
                    "pb": lambda: list(tsinks.read_pb_trace(path)),
                    "remote": lambda: tsinks.decode_remote_stream(out["port"])}[kind]()
            assert back == evs
    assert out["port"] == out["jax"]


def test_pb_tracer_refuses_the_native_writer(tmp_path):
    with pytest.raises(ValueError, match="item 8"):
        tsinks.PBTracer(str(tmp_path / "t.pb"), use_native=True)


def test_remote_tracer_batching():
    frames: list[bytes] = []
    t = tsinks.RemoteTracer(frames.append, min_batch=4)
    evs = [_mk_event(i) for i in range(10)]
    t.trace_many(evs)  # two full batches sent eagerly
    assert len(frames) == 2
    t.close()          # remainder flushed + gzip stream finished
    assert len(frames) == 4
    assert tsinks.decode_remote_stream(b"".join(frames)) == evs
    assert frames[0][:2] == b"\x1f\x8b" and gzip.decompress(b"".join(frames))


def test_remote_tracer_reconnect_semantics():
    """tracer.go:201-301: a failed batch is lost, the stream redialed with
    a fresh gzip member, events kept (lossily) while the collector is
    down and sent in order once it is back."""
    col = tsinks.MemoryCollector()
    t = tsinks.RemoteTracer(connect=col.connect, min_batch=4, redial_backoff=2)
    evs = [_mk_event(i) for i in range(24)]
    t.trace_many(evs[:4])
    assert col.connections == 1 and t.dials == 1
    col.fail_writes = 1
    t.trace_many(evs[4:8])          # lost; the immediate redial wins
    assert t.write_failures == 1 and t.lost_events == 4 and col.connections == 2
    t.trace_many(evs[8:12])
    assert col.events() == evs[:4] + evs[8:12]
    col.go_down()
    t.trace_many(evs[12:16])        # lost on write; the dial fails
    assert t.lost_events == 8 and t.dial_failures == 1
    t.trace_many(evs[16:20])        # kept while down
    assert len(t._pending) == 4 and col.connections == 2
    col.go_up()
    t.trace_many(evs[20:24])
    t.close()
    assert col.connections == 3
    assert col.events() == evs[:4] + evs[8:12] + evs[16:24]


def test_decode_spliced_abandoned_member():
    chunks: list[bytes] = []
    t = tsinks.RemoteTracer(chunks.append, min_batch=4)
    evs = [_mk_event(i) for i in range(12)]
    t.trace_many(evs[:8])
    t._stream = None             # stream reset: the member never finished
    t.trace_many(evs[8:12])      # redial: a fresh member on the same sink
    t.close()
    assert tsinks.decode_remote_stream(b"".join(chunks)) == evs


@pytest.mark.parametrize("case", ["closed", "close_while_down", "cap_while_down", "lossy"])
def test_tracer_buffer_and_loss_accounting(case):
    """The lossy 64Ki buffer's contract (tracer.go:23-24, 195): a closed
    sink is inert, events stranded at close are counted lost, the buffer
    holds at most its cap while the collector is down (the rest dropped),
    and a base sink counts what it drops."""
    col = tsinks.MemoryCollector()
    if case == "closed":
        t = tsinks.RemoteTracer(connect=col.connect, min_batch=2)
        t.trace_many([_mk_event(0), _mk_event(1)])
        t.close()
        dials = t.dials
        t.trace_many([_mk_event(2), _mk_event(3)])
        assert t.dials == dials and len(col.events()) == 2
    elif case == "close_while_down":
        col.go_down()
        t = tsinks.RemoteTracer(connect=col.connect, min_batch=64, redial_backoff=0)
        t.trace_many([_mk_event(i) for i in range(5)])
        t.close()
        assert t.lost_events == 5 and not t._pending
    elif case == "cap_while_down":
        col.go_down()
        t = tsinks.RemoteTracer(connect=col.connect, min_batch=4, redial_backoff=0,
                                buffer_cap=6)
        for i in range(20):
            t.trace(_mk_event(i))
        assert len(t._pending) <= 6 and t.dropped >= 14
        col.go_up()
        t.flush()
        t.close()
        assert len(col.events()) >= 6
    else:
        t = tsinks.Tracer(buffer_cap=3)
        t._write = lambda evs: None
        for i in range(10):
            t.trace(_mk_event(i))
        assert t.dropped == 7


# ---------------------------------------------------------------------------
# the drain: the same runs through both packages


class _Outputs:
    """One package's sinks over one run: ndjson, delimited protobuf and a
    collector stream under the default session, and a protobuf file under
    a ``queue_cap=1`` session."""

    def __init__(self, mod, drain, net, base, exact):
        self.paths = [f"{base}.json", f"{base}.pb", f"{base}.q1.pb"]
        self.frames: list[bytes] = []
        self.sessions = [
            drain.TraceSession(net, [mod.JSONTracer(self.paths[0]),
                                     mod.PBTracer(self.paths[1], use_native=False),
                                     mod.RemoteTracer(self.frames.append)], exact=exact),
            drain.TraceSession(net, [mod.PBTracer(self.paths[2], use_native=False)],
                               queue_cap=1, exact=exact),
        ]

    def bytes(self):
        return [open(p, "rb").read() for p in self.paths] + [b"".join(self.frames)]


def _trace(drain, sinks, net, st, call, pubs, n, base, exact, resident):
    """Run ``n`` dispatches of ``call(st, i)`` under two sessions; returns
    (outputs, final state, final snapshot)."""
    out = _Outputs(sinks, drain, net, base, exact)
    snap = lambda s: drain.snapshot(s, net if resident else None)
    prev = snap(st)
    for sess in out.sessions:
        sess.emit_init(prev)
    for i in range(n):
        st = call(st, i)
        new = snap(st)
        for sess in out.sessions:
            sess.observe(prev, new, *pubs(i))
        prev = new
    for sess in out.sessions:
        sess.close(prev)
    return out, st, prev


def _both(tmp_path, nets, states, calls, pubs, n, exact=False, resident=False):
    """The same run through both packages; asserts equal trace bytes,
    counters and caveats and returns the port's final snapshot, session
    and the events of its two protobuf files."""
    jout, _, jsnap = _trace(jdrain, jsinks, nets[0], states[0], calls[0], pubs, n,
                            tmp_path / "jax", exact, resident)
    tout, _, tsnap = _trace(tdrain, tsinks, nets[1], states[1], calls[1], pubs, n,
                            tmp_path / "port", exact, resident)
    names = ["json", "pb", "pb queue_cap=1", "remote stream"]
    for name, a, b in zip(names, jout.bytes(), tout.bytes()):
        assert a == b, f"{name} differs: {len(a)} bytes against {len(b)}"
    np.testing.assert_array_equal(jsnap.events, tsnap.events)
    sess = tout.sessions[0]
    assert sess.counter_events(tsnap) == jout.sessions[0].counter_events(jsnap)
    assert sess.accounting_caveats() == jout.sessions[0].accounting_caveats()
    assert tsinks.decode_remote_stream(tout.bytes()[3]) == list(
        tsinks.read_pb_trace(tout.paths[1]))
    return tsnap, sess, [list(tsinks.read_pb_trace(p)) for p in tout.paths[1:3]]


def _types(evs):
    return {TYPE.Type.Name(e.type) for e in evs}


N = 96
ROUNDS = 12
#: the record types every GossipSub cell writes in default mode (PRUNE
#: needs over-subscription: the PX cell; REMOVE_PEER churn)
GOSSIP_TYPES = {"PUBLISH_MESSAGE", "DELIVER_MESSAGE", "REJECT_MESSAGE", "ADD_PEER", "JOIN",
                "LEAVE", "SEND_RPC", "RECV_RPC", "GRAFT"}


def _gossip_run(builds, rounds, r=1, up=None, dormant=None, step_kw=None):
    """(nets, states, calls, pubs, dispatches) of a GossipSub run of both
    packages from one fresh state: the per-round step, or the phase
    engine at r with heartbeats as ``heartbeat_schedule`` flags them."""
    jcfg, jnet, jsp, tcfg, tnet, tsp = builds
    jst = jinit(JState.init, jnet, 64, jcfg, score_params=jsp, seed=0, dormant=dormant)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    kw = step_kw or {}
    po, pt, pv = phase_schedule(tnet.n_peers, rounds)
    if r == 1:
        jstep = jmake(jcfg, jnet, score_params=jsp, **kw)
        tstep = tmake(tcfg, tnet, score_params=tsp, **kw)
        rows = (lambda i: (up[i],)) if up is not None else (lambda i: ())
        jcall = lambda s, i: jstep(s, jnp.asarray(po[i]), jnp.asarray(pt[i]),
                                   jnp.asarray(pv[i]), *map(jnp.asarray, rows(i)))
        tcall = lambda s, i: tstep(s, torch.from_numpy(po[i]), torch.from_numpy(pt[i]),
                                   torch.from_numpy(pv[i]), *map(torch.from_numpy, rows(i)))
        return (jnet, tnet), (jst, tst), (jcall, tcall), lambda i: (po[i], pt[i], pv[i]), rounds
    flags = heartbeat_schedule(tcfg.heartbeat_every, r)
    jstep = jmake_phase(jcfg, jnet, r, score_params=jsp, **kw)
    tstep = make_gossipsub_phase_step(tcfg, tnet, r, score_params=tsp, **kw)
    sl = lambda i: slice(i * r, (i + 1) * r)
    hb = lambda i: flags[i % len(flags)]
    jcall = lambda s, i: jstep(s, jnp.asarray(po[sl(i)]), jnp.asarray(pt[sl(i)]),
                               jnp.asarray(pv[sl(i)]), do_heartbeat=hb(i))
    tcall = lambda s, i: tstep(s, torch.from_numpy(po[sl(i)]), torch.from_numpy(pt[sl(i)]),
                               torch.from_numpy(pv[sl(i)]), do_heartbeat=hb(i))
    pubs = lambda i: (po[sl(i)], pt[sl(i)], pv[sl(i)])
    return (jnet, tnet), (jst, tst), (jcall, tcall), pubs, rounds // r


def _random_topologies(n=N):
    return jgraph.random_connect(n, 5, seed=1), tgraph.random_connect(n, 5, seed=1)


@pytest.mark.parametrize("cell", ["lattice", "random", "csr"])
def test_round_traces_equal_reference(tmp_path, cell):
    """The per-round GossipSub step: ``GOSSIP_TYPES``, DELIVER + REJECT one for each first receipt counted on the
    device, SEND_RPC and RECV_RPC one each per receipt, DROP_RPC under
    ``queue_cap=1``; CSR-resident the flat plane densified by the
    snapshot."""
    kw = {} if cell == "lattice" else dict(topologies=_random_topologies())
    if cell == "csr":
        kw.update(edge_layout="csr", fused=True)
    run = _gossip_run(bench_builds(n=N, d=4, **kw), ROUNDS)
    assert (run[1][1].core.dlv.fe_words.dim() == 2) == (cell == "csr")
    snap, sess, (evs, q1) = _both(tmp_path, *run, resident=cell == "csr")
    assert GOSSIP_TYPES <= _types(evs) and "DROP_RPC" in _types(q1)
    count = sess.counter_events(snap)
    kinds = [TYPE.Type.Name(e.type) for e in evs]
    first = kinds.count("DELIVER_MESSAGE") + kinds.count("REJECT_MESSAGE")
    assert kinds.count("DELIVER_MESSAGE") == count["DELIVER_MESSAGE"]
    assert kinds.count("SEND_RPC") == kinds.count("RECV_RPC") == first


def test_phase_traces_equal_reference(tmp_path):
    """The phase engine at r = 8: DELIVER records keep their sub-round
    ticks, control lands at the phase heads, and both sessions report the
    phase-cadence caveat."""
    builds = bench_builds(n=N, d=4, heartbeat_every=8)
    snap, sess, (evs, _) = _both(tmp_path, *_gossip_run(builds, 24, r=8))
    assert sess.accounting_caveats() == {"phase_cadence": tdrain.PHASE_CADENCE_NOTE}
    ticks = {e.timestamp // 10**9 for e in evs if e.type == TYPE.DELIVER_MESSAGE}
    assert len({t % 8 for t in ticks}) > 1
    assert {e.timestamp // 10**9 % 8 for e in evs if e.type == TYPE.GRAFT} == {0}
    assert {"PUBLISH_MESSAGE", "DELIVER_MESSAGE", "SEND_RPC", "RECV_RPC", "GRAFT"} <= _types(evs)


def test_exact_traces_equal_reference(tmp_path):
    """Exact mode on a ``trace_exact`` build: every duplicate a
    DUPLICATE_MESSAGE record, and one RPC pair per (sender, receiver,
    round) with full RPCMeta, control-only RPCs included."""
    builds = bench_builds(n=N, d=4, options=dict(trace_exact=True), validation_capacity=2)
    snap, sess, (evs, _) = _both(tmp_path, *_gossip_run(builds, ROUNDS), exact=True)
    kinds = [TYPE.Type.Name(e.type) for e in evs]
    assert kinds.count("DUPLICATE_MESSAGE") == sess.counter_events(snap)["DUPLICATE_MESSAGE"] > 0
    assert any(e.type == TYPE.SEND_RPC and not e.sendRPC.meta.messages
               and e.sendRPC.meta.control.ihave for e in evs)


def test_snapshot_reads_the_port_state(tmp_path):
    """A snapshot carries the JAX package's dtypes, takes the publish
    arrays as tensors, and refuses a CSR-resident state without its
    net."""
    builds = bench_builds(n=32, d=2, edge_layout="csr", fused=True)
    run = _gossip_run(builds, 12)
    tst = run[2][1](run[1][1], 0)
    snap = tdrain.snapshot(tst, builds[4])
    assert (snap.first_edge.dtype, snap.first_round.dtype, snap.mesh.dtype) == (
        np.int8, np.int32, np.bool_)
    with pytest.raises(ValueError, match="net="):
        tdrain.snapshot(tst)
    sess = tdrain.TraceSession(builds[4], [])
    po, pt, pv = run[3](1)
    sess.observe(snap, tdrain.snapshot(run[2][1](tst, 1), builds[4]),
                 torch.from_numpy(po), torch.from_numpy(pt), torch.from_numpy(pv))
    assert int(sess.seqno.sum()) == int((po >= 0).sum())
    per_sim, totals = tdrain.batched_counter_events(torch.stack([tst.core.events] * 2))
    assert per_sim[0] == per_sim[1] and totals["PUBLISH_MESSAGE"] == 2 * per_sim[0][
        "PUBLISH_MESSAGE"]
    assert snap.tick == int(tst.core.tick) == 1
