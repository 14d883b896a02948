"""The host modules under the port's API against the JAX package's: the
same calls on the same inputs (numpy-seeded) give the same outputs in
``sign`` (peer ids, signatures, the signing policies, peer records),
``blacklist``, ``subscription_filter``, ``protocol``, ``connmgr`` (the
tags of a traced FloodSub run, protection, trim), ``discovery`` (the
peers a bootstrap dials, readiness) and ``serve/store`` (the rolling
checkpoint store, read by either package).

Both packages sign with ``cryptography``'s Ed25519, which is deterministic,
so identities and signatures match byte for byte; RFC 8032 §7.1 TEST 2
pins the port's signing key path to the standard's vector."""

from __future__ import annotations

import numpy as np
import pytest
from torch_parity import diff_leaves, jinit, package_modules, reference_leaves

from go_libp2p_pubsub_tpu_torch import convert

SIDES = ("jax", "port")


def both(*names):
    return [package_modules(side, names) for side in SIDES]


def outcome(fn, *args):
    """A call's result, or its exception's class name and message."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the packages' classes differ, their names do not
        return ("raise", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# sign


def _messages(M, idents):
    pb = M.pb.rpc_pb2
    out = []
    for i, ident in enumerate(idents):
        m = pb.Message(data=b"payload-%d" % i, topic="t%d" % (i % 2))
        setattr(m, "from", ident.peer_id)
        m.seqno = i.to_bytes(8, "big")
        M.sign.sign_message(m, ident)
        out.append(m)
    anon = pb.Message(data=b"anon", topic="t0")
    bare = pb.Message(data=b"bare", topic="t0")
    setattr(bare, "from", idents[0].peer_id)
    bare.seqno = (7).to_bytes(8, "big")
    forged = pb.Message()
    forged.CopyFrom(out[1])
    forged.data = b"tampered"
    keyed = pb.Message()
    keyed.CopyFrom(out[2])
    keyed.key = b"\x01" + idents[3].peer_id[3:]
    return out + [anon, bare, forged, keyed]


def sign_script(M):
    seeds = (0, 1, 5_000_003, 2**40 + 7, b"seed-bytes", b"x" * 40)
    idents = [M.sign.Identity.generate(s) for s in seeds]
    msgs = _messages(M, idents)
    policies = list(M.sign.SignPolicy)
    checks = [[outcome(M.sign.check_signing_policy, p, m) for m in msgs] for p in policies]
    records = [M.sign.make_peer_record(ident, seqno=i) for i, ident in enumerate(idents)]
    forged = M.sign.SignedPeerRecord(records[0].peer_id, records[0].seqno,
                                     records[1].signature)
    valid = [M.sign.validate_peer_record(r, idents[i].peer_id) for i, r in enumerate(records)]
    valid += [M.sign.validate_peer_record(records[0], idents[1].peer_id),
              M.sign.validate_peer_record(forged, idents[0].peer_id),
              M.sign.validate_peer_record(None, idents[0].peer_id)]
    return dict(
        ids=[i.peer_id for i in idents],
        keys=[i.key.private_bytes_raw() for i in idents],
        msgs=[m.SerializeToString() for m in msgs],
        checks=[[c[:2] for c in row] for row in checks],
        records=[(r.peer_id, r.seqno, r.signature) for r in records],
        valid=valid,
        policy=[(p.name, p.signs, p.verifies) for p in policies],
        recovered=[M.sign.pubkey_from_peer_id(i.peer_id) is not None for i in idents]
        + [M.sign.pubkey_from_peer_id(b"\x00\x05short") is None],
    )


def test_sign_matches_reference():
    ref, got = (sign_script(M) for M in both("sign", "pb"))
    assert ref == got
    assert got["valid"][:6] == [True] * 6 and got["valid"][6:] == [False] * 3


def test_sign_reproduces_rfc8032_test_2():
    from go_libp2p_pubsub_tpu_torch import sign

    sk = bytes.fromhex("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb")
    key = sign.ed25519.Ed25519PrivateKey.from_private_bytes(sk)
    assert key.public_key().public_bytes_raw().hex() == (
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c")
    assert key.sign(b"\x72").hex() == (
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00")
    ident = sign.Identity(key=key, peer_id=sign.peer_id_from_pubkey(key.public_key()))
    assert sign.pubkey_from_peer_id(ident.peer_id).public_bytes_raw() == \
        key.public_key().public_bytes_raw()


# ---------------------------------------------------------------------------
# blacklist, subscription filters, protocol matching


def blacklist_script(M):
    now = [0.0]
    out = []
    for bl in (M.blacklist.MapBlacklist(),
               M.blacklist.TimeCachedBlacklist(ttl=5.0, now=lambda: now[0])):
        peers = [b"p%d" % i for i in range(6)]
        for i, p in enumerate(peers[:4]):
            now[0] = float(i)
            out.append(bl.add(p))
        now[0] = 6.5
        out.append([bl.contains(p) for p in peers])
        bl.remove(peers[3])
        out.append(M.blacklist.blacklist_mask(bl, peers).tolist())
        now[0] = 100.0
        out.append([bl.contains(p) for p in peers])
    return out


def filter_script(M):
    sf = M.subscription_filter
    topics = ["a", "b", "news/1", "news/22", "other", "news/x"]
    subs = [(True, "a"), (True, "a"), (False, "b"), (True, "news/1"), (True, "zzz"),
            (False, "news/22"), (True, "news/1")]
    filters = [sf.AllowlistSubscriptionFilter(["a", "news/1"]),
               sf.RegexSubscriptionFilter(r"news/\d+$")]
    filters.append(sf.LimitSubscriptionFilter(filters[1], limit=5))
    filters.append(sf.LimitSubscriptionFilter(filters[0], limit=7))
    return [([f.can_subscribe(t) for t in topics],
             outcome(f.filter_incoming_subscriptions, b"peer", subs)) for f in filters]


def protocol_script(M):
    pm = M.protocol
    ids = ["/floodsub/1.0.0", "/meshsub/1.0.0", "/meshsub/1.1.0", "/meshsub/1.1.0-beta",
           "/my-app/gossip/2.0.0", "/unknown/1"]
    out = []
    for matcher in (pm.ProtocolMatcher(),
                    pm.ProtocolMatcher({"/my-app/gossip/2.0.0": pm.FEATURE_MESH | pm.FEATURE_PX},
                                       match_fn=pm.prefix_match("/meshsub/1.1.0"))):
        out.append([outcome(matcher.level, i)[:2] for i in ids])
        out.append([outcome(matcher.supports, i, pm.FEATURE_PX)[:2] for i in ids])
    out.append(outcome(pm.ProtocolMatcher, {"/bad": pm.FEATURE_PX})[:2])
    return out


@pytest.mark.parametrize("script,names", [
    (blacklist_script, ("blacklist",)),
    (filter_script, ("subscription_filter",)),
    (protocol_script, ("protocol",)),
], ids=["blacklist", "subscription_filter", "protocol"])
def test_plain_host_modules_match_reference(script, names):
    ref, got = (script(M) for M in both(*names))
    assert ref == got


# ---------------------------------------------------------------------------
# connmgr


def test_connmgr_matches_reference():
    """Protection, edge values, trim and decay on the same planes, and the
    tag tracer over a traced FloodSub run of both packages: the same tags."""
    import jax.numpy as jnp
    import torch

    from go_libp2p_pubsub_tpu import connmgr as jcm
    from go_libp2p_pubsub_tpu import graph as jgraph
    from go_libp2p_pubsub_tpu.models.floodsub import floodsub_step as jflood
    from go_libp2p_pubsub_tpu.state import Net as JNet
    from go_libp2p_pubsub_tpu.state import SimState as JSim
    from go_libp2p_pubsub_tpu.trace.drain import snapshot as jsnap
    from go_libp2p_pubsub_tpu_torch import connmgr as tcm
    from go_libp2p_pubsub_tpu_torch import graph as tgraph
    from go_libp2p_pubsub_tpu_torch.models.floodsub import floodsub_step as tflood
    from go_libp2p_pubsub_tpu_torch.state import Net as TNet
    from go_libp2p_pubsub_tpu_torch.trace.drain import snapshot as tsnap

    n = 16
    jt, tt = jgraph.random_connect(n, d=5, seed=3), tgraph.random_connect(n, d=5, seed=3)
    rng = np.random.default_rng(4)
    direct = rng.random(jt.nbr.shape) < 0.1
    jnet = JNet.build(jt, jgraph.subscribe_all(n, 1), direct=direct)
    tnet = TNet.build(tt, tgraph.subscribe_all(n, 1), direct=direct, device="cpu")
    mesh = rng.random((n, 1, jnet.max_degree)) < 0.3
    tags = rng.integers(0, 16, size=(n, 1, jnet.max_degree)).astype(np.int32)
    res = []
    for cm_mod, net in ((jcm, jnet), (tcm, tnet)):
        cm = cm_mod.ConnManager(n, net.n_slots, net.max_degree)
        cm.tags = tags.copy()
        for _ in range(20):
            cm.bump(2, 0, 1)
        cm.maybe_decay(cm_mod.TAG_DECAY_INTERVAL_TICKS * 3)
        res.append([cm.tags.tolist(), cm.protected(net, mesh).tolist(),
                    cm.protected(net, None).tolist(), cm.edge_value(net, mesh).tolist(),
                    cm.trim(net, mesh, max_conns=3).tolist()])
    assert res[0] == res[1]

    jst = jinit(JSim.init, n, 32, seed=0, k=jnet.max_degree)
    tst = convert.state_from_reference(reference_leaves(jst), device="cpu")
    jtr, ttr = jcm.TagTracer(jnet), tcm.TagTracer(tnet)
    po = np.full(4, -1, np.int32)
    pt = np.zeros(4, np.int32)
    pv = np.ones(4, bool)
    for r in range(6):
        po[:] = -1
        po[: 2 if r < 2 else 0] = (3 * r, 3 * r + 1)[: 2 if r < 2 else 0]
        jprev, tprev = jsnap(jst), tsnap(tst)
        jst = jflood(jnet, jst, jnp.asarray(po), jnp.asarray(pt), jnp.asarray(pv))
        tst = tflood(tnet, tst, torch.from_numpy(po), torch.from_numpy(pt),
                     torch.from_numpy(pv))
        jtr.observe(jprev, jsnap(jst))
        ttr.observe(tprev, tsnap(tst))
        np.testing.assert_array_equal(jtr.cm.tags, ttr.cm.tags)
    assert ttr.cm.tags.sum() > 0
    np.testing.assert_array_equal(jtr.tags_for(5), ttr.tags_for(5))


# ---------------------------------------------------------------------------
# discovery


def discovery_script(M, router):
    server = M.discovery.MemoryDiscovery()
    net = M.api.Network(router=router, discovery=server, seed=9, **M.net_kw)
    nodes = net.add_nodes(14)
    for nd in nodes[:12]:
        nd.join("found")
    nodes[12].join("other")
    nodes[11].leave("found")
    ns = M.discovery.namespace("found")
    out = [[server.has_peer_record(ns, nd.peer_id) for nd in nodes]]
    out.append(net.bootstrap("found", min_peers=4))
    out.append(sorted(net._edges))
    out.append(sorted(net.discovery.connector._state.items()))
    sess = net.discovery
    out.append([sess.enough_peers(nd, "found", s) for nd in nodes[:12] for s in (0, 3, 6)])
    out.append([sess.poll_once() for _ in range(3)])
    out.append(M.discovery.min_topic_size(5)(sess, "found"))
    net.start()   # readiness against the running network, no step taken
    out.append(outcome(nodes[0].topics["found"].publish, b"x", 20)[:2] == ("raise",))
    out.append(outcome(nodes[0].topics["found"].publish, b"x", 1)[0])
    out.append(net.discovery.poll_once())
    return out


@pytest.mark.parametrize("router", ["floodsub", "gossipsub"])
def test_discovery_dials_match_reference(router):
    ref, got = (discovery_script(M, router) for M in both("api", "discovery"))
    assert ref == got
    assert got[1] and len(got[2]) > 0


def test_backoff_connector_draws_match_reference():
    out = []
    for M in both("discovery"):
        conn = M.discovery.BackoffConnector(seed=3)
        row = []
        for t in range(12):
            row.append(conn.may_dial(0, t % 3, tick=t * 7))
            conn.record_dial(0, t % 3, tick=t * 7)
        conn.reset(0, 1)
        out.append((row, sorted(conn._state.items())))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# serve/store


def test_checkpoint_store_matches_reference(tmp_path):
    """The port's rolling store keeps the JAX store's entries and manifest;
    the JAX store restores the port's newest snapshot, and with the newest
    file damaged both fall back to the same older entry."""
    from go_libp2p_pubsub_tpu.serve import CheckpointStore as JStore
    from go_libp2p_pubsub_tpu.serve import truncate_file
    from go_libp2p_pubsub_tpu.state import SimState as JSim
    from go_libp2p_pubsub_tpu_torch.serve import CheckpointStore, RetentionPolicy
    from go_libp2p_pubsub_tpu_torch.state import SimState as TSim

    n, m = 16, 32
    jst = jinit(JSim.init, n, m, seed=1, k=4)
    st = convert.state_from_reference(reference_leaves(jst), device="cpu")
    store = CheckpointStore(str(tmp_path / "port"), RetentionPolicy(keep_last=2, keep_every=3))
    jstore = JStore(str(tmp_path / "jax"), __import__(
        "go_libp2p_pubsub_tpu.serve", fromlist=["RetentionPolicy"]).RetentionPolicy(2, 3))
    for t in range(7):
        st.dlv.first_round[t % n, t % m] = t
        st.tick.fill_(t)
        store.save(st, tick=t, meta={"t": t})
        jstore.save(convert_back(st, jst), tick=t, meta={"t": t})
    strip = lambda es: [{k: v for k, v in e.items() if k != "written_at"} for e in es]  # noqa: E731
    assert strip(store.entries()) == strip(jstore.entries())
    assert [e["ordinal"] for e in store.entries()] == [0, 3, 5, 6]
    restored, entry = JStore(str(tmp_path / "port")).restore_latest(jinit(JSim.init, n, m, seed=1, k=4))
    assert entry["ordinal"] == 6
    diff_leaves(convert.state_leaves(st), reference_leaves(restored), "jax reads port")
    truncate_file(str(tmp_path / "port" / store.latest()["file"]))
    back, entry = CheckpointStore(str(tmp_path / "port")).restore_latest(
        TSim.init(n, m, seed=1, k=4, device="cpu"))
    assert entry["ordinal"] == 5 and int(back.tick) == 5


def convert_back(st, template):
    """A JAX SimState with the port state's values (the template's key type)."""
    import jax
    import jax.numpy as jnp

    leaves = convert.state_leaves(st)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in flat:
        a = leaves[jax.tree_util.keystr(path)]
        out.append(jax.random.wrap_key_data(jnp.asarray(a)) if jnp.issubdtype(
            leaf.dtype, jax.dtypes.prng_key) else jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, out)
