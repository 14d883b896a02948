"""RPC fragmentation: split oversized outbound RPCs into size-bounded
frames (the reference caps frames at DefaultMaxMessageSize = 1 MiB and
splits any larger RPC before queueing it, gossipsub.go:1096-1141 sendRPC ->
:1162-1251 fragmentRPC; a single message that alone exceeds the cap is
dropped with a SendRPC drop trace).

Splitting rules (behavioral parity, re-derived not transcribed):
  * subscriptions ride in the first fragment (they are tiny);
  * published messages are greedily packed into fragments by serialized
    size; one message > limit is undeliverable and is returned as dropped;
  * control GRAFT/PRUNE lists are small and kept whole in one fragment;
  * control IHAVE/IWANT message-id lists may be arbitrarily long (flood
    attacks) and are split mid-list across fragments as needed.

Pure host-side wire code — the device loop never sees frames. Consumer:
`wire.framing.write_rpc` (fragment-then-frame onto a stream).
"""

from __future__ import annotations

from ..pb import rpc_pb2 as pb

DEFAULT_MAX_RPC_SIZE = 1 << 20  # bytes, the reference's DefaultMaxMessageSize

# serialized-size slack per repeated entry (field tag + length prefix); a
# deliberate overestimate so running-size accounting never undercounts
_ENTRY_SLACK = 8


class _Packer:
    """Greedy fragment packer with linear running-size accounting (protobuf
    ByteSize() on a growing message would be quadratic in list length)."""

    def __init__(self, rpc: pb.RPC, limit: int):
        self.rpc = rpc
        self.limit = limit
        self.frags: list[pb.RPC] = []
        self.size = 0
        self._open(first=True)

    def _open(self, first: bool = False) -> None:
        f = pb.RPC()
        if first and self.rpc.subscriptions:
            f.subscriptions.extend(self.rpc.subscriptions)
        self.frags.append(f)
        self.size = f.ByteSize()

    def fit(self, extra: int) -> None:
        """Open a new fragment unless `extra` more bytes fit the current."""
        if self.size + extra > self.limit:
            self._open()

    def add(self, extra: int) -> None:
        self.size += extra


def fragment_rpc(rpc: pb.RPC, limit: int = DEFAULT_MAX_RPC_SIZE):
    """Split `rpc` into a list of RPCs each serializing to <= limit bytes.

    Returns (fragments, dropped_messages): `dropped_messages` are publish
    entries whose single-message size already exceeds the limit (the
    reference drops these with an error, gossipsub.go:1127-1136). An RPC
    already within the limit returns ([rpc], [])."""
    if rpc.ByteSize() <= limit:
        return [rpc], []

    pk = _Packer(rpc, limit)
    dropped: list[pb.Message] = []

    # published messages: greedy first-fit-in-order packing
    for msg in rpc.publish:
        sz = msg.ByteSize() + _ENTRY_SLACK
        if sz > limit:
            dropped.append(msg)
            continue
        pk.fit(sz)
        pk.frags[-1].publish.append(msg)
        pk.add(sz)

    if rpc.HasField("control"):
        ctl = rpc.control

        # graft/prune: small, keep whole; open a fresh fragment if needed
        gp_size = sum(g.ByteSize() + _ENTRY_SLACK for g in ctl.graft) + sum(
            p.ByteSize() + _ENTRY_SLACK for p in ctl.prune
        )
        if gp_size:
            pk.fit(gp_size)
            pk.frags[-1].control.graft.extend(ctl.graft)
            pk.frags[-1].control.prune.extend(ctl.prune)
            pk.add(gp_size)

        # ihave/iwant: split the id lists themselves; every id append is
        # preceded by a room check (entry header included for the first)
        for ih in ctl.ihave:
            header = len(ih.topicID.encode()) + 2 * _ENTRY_SLACK
            cur = None
            for mid in ih.messageIDs:
                sz = len(mid.encode()) + _ENTRY_SLACK
                if cur is None:
                    pk.fit(header + sz)
                elif pk.size + sz > pk.limit:
                    pk._open()
                    cur = None
                    pk.fit(header + sz)
                if cur is None:
                    cur = pk.frags[-1].control.ihave.add()
                    cur.topicID = ih.topicID
                    pk.add(header)
                cur.messageIDs.append(mid)
                pk.add(sz)
        for iw in ctl.iwant:
            header = 2 * _ENTRY_SLACK
            cur = None
            for mid in iw.messageIDs:
                sz = len(mid.encode()) + _ENTRY_SLACK
                if cur is None:
                    pk.fit(header + sz)
                elif pk.size + sz > pk.limit:
                    pk._open()
                    cur = None
                    pk.fit(header + sz)
                if cur is None:
                    cur = pk.frags[-1].control.iwant.add()
                    pk.add(header)
                cur.messageIDs.append(mid)
                pk.add(sz)

    frags = [f for i, f in enumerate(pk.frags) if i == 0 or f.ByteSize() > 0]
    return frags, dropped
