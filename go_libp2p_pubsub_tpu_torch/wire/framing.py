"""Varint-delimited protobuf framing.

The reference frames every RPC and trace record as LEB128 length prefix +
protobuf payload on the stream (protoio delimited writer/reader used by
comm.go:42-88,139-170 and tracer.go:132-181). This is the pure-Python
codec, the same as the JAX package's ``wire/framing.py``: both write the
same bytes for the same messages.
"""

from __future__ import annotations

from typing import BinaryIO, Iterator


def encode_uvarint(n: int) -> bytes:
    """LEB128 unsigned varint."""
    if n < 0:
        raise ValueError("uvarint encodes non-negative integers")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(buf: bytes, pos: int = 0) -> tuple[int, int]:
    """Decode a uvarint at buf[pos:]; returns (value, next_pos)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise EOFError("truncated uvarint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint too long")


def write_delimited(stream: BinaryIO, msg) -> int:
    """Write one length-prefixed protobuf message; returns bytes written."""
    payload = msg.SerializeToString()
    header = encode_uvarint(len(payload))
    stream.write(header)
    stream.write(payload)
    return len(header) + len(payload)


def write_rpc(stream: BinaryIO, rpc, limit: int | None = None):
    """Frame an outbound RPC onto a stream, fragmenting first when it
    exceeds the size cap (sendRPC -> fragmentRPC, gossipsub.go:1096-1141).
    Returns (bytes_written, dropped_messages)."""
    from .fragment import DEFAULT_MAX_RPC_SIZE, fragment_rpc

    frags, dropped = fragment_rpc(rpc, limit or DEFAULT_MAX_RPC_SIZE)
    n = 0
    for f in frags:
        n += write_delimited(stream, f)
    return n, dropped


def _read_uvarint_stream(stream: BinaryIO) -> int | None:
    result = 0
    shift = 0
    while True:
        b = stream.read(1)
        if not b:
            if shift == 0:
                return None  # clean EOF at a frame boundary
            raise EOFError("truncated uvarint")
        v = b[0]
        result |= (v & 0x7F) << shift
        if not (v & 0x80):
            return result
        shift += 7
        if shift > 63:
            raise ValueError("uvarint too long")


class FrameTooLargeError(ValueError):
    """An inbound frame's declared length exceeds the reader's cap — the
    reference bounds its delimited RPC readers at maxMessageSize
    (comm.go:62,126: protoio.NewDelimitedReader(s, p.maxMessageSize)) so a
    hostile peer can't demand an unbounded allocation; the read error kills
    the stream (handleNewStream's error return, comm.go:67-76)."""


def read_delimited(stream: BinaryIO, msg_type, max_size: int | None = None):
    """Read one length-prefixed message; None at clean EOF.

    `max_size` caps the declared frame length BEFORE any payload
    allocation (FrameTooLargeError beyond it); None = unbounded (trusted
    local files — trace replay etc.)."""
    size = _read_uvarint_stream(stream)
    if size is None:
        return None
    if max_size is not None and size > max_size:
        raise FrameTooLargeError(
            f"frame of {size} bytes exceeds the {max_size}-byte reader cap"
        )
    payload = stream.read(size)
    if len(payload) != size:
        raise EOFError("truncated frame")
    msg = msg_type()
    msg.ParseFromString(payload)
    return msg


def read_delimited_messages(stream: BinaryIO, msg_type,
                            max_size: int | None = None) -> Iterator:
    """Yield messages until EOF."""
    while True:
        msg = read_delimited(stream, msg_type, max_size=max_size)
        if msg is None:
            return
        yield msg


def read_rpc(stream: BinaryIO, max_size: int | None = None):
    """Read one RPC frame off a peer stream with the reference's
    maxMessageSize reader bound (comm.go:62)."""
    from .fragment import DEFAULT_MAX_RPC_SIZE
    from ..pb import rpc_pb2

    return read_delimited(
        stream, rpc_pb2.RPC,
        max_size=DEFAULT_MAX_RPC_SIZE if max_size is None else max_size,
    )
