"""Host wire layer: varint-delimited protobuf framing and RPC
fragmentation. The device step never sees frames; they exist at the
edges, in the trace sinks (``trace/sinks.py``) and for RPCs written to or
read from a stream."""

from .fragment import DEFAULT_MAX_RPC_SIZE, fragment_rpc
from .framing import (
    FrameTooLargeError,
    decode_uvarint,
    encode_uvarint,
    read_delimited,
    read_delimited_messages,
    read_rpc,
    write_delimited,
    write_rpc,
)

__all__ = [
    "encode_uvarint",
    "decode_uvarint",
    "write_delimited",
    "write_rpc",
    "read_delimited",
    "read_delimited_messages",
    "read_rpc",
    "FrameTooLargeError",
    "fragment_rpc",
    "DEFAULT_MAX_RPC_SIZE",
]
