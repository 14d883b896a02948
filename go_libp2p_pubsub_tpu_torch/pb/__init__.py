"""Wire-schema bindings: the three ``.proto`` files here (the JAX package's
schemas) and their protoc output, whose ``_pb2.py`` modules are byte for
byte the JAX package's.

The protobuf runtime holds one descriptor pool a process. A second
registration of a file that is byte for byte the same returns the same
descriptor and message classes, so both packages' bindings load side by
side and their messages are interchangeable; a file of the same name that
differs in one field fails to load. So these modules are never
regenerated or edited here: a schema change is made in both packages at
once, from the same protoc run.

Schemas are wire-compatible with the reference's pb/rpc.proto,
pb/trace.proto and compat/compat.proto (see each .proto header).
"""

from . import pubsub_compat_pb2 as compat_pb2
from . import pubsub_rpc_pb2 as rpc_pb2
from . import pubsub_trace_pb2 as trace_pb2

__all__ = ["rpc_pb2", "trace_pb2", "compat_pb2"]
