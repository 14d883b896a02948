"""Trace sinks — buffered writers for TraceEvent streams (tracer.go:79-303).

Three sinks, same as the reference:
  JSONTracer    — one JSON object per line (ndjson), human/jq-friendly
  PBTracer      — varint-delimited protobuf records
  RemoteTracer  — gzip-compressed TraceEventBatch frames shipped to a
                  collector (proto /libp2p/pubsub/tracer/1.0.0); batches of
                  >= MIN_BATCH events, or whatever is pending at flush time

All sinks share the reference's lossy buffering contract: events beyond the
in-flight buffer cap (64Ki, tracer.go:23-24) are dropped rather than
blocking the protocol loop. Here writes happen on the caller's thread at
drain granularity (the vectorized loop already batches thousands of events
per round), so the cap bounds memory between flushes.

The same sinks as the JAX package's ``trace/sinks.py``: for the same events
each writes the same bytes.
"""

from __future__ import annotations

import io
import zlib
from typing import Callable, Iterable, Iterator

from google.protobuf import json_format

from ..pb import trace_pb2
from ..wire import framing

TRACE_BUFFER_CAP = 1 << 16   # events held before the sink starts dropping
MIN_REMOTE_BATCH = 16        # tracer.go: batch when >=16 pending
_GZIP_WBITS = 31             # zlib window-bits selector for gzip framing


class Tracer:
    """Base sink: bounded pending buffer + drop counter."""

    def __init__(self, buffer_cap: int = TRACE_BUFFER_CAP):
        self._pending: list[trace_pb2.TraceEvent] = []
        self._cap = buffer_cap
        self.dropped = 0
        self.closed = False

    def trace(self, ev: trace_pb2.TraceEvent) -> None:
        if self.closed:
            return
        if len(self._pending) >= self._cap:
            self.dropped += 1
            return
        self._pending.append(ev)

    def trace_many(self, evs: Iterable[trace_pb2.TraceEvent]) -> None:
        for ev in evs:
            self.trace(ev)

    def flush(self) -> None:
        pending, self._pending = self._pending, []
        if pending:
            self._write(pending)

    def close(self) -> None:
        if not self.closed:
            self.flush()
            self._close()
            self.closed = True

    # subclass hooks
    def _write(self, evs: list[trace_pb2.TraceEvent]) -> None:
        raise NotImplementedError

    def _close(self) -> None:
        pass


class JSONTracer(Tracer):
    """ndjson sink (tracer.go:79-129)."""

    def __init__(self, path: str, **kw):
        super().__init__(**kw)
        self._f = open(path, "a", encoding="utf-8")

    def _write(self, evs):
        for ev in evs:
            self._f.write(json_format.MessageToJson(ev, indent=None))
            self._f.write("\n")
        self._f.flush()

    def _close(self):
        self._f.close()


class PBTracer(Tracer):
    """Varint-delimited protobuf file sink (tracer.go:132-181), written by
    the Python framing path. The JAX package's native C++ writer
    (``use_native=True`` there) writes byte-identical files; the port has
    no native runtime yet (ROADMAP §1, item 8), so ``use_native`` must be
    False or None."""

    def __init__(self, path: str, use_native: bool | None = None, **kw):
        if use_native:
            raise ValueError(
                "PBTracer(use_native=True): the port has no native trace writer "
                "yet (ROADMAP §1, item 8); the Python framing path writes the "
                "same bytes — pass use_native=False or None")
        super().__init__(**kw)
        self._f = open(path, "ab")

    def _write(self, evs):
        for ev in evs:
            framing.write_delimited(self._f, ev)
        self._f.flush()

    def _close(self):
        self._f.close()


class _CollectorStream:
    """One dialed collector stream: a persistent gzip stream into which
    delimited TraceEventBatch frames are written, sync-flushed after each
    batch (tracer.go:212-213 gzip.NewWriter once per stream; :239-249
    WriteMsg + Flush per batch). The reference's collector therefore sees
    one gzip member per connection, incrementally decompressible — not one
    member per batch."""

    def __init__(self, send: Callable[[bytes], None]):
        self._send = send
        self._z = zlib.compressobj(6, zlib.DEFLATED, _GZIP_WBITS)

    def write_batch(self, payload: bytes) -> None:
        # may raise — the caller owns failure handling (batch loss + redial)
        self._send(self._z.compress(payload) + self._z.flush(zlib.Z_SYNC_FLUSH))

    def close(self) -> None:
        # clean shutdown finishes the gzip member (tracer.go:261 gzipW.Close);
        # a reset connection just abandons it (tracer.go:259 s.Reset)
        try:
            self._send(self._z.flush(zlib.Z_FINISH))
        except Exception:
            pass


class RemoteTracer(Tracer):
    """Collector-stream sink (tracer.go:186-303).

    Connection semantics modeled from the reference writer loop
    (tracer.go:201-301):

      * `connect()` dials the collector and returns a byte-sink callable;
        it raises on dial failure. Dialing never gives up until close —
        the reference retries every minute (tracer.go:280-301); here a
        failed dial retries after `redial_backoff` further flush attempts
        (wall-clock has no meaning in the simulated loop).
      * While disconnected, events keep accumulating in the lossy pending
        buffer (cap 64Ki, then dropped — tracer.go:23-24,195 lossy).
      * Each connection carries ONE persistent gzip stream; batches are
        sync-flushed into it (_CollectorStream). A reconnect starts a
        fresh gzip stream (tracer.go:275 gzipW.Reset).
      * A batch whose write fails is LOST — the reference nils the buffer
        whether or not the write succeeded (tracer.go:251-255) — and the
        stream is reset + redialed (tracer.go:267-276).

    Counters: `dials`, `dial_failures`, `write_failures`, `lost_events`
    (failed-batch losses) and the inherited `dropped` (buffer-cap losses).

    Backward-compatible: passing an infallible `send` callable as the
    first argument models an always-up collector."""

    def __init__(self, send: Callable[[bytes], None] | None = None,
                 min_batch: int = MIN_REMOTE_BATCH, *,
                 connect: Callable[[], Callable[[bytes], None]] | None = None,
                 redial_backoff: int = 1, **kw):
        super().__init__(**kw)
        if (send is None) == (connect is None):
            raise ValueError("exactly one of send / connect is required")
        self._connect = connect if connect is not None else (lambda: send)
        self._min_batch = min_batch
        self._redial_backoff = redial_backoff
        self._stream: _CollectorStream | None = None
        self._backoff_left = 0
        self.dials = 0
        self.dial_failures = 0
        self.write_failures = 0
        self.lost_events = 0

    def trace(self, ev):
        if self.closed:
            return
        super().trace(ev)
        if len(self._pending) >= self._min_batch:
            self.flush()

    # -- connection management -------------------------------------------
    def _try_dial(self) -> bool:
        if self._stream is not None:
            return True
        if self._backoff_left > 0:
            self._backoff_left -= 1
            return False
        self.dials += 1
        try:
            self._stream = _CollectorStream(self._connect())
            return True
        except Exception:
            self.dial_failures += 1
            self._backoff_left = self._redial_backoff
            return False

    def flush(self) -> None:
        # connection check FIRST: while the collector is down, events stay
        # buffered in place (lossy via the cap in trace()) — no per-event
        # buffer churn, and a flush attempt costs one backoff tick
        if not self._pending or not self._try_dial():
            return
        super().flush()

    def _write(self, evs):
        # flush() guarantees a live stream here
        batch = trace_pb2.TraceEventBatch()
        batch.batch.extend(evs)
        raw = io.BytesIO()
        framing.write_delimited(raw, batch)
        try:
            self._stream.write_batch(raw.getvalue())
        except Exception:
            # the batch is gone (tracer.go:251-255); reset + immediate redial
            self.write_failures += 1
            self.lost_events += len(evs)
            self._stream = None
            self._try_dial()

    def _close(self):
        if self._pending:
            # close while the collector is down: whatever the final flush
            # could not send is gone with the writer (tracer.go:257-264)
            self.lost_events += len(self._pending)
            self._pending = []
        if self._stream is not None:
            self._stream.close()
            self._stream = None


class MemoryCollector:
    """In-process collector endpoint for tests/tools — the counterpart of
    the reference's mockRemoteTracer (trace_test.go:266-300). Accumulates
    the connection's byte stream and decodes it incrementally; failure
    injection knobs simulate collector downtime."""

    def __init__(self):
        self.connections = 0
        self.chunks: list[bytes] = []
        self._streams: list[bytearray] = []
        self.fail_dials = 0       # next N connect() calls raise
        self.fail_writes = 0      # next N send() calls raise
        self._down = False

    # failure injection
    def go_down(self) -> None:
        self._down = True

    def go_up(self) -> None:
        self._down = False

    def connect(self) -> Callable[[bytes], None]:
        # downtime does not consume the injected-failure budget — a
        # fail_dials scheduled for after go_up() still fires
        if self._down:
            raise ConnectionError("collector down")
        if self.fail_dials > 0:
            self.fail_dials -= 1
            raise ConnectionError("collector unavailable")
        self.connections += 1
        buf = bytearray()
        self._streams.append(buf)

        def send(data: bytes) -> None:
            if self._down:
                raise ConnectionError("collector down")
            if self.fail_writes > 0:
                self.fail_writes -= 1
                raise ConnectionError("collector stream reset")
            buf.extend(data)
            self.chunks.append(data)

        return send

    def events(self) -> list[trace_pb2.TraceEvent]:
        """Decode every connection's (possibly unfinished) gzip stream."""
        out: list[trace_pb2.TraceEvent] = []
        for buf in self._streams:
            out.extend(decode_remote_stream(bytes(buf)))
        return out


def read_json_trace(path: str) -> Iterator[trace_pb2.TraceEvent]:
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json_format.Parse(line, trace_pb2.TraceEvent())


def read_pb_trace(path: str) -> Iterator[trace_pb2.TraceEvent]:
    with open(path, "rb") as f:
        yield from framing.read_delimited_messages(f, trace_pb2.TraceEvent)


def decode_remote_stream(data: bytes) -> list[trace_pb2.TraceEvent]:
    """Decode a collector-side byte stream back into events.

    Handles one or more concatenated gzip members — a reconnect starts a
    fresh member — where any member may be unfinished (sync-flushed but
    never Z_FINISHed: a live connection's tail, or a member abandoned by a
    stream reset). An abandoned member followed by another member is
    decoded up to its last complete sync-flush block; a handful of bytes
    at the splice point can be unparseable and are skipped, like a
    collector reading a reset stream loses its undelivered tail."""
    data = bytes(data)
    n = len(data)
    # decoded bytes are parsed per SEGMENT: a truncated (abandoned) member
    # ends its segment, so the next member's records never get misread as
    # the continuation of a half-record
    segments: list[bytearray] = [bytearray()]
    pos = 0
    while pos < n:
        if data[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError(
                "not at a gzip member boundary — individual mid-connection "
                "chunks are sync-flushed continuations of one per-connection "
                "gzip stream and cannot be decoded alone; concatenate the "
                "connection's chunks and decode the whole stream"
            )
        z = zlib.decompressobj(_GZIP_WBITS)
        cur = pos
        member = bytearray()
        spliced = False
        try:
            # happy path: one decompress call over the whole remainder
            member.extend(z.decompress(data[pos:]))
            cur = n - len(z.unused_data)
        except zlib.error:
            # an abandoned member spliced against the next member's
            # header. Replay from the member start in stepped chunks with
            # checkpointing, dropping to bytewise on the failing step, so
            # every output byte before the corrupt point is salvaged —
            # O(member) work on this rare path only, zero on the happy one
            z = zlib.decompressobj(_GZIP_WBITS)
            member = bytearray()
            fail_at = n
            while cur < n:
                step = min(512, n - cur)
                snap = z.copy()
                try:
                    member.extend(z.decompress(data[cur:cur + step]))
                    cur += step
                except zlib.error:
                    z = snap
                    fail_at = cur + step
                    for b in range(cur, cur + step):
                        try:
                            member.extend(z.decompress(data[b:b + 1]))
                        except zlib.error:
                            fail_at = b
                            break
                    break
                if z.unused_data:
                    cur -= len(z.unused_data)
                    break
            spliced = True
        if spliced:
            # close the segment (next member's records parse from a fresh
            # boundary) and resume at the next plausible member header near
            # the failure point (the next member's 10-byte gzip header sits
            # at most a few bytes before where the error surfaced). A bare
            # \x1f\x8b match inside compressed data is a false positive
            # that would swallow the real header behind it, so candidates
            # are screened: method byte must be 8 (deflate) and the three
            # reserved FLG bits zero (RFC 1952 §2.3.1) — decode failure on
            # a survivor still just fails and re-scans from past it
            segments[-1].extend(member)
            segments.append(bytearray())
            nxt = data.find(b"\x1f\x8b", max(pos + 2, fail_at - 18))
            while nxt >= 0 and nxt + 3 < n and not (
                data[nxt + 2] == 0x08 and (data[nxt + 3] & 0xE0) == 0
            ):
                nxt = data.find(b"\x1f\x8b", nxt + 2)
            if nxt < 0:
                break
            pos = nxt
        else:
            try:
                member.extend(z.flush())
            except zlib.error:
                pass
            segments[-1].extend(member)
            pos = cur
            if pos >= n:
                break
    out: list[trace_pb2.TraceEvent] = []
    for seg in segments:
        stream = io.BytesIO(bytes(seg))
        try:
            for batch in framing.read_delimited_messages(
                stream, trace_pb2.TraceEventBatch
            ):
                out.extend(batch.batch)
        except (EOFError, ValueError):
            # a salvaged abandoned member can end mid-record; everything
            # before the truncation parsed cleanly and is kept
            pass
    return out

