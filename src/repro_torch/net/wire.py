"""Length-prefixed binary frame protocol over asyncio sockets.

The cross-host serving tier needs to move two very different things over
one connection: small control messages (submit acks, heartbeat gauges,
drain reports) and large dense ndarray planes (operands in, iterates out).
A text protocol would re-encode megabytes of float32; a pickle protocol
would execute remote bytes.  This module does neither — a frame is:

  ``u32 magic | u32 header_len | u64 body_len | header JSON | raw planes``

The JSON header carries the op name, the request id, and — under the
reserved ``_planes`` key — one ``[dtype_str, shape]`` tag per ndarray
plane; the planes themselves follow as raw little-endian bytes in tag
order, sliced back into (read-only) numpy arrays with ``np.frombuffer`` on
receipt.  No third-party serializer (msgpack, protobuf, pickle) is
involved: JSON is stdlib, the planes are the bytes the engine already has.
Everything is validated before allocation: magic, header/body length
bounds, header-inside-body, JSON shape, and that the tagged plane sizes
sum exactly to the payload — a truncated or malformed frame raises
:class:`WireError` instead of yielding garbage arrays.

On top of the framing live the three mechanisms every RPC caller here
needs:

* **request/response matching** — :class:`WireClient` multiplexes
  concurrent calls over one connection (``_id`` in the header; a single
  reader task resolves the matching future), so the front door's
  heartbeat, deliver stream, and submits share a socket without
  head-of-line blocking on the server's handler latency.
* **deadlines, retry, exponential backoff** — every ``call`` carries a
  deadline; expiry (or a connection error) fails the attempt, the client
  backs off exponentially (doubling from ``backoff0``, capped) and
  retries up to ``retries`` times before raising.  The ``trace`` hook
  records the (expired → backoff → retry) event ordering — what the
  protocol tests pin down.
* **heartbeats** — :class:`Heartbeater` pings a peer on a fixed cadence
  and calls ``on_loss`` after ``miss_limit`` consecutive failures; the
  ping reply's header is the carrier for the serialized
  :class:`~repro_torch.io.storage.IOStats` / backlog gauges the front door's
  routing and budget arbitration feed on.
"""
from __future__ import annotations

import asyncio
import hashlib
import hmac
import itertools
import json
import struct
from typing import (Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

MAGIC = 0x53_45_4D_52            # "SEMR"
_PREFIX = struct.Struct("<IIQ")  # magic, header_len, body_len
MAX_HEADER = 1 << 24             # 16 MB of JSON is already a bug
MAX_BODY = 1 << 34               # 16 GB per frame; beyond it, stream planes

# Optional shared-secret handshake: a connection to an authenticated server
# must open with this fixed-size preamble — a distinct magic plus the
# sha256 of the shared token — before any frame.  The server verifies it
# with a constant-time compare and hangs up on mismatch *before* any frame
# (and hence any JSON) is parsed; a tokenless client's first frame starts
# with MAGIC, which fails the preamble check the same way.  Both sides must
# agree on whether a token is in use.
AUTH_MAGIC = 0x53_45_4D_41       # "SEMA"
_AUTH = struct.Struct("<I32s")   # auth magic, sha256(token)
# Seconds WireServer.close gives its connections to end, and then the
# server to close, before it aborts what is still open.
CLOSE_TIMEOUT = 2.0


def _token_digest(token: str) -> bytes:
    return hashlib.sha256(token.encode()).digest()

Frame = Tuple[dict, List[np.ndarray]]


class WireError(ConnectionError):
    """A malformed, truncated, or over-limit frame (or a dead peer).

    Subclasses ``ConnectionError`` deliberately: a peer speaking garbage is
    handled like a peer that hung up — the connection is abandoned and the
    caller's retry/failover policy takes over."""


class DeadlineExpired(WireError):
    """A request's deadline elapsed before its response arrived."""


def encode_frame(header: dict, planes: Sequence[np.ndarray] = ()) -> bytes:
    """Serialize one frame.  ``header`` must be JSON-safe; ``_planes`` is
    reserved (it carries the dtype/shape tags)."""
    planes = [np.ascontiguousarray(p) for p in planes]
    header = dict(header)
    header["_planes"] = [[p.dtype.str, list(p.shape)] for p in planes]
    hdr = json.dumps(header, separators=(",", ":")).encode()
    payload = b"".join(p.tobytes() for p in planes)
    if len(hdr) > MAX_HEADER:
        raise WireError(f"header too large: {len(hdr)} bytes")
    body_len = len(hdr) + len(payload)
    if body_len > MAX_BODY:
        raise WireError(f"frame too large: {body_len} bytes")
    return _PREFIX.pack(MAGIC, len(hdr), body_len) + hdr + payload


def _decode_planes(header: dict, payload: bytes) -> List[np.ndarray]:
    tags = header.pop("_planes", [])
    if not isinstance(tags, list):
        raise WireError("malformed frame: _planes is not a list")
    planes: List[np.ndarray] = []
    off = 0
    for tag in tags:
        try:
            dtype = np.dtype(tag[0])
            shape = tuple(int(d) for d in tag[1])
        except (TypeError, ValueError, IndexError) as e:
            raise WireError(f"malformed plane tag {tag!r}") from e
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if off + nbytes > len(payload):
            raise WireError(
                f"truncated frame: plane {tag!r} wants {nbytes} bytes, "
                f"{len(payload) - off} remain")
        planes.append(np.frombuffer(payload, dtype, count=int(
            np.prod(shape, dtype=np.int64)), offset=off).reshape(shape))
        off += nbytes
    if off != len(payload):
        raise WireError(
            f"malformed frame: {len(payload) - off} trailing payload bytes")
    return planes


def decode_frame(buf: bytes) -> Frame:
    """Parse one complete frame from ``buf`` (must be exactly one frame)."""
    if len(buf) < _PREFIX.size:
        raise WireError(f"truncated frame: {len(buf)} < prefix size")
    magic, header_len, body_len = _PREFIX.unpack_from(buf)
    if magic != MAGIC:
        raise WireError(f"bad magic 0x{magic:08x}")
    if header_len > MAX_HEADER or body_len > MAX_BODY \
            or header_len > body_len:
        raise WireError(
            f"bad frame lengths: header {header_len}, body {body_len}")
    if len(buf) != _PREFIX.size + body_len:
        raise WireError(
            f"truncated frame: body is {len(buf) - _PREFIX.size} of "
            f"{body_len} bytes")
    body = buf[_PREFIX.size:]
    try:
        header = json.loads(body[:header_len].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError("malformed frame header (not JSON)") from e
    if not isinstance(header, dict):
        raise WireError("malformed frame header (not an object)")
    return header, _decode_planes(header, body[header_len:])


async def read_frame(reader: asyncio.StreamReader) -> Frame:
    """Read exactly one frame from an asyncio stream.  EOF mid-frame is a
    :class:`WireError` (truncation), EOF *between* frames raises
    ``asyncio.IncompleteReadError`` with nothing read — the clean-close
    signal connection loops key on."""
    try:
        prefix = await reader.readexactly(_PREFIX.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            raise                      # clean close between frames
        raise WireError("truncated frame prefix") from e
    magic, header_len, body_len = _PREFIX.unpack(prefix)
    if magic != MAGIC:
        raise WireError(f"bad magic 0x{magic:08x}")
    if header_len > MAX_HEADER or body_len > MAX_BODY \
            or header_len > body_len:
        raise WireError(
            f"bad frame lengths: header {header_len}, body {body_len}")
    try:
        body = await reader.readexactly(body_len)
    except asyncio.IncompleteReadError as e:
        raise WireError(
            f"truncated frame: got {len(e.partial)} of {body_len} "
            f"body bytes") from e
    return decode_frame(prefix + body)


async def write_frame(writer: asyncio.StreamWriter, header: dict,
                      planes: Sequence[np.ndarray] = ()) -> None:
    writer.write(encode_frame(header, planes))
    await writer.drain()


class WireClient:
    """One connection to a peer, multiplexing concurrent requests.

    ``call`` is the whole client API: send ``op`` with a header and
    ndarray planes, await the matching response.  Per-request deadline;
    on expiry or connection failure the attempt is abandoned, the client
    sleeps an exponentially growing backoff, reconnects if needed, and
    retries — after ``retries`` extra attempts the last error is raised.
    ``trace(event, detail)`` (optional) observes the retry machinery:
    ``("expired", attempt) → ("backoff", seconds) → ("retry", attempt)``
    in that order, one triple per failed attempt.

    All coroutines must run on the event loop that ``connect`` ran on.
    """

    def __init__(self, host: str, port: int, *, deadline: float = 5.0,
                 retries: int = 2, backoff0: float = 0.05,
                 backoff_cap: float = 2.0,
                 trace: Optional[Callable[[str, object], None]] = None,
                 auth_token: Optional[str] = None):
        self.host, self.port = host, port
        self.deadline = deadline
        self.retries = retries
        self.backoff0, self.backoff_cap = backoff0, backoff_cap
        self.auth_token = auth_token
        self.trace = trace or (lambda event, detail: None)
        self._ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._wlock = asyncio.Lock()

    @property
    def connected(self) -> bool:
        return self._writer is not None

    async def connect(self) -> None:
        if self._writer is not None:
            return
        reader, writer = await asyncio.open_connection(self.host, self.port)
        if self.auth_token is not None:
            writer.write(_AUTH.pack(AUTH_MAGIC,
                                    _token_digest(self.auth_token)))
            await writer.drain()
        self._writer = writer
        self._reader_task = asyncio.ensure_future(self._read_loop(reader))

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                header, planes = await read_frame(reader)
                fut = self._pending.pop(int(header.get("_id", -1)), None)
                if fut is not None and not fut.done():
                    fut.set_result((header, planes))
        except (asyncio.IncompleteReadError, WireError, OSError) as e:
            self._drop_connection(e)

    def _drop_connection(self, exc: Exception) -> None:
        """Fail every in-flight request and forget the writer: the next
        ``call`` attempt reconnects from scratch."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(WireError(f"connection lost: {exc!r}"))

    async def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            self._reader_task = None
        self._drop_connection(ConnectionError("client closed"))

    async def _attempt(self, op: str, header: dict,
                       planes: Sequence[np.ndarray],
                       deadline: float) -> Frame:
        await self.connect()
        rid = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        msg = dict(header)
        msg["_op"] = op
        msg["_id"] = rid
        try:
            async with self._wlock:   # interleaved writes corrupt the stream
                await write_frame(self._writer, msg, planes)
            return await asyncio.wait_for(fut, deadline)
        finally:
            self._pending.pop(rid, None)

    async def call(self, op: str, header: Optional[dict] = None,
                   planes: Sequence[np.ndarray] = (),
                   deadline: Optional[float] = None) -> Frame:
        """Request/response with deadline + exponential-backoff retry."""
        deadline = self.deadline if deadline is None else deadline
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                resp, rplanes = await self._attempt(
                    op, header or {}, planes, deadline)
            except asyncio.TimeoutError:
                last = DeadlineExpired(
                    f"{op} to {self.host}:{self.port} exceeded "
                    f"{deadline}s (attempt {attempt + 1})")
                self.trace("expired", attempt)
            except (WireError, OSError) as e:
                last = e
                self.trace("failed", attempt)
                self._drop_connection(e)
            else:
                if resp.get("ok", True) is False:
                    # application error: the peer is alive and answered —
                    # retrying would repeat the same rejection
                    raise RemoteError(resp.get("error", "remote error"))
                return resp, rplanes
            if attempt < self.retries:
                backoff = min(self.backoff0 * (2 ** attempt),
                              self.backoff_cap)
                self.trace("backoff", backoff)
                await asyncio.sleep(backoff)
                self.trace("retry", attempt + 1)
        raise last


class RemoteError(RuntimeError):
    """The peer processed the request and reported a failure (``ok: false``
    in the response header) — distinct from transport trouble, which is
    :class:`WireError` and retried."""


class WireServer:
    """Accept loop + per-connection frame dispatch around an async handler
    ``handler(op, header, planes) -> (header, planes)``.

    Each request is served as its own task, so a slow handler (a drain, a
    long-poll deliver) never blocks the connection's heartbeats.  Handler
    exceptions become ``ok: false`` responses; a malformed frame kills just
    that connection.

    ``close`` ends the live connections itself: since Python 3.12.1
    ``asyncio.Server.wait_closed`` waits for every open connection, and a
    peer that keeps its socket open (a front door's heartbeat) would hold
    it forever.  So the server tracks each connection's writer and serving
    task, and ``close`` stops accepting, closes the writers, cancels the
    connections' tasks (which cancel their requests), and only then waits,
    under a bound."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0,
                 *, auth_token: Optional[str] = None):
        self.handler = handler
        self.host, self.port = host, port
        self.auth_token = auth_token
        self.rejected_connections = 0
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: Set[asyncio.StreamWriter] = set()
        self._conn_tasks: Set[asyncio.Task] = set()

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def close(self) -> None:
        """Stop accepting, end every live connection, then wait for the
        server to close — at most ``CLOSE_TIMEOUT`` seconds for each step,
        after which the transports still open are aborted."""
        if self._server is None:
            return
        server, self._server = self._server, None
        server.close()
        writers = list(self._writers)
        for w in writers:
            w.close()
        tasks = list(self._conn_tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.wait(tasks, timeout=CLOSE_TIMEOUT)
        try:
            await asyncio.wait_for(server.wait_closed(), CLOSE_TIMEOUT)
        except asyncio.TimeoutError:
            # a transport still flushing to a peer that stopped reading
            for w in writers:
                w.transport.abort()

    async def _authenticate(self, reader: asyncio.StreamReader) -> bool:
        """Consume and verify the connection preamble.  Runs before any
        frame is read, so an unauthenticated peer is rejected before a
        single byte of its JSON is parsed."""
        try:
            preamble = await reader.readexactly(_AUTH.size)
        except (asyncio.IncompleteReadError, OSError):
            return False
        magic, digest = _AUTH.unpack(preamble)
        return magic == AUTH_MAGIC and hmac.compare_digest(
            digest, _token_digest(self.auth_token))

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        me = asyncio.current_task()
        self._writers.add(writer)
        self._conn_tasks.add(me)
        wlock = asyncio.Lock()
        tasks = set()
        try:
            if self.auth_token is not None:
                if not await self._authenticate(reader):
                    self.rejected_connections += 1
                    return
            while True:
                header, planes = await read_frame(reader)
                t = asyncio.ensure_future(
                    self._serve_request(header, planes, writer, wlock))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        except (asyncio.IncompleteReadError, WireError, OSError):
            pass
        finally:
            for t in tasks:
                t.cancel()
            writer.close()
            self._conn_tasks.discard(me)
            self._writers.discard(writer)

    async def _serve_request(self, header: dict, planes, writer,
                             wlock: asyncio.Lock) -> None:
        rid = header.pop("_id", None)
        op = header.pop("_op", "")
        try:
            resp, rplanes = await self.handler(op, header, planes)
            resp = dict(resp)
            resp.setdefault("ok", True)
        except Exception as e:  # noqa: BLE001 — reported to the peer
            resp, rplanes = {"ok": False, "error": repr(e)}, []
        resp["_id"] = rid
        try:
            async with wlock:
                await write_frame(writer, resp, rplanes)
        except (OSError, WireError):
            pass                      # peer gone; connection loop will end


class Heartbeater:
    """Ping a peer on a fixed cadence; declare it lost after
    ``miss_limit`` consecutive failures.

    ``on_beat(header)`` receives every successful ping reply — the carrier
    for the peer's serialized gauges (IOStats, backlog, pass-time EWMA,
    and the versioned-graph pair ``version`` / ``delta_nnz`` the front
    door folds into ``version_skew``).
    ``on_loss(exc)`` fires once, after which the task exits; the owner
    decides what eviction means.  Heartbeat pings use a single attempt
    (``retries=0`` semantics) — the miss counter IS the retry policy, and
    a backoff here would stretch the detection latency the front door's
    failover is specified in."""

    def __init__(self, client: WireClient, *, interval: float = 0.2,
                 miss_limit: int = 3, deadline: Optional[float] = None,
                 on_beat=None, on_loss=None):
        self.client = client
        self.interval = interval
        self.miss_limit = miss_limit
        self.deadline = deadline if deadline is not None else 2 * interval
        self.on_beat = on_beat or (lambda header: None)
        self.on_loss = on_loss or (lambda exc: None)
        self.misses = 0
        self.beats = 0

    async def run(self) -> None:
        while True:
            try:
                saved = self.client.retries
                self.client.retries = 0
                try:
                    header, _ = await self.client.call(
                        "ping", deadline=self.deadline)
                finally:
                    self.client.retries = saved
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a miss, not a crash
                self.misses += 1
                if self.misses >= self.miss_limit:
                    self.on_loss(e)
                    return
            else:
                self.misses = 0
                self.beats += 1
                self.on_beat(header)
            await asyncio.sleep(self.interval)
