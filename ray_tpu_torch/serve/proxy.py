"""HTTP ingress proxy — an HTTP/1.1 server actor routing to deployments.

Role-equivalent to the reference's HTTPProxy (ref:
serve/_private/proxy.py:763 — uvicorn ASGI per node).  The JAX package
runs aiohttp in a dedicated actor; the port serves the same protocol
over the standard library's ``asyncio`` streams, so a machine without
aiohttp (and its multidict/yarl/frozenlist stack) still has an ingress.
Routes come from the controller's long-poll push (``routes.py``).  JSON
in / JSON out: the request body (or the query string) parses to the
handler's argument; responses serialize back.  Generator deployments
answer with chunked NDJSON.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from http import HTTPStatus
from typing import Any, Dict, Optional
from urllib.parse import parse_qsl, unquote, urlsplit

REQUEST_ID_HEADER = "X-RT-Request-Id"

# aiohttp's defaults, kept so both ingresses refuse the same requests.
_MAX_BODY = 1024 ** 2
_MAX_HEAD = 8190 * 4
_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"


def status_class(status: int) -> str:
    """Map an HTTP status to the SLO status class: 429 (admission
    shed) and 504 (deadline exceeded) get their own classes — they
    feed the shed/deadline counters into error-budget math —
    everything else buckets by hundreds (2xx/4xx/5xx)."""
    if status == 429:
        return "shed"
    if status == 504:
        return "deadline"
    return f"{int(status) // 100}xx"


def clean_request_id(raw: Optional[str]) -> Optional[str]:
    """Sanitize a client-supplied request id: printable, bounded,
    no whitespace — a hostile header must not corrupt span tags or
    log lines.  None/empty returns None (caller mints one)."""
    if not raw:
        return None
    rid = "".join(c for c in str(raw)[:64]
                  if c.isalnum() or c in "-_.:")
    return rid or None


class _IngressTelemetry:
    """Per-proxy request metrics: latency histogram by deployment +
    outcome + status class, a per-status-class request counter (the
    availability SLO's input), TTFT observations, and an in-flight
    depth gauge (the proxy-side queue depth — requests accepted but
    not yet answered)."""

    def __init__(self, proto: str = "http"):
        self._lock = threading.Lock()
        self._inflight = 0
        self._proto = proto

    def begin(self) -> float:
        with self._lock:
            self._inflight += 1
            # Gauge set stays under the lock: interleaved begin/end
            # pairs must not publish a stale depth out of order.
            self._set_inflight(self._inflight)
        return time.perf_counter()

    def end(self, t0: float, deployment: str, outcome: str,
            sclass: str = "?", request_id: Optional[str] = None
            ) -> None:
        with self._lock:
            self._inflight -= 1
            self._set_inflight(self._inflight)
        elapsed = time.perf_counter() - t0
        try:
            from ..util.metrics import Counter, Histogram

            Histogram("rt_serve_request_seconds",
                      "Ingress request latency.",
                      tag_keys=("deployment", "outcome",
                                "status_class")).observe(
                elapsed,
                tags={"deployment": deployment, "outcome": outcome,
                      "status_class": sclass})
            Counter("rt_serve_requests_total",
                    "Ingress requests by status class (the "
                    "availability SLO's error-budget input).",
                    tag_keys=("deployment", "status_class")).inc(
                tags={"deployment": deployment,
                      "status_class": sclass})
        except Exception:
            pass
        try:
            from ..util import spans

            wall_end = time.time()
            tags = {"deployment": deployment, "outcome": outcome,
                    "status_class": sclass, "proto": self._proto}
            if request_id:
                tags["request_id"] = request_id
            spans.record_span("ingress", wall_end - elapsed,
                              wall_end, cat="serve", tags=tags)
        except Exception:
            pass

    def observe_ttft(self, deployment: str, seconds: float) -> None:
        """End-to-end ingress-to-first-token (streaming requests)."""
        try:
            from ..util.metrics import Histogram

            Histogram("rt_serve_ttft_seconds",
                      "Ingress-to-first-token latency (streaming "
                      "requests).",
                      tag_keys=("deployment",)).observe(
                seconds, tags={"deployment": deployment})
        except Exception:
            pass

    @staticmethod
    def observe_phase(phase: str, seconds: float) -> None:
        """One TTFT phase observation (proxy parse/route/dispatch
        overhead here; admission queue at the handle's gate; engine
        waiting + prefill inside the generation engine)."""
        try:
            from ..util.metrics import observe_ttft_phase

            observe_ttft_phase(phase, seconds)
        except Exception:
            pass

    def _set_inflight(self, depth: int) -> None:
        try:
            from ..util.metrics import Gauge

            Gauge("rt_serve_inflight",
                  "Requests accepted but not yet answered.").set(
                float(depth))
        except Exception:
            pass


class _BadRequest(Exception):
    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status


class _Request:
    """One parsed HTTP/1.1 request head; the body is read on demand."""

    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str]):
        self.method = method
        self.version = version
        self.headers = headers          # lower-cased names
        parts = urlsplit(target)
        self.path = unquote(parts.path) or "/"
        self.query = parts.query
        self.body = b""

    def header(self, name: str) -> Optional[str]:
        return self.headers.get(name.lower())

    @property
    def chunked(self) -> bool:
        return "chunked" in (self.header("transfer-encoding") or "")

    @property
    def keep_alive(self) -> bool:
        conn = (self.header("connection") or "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


class _Response:
    """A complete (non-streaming) response."""

    def __init__(self, status: int, body: bytes,
                 content_type: str = _JSON):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers: Dict[str, str] = {}
        self.prepared = False


def _json_response(data: Any, status: int = 200) -> _Response:
    return _Response(status, json.dumps(data).encode())


def _head(status: int, headers: Dict[str, str]) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[_Request]:
    """Parse one request head; None on a clean EOF between requests."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise _BadRequest(400, "Bad Request")
    except asyncio.LimitOverrunError:
        raise _BadRequest(431, "Request Header Fields Too Large")
    lines = raw.decode("latin-1").split("\r\n")
    try:
        method, target, version = lines[0].split(" ", 2)
    except ValueError:
        raise _BadRequest(400, "Bad Request")
    if not version.startswith("HTTP/1."):
        raise _BadRequest(505, "HTTP Version Not Supported")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise _BadRequest(400, "Bad Request")
        headers[name.strip().lower()] = value.strip()
    return _Request(method, target, version, headers)


async def _read_body(req: _Request, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
    if (req.header("expect") or "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if req.chunked:
        parts, total = [], 0
        while True:
            size_line = await reader.readuntil(b"\r\n")
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise _BadRequest(400, "Bad Request")
            if size == 0:
                # Trailers (usually none) end with an empty line.
                while (await reader.readuntil(b"\r\n")) != b"\r\n":
                    pass
                break
            total += size
            if total > _MAX_BODY:
                raise _BadRequest(413, "Request Entity Too Large")
            parts.append(await reader.readexactly(size))
            await reader.readexactly(2)
        req.body = b"".join(parts)
        return
    try:
        length = int(req.header("content-length") or 0)
    except ValueError:
        raise _BadRequest(400, "Bad Request")
    if length > _MAX_BODY:
        raise _BadRequest(413, "Request Entity Too Large")
    if length:
        req.body = await reader.readexactly(length)


class _Stream:
    """A chunked (``Transfer-Encoding: chunked``) streaming response."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, keep_alive: bool):
        self._reader = reader
        self._writer = writer
        self._keep_alive = keep_alive
        self.status = 200
        self.prepared = False

    def closed(self) -> bool:
        """The client closed its socket: EOF on the reader (nothing
        pipelined behind it) or a transport already shut."""
        return (self._reader.at_eof()
                or self._writer.transport.is_closing())

    async def prepare(self, headers: Dict[str, str]) -> None:
        self._writer.write(_head(200, {
            **headers, "Transfer-Encoding": "chunked",
            "Connection": "keep-alive" if self._keep_alive
            else "close"}))
        self.prepared = True
        await self._drain()

    async def write(self, data: bytes) -> None:
        self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._drain()

    async def write_eof(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._drain()

    async def _drain(self) -> None:
        # A peer that closed its socket shows up as EOF on the reader,
        # a closing transport or a failed drain.
        if self.closed():
            raise ConnectionResetError("client disconnected")
        await self._writer.drain()


class HTTPProxy:
    """Actor: runs an asyncio HTTP/1.1 server thread, proxies to
    handles."""

    def __init__(self, port: int = 0):
        from concurrent.futures import ThreadPoolExecutor

        from .routes import RouteTable

        self._routes: Dict[str, Any] = {}
        self._route_table = RouteTable()
        self._port = port
        self._actual_port = None
        self._ready = threading.Event()
        self._telemetry = _IngressTelemetry()
        # Dedicated executor for the blocking handle calls: the
        # default loop executor sizes to ~cpu+4 threads, which on a
        # small host caps concurrent in-flight requests BELOW the
        # admission gate's queue bound — overload would then pile up
        # invisibly in the executor instead of shedding with 429.
        self._executor = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="serve-proxy")
        from ..core.config import RuntimeConfig

        self._default_timeout = RuntimeConfig.from_env(
        ).serve_request_timeout_s
        self._thread = threading.Thread(target=self._run_server,
                                        daemon=True)
        self._thread.start()
        self._ready.wait(30)

    def port(self) -> int:
        self._ready.wait(30)
        return self._actual_port

    # ------------------------------------------------------------ server
    def _run_server(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        server = loop.run_until_complete(asyncio.start_server(
            self._connection, "0.0.0.0", self._port, limit=_MAX_HEAD))
        self._actual_port = server.sockets[0].getsockname()[1]
        self._ready.set()
        loop.run_forever()

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """One client connection: requests in order (HTTP/1.1
        keep-alive) until the client closes or asks to."""
        try:
            while True:
                try:
                    req = await _read_request(reader)
                    if req is None:
                        return
                    await _read_body(req, reader, writer)
                except _BadRequest as e:
                    writer.write(self._complete(
                        _Response(e.status, str(e).encode(), _TEXT),
                        keep_alive=False))
                    await writer.drain()
                    return
                resp = await self._handler(req, reader, writer)
                if resp is None or not req.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.CancelledError):
            return
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _complete(resp: _Response, keep_alive: bool) -> bytes:
        headers = {"Content-Type": resp.content_type,
                   "Content-Length": str(len(resp.body)),
                   **resp.headers,
                   "Connection": "keep-alive" if keep_alive else "close"}
        return _head(resp.status, headers) + resp.body

    async def _handler(self, req: _Request, reader, writer):
        """Telemetry and request-id wrapper around ``_handle``; writes a
        complete response (a stream writes itself).  Returns None when
        the connection is done."""
        from ..util import tracing

        # Honor the client's X-RT-Request-Id (sanitized) or mint
        # one; it is echoed on EVERY response — 2xx, 404, 429,
        # 504, and the stream's headers — so a client holding an
        # error body can hand support the exact id.
        rid = clean_request_id(req.header(REQUEST_ID_HEADER)) \
            or tracing.new_request_id()
        t0 = self._telemetry.begin()
        tel = {"deployment": "?"}
        outcome, sclass = "error", "5xx"
        try:
            try:
                stream = _Stream(reader, writer, req.keep_alive)
                resp = await self._handle(req, tel, rid, stream)
            except (ConnectionError, asyncio.CancelledError):
                raise
            except Exception:  # noqa: BLE001 — a server fault: 500
                resp = _Response(500, b"500 Internal Server Error\n\n"
                                 b"Server got itself in trouble", _TEXT)
                resp.headers[REQUEST_ID_HEADER] = rid
                writer.write(self._complete(resp, req.keep_alive))
                await writer.drain()
                return resp
            outcome = ("ok" if resp.status < 400
                       else f"http_{resp.status}")
            sclass = status_class(resp.status)
            if not resp.prepared:
                resp.headers[REQUEST_ID_HEADER] = rid
                writer.write(self._complete(resp, req.keep_alive))
                await writer.drain()
            return resp
        except (ConnectionError, asyncio.CancelledError):
            # The CLIENT went away: not a server failure — it
            # must not burn the availability error budget.
            outcome, sclass = "disconnect", "4xx"
            return None
        finally:
            self._telemetry.end(t0, tel["deployment"], outcome,
                                sclass, rid)

    # ---------------------------------------------------------- requests
    def _payload(self, req: _Request) -> Any:
        if req.body:
            text = req.body.decode()
            try:
                return json.loads(text)
            except ValueError:
                return text
        query: Dict[str, str] = {}
        for k, v in parse_qsl(req.query, keep_blank_values=True):
            query.setdefault(k, v)      # the first value of a key
        return query or None

    def _request_timeout(self, req: _Request) -> Optional[float]:
        """Per-request deadline override (X-RT-Timeout-S header);
        None falls through to ``serve_request_timeout_s``."""
        raw = req.header("X-RT-Timeout-S")
        if not raw:
            return None
        try:
            return max(0.0, float(raw))
        except ValueError:
            return None

    async def _handle(self, req: _Request, tel: Dict[str, str],
                      rid: str, stream: _Stream):
        from .controller import DeploymentHandle
        from .resilience import RequestTimeoutError

        t_ingress = time.perf_counter()
        target = self._route_table.resolve(req.path)
        tel["deployment"] = target or "?"
        if target is None:
            return _json_response({"error": f"no route for {req.path}"},
                                  status=404)
        payload = self._payload(req)
        handle = self._routes.get(target)
        if handle is None:
            handle = self._routes[target] = DeploymentHandle(target)
        timeout_s = self._request_timeout(req)
        # The effective deadline also bounds the EXECUTOR hop: a
        # request parked in the thread pool's internal queue has
        # not started its Deadline yet, so under saturation it
        # would otherwise wait unboundedly with no 429/504 —
        # asyncio.wait_for makes the client-side deadline hold no
        # matter where the request is stuck (+grace so an
        # in-flight call that is ABOUT to 504 itself wins the
        # race and returns the richer error).
        eff_timeout = (self._default_timeout if timeout_s is None
                       else timeout_s)
        loop = asyncio.get_running_loop()

        async def _bounded(fut):
            if eff_timeout and eff_timeout > 0:
                return await asyncio.wait_for(
                    fut, timeout=eff_timeout + 1.0)
            return await fut

        if self._route_table.is_streaming(target):
            return await self._handle_stream(
                handle, target, payload, timeout_s, eff_timeout, rid,
                stream, t_ingress, loop, _bounded)
        self._telemetry.observe_phase(
            "proxy", time.perf_counter() - t_ingress)
        call_fut = loop.run_in_executor(
            self._executor,
            lambda: handle.call(payload, timeout_s=timeout_s,
                                request_id=rid))
        try:
            result = await _bounded(call_fut)
        except asyncio.TimeoutError:
            return _json_response(
                {"error": repr(RequestTimeoutError(
                    target, eff_timeout))}, status=504)
        except Exception as e:  # noqa: BLE001
            return _json_response({"error": repr(e)},
                                  status=_error_status(e))
        if isinstance(result, (dict, list, str, int, float, bool,
                               type(None))):
            return _json_response({"result": result})
        return _json_response({"result": repr(result)})

    async def _handle_stream(self, handle, target: str, payload: Any,
                             timeout_s, eff_timeout, rid: str,
                             stream: _Stream, t_ingress: float, loop,
                             _bounded):
        """Generator deployment: chunked NDJSON written as the replica
        yields, carried by the core streaming-generator plane through
        the handle's RESILIENT stream — a stream that dies before its
        first frame is retried on another replica like a unary call,
        so the first-frame pull happens BEFORE the 200 goes out and
        pre-stream failures get real status codes."""
        from .resilience import RequestTimeoutError

        self._telemetry.observe_phase(
            "proxy", time.perf_counter() - t_ingress)
        it = handle.stream_timed(timeout_s, payload, request_id=rid)
        _END = object()

        def _next():
            try:
                return next(it)
            except StopIteration:
                return _END

        def _close_after(fut):
            # The generator may be mid-next() in the executor thread:
            # close() would raise "generator already executing",
            # silently leaking the replica-side stream.  Close when
            # the in-flight step returns.
            def _do_close(_f):
                try:
                    it.close()
                except Exception:
                    pass

            try:
                fut.add_done_callback(_do_close)
            except Exception:
                _do_close(None)

        async def _await_step(fut):
            # Wait for the next frame while watching the socket: a
            # client that closes it mid-wait is gone now, not at the
            # next write.
            while True:
                done, _ = await asyncio.wait({fut}, timeout=0.25)
                if done:
                    return fut.result()
                if stream.closed():
                    raise ConnectionResetError("client disconnected")

        step = loop.run_in_executor(self._executor, _next)
        try:
            first = await _bounded(_await_step(step))
        except asyncio.TimeoutError:
            _close_after(step)
            return _json_response(
                {"error": repr(RequestTimeoutError(
                    target, eff_timeout))}, status=504)
        except (ConnectionError, asyncio.CancelledError):
            _close_after(step)
            raise
        except Exception as e:  # noqa: BLE001
            return _json_response({"error": repr(e)},
                                  status=_error_status(e))
        self._telemetry.observe_ttft(
            target, time.perf_counter() - t_ingress)
        # Stream headers go out first: the id must be on the response
        # BEFORE the first chunk.
        step = None
        try:
            await stream.prepare({
                "Content-Type": "application/x-ndjson",
                REQUEST_ID_HEADER: rid})
            item = first
            while item is not _END:
                await stream.write((json.dumps(item) + "\n").encode())
                step = loop.run_in_executor(self._executor, _next)
                try:
                    item = await _await_step(step)
                except (ConnectionError, asyncio.CancelledError):
                    raise
                except Exception as e:  # noqa: BLE001
                    # Mid-stream failure: emit the typed terminal
                    # frame so consumers never mistake truncation for
                    # completion.
                    step = None
                    await stream.write(_stream_error_chunk(e))
                    break
                step = None
            await stream.write_eof()
        except (ConnectionError, asyncio.CancelledError):
            # Client went away mid-stream: stop the replica-side
            # generator as soon as the in-flight step (if any) hands
            # the generator back.
            if step is not None:
                _close_after(step)
            else:
                try:
                    it.close()
                except Exception:
                    pass
            raise
        return stream


def _error_status(e: BaseException) -> int:
    """Resilience-plane errors map to meaningful statuses instead of a
    generic 500."""
    from .resilience import (ReplicasUnavailableError, RequestShedError,
                             RequestTimeoutError, is_system_fault)

    if isinstance(e, RequestShedError):
        return 429    # admission queue full, oldest shed
    if isinstance(e, RequestTimeoutError):
        return 504    # request deadline exceeded
    if isinstance(e, ReplicasUnavailableError) or is_system_fault(e):
        return 503    # no healthy replica (even after retries)
    return 500


def _stream_error_chunk(e: BaseException) -> bytes:
    """Structured terminal error frame: status 200 already went out,
    so this line is the ONLY way a consumer can distinguish a
    mid-stream failure from completion."""
    from .resilience import StreamInterruptedError, is_system_fault

    info: Dict[str, Any] = {
        "type": type(e).__name__,
        "message": str(e) or repr(e),
        "system": bool(is_system_fault(e) or
                       isinstance(e, StreamInterruptedError)),
    }
    if isinstance(e, StreamInterruptedError):
        info["items_delivered"] = e.items_delivered
    return (json.dumps({"__rt_stream_error__": info}) + "\n").encode()

