"""HTTP/1.1 request parsing and response framing over ``asyncio``
streams, shared by the serve ingress (``serve/proxy.py``) and the
dashboard (``dashboard/``): neither needs aiohttp.  The limits are
aiohttp's defaults, so the port's servers refuse the requests the JAX
package's refuse.
"""

from __future__ import annotations

import asyncio
import json
from http import HTTPStatus
from typing import Any, Dict, Optional
from urllib.parse import unquote, urlsplit

# aiohttp's defaults, kept so both packages' servers refuse the same
# requests.
MAX_BODY = 1024 ** 2
MAX_HEAD = 8190 * 4
JSON = "application/json; charset=utf-8"
TEXT = "text/plain; charset=utf-8"


class BadRequest(Exception):
    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status


class Request:
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


class Response:
    """A complete (non-streaming) response."""

    def __init__(self, status: int, body: bytes,
                 content_type: str = JSON):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers: Dict[str, str] = {}
        self.prepared = False


def json_response(data: Any, status: int = 200) -> Response:
    return Response(status, json.dumps(data).encode())


def encode_head(status: int, headers: Dict[str, str]) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def encode_response(resp: Response, keep_alive: bool) -> bytes:
    """A complete response's head and body, ready to write."""
    headers = {"Content-Type": resp.content_type,
               "Content-Length": str(len(resp.body)),
               **resp.headers,
               "Connection": "keep-alive" if keep_alive else "close"}
    return encode_head(resp.status, headers) + resp.body


async def read_request(reader: asyncio.StreamReader
                        ) -> Optional[Request]:
    """Parse one request head; None on a clean EOF between requests."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise BadRequest(400, "Bad Request")
    except asyncio.LimitOverrunError:
        raise BadRequest(431, "Request Header Fields Too Large")
    lines = raw.decode("latin-1").split("\r\n")
    try:
        method, target, version = lines[0].split(" ", 2)
    except ValueError:
        raise BadRequest(400, "Bad Request")
    if not version.startswith("HTTP/1."):
        raise BadRequest(505, "HTTP Version Not Supported")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise BadRequest(400, "Bad Request")
        headers[name.strip().lower()] = value.strip()
    return Request(method, target, version, headers)


async def read_body(req: Request, reader: asyncio.StreamReader,
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
                raise BadRequest(400, "Bad Request")
            if size == 0:
                # Trailers (usually none) end with an empty line.
                while (await reader.readuntil(b"\r\n")) != b"\r\n":
                    pass
                break
            total += size
            if total > MAX_BODY:
                raise BadRequest(413, "Request Entity Too Large")
            parts.append(await reader.readexactly(size))
            await reader.readexactly(2)
        req.body = b"".join(parts)
        return
    try:
        length = int(req.header("content-length") or 0)
    except ValueError:
        raise BadRequest(400, "Bad Request")
    if length > MAX_BODY:
        raise BadRequest(413, "Request Entity Too Large")
    if length:
        req.body = await reader.readexactly(length)
