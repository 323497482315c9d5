"""ClientServer — the head-side rt:// listener and per-client relay.

Role-equivalent to the reference's client proxier (ref:
util/client/server/proxier.py ProxyManager: listens on one public
port, starts a SpecificServer per client, forwards that client's
traffic to it).  Here the forwarding is a raw byte relay of the framed
RPC protocol — the thin client speaks end-to-end with its session
host; the relay adds no protocol of its own.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
from typing import Optional

logger = logging.getLogger("ray_tpu_torch.client.server")


class ClientServer:
    def __init__(self, controller_address: str, *,
                 host: Optional[str] = None, port: int = 0):
        self.controller_address = controller_address
        self._requested_port = port
        self._host = host
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: int = 0

    async def start(self) -> int:
        from ray_tpu_torch.core.net import get_node_ip_address

        bind = self._host
        if bind is None:
            bind = ("0.0.0.0" if os.environ.get("RT_BIND_ALL") == "1"
                    else get_node_ip_address())
        self._server = await asyncio.start_server(
            self._handle, bind, self._requested_port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("rt:// client server listening on %s:%d", bind,
                    self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
            self._server = None

    async def _handle(self, creader: asyncio.StreamReader,
                      cwriter: asyncio.StreamWriter) -> None:
        """One client connection = one session-host process + a
        bidirectional byte relay (ref: proxier.py:119 SpecificServer
        startup + data forwarding)."""
        # The host must import ray_tpu_torch exactly as this process does
        # (the server may run from a dev checkout not on the default
        # path).
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [p for p in sys.path if p]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
               if p])
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-u", "-m", "ray_tpu_torch.client.session_host",
            "--address", self.controller_address, env=env,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT)
        port = None
        try:
            deadline = asyncio.get_event_loop().time() + 60.0
            while asyncio.get_event_loop().time() < deadline:
                line = await asyncio.wait_for(proc.stdout.readline(),
                                              60.0)
                if not line:
                    break
                if line.startswith(b"RT_CLIENT_PORT="):
                    port = int(line.split(b"=", 1)[1])
                    break
            if port is None:
                raise RuntimeError(
                    "session host produced no RT_CLIENT_PORT trailer")
            from ray_tpu_torch.core.rpc import spawn_task

            spawn_task(self._drain(proc.stdout))
            sreader, swriter = await asyncio.open_connection(
                "127.0.0.1", port)
        except Exception:
            logger.exception("session host startup failed")
            try:
                cwriter.close()
            except Exception:
                pass
            if proc.returncode is None:
                proc.terminate()
            return
        try:
            await asyncio.wait(
                [asyncio.ensure_future(self._pump(creader, swriter)),
                 asyncio.ensure_future(self._pump(sreader, cwriter))],
                return_when=asyncio.FIRST_COMPLETED)
        finally:
            for w in (cwriter, swriter):
                try:
                    w.close()
                except Exception:
                    pass
            # Closing the host-side socket fires the session host's
            # connection-lost exit; give it a moment, then make sure.
            try:
                await asyncio.wait_for(proc.wait(), 15.0)
            except asyncio.TimeoutError:
                proc.terminate()

    @staticmethod
    async def _pump(reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                chunk = await reader.read(256 * 1024)
                if not chunk:
                    return
                writer.write(chunk)
                await writer.drain()
        except (ConnectionError, OSError, asyncio.CancelledError):
            return

    @staticmethod
    async def _drain(stream: asyncio.StreamReader) -> None:
        """Keep the session host's stdout pipe from filling."""
        try:
            while True:
                line = await stream.readline()
                if not line:
                    return
                logger.debug("session-host: %s",
                             line.decode("utf-8", "replace").rstrip())
        except Exception:
            return


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--address", required=True)
    ap.add_argument("--port", type=int, default=10001)
    args = ap.parse_args(argv)
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    server = ClientServer(args.address, port=args.port)
    port = loop.run_until_complete(server.start())
    print(f"RT_CLIENT_SERVER_PORT={port}", flush=True)
    try:
        loop.run_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
