"""Shared ingress route table — ONE config-push client for every proxy.

Both the HTTP and gRPC proxies consume the controller's long-poll route
pushes through this class, so the two ingresses always agree (ref:
serve/_private/long_poll.py LongPollClient shared by proxy types)."""

from __future__ import annotations

import threading
from typing import Dict, Optional


class RouteTable:
    def __init__(self):
        self._cache: Dict[str, str] = {}
        self._streaming: Dict[str, bool] = {}
        self._version = -1
        self._poller: Optional[threading.Thread] = None
        # The gRPC proxy calls get() from a thread POOL: without this
        # lock, concurrent first requests each start a poller.
        self._start_lock = threading.Lock()

    def get(self) -> Dict[str, str]:
        """Current {route_prefix: deployment_name}; starts the poller
        on first use (synchronous first fetch so the first request
        routes)."""
        if self._poller is None or not self._poller.is_alive():
            with self._start_lock:
                if self._poller is None or \
                        not self._poller.is_alive():
                    self._start()
        return self._cache

    def is_streaming(self, name: str) -> bool:
        """Whether a deployment's handler is a generator (the ingress
        must take the streaming call path for it)."""
        return bool(self._streaming.get(name))

    def resolve(self, path: str) -> Optional[str]:
        """Longest-prefix route match -> deployment name (or None)."""
        target, best = None, ""
        for prefix, name in self.get().items():
            if path == prefix or path.startswith(
                    prefix.rstrip("/") + "/"):
                if len(prefix) > len(best):
                    target, best = name, prefix
        return target

    def _start(self) -> None:
        import ray_tpu_torch
        from .controller import CONTROLLER_NAME

        try:
            ctl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            r = ray_tpu_torch.get(ctl.poll_update.remote(None, -1, 0.0),
                            timeout=30)
            self._cache = r["routes"]
            self._streaming = r.get("streaming", {})
            self._version = r["version"]
        except Exception:
            pass

        def loop():
            import time as _t

            import ray_tpu_torch
            while True:
                try:
                    ctl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                    r = ray_tpu_torch.get(ctl.poll_update.remote(
                        None, self._version, 25.0), timeout=40)
                    self._cache = r["routes"]
                    self._streaming = r.get("streaming", {})
                    self._version = r["version"]
                except Exception:
                    _t.sleep(1.0)

        self._poller = threading.Thread(
            target=loop, daemon=True, name="serve-route-poll")
        self._poller.start()
