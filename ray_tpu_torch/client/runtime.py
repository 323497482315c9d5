"""ClientRuntime — the thin rt:// driver runtime.

Role-equivalent to the reference's client-side Ray Client worker (ref:
util/client/worker.py Worker: every API call becomes a message over one
connection; the server-side driver owns all cluster state).  Because
the whole public API funnels through BaseRuntime, this class IS the
client: api.remote/get/put/wait/actors work unchanged on top of it —
specs built locally, shipped whole, replayed by the session host.

ID safety: the session host is a dedicated driver with its own job id
(one per client), and the client never generates ObjectIDs itself
except task-return ids derived from its own task counter — the same
uniqueness contract a normal driver has.

Values and specs cross the link packed by ``core.serialization.pack``
(the port's pickler): a CUDA tensor leaves this process as host bytes,
so the session host rebuilds it as a CPU tensor and never initialises
CUDA (the RPC layer's own pickling would rebuild it on the card).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..core.config import RuntimeConfig
from ..core.object_ref import ObjectRef
from ..core.rpc import EventLoopThread, RemoteCallError, RpcClient
from ..core.runtime import BaseRuntime
from ..core.serialization import pack, unpack


class ClientRuntime(BaseRuntime):
    is_client = True

    def __init__(self, config: RuntimeConfig, address: str):
        self.io = EventLoopThread("rt-client-io")
        self._cli = RpcClient(address, tag="rt-client",
                              connect_timeout=30.0)
        self.io.run(self._cli.connect())
        hello = self._raw_call("c_init", {}, timeout=60.0)
        cfg = RuntimeConfig.from_json(hello["config_json"])
        super().__init__(cfg, job_id=hello["job_id"])
        self._ref_lock = threading.Lock()
        self._ref_counts: Dict[Any, int] = {}
        self._shutdown_flag = False

    # ------------------------------------------------------------ plumbing
    def _raw_call(self, method: str, payload: Any,
                  timeout: Optional[float] = None) -> Any:
        return self.io.run(self._cli.call(method, payload), timeout)

    def _call(self, method: str, payload: Any,
              timeout: Optional[float] = None) -> Any:
        """Call the session host; a handler-side exception re-raises
        here as its ORIGINAL type (incl. remote traceback text)."""
        try:
            return self._raw_call(method, payload, timeout)
        except RemoteCallError as e:
            raise e.cause from None

    # ------------------------------------------------------------- backend
    def submit_task(self, spec) -> List[ObjectRef]:
        r = self._call("c_submit_task", {"spec": pack(spec)})
        return [ObjectRef(o) for o in r["oids"]]

    def create_actor(self, spec) -> None:
        self._call("c_create_actor", {"spec": pack(spec)})

    def submit_actor_task(self, spec) -> List[ObjectRef]:
        r = self._call("c_submit_actor_task", {"spec": pack(spec)})
        return [ObjectRef(o) for o in r["oids"]]

    def put(self, value: Any) -> ObjectRef:
        return ObjectRef(self._call("c_put", {"value": pack(value)})["oid"])

    def get(self, refs: List[ObjectRef],
            timeout: Optional[float]) -> List[Any]:
        rpc_timeout = None if timeout is None else timeout + 60.0
        r = self._call("c_get", {"oids": [x.id for x in refs],
                                 "timeout": timeout}, rpc_timeout)
        return unpack(r["values"])

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float], fetch_local: bool
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        rpc_timeout = None if timeout is None else timeout + 60.0
        r = self._call("c_wait", {
            "oids": [x.id for x in refs], "num_returns": num_returns,
            "timeout": timeout, "fetch_local": fetch_local},
            rpc_timeout)
        ready_ids = set(r["ready"])
        ready = [x for x in refs if x.id in ready_ids]
        not_ready = [x for x in refs if x.id not in ready_ids]
        return ready, not_ready

    def kill_actor(self, actor_id, no_restart: bool) -> None:
        self._call("c_kill_actor", {"actor_id": actor_id,
                                    "no_restart": no_restart})

    def cancel(self, ref: ObjectRef, force: bool) -> None:
        self._call("c_cancel", {"oid": ref.id, "force": force})

    def get_named_actor(self, name: str, namespace: str = ""):
        r = self._call("c_get_named_actor",
                       {"name": name, "namespace": namespace})
        return r["handle"]

    def controller_call(self, method: str, payload=None,
                        timeout: Optional[float] = None):
        return self._call("c_controller",
                          {"method": method, "payload": payload},
                          timeout)

    def agent_call(self, method: str, payload=None,
                   timeout: Optional[float] = None):
        """Reaches the session host's LOCAL node agent (head node)."""
        return self._call("c_agent",
                          {"method": method, "payload": payload},
                          timeout)

    def cluster_resources(self) -> Dict[str, float]:
        return self._call("c_cluster_resources", {})

    def available_resources(self) -> Dict[str, float]:
        return self._call("c_available_resources", {})

    def nodes(self) -> List[Dict[str, Any]]:
        return self._call("c_nodes", {})

    # ------------------------------------------------------- ref counting
    def add_local_ref(self, object_id) -> None:
        with self._ref_lock:
            self._ref_counts[object_id] = \
                self._ref_counts.get(object_id, 0) + 1

    def remove_local_ref(self, object_id) -> None:
        if self._shutdown_flag:
            return
        with self._ref_lock:
            n = self._ref_counts.get(object_id, 0) - 1
            if n > 0:
                self._ref_counts[object_id] = n
                return
            self._ref_counts.pop(object_id, None)
            if n < 0:
                return
        try:
            self.io.spawn(self._cli.notify("c_release",
                                           {"oids": [object_id]}))
        except Exception:
            pass  # interpreter teardown / link already gone

    # ------------------------------------------------------------ teardown
    def shutdown(self) -> None:
        if self._shutdown_flag:
            return
        self._shutdown_flag = True
        try:
            self.io.run(self._cli.notify("c_shutdown", {}),
                        timeout=5.0)
        except Exception:
            pass
        try:
            self.io.run(self._cli.close(), timeout=5.0)
        except Exception:
            pass
