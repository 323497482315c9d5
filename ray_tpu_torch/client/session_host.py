"""Session host — the server-side driver hosting ONE rt:// client.

Role-equivalent to the reference's SpecificServer (ref:
util/client/server/proxier.py:119 — one dedicated server process per
client so each client is a real, isolated driver with its own job).
The ClientServer spawns this process per connection and relays the
client's frames to it verbatim; handlers here replay the thin client's
BaseRuntime calls onto a real ClusterRuntime and pin returned
ObjectRefs until the client releases them.

Values and specs arrive packed by the client (``serialization.pack``)
and values leave packed: a tensor passes through here as host memory,
so this process may load torch but never initialises CUDA.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--address", required=True,
                    help="controller address of the cluster")
    args = ap.parse_args(argv)

    import ray_tpu_torch
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.core.rpc import RpcServer
    from ray_tpu_torch.core.serialization import pack, unpack

    rt = ray_tpu_torch.init(address=args.address)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    # Blocking runtime ops (get/wait can block for minutes) run here so
    # the RPC loop stays responsive to concurrent client requests.
    pool = ThreadPoolExecutor(max_workers=8,
                              thread_name_prefix="client-op")
    server = RpcServer(host="127.0.0.1")  # only the relay dials us
    exit_event = asyncio.Event()
    # Client-held refs: the session host IS the owner/borrower of every
    # object the client sees; pinning here keeps ref counting honest
    # until the client's ObjectRef.__del__ releases (ref:
    # util/client/server/server.py object id tracking).
    pins: Dict[Any, ObjectRef] = {}

    def _pin(ref: ObjectRef):
        pins[ref.id] = ref
        return ref.id

    def _ref_of(oid) -> ObjectRef:
        ref = pins.get(oid)
        return ref if ref is not None else ObjectRef(oid)

    async def _sync(fn, *a):
        return await loop.run_in_executor(pool, fn, *a)

    async def c_init(_p):
        return {"job_id": rt.job_id, "config_json": rt.config.to_json()}

    async def c_submit_task(p):
        out = await _sync(rt.submit_task, unpack(p["spec"]))
        return {"oids": [_pin(r) for r in out]}

    async def c_create_actor(p):
        await _sync(rt.create_actor, unpack(p["spec"]))
        return {"ok": True}

    async def c_submit_actor_task(p):
        out = await _sync(rt.submit_actor_task, unpack(p["spec"]))
        return {"oids": [_pin(r) for r in out]}

    async def c_put(p):
        return {"oid": _pin(await _sync(rt.put, unpack(p["value"])))}

    async def c_get(p):
        values = await _sync(rt.get, [_ref_of(o) for o in p["oids"]],
                             p.get("timeout"))
        return {"values": await _sync(pack, values)}

    async def c_wait(p):
        ready, _nr = await _sync(rt.wait,
                                 [_ref_of(o) for o in p["oids"]],
                                 p["num_returns"], p.get("timeout"),
                                 p.get("fetch_local", True))
        return {"ready": [r.id for r in ready]}

    async def c_kill_actor(p):
        await _sync(rt.kill_actor, p["actor_id"], p["no_restart"])
        return {"ok": True}

    async def c_cancel(p):
        await _sync(rt.cancel, _ref_of(p["oid"]), p["force"])
        return {"ok": True}

    async def c_get_named_actor(p):
        handle = await _sync(rt.get_named_actor, p["name"],
                             p.get("namespace", ""))
        return {"handle": handle}

    async def c_controller(p):
        return await _sync(rt.controller_call, p["method"],
                           p.get("payload"))

    async def c_agent(p):
        return await _sync(rt.agent_call, p["method"],
                           p.get("payload"))

    async def c_cluster_resources(_p):
        return await _sync(rt.cluster_resources)

    async def c_available_resources(_p):
        return await _sync(rt.available_resources)

    async def c_nodes(_p):
        return await _sync(rt.nodes)

    def c_release(p):  # notify — fire and forget
        for oid in p["oids"]:
            pins.pop(oid, None)

    def c_shutdown(_p):  # notify
        loop.call_soon_threadsafe(exit_event.set)

    for name, fn in list(locals().items()):
        if name.startswith("c_"):
            server.register(name, fn)
    # The relay holds exactly one connection to us; when the client
    # goes away (clean or not), this session's driver exits and its
    # job's refs release (ref: proxier.py cleanup on client drop).
    server.on_connection_lost(
        lambda _tag: loop.call_soon_threadsafe(exit_event.set))

    port = loop.run_until_complete(server.start(0))
    print(f"RT_CLIENT_PORT={port}", flush=True)
    loop.run_until_complete(exit_event.wait())
    loop.run_until_complete(server.stop())
    ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
