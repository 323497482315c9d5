"""ray_tpu_torch.serve — model serving over the cluster runtime.

Role-equivalent to the reference's Ray Serve (ref: SURVEY.md §2.4 —
serve.run -> controller -> replicas, HTTP proxy, pow-2 routing,
DeploymentHandle composition).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import ray_tpu_torch
from .controller import (CONTROLLER_NAME, DeploymentHandle,  # noqa
                         ServeController)
from .deployment import (Application, AutoscalingConfig,  # noqa
                         Deployment, deployment)
from .resilience import (ReplicasUnavailableError,  # noqa: F401
                         RequestShedError, RequestTimeoutError,
                         StreamInterruptedError)

_http_proxy = None


def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        cls = ray_tpu_torch.remote(ServeController)
        # Control-plane actors are IO-bound: 0 CPUs, like the reference's
        # serve controller/proxy actors.  max_concurrency is sized for
        # many handles/proxies parked in poll_update long-polls at once.
        return cls.options(name=CONTROLLER_NAME, max_concurrency=64,
                           num_cpus=0, get_if_exists=True,
                           lifetime="detached").remote()


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/",
        http: bool = False) -> DeploymentHandle:
    """Deploy an application graph; returns the ingress handle (ref:
    serve/api.py:496 serve.run)."""
    from ..core import serialization

    ctl = _get_or_create_controller()

    def deploy_app(node: Application, is_root: bool) -> DeploymentHandle:
        # Depth-first: children deploy first; their handles replace the
        # Application objects in parent init args (model composition).
        args = tuple(
            deploy_app(a, False) if isinstance(a, Application) else a
            for a in node.init_args)
        kwargs = {
            k: deploy_app(v, False) if isinstance(v, Application) else v
            for k, v in node.init_kwargs.items()}
        d = node.deployment
        serialization.ensure_code_portable(d.func_or_class)
        from .._vendor import cloudpickle

        payload = cloudpickle.dumps(d.func_or_class)
        # The init arguments as bytes: only the replica decodes them
        # (controller.py's docstring says why).
        init_payload = serialization.pack((args, kwargs))
        prefix = d.route_prefix
        if is_root and prefix is None:
            prefix = route_prefix
        autoscaling = None
        if d.autoscaling_config is not None:
            ac = d.autoscaling_config
            autoscaling = {
                "min_replicas": ac.min_replicas,
                "max_replicas": ac.max_replicas,
                "target_ongoing_requests": ac.target_ongoing_requests,
                "upscale_delay_s": ac.upscale_delay_s,
                "downscale_delay_s": ac.downscale_delay_s,
            }
        import inspect as _inspect

        target_fn = (d.func_or_class if d.is_function
                     else getattr(d.func_or_class, "__call__", None))
        streaming = bool(target_fn is not None and (
            _inspect.isgeneratorfunction(target_fn)
            or _inspect.isasyncgenfunction(target_fn)))
        ray_tpu_torch.get(ctl.deploy.remote(
            d.name, payload, init_payload, d.num_replicas,
            d.is_function, prefix, d.ray_actor_options, autoscaling,
            streaming, d.max_ongoing_requests))
        return DeploymentHandle(d.name)

    handle = deploy_app(app, True)
    if http:
        start_http_proxy()
    return handle


def start_http_proxy(port: int = 0) -> int:
    """Start (or reuse) the HTTP ingress on THIS node; returns the
    bound port."""
    global _http_proxy
    from .proxy import HTTPProxy

    if _http_proxy is None:
        cls = ray_tpu_torch.remote(HTTPProxy)
        _http_proxy = cls.options(max_concurrency=32, num_cpus=0,
                                  name="rt_serve_proxy",
                                  get_if_exists=True).remote(port)
    return ray_tpu_torch.get(_http_proxy.port.remote())


def start_http_proxies(port: int = 0) -> Dict[str, int]:
    """One ingress proxy per alive node (ref: serve/_private/proxy.py
    :763 — the reference runs an HTTPProxy on every ingress node so
    losing a node's proxy leaves ingress up elsewhere).  Returns
    {node_id_hex: port}."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    from .proxy import HTTPProxy

    cls = ray_tpu_torch.remote(HTTPProxy)
    out: Dict[str, int] = {}
    for n in ray_tpu_torch.nodes():
        if not n.get("Alive"):
            continue
        nid = n["NodeID"]
        proxy = cls.options(
            max_concurrency=32, num_cpus=0,
            name=f"rt_serve_proxy_{nid[:12]}", get_if_exists=True,
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=nid, soft=False)).remote(port)
        out[nid] = ray_tpu_torch.get(proxy.port.remote())
    return out


_grpc_proxy = None


def start_grpc_proxy(port: int = 0) -> int:
    """Start (or reuse) the gRPC ingress on THIS node; returns the
    bound port (ref: serve/_private/proxy.py:540 gRPCProxy)."""
    global _grpc_proxy
    from .grpc_proxy import GRPCProxy, import_grpc

    import_grpc()     # a clear ImportError where grpcio is missing
    if _grpc_proxy is None:
        cls = ray_tpu_torch.remote(GRPCProxy)
        _grpc_proxy = cls.options(max_concurrency=32, num_cpus=0,
                                  name="rt_serve_grpc_proxy",
                                  get_if_exists=True).remote(port)
    return ray_tpu_torch.get(_grpc_proxy.port.remote())


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def status() -> Dict[str, Any]:
    ctl = _get_or_create_controller()
    return ray_tpu_torch.get(ctl.list_deployments.remote())


def scale(deployment_name: str, num_replicas: int) -> int:
    ctl = _get_or_create_controller()
    return ray_tpu_torch.get(ctl.scale.remote(deployment_name, num_replicas))


def delete(deployment_name: str) -> None:
    ctl = _get_or_create_controller()
    ray_tpu_torch.get(ctl.delete.remote(deployment_name))


def shutdown() -> None:
    global _http_proxy, _grpc_proxy
    try:
        ctl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        for name in list(ray_tpu_torch.get(ctl.list_deployments.remote())):
            ray_tpu_torch.get(ctl.delete.remote(name))
        ray_tpu_torch.kill(ctl)
    except ValueError:
        pass
    for proxy in (_http_proxy, _grpc_proxy):
        if proxy is not None:
            try:
                ray_tpu_torch.kill(proxy)
            except Exception:
                pass
    _http_proxy = None
    _grpc_proxy = None
