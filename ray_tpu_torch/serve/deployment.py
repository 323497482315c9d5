"""Deployments — versioned replicated callables.

Role-equivalent to the reference's @serve.deployment / Deployment /
Application (ref: python/ray/serve/api.py, _private/deployment_state.py).
``@serve.deployment`` wraps a class or function; ``.bind(...)`` builds an
application graph whose nodes may reference other bound deployments
(model composition — parents receive DeploymentHandles at init).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 10.0


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    route_prefix: Optional[str] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    max_ongoing_requests: int = 16

    def options(self, **kwargs) -> "Deployment":
        return replace(self, **kwargs)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    @property
    def is_function(self) -> bool:
        return inspect.isfunction(self.func_or_class)


@dataclass
class Application:
    deployment: Deployment
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)

    def children(self) -> List["Application"]:
        out = []
        for a in list(self.init_args) + list(self.init_kwargs.values()):
            if isinstance(a, Application):
                out.append(a)
        return out


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               ray_actor_options: Optional[Dict] = None,
               route_prefix: Optional[str] = None,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               max_ongoing_requests: int = 16):
    """``@serve.deployment`` decorator (ref: serve/api.py deployment)."""

    def wrap(target):
        return Deployment(
            func_or_class=target,
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options or {},
            route_prefix=route_prefix,
            autoscaling_config=autoscaling_config,
            max_ongoing_requests=max_ongoing_requests)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
