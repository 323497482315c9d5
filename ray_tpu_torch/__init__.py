"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

The JAX package ``ray_tpu`` is the reference; this package keeps its
module paths and public names (``ops.flash_attention``,
``models.gpt2``, ``models.llama``, ``train.train_step``, ``llm``, the
runtime's ``init``/``remote``/``get``) so each counterpart is easy to
find.  It imports ``torch`` and numpy only: nothing of ``jax`` and
nothing of ``ray_tpu``.

The runtime (``core/``: tasks, actors, objects, placement groups over a
controller/agent/worker process tree) is the JAX package's own, with
``GPU`` in place of ``TPU`` as a scheduler resource: a lease's GPU ids
reach its worker as ``CUDA_VISIBLE_DEVICES``.  Its control-plane
processes never import torch.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see ``device.py``).  On the card, attention runs
through hand-written Hopper kernels (``csrc/flash_{fwd,dkv,dq}.cu``,
built at first use by ``ops/_kernels.py``); on the CPU the same
functions use their plain PyTorch versions.

This top-level module is import-light (worker processes start through
it): ML subpackages load on attribute access.
"""

import atexit
import os
from typing import Any, Dict, Optional

from .core import runtime as _runtime_mod
from .core.api import (cancel, get, get_actor, get_runtime_context,  # noqa: F401
                       kill, method, put, remote, wait)
from .core.api import ActorClass, ActorHandle, RemoteFunction  # noqa: F401
from .core.config import RuntimeConfig
from .core.errors import *  # noqa: F401,F403
from .core.object_ref import ObjectRef  # noqa: F401

__version__ = "0.1.0"

_LAZY_SUBMODULES = ("collective", "device", "dryrun", "llm", "models",
                    "ops", "parallel", "serve", "train", "util")


def __getattr__(name: str):
    if name in _LAZY_SUBMODULES:
        import importlib

        mod = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def init(
    address: Optional[str] = None,
    *,
    mode: str = "auto",
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    namespace: str = "",
    config: Optional[Dict[str, Any]] = None,
    log_to_driver: Optional[bool] = None,
    ignore_reinit_error: bool = False,
):
    """Start (or connect to) a runtime.

    Role-equivalent to the reference's ray.init (ref:
    python/ray/_private/worker.py:1275).

    - ``mode="local"``: synchronous in-process execution (debugging).
    - ``mode="cluster"``: spawn a controller + node agent + workers on this
      host (the default for ``mode="auto"`` unless RT_LOCAL_MODE=1).
    - ``address="<host:port>"``: connect as a driver to an existing cluster.

    ``num_gpus`` overrides GPU detection (``/proc/driver/nvidia``, a
    preset ``CUDA_VISIBLE_DEVICES``).  The remote client (``rt://``) and
    ``address="auto"`` (the ``rt`` CLI's cluster record) are not ported
    yet and raise.
    """
    if _runtime_mod.is_initialized():
        if ignore_reinit_error:
            return _runtime_mod.get_runtime()
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(pass ignore_reinit_error=True to allow)")
    if address and (address.startswith("rt://") or address == "auto"):
        raise NotImplementedError(
            f"address={address!r} needs the remote client or the rt CLI's "
            "cluster record, not ported yet (ROADMAP Queue 1 item 5: "
            "'doctor, state and the rt CLI', 'jobs'); pass the "
            "controller's host:port")
    overrides = dict(config or {})
    if object_store_memory:
        overrides["object_store_memory_bytes"] = int(object_store_memory)
    if log_to_driver is not None:
        overrides["log_to_driver"] = log_to_driver
    cfg = RuntimeConfig.from_env(overrides)
    if mode == "auto":
        mode = "local" if os.environ.get("RT_LOCAL_MODE") == "1" \
            else "cluster"
    if mode == "local":
        from .core.local_runtime import LocalRuntime

        rt = LocalRuntime(cfg)
    elif mode == "cluster":
        from .core.cluster_runtime import ClusterRuntime

        rt = ClusterRuntime(
            cfg, address=address, num_cpus=num_cpus, num_gpus=num_gpus,
            custom_resources=resources, namespace=namespace)
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    _runtime_mod.set_runtime(rt)
    atexit.register(_shutdown_quiet)
    return rt


def _shutdown_quiet():
    try:
        shutdown()
    except Exception:
        pass


def shutdown() -> None:
    """Tear down the runtime started by init()."""
    if _runtime_mod.is_initialized():
        rt = _runtime_mod.get_runtime()
        _runtime_mod.set_runtime(None)
        rt.shutdown()


def is_initialized() -> bool:
    return _runtime_mod.is_initialized()


def cluster_resources() -> Dict[str, float]:
    return _runtime_mod.get_runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _runtime_mod.get_runtime().available_resources()


def nodes():
    return _runtime_mod.get_runtime().nodes()
