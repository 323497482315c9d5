"""gRPC ingress proxy — generic service sharing the HTTP route table.

Role-equivalent to the reference's gRPCProxy (ref:
serve/_private/proxy.py:540 — a gRPC server whose methods resolve to
deployments and whose responses may stream).  Without user-compiled
stubs in the image, the surface is the generic-ingress pattern: one
service ``ray_tpu.serve.Ingress`` with

- ``Call``       (unary-unary):  request bytes = JSON
  ``{"deployment": name}`` or ``{"route": "/prefix"}`` plus
  ``"payload"``; response bytes = JSON ``{"result": ...}``.
- ``CallStream`` (unary-stream): same request against a generator
  deployment; each yielded item arrives as one JSON message.

Routes come from the same controller long-poll the HTTP proxy uses, so
both ingresses always agree on the table.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict

SERVICE = "ray_tpu.serve.Ingress"
REQUEST_ID_KEY = "rt-request-id"


def import_grpc():
    """``grpc``, imported on demand: the gRPC ingress is the only part
    of serve that needs grpcio, and a node without it still serves
    HTTP."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the gRPC ingress needs the grpcio package (import grpc "
            f"failed: {e}); the HTTP ingress does not") from e
    return grpc


class GRPCProxy:
    """Actor: a grpc.server with generic handlers over deployments."""

    def __init__(self, port: int = 0):
        from concurrent import futures as _futures

        grpc = import_grpc()

        from .proxy import _IngressTelemetry, clean_request_id
        from .routes import RouteTable

        self._handles: Dict[str, Any] = {}
        self._route_table = RouteTable()
        self._telemetry = _IngressTelemetry(proto="grpc")

        def _resolve(req: Dict[str, Any]) -> str:
            if req.get("deployment"):
                return req["deployment"]
            route = req.get("route", "/")
            target = self._route_table.resolve(route)
            if target is None:
                raise KeyError(f"no route for {route!r}")
            return target

        def _handle_for(name: str):
            from .controller import DeploymentHandle

            h = self._handles.get(name)
            if h is None:
                h = self._handles[name] = DeploymentHandle(name)
            return h

        def _timeout_of(req: Dict[str, Any], context) -> Any:
            """Per-request deadline: explicit ``timeout_s`` request
            field wins; else the client's own gRPC deadline (so the
            server stops working on a call the client already gave up
            on); else the ``serve_request_timeout_s`` default."""
            t = req.get("timeout_s")
            if t is not None:
                try:
                    return max(0.0, float(t))
                except (TypeError, ValueError):
                    pass
            try:
                remaining = context.time_remaining()
            except Exception:
                remaining = None
            # A channel without a deadline reports None (or a huge
            # sentinel); only propagate real client deadlines.
            if remaining is not None and remaining < 3e7:
                return max(0.0, float(remaining))
            return None

        def _abort_typed(context, e: BaseException) -> None:
            """Map resilience-plane errors to the canonical gRPC
            status codes (ref: the reference's gRPC proxy surfacing
            DEADLINE_EXCEEDED / RESOURCE_EXHAUSTED / UNAVAILABLE)."""
            from .controller import StreamingResponseRequired
            from .resilience import (ReplicasUnavailableError,
                                     RequestShedError,
                                     RequestTimeoutError,
                                     is_system_fault)

            if isinstance(e, RequestShedError):
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              repr(e))
            if isinstance(e, RequestTimeoutError):
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                              repr(e))
            if isinstance(e, ReplicasUnavailableError) or \
                    is_system_fault(e):
                context.abort(grpc.StatusCode.UNAVAILABLE, repr(e))
            cause = getattr(e, "cause", None) or \
                getattr(e, "__cause__", None) or e
            if isinstance(cause, StreamingResponseRequired) or \
                    "StreamingResponseRequired" in repr(e):
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "deployment streams; use "
                    "/ray_tpu.serve.Ingress/CallStream")
            context.abort(grpc.StatusCode.INTERNAL, repr(e))

        def _rid_of(context) -> Any:
            """The client's rt-request-id metadata (sanitized), or
            None — the gRPC dual of the X-RT-Request-Id header."""
            try:
                for k, v in context.invocation_metadata() or ():
                    if k == REQUEST_ID_KEY:
                        return clean_request_id(v)
            except Exception:
                pass
            return None

        def _class_of_exc(e: BaseException) -> str:
            from .resilience import (RequestShedError,
                                     RequestTimeoutError)

            if isinstance(e, RequestShedError):
                return "shed"
            if isinstance(e, RequestTimeoutError):
                return "deadline"
            if isinstance(e, KeyError):
                return "4xx"
            return "5xx"

        def call(request: bytes, context) -> bytes:
            from ..util import tracing

            rid = _rid_of(context) or tracing.new_request_id()
            try:
                # Trailer: delivered on success AND on abort(), so the
                # client can always quote the id (incl. 429/504 duals).
                context.set_trailing_metadata(((REQUEST_ID_KEY, rid),))
            except Exception:
                pass
            t0 = self._telemetry.begin()
            tel = {"dep": "?", "cls": "5xx", "outcome": "error"}
            try:
                try:
                    req = json.loads(request or b"{}")
                except ValueError as e:
                    # Malformed request bytes: the CLIENT's fault —
                    # 4xx like the HTTP proxy's 400, never budget burn.
                    tel["cls"], tel["outcome"] = "4xx", "bad_request"
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                  f"request is not JSON: {e}")
                handle = _handle_for(_resolve(req))
                tel["dep"] = handle.deployment_name
                self._telemetry.observe_phase(
                    "proxy", time.perf_counter() - t0)
                result = handle.call(req.get("payload"),
                                     timeout_s=_timeout_of(req,
                                                           context),
                                     request_id=rid)
                # Serialize INSIDE the try (with the HTTP proxy's
                # repr fallback): a non-JSON-able handler result must
                # not count as a served 2xx while the client errors.
                try:
                    out = json.dumps({"result": result}).encode()
                except (TypeError, ValueError):
                    out = json.dumps(
                        {"result": repr(result)}).encode()
                tel["cls"], tel["outcome"] = "2xx", "ok"
            except KeyError as e:
                tel["cls"], tel["outcome"] = "4xx", "not_found"
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            except Exception as e:  # noqa: BLE001 — surface to client
                if tel["outcome"] == "bad_request":
                    raise   # abort() already fired; don't re-abort
                tel["cls"] = _class_of_exc(e)
                _abort_typed(context, e)
            finally:
                self._telemetry.end(t0, tel["dep"], tel["outcome"],
                                    tel["cls"], rid)
            return out

        def call_stream(request: bytes, context):
            from ..util import tracing
            from .resilience import (StreamInterruptedError,
                                     is_system_fault)

            rid = _rid_of(context) or tracing.new_request_id()
            try:
                context.set_trailing_metadata(((REQUEST_ID_KEY, rid),))
            except Exception:
                pass
            t0 = self._telemetry.begin()
            tel = {"dep": "?", "cls": "5xx", "outcome": "error"}
            delivered = 0
            try:
                try:
                    req = json.loads(request or b"{}")
                except ValueError as e:
                    tel["cls"], tel["outcome"] = "4xx", "bad_request"
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                  f"request is not JSON: {e}")
                handle = _handle_for(_resolve(req))
                tel["dep"] = handle.deployment_name
                self._telemetry.observe_phase(
                    "proxy", time.perf_counter() - t0)
                for item in handle.stream_timed(
                        _timeout_of(req, context),
                        req.get("payload"), request_id=rid):
                    delivered += 1
                    if delivered == 1:
                        self._telemetry.observe_ttft(
                            tel["dep"], time.perf_counter() - t0)
                    yield json.dumps(item).encode()
                tel["cls"], tel["outcome"] = "2xx", "ok"
            except GeneratorExit:
                # The CLIENT cancelled the stream: grpc closes the
                # response generator.  Their choice, not a server
                # failure — must not burn the availability budget.
                tel["cls"], tel["outcome"] = "4xx", "disconnect"
                raise
            except KeyError as e:
                tel["cls"], tel["outcome"] = "4xx", "not_found"
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            except Exception as e:  # noqa: BLE001
                if tel["outcome"] == "bad_request":
                    raise   # abort() already fired; don't re-abort
                tel["cls"] = _class_of_exc(e)
                if delivered == 0:
                    _abort_typed(context, e)
                # Mid-stream failure: the typed trailer is how a gRPC
                # consumer distinguishes an interrupted stream from a
                # completed one (items already went out, but abort()
                # still carries status + trailing metadata).
                info = {"type": type(e).__name__,
                        "message": str(e) or repr(e),
                        "system": bool(
                            is_system_fault(e) or
                            isinstance(e, StreamInterruptedError)),
                        "items_delivered": delivered}
                try:
                    # One call replaces the trailer set: carry the
                    # request id alongside the error info.
                    context.set_trailing_metadata((
                        ("rt-stream-error", json.dumps(info)),
                        (REQUEST_ID_KEY, rid)))
                except Exception:
                    pass
                code = (grpc.StatusCode.UNAVAILABLE if info["system"]
                        else grpc.StatusCode.INTERNAL)
                context.abort(code, repr(e))
            finally:
                self._telemetry.end(t0, tel["dep"], tel["outcome"],
                                    tel["cls"], rid)

        ident = lambda b: b  # noqa: E731 — raw-bytes (de)serializer
        handlers = grpc.method_handlers_generic_handler(SERVICE, {
            "Call": grpc.unary_unary_rpc_method_handler(
                call, request_deserializer=ident,
                response_serializer=ident),
            "CallStream": grpc.unary_stream_rpc_method_handler(
                call_stream, request_deserializer=ident,
                response_serializer=ident),
        })
        self._server = grpc.server(
            _futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((handlers,))
        self._port = self._server.add_insecure_port(
            f"0.0.0.0:{port}")
        self._server.start()

    def port(self) -> int:
        return self._port
