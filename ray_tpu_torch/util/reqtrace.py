"""Request-scoped trace assembly and slow-request exemplars.

A copy of ``ray_tpu/util/reqtrace.py``.  The span plane
(``util/spans.py``) records per-hop spans tagged with a request id; on
the port those are the generation engine's lifecycle spans
(``engine_waiting`` / ``prefill`` / ``decode``), and the ingress hops
(``ingress``, ``admission_wait``, ``attempt``, ``replica_exec``) come
with the serve plane.  ``assemble_trace`` turns a flat span set back
into one request's hop chain and ``ttft_phases`` splits its
time-to-first-token; ``ExemplarRing`` keeps the slowest requests per
window.

Plain Python over plain dicts: no torch, no cluster.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# TTFT decomposition: the phases a request's time-to-first-token can be
# attributed to, in hop order.  ``proxy`` is derived (ingress start ->
# first downstream span); the rest are recorded spans.
TTFT_PHASES = ("proxy", "admission_queue", "engine_waiting", "prefill")

# Render order for hop categories (ingress first, engine last).
_HOP_ORDER = {"ingress": 0, "admission_wait": 1, "attempt": 2,
              "replica_exec": 3, "engine_waiting": 4, "prefill": 5,
              "decode": 6}


def request_id_of(span: Dict[str, Any]) -> Optional[str]:
    return (span.get("tags") or {}).get("request_id")


def find_request_ids(spans: List[Dict[str, Any]],
                     prefix: str = "") -> List[str]:
    """Distinct request ids in a span set, optionally prefix-filtered
    (the ``rt explain`` prefix-match convention)."""
    out = []
    seen = set()
    for s in spans or []:
        rid = request_id_of(s)
        if rid and rid not in seen and rid.startswith(prefix):
            seen.add(rid)
            out.append(rid)
    return out


def assemble_trace(spans: List[Dict[str, Any]],
                   request_id: str) -> Dict[str, Any]:
    """Reassemble one request's cross-process hop chain from a flat
    span set (``state.list_spans`` or a synthetic test set).

    Returns {"request_id", "found", "hops", "deployment", "start",
    "end", "total_s", "phases", "ttft_s", "dominant_phase"} — hops
    sorted by (start, hop order) so the chain reads ingress -> queue ->
    attempt -> replica -> engine even when clocks are near-ties.
    """
    hops = [dict(s) for s in spans or []
            if request_id_of(s) == request_id]
    hops.sort(key=lambda s: (s.get("start", 0.0),
                             _HOP_ORDER.get(s.get("name"), 9)))
    if not hops:
        return {"request_id": request_id, "found": False, "hops": []}
    deployment = next((h["tags"]["deployment"] for h in hops
                       if (h.get("tags") or {}).get("deployment")),
                      "?")
    start = min(h.get("start", 0.0) for h in hops)
    end = max(h.get("end", 0.0) for h in hops)
    phases = ttft_phases(hops)
    dominant = max(phases, key=lambda p: phases[p]) if phases else None
    return {
        "request_id": request_id,
        "found": True,
        "hops": hops,
        "deployment": deployment,
        "start": start,
        "end": end,
        "total_s": max(end - start, 0.0),
        "phases": phases,
        "ttft_s": sum(phases.values()) if phases else None,
        "dominant_phase": dominant,
    }


def ttft_phases(hops: List[Dict[str, Any]]) -> Dict[str, float]:
    """Split a request's time-to-first-token across the phases that
    produced it.  The recorded spans give admission_queue /
    engine_waiting / prefill directly; ``proxy`` is the derived gap
    between ingress start and the first downstream span (parse +
    route + dispatch overhead at the proxy), so the phases SUM to the
    ingress-to-first-token wall time when all hops are present (the
    accounting invariant pinned by tests/test_request_tracing.py)."""
    by_name: Dict[str, Dict[str, Any]] = {}
    for h in hops:
        name = h.get("name")
        if name in _HOP_ORDER and name not in by_name:
            by_name[name] = h

    def _dur(name: str) -> float:
        h = by_name.get(name)
        if not h:
            return 0.0
        return max(h.get("end", 0.0) - h.get("start", 0.0), 0.0)

    phases = {
        "admission_queue": _dur("admission_wait"),
        "engine_waiting": _dur("engine_waiting"),
        "prefill": _dur("prefill"),
    }
    ingress = by_name.get("ingress")
    downstream = [by_name[n] for n in
                  ("admission_wait", "attempt", "replica_exec",
                   "engine_waiting", "prefill") if n in by_name]
    if ingress and downstream:
        first = min(d.get("start", 0.0) for d in downstream)
        phases["proxy"] = max(first - ingress.get("start", 0.0), 0.0)
    else:
        phases["proxy"] = 0.0
    # Time between leaving the admission queue (or the proxy) and the
    # engine seeing the request that no span claims: dispatch, arg
    # serialization, the actor-call hop.  Attributed explicitly so the
    # decomposition is exhaustive instead of silently lossy.
    accounted = sum(phases.values())
    tf = first_token_ts(hops)
    anchor = (ingress or (downstream[0] if downstream else None))
    if tf is not None and anchor is not None:
        e2e = max(tf - anchor.get("start", 0.0), 0.0)
        phases["other"] = max(e2e - accounted, 0.0)
    return phases


def first_token_ts(hops: List[Dict[str, Any]]) -> Optional[float]:
    """The first-token instant: end of the prefill span (prefill
    samples and emits the first token), falling back to the decode
    span's start."""
    for h in hops:
        if h.get("name") == "prefill":
            return h.get("end")
    for h in hops:
        if h.get("name") == "decode":
            return h.get("start")
    return None


def render_trace(trace: Dict[str, Any]) -> str:
    """Human-readable hop chain for `rt trace <id>`."""
    rid = trace.get("request_id", "?")
    if not trace.get("found"):
        return f"request {rid}: no spans found (expired from the " \
               f"span sink, or the id is wrong)\n"
    lines = [f"request {rid}  deployment={trace.get('deployment', '?')}"
             f"  total {trace.get('total_s', 0.0) * 1e3:.1f}ms"]
    phases = trace.get("phases") or {}
    if any(phases.values()):
        parts = "  ".join(f"{p}={phases[p] * 1e3:.1f}ms"
                          for p in (*TTFT_PHASES, "other")
                          if phases.get(p))
        lines.append(f"  ttft breakdown: {parts}")
        if trace.get("dominant_phase"):
            lines.append(f"  dominant phase: "
                         f"{trace['dominant_phase']}")
    t0 = trace.get("start", 0.0)
    for h in trace.get("hops", []):
        tags = h.get("tags") or {}
        extras = "  ".join(
            f"{k}={v}" for k, v in sorted(tags.items())
            if k not in ("request_id",))
        src = h.get("source") or f"pid-{h.get('pid', '?')}"
        dur = max(h.get("end", 0.0) - h.get("start", 0.0), 0.0)
        lines.append(f"  +{h.get('start', 0.0) - t0:8.4f}s "
                     f"{h.get('name', '?'):<16} "
                     f"{dur * 1e3:9.2f}ms  [{src}]"
                     + (f"  {extras}" if extras else ""))
    return "\n".join(lines) + "\n"
