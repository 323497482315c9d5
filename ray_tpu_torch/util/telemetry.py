"""Cluster telemetry summary: a copy of ``ray_tpu/util/telemetry.py``.

Pulls the controller's latest per-source metric snapshots (plus retained
flight-recorder dumps) through the ``telemetry`` RPC and re-aggregates
them into one operator-facing structure:

  goodput      phase seconds/fractions summed across every process
  train        per-source step / step-time / tokens-per-sec / MFU series
  collectives  latency histograms + effective bus bandwidth by op
  serve        ingress request latency + in-flight depth
  flight       dumps forwarded from dead workers

Everything here is read-side only: the write side is the process-local
metric registries shipped on the existing heartbeat cadence.  The
``rt telemetry`` command and the dashboard route that render it in the
JAX package are not ported (ROADMAP Queue 1 item 5); ``render_text``
gives the same report.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

TRAIN_GAUGES = ("rt_train_step", "rt_train_tokens_per_sec",
                "rt_train_mfu", "rt_train_compile_seconds",
                "rt_train_achieved_flops_per_sec",
                "rt_train_workers")
TRAIN_HISTS = ("rt_train_step_time_seconds",
               "rt_train_data_wait_seconds",
               "rt_train_checkpoint_save_seconds",
               "rt_train_checkpoint_restore_seconds")


def _hist_stats(boundaries: List[float], hist: Dict) -> Dict[str, float]:
    count = hist.get("count", 0)
    total = hist.get("sum", 0.0)
    out = {"count": count, "sum": total,
           "mean": (total / count) if count else 0.0}
    out["p50"] = _hist_quantile(boundaries, hist.get("buckets", []),
                                count, 0.5)
    out["p99"] = _hist_quantile(boundaries, hist.get("buckets", []),
                                count, 0.99)
    return out


def _merge_hist_stats(cur: Optional[Dict[str, float]],
                      new: Dict[str, float]) -> Dict[str, float]:
    """Merge hist stats across series/sources: exact for count/sum/
    mean, conservative (max) for the quantile bounds."""
    if not cur:
        return dict(new)
    n = cur["count"] + new["count"]
    total = cur["sum"] + new["sum"]
    return {"count": n, "sum": total,
            "mean": (total / n) if n else 0.0,
            "p50": max(cur["p50"], new["p50"]),
            "p99": max(cur["p99"], new["p99"])}


def _hist_quantile(boundaries: List[float], buckets: List[int],
                   count: int, q: float) -> float:
    """Upper-bound estimate of the q-quantile from bucket counts (the
    +Inf bucket reports the last finite boundary)."""
    if not count or not buckets:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= target:
            if i < len(boundaries):
                return float(boundaries[i])
            return float(boundaries[-1]) if boundaries else 0.0
    return float(boundaries[-1]) if boundaries else 0.0


def _iter_metrics(sources: Dict[str, List[Dict]]
                  ) -> List[Tuple[str, Dict]]:
    out = []
    for src, snaps in (sources or {}).items():
        for snap in snaps:
            out.append((src, snap))
    return out


def cluster_summary(*, address: Optional[str] = None) -> Dict[str, Any]:
    """Assemble the full telemetry summary from a live controller."""
    from . import goodput as goodput_mod
    from . import state as state_api

    raw = state_api.telemetry(address=address)
    sources: Dict[str, List[Dict]] = raw.get("sources", {})
    try:
        history = state_api.metrics_history(address=address)
    except Exception:
        history = {}

    # --- train: latest gauge values + histogram stats per source.
    train: Dict[str, Dict[str, Any]] = {}
    collectives: List[Dict[str, Any]] = []
    serve: Dict[str, Any] = {}
    object_store = {"spilled_bytes": 0.0, "spill_total": 0.0,
                    "restore_total": 0.0}
    worker_pool = {"idle": 0.0, "target": 0.0, "adoptions": 0.0,
                   "cold_spawns": 0.0, "events_dropped": 0.0,
                   "startup": {}}
    llm = {"kv_pages_used": 0.0, "kv_pages_total": 0.0,
           "batch_size": 0.0, "waiting": 0.0, "tokens": 0.0,
           "prefill_tokens": 0.0, "evictions": 0.0, "engines": 0}
    checkpoints: Dict[str, Any] = {"bytes": 0.0, "shards": 0.0,
                                   "save": {}, "restore": {}}
    # XLA introspection plane (util/xprof.py): per-program static
    # facts are identical on every rank (max-merge); compile counts/
    # seconds accumulate (sum across sources).
    xla_programs: Dict[str, Dict[str, Any]] = {}
    xla_devmem: Dict[str, Dict[str, Dict[str, float]]] = {}

    def _xla_prog(fn: str) -> Dict[str, Any]:
        return xla_programs.setdefault(
            fn, {"flops": 0.0, "bytes": 0.0, "memory": {},
                 "collectives": {}, "compiles": 0.0,
                 "compile_seconds": 0.0})

    for src, snap in _iter_metrics(sources):
        name = snap.get("name", "")
        if name.startswith("rt_xla_"):
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                val = float(s.get("value", 0.0))
                if name == "rt_xla_device_memory_bytes":
                    dev = xla_devmem.setdefault(src, {}).setdefault(
                        tags.get("device", "?"), {})
                    dev[tags.get("kind", "?")] = val
                    continue
                prog = _xla_prog(tags.get("fn", "?"))
                if name == "rt_xla_cost_flops":
                    prog["flops"] = max(prog["flops"], val)
                elif name == "rt_xla_cost_bytes":
                    prog["bytes"] = max(prog["bytes"], val)
                elif name == "rt_xla_memory_bytes":
                    kind = tags.get("kind", "?")
                    prog["memory"][kind] = max(
                        prog["memory"].get(kind, 0.0), val)
                elif name == "rt_xla_collective_bytes":
                    axis = tags.get("axis", "?")
                    a = prog["collectives"].setdefault(
                        axis, {"bytes": 0.0, "by_op": {}})
                    op = tags.get("op", "?")
                    a["by_op"][op] = max(a["by_op"].get(op, 0.0),
                                         val)
                elif name == "rt_xla_compiles_total":
                    prog["compiles"] += val
                elif name == "rt_xla_compile_seconds_total":
                    prog["compile_seconds"] += val
            continue
        if name in ("rt_checkpoint_bytes", "rt_checkpoint_shards"):
            key = "bytes" if name.endswith("bytes") else "shards"
            for s in snap.get("series", []):
                checkpoints[key] += float(s.get("value", 0.0))
            continue
        if name.startswith("rt_llm_"):
            key = {"rt_llm_kv_pages_used": "kv_pages_used",
                   "rt_llm_kv_pages_total": "kv_pages_total",
                   "rt_llm_batch_size": "batch_size",
                   "rt_llm_waiting": "waiting",
                   "rt_llm_tokens_total": "tokens",
                   "rt_llm_prefill_tokens_total": "prefill_tokens",
                   "rt_llm_evictions_total": "evictions"}.get(name)
            if key is not None:
                if name == "rt_llm_kv_pages_total":
                    llm["engines"] += 1
                for s in snap.get("series", []):
                    llm[key] += float(s.get("value", 0.0))
            continue
        if name in ("rt_object_spilled_bytes", "rt_object_spill_total",
                    "rt_object_restore_total"):
            key = name.replace("rt_object_", "")
            for s in snap.get("series", []):
                object_store[key] += float(s.get("value", 0.0))
            continue
        if name in ("rt_worker_pool_idle", "rt_worker_pool_target",
                    "rt_worker_adoptions_total",
                    "rt_worker_cold_spawn_total",
                    "rt_task_events_dropped_total"):
            key = {"rt_worker_pool_idle": "idle",
                   "rt_worker_pool_target": "target",
                   "rt_worker_adoptions_total": "adoptions",
                   "rt_worker_cold_spawn_total": "cold_spawns",
                   "rt_task_events_dropped_total":
                       "events_dropped"}[name]
            for s in snap.get("series", []):
                worker_pool[key] += float(s.get("value", 0.0))
            continue
        if name == "rt_worker_startup_seconds":
            for s in snap.get("series", []):
                phase = (s.get("tags") or {}).get("phase", "?")
                stats = _hist_stats(snap.get("boundaries", []),
                                    s.get("hist", {}))
                cur = worker_pool["startup"].get(phase)
                if cur is None:
                    worker_pool["startup"][phase] = stats
                else:
                    # Merge across nodes: exact for count/sum/mean,
                    # conservative (max) for the quantile bounds.
                    n = cur["count"] + stats["count"]
                    total = cur["sum"] + stats["sum"]
                    worker_pool["startup"][phase] = {
                        "count": n, "sum": total,
                        "mean": (total / n) if n else 0.0,
                        "p50": max(cur["p50"], stats["p50"]),
                        "p99": max(cur["p99"], stats["p99"])}
            continue
        if name in TRAIN_GAUGES:
            row = train.setdefault(src, {})
            for s in snap.get("series", []):
                row[name] = float(s.get("value", 0.0))
        elif name in TRAIN_HISTS:
            row = train.setdefault(src, {})
            for s in snap.get("series", []):
                stats = _hist_stats(snap.get("boundaries", []),
                                    s.get("hist", {}))
                # The sharded-checkpoint tag splits save/restore into
                # multiple series; the per-source train row merges
                # them, the Checkpoints section keeps them apart.
                row[name] = _merge_hist_stats(row.get(name), stats)
                if "checkpoint" in name:
                    kind = "save" if "save" in name else "restore"
                    tag = "sharded" if (s.get("tags") or {}).get(
                        "sharded") == "1" else "blob"
                    checkpoints[kind][tag] = _merge_hist_stats(
                        checkpoints[kind].get(tag), stats)
        elif name == "rt_collective_latency_seconds":
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                stats = _hist_stats(snap.get("boundaries", []),
                                    s.get("hist", {}))
                collectives.append({"source": src, **tags, **stats})
        elif name == "rt_collective_bus_bandwidth_bytes_per_sec":
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                for row in collectives:
                    if row.get("source") == src and all(
                            row.get(k) == v for k, v in tags.items()):
                        row["bus_bytes_per_sec"] = float(
                            s.get("value", 0.0))
        elif name == "rt_serve_request_seconds":
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                key = tags.get("deployment", "?")
                # Status-class tagging splits a deployment into
                # several series — merge them back for the per-
                # deployment latency row.
                reqs = serve.setdefault("requests", {})
                reqs[key] = _merge_hist_stats(
                    reqs.get(key),
                    _hist_stats(snap.get("boundaries", []),
                                s.get("hist", {})))
        elif name == "rt_serve_requests_total":
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                dep = tags.get("deployment", "?")
                cls = tags.get("status_class", "?")
                row = serve.setdefault("status_classes",
                                       {}).setdefault(dep, {})
                row[cls] = row.get(cls, 0.0) + float(
                    s.get("value", 0.0))
        elif name == "rt_serve_ttft_seconds":
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                dep = tags.get("deployment", "?")
                ttft = serve.setdefault("ttft", {})
                ttft[dep] = _merge_hist_stats(
                    ttft.get(dep),
                    _hist_stats(snap.get("boundaries", []),
                                s.get("hist", {})))
        elif name == "rt_serve_ttft_phase_seconds":
            for s in snap.get("series", []):
                phase = (s.get("tags") or {}).get("phase", "?")
                ph = serve.setdefault("ttft_phases", {})
                ph[phase] = _merge_hist_stats(
                    ph.get(phase),
                    _hist_stats(snap.get("boundaries", []),
                                s.get("hist", {})))
        elif name == "rt_llm_tpot_seconds":
            for s in snap.get("series", []):
                llm["tpot"] = _merge_hist_stats(
                    llm.get("tpot"),
                    _hist_stats(snap.get("boundaries", []),
                                s.get("hist", {})))
        elif name == "rt_serve_inflight":
            for s in snap.get("series", []):
                serve["inflight"] = serve.get("inflight", 0.0) + float(
                    s.get("value", 0.0))
        elif name in ("rt_serve_retries_total", "rt_serve_shed_total",
                      "rt_serve_deadline_exceeded_total",
                      "rt_serve_queue_depth"):
            key = name.replace("rt_serve_", "").replace("_total", "")
            for s in snap.get("series", []):
                serve[key] = serve.get(key, 0.0) + float(
                    s.get("value", 0.0))
        elif name == "rt_serve_breaker_open":
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                bkey = (f"{tags.get('deployment', '?')}/"
                        f"{tags.get('replica', '?')}")
                cur = serve.setdefault("breakers_open", {})
                cur[bkey] = max(cur.get(bkey, 0.0),
                                float(s.get("value", 0.0)))

    # --- serve resilience stats published by the serve controller
    # (replacement log, merged breaker reports, admission depth).
    try:
        resil = state_api.serve_resilience(address=address)
        if resil.get("deployments"):
            serve["resilience"] = resil["deployments"]
    except Exception:
        pass

    # --- SLO plane: declared objectives (RT_SLO_CONFIG) + the default
    # availability objective, evaluated from the status-class counter
    # history and the latency/TTFT histograms just fetched.
    slo_report: Dict[str, Any] = {}
    try:
        import time as _time

        from . import slo as slo_mod

        objectives, default = slo_mod.objectives_from_env()
        slo_report = slo_mod.evaluate_all(
            objectives, slo_mod.status_series(history),
            now=float(raw.get("ts") or _time.time()),
            latency_p99_ms=slo_mod.latency_p99s(sources),
            ttft_p99_ms=slo_mod.latency_p99s(
                sources, metric=slo_mod.TTFT_METRIC),
            default_spec=default)
    except Exception:
        pass

    # --- per-step time series from the controller's retained history.
    series: Dict[str, List] = {}
    for src, rows in (history or {}).items():
        keep = []
        for ts, vals in rows:
            step_vals = {k: v for k, v in vals.items()
                         if k.startswith("rt_train_")
                         or k.startswith(goodput_mod.GAUGE_NAME)}
            if step_vals:
                keep.append([ts, step_vals])
        if keep:
            series[src] = keep

    # Collective bytes of one program are per-axis sums of its by_op
    # maxima (recomputed after the merge so partial snapshots from
    # several sources cannot double count).
    for prog in xla_programs.values():
        for a in prog["collectives"].values():
            a["bytes"] = sum(a["by_op"].values())

    return {
        "ts": raw.get("ts"),
        "slo": slo_report,
        "xla": {"programs": xla_programs,
                "device_memory": xla_devmem},
        "goodput": goodput_mod.summarize_sources(sources),
        "train": train,
        "train_series": series,
        "collectives": collectives,
        "serve": serve,
        "object_store": object_store,
        "worker_pool": worker_pool,
        "llm": llm,
        "checkpoints": checkpoints,
        "flight": raw.get("flight", []),
    }


def _fmt_rate(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.1f}"


def render_text(summary: Dict[str, Any]) -> str:
    """Human-readable telemetry report for the CLI."""
    lines: List[str] = []
    gp = summary.get("goodput", {})
    lines.append("Goodput "
                 f"(total {gp.get('total_seconds', 0.0):.1f}s across "
                 f"{len(gp.get('per_source', {}))} source(s)):")
    fracs = gp.get("fractions", {})
    if not fracs:
        lines.append("  (no goodput data reported yet)")
    for phase in sorted(fracs, key=lambda p: -fracs[p]):
        lines.append(f"  {phase:<11} {100 * fracs[phase]:6.2f}%  "
                     f"({gp['seconds'][phase]:.2f}s)")
    per_job = gp.get("per_job") or {}
    if per_job:
        lines.append("\nPer-job goodput (who is paying for this "
                     "cluster):")
        for job in sorted(per_job,
                          key=lambda j: -sum(per_job[j].values())):
            phases = per_job[job]
            total = sum(phases.values())
            top = "  ".join(
                f"{p}={s:.1f}s"
                for p, s in sorted(phases.items(), key=lambda kv:
                                   -kv[1]) if s > 0)[:100]
            lines.append(f"  {job:<24} {total:8.1f}s   {top}")

    train = summary.get("train", {})
    xla = summary.get("xla") or {}
    xla_programs = xla.get("programs") or {}
    # Compile seconds per source come from the xprof counters when
    # present (count + cumulative seconds beat the first-step-only
    # rt_train_compile_seconds gauge).
    compile_total = sum(p.get("compile_seconds", 0.0)
                        for p in xla_programs.values())
    compile_count = sum(p.get("compiles", 0.0)
                        for p in xla_programs.values())
    if train or compile_count:
        lines.append("\nTraining:")
        for src in sorted(train):
            row = train[src]
            lines.append(f"  {src}:")
            if "rt_train_step" in row:
                lines.append(f"    step                {row['rt_train_step']:.0f}")
            if "rt_train_tokens_per_sec" in row:
                lines.append("    tokens/sec          "
                             f"{_fmt_rate(row['rt_train_tokens_per_sec'])}")
            if "rt_train_mfu" in row:
                lines.append(f"    MFU                 "
                             f"{100 * row['rt_train_mfu']:.2f}%")
            if "rt_train_achieved_flops_per_sec" in row:
                lines.append(
                    "    achieved FLOP/s     "
                    f"{_fmt_rate(row['rt_train_achieved_flops_per_sec'])}")
            if "rt_train_compile_seconds" in row:
                lines.append(
                    f"    compile             "
                    f"{row['rt_train_compile_seconds']:.2f}s "
                    f"(first step)")
            st = row.get("rt_train_step_time_seconds")
            if st:
                lines.append(f"    step time           mean "
                             f"{st['mean'] * 1e3:.1f}ms  p50≤"
                             f"{st['p50'] * 1e3:.1f}ms  n={st['count']}")
            dw = row.get("rt_train_data_wait_seconds")
            if dw and dw["count"]:
                lines.append(f"    data wait           mean "
                             f"{dw['mean'] * 1e3:.1f}ms  n={dw['count']}")
            for key, label in (
                    ("rt_train_checkpoint_save_seconds", "ckpt save"),
                    ("rt_train_checkpoint_restore_seconds",
                     "ckpt restore")):
                h = row.get(key)
                if h and h["count"]:
                    lines.append(f"    {label:<19} mean "
                                 f"{h['mean'] * 1e3:.1f}ms  n={h['count']}")
        if compile_count:
            lines.append(f"  XLA compiles        {compile_count:.0f} "
                         f"({compile_total:.2f}s total; `rt perf` "
                         f"for per-program detail)")
    devmem = xla.get("device_memory") or {}
    if any(devmem.values()):
        lines.append("\nDevice memory (used/peak/limit):")
        for src in sorted(devmem):
            for dev in sorted(devmem[src]):
                row = devmem[src][dev]
                limit = row.get("limit", 0.0)
                pct = (f"  ({100 * row.get('used', 0.0) / limit:.1f}%"
                       f" used)") if limit else ""
                lines.append(
                    f"  {src} dev{dev}: "
                    f"{_fmt_rate(row.get('used', 0.0))}B / "
                    f"{_fmt_rate(row.get('peak', 0.0))}B / "
                    f"{_fmt_rate(row.get('limit', 0.0))}B{pct}")

    cols = summary.get("collectives", [])
    if cols:
        lines.append("\nCollectives:")
        for row in cols:
            bw = row.get("bus_bytes_per_sec")
            lines.append(
                f"  {row.get('op', '?'):<14} backend={row.get('backend', '?')}"
                f" world={row.get('world', '?')}  n={row['count']}  "
                f"mean {row['mean'] * 1e3:.2f}ms"
                + (f"  busbw {_fmt_rate(bw)}B/s" if bw else ""))

    serve = summary.get("serve", {})
    if serve.get("requests"):
        lines.append("\nServe ingress:")
        for dep, h in sorted(serve["requests"].items()):
            cls = (serve.get("status_classes") or {}).get(dep) or {}
            cls_s = "  ".join(f"{c}={cls[c]:.0f}"
                              for c in sorted(cls)) if cls else ""
            lines.append(f"  {dep:<20} n={h['count']}  mean "
                         f"{h['mean'] * 1e3:.1f}ms  p99≤"
                         f"{h['p99'] * 1e3:.1f}ms"
                         + (f"  [{cls_s}]" if cls_s else ""))
        lines.append(f"  in-flight now: {serve.get('inflight', 0):.0f}")
    if serve.get("ttft") or serve.get("ttft_phases"):
        lines.append("\nServe TTFT (time to first token):")
        for dep, h in sorted((serve.get("ttft") or {}).items()):
            lines.append(f"  {dep:<20} n={h['count']}  p50≤"
                         f"{h['p50'] * 1e3:.1f}ms  p99≤"
                         f"{h['p99'] * 1e3:.1f}ms")
        phases = serve.get("ttft_phases") or {}
        for phase in ("proxy", "admission_queue", "engine_waiting",
                      "prefill"):
            h = phases.get(phase)
            if h and h["count"]:
                lines.append(f"    {phase:<17} mean "
                             f"{h['mean'] * 1e3:.2f}ms  p99≤"
                             f"{h['p99'] * 1e3:.1f}ms  n={h['count']}")
    if serve.get("retries") or serve.get("shed") or \
            serve.get("deadline_exceeded") or serve.get("resilience"):
        lines.append("\nServe resilience:")
        lines.append(f"  failover retries    "
                     f"{serve.get('retries', 0):.0f}")
        lines.append(f"  shed (429)          "
                     f"{serve.get('shed', 0):.0f}")
        lines.append(f"  deadline exceeded   "
                     f"{serve.get('deadline_exceeded', 0):.0f}")
        if serve.get("queue_depth"):
            lines.append(f"  queued now          "
                         f"{serve['queue_depth']:.0f}")
        open_now = sorted(k for k, v in
                          (serve.get("breakers_open") or {}).items()
                          if v >= 1.0)
        if open_now:
            lines.append(f"  open breakers       "
                         f"{', '.join(open_now)}")
        for dep, stats in sorted(
                (serve.get("resilience") or {}).items()):
            reps = stats.get("replacements", [])
            brs = stats.get("breakers", {})
            open_b = sorted(k[:12] for k, v in brs.items()
                            if v.get("state") == "open")
            lines.append(
                f"  {dep:<20} replicas "
                f"{stats.get('replicas', 0)}/"
                f"{stats.get('target', 0)}"
                + (f"  bleeding {stats['draining']}"
                   if stats.get("draining") else "")
                + f"  replaced {len(reps)}"
                + (f"  queue {stats.get('queue_depth', 0)}"
                   if stats.get("queue_depth") else "")
                + (f"  open [{', '.join(open_b)}]" if open_b
                   else ""))

    llm = summary.get("llm") or {}
    if llm.get("kv_pages_total"):
        lines.append("\nLLM engine (continuous batching):")
        used, total = llm["kv_pages_used"], llm["kv_pages_total"]
        lines.append(
            f"  KV pool        {used:.0f} / {total:.0f} pages "
            f"({100 * used / max(total, 1):.1f}% across "
            f"{llm.get('engines', 0)} engine(s))")
        lines.append(f"  batch now      {llm.get('batch_size', 0):.0f} "
                     f"decoding, {llm.get('waiting', 0):.0f} waiting")
        lines.append(f"  tokens out     {llm.get('tokens', 0):.0f}  "
                     f"(prefilled {llm.get('prefill_tokens', 0):.0f})")
        if llm.get("evictions"):
            lines.append(f"  evictions      {llm['evictions']:.0f} "
                         "(KV-pressure recompute preemptions)")
        tpot = llm.get("tpot")
        if isinstance(tpot, dict) and tpot.get("count"):
            lines.append(f"  TPOT           mean "
                         f"{tpot['mean'] * 1e3:.2f}ms  p99≤"
                         f"{tpot['p99'] * 1e3:.1f}ms "
                         f"(inter-token, n={tpot['count']})")

    ck = summary.get("checkpoints") or {}
    if ck.get("bytes") or ck.get("save") or ck.get("restore"):
        lines.append("\nCheckpoints:")
        if ck.get("bytes") or ck.get("shards"):
            lines.append(
                f"  last save     {_fmt_rate(ck.get('bytes', 0.0))}B "
                f"in {ck.get('shards', 0):.0f} shard file(s) "
                f"(summed across writers)")
        for kind in ("save", "restore"):
            for tag in sorted(ck.get(kind) or {}):
                h = ck[kind][tag]
                if not h.get("count"):
                    continue
                lines.append(
                    f"  {kind:<7} {tag:<8} n={h['count']}  mean "
                    f"{h['mean'] * 1e3:.1f}ms  "
                    f"p99≤{h['p99'] * 1e3:.1f}ms")

    pool = summary.get("worker_pool") or {}
    if pool.get("target") or pool.get("adoptions") \
            or pool.get("cold_spawns") or pool.get("events_dropped"):
        lines.append("\nWorker pool (control-plane fast path):")
        lines.append(f"  warm idle     {pool.get('idle', 0):.0f} / "
                     f"{pool.get('target', 0):.0f} target")
        lines.append(f"  adoptions     {pool.get('adoptions', 0):.0f}")
        lines.append(f"  cold spawns   "
                     f"{pool.get('cold_spawns', 0):.0f}")
        if pool.get("events_dropped"):
            # Nonzero means the observability plane is lossy under
            # this load — `rt explain` chains may have gaps.
            lines.append(f"  task events dropped  "
                         f"{pool.get('events_dropped', 0):.0f}")
        for phase in ("spawn", "import", "connect", "adopt"):
            h = (pool.get("startup") or {}).get(phase)
            if h and h["count"]:
                lines.append(
                    f"  {phase:<12}  mean {h['mean'] * 1e3:.1f}ms  "
                    f"p50≤{h['p50'] * 1e3:.1f}ms  "
                    f"p99≤{h['p99'] * 1e3:.1f}ms  n={h['count']}")

    objs = summary.get("object_store") or {}
    if any(objs.values()):
        lines.append("\nObject store:")
        lines.append(f"  spilled now   {_fmt_rate(objs['spilled_bytes'])}B")
        lines.append(f"  spills total  {objs['spill_total']:.0f}")
        lines.append(f"  restores      {objs['restore_total']:.0f}")

    slo_rows = (summary.get("slo") or {}).get("objectives") or []
    if slo_rows:
        from . import slo as slo_mod

        # Reuse the SLO renderer's rows under a section header.
        body = slo_mod.render_text(summary["slo"]).splitlines()
        lines.append("\nSLOs:")
        lines.extend(body[1:])

    flights = summary.get("flight", [])
    if flights:
        lines.append("\nFlight recorder dumps:")
        for d in flights:
            last = (d.get("sticky") or {}).get("last_task") or {}
            lines.append(f"  {d.get('source', '?')}  "
                         f"reason={d.get('reason', '?')!r}  "
                         f"events={len(d.get('events', []))}"
                         + (f"  last_task={last.get('name')}"
                            f"[{last.get('state')}]" if last else "")
                         + (f"  path={d['path']}" if d.get("path")
                            else ""))
    return "\n".join(lines) + "\n"
