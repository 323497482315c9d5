"""Job submission client.

Role-equivalent to the reference's JobSubmissionClient (ref:
python/ray/job_submission/sdk.py + dashboard/modules/job/job_manager.py
submit_job:422): submit an entrypoint, poll status, fetch logs, stop.
Submission creates the detached supervisor through the normal actor
path; the read-side endpoints only need the controller KV, so they work
from any process that can reach the controller.
"""

from __future__ import annotations

import json
import re
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

TERMINAL = ("SUCCEEDED", "FAILED", "STOPPED")


@dataclass
class JobStatus:
    job_id: str
    status: str
    message: str = ""
    entrypoint: str = ""
    metadata: Optional[Dict[str, Any]] = None
    ts: float = 0.0
    priority: int = 0
    quota: Optional[Dict[str, float]] = None

    @property
    def is_terminal(self) -> bool:
        return self.status in TERMINAL


class JobSubmissionClient:
    def __init__(self, address: Optional[str] = None):
        from ..core import runtime as runtime_mod

        rt = runtime_mod.get_runtime_quiet()
        if rt is None or not hasattr(rt, "controller_call"):
            import ray_tpu_torch

            rt = ray_tpu_torch.init(address=address or "auto")
        self._rt = rt

    # ------------------------------------------------------------- submit
    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   metadata: Optional[Dict[str, Any]] = None,
                   num_cpus: float = 0,
                   priority: int = 0,
                   quota: Optional[Dict[str, float]] = None) -> str:
        """Start ``entrypoint`` under a detached supervisor actor;
        returns the job id immediately.

        ``priority`` (int, default 0, higher wins) orders gang
        admission across jobs, and a higher-priority job may preempt
        a lower one's gangs when the cluster is full.  ``quota``
        optionally caps the job's total resource footprint (e.g.
        ``{"CPU": 4}``); over-quota lease/gang requests wait until the
        job's own usage drops."""
        import ray_tpu_torch

        from .supervisor import JobSupervisor

        job_id = submission_id or f"job-{uuid.uuid4().hex[:12]}"
        if not re.fullmatch(r"[A-Za-z0-9_.-]{1,128}", job_id):
            raise ValueError(
                f"invalid submission_id {job_id!r}: use letters, digits, "
                f"'_', '-', '.' (it becomes a KV key segment)")
        priority = int(priority)
        if quota is not None:
            if not isinstance(quota, dict) or not quota:
                raise ValueError(f"quota must be a non-empty dict of "
                                 f"resource caps, got {quota!r}")
            bad = {k: v for k, v in quota.items()
                   if not isinstance(k, str)
                   or not isinstance(v, (int, float)) or v <= 0}
            if bad:
                raise ValueError(f"invalid quota entries {bad!r}: "
                                 f"caps must be positive numbers")
            quota = {k: float(v) for k, v in quota.items()}
        existing = self._status_raw(job_id)
        if existing is not None:
            raise ValueError(f"job {job_id!r} already exists")
        opts: Dict[str, Any] = {
            "name": f"_job:{job_id}", "lifetime": "detached",
            "num_cpus": num_cpus,
            # ping()/stop() must stay serviceable while a blocking
            # wait() call occupies one slot.
            "max_concurrency": 4,
        }
        if runtime_env:
            opts["runtime_env"] = runtime_env
        actor_cls = ray_tpu_torch.remote(JobSupervisor)
        actor = actor_cls.options(**opts).remote(
            job_id, entrypoint, metadata, priority, quota)
        # Surface scheduling failures at submit time: the supervisor
        # writes PENDING from __init__, so a ping proves liveness.
        ray_tpu_torch.get(actor.ping.remote(), timeout=120)
        return job_id

    # -------------------------------------------------------------- reads
    def _status_raw(self, job_id: str) -> Optional[Dict]:
        raw = self._rt.controller_call(
            "kv_get", {"key": f"job/{job_id}/status"})
        return json.loads(raw) if raw else None

    def get_job_status(self, job_id: str) -> JobStatus:
        raw = self._status_raw(job_id)
        if raw is None:
            raise KeyError(f"no such job: {job_id}")
        if raw["status"] in ("PENDING", "RUNNING") \
                and not self._supervisor_alive(job_id):
            # Supervisor might be dead — but a single missed ping can be
            # load, not death (and a FAILED write is visible to every
            # observer).  Require repeated failures over a real window
            # before declaring it (ref: job_manager.py _monitor_job).
            fails = getattr(self, "_liveness_fails", None)
            if fails is None:
                fails = self._liveness_fails = {}
            count, first = fails.get(job_id, (0, time.time()))
            count += 1
            fails[job_id] = (count, first)
            if count >= 3 and time.time() - first >= 10.0:
                raw = {**raw, "status": "FAILED",
                       "message": "job supervisor died"}
                self._rt.controller_call("kv_put", {
                    "key": f"job/{job_id}/status",
                    "value": json.dumps(raw).encode()})
                fails.pop(job_id, None)
        else:
            getattr(self, "_liveness_fails", {}).pop(job_id, None)
        return JobStatus(job_id=job_id, status=raw["status"],
                         message=raw.get("message", ""),
                         entrypoint=raw.get("entrypoint", ""),
                         metadata=raw.get("metadata"),
                         ts=raw.get("ts", 0.0),
                         priority=raw.get("priority", 0),
                         quota=raw.get("quota"))

    def _supervisor_alive(self, job_id: str) -> bool:
        import ray_tpu_torch

        try:
            actor = ray_tpu_torch.get_actor(f"_job:{job_id}")
            return bool(ray_tpu_torch.get(actor.ping.remote(), timeout=15))
        except Exception:
            return False

    def get_job_logs(self, job_id: str) -> str:
        raw = self._rt.controller_call(
            "kv_get", {"key": f"job/{job_id}/logs"})
        if raw is None and self._status_raw(job_id) is None:
            raise KeyError(f"no such job: {job_id}")
        return (raw or b"").decode(errors="replace")

    def list_jobs(self) -> List[JobStatus]:
        keys = self._rt.controller_call(
            "kv_keys", {"prefix": "job/"})
        out = []
        for key in keys:
            if not key.endswith("/status"):
                continue
            job_id = key.split("/", 2)[1]
            try:
                out.append(self.get_job_status(job_id))
            except KeyError:
                continue
        return sorted(out, key=lambda s: s.ts)

    # ------------------------------------------------------------ control
    def stop_job(self, job_id: str) -> bool:
        import ray_tpu_torch

        self.get_job_status(job_id)  # raises if unknown
        try:
            actor = ray_tpu_torch.get_actor(f"_job:{job_id}")
            return ray_tpu_torch.get(actor.stop.remote(), timeout=30)
        except Exception:
            return False

    def wait_until_finished(self, job_id: str, timeout: float = 300,
                            poll_s: float = 0.5) -> JobStatus:
        deadline = time.time() + timeout
        while True:
            st = self.get_job_status(job_id)
            if st.is_terminal:
                return st
            if time.time() > deadline:
                raise TimeoutError(
                    f"job {job_id} still {st.status} after {timeout}s")
            time.sleep(poll_s)
