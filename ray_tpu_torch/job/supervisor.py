"""The per-job supervisor actor: runs the entrypoint, streams logs.

Role-equivalent to the reference's JobSupervisor (ref:
dashboard/modules/job/job_supervisor.py:54): one detached actor per job
runs the entrypoint as a subprocess, publishes status transitions and a
bounded log tail into the controller KV, and serves stop requests.
"""

from __future__ import annotations

import atexit
import os
import signal
import subprocess
import threading
import time

_LOG_CAP = 2 * 1024 * 1024  # keep at most this much log in the KV


class JobSupervisor:
    """Detached actor; one instance per submitted job."""

    def __init__(self, job_id: str, entrypoint: str,
                 metadata: dict | None = None,
                 priority: int = 0,
                 quota: dict | None = None):
        from ray_tpu_torch.core import runtime as _rt

        self.job_id = job_id
        self.entrypoint = entrypoint
        self.metadata = metadata or {}
        self.priority = int(priority or 0)
        self.quota = dict(quota) if quota else None
        self._rt = _rt.get_runtime()
        self._proc: subprocess.Popen | None = None
        self._stopped = False
        self._log_buf = bytearray()
        self._log_lock = threading.Lock()
        # Register the multi-tenant metadata BEFORE the first status
        # write (and long before the entrypoint spawns), so admission
        # and quota decisions never race the job's first lease/gang
        # request.
        self._rt.controller_call("job_register", {
            "job_id": job_id, "priority": self.priority,
            "quota": self.quota, "entrypoint": entrypoint,
            "ts": time.time()})
        self._set_status("PENDING")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        # Best-effort orphan control: if this worker exits cleanly while
        # the entrypoint is still running, take the process group down
        # (a SIGKILLed supervisor can still orphan it — the reference
        # has the same gap, mitigated by its job monitor loop; our
        # client marks such jobs FAILED when the actor is gone).
        atexit.register(self._kill_pg)

    # ------------------------------------------------------------ kv state
    def _kv(self, suffix: str, value: bytes) -> None:
        self._rt.controller_call(
            "kv_put", {"key": f"job/{self.job_id}/{suffix}",
                       "value": value})

    def _set_status(self, status: str, message: str = "") -> None:
        import json

        self._kv("status", json.dumps({
            "status": status, "message": message,
            "entrypoint": self.entrypoint, "metadata": self.metadata,
            "priority": self.priority, "quota": self.quota,
            "ts": time.time()}).encode())

    def _push_logs(self) -> None:
        with self._log_lock:
            data = bytes(self._log_buf)
        self._kv("logs", data)

    def _kill_pg(self) -> None:
        proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    # ------------------------------------------------------------- running
    def _run(self) -> None:
        try:
            self._run_inner()
        except Exception as e:  # noqa: BLE001 — job must reach terminal
            try:
                self._kill_pg()
                self._set_status("FAILED", f"supervisor error: {e!r}")
            except Exception:
                pass

    def _run_inner(self) -> None:
        if self._stopped:
            self._set_status("STOPPED", "stopped before start")
            return
        # The entrypoint inherits this worker's environment.  The
        # supervisor leases no GPU (``num_cpus`` only), so its worker's
        # CUDA_VISIBLE_DEVICES is empty and an entrypoint that is a
        # driver reaches the card only through leases (``num_gpus``
        # actors and tasks), as the JAX supervisor leases no chip.
        env = dict(os.environ)
        env["RT_JOB_ID"] = self.job_id
        # The entrypoint's gangs compete for admission at the job's
        # priority (placement_group() reads this by default).
        env["RT_JOB_PRIORITY"] = str(self.priority)
        try:
            self._proc = subprocess.Popen(
                self.entrypoint, shell=True, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                start_new_session=True)
        except OSError as e:
            self._set_status("FAILED", f"failed to spawn: {e}")
            return
        if self._stopped:
            # stop() raced the spawn: it saw _proc None, so enforce here.
            self._kill_pg()
        self._set_status("RUNNING")
        last_push = 0.0
        assert self._proc.stdout is not None
        for line in self._proc.stdout:
            with self._log_lock:
                self._log_buf += line
                overflow = len(self._log_buf) - _LOG_CAP
                if overflow > 0:
                    del self._log_buf[:overflow]
            now = time.time()
            if now - last_push > 0.5:
                last_push = now
                self._push_logs()
        rc = self._proc.wait()
        self._push_logs()
        if self._stopped:
            self._set_status("STOPPED", f"stopped by user (rc={rc})")
        elif rc == 0:
            self._set_status("SUCCEEDED")
        else:
            self._set_status("FAILED", f"entrypoint exited with {rc}")

    # ------------------------------------------------------------- methods
    def ping(self) -> bool:
        return True

    def stop(self) -> bool:
        """SIGTERM the entrypoint's process group; SIGKILL after 3 s.
        Returns True when the job will not (or no longer) run."""
        self._stopped = True
        proc = self._proc
        if proc is None:
            return True  # pre-spawn: _run_inner honors the flag
        if proc.poll() is not None:
            return False  # already finished; terminal status stands
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return False

        def _enforce():
            time.sleep(3)
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

        threading.Thread(target=_enforce, daemon=True).start()
        return True

    def wait(self, timeout: float = 0) -> bool:
        """True once the entrypoint finished."""
        self._thread.join(timeout or None)
        return not self._thread.is_alive()
