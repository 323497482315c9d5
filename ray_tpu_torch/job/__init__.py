"""Job submission: run an entrypoint command on a running cluster.

Role-equivalent to the reference's job submission stack (ref:
dashboard/modules/job/job_manager.py:59 JobManager, submit_job:422,
job_supervisor.py:54 per-job supervisor actor, python/ray/job_submission/
client API).  Redesigned without the dashboard: the supervisor is a
detached actor scheduled through the normal actor path, job state lives
in the controller KV, and the client talks straight to the controller —
one control plane instead of a REST sidecar.
"""

from .client import JobStatus, JobSubmissionClient  # noqa
