"""Job submission in the port against the JAX package's.

tests/test_job.py's programs run through both packages' job APIs
(``JobSubmissionClient``), one cluster per package, JAX's first: a job
that succeeds with stdout and stderr in its logs, one that fails with
its exit code, one stopped while it runs, env vars and metadata through
``runtime_env``, a duplicate id rejected, an unknown id, and a job that
outlives the process that submitted it.  The statuses, messages, logs
and errors must be equal.  The supervisor leases no accelerator, so the
entrypoint's ``CUDA_VISIBLE_DEVICES`` (JAX: ``TPU_VISIBLE_CHIPS``) is
empty in both; a port entrypoint that is a driver reaches a GPU only
through a ``num_gpus`` lease.  Then both CLIs: ``rt job submit
--wait``, ``status``, ``logs``, ``list``, ``stop`` and ``rt logs
--job`` on a head started with ``rt start``.
"""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _statuses(client, job_id, timeout=60):
    """Every status seen until a terminal one, repeats dropped."""
    seen = []
    deadline = time.time() + timeout
    while True:
        st = client.get_job_status(job_id)
        if not seen or seen[-1] != st.status:
            seen.append(st.status)
        if st.is_terminal or time.time() > deadline:
            return seen, st
        time.sleep(0.1)


def _programs(pkg: str, root: Path) -> dict:
    import importlib

    rt = importlib.import_module(pkg)
    JobSubmissionClient = importlib.import_module(
        f"{pkg}.job").JobSubmissionClient
    var = "TPU_VISIBLE_CHIPS" if pkg == "ray_tpu" else \
        "CUDA_VISIBLE_DEVICES"
    out = {}
    handle = rt.init(mode="cluster", num_cpus=2)
    try:
        client = JobSubmissionClient()
        jid = client.submit_job(
            entrypoint="echo hello-from-job && echo line2 >&2 && sleep 1")
        seen, st = _statuses(client, jid)
        logs = client.get_job_logs(jid)
        out["succeed"] = (seen[-2:], st.status, st.message,
                          "hello-from-job" in logs, "line2" in logs,
                          any(j.job_id == jid for j in client.list_jobs()))

        jid = client.submit_job(entrypoint="echo boom; exit 3")
        st = client.wait_until_finished(jid, timeout=60)
        out["fail"] = (st.status, st.message,
                       "boom" in client.get_job_logs(jid))

        jid = client.submit_job(entrypoint="sleep 60")
        deadline = time.time() + 30
        while client.get_job_status(jid).status == "PENDING":
            assert time.time() < deadline
            time.sleep(0.1)
        stopped = client.stop_job(jid)
        seen, st = _statuses(client, jid, timeout=30)
        # RUNNING may or may not be seen again before STOPPED.
        assert set(seen) <= {"RUNNING", "STOPPED"}
        out["stop"] = (stopped, seen[-1], st.status, st.message,
                       client.stop_job(jid))

        jid = client.submit_job(
            entrypoint=f'echo "flavor=$JOBTEST_FLAVOR [${var}]"',
            runtime_env={"env_vars": {"JOBTEST_FLAVOR": "vanilla"}},
            metadata={"owner": "tests"})
        st = client.wait_until_finished(jid, timeout=90)
        out["env_meta"] = (st.status, client.get_job_logs(jid).strip(),
                           st.metadata, st.entrypoint.replace(var, "VAR"))

        jid = client.submit_job(entrypoint="true",
                                submission_id="job-dup-test")
        client.wait_until_finished(jid, timeout=60)
        with pytest.raises(ValueError) as ei:
            client.submit_job(entrypoint="true",
                              submission_id="job-dup-test")
        out["duplicate"] = str(ei.value)
        with pytest.raises(ValueError) as ei:
            client.submit_job(entrypoint="true", submission_id="a/b")
        out["bad_id"] = str(ei.value)
        with pytest.raises(KeyError) as ei:
            client.get_job_status("job-nope")
        out["unknown"] = str(ei.value)

        # A short-lived process submits; this one reads the result.
        code = (f"import {pkg} as rt\n"
                f"from {pkg}.job import JobSubmissionClient\n"
                f"rt.init(address={handle.controller_addr!r})\n"
                "print(JobSubmissionClient().submit_job(entrypoint="
                "'sleep 1; echo survived', submission_id='job-detach'))\n")
        res = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
        st = client.wait_until_finished("job-detach", timeout=60)
        out["detach"] = ("job-detach" in res.stdout, st.status,
                         "survived" in client.get_job_logs("job-detach"))
        out["listed"] = sorted(j.status for j in client.list_jobs())
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    saved = os.environ.get("RT_SESSION_DIR_ROOT")
    out = {}
    try:
        for pkg in PACKAGES:
            os.environ["RT_SESSION_DIR_ROOT"] = str(
                tmp_path_factory.mktemp(pkg))
            out[pkg] = _programs(pkg, ROOT)
    finally:
        if saved is None:
            os.environ.pop("RT_SESSION_DIR_ROOT", None)
        else:
            os.environ["RT_SESSION_DIR_ROOT"] = saved
    return out


@pytest.mark.parametrize("key", ["succeed", "fail", "stop", "env_meta",
                                 "duplicate", "bad_id", "unknown",
                                 "detach", "listed"])
def test_job_programs_match_jax(programs, key):
    assert programs["ray_tpu_torch"][key] == programs["ray_tpu"][key]


def test_job_program_values(programs):
    port = programs["ray_tpu_torch"]
    assert port["succeed"] == (["RUNNING", "SUCCEEDED"], "SUCCEEDED", "",
                               True, True, True)
    assert port["fail"] == ("FAILED", "entrypoint exited with 3", True)
    assert port["stop"][:3] == (True, "STOPPED", "STOPPED")
    assert port["stop"][3].startswith("stopped by user")
    assert port["stop"][4] is False     # already finished
    assert port["env_meta"][:3] == ("SUCCEEDED", "flavor=vanilla []",
                                    {"owner": "tests"})
    assert port["duplicate"] == "job 'job-dup-test' already exists"
    assert port["detach"] == (True, "SUCCEEDED", True)


DRIVER_ENTRY = r"""
import os
import ray_tpu_torch as rt
print("entrypoint CUDA_VISIBLE_DEVICES=[%s]"
      % os.environ.get("CUDA_VISIBLE_DEVICES"))
rt.init(address="auto")

@rt.remote(num_gpus=1)
def on_gpu():
    return os.environ.get("CUDA_VISIBLE_DEVICES")

print("leased CUDA_VISIBLE_DEVICES=[%s]" % rt.get(on_gpu.remote(),
                                                   timeout=120))
"""


def _cli_flow(pkg: str, root: Path) -> dict:
    env = dict(os.environ, RT_SESSION_DIR_ROOT=str(root),
               PYTHONPATH=str(ROOT))
    env.pop("RT_ADDRESS", None)
    acc = "--num-tpus" if pkg == "ray_tpu" else "--num-gpus"

    def rt(*args, timeout=120):
        r = subprocess.run([sys.executable, "-m", pkg, *args],
                           capture_output=True, text=True, env=env,
                           timeout=timeout, cwd=root)
        return r.returncode, re.sub(r"job-[0-9a-f]{12}", "JOB", r.stdout)

    out = {}
    rc, _ = rt("start", "--head", "--port", "0", "--num-cpus", "2", acc, "1")
    assert rc == 0
    try:
        out["submit"] = rt("job", "submit", "--wait", "--id", "job-a",
                           "--", "echo", "hi", "&&", "echo", "there")
        out["status"] = rt("job", "status", "job-a")
        out["logs"] = rt("job", "logs", "job-a")
        out["logs_job"] = rt("logs", "--job", "job-a")
        out["failed"] = rt("job", "submit", "--wait", "--id", "job-b",
                           "--", "exit", "4")
        out["status_failed"] = rt("job", "status", "job-b")
        out["long"] = rt("job", "submit", "--id", "job-c", "--",
                         "sleep", "600")
        deadline = time.time() + 30
        while "RUNNING" not in rt("job", "status", "job-c")[1]:
            assert time.time() < deadline
            time.sleep(0.2)
        out["stop"] = rt("job", "stop", "job-c")
        deadline = time.time() + 30
        while "STOPPED" not in rt("job", "status", "job-c")[1]:
            assert time.time() < deadline
            time.sleep(0.2)
        out["list"] = rt("job", "list")
        out["unknown"] = rt("job", "status", "job-nope")
        out["bad_env"] = rt("job", "submit", "--env", "NOEQUALS", "--",
                            "true")
        if pkg == "ray_tpu_torch":
            entry = root / "entry.py"
            entry.write_text(DRIVER_ENTRY)
            out["driver"] = rt("job", "submit", "--wait", "--", sys.executable,
                               str(entry), timeout=240)
    finally:
        rt("stop")
    return out


@pytest.fixture(scope="module")
def cli_flows(tmp_path_factory):
    return {pkg: _cli_flow(pkg, tmp_path_factory.mktemp(f"cli_{pkg}"))
            for pkg in PACKAGES}


@pytest.mark.parametrize("key", ["submit", "status", "logs", "logs_job",
                                 "failed", "status_failed", "long", "stop",
                                 "list", "unknown", "bad_env"])
def test_job_cli_matches_jax(cli_flows, key):
    assert cli_flows["ray_tpu_torch"][key] == cli_flows["ray_tpu"][key]


def test_job_cli_values(cli_flows):
    port = cli_flows["ray_tpu_torch"]
    assert port["submit"] == (0, "Submitted job-a\nhi\nthere\n"
                                 "Job job-a: SUCCEEDED \n")
    assert port["logs"] == port["logs_job"] == (0, "hi\nthere\n")
    assert port["failed"][0] == 1 and "FAILED" in port["failed"][1]
    assert port["stop"] == (0, "stopped\n")
    assert port["list"][1].count("\n") == 3
    assert port["unknown"][0] == 1


def test_cpu_leased_entrypoint_reaches_the_gpu_only_through_a_lease(
        cli_flows):
    """The entrypoint runs in the supervisor's CPU-leased worker's
    environment: CUDA_VISIBLE_DEVICES is empty there, and its
    ``num_gpus=1`` task gets GPU id 0 of the head's one GPU."""
    rc, text = cli_flows["ray_tpu_torch"]["driver"]
    assert rc == 0, text
    assert "entrypoint CUDA_VISIBLE_DEVICES=[]" in text
    assert "leased CUDA_VISIBLE_DEVICES=[0]" in text
    assert "SUCCEEDED" in text
