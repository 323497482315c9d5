"""Command runners: how the launcher reaches a machine.

Role-equivalent to the reference's command runner stack (ref:
python/ray/autoscaler/_private/command_runner.py SSHCommandRunner and
autoscaler/_private/gcp/tpu_command_runner.py TPUCommandRunner): a
narrow run/put interface the provider and `rt up` bootstrap drive, with
an SSH implementation for real machines, a subprocess implementation
for hermetic tests (same contract, localhost execution), and a pod
runner that fans every call out to all hosts of a multi-host slice in
parallel — commands land on every host, as the reference treats one
TPU pod as one logical node.
"""

from __future__ import annotations

import abc
import os
import shlex
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence


class CommandRunnerError(RuntimeError):
    def __init__(self, host: str, cmd: str, returncode: int,
                 output: str):
        super().__init__(
            f"[{host}] command failed (exit {returncode}): {cmd}\n"
            f"{output[-2000:]}")
        self.host = host
        self.cmd = cmd
        self.returncode = returncode
        self.output = output


class CommandRunner(abc.ABC):
    """run() a shell command on the target and put() files onto it."""

    host: str

    @abc.abstractmethod
    def run(self, cmd: str, *, env: Optional[Dict[str, str]] = None,
            timeout: float = 300.0, check: bool = True) -> str:
        """Execute ``cmd`` in a shell on the target; returns combined
        stdout+stderr.  Raises CommandRunnerError when check and the
        exit status is non-zero."""

    @abc.abstractmethod
    def put(self, local_path: str, remote_path: str) -> None:
        """Copy a local file or directory tree onto the target."""

    def run_background(self, cmd: str,
                       env: Optional[Dict[str, str]] = None,
                       log_file: str = "/tmp/rt_launch.log") -> None:
        """Start ``cmd`` on the target detached from this connection
        (nohup): used for long-lived daemons like the autoscaler."""
        wrapped = (f"nohup sh -c {shlex.quote(cmd)} "
                   f">> {shlex.quote(log_file)} 2>&1 < /dev/null &")
        self.run(wrapped, env=env, timeout=60.0)


def _env_prefix(env: Optional[Dict[str, str]]) -> str:
    if not env:
        return ""
    return " ".join(f"{k}={shlex.quote(v)}" for k, v in
                    sorted(env.items())) + " "


class SubprocessCommandRunner(CommandRunner):
    """Hermetic runner: the "remote machine" is this host.

    Same contract as SSH (shell string in, output out; put copies
    files) so `rt up`, the provider, and the autoscaler can be tested
    end-to-end with no sshd — the fake-multi-node pattern applied to
    the launcher (ref: autoscaler/_private/fake_multi_node/).
    """

    def __init__(self, host: str = "localhost",
                 base_env: Optional[Dict[str, str]] = None):
        self.host = host
        self._base_env = dict(base_env or {})

    def run(self, cmd: str, *, env: Optional[Dict[str, str]] = None,
            timeout: float = 300.0, check: bool = True) -> str:
        full_env = {**os.environ, **self._base_env, **(env or {})}
        proc = subprocess.run(
            ["sh", "-c", cmd], env=full_env, timeout=timeout,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if check and proc.returncode != 0:
            raise CommandRunnerError(self.host, cmd, proc.returncode,
                                     proc.stdout)
        return proc.stdout

    def put(self, local_path: str, remote_path: str) -> None:
        # "Remote" is this host: the head may share session paths with
        # the launcher (e.g. the cluster state file), so copying a file
        # onto itself must be a no-op, not a SameFileError.
        if os.path.abspath(local_path) == os.path.abspath(remote_path):
            return
        os.makedirs(os.path.dirname(remote_path) or "/", exist_ok=True)
        if os.path.isdir(local_path):
            shutil.copytree(local_path, remote_path,
                            dirs_exist_ok=True)
        else:
            shutil.copy2(local_path, remote_path)


class SSHCommandRunner(CommandRunner):
    """Reaches a real machine over ssh/scp (ref: SSHCommandRunner,
    command_runner.py — options trimmed to the ones the launcher
    needs: user, key, port, connect timeout, known-hosts off)."""

    SSH_OPTS = ["-o", "StrictHostKeyChecking=no",
                "-o", "UserKnownHostsFile=/dev/null",
                "-o", "LogLevel=ERROR",
                "-o", "ServerAliveInterval=15",
                "-o", "ServerAliveCountMax=4"]

    def __init__(self, host: str, *, user: Optional[str] = None,
                 key_file: Optional[str] = None, port: int = 22,
                 connect_timeout_s: int = 15):
        self.host = host
        self.user = user
        self.key_file = key_file
        self.port = port
        self.connect_timeout_s = connect_timeout_s

    def _target(self) -> str:
        return f"{self.user}@{self.host}" if self.user else self.host

    def _ssh_base(self) -> List[str]:
        cmd = ["ssh", *self.SSH_OPTS,
               "-o", f"ConnectTimeout={self.connect_timeout_s}",
               "-p", str(self.port)]
        if self.key_file:
            cmd += ["-i", os.path.expanduser(self.key_file)]
        return cmd

    def run(self, cmd: str, *, env: Optional[Dict[str, str]] = None,
            timeout: float = 300.0, check: bool = True) -> str:
        remote = _env_prefix(env) + cmd
        argv = self._ssh_base() + [self._target(), remote]
        proc = subprocess.run(argv, timeout=timeout,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if check and proc.returncode != 0:
            raise CommandRunnerError(self.host, cmd, proc.returncode,
                                     proc.stdout)
        return proc.stdout

    def put(self, local_path: str, remote_path: str) -> None:
        # rsync if available (delta sync, like the reference's
        # rsync_up); scp -r otherwise.  Neither creates missing parent
        # directories on the target, so make them first.  A leading ~/
        # must stay OUTSIDE the quotes or the remote shell won't expand
        # it (and mkdir would create a literal '~' directory).
        parent = os.path.dirname(remote_path.rstrip("/"))
        if parent and parent not in ("/", "~"):
            if parent.startswith("~/"):
                quoted = "~/" + shlex.quote(parent[2:])
            else:
                quoted = shlex.quote(parent)
            self.run(f"mkdir -p {quoted}", timeout=60.0)
        if shutil.which("rsync"):
            ssh_cmd = " ".join(self._ssh_base())
            src = local_path + ("/" if os.path.isdir(local_path)
                                else "")
            argv = ["rsync", "-az", "-e", ssh_cmd, src,
                    f"{self._target()}:{remote_path}"]
        else:
            argv = (["scp", *self.SSH_OPTS, "-P", str(self.port)]
                    + (["-i", os.path.expanduser(self.key_file)]
                       if self.key_file else [])
                    + (["-r"] if os.path.isdir(local_path) else [])
                    + [local_path, f"{self._target()}:{remote_path}"])
        proc = subprocess.run(argv, timeout=600,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise CommandRunnerError(self.host, " ".join(argv),
                                     proc.returncode, proc.stdout)


class PodCommandRunner(CommandRunner):
    """Fans run/put out to every host of a slice in parallel.

    Ref: autoscaler/_private/gcp/tpu_command_runner.py — the reference
    treats a TPU pod as one node whose commands execute on all its
    VM hosts; per-host failures surface as one aggregate error."""

    def __init__(self, runners: Sequence[CommandRunner]):
        if not runners:
            raise ValueError("pod needs at least one host runner")
        self.runners = list(runners)
        self.host = ",".join(r.host for r in runners)

    def run(self, cmd: str, *, env: Optional[Dict[str, str]] = None,
            timeout: float = 300.0, check: bool = True) -> str:
        return "\n".join(self.run_per_host(cmd, env=env,
                                           timeout=timeout,
                                           check=check))

    def run_per_host(self, cmd: str, *,
                     env: Optional[Dict[str, str]] = None,
                     per_host_env: Optional[
                         Sequence[Dict[str, str]]] = None,
                     timeout: float = 300.0,
                     check: bool = True) -> List[str]:
        """run() on all hosts concurrently; returns per-host outputs in
        host order.  ``per_host_env`` adds rank-specific variables
        (e.g. the host's index in its slice) on top of ``env``."""
        def _one(i: int) -> str:
            merged = dict(env or {})
            if per_host_env is not None:
                merged.update(per_host_env[i])
            return self.runners[i].run(cmd, env=merged or None,
                                       timeout=timeout, check=check)

        with ThreadPoolExecutor(len(self.runners)) as pool:
            futs = [pool.submit(_one, i)
                    for i in range(len(self.runners))]
            outs, errors = [], []
            for i, f in enumerate(futs):
                try:
                    outs.append(f.result())
                except Exception as e:  # noqa: BLE001 — aggregate
                    errors.append((self.runners[i].host, e))
                    outs.append("")
            if errors:
                if len(errors) == 1:
                    raise errors[0][1]
                # CommandRunnerError keeps only the last 2000 message
                # chars.  Show as many hosts as fit (each line budgeted
                # including its '--- host: Type: ' prefix); past ~12
                # failing hosts, elide the middle EXPLICITLY rather than
                # letting truncation silently cut the earliest ones.
                # The full exception list rides on agg.errors.
                shown = errors
                elided = 0
                if len(errors) > 12:
                    shown = errors[:6] + errors[-6:]
                    elided = len(errors) - 12
                per_host = max(64, 1800 // len(shown) - 80)
                lines = [f"--- {host}: {type(e).__name__}: "
                         + str(e)[-per_host:] for host, e in shown]
                if elided:
                    lines.insert(6, f"--- ... {elided} more failing "
                                    f"hosts elided (see .errors) ...")
                agg = CommandRunnerError(
                    self.host, cmd, -1,
                    f"{len(errors)}/{len(self.runners)} hosts failed:\n"
                    + "\n".join(lines))
                agg.errors = [e for _, e in errors]
                raise agg
            return outs

    def put(self, local_path: str, remote_path: str) -> None:
        with ThreadPoolExecutor(len(self.runners)) as pool:
            futs = [pool.submit(r.put, local_path, remote_path)
                    for r in self.runners]
            for f in futs:
                f.result()
