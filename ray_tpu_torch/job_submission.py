"""Job submission: run driver scripts as supervised cluster jobs (port of
ray_tpu/job_submission.py).

The supervisor Popens the entrypoint with its own worker's environment,
as the reference's does. A supervisor holds no GPU lease, so that
environment carries ``CUDA_VISIBLE_DEVICES=""`` (the reference's
entrypoint inherits ``JAX_PLATFORMS=cpu`` the same way): a job reaches
the card through ``num_gpus`` tasks and actors, not in its driver.

Counterpart of the reference's job submission stack (SURVEY.md §2.2 —
JobSubmissionClient dashboard/modules/job/sdk.py:35, JobManager
job_manager.py:60, per-job JobSupervisor actor job_supervisor.py). A
JobSupervisor actor Popens the entrypoint with RAY_TPU_HEAD pointing at
this cluster, streams logs to a file, and records status in the head KV
(ns __jobs__) so any client can poll."""

from __future__ import annotations

import json
import os
import subprocess
import time
import uuid
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch._private.worker_context import global_runtime

_NS = "__jobs__"


def list_jobs() -> list[dict]:
    """Read-only job listing straight from the head KV (no JobManager
    side effects — safe for dashboards)."""
    rt = global_runtime()
    out = []
    for k in rt.kv_keys(ns=_NS):
        raw = rt.kv_get(k, ns=_NS)
        if raw is not None:
            out.append(json.loads(raw))
    return out

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class JobSupervisor:
    """One per job (reference: job_supervisor.py). max_concurrency=2 so
    stop() can land while run() blocks on the child process."""

    def __init__(self, job_id: str, entrypoint: str, env_vars: dict,
                 log_path: str, head_address: str):
        import threading

        self.job_id = job_id
        self.entrypoint = entrypoint
        self.env_vars = env_vars
        self.log_path = log_path
        self.head_address = head_address
        self.proc: subprocess.Popen | None = None
        self._stopped = False
        self._lock = threading.Lock()

    def _put_status(self, status: str, message: str = "") -> None:
        rt = global_runtime()
        record = {
            "job_id": self.job_id,
            "status": status,
            "entrypoint": self.entrypoint,
            "message": message,
            "log_path": self.log_path,
            "ts": time.time(),
        }
        rt.kv_put(self.job_id, json.dumps(record).encode(), ns=_NS)

    def run(self) -> str:
        env = dict(os.environ)
        env.update({str(k): str(v) for k, v in self.env_vars.items()})
        env["RAY_TPU_HEAD"] = self.head_address
        env["RAY_TPU_JOB_ID"] = self.job_id
        # The job driver connects to THIS cluster, not a new head.
        env["RAY_TPU_ADDRESS"] = self.head_address
        with open(self.log_path, "wb") as logf:
            # Launch atomically w.r.t. stop(): a stop that wins the lock
            # first prevents the Popen entirely.
            with self._lock:
                if self._stopped:
                    self._put_status(STOPPED, "stopped before start")
                    return STOPPED
                self._put_status(RUNNING)
                # New session → own process group, so stop()/cleanup kills
                # compound entrypoints (sh -c a && b), not just the shell.
                self.proc = subprocess.Popen(
                    self.entrypoint, shell=True, stdout=logf,
                    stderr=subprocess.STDOUT, env=env, start_new_session=True,
                )
            code = self.proc.wait()
        if self._stopped:
            self._put_status(STOPPED, "stopped by user")
            return STOPPED
        if code == 0:
            self._put_status(SUCCEEDED)
            return SUCCEEDED
        self._put_status(FAILED, f"entrypoint exited with code {code}")
        return FAILED

    def stop(self) -> bool:
        import signal

        with self._lock:
            self._stopped = True
            proc = self.proc
        if proc is None:
            return True  # run() will observe _stopped and never launch
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    proc.kill()
            return True
        return False

    def ping(self) -> str:
        return "pong"


class JobManager:
    """Cluster-wide job bookkeeper, one named actor per cluster
    (reference: job_manager.py:60). Owns the supervisors so ANY client can
    stop a job, and monitors their run() futures so a dead supervisor
    marks its job FAILED instead of leaving it RUNNING forever."""

    def __init__(self):
        import threading

        self._sups: dict[str, object] = {}
        self._runs: dict[str, object] = {}  # job_id -> ObjectRef of run()
        self._stop = threading.Event()
        threading.Thread(target=self._monitor, daemon=True, name="job-monitor").start()

    def submit(self, job_id: str, entrypoint: str, env_vars: dict,
               log_path: str, head_address: str) -> None:
        sup = ray_tpu_torch.remote(num_cpus=0, max_concurrency=2)(JobSupervisor).remote(
            job_id, entrypoint, env_vars, log_path, head_address
        )
        self._sups[job_id] = sup
        self._runs[job_id] = sup.run.remote()

    def stop(self, job_id: str) -> bool:
        sup = self._sups.get(job_id)
        if sup is None:
            return False
        return ray_tpu_torch.get(sup.stop.remote())

    def ping(self) -> str:
        return "pong"

    def _monitor(self) -> None:
        while not self._stop.wait(0.5):
            for job_id, ref in list(self._runs.items()):
                ready, _ = ray_tpu_torch.wait([ref], timeout=0)
                if not ready:
                    continue
                try:
                    ray_tpu_torch.get(ref)
                except Exception as e:  # noqa: BLE001 — supervisor died
                    self._mark_failed(job_id, f"job supervisor died: {e}")
                self._runs.pop(job_id, None)
                # Job is terminal: release the supervisor's worker process.
                sup = self._sups.pop(job_id, None)
                if sup is not None:
                    try:
                        ray_tpu_torch.kill(sup)
                    except Exception:
                        pass

    @staticmethod
    def _mark_failed(job_id: str, message: str) -> None:
        rt = global_runtime()
        raw = rt.kv_get(job_id, ns=_NS)
        if raw is None:
            return
        record = json.loads(raw)
        if record["status"] in (SUCCEEDED, FAILED, STOPPED):
            return
        record.update({"status": FAILED, "message": message, "ts": time.time()})
        rt.kv_put(job_id, json.dumps(record).encode(), ns=_NS)


def _get_or_create_manager():
    from ray_tpu_torch._private import rpc

    try:
        return ray_tpu_torch.get_actor("JOB_MANAGER", namespace="_jobs")
    except ValueError:
        pass
    try:
        mgr = ray_tpu_torch.remote(num_cpus=0, max_concurrency=4, name="JOB_MANAGER",
                             namespace="_jobs")(JobManager).remote()
        ray_tpu_torch.get(mgr.ping.remote())
        return mgr
    except rpc.RpcError:
        # Lost the creation race: another client registered it first.
        return ray_tpu_torch.get_actor("JOB_MANAGER", namespace="_jobs")


class JobSubmissionClient:
    """Reference: dashboard/modules/job/sdk.py:35 (REST there, direct
    actor+KV here — the head is the single source of truth either way)."""

    def __init__(self, address: Optional[str] = None):
        if address is not None and not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)
        ray_tpu_torch.api.auto_init()
        self._manager = _get_or_create_manager()

    def _head_address(self) -> str:
        host, port = global_runtime().address
        return f"{host}:{port}"

    def submit_job(self, *, entrypoint: str, submission_id: str | None = None,
                   runtime_env: dict | None = None) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:8]}"
        rt = global_runtime()
        log_dir = os.path.join(rt.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"job-{job_id}.log")
        env_vars = (runtime_env or {}).get("env_vars", {})
        record = {
            "job_id": job_id, "status": PENDING, "entrypoint": entrypoint,
            "message": "", "log_path": log_path, "ts": time.time(),
        }
        rt.kv_put(job_id, json.dumps(record).encode(), ns=_NS)
        ray_tpu_torch.get(self._manager.submit.remote(
            job_id, entrypoint, env_vars, log_path, self._head_address()
        ))
        return job_id

    def get_job_info(self, job_id: str) -> dict:
        raw = global_runtime().kv_get(job_id, ns=_NS)
        if raw is None:
            raise ValueError(f"no job {job_id}")
        return json.loads(raw)

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id)["status"]

    def get_job_logs(self, job_id: str) -> str:
        info = self.get_job_info(job_id)
        try:
            with open(info["log_path"], "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def list_jobs(self) -> list[dict]:
        return list_jobs()

    def stop_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._manager.stop.remote(job_id))

    def wait_until_finished(self, job_id: str, timeout_s: float = 120.0) -> str:
        deadline = time.monotonic() + timeout_s
        status = self.get_job_status(job_id)
        while time.monotonic() < deadline:
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            time.sleep(0.2)
            status = self.get_job_status(job_id)
        raise TimeoutError(f"job {job_id} still {status} after {timeout_s}s")
