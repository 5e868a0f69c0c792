"""Worker resource isolation via cgroup v2.

Counterpart of the reference's cgroup setup
(reference: src/ray/common/cgroup/cgroup_setup.h — per-node cgroup tree
with a system slice for daemons and an application slice for workers;
fake_cgroup_setup.h for tests). Python implementation writing the
cgroup2 filesystem directly: the head/agent creates

    <root>/ray_tpu_torch_node_<id>/system     (reserved cpu/memory for daemons)
    <root>/ray_tpu_torch_node_<id>/workers    (application slice)

and each worker is moved into the application slice at spawn; per-worker
memory caps come from task resource requests (``memory`` resource).
Everything degrades to a no-op when cgroup v2 is unavailable or
unwritable (containers without delegation) — same graceful fallback the
reference uses (cgroup_setup.cc returns Status::Invalid and scheduling
proceeds without isolation).
"""

from __future__ import annotations

import os
from typing import Optional

CGROUP_ROOT = "/sys/fs/cgroup"


def cgroup_v2_available(root: str = CGROUP_ROOT) -> bool:
    """cgroup v2 unified hierarchy mounted and writable."""
    return (os.path.isfile(os.path.join(root, "cgroup.controllers"))
            and os.access(root, os.W_OK))


class CgroupSetup:
    """Node-level cgroup tree manager (reference: cgroup_setup.h
    CgroupSetup). All operations are best-effort: a read-only cgroupfs
    yields a disabled instance whose methods are no-ops."""

    @classmethod
    def get_or_create(cls, owner, node_id: str) -> "CgroupSetup":
        """Lazily attach one instance to ``owner`` (head or node agent) —
        the shared spawn-path hook used by both daemons."""
        cg = getattr(owner, "_cgroup", None)
        if cg is None:
            cg = cls(node_id)
            owner._cgroup = cg
        return cg

    def __init__(self, node_id: str, root: str = CGROUP_ROOT):
        self.root = root
        self.node_path: Optional[str] = None
        self.workers_path: Optional[str] = None
        self.system_path: Optional[str] = None
        self.enabled = False
        if not cgroup_v2_available(root):
            return
        try:
            node_path = os.path.join(root, f"ray_tpu_torch_node_{node_id}")
            os.makedirs(node_path, exist_ok=True)
            # Enable controllers for children (ok if some are absent).
            self._try_write(os.path.join(node_path, "cgroup.subtree_control"),
                            "+cpu +memory")
            workers = os.path.join(node_path, "workers")
            system = os.path.join(node_path, "system")
            os.makedirs(workers, exist_ok=True)
            os.makedirs(system, exist_ok=True)
            # Per-worker children under workers/ need the memory controller
            # delegated one more level down; and cgroup v2's
            # no-internal-process rule means workers/ itself must stay
            # process-free — every worker lives in a child (per-worker
            # capped dir, or the shared uncapped one).
            self._try_write(os.path.join(workers, "cgroup.subtree_control"),
                            "+memory")
            os.makedirs(os.path.join(workers, "shared"), exist_ok=True)
            self.node_path, self.workers_path, self.system_path = (
                node_path, workers, system)
            self.enabled = True
        except OSError:
            self.node_path = self.workers_path = self.system_path = None
            self.enabled = False

    # ------------------------------------------------------------------

    @staticmethod
    def _try_write(path: str, value: str) -> bool:
        try:
            with open(path, "w") as f:
                f.write(value)
            return True
        except OSError:
            return False

    def add_system_process(self, pid: int) -> bool:
        """Move a daemon (head service, agent) into the system slice."""
        if not self.enabled:
            return False
        return self._try_write(
            os.path.join(self.system_path, "cgroup.procs"), str(pid))

    def add_worker_process(self, pid: int,
                           memory_bytes: Optional[int] = None) -> bool:
        """Move a worker into the application slice; optionally into a
        per-worker child with a memory.max cap (reference: per-task
        memory resource enforcement)."""
        if not self.enabled:
            return False
        if memory_bytes is None:
            # Shared child, not workers/ itself (no-internal-process rule).
            return self._try_write(
                os.path.join(self.workers_path, "shared", "cgroup.procs"),
                str(pid))
        child = os.path.join(self.workers_path, f"worker_{pid}")
        try:
            os.makedirs(child, exist_ok=True)
        except OSError:
            return False
        self._try_write(os.path.join(child, "memory.max"), str(int(memory_bytes)))
        return self._try_write(os.path.join(child, "cgroup.procs"), str(pid))

    def remove_worker(self, pid: int) -> None:
        """Reap a per-worker child after the process exits."""
        if not self.enabled:
            return
        child = os.path.join(self.workers_path, f"worker_{pid}")
        if os.path.isdir(child):
            try:
                os.rmdir(child)
            except OSError:
                pass

    def set_system_reserved(self, *, cpu_weight: Optional[int] = None,
                            memory_min: Optional[int] = None) -> None:
        """Reserve headroom for daemons (reference: system cgroup
        cpu.weight / memory.min reservation)."""
        if not self.enabled:
            return
        if cpu_weight is not None:
            self._try_write(os.path.join(self.system_path, "cpu.weight"),
                            str(cpu_weight))
        if memory_min is not None:
            self._try_write(os.path.join(self.system_path, "memory.min"),
                            str(memory_min))

    def teardown(self) -> None:
        """Remove the node tree (workers must have exited)."""
        if not self.enabled:
            return
        for path in (self.workers_path, self.system_path, self.node_path):
            if path and os.path.isdir(path):
                for sub in sorted(
                    (os.path.join(path, d) for d in os.listdir(path)
                     if os.path.isdir(os.path.join(path, d))),
                    reverse=True,
                ):
                    try:
                        os.rmdir(sub)
                    except OSError:
                        pass
                try:
                    os.rmdir(path)
                except OSError:
                    pass
        self.enabled = False


class FakeCgroupSetup(CgroupSetup):
    """In-memory fake (reference: common/cgroup/fake_cgroup_setup.h) so
    scheduler/agent tests can assert cgroup calls without a cgroupfs."""

    def __init__(self, node_id: str):  # noqa: super-init-not-called
        self.enabled = True
        self.node_path = f"/fake/ray_tpu_torch_node_{node_id}"
        self.workers_path = self.node_path + "/workers"
        self.system_path = self.node_path + "/system"
        self.system_procs: list[int] = []
        self.worker_procs: dict[int, Optional[int]] = {}
        self.reserved: dict = {}

    def add_system_process(self, pid: int) -> bool:
        self.system_procs.append(pid)
        return True

    def add_worker_process(self, pid: int, memory_bytes=None) -> bool:
        self.worker_procs[pid] = memory_bytes
        return True

    def remove_worker(self, pid: int) -> None:
        self.worker_procs.pop(pid, None)

    def set_system_reserved(self, *, cpu_weight=None, memory_min=None) -> None:
        self.reserved = {"cpu_weight": cpu_weight, "memory_min": memory_min}

    def teardown(self) -> None:
        self.enabled = False
