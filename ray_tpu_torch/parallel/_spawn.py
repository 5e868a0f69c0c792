"""Run one function on N ranks of a fresh process group (a private
launcher for the tests and ``chip_smoke.py``).

``run(fn, world_size, *args)`` starts ``world_size`` processes by the
``spawn`` method; each joins a ``torch.distributed`` group through a
``FileStore`` in a temporary directory of its own (a fixed TCP port would
collide between test workers running at once), calls ``fn(rank,
world_size, *args)`` and sends back what it returns, with every tensor in
it turned into a numpy array. ``fn`` must be a module-level function: the
children import its module, so that module must not import JAX.

The call raises if any rank raises, dies or has not finished within
``timeout`` seconds, and it stops every process it started. The group
gets the same timeout, so a collective that a rank waits on in vain
fails there too.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _to_numpy(tree):
    """``tree`` with every tensor (DTensors as their local shards) as a
    numpy array on the host; bfloat16 becomes float32, which holds it
    exactly."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_to_numpy(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if isinstance(tree, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(tree, DTensor):
            tree = tree.to_local()
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _child(fn, rank, world_size, backend, store, timeout, results, args):
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = _to_numpy(fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def _other_failures(results, first: int) -> str:
    """The other ranks' failures reported within a few seconds of the
    first (the rank at fault is often not the first to report)."""
    out = []
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        try:
            rank, ok, payload = results.get(timeout=0.5)
        except queue.Empty:
            continue
        if not ok and rank != first:
            out.append(f"\nrank {rank} failed too:\n{payload}")
    return "".join(out)


def run(fn, world_size: int, *args, backend: str = "gloo",
        timeout: float = 300.0) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` ranks; returns
    each rank's result, in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(fn, rank, world_size, backend, store, timeout, results,
                                   args))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            done = {}
            deadline = time.monotonic() + timeout
            while len(done) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} of {fn.__name__} died "
                                           f"without a result (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{fn.__name__} on {world_size} ranks did "
                                           f"not finish in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n{payload}"
                                       + _other_failures(results, rank))
                done[rank] = payload
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
    return [done[r] for r in range(world_size)]
