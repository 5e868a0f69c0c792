"""Training backends: per-worker distributed setup (port of
ray_tpu/train/backend.py).

ray_tpu's JaxConfig backend sets up two things on a worker: a host-level
collective group (weight broadcast, gradient averaging, barriers) and,
on a multi-host pod, ``jax.distributed.initialize`` for the collectives
inside compiled programs. Under torch both are one thing, the default
``torch.distributed`` process group: NCCL for workers on the card, gloo
on the CPU. ``TorchBackend.on_worker_setup`` initialises it, with an
explicit timeout, so a rank that waits on a collective its peers never
join fails instead of hanging; ``ray_tpu_torch.parallel`` builds its
meshes over it and ``torch_utils`` syncs over it. It registers that group
under the run's group name (``get_group``), the name ray_tpu's sync
helpers take as ``group_name``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

# Process groups by the name on_worker_setup was given (ray_tpu keeps its
# host collective groups by name the same way, util/collective.py).
_groups: dict = {}


def get_group(name: str):
    """The process group registered under ``name``."""
    if name not in _groups:
        raise ValueError(f"no process group named {name!r}: TorchBackend."
                         f"on_worker_setup registers the run's group under its "
                         f"group_name (registered: {sorted(_groups)})")
    return _groups[name]


@dataclasses.dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks called around the training lifecycle."""

    def on_start(self, worker_group, backend_config) -> None:
        pass

    def on_worker_setup(self, rank: int, world_size: int, group_name: str) -> None:
        pass

    def on_shutdown(self, worker_group, backend_config) -> None:
        pass


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """The counterpart of ray_tpu's JaxConfig, field for field:

      - ``distributed``: "on" always initialises the default process group
        (at world size 1 too), "off" never, "auto" when the world has more
        than one rank (JaxConfig: jax.distributed on a multi-host pod);
      - ``coordinator_address``: the group's rendezvous, its
        ``init_method``: "tcp://host:port", "file:///path", or "host:port"
        (read as tcp); None reads MASTER_ADDR and MASTER_PORT ("env://");
      - ``collective_group``: whether a world of more than one rank gets the
        group the sync helpers use (JaxConfig: the host collective group),
        whatever ``distributed`` says.

    Beside them, what torch needs and JAX did not: the ``device`` the ranks
    run on ("cuda": NCCL, each rank on card LOCAL_RANK; "cpu": gloo), and
    the group's ``timeout_s``.
    """

    distributed: str = "auto"
    coordinator_address: str | None = None
    collective_group: bool = True
    device: str = "cuda"
    timeout_s: float = 600.0

    def backend_cls(self):
        return TorchBackend

    def init_method(self) -> str:
        addr = self.coordinator_address
        if addr is None:
            return "env://"
        return addr if "://" in addr else f"tcp://{addr}"


class TorchBackend(Backend):
    def on_worker_setup(self, rank: int, world_size: int, group_name: str,
                        config: TorchConfig | None = None) -> None:
        import torch
        import torch.distributed as dist

        config = config or TorchConfig()
        if config.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {config.device!r}")
        if config.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchConfig(device='cuda') needs a CUDA device; "
                               "pass device='cpu' for gloo ranks on the CPU")
        # torchrun's env vars for user code (the reference sets the same).
        os.environ["RANK"] = str(rank)
        os.environ["WORLD_SIZE"] = str(world_size)
        os.environ["LOCAL_RANK"] = str(rank)
        if config.device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        if config.distributed not in ("auto", "on", "off"):
            raise ValueError(f"distributed must be 'auto', 'on' or 'off', "
                             f"got {config.distributed!r}")
        wanted = config.distributed == "on" or (
            world_size > 1 and (config.distributed == "auto" or config.collective_group))
        if wanted:
            dist.init_process_group(
                "nccl" if config.device == "cuda" else "gloo",
                init_method=config.init_method(), rank=rank, world_size=world_size,
                timeout=datetime.timedelta(seconds=config.timeout_s))
        if dist.is_initialized():
            _groups[group_name] = dist.group.WORLD
