"""ray_tpu_torch.experimental: mutable channels for compiled-DAG pipelines
(port of ray_tpu.experimental).

Reusable buffers that bypass the per-call task RPC and object store for
actor-to-actor hand-offs: ``Channel`` (a shm ring, same host),
``tcp_channel`` (across nodes) and ``device_channel`` (CUDA tensors by
CUDA IPC, device to device).
"""

from ray_tpu_torch.experimental.channel import Channel

__all__ = ["Channel"]
