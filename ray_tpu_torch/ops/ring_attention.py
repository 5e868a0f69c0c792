"""Ring attention: sequence/context parallelism over a ring of ranks
(port of ray_tpu/ops/ring_attention.py).

The sequence is sharded over a ``sequence`` mesh axis; each rank
computes attention for its local query shard while key/value shards
rotate around the ring (point-to-point transfers on that axis's process
group, ``batch_isend_irecv``), folded in with the online softmax. Peak
memory per rank is O(T/n). Differentiable: the transfers carry the
gradients back the other way round the ring. There is no hand-written
kernel on this path, in ray_tpu or here.

Every rank of the axis calls ``ring_attention`` with its shards;
``ring_attention_sharded`` takes global tensors (or DTensors) and runs it
under ``local_map``.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.attention import _NEG_INF, _finalize, online_softmax_block
from ray_tpu_torch.parallel._collectives import axis_group, ring_shift
from ray_tpu_torch.parallel.mesh import AXIS_SEQUENCE


def ring_attention(q, k, v, *, mesh, axis_name: str = AXIS_SEQUENCE,
                   causal: bool = True):
    """Attention over sequence-sharded q/k/v, called on every rank of
    ``mesh``'s ``axis_name`` dim.

    q, k, v: [B, T_local, H, D] — this rank's contiguous sequence shard
    (rank r along the axis holds global positions [r*T_local,
    (r+1)*T_local)). Returns [B, T_local, H, D].
    """
    group, rank, n = axis_group(mesh, axis_name)
    b, t_local, h, d = q.shape
    arange = torch.arange(t_local, device=q.device)
    q_pos = rank * t_local + arange

    def fold(k_cur, v_cur, m, l, o, s):
        # After s hops along the +1 ring, this rank holds the shard that
        # originated at rank - s.
        src = (rank - s) % n
        return online_softmax_block(q, k_cur, v_cur, m, l, o, q_pos=q_pos,
                                    k_pos=src * t_local + arange, causal=causal)

    m = torch.full((b, h, t_local), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=q.device)
    # n-1 hops; the last resident shard is folded after the loop, so no
    # transfer leaves it that nobody reads.
    for s in range(n - 1):
        k_nxt = ring_shift(k, group, rank, n)
        v_nxt = ring_shift(v, group, rank, n)
        m, l, o = fold(k, v, m, l, o, s)
        k, v = k_nxt, v_nxt
    m, l, o = fold(k, v, m, l, o, n - 1)
    return _finalize(o, l).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, *, axis_name: str = AXIS_SEQUENCE,
                           causal: bool = True, batch_spec=None):
    """q/k/v are global [B, T, H, D] (plain tensors, the same on every
    rank, or DTensors); the sequence dim is sharded over ``axis_name``,
    batch over the ``batch_spec`` axes. Returns a DTensor laid out so."""
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.ops.attention import blockwise_attention
    from ray_tpu_torch.parallel.mesh import mesh_axis_size
    from ray_tpu_torch.parallel.sharding import P, constrain, to_placements

    if mesh_axis_size(mesh, axis_name) == 1:
        # Degenerate mesh (sequence axis collapsed): no ring needed.
        return blockwise_attention(q, k, v, causal=causal)

    spec = P(batch_spec, axis_name)
    placements = tuple(to_placements(spec, mesh))
    q, k, v = (constrain(x, mesh, *spec) for x in (q, k, v))

    def local(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal)

    return local_map(local, out_placements=list(placements),
                     in_placements=(placements,) * 3, device_mesh=mesh)(q, k, v)
