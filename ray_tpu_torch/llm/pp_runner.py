"""Pipeline-parallel prefill/decode for the LLM engine (port of
ray_tpu/llm/pp_runner.py).

ray_tpu runs the pipeline as one SPMD program over a ``pipeline`` mesh
axis (shard_map); here every rank of the axis runs the same loop on its
own stage, one process per rank:

  - each rank holds only its stage's ``L/pp`` layers and their rows of
    the slot cache (the layer axis is split; everything else — the
    embedding, the final norm, the head — is whole on every rank);
  - a step walks the stages in order: the stage the activation has
    reached runs its layers, then a ring hop along the axis
    (``parallel._collectives.ring_shift``, batch_isend_irecv: ray_tpu's
    ppermute) hands it to the next stage;
  - the embedding runs on every rank, the head on the last stage only,
    and the logits reach every rank by one broadcast
    (``parallel.pipeline_last_to_all``), so every rank samples the same
    tokens and its host scheduler makes the same choices.

The per-layer math is model_runner's own (make_prefill_body /
make_decode_body): one implementation, two runners.

A decode step through the pipeline runs one stage at a time by design:
pipeline parallelism buys memory (a model too large for one device),
and continuous batching gives the overlap across requests.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.ops.tree import tree_map
from ray_tpu_torch.parallel._collectives import axis_group, ring_shift
from ray_tpu_torch.parallel.mesh import AXIS_PIPELINE
from ray_tpu_torch.parallel.pipeline import pipeline_last_to_all


class PPRunner:
    """Stands in for the part of model_runner the engine uses on the
    non-speculative, unchunked path: ``init_slot_cache``, ``prefill`` and
    ``decode``, with model_runner's signatures (params and cache are this
    stage's). Every rank of the default process group constructs it
    together (it builds the ``pipeline`` mesh)."""

    def __init__(self, config: TransformerConfig, pp: int, *, device="cuda"):
        if config.n_layers % pp:
            raise ValueError(
                f"pipeline_parallel_size={pp} must divide n_layers "
                f"({config.n_layers})")
        self.c = config
        self.pp = pp
        self.mesh = mr.serving_mesh(AXIS_PIPELINE, pp, torch.device(device).type,
                                    "pipeline_parallel_size")
        self.group, self.stage, _ = axis_group(self.mesh, AXIS_PIPELINE)
        n = config.n_layers // pp
        self.layers = slice(self.stage * n, (self.stage + 1) * n)

    # -- placement ---------------------------------------------------------

    def shard_params(self, params):
        """This stage's parameters: its slice of the layer stacks (copies,
        so the whole tree can be freed), everything else as it is."""
        return {k: tree_map(lambda a: a[self.layers].clone(), v) if k == "layers" else v
                for k, v in params.items()}

    def init_slot_cache(self, config, num_slots, max_len, *, device="cuda"):
        c = config
        shape = (c.n_layers // self.pp, num_slots, max_len, c.kv_heads, c.head_dim)
        return {"k": torch.zeros(shape, dtype=c.compute_dtype, device=device),
                "v": torch.zeros(shape, dtype=c.compute_dtype, device=device)}

    # -- the stage walk ----------------------------------------------------

    def _stage_loop(self, x, seg):
        """Stage s runs ``seg`` on its layers when the activation reaches
        it; after each stage but the last, the ring hands x onward. The
        last stage ends holding the output."""
        for s in range(self.pp):
            if self.stage == s:
                x = seg(x)
            if s < self.pp - 1:
                x = ring_shift(x, self.group, self.stage, self.pp)
        return x

    def _last_stage_logits(self, x, params, dt):
        """The head on the last stage only; the logits on every rank."""
        if self.stage == self.pp - 1:
            logits = mr._final_logits(x, params, self.c, dt)
        else:
            logits = torch.zeros(x.shape[:2] + (self.c.vocab_size,),
                                 dtype=torch.float32, device=x.device)
        return pipeline_last_to_all(logits, mesh=self.mesh)

    # -- engine-facing API (model_runner signatures) -----------------------

    def prefill(self, params, tokens, true_len: int, slot: int, cache, *, config):
        c, dt = self.c, self.c.compute_dtype
        _, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)
        x, rope = mr.embed_tokens(params, tokens, positions, c, dt)
        body = mr.make_prefill_body(c, dt, positions, rope, slot)
        x = self._stage_loop(x, lambda x: mr._run_layers(body, x, params, cache, c))
        last = self._last_stage_logits(x[:, true_len - 1:true_len], params, dt)
        return last[0, 0], cache

    def decode(self, params, tokens, positions, cache, temperature, rng, *, config):
        c, dt = self.c, self.c.compute_dtype
        B = tokens.shape[0]
        T = cache["k"].shape[2]
        device = tokens.device
        x, rope = mr.embed_tokens(params, tokens[:, None], positions[:, None], c, dt)
        kmask = torch.arange(T, device=device)[None, :] <= positions[:, None]
        body = mr.make_decode_body(c, dt, positions, mr.decode_rope_tables(rope, positions),
                                   kmask, torch.arange(B, device=device))
        x = self._stage_loop(x, lambda x: mr._run_layers(body, x, params, cache, c))
        logits = self._last_stage_logits(x, params, dt)[:, 0]
        return mr.sample_tokens(logits, temperature, rng), logits, cache
