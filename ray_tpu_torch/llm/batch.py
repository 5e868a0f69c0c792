"""Batch LLM inference over ray_tpu_torch.data Datasets (port of
ray_tpu/llm/batch.py).

Counterpart of the reference's batch path (reference:
python/ray/llm/_internal/batch/ — Processor + vLLMEngineStage mapping a
Dataset through engine actors). Here the stage is a stateful map_batches
UDF: each Data worker constructs one engine of the port
(``LLMEngine(config, params, device=...)``) and pushes every batch of
prompts through ``LLMEngine.generate`` (continuous batching inside the
engine gives intra-batch parallelism on the card).

A class UDF without ``compute`` builds inside plain tasks, whose workers
hold no GPU lease and see no card. So for a CUDA device the stage runs
on an actor pool whose workers each hold a ``GPU`` lease
(``ActorPoolStrategy(resources={"GPU": 1})``, the port's form of the
reference's ``{"TPU": 1}`` example); with no cluster up it runs inline
in the driver, which holds the card. A CPU device runs as the
reference's stage does, unless the caller passes ``compute``.

    ds = ray_tpu_torch.data.from_items([{"prompt": "..."}])
    ds = build_llm_processor(ds, LLMConfig(model="tiny"))
    rows = ds.take_all()   # adds a "generated_text" column
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams


class LLMPredictor:
    """Stateful map_batches UDF: one engine per Data worker."""

    def __init__(self, config: LLMConfig, sampling: SamplingParams | None = None,
                 prompt_column: str = "prompt",
                 output_column: str = "generated_text",
                 params: Any = None, device="cuda"):
        from ray_tpu_torch.llm.engine import LLMEngine

        self.engine = LLMEngine(config, params, device=device)
        self.sampling = sampling
        self.prompt_column = prompt_column
        self.output_column = output_column

    def __call__(self, batch: dict) -> dict:
        prompts = [str(p) for p in batch[self.prompt_column]]
        outs = self.engine.generate(prompts, self.sampling)
        batch = dict(batch)
        batch[self.output_column] = np.array([o.text for o in outs], dtype=object)
        return batch


def build_llm_processor(ds, config: LLMConfig, *,
                        sampling: SamplingParams | None = None,
                        batch_size: int | None = 32,
                        prompt_column: str = "prompt",
                        output_column: str = "generated_text",
                        params: Any = None, device="cuda", compute=None):
    """Append an LLM-generation stage to a Dataset. ``params``: the
    engine's weights (None: the config's checkpoint or its seed).
    ``device``: where each engine runs; for CUDA the stage defaults to
    an actor pool of one worker holding a whole-card ``GPU`` lease.
    ``compute``: an ``ActorPoolStrategy`` (or ``"actors"``) in place of
    that default."""
    import torch

    from ray_tpu_torch.data import ActorPoolStrategy

    if compute is None and torch.device(device).type == "cuda":
        compute = ActorPoolStrategy(min_size=1, max_size=1, resources={"GPU": 1})
    return ds.map_batches(
        LLMPredictor,
        batch_size=batch_size,
        compute=compute,
        fn_constructor_args=(config, sampling, prompt_column, output_column, params,
                             device),
    )
