"""Batch LLM inference over Data (ray_tpu_torch.llm.batch, the port of
ray_tpu/llm/batch.py): build_llm_processor with the port's engine on
device="cpu" against ray_tpu's LLMPredictor on the same parameters
(tests/torch_llm_helpers.py's tiny float32 model), greedy, every token's
top-2 margin checked on the JAX model first: equal ``generated_text``,
inline and on a port cluster through a CPU actor pool (every get
bounded). For a CUDA device the stage defaults to a pool of one worker
with a GPU lease."""

import pytest

import ray_tpu_torch as rt
from ray_tpu.data import from_items as jfrom_items
from ray_tpu.llm.batch import LLMPredictor as JPredictor
from ray_tpu.llm import LLMConfig as JConfig
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.executor import MapBatches
from ray_tpu_torch.llm import LLMConfig, build_llm_processor
from torch_llm_helpers import (GEOMETRY, JMODEL, TMODEL, assert_decided, base_params,
                               engine_pair, sampling)

PROMPTS = ["hello there", "the quick brown fox", "a", "Data in, text out: "]
MAX_TOKENS = 8


@pytest.fixture(scope="module")
def reference():
    """ray_tpu's batch stage on the JAX engine, with each prompt's tokens
    decided by more than the logit tolerance."""
    jp, _ = base_params()
    jsp, _ = sampling(max_tokens=MAX_TOKENS, temperature=0.0)
    je, _ = engine_pair()
    for p, out in zip(PROMPTS, je.generate(PROMPTS, jsp)):
        assert_decided(je, je.tokenizer.encode(p), out.token_ids)
    ds = jfrom_items([{"prompt": p} for p in PROMPTS]).map_batches(
        JPredictor, batch_size=2,
        fn_constructor_args=(JConfig(model=JMODEL, **GEOMETRY), jsp, "prompt",
                             "generated_text", jp))
    return [r["generated_text"] for r in ds.take_all()]


@pytest.mark.parametrize("where", ["inline", "actor_pool"])
def test_batch_stage_gives_the_reference_text(reference, where):
    _, tp = base_params()
    _, tsp = sampling(max_tokens=MAX_TOKENS, temperature=0.0)
    compute = None
    if where == "actor_pool":
        if not rt.is_initialized():
            rt.init(num_cpus=2, object_store_memory=64 * 1024 * 1024,
                    _system_config={"head_shards": 1})
        compute = rd.ActorPoolStrategy(min_size=1, max_size=1, block_timeout_s=120)
    try:
        ds = build_llm_processor(rd.from_items([{"prompt": p} for p in PROMPTS]),
                                 LLMConfig(model=TMODEL, **GEOMETRY), sampling=tsp,
                                 batch_size=2, params=tp, device="cpu", compute=compute)
        rows = ds.take_all()
    finally:
        if rt.is_initialized():
            rt.shutdown()
    assert [r["prompt"] for r in rows] == PROMPTS
    assert [r["generated_text"] for r in rows] == reference
    # the byte tokenizer writes no text for ids past 255, so some of the
    # tiny model's answers are empty; most are not
    assert all(isinstance(t, str) for t in reference) and sum(map(bool, reference)) >= 3


def test_cuda_stage_defaults_to_a_gpu_pool():
    """The plan only (nothing runs): a CUDA stage asks for one pool worker
    holding a whole-card GPU lease; a CPU stage runs as plain tasks."""
    for device, want in (("cuda", {"GPU": 1}), ("cpu", None)):
        ds = build_llm_processor(rd.from_items([{"prompt": "x"}]),
                                 LLMConfig(model=TMODEL, **GEOMETRY), device=device)
        op = ds._plan[-1]
        assert isinstance(op, MapBatches) and op.fn_constructor is not None
        got = None if op.compute is None else op.compute.resources
        assert got == want, device
        if want is not None:
            assert (op.compute.min_size, op.compute.max_size) == (1, 1)
