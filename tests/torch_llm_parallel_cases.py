"""The port's side of tests/test_torch_llm_parallel.py: LLM engines that
each rank of a gloo CPU group builds and serves with, spawned by
ray_tpu_torch.parallel._spawn. This module imports no JAX (the children
must not load XLA): params arrive as numpy trees made by the JAX package,
and results go back as plain lists."""

from __future__ import annotations

import os
import warnings

import torch

from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import transformer as T


def _engine(config, params, kw):
    """kw's model configs (speculative_model) arrive as dicts."""
    kw = {k: T.TransformerConfig(**v) if isinstance(v, dict) and k.endswith("model") else v
          for k, v in kw.items()}
    return LLMEngine(LLMConfig(model=T.TransformerConfig(**config), **kw),
                     params=params_from_jax(params, "cpu"), device="cpu")


def serve(config, params, kw, waves, adapters=None):
    """Each wave ([(prompt, SamplingParams kwargs)]) through one engine in
    turn: the outputs, and the shapes and counters the test compares."""
    eng = _engine(config, params, kw)
    for name, (factors, alpha) in (adapters or {}).items():
        eng.add_lora(name, factors, alpha=alpha)
    outs = []
    for wave in waves:
        got = eng.generate([p for p, _ in wave], [SamplingParams(**s) for _, s in wave])
        outs.append([(o.token_ids, o.finish_reason, o.text, o.logprobs) for o in got])
    mesh = None if eng.mesh is None else dict(zip(eng.mesh.mesh_dim_names, eng.mesh.shape))
    return {"waves": outs, "cache_k": list(eng.cache["k"].shape),
            "wq": list(eng.params["layers"]["attn"]["wq"].shape),
            "embed": list(eng.params["embed"]["tokens"].shape), "mesh": mesh,
            "spec": dict(eng.spec_stats), "prefix_hits": eng.prefix_cache_hits}


def refuse(config, params, kw):
    """(type name, message) of the error building the engine raises."""
    try:
        _engine(config, params, kw)
    except Exception as e:  # noqa: BLE001 - the test compares it
        return [type(e).__name__, str(e)]
    return None


def run(rank, world, cases):
    """Every case in ``cases`` ({name: (function name, kwargs)}), in order,
    on this rank: {name: result}. Each rank takes its share of the cores."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*")
    return {name: globals()[fn](**kwargs) for name, (fn, kwargs) in cases.items()}
