"""The PyTorch port's LLM engine (ray_tpu_torch.llm) against the JAX
package's, on the CPU, from the same parameters: identical greedy token
ids on the scenarios of tests/test_llm.py.

The model is test_llm.py's ``tiny(vocab_size=512, max_seq_len=128)`` in
float32 compute: bf16 rounds at different places in the two frameworks,
which turns random-weight near-ties into different tokens; in float32
the logits agree to ~1e-6. Before tokens are compared exactly, every
step's top-2 logit margin is checked to exceed LOGIT_TOL, so a near-tie
cannot decide a test.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.llm import LLMConfig as JConfig
from ray_tpu.llm import LLMEngine as JEngine
from ray_tpu.llm import SamplingParams as JSampling
from ray_tpu.models import transformer as J
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import transformer as T

LOGIT_TOL = 1e-4
JMODEL = J.tiny(vocab_size=512, max_seq_len=128, dtype="float32")
TMODEL = T.TransformerConfig(**dataclasses.asdict(JMODEL))
GEOMETRY = dict(max_seq_len=64, prefill_buckets=(8, 16, 32))


def _engines(max_num_seqs=4):
    je = JEngine(JConfig(model=JMODEL, max_num_seqs=max_num_seqs,
                         sampling_defaults=JSampling(max_tokens=8), **GEOMETRY))
    te = LLMEngine(LLMConfig(model=TMODEL, max_num_seqs=max_num_seqs,
                             sampling_defaults=SamplingParams(max_tokens=8),
                             **GEOMETRY),
                   params=params_from_jax(jax.device_get(je.params), "cpu"),
                   device="cpu")
    return je, te


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _assert_decided(je, prompt_tokens, out):
    """Every generated token (past the stop) had a clear argmax."""
    seq = list(prompt_tokens) + list(out.token_ids)
    if not out.token_ids:
        return
    logits = np.asarray(J.forward(je.params, jnp.asarray([seq[:-1]]), JMODEL))
    steps = logits[0, len(prompt_tokens) - 1:]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > LOGIT_TOL


def _same(je, jo, to, prompts):
    for p, a, b in zip(prompts, jo, to):
        toks = je.tokenizer.encode(p)[: je.max_len - 1]
        _assert_decided(je, toks, a)
        assert b.token_ids == a.token_ids
        assert b.finish_reason == a.finish_reason
        assert b.num_prompt_tokens == a.num_prompt_tokens
        assert b.text == a.text


def test_single_request(engines):
    je, te = engines
    prompts = ["hello"]
    _same(je, je.generate(prompts, JSampling(max_tokens=5)),
          te.generate(prompts, SamplingParams(max_tokens=5)), prompts)


def test_staggered_admission_two_slots():
    """Three requests on two slots: the third joins when one finishes."""
    je, te = _engines(max_num_seqs=2)
    outs = []
    for eng, sp in ((je, JSampling(max_tokens=4)), (te, SamplingParams(max_tokens=4))):
        for i, p in enumerate(("aa", "bb", "cc")):
            eng.add_request(f"r{i}", p, sp)
        done = {}
        while eng.has_unfinished():
            for out in eng.step():
                done[out.request_id] = out
        outs.append([done[f"r{i}"] for i in range(3)])
    _same(je, outs[0], outs[1], ["aa", "bb", "cc"])


def test_batched_same_bucket_admit(engines):
    """Three same-bucket prompts admit in one batched prefill, padded to
    four rows; the pad row's out-of-range slot writes nothing."""
    je, te = engines
    prompts = ["abc", "wxyz", "hey"]
    _same(je, je.generate(prompts, JSampling(max_tokens=6)),
          te.generate(prompts, SamplingParams(max_tokens=6)), prompts)


def test_stop_token(engines):
    """Stop on the first generated id that differs from the first token,
    so some tokens come out before the stop."""
    je, te = engines
    probe = je.generate(["hello"], JSampling(max_tokens=8))[0].token_ids
    stop = next((t for t in probe if t != probe[0]), probe[0])
    jo = je.generate(["hello"], JSampling(max_tokens=10, stop_token_ids=(stop,)))
    to = te.generate(["hello"], SamplingParams(max_tokens=10, stop_token_ids=(stop,)))
    assert to[0].finish_reason == "stop" and stop not in to[0].token_ids
    _same(je, jo, to, ["hello"])


def test_long_prompt_truncated_and_cache_capped(engines):
    je, te = engines
    prompts = ["x" * 200]
    jo = je.generate(prompts, JSampling(max_tokens=500))
    to = te.generate(prompts, SamplingParams(max_tokens=500))
    assert to[0].num_prompt_tokens == GEOMETRY["max_seq_len"] - 1
    assert to[0].finish_reason == "length"
    _same(je, jo, to, prompts)


def test_engine_greedy_matches_model_generate(engines):
    """The slot engine agrees with the port's own generate() loop."""
    _, te = engines
    prompt = te.tokenizer.encode("abc")
    ref = T.generate(te.params, [prompt], TMODEL, max_new_tokens=6,
                     max_len=GEOMETRY["max_seq_len"])[0, len(prompt):]
    out = te.generate([prompt], SamplingParams(max_tokens=6))[0]
    assert out.token_ids == ref.tolist()


@pytest.mark.parametrize("option", [
    dict(checkpoint_path=os.path.dirname(__file__)),
    dict(speculative_model=TMODEL,
         speculative_checkpoint_path=os.path.dirname(__file__)),
])
def test_unported_engine_options_raise(option):
    """What the port's engine still refuses: orbax checkpoint directories
    (it reads .npz only)."""
    with pytest.raises(NotImplementedError):
        LLMEngine(LLMConfig(model=TMODEL, **GEOMETRY, **option), device="cpu")


@pytest.mark.parametrize("option", ["tensor_parallel_size", "pipeline_parallel_size"])
def test_parallel_engine_needs_enough_ranks(option):
    """Tensor and pipeline parallelism serve over the ranks of the default
    process group; without one the world is this process alone, too few
    ranks (tests/test_torch_llm_parallel.py runs them on 2 gloo ranks)."""
    with pytest.raises(ValueError, match=f"{option}=2 but only 1 ranks"):
        LLMEngine(LLMConfig(model=TMODEL, **GEOMETRY, **{option: 2}), device="cpu")


@pytest.mark.parametrize("option", [
    dict(kv_page_size=16), dict(kv_page_size=8, kv_num_pages=5),
    dict(speculative_model=TMODEL), dict(lora={"max_adapters": 2}),
    dict(enable_prefix_caching=True), dict(prefill_chunk=16),
    dict(kv_page_size=8, prefill_chunk=16, enable_prefix_caching=True),
])
def test_ported_engine_options_construct(option):
    eng = LLMEngine(LLMConfig(model=TMODEL, **GEOMETRY, **option), device="cpu")
    assert not eng.has_unfinished()


@pytest.mark.parametrize("sampling", [
    dict(logprobs=21), dict(logit_bias=tuple((i, 1.0) for i in range(17))),
    dict(logit_bias=((512, 1.0),)),
    dict(response_format={"type": "yaml"}),
])
def test_unported_sampling_raises(engines, sampling):
    """Sampling the engine cannot take (past its logprob and logit_bias
    caps, a bias outside the vocab, an unknown response_format) raises
    ValueError at intake and queues nothing."""
    _, te = engines
    with pytest.raises(ValueError):
        te.add_request("x", "abc", SamplingParams(**sampling))
    assert not te.has_unfinished()


def test_temperature_sampling_runs(engines):
    """Sampled streams differ from the JAX engine's (different RNGs), so
    they are checked for running to length with in-vocab ids."""
    _, te = engines
    sp = SamplingParams(max_tokens=4, temperature=0.8)
    outs = te.generate(["ab", "cd"], sp)
    assert all(len(o.token_ids) == 4 for o in outs)
    assert all(0 <= t < TMODEL.vocab_size for o in outs for t in o.token_ids)
