"""Shared pieces of the tests/test_torch_llm_*.py files: the JAX and the
port's engine built from the same parameters, and the top-2 margin check
that must pass before greedy tokens are compared exactly.

The model is tests/test_torch_llm.py's ``tiny(vocab_size=512,
max_seq_len=128)`` in float32 compute, where the two frameworks' logits
agree to ~1e-6; a step whose top-2 margin is below LOGIT_TOL would let a
rounding difference decide the token, so the margin is checked first.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

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


def to_torch_config(jc):
    return T.TransformerConfig(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def base_params():
    """JMODEL's parameters from PRNGKey(0), as the JAX tree and as the
    port's (made once per process: JAX's eager init is slow)."""
    jp = J.init_params(jax.random.PRNGKey(0), JMODEL)
    return jp, params_from_jax(jax.device_get(jp), "cpu")


def engine_pair(*, jkw=None, tkw=None, **kw):
    """(JAX engine, port engine) on base_params(). ``kw`` go to both
    configs; ``jkw``/``tkw`` to one side only. Model configs passed in
    ``kw`` (speculative_model) are JAX configs, converted for the port."""
    kw = {**GEOMETRY, **kw}
    tside = {k: (to_torch_config(v) if isinstance(v, J.TransformerConfig)
                 else v) for k, v in kw.items()}
    jp, tp = base_params()
    je = JEngine(JConfig(model=JMODEL, **kw, **(jkw or {})), jp)
    te = LLMEngine(LLMConfig(model=TMODEL, **tside, **(tkw or {})),
                   params=tp, device="cpu")
    return je, te


def sampling(**kw):
    """The same SamplingParams for both engines."""
    return JSampling(**kw), SamplingParams(**kw)


_forward = jax.jit(J.forward, static_argnums=2)


def forward_logits(je, seq):
    """The JAX model's logits [len(seq), V] (float64) for ``seq``. The
    sequence is right-padded to the model's length (one compile; causal
    attention keeps the padding out of the rows returned)."""
    c = je.model_config
    padded = np.zeros((1, c.max_seq_len), np.int32)
    padded[0, :len(seq)] = seq
    out = _forward(je.params, jnp.asarray(padded), c)
    return np.asarray(out[0, :len(seq)], np.float64)


def top2_margins(logits, allowed=None):
    """The top-2 margin of each row, over ``allowed`` tokens only when
    given."""
    if allowed is not None:
        logits = np.where(allowed, logits, -np.inf)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def penalized(logits, prompt, gen, sp):
    """The engine's greedy choice input for one step: logits after the
    repetition, presence and frequency penalties and logit_bias, given
    the prompt and the tokens generated before this step."""
    lg = np.array(logits, np.float64)
    for tid, b in sp.logit_bias:
        lg[int(tid)] += float(b)
    seen = np.unique(np.asarray(list(prompt) + list(gen), np.int64))
    vals = lg[seen]
    rep = sp.repetition_penalty
    lg[seen] = np.where(vals > 0, vals / rep, vals * rep)
    if gen:
        cnt = np.bincount(np.asarray(gen, np.int64), minlength=len(lg))
        lg -= sp.frequency_penalty * cnt + sp.presence_penalty * (cnt > 0)
    return lg


def assert_decided(je, prompt, tokens, sp=None):
    """Every generated token had a clear greedy choice (under the
    penalties of ``sp`` when given)."""
    if not tokens:
        return
    seq = list(prompt) + list(tokens)
    steps = forward_logits(je, seq[:-1])[len(prompt) - 1:]
    if sp is not None:
        steps = np.stack([penalized(row, prompt, tokens[:i], sp)
                          for i, row in enumerate(steps)])
    assert top2_margins(steps).min() > LOGIT_TOL


def run(eng, prompts, sps, *, ids=None):
    """Queue ``prompts`` (one SamplingParams each, or one for all) and
    step to completion; the outputs in prompt order."""
    if not isinstance(sps, (list, tuple)):
        sps = [sps] * len(prompts)
    ids = ids or [f"r{i}" for i in range(len(prompts))]
    for rid, p, sp in zip(ids, prompts, sps):
        eng.add_request(rid, p, sp)
    done = {}
    while eng.has_unfinished():
        for out in eng.step():
            done[out.request_id] = out
    return [done[rid] for rid in ids]


def assert_same(je, jo, to, prompts, sp=None):
    """Port outputs ``to`` equal JAX outputs ``jo`` exactly, after the
    margin check of each JAX output."""
    for p, a, b in zip(prompts, jo, to):
        toks = (je.tokenizer.encode(p) if isinstance(p, str) else list(p))
        assert_decided(je, toks[: je.max_len - 1], a.token_ids, sp)
        assert b.token_ids == a.token_ids
        assert b.finish_reason == a.finish_reason
        assert b.text == a.text
