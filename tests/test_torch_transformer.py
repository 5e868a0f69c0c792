"""The PyTorch port's transformer (ray_tpu_torch.models) against the JAX
package's, on the CPU, from the same parameters carried across by
ray_tpu_torch.interop.params_from_jax.

Tolerance: float32 logits agree to 1e-4 — the two frameworks order the
matmul and softmax sums differently over two layers (the observed gap is
~1e-6). Greedy tokens are compared exactly after checking that every
step's top-2 logit margin exceeds that tolerance, so a near-tie cannot
decide the test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as J
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.models import transformer as T

LOGIT_TOL = 1e-4

ARCHS = {
    "gpt2": dict(dtype="float32"),
    "llama_gqa": dict(dtype="float32", arch="llama", n_kv_heads=2),
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    jc = J.tiny(**ARCHS[request.param])
    tc = T.TransformerConfig(**dataclasses.asdict(jc))
    jp = J.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    return jc, tc, jp, tp


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t))


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def test_param_tree_matches_jax(model):
    jc, tc, jp, _ = model
    mine = T.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    assert _shapes(mine) == _shapes(jp)
    assert tc.num_params() == jc.num_params()
    assert all(v.dtype == torch.float32 for v in _leaves(mine))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("impl", ["reference", "blockwise", "flash"])
def test_forward_matches_jax(model, impl):
    jc, tc, jp, tp = model
    toks = _tokens(2, 64)
    ref = J.forward(jp, jnp.asarray(toks), dataclasses.replace(jc, attn_impl=impl))
    got = T.forward(tp, torch.as_tensor(toks), dataclasses.replace(tc, attn_impl=impl))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_TOL,
                               rtol=0)


def test_decode_step_matches_jax(model):
    """Prefill 10 tokens into the cache, then one decode step."""
    jc, tc, jp, tp = model
    toks = _tokens(2, 11, seed=1)
    jcache = J.init_kv_cache(jc, 2, 32)
    tcache = T.init_kv_cache(tc, 2, 32, device="cpu")
    for sl in (slice(0, 10), slice(10, 11)):
        ref, jcache = J.decode_step(jp, jnp.asarray(toks[:, sl]), jcache, jc)
        got, tcache = T.decode_step(tp, torch.as_tensor(toks[:, sl]), tcache, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOGIT_TOL, rtol=0)
    assert tcache["pos"] == int(jcache["pos"]) == 11


def test_generate_greedy_matches_jax(model):
    jc, tc, jp, tp = model
    prompt = _tokens(2, 5, seed=2)
    ref = np.asarray(J.generate(jp, prompt, jc, max_new_tokens=8))
    logits = np.asarray(J.forward(jp, jnp.asarray(ref[:, :-1]), jc))[:, 4:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > LOGIT_TOL
    got = T.generate(tp, prompt, tc, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_params_from_jax_is_bit_exact_for_bf16():
    jc = J.tiny(param_dtype="bfloat16")
    host = jax.device_get(J.init_params(jax.random.PRNGKey(1), jc))
    tp = params_from_jax(host, device="cpu")
    for a, t in ((host["embed"]["tokens"], tp["embed"]["tokens"]),
                 (host["layers"]["attn"]["wq"], tp["layers"]["attn"]["wq"])):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))


def test_moe_and_mesh_are_refused():
    """MoE models run forward, and only their KV-cache decode is refused,
    as in ray_tpu. mesh= is no longer refused (the sharded forward is held
    against ray_tpu's in test_torch_parallel.py): its layouts,
    partition_specs, mirror the parameter tree leaf for leaf."""
    tc = T.tiny_moe()
    tp = T.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    assert T.TransformerConfig(**dataclasses.asdict(J.tiny_moe())).num_params() \
        == J.tiny_moe().num_params()
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        logits, aux = T.forward(tp, tokens, tc, return_aux=True)
    assert logits.shape == (1, 4, tc.vocab_size) and bool(logits.isfinite().all())
    assert float(aux) > 0.0
    with pytest.raises(NotImplementedError, match="MoE"):
        T.init_kv_cache(tc, 1, 8, device="cpu")
    def check(params, specs):
        assert isinstance(specs, dict) and params.keys() == specs.keys()
        for key, value in params.items():
            if isinstance(value, dict):
                check(value, specs[key])
            else:
                assert specs[key] is None or len(specs[key]) == value.dim(), key

    check(tp, T.partition_specs(tc))
