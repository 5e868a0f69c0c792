"""The PyTorch port's ops (ray_tpu_torch.ops) against the JAX package's,
on the CPU, from the same numpy inputs.

JAX's flash_attention runs its Pallas kernels (forward, dq, dk/dv) in
interpret mode here, as the JAX suite runs them (test_ops_parallel.py);
the port's flash_attention runs its plain PyTorch versions (the CUDA
kernels are held against those versions on the card by chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import layers as jl
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import layers as tl

JA = importlib.import_module("ray_tpu.ops.attention")
TA = importlib.import_module("ray_tpu_torch.ops.attention")


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _qkv(b=2, t=128, h=4, d=32, tk=None, seed=0):
    tk = tk or t
    return (_rand(b, t, h, d, seed=seed), _rand(b, tk, h, d, seed=seed + 1),
            _rand(b, tk, h, d, seed=seed + 2))


def _both(fn_jax, fn_torch, *arrays, **kw):
    ref = fn_jax(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_torch(*(torch.from_numpy(a) for a in arrays), **kw)
    return ref, got


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


# -- layers.py: f32, atol 1e-6 --------------------------------------------

def _rope_case(positions):
    cos, sin = jl.rope_frequencies(16, 32)
    x = _rand(2, 8, 3, 16)
    ref = jl.apply_rope(jnp.asarray(x), cos, sin,
                        positions=None if positions is None
                        else jnp.asarray(positions))
    tcos, tsin = tl.rope_frequencies(16, 32, device="cpu")
    got = tl.apply_rope(torch.from_numpy(x), tcos, tsin,
                        positions=None if positions is None
                        else torch.as_tensor(positions))
    return ref, got


LAYER_CASES = {
    "rms_norm": lambda: _both(jl.rms_norm, tl.rms_norm, _rand(2, 8, 32),
                              _rand(32, seed=1)),
    "layer_norm": lambda: _both(jl.layer_norm, tl.layer_norm,
                                _rand(2, 8, 32), _rand(32, seed=1),
                                _rand(32, seed=2)),
    "rope_frequencies": lambda: (jl.rope_frequencies(16, 32)[0],
                                 tl.rope_frequencies(16, 32, device="cpu")[0]),
    "rope_frequencies_sin": lambda: (jl.rope_frequencies(16, 32)[1],
                                     tl.rope_frequencies(16, 32, device="cpu")[1]),
    "apply_rope": lambda: _rope_case(None),
    "apply_rope_positions": lambda: _rope_case([3, 5, 7, 9, 11, 13, 15, 31]),
    "swiglu": lambda: _both(jl.swiglu, tl.swiglu, _rand(2, 8, 32),
                            _rand(32, 48, seed=1, scale=0.2),
                            _rand(32, 48, seed=2, scale=0.2),
                            _rand(48, 32, seed=3, scale=0.2)),
    "gelu_mlp": lambda: _both(jl.gelu_mlp, tl.gelu_mlp, _rand(2, 8, 32),
                              _rand(32, 48, seed=1, scale=0.2),
                              _rand(48, seed=2, scale=0.2),
                              _rand(48, 32, seed=3, scale=0.2),
                              _rand(32, seed=4, scale=0.2)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layers_match_jax(case):
    ref, got = LAYER_CASES[case]()
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-6, rtol=0)


# -- attention tiers: f32, 2e-5 (the JAX suite's forward tolerance) ---------

@pytest.mark.parametrize("causal,t,tk,q_offset", [
    (True, 64, 64, 0), (False, 64, 64, 0), (True, 4, 16, 12),
])
def test_dot_product_attention_matches_jax(causal, t, tk, q_offset):
    q, k, v = _qkv(t=t, tk=tk)
    ref, got = _both(JA.dot_product_attention, TA.dot_product_attention,
                     q, k, v, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,t", [(True, 128), (False, 100)])
def test_blockwise_attention_matches_jax(causal, t):
    """t=100 with 32-key blocks exercises the key-padding path."""
    q, k, v = _qkv(t=t)
    ref, got = _both(JA.blockwise_attention, TA.blockwise_attention,
                     q, k, v, causal=causal, block_k=32)
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_matches_jax_kernel(causal):
    q, k, v = _qkv(t=128)
    ref = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, 64, 64)
    got = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal, 64, 64)
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_jax_kernel(causal):
    q, k, v = _qkv(t=128)
    _, ref = JA._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=64, block_k=64,
                               interpret=True, return_lse=True)
    _, got = TA._flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               block_q=64, block_k=64, return_lse=True)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=0)


def test_flash_bf16_rounds_p_like_jax_kernel():
    """bf16 inputs: p is rounded to v's dtype per key block before p·v;
    same blocks on both sides, so only the frameworks' bf16 rounding of
    the output differs (one bf16 ulp at |O| < 2 is 2^-7)."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(t=128))
    ref = JA.flash_attention(q, k, v, True, 64, 64)
    tq, tk_, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))
                                    ).bfloat16() for a in (q, k, v))
    got = TA.flash_attention(tq, tk_, tv, True, 64, 64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), atol=2 ** -7, rtol=0)


def test_flash_rejects_non_dividing_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=100))
    with pytest.raises(ValueError, match="must divide blocks"):
        TA.flash_attention(q, k, v, True, 64, 64)
    with pytest.raises(ValueError, match="must divide blocks"):
        JA.flash_attention(*(jnp.asarray(a) for a in _qkv(t=100)),
                           True, 64, 64)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["reference", "blockwise", "flash",
                                  "flash_jax", "auto"])
def test_attention_dispatch_matches_jax(impl, causal):
    q, k, v = _qkv(t=128)
    ref, got = _both(JA.attention, TA.attention, q, k, v, causal=causal,
                     impl=impl, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-5, rtol=2e-5)


def test_flash_kernel_wrapper_never_runs_on_cpu():
    """The CUDA wrapper raises for a CPU tensor instead of computing:
    only _flash_forward picks the plain version, and only for CPU."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=64, d=64))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_fwd(q, k, v, causal=True, return_lse=False)
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA"):
        TA.flash_attention(*meta, True, 64, 64)


def test_flash_plain_skips_blocks_above_diagonal_exactly():
    """The plain version's early exit over key blocks wholly above the
    diagonal gives the same result as processing every block."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=32, tk=128))
    o, lse = TA.flash_forward_plain(q, k, v, causal=True, block_k=32)
    ref = TA.dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_np(o), _np(ref), atol=2e-5, rtol=2e-5)
    assert lse.shape == (2 * 4, 32, 1)


# -- flash backward: f32, 2e-4 (the JAX suite's backward tolerance) ---------

@pytest.mark.parametrize("causal,t,tk", [(True, 64, 64), (False, 64, 64),
                                         (True, 32, 64)])
def test_flash_backward_plain_matches_jax_kernels(causal, t, tk):
    """The plain backward against the Pallas dq and dk/dv kernels in
    interpret mode, from the same q, k, v, dO and the JAX forward's O and
    LSE, in 32-row blocks; t=32 < tk=64 leaves a causal key block that no
    query attends to (its dK/dV are zero)."""
    q, k, v = _qkv(b=1, t=t, tk=tk, h=2, d=16)
    do = _rand(1, t, 2, 16, seed=9)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = JA._flash_forward(jq, jk, jv, causal=causal, block_q=32,
                               block_k=32, interpret=True, return_lse=True)
    ref = JA._flash_backward(jq, jk, jv, o, lse, jdo, causal=causal,
                             block_q=32, block_k=32, interpret=True)
    got = TA.flash_backward_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)),
        causal=causal, block_q=32, block_k=32)
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), _np(r), atol=2e-4, rtol=2e-4, err_msg=name)
    if causal and tk > t:
        assert not got[1][:, t:].any() and not got[2][:, t:].any()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match_jax(causal):
    """Gradients of flash_attention through autograd against jax.grad of
    the JAX flash_attention (Pallas backward in interpret mode), with a
    non-trivial cotangent across several q/k blocks
    (test_ops_parallel.py::test_flash_backward_kernels_multiblock)."""
    q, k, v = _qkv(b=2, t=128, h=2, d=32)
    w = np.random.RandomState(7).randn(32).astype(np.float32)

    def jloss(q, k, v):
        out = JA.flash_attention(q, k, v, causal, 32, 64)
        return (jnp.tanh(out @ w) * jnp.cos(out.sum(-1))).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TA.flash_attention(tq, tk, tv, causal, 32, 64)
    loss = (torch.tanh(out @ torch.from_numpy(w)) * torch.cos(out.sum(-1))).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        np.testing.assert_allclose(_np(g), _np(r), atol=2e-4, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("impl", ["flash", "flash_jax"])
def test_flash_gradient_through_fused_qkv_views(impl):
    """q, k, v as strided views of one fused projection (as the model
    makes them) and an incoming gradient whose last axis is not
    contiguous: the gradient of the projection matches plain attention's."""
    qkv = torch.from_numpy(_rand(2, 64, 4, 48)).requires_grad_()
    g = torch.from_numpy(_rand(2, 64, 16, 4, seed=3)).transpose(-1, -2)
    assert g.stride(-1) != 1
    grads = []
    for which in (impl, "reference"):
        q, k, v = qkv.split(16, dim=-1)
        out = TA.attention(q, k, v, causal=True, impl=which, block_q=32, block_k=32)
        grads.append(torch.autograd.grad(out, qkv, g)[0])
    np.testing.assert_allclose(_np(grads[0]), _np(grads[1]), atol=2e-5, rtol=2e-5)


def test_flash_backward_rejects_non_dividing_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=64))
    o, lse = TA.flash_forward_plain(q, k, v, causal=True, block_k=64)
    with pytest.raises(ValueError, match="must divide blocks"):
        TA._flash_backward(q, k, v, o, lse, o, causal=True, block_q=48, block_k=64)


def test_flash_backward_kernel_wrappers_never_run_on_cpu():
    """The backward wrappers raise for CPU tensors instead of computing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=64, d=64))
    lse = torch.zeros((2 * 4, 64, 1))
    for fn in (_kernels.flash_bwd_dq, _kernels.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, q, lse, lse, causal=True)


def test_flash_forward_without_grad_keeps_no_graph():
    """Inference takes the forward alone: no autograd node is built."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=64))
    assert TA.flash_attention(q, k, v, True, 32, 32).grad_fn is None
    with torch.no_grad():
        out = TA.flash_attention(q.requires_grad_(), k, v, True, 32, 32)
    assert out.grad_fn is None
