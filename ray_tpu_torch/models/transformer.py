"""Decoder-only transformer LM (port of ray_tpu/models/transformer.py).

  - Params are plain nested dicts of tensors with a **stacked layer
    axis** (``[n_layers, ...]`` leaves) and the reference's einsum
    layouts (``wq [L,D,H,Dh]``, ``wo [L,H,Dh,D]``, ``w_in [L,D,F]``), so
    a JAX parameter tree carries across as a pure copy
    (``ray_tpu_torch.interop.params_from_jax``). The forward pass is a
    loop over layers.
  - Compute in ``config.dtype`` (bfloat16 by default), params in
    ``config.param_dtype``, statistics and softmax in float32.
  - Attention dispatches through ``ray_tpu_torch.ops.attention``; with
    ``attn_impl="flash"`` it runs the hand-written Hopper kernel.

Two architectures behind one config:
  - ``arch="gpt2"``  — learned positions, LayerNorm, GELU MLP, tied head.
  - ``arch="llama"`` — RoPE, RMSNorm, SwiGLU, GQA, untied head.

Inference only for now: the loss, the train step, sharding (``mesh``)
and MoE layers arrive with later slices of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ray_tpu_torch.ops.attention import attention, dot_product_attention
from ray_tpu_torch.ops.layers import (
    apply_rope,
    gelu_mlp,
    layer_norm,
    rms_norm,
    rope_frequencies,
    swiglu,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304          # GPT-2 BPE padded to a multiple of 128
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int | None = None    # < n_heads → GQA (llama arch only)
    d_ff: int | None = None          # default: 4*d_model (gpt2), 8/3*d (llama)
    max_seq_len: int = 1024
    arch: str = "gpt2"               # "gpt2" | "llama"
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    tie_embeddings: bool | None = None  # default: True for gpt2, False for llama
    attn_impl: str = "auto"          # ray_tpu_torch.ops.attention dispatch
    # Divisibility contract of attn_impl="flash" (the kernel tiles by its
    # own sizes; a sequence these do not divide raises, as in ray_tpu).
    flash_block_q: int = 256
    flash_block_k: int = 256
    # The fields below configure training in ray_tpu. They are kept so a
    # ray_tpu config carries across field for field; this inference-only
    # slice does not read them.
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    loss_chunk: int = 0
    ce_accuracy: bool = True
    ce_impl: str = "fused"
    # Mixture of Experts (llama arch only; 0 = dense FFN). Parameters can
    # be made; the forward pass raises until MoE is ported.
    n_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.arch == "llama":
            # 8/3 * d rounded up to a multiple of 256
            return ((int(8 * self.d_model / 3) + 255) // 256) * 256
        return 4 * self.d_model

    @property
    def tied(self) -> bool:
        if self.tie_embeddings is not None:
            return self.tie_embeddings
        return self.arch == "gpt2"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def num_params(self) -> int:
        return sum(math.prod(s) for s in _leaves(self.shapes()))

    def shapes(self):
        """Nested dict of parameter shapes, mirroring the param tree."""
        return _tree_map(lambda spec: spec[0], _param_specs(self))


# -- presets ----------------------------------------------------------------

def gpt2_small(**kw) -> TransformerConfig:
    """GPT-2 124M."""
    return replace(TransformerConfig(), **kw)


def gpt2_medium(**kw) -> TransformerConfig:
    return replace(
        TransformerConfig(n_layers=24, d_model=1024, n_heads=16), **kw
    )


def gpt2_xl(**kw) -> TransformerConfig:
    return replace(
        TransformerConfig(n_layers=48, d_model=1600, n_heads=25), **kw
    )


def llama2_7b(**kw) -> TransformerConfig:
    return replace(
        TransformerConfig(
            vocab_size=32000, n_layers=32, d_model=4096, n_heads=32,
            n_kv_heads=32, d_ff=11008, max_seq_len=4096, arch="llama",
        ),
        **kw,
    )


def llama3_8b(**kw) -> TransformerConfig:
    return replace(
        TransformerConfig(
            vocab_size=128256, n_layers=32, d_model=4096, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq_len=8192, arch="llama",
            rope_theta=500000.0,
        ),
        **kw,
    )


def mistral_7b(**kw) -> TransformerConfig:
    """Mistral-7B-v0.1 geometry (GQA 8 kv-heads, 32k positions)."""
    return replace(
        TransformerConfig(
            vocab_size=32000, n_layers=32, d_model=4096, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq_len=32768, arch="llama",
        ),
        **kw,
    )


def qwen2_7b(**kw) -> TransformerConfig:
    """Qwen2-7B geometry (GQA 4 kv-heads, 1M rope theta)."""
    return replace(
        TransformerConfig(
            vocab_size=152064, n_layers=28, d_model=3584, n_heads=28,
            n_kv_heads=4, d_ff=18944, max_seq_len=32768, arch="llama",
            rope_theta=1000000.0,
        ),
        **kw,
    )


def mixtral_8x7b(**kw) -> TransformerConfig:
    """Mixtral-8x7B geometry: Mistral-7B dims with 8 experts, top-2."""
    return mistral_7b(n_experts=8, expert_top_k=2, **kw)


def moe_small(**kw) -> TransformerConfig:
    """Mixtral-style MoE on the small-llama geometry: 8 experts, top-2."""
    defaults = dict(
        vocab_size=32000, n_layers=12, d_model=768, n_heads=12,
        max_seq_len=2048, arch="llama", n_experts=8, expert_top_k=2,
    )
    defaults.update(kw)
    return TransformerConfig(**defaults)


def tiny_moe(**kw) -> TransformerConfig:
    defaults = dict(
        vocab_size=256, n_layers=2, d_model=64, n_heads=4, max_seq_len=128,
        arch="llama", n_experts=4, expert_top_k=2,
    )
    defaults.update(kw)
    return TransformerConfig(**defaults)


def tiny(**kw) -> TransformerConfig:
    """Test-sized model."""
    return replace(
        TransformerConfig(
            vocab_size=256, n_layers=2, d_model=64, n_heads=4,
            max_seq_len=128, remat=False,
        ),
        **kw,
    )


# -- parameter tree -----------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _param_specs(c: TransformerConfig):
    """The parameter tree as (shape, init) leaves; init is "normal"
    (N(0, 0.02)), "residual" (N(0, 0.02/sqrt(2L)), residual-out
    projections), "ones" or "zeros"."""
    if c.n_experts > 0 and c.arch != "llama":
        raise ValueError("MoE (n_experts > 0) requires arch='llama'")
    L, D, H, KV, Dh, F = (
        c.n_layers, c.d_model, c.n_heads, c.kv_heads, c.head_dim, c.ffn_dim,
    )
    specs = {
        "embed": {"tokens": ((c.vocab_size, D), "normal")},
        "layers": {
            "attn": {
                "wq": ((L, D, H, Dh), "normal"),
                "wk": ((L, D, KV, Dh), "normal"),
                "wv": ((L, D, KV, Dh), "normal"),
                "wo": ((L, H, Dh, D), "residual"),
            },
        },
        "final_norm": {"w": ((D,), "ones")},
    }
    layers = specs["layers"]
    if c.arch == "gpt2":
        specs["embed"]["pos"] = ((c.max_seq_len, D), "normal")
        layers["ln1"] = {"w": ((L, D), "ones"), "b": ((L, D), "zeros")}
        layers["ln2"] = {"w": ((L, D), "ones"), "b": ((L, D), "zeros")}
        layers["mlp"] = {
            "w_in": ((L, D, F), "normal"),
            "b_in": ((L, F), "zeros"),
            "w_out": ((L, F, D), "residual"),
            "b_out": ((L, D), "zeros"),
        }
        specs["final_norm"]["b"] = ((D,), "zeros")
    else:
        layers["ln1"] = {"w": ((L, D), "ones")}
        layers["ln2"] = {"w": ((L, D), "ones")}
        if c.n_experts > 0:
            E = c.n_experts
            layers["router"] = {"w": ((L, D, E), "normal")}
            layers["mlp"] = {
                "w_gate": ((L, E, D, F), "normal"),
                "w_up": ((L, E, D, F), "normal"),
                "w_down": ((L, E, F, D), "residual"),
            }
        else:
            layers["mlp"] = {
                "w_gate": ((L, D, F), "normal"),
                "w_up": ((L, D, F), "normal"),
                "w_down": ((L, F, D), "residual"),
            }
    if not c.tied:
        specs["lm_head"] = ((D, c.vocab_size), "normal")
    return specs


def init_params(rng: torch.Generator, config: TransformerConfig, *,
                device="cuda"):
    """Initialize the parameter tree on ``device``.

    Same tree and distributions as ray_tpu's init_params (GPT-2 init:
    N(0, 0.02), residual-out projections scaled by 1/sqrt(2*n_layers));
    the values differ, since ``rng`` is a torch.Generator. Normals are
    drawn on the generator's device, then moved.
    """
    c = config
    pdt = _DTYPES[c.param_dtype]
    std = 0.02
    stds = {"normal": std, "residual": std / math.sqrt(2 * c.n_layers)}

    def make(spec):
        shape, init = spec
        if init == "ones":
            return torch.ones(shape, dtype=pdt, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=pdt, device=device)
        w = torch.randn(shape, generator=rng, dtype=torch.float32,
                        device=rng.device) * stds[init]
        return w.to(device=device, dtype=pdt)

    return _tree_map(make, _param_specs(c))


def _layer_params(layers, i: int):
    """Layer ``i``'s slice of the stacked layer tree (views)."""
    return _tree_map(lambda a: a[i], layers)


# -- forward ----------------------------------------------------------------

def _check_supported(c: TransformerConfig, mesh=None):
    if mesh is not None:
        raise NotImplementedError(
            "sharded forward (mesh=) is not ported yet (ROADMAP.md §1 item 3: "
            "parallel/)")
    if c.n_experts > 0:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP.md §1 item 2: the rest "
            "of the model family)")


def _final_norm(x, params, c):
    if c.arch == "gpt2":
        return layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    return rms_norm(x, params["final_norm"]["w"])


def lm_head(x, params, c):
    """Float32 logits of hidden states ``x`` [..., D] in compute dtype:
    the product of compute-dtype operands accumulated and returned in
    f32 (ray_tpu's einsum with preferred_element_type=float32)."""
    head = params["embed"]["tokens"].T if c.tied else params["lm_head"]
    head = head.to(c.compute_dtype)
    if x.is_cuda and x.dtype != torch.float32:
        # One cuBLAS GEMM on the 16-bit operands with an f32 output (the
        # upcast product below runs ~10x slower on the card's FMA units).
        out = torch.mm(x.reshape(-1, x.shape[-1]), head,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], head.shape[1])
    return x.float() @ head.float()


def forward(params, tokens, config: TransformerConfig, *, mesh=None,
            positions=None, return_aux: bool = False,
            return_hidden: bool = False):
    """Logits for ``tokens`` [B, T] → [B, T, vocab] (float32), computed on
    the device of ``params`` and ``tokens``.

    ``return_aux`` additionally returns the mean per-layer router
    load-balance loss (0 for dense models). ``return_hidden`` skips the
    LM head and returns the final normed hidden states [B, T, D].
    """
    c = config
    _check_supported(c, mesh)
    dt = c.compute_dtype
    _, T = tokens.shape

    x = params["embed"]["tokens"][tokens].to(dt)
    if c.arch == "gpt2":
        if positions is None:
            pos_emb = params["embed"]["pos"][:T]
        else:
            pos_emb = params["embed"]["pos"][positions]
        x = x + pos_emb.to(dt)
        rope = None
    else:
        rope = rope_frequencies(c.head_dim, c.max_seq_len,
                                theta=c.rope_theta, device=x.device)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(c.n_layers):
        x, aux_i = _block(x, _layer_params(params["layers"], i), c,
                          rope=rope, positions=positions)
        aux = aux + aux_i / c.n_layers

    x = _final_norm(x, params, c)
    if return_hidden:
        return (x, aux) if return_aux else x
    logits = lm_head(x, params, c)
    return (logits, aux) if return_aux else logits


def _block(x, lp, c: TransformerConfig, *, rope, positions=None):
    """One transformer block (pre-norm residual)."""
    dt = c.compute_dtype
    if c.arch == "gpt2":
        h = layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"])
    else:
        h = rms_norm(x, lp["ln1"]["w"])
    if c.kv_heads == c.n_heads:
        # Fused QKV: one (d → 3·h·k) matmul; q, k, v are strided views
        # of its output, which the flash kernel reads as they are.
        wqkv = torch.cat(
            [lp["attn"]["wq"].to(dt), lp["attn"]["wk"].to(dt),
             lp["attn"]["wv"].to(dt)],
            dim=-1,
        )  # [d, h, 3k]
        qkv = torch.einsum("btd,dhm->bthm", h, wqkv)
        q, k, v = qkv.split(c.head_dim, dim=-1)
    else:
        q = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wq"].to(dt))
        k = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wk"].to(dt))
        v = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wv"].to(dt))
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
    k, v = _expand_gqa(k, v, c)
    o = attention(q, k, v, causal=True, impl=c.attn_impl,
                  block_q=c.flash_block_q, block_k=c.flash_block_k)
    o = torch.einsum("bthk,hkd->btd", o, lp["attn"]["wo"].to(dt))
    x = x + o

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if c.arch == "gpt2":
        h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"])
        m = gelu_mlp(h, lp["mlp"]["w_in"].to(dt), lp["mlp"]["b_in"].to(dt),
                     lp["mlp"]["w_out"].to(dt), lp["mlp"]["b_out"].to(dt))
    else:
        h = rms_norm(x, lp["ln2"]["w"])
        m = swiglu(h, lp["mlp"]["w_gate"].to(dt), lp["mlp"]["w_up"].to(dt),
                   lp["mlp"]["w_down"].to(dt))
    return x + m, aux


def _expand_gqa(k, v, c: TransformerConfig):
    if c.kv_heads == c.n_heads:
        return k, v
    rep = c.n_heads // c.kv_heads
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


# -- decode (KV cache) ------------------------------------------------------

def init_kv_cache(config: TransformerConfig, batch_size: int, max_len: int,
                  *, device="cuda"):
    """Preallocated decode cache: [L, B, max_len, KV, Dh] per k/v, and
    the next write position ``pos`` (a host int)."""
    c = config
    if c.n_experts > 0:
        raise NotImplementedError(
            "KV-cache decode for MoE models is not implemented yet"
        )
    shape = (c.n_layers, batch_size, max_len, c.kv_heads, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=c.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=c.compute_dtype, device=device),
        "pos": 0,
    }


def decode_step(params, tokens, cache, config: TransformerConfig):
    """One autoregressive step: tokens [B, S] appended at cache['pos'].

    Returns (logits [B, S, V] float32, cache'). The K/V rows are written
    into the cache's tensors in place (ray_tpu returns a new cache);
    cache' shares them and carries pos + S. S=1 for pure decode; S>1 for
    prefill.
    """
    c = config
    _check_supported(c)
    dt = c.compute_dtype
    _, S = tokens.shape
    pos0 = int(cache["pos"])
    if pos0 + S > cache["k"].shape[2]:
        raise ValueError(f"decode past the cache: pos {pos0} + {S} tokens > "
                         f"{cache['k'].shape[2]} rows")
    positions = pos0 + torch.arange(S, device=tokens.device)

    x = params["embed"]["tokens"][tokens].to(dt)
    if c.arch == "gpt2":
        x = x + params["embed"]["pos"][positions].to(dt)
        rope = None
    else:
        rope = rope_frequencies(c.head_dim, c.max_seq_len,
                                theta=c.rope_theta, device=x.device)

    for i in range(c.n_layers):
        lp = _layer_params(params["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        if c.arch == "gpt2":
            h = layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"])
        else:
            h = rms_norm(x, lp["ln1"]["w"])
        q = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wq"].to(dt))
        k = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wk"].to(dt))
        v = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wv"].to(dt))
        if rope is not None:
            q = apply_rope(q, *rope, positions=positions)
            k = apply_rope(k, *rope, positions=positions)
        kc[:, pos0:pos0 + S] = k
        vc[:, pos0:pos0 + S] = v
        kf, vf = _expand_gqa(kc, vc, c)
        # Causality against global positions doubles as the cache-validity
        # mask: unwritten slots sit at k_pos > current positions.
        o = dot_product_attention(q, kf, vf, causal=True,
                                  q_offset=pos0).to(dt)
        o = torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"].to(dt))
        x = x + o
        if c.arch == "gpt2":
            h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"])
            m = gelu_mlp(h, lp["mlp"]["w_in"].to(dt),
                         lp["mlp"]["b_in"].to(dt),
                         lp["mlp"]["w_out"].to(dt),
                         lp["mlp"]["b_out"].to(dt))
        else:
            h = rms_norm(x, lp["ln2"]["w"])
            m = swiglu(h, lp["mlp"]["w_gate"].to(dt),
                       lp["mlp"]["w_up"].to(dt),
                       lp["mlp"]["w_down"].to(dt))
        x = x + m
    x = _final_norm(x, params, c)
    logits = lm_head(x, params, c)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos0 + S}


def generate(params, prompt, config: TransformerConfig, *, max_new_tokens: int,
             temperature: float = 0.0, rng: torch.Generator | None = None,
             max_len: int | None = None):
    """Greedy/temperature sampling loop (prefill + one decode_step per
    token) on the device of ``params``. ``prompt`` [B, T] is a tensor or
    anything ``torch.as_tensor`` takes; returns [B, T + new] tokens."""
    device = params["embed"]["tokens"].device
    prompt = torch.as_tensor(prompt, device=device)
    B, T = prompt.shape
    max_len = min(max_len or T + max_new_tokens, config.max_seq_len)
    # Never decode past the cache/pos-embedding capacity.
    max_new_tokens = min(max_new_tokens, max_len - T)
    if max_new_tokens <= 0:
        return prompt
    cache = init_kv_cache(config, B, max_len, device=device)
    logits, cache = decode_step(params, prompt, cache, config)
    last = logits[:, -1]

    def sample(lg):
        if temperature == 0.0:
            return lg.argmax(-1).to(prompt.dtype)
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0].to(prompt.dtype)

    toks = []
    for i in range(max_new_tokens):
        tok = sample(last)
        toks.append(tok)
        if i + 1 < max_new_tokens:  # the last token's logits are not needed
            logits, cache = decode_step(params, tok[:, None], cache, config)
            last = logits[:, -1]
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
