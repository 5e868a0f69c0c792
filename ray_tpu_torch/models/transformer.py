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

MoE (llama arch, ``n_experts > 0``): each block's FFN is
``ray_tpu_torch.ops.moe.moe_swiglu``, and ``lm_loss`` adds the router's
load-balance loss.

Training: ``lm_loss`` (full, chunked and fused chunked cross-entropy),
``make_train_step`` with the fused clip+AdamW optimizer or an
optax-style one (``ray_tpu_torch.ops.optim``) and gradient
accumulation, and ``remat`` as torch.utils.checkpoint.

Sharding (``mesh``, a DeviceMesh of ray_tpu_torch.parallel): the params
are DTensors laid out by ``partition_specs`` (Megatron-style tensor
parallelism, expert parallelism) and fsdp (``parallel.shard_params``),
the batch over data × fsdp. Each block runs as two sublayers under
``local_map`` on every rank's shards — the attention (its local heads,
through the flash kernel) and the FFN (its share of the hidden units;
of an MoE layer's experts, whose outputs are gathered over the expert
axis) — whose outputs are partial sums over the tensor axis; DTensor
gathers the fsdp-sharded weights before them, reduces their outputs and
carries the gradients back (reduce-scatter for fsdp, all-reduce over
the data axes). Activations are laid out at ray_tpu's points: x after
the embedding and between blocks, and the logits, as (batch, sequence,
...).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.ops.attention import attention, dot_product_attention
from ray_tpu_torch.ops.moe import _group_size, moe_swiglu
from ray_tpu_torch.parallel._collectives import ExpertShard
from ray_tpu_torch.ops.optim import FusedClipAdamW, apply_updates, global_norm
from ray_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    batch_sharding,
)
from ray_tpu_torch.parallel.sharding import P, constrain, to_placements
from ray_tpu_torch.ops.tree import tree_leaves, tree_map, tree_unflatten
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
    # Training. remat: recompute each layer in the backward
    # (torch.utils.checkpoint); remat_policy "dots" keeps the products
    # without a batch dimension. scan_layers is kept so a ray_tpu config
    # carries across field for field: the port always loops over layers.
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    loss_chunk: int = 0
    ce_accuracy: bool = True
    ce_impl: str = "fused"
    # Mixture of Experts (llama arch only; 0 = dense FFN).
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
        return sum(math.prod(s) for s in tree_leaves(self.shapes()))

    def shapes(self):
        """Nested dict of parameter shapes (torch.Size leaves), mirroring
        the param tree."""
        return tree_map(lambda spec: torch.Size(spec[0]), _param_specs(self),
                        is_leaf=_tuple_leaf)


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

def _tuple_leaf(x) -> bool:
    """The leaves of ``_param_specs``' tree: (shape, init) pairs."""
    return type(x) is tuple


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

    return tree_map(make, _param_specs(c), is_leaf=_tuple_leaf)


# -- partitioning -----------------------------------------------------------

def partition_specs(config: TransformerConfig):
    """Megatron-style TP base specs mirroring the param tree.

    Heads / ffn-hidden shard over the ``tensor`` axis so each attention
    and MLP block is a pair of column→row parallel products (one
    reduction per block). Vocab shards over ``tensor`` in the
    embedding/head; experts over ``expert``. FSDP is layered on top by
    parallel.infer_param_specs.
    """
    c = config
    specs = {
        "embed": {"tokens": P(AXIS_TENSOR, None)},
        "layers": {
            "attn": {
                "wq": P(None, None, AXIS_TENSOR, None),
                "wk": P(None, None, AXIS_TENSOR, None),
                "wv": P(None, None, AXIS_TENSOR, None),
                "wo": P(None, AXIS_TENSOR, None, None),
            },
            "ln1": None,
            "ln2": None,
        },
        "final_norm": None,
    }
    if c.arch == "gpt2":
        specs["embed"]["pos"] = P(None, None)
        specs["layers"]["mlp"] = {
            "w_in": P(None, None, AXIS_TENSOR),
            "b_in": P(None, AXIS_TENSOR),
            "w_out": P(None, AXIS_TENSOR, None),
            "b_out": None,
        }
    elif c.n_experts > 0:
        specs["layers"]["router"] = {"w": P(None, None, None)}
        specs["layers"]["mlp"] = {
            "w_gate": P(None, AXIS_EXPERT, None, AXIS_TENSOR),
            "w_up": P(None, AXIS_EXPERT, None, AXIS_TENSOR),
            "w_down": P(None, AXIS_EXPERT, AXIS_TENSOR, None),
        }
    else:
        specs["layers"]["mlp"] = {
            "w_gate": P(None, None, AXIS_TENSOR),
            "w_up": P(None, None, AXIS_TENSOR),
            "w_down": P(None, AXIS_TENSOR, None),
        }
    if not c.tied:
        specs["lm_head"] = P(None, AXIS_TENSOR)
    # Expand None-marked subtrees to per-leaf None specs.
    return _mirror(specs, config.shapes())


def _mirror(specs, shapes):
    """Expand a spec tree with None-subtree shorthands to exactly mirror
    the param tree structure."""
    if isinstance(shapes, dict):
        out = {}
        for k, sub in shapes.items():
            s = specs.get(k) if isinstance(specs, dict) else None
            out[k] = _mirror(s, sub)
        return out
    return specs  # leaf: a P or None


def _unstack_layers(layers):
    """The stacked layer tree as one tree per layer (views). Each leaf is
    split by one ``unbind``: under autograd its backward stacks the
    per-layer gradients once, where indexing ``a[i]`` per layer would
    build a full-size zero gradient of the leaf for every layer."""
    split = [a.unbind(0) for a in tree_leaves(layers)]
    return [tree_unflatten(layers, [s[i] for s in split]) for i in range(len(split[0]))]


# -- forward ----------------------------------------------------------------

_BATCH = (AXIS_DATA, AXIS_FSDP)


def _final_norm(x, params, c):
    if c.arch == "gpt2":
        return layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    return rms_norm(x, params["final_norm"]["w"])


def _matmul_f32(a, b):
    """``a [..., K] @ b [K, N]`` accumulated and returned in f32 from
    operands in their own dtype (ray_tpu's einsum with
    preferred_element_type=float32)."""
    if (a.is_cuda and a.dtype != torch.float32 and b.dtype == a.dtype
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))):
        # One cuBLAS GEMM on the 16-bit operands with an f32 output (the
        # upcast product below runs ~10x slower on the card's FMA units).
        # That GEMM has no gradient, so under autograd the operands are
        # upcast instead.
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[1])
    return a.float() @ b.float()


def _head_leaf(params, c):
    """The parameter the LM head is (tied: the token embedding)."""
    return params["embed"]["tokens"] if c.tied else params["lm_head"]


def _as_head(w, c):
    """The LM head [D, V] in compute dtype from its parameter ``w``."""
    return (w.T if c.tied else w).to(c.compute_dtype)


def lm_head(x, params, c):
    """Float32 logits of hidden states ``x`` [..., D] in compute dtype."""
    return _matmul_f32(x, _as_head(_head_leaf(params, c), c))


def _embed(tokens, embed, c: TransformerConfig, positions=None):
    """Token (and, for gpt2, position) embeddings of ``tokens`` [B, T] in
    compute dtype."""
    dt = c.compute_dtype
    x = embed["tokens"][tokens].to(dt)
    if c.arch == "gpt2":
        if positions is None:
            pos_emb = embed["pos"][:tokens.shape[1]]
        else:
            pos_emb = embed["pos"][positions]
        x = x + pos_emb.to(dt)
    return x


def forward(params, tokens, config: TransformerConfig, *, mesh=None,
            positions=None, return_aux: bool = False,
            return_hidden: bool = False):
    """Logits for ``tokens`` [B, T] → [B, T, vocab] (float32), computed on
    the device of ``params`` and ``tokens``.

    ``mesh`` runs the sharded forward (params as ``parallel.shard_params``
    lays them out; tokens a plain tensor, the same on every rank, or a
    DTensor): the logits and hidden states come back as DTensors laid out
    (batch over data+fsdp, sequence, vocab over tensor), the aux as a
    plain tensor. ``return_aux`` additionally returns the mean per-layer
    router load-balance loss (0 for dense models). ``return_hidden`` skips
    the LM head and returns the final normed hidden states [B, T, D].
    """
    c = config
    batch, seq = _present(mesh, _BATCH), _present(mesh, (AXIS_SEQUENCE,))
    act = P(_BATCH, AXIS_SEQUENCE, None)
    embed = list(tree_leaves(params["embed"]))

    def embed_local(tokens, *leaves):
        return _embed(tokens, tree_unflatten(params["embed"], leaves), c, positions)

    x = _sharded(embed_local, mesh, [tokens, *embed], [P(_BATCH, None)] + [P()] * len(embed),
                 [(P(_BATCH, None, None), ())], batch)
    x = constrain(x, mesh, *act)
    layer = functools.partial(
        _block, c=c, mesh=mesh, specs=tree_map(_layer_spec, partition_specs(c)["layers"]),
        rope=_rope(c, x.device), positions=positions,
        expert_shard=(ExpertShard(mesh, AXIS_EXPERT, c.n_experts)
                      if c.n_experts > 0 and _present(mesh, (AXIS_EXPERT,)) else None))
    if c.remat and torch.is_grad_enabled():
        layer = _checkpointed(layer, c.remat_policy)
    aux = None
    for lp in _unstack_layers(params["layers"]):
        x, aux_i = layer(x, lp)
        if c.n_experts > 0:
            aux = aux_i / c.n_layers if aux is None else aux + aux_i / c.n_layers
    aux = (_whole(aux) if aux is not None
           else torch.zeros((), dtype=torch.float32, device=x.device))

    norm = list(tree_leaves(params["final_norm"]))

    def norm_local(x, *leaves):
        return _final_norm(x, {"final_norm": tree_unflatten(params["final_norm"], leaves)}, c)

    x = _sharded(norm_local, mesh, [x, *norm], [act] + [P()] * len(norm), [(act, ())],
                 batch + seq)
    if return_hidden:
        return (x, aux) if return_aux else x

    def head_local(x, w):
        return _matmul_f32(x, _as_head(w, c))

    logits = _sharded(head_local, mesh, [x, _head_leaf(params, c)], [act, P()], [(act, ())],
                      batch + seq)
    logits = constrain(logits, mesh, _BATCH, AXIS_SEQUENCE, AXIS_TENSOR)
    return (logits, aux) if return_aux else logits


def _rope(c: TransformerConfig, device):
    """RoPE's (cos, sin) tables for the llama arch, None for gpt2."""
    if c.arch == "gpt2":
        return None
    return rope_frequencies(c.head_dim, c.max_seq_len, theta=c.rope_theta,
                            device=device)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat_policy="dots" (jax's
    dots_with_no_batch_dims_saveable): keep the products without a batch
    dimension — the projections and MLP matmuls, which torch runs as mm,
    addmm or a bmm over a batch of one — and recompute the rest, the
    attention's batched products included."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, policy: str):
    """``fn`` recomputed in the backward (ray_tpu's jax.checkpoint):
    everything for any policy but "dots", which keeps what _save_dots
    saves."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _block(x, lp, c: TransformerConfig, *, mesh, specs, rope, positions, expert_shard):
    """One transformer block (pre-norm residual): the attention and the
    FFN sublayer, each on every rank's shards (``_sharded``; ``specs``
    lays out one layer's leaves), each output a partial sum over the
    tensor axis, which splits the heads and the hidden units."""
    batch, seq = _present(mesh, _BATCH), _present(mesh, (AXIS_SEQUENCE,))
    tensor = _present(mesh, (AXIS_TENSOR,))
    leaves = list(tree_leaves(lp))
    leaf_specs = _leaf_specs(lp, specs)

    def attn_local(x, cos, sin, *leaves):
        rope = None if cos is None else (cos, sin)
        return _attention(x, tree_unflatten(lp, leaves), c, rope=rope, positions=positions)

    # The sequence is gathered: attention sees all of it (ray_tpu's GSPMD
    # gathers K/V); every sequence rank computes the same.
    o = _sharded(attn_local, mesh, [x, *(rope or (None, None)), *leaves],
                 [P(_BATCH, None, None), None, None, *leaf_specs],
                 [(P(_BATCH, None, None), tensor)], batch + tensor)
    x = x + _laid_out_as(o, x)

    moe_kw, ffn_in, ffn_partial = {}, P(_BATCH, AXIS_SEQUENCE, None), batch + seq + tensor
    # A term every rank of the tensor axis would add (gpt2's b_out, the
    # router aux) is added by the first of them only, so the partial sums
    # add it once.
    first = _coordinate(mesh, AXIS_TENSOR)[0] == 0
    aux_scale = float(first)
    if c.n_experts > 0:
        # Each rank routes whole groups of the global batch (of
        # moe_swiglu's default size): its own rows where they hold a whole
        # number of groups, else all of them.
        B, S = x.shape[:2]
        n_batch = math.prod(_coordinate(mesh, a)[1] for a in batch)
        g = _group_size(B * S, 1024)
        aligned = B % n_batch == 0 and (B // n_batch * S) % g == 0
        ffn_in = P(_BATCH if aligned else None, None, None)
        ffn_partial = (batch if aligned else ()) + tensor
        moe_kw = dict(group_size=g, constrain_fn=expert_shard)
        if aligned:  # a batch shard's aux is its share of the mean over groups
            aux_scale /= n_batch

    def ffn_local(x, *leaves):
        lp_ = tree_unflatten(lp, leaves)
        if c.arch == "gpt2" and not first:
            lp_["mlp"]["b_out"] = lp_["mlp"]["b_out"] * 0.0
        m, aux = _ffn(x, lp_, c, **moe_kw)
        return m, (aux if aux_scale == 1.0 else aux * aux_scale)

    m, aux = _sharded(ffn_local, mesh, [x, *leaves], [ffn_in, *leaf_specs],
                      [(ffn_in, tensor), (P(), ffn_partial)], ffn_partial)
    return x + _laid_out_as(m, x), aux


def _attention(x, lp, c: TransformerConfig, *, rope, positions=None):
    """A block's attention sublayer without its residual: ln1, the q/k/v
    products, RoPE, attention over every head ``lp`` holds and the output
    product."""
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
    return torch.einsum("bthk,hkd->btd", o, lp["attn"]["wo"].to(dt))


def _ffn(x, lp, c: TransformerConfig, **moe_kw):
    """A block's FFN sublayer without its residual: (out, router aux).
    ``moe_kw`` goes to moe_swiglu (the group size and the expert split)."""
    dt = c.compute_dtype
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if c.arch == "gpt2":
        h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"])
        m = gelu_mlp(h, lp["mlp"]["w_in"].to(dt), lp["mlp"]["b_in"].to(dt),
                     lp["mlp"]["w_out"].to(dt), lp["mlp"]["b_out"].to(dt))
    elif c.n_experts > 0:
        # The weights go in uncast: moe_swiglu runs the router in f32 and
        # casts the experts to x's dtype itself.
        h = rms_norm(x, lp["ln2"]["w"])
        m, aux = moe_swiglu(
            h, lp["router"]["w"], lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
            lp["mlp"]["w_down"], top_k=c.expert_top_k,
            capacity_factor=c.expert_capacity_factor, **moe_kw)
    else:
        h = rms_norm(x, lp["ln2"]["w"])
        m = swiglu(h, lp["mlp"]["w_gate"].to(dt), lp["mlp"]["w_up"].to(dt),
                   lp["mlp"]["w_down"].to(dt))
    return m, aux


def _expand_gqa(k, v, c: TransformerConfig):
    if c.kv_heads == c.n_heads:
        return k, v
    rep = c.n_heads // c.kv_heads
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


# -- sharding -------------------------------------------------------------------

def _present(mesh, axes) -> tuple:
    """The axes of ``axes`` that ``mesh`` has, in their order (none
    without a mesh)."""
    return () if mesh is None else tuple(a for a in axes if a in mesh.mesh_dim_names)


def _coordinate(mesh, axis: str) -> tuple[int, int]:
    """(this rank's index, size) along ``axis``; (0, 1) where it is absent."""
    if axis not in _present(mesh, (axis,)):
        return 0, 1
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_local_rank(dim), mesh.size(dim)


def _sharded(fn, mesh, args, specs, outs, partial_axes=()):
    """``fn`` on every rank's shards of ``args``, under local_map; without
    a mesh, ``fn`` on views of ``args``.

    ``args`` and ``specs`` are two flat lists: a P lays an arg out (a
    plain tensor is taken as the whole value, which every rank holds), a
    None passes it to ``fn`` as it is. ``outs`` holds one (P, axes the
    output is a partial sum over) per output of ``fn``. ``partial_axes``
    are the axes whose work this call divides among their ranks (those
    sharding its activations, and the tensor axis of its weights): the
    gradient of an arg not sharded over one of them is each
    rank's share, a partial sum over it; over the other axes every rank
    computes the same, so it is replicated there.
    """
    if mesh is None:
        # Views, as local_map hands fn each shard: autograd then sums an
        # arg's gradients in the same order, so that a mesh of one gives
        # the same bits.
        return fn(*(a if s is None or a is None else a.view_as(a)
                    for a, s in zip(args, specs)))
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    in_pl, grad_pl, placed = [], [], []
    for arg, spec in zip(args, specs):
        if spec is None:
            in_pl.append(None)
            grad_pl.append(None)
            placed.append(arg)
            continue
        if not isinstance(arg, DTensor):
            arg = DTensor.from_local(arg, mesh, [Replicate()] * len(names),
                                     run_check=False)
        pl = tuple(to_placements(spec, mesh))
        in_pl.append(pl)
        grad_pl.append(tuple(
            p if isinstance(p, Shard) else Partial() if name in partial_axes else Replicate()
            for name, p in zip(names, pl)))
        placed.append(arg)
    out_pl = tuple(
        [Partial() if name in partial and isinstance(p, Replicate) else p
         for name, p in zip(names, to_placements(spec, mesh))]
        for spec, partial in outs)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*placed)


def _whole(t):
    """A DTensor's whole value on every rank; a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _laid_out_as(t, like):
    """``t`` in the layout of ``like`` (plain tensors: ``t``)."""
    if isinstance(t, DTensor) and t.placements != like.placements:
        return t.redistribute(like.device_mesh, like.placements)
    return t


def _layer_spec(spec):
    """A stacked leaf's spec for one layer's slice (its layer dim gone)."""
    return P() if spec is None else P(*spec[1:])


def _leaf_specs(tree, specs) -> list:
    """The specs of the leaves of ``tree`` (in tree_leaves order), looked
    up by key in ``specs`` (P() where it has None)."""
    out = []

    def walk(t, s):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, s.get(k) if isinstance(s, dict) else None)
        else:
            out.append(P() if s is None else s)

    walk(tree, specs)
    return out


# -- loss / train step ------------------------------------------------------

def _perplexity(loss):
    return torch.exp(torch.clamp(loss, max=20.0))


def _ce_sums(logits, targets, mask, z_loss):
    """(Σ nll·mask, Σ correct·mask) of logits [..., V] against targets
    (mask None: every token counts 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    correct = (logits.argmax(-1) == targets).float()
    if mask is None:
        return nll.sum(), correct.sum()
    mask = mask.float()
    return (nll * mask).sum(), (correct * mask).sum()


def _ce_denom(targets, mask):
    """The tokens a CE means over: all of them, or max(Σ mask, 1)."""
    if mask is None:
        return targets.numel()
    return mask.float().sum().clamp_min(1.0)


def cross_entropy_loss(logits, targets, *, mask=None, z_loss: float = 0.0):
    """Token-level CE in float32 with optional z-loss regularizer.

    logits [B,T,V] (any dtype; upcast), targets [B,T] int, mask [B,T]
    (1 = contributes). Returns (scalar loss, dict metrics).
    """
    nll_sum, correct_sum = _ce_sums(logits, targets, mask, z_loss)
    denom = _ce_denom(targets, mask)
    loss = nll_sum / denom
    acc = correct_sum / denom
    return loss, {"loss": loss, "accuracy": acc, "perplexity": _perplexity(loss)}


def _ce_chunk_stats(logits, tb, mb, z_loss, accuracy):
    """Shared per-chunk CE statistics: (nll_masked_sum, correct_masked_sum,
    lse). logits fp32 [c,V]; tb [c] int; mb [c] fp32."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tb[:, None].long())[:, 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    correct = (((logits.argmax(-1) == tb).float() * mb).sum() if accuracy
               else torch.zeros((), dtype=torch.float32, device=logits.device))
    return (nll * mb).sum(), correct, lse


def _ce_chunk(xb, head, tb, mb, z_loss, accuracy):
    nll_s, corr_s, _ = _ce_chunk_stats(_matmul_f32(xb, head), tb, mb, z_loss,
                                       accuracy)
    return nll_s, corr_s


def _flat_mask(mask, n, device):
    return (mask.reshape(n).float() if mask is not None
            else torch.ones((n,), dtype=torch.float32, device=device))


def _chunked_ce_sums(x, head, targets, mask, z_loss, chunk, accuracy):
    """chunked_ce_loss's (Σ nll·mask, Σ correct·mask)."""
    B, T, D = x.shape
    N = B * T
    xf = x.reshape(N, D)
    tf = targets.reshape(N)
    mf = _flat_mask(mask, N, x.device)
    chunk = min(chunk, N)
    nll_sum = correct_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, N, chunk):
        sl = slice(s, s + chunk)
        nll_s, corr_s = checkpoint(_ce_chunk, xf[sl], head, tf[sl], mf[sl],
                                   z_loss, accuracy, use_reentrant=False)
        nll_sum = nll_sum + nll_s
        correct_sum = correct_sum + corr_s
    return nll_sum, correct_sum


def chunked_ce_loss(x, head, targets, *, mask=None, z_loss: float = 0.0,
                    chunk: int = 2048, accuracy: bool = True, denom=None):
    """CE over a chunked LM head: x [B,T,D] (final hidden), head [D,V].

    Logits exist only a chunk at a time, each chunk under
    torch.utils.checkpoint: the backward recomputes its logits instead of
    keeping the [B,T,V] float32 tensor alive. ``denom`` is the count the
    sums are divided by (default: the tokens ``mask`` keeps; the sharded
    loss passes the global batch's)."""
    nll_sum, correct_sum = _chunked_ce_sums(x, head, targets, mask, z_loss, chunk,
                                            accuracy)
    if denom is None:
        B, T, _ = x.shape
        denom = _flat_mask(mask, B * T, x.device).sum().clamp_min(1.0)
    loss = nll_sum / denom
    acc = correct_sum / denom
    return loss, {"loss": loss, "accuracy": acc, "perplexity": _perplexity(loss)}


def _fused_ce_scan(x, head, targets, mask, denom, z_loss, chunk, accuracy,
                   want_grads):
    """Loop over token chunks. Returns ((nll_sum, correct_sum), grads):
    with want_grads, grads is (dx [N,D] f32, dhead [D,V] f32), the
    gradients of x/head for a unit loss gradient of nll_sum / ``denom``,
    already including the 1/denom and z_loss terms; else None."""
    N, D = x.shape
    chunk = min(chunk, N)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    correct_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    dhead = (torch.zeros((D, head.shape[1]), dtype=torch.float32, device=x.device)
             if want_grads else None)
    dxs = []
    for s in range(0, N, chunk):
        xb, tb, mb = x[s:s + chunk], targets[s:s + chunk], mask[s:s + chunk]
        logits = _matmul_f32(xb, head)
        nll_s, corr_s, lse = _ce_chunk_stats(logits, tb, mb, z_loss, accuracy)
        nll_sum += nll_s
        correct_sum += corr_s
        if not want_grads:
            continue
        # dloss/dlogits for loss = sum(nll*m)/denom:
        #   (softmax * (1 + 2*z*lse) - onehot) * m / denom
        # computed in place over the chunk's logits.
        dl = logits.sub_(lse[:, None]).exp_()
        if z_loss:
            dl.mul_((1.0 + 2.0 * z_loss * lse)[:, None])
        dl[torch.arange(xb.shape[0], device=x.device), tb.long()] -= 1.0
        dl.mul_((mb / denom)[:, None])
        # 16-bit product operands, f32 accumulation: the same precision as
        # the rest of the model's backward.
        dlc = dl.to(head.dtype)
        dxs.append(_matmul_f32(dlc, head.t()))
        dhead += _matmul_f32(xb.to(head.dtype).t(), dlc)
    grads = (torch.cat(dxs), dhead) if want_grads else None
    return (nll_sum, correct_sum), grads


class _FusedChunkedCE(torch.autograd.Function):
    """fused_chunked_ce_loss: the gradients are computed in the forward
    loop (dlogits = softmax - onehot), so each chunk's logits product runs
    once per train step, and kept as the residuals in x's and head's
    dtypes (ray_tpu's _fused_ce_fwd); the backward scales them by the
    incoming loss gradient. The accuracy carries no gradient. ``denom``
    is the count the sums are divided by (the sharded loss passes the
    global batch's)."""

    @staticmethod
    def forward(ctx, x, head, targets, mask, denom, z_loss, chunk, accuracy):
        want = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        (nll_sum, correct_sum), grads = _fused_ce_scan(
            x, head, targets, mask, denom, z_loss, chunk, accuracy, want_grads=want)
        if want:
            dx, dhead = grads
            ctx.save_for_backward(dx.to(x.dtype), dhead.to(head.dtype))
        acc = correct_sum / denom
        ctx.mark_non_differentiable(acc)
        return nll_sum / denom, acc

    @staticmethod
    def backward(ctx, g_loss, g_acc):
        dx, dhead = ctx.saved_tensors
        return ((dx * g_loss).to(dx.dtype), (dhead * g_loss).to(dhead.dtype),
                None, None, None, None, None, None)


def fused_chunked_ce_loss(x, head, targets, mask, z_loss, chunk, accuracy, denom=None):
    """Chunked LM-head CE whose gradient is computed in the forward loop.
    x [N,D] (flattened final hidden), head [D,V], targets [N] int, mask
    [N] f32. Returns (loss, acc). A call that needs no gradient (eval)
    skips the gradient work. ``denom`` as chunked_ce_loss's."""
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    return _FusedChunkedCE.apply(x, head, targets, mask, denom, z_loss, chunk, accuracy)


def _split_batch(batch):
    """(inputs, targets, mask of the targets or None) of an LM batch."""
    if "inputs" in batch:
        return batch["inputs"], batch["targets"], batch.get("mask")
    toks = batch["tokens"]
    mask = batch.get("mask")
    return toks[:, :-1], toks[:, 1:], (mask[:, 1:] if mask is not None else None)


def lm_loss(params, batch, config: TransformerConfig, *, mesh=None,
            z_loss: float = 0.0):
    """Next-token LM loss. batch: {"tokens": [B,T]} (targets = shift) or
    {"inputs","targets"[,"mask"]}.

    For MoE models the loss adds ``router_aux_weight`` times the router's
    load-balance loss; the metrics report it as ``router_aux`` and
    ``loss`` is the total (``perplexity`` stays the cross-entropy's).
    With ``mesh`` the forward is sharded (see ``forward``) and the loss
    and metrics are plain tensors, the same on every rank."""
    c = config
    inp, tgt, mask = _split_batch(batch)
    # Each rank sums the CE over its own tokens and divides by the global
    # batch's count, so the loss is the sum of the ranks' shares. The vocab
    # is gathered: the head (or the logits) enters each rank whole, where
    # ray_tpu's GSPMD keeps it sharded over ``tensor`` and reduces the
    # softmax's max and sum across it — the same loss.
    shards = _present(mesh, _BATCH) + _present(mesh, (AXIS_SEQUENCE,))
    tok = P(_BATCH, AXIS_SEQUENCE)
    mask_spec = tok if mask is not None else None
    # A tensor, as the sum of the mask (a Python number divides otherwise).
    denom = _whole(mask.float().sum().clamp_min(1.0) if mask is not None
                   else torch.full((), float(tgt.numel()), device=tgt.device))
    if c.loss_chunk <= 0:
        logits, aux = forward(params, inp, c, mesh=mesh, return_aux=True)

        def ce_local(logits, tgt, mask):
            nll_sum, correct_sum = _ce_sums(logits, tgt, mask, z_loss)
            return nll_sum / denom, correct_sum / denom

        args, specs = [logits, tgt, mask], [P(_BATCH, AXIS_SEQUENCE, None), tok, mask_spec]
    else:
        _check_ce_impl(c)
        x, aux = forward(params, inp, c, mesh=mesh, return_aux=True, return_hidden=True)

        def ce_local(x, w, tgt, mask):
            head = _as_head(w, c)
            if c.ce_impl == "checkpoint":
                loss, metrics = chunked_ce_loss(
                    x, head, tgt, mask=mask, z_loss=z_loss, chunk=c.loss_chunk,
                    accuracy=c.ce_accuracy, denom=denom)
                return loss, metrics["accuracy"]
            B, T, D = x.shape
            return fused_chunked_ce_loss(
                x.reshape(B * T, D), head, tgt.reshape(-1), _flat_mask(mask, B * T, x.device),
                float(z_loss), int(c.loss_chunk), bool(c.ce_accuracy), denom=denom)

        args = [x, _head_leaf(params, c), tgt, mask]
        specs = [P(_BATCH, AXIS_SEQUENCE, None), P(), tok, mask_spec]
    loss, acc = _sharded(ce_local, mesh, args, specs, [(P(), shards)] * 2, shards)
    loss, acc = _whole(loss), _whole(acc)
    metrics = {"loss": loss, "accuracy": acc, "perplexity": _perplexity(loss)}
    if c.n_experts > 0:
        loss = loss + c.router_aux_weight * aux
        metrics = dict(metrics, router_aux=aux, loss=loss)
    return loss, metrics


def _check_ce_impl(config):
    if config.ce_impl not in ("fused", "checkpoint"):
        raise ValueError(
            f"ce_impl must be 'fused' or 'checkpoint', got {config.ce_impl!r}")


def _micro_weight(mb):
    """Valid-TARGET-token count of a microbatch: lm_loss means over it,
    so weighting by it reproduces the full-batch per-token mean."""
    mask = mb.get("mask")
    if mask is not None:
        m = mask[:, 1:] if "tokens" in mb else mask
        return m.float().sum()
    toks = mb["tokens"] if "tokens" in mb else mb["targets"]
    n_t = toks.shape[0] * (toks.shape[1] - (1 if "tokens" in mb else 0))
    return torch.tensor(float(n_t), device=toks.device)


def loss_and_grads(params, batch, config: TransformerConfig, *, mesh=None,
                   z_loss: float = 0.0):
    """(metrics, grads): lm_loss's metrics, detached, and the gradient of
    its loss for every parameter leaf in ``tree_leaves`` order, by
    torch.autograd.grad (a leaf the loss does not reach gets zeros, as
    jax.grad gives). With ``mesh`` each gradient is a DTensor laid out as
    its parameter (the data-parallel partial sums reduced)."""
    leaves = list(tree_leaves(params))
    live = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = lm_loss(tree_unflatten(params, live), batch, config, mesh=mesh,
                            z_loss=z_loss)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _laid_out_as(g, p)
             for p, g in zip(leaves, grads)]
    return {k: m.detach() for k, m in metrics.items()}, grads


def _place_batch(batch, mesh, device):
    """A batch's leaves as the train step takes them: tensors on
    ``device``; with a mesh, DTensors split over the batch axes (a plain
    leaf is the global batch, the same on every rank)."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for k, v in batch.items():
        if mesh is None or not isinstance(v, DTensor):
            v = torch.as_tensor(v, device=device)
        if mesh is not None and not isinstance(v, DTensor):
            v = distribute_tensor(v, mesh, batch_sharding(mesh), src_data_rank=None)
        out[k] = v
    return out


def make_train_step(config: TransformerConfig, optimizer, *, mesh=None,
                    z_loss: float = 0.0, accum_steps: int = 1):
    """Build the training step ``train_step(state, batch) -> (state,
    metrics)``; state is {"params", "opt_state", "step"} (see
    init_train_state) and metrics hold lm_loss's plus ``grad_norm``.

    Gradients come from torch.autograd.grad over the parameter leaves.
    ``accum_steps > 1`` splits every batch leaf's leading dim into
    microbatches, accumulates their gradients in f32 weighted by each
    microbatch's valid-token count (so masked batches match the
    unaccumulated step's per-token weighting), weights every metric
    (``router_aux`` too) the same way, and applies the optimizer once.

    ``optimizer`` is the port's ``FusedClipAdamW`` (one pass: clip, AdamW
    and the update) or any optax-style ``GradientTransformation`` (the
    port's own in ray_tpu_torch.ops.optim): its ``update(grads,
    opt_state, params)`` gives the updates, which are added to the
    parameters. Either way the parameters are updated IN PLACE, so the
    returned state holds the tensors of ``state["params"]`` (ray_tpu
    returns new arrays).

    ``mesh``: the sharded step. The params (and the optimizer state made
    from them) are DTensors, as ``parallel.shard_params`` lays them out;
    a batch leaf is the global batch (a plain tensor, the same on every
    rank, split here over the batch axes; each microbatch is a slice of
    it) or a DTensor. Gradients take their parameters' layouts; the
    optimizer updates each rank's shards in place; metrics are plain
    tensors, the same on every rank.
    """
    fused = isinstance(optimizer, FusedClipAdamW)

    grads_of = functools.partial(loss_and_grads, config=config, mesh=mesh, z_loss=z_loss)

    def accumulated(params, batch, device):
        batch = {k: v.full_tensor() if isinstance(v, DTensor) else v
                 for k, v in batch.items()}
        for key, x in batch.items():
            if x.shape[0] % accum_steps:
                raise ValueError(f"batch dim {x.shape[0]} of {key!r} not "
                                 f"divisible by accum_steps {accum_steps}")
        splits = {k: torch.as_tensor(x, device=device).chunk(accum_steps)
                  for k, x in batch.items()}
        micro = [{k: x[i] for k, x in splits.items()} for i in range(accum_steps)]
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
        msum, wsum = None, 0.0
        for mb in micro:
            metrics, grads = grads_of(params, _place_batch(mb, mesh, device))
            w = _micro_weight(mb)
            for a, g in zip(gsum, grads):
                a.add_(w * g.float())
            msum = ({k: w * m for k, m in metrics.items()} if msum is None
                    else {k: msum[k] + w * m for k, m in metrics.items()})
            wsum = wsum + w
        inv = 1.0 / torch.clamp(wsum, min=1.0)
        return ({k: m * inv for k, m in msum.items()},
                [g * inv for g in gsum])

    def step(state, batch):
        params = state["params"]
        device = next(tree_leaves(params)).device
        if accum_steps > 1:
            metrics, grads = accumulated(params, batch, device)
        else:
            metrics, grads = grads_of(params, _place_batch(batch, mesh, device))
        grads = tree_unflatten(params, grads)
        if fused:
            params, opt_state, gnorm = optimizer.apply(grads, state["opt_state"],
                                                       params)
        else:
            updates, opt_state = optimizer.update(grads, state["opt_state"], params)
            params = apply_updates(params, updates)
            gnorm = global_norm(grads)
        metrics = dict(metrics, grad_norm=gnorm)
        return {"params": params, "opt_state": opt_state,
                "step": state["step"] + 1}, metrics

    def train_step(state, batch):
        if mesh is None:
            return step(state, batch)
        from torch.distributed.tensor.experimental import implicit_replication

        # Scalars (the microbatch weights, the optimizers' norms and bias
        # corrections) meet DTensors as values every rank holds.
        with implicit_replication():
            return step(state, batch)

    return train_step


def init_train_state(rng: torch.Generator, config: TransformerConfig,
                     optimizer, *, device="cuda"):
    """{"params", "opt_state", "step"} on ``device`` (see init_params)."""
    params = init_params(rng, config, device=device)
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


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
    if c.n_experts > 0:  # as init_kv_cache: no cache is made for MoE
        raise NotImplementedError(
            "KV-cache decode for MoE models is not implemented yet")
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

    for i, lp in enumerate(_unstack_layers(params["layers"])):
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
