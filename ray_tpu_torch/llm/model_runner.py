"""Slot-based prefill/decode steps for continuous batching (port of
ray_tpu/llm/model_runner.py).

The KV cache is one preallocated tensor pair of ``max_num_seqs`` slots ×
``max_seq_len`` rows per layer, and continuous batching is expressed as

  - ``prefill``: run one (bucket-padded) prompt through the model and
    write its K/V rows into slot ``s``;
  - ``decode``: ONE step advancing ALL slots together, each at its own
    position (``positions`` vector), with per-slot causal masking
    ``k_pos <= pos[b]``. Inactive/garbage slots are masked out by the
    same rule: rows beyond a slot's position are never attended, and each
    decode write lands exactly at ``pos[b]``, reclaiming any stale row
    before the mask can reach it.

Both steps update the cache in place (ray_tpu donates it to XLA, which
updates it in place on the device). Sampling (greedy / temperature)
happens on the device: only the sampled token ids [B] need to come back
to the host each step.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _expand_gqa,
    _unstack_layers,
    lm_head,
)
from ray_tpu_torch.ops.attention import dot_product_attention
from ray_tpu_torch.ops.layers import (
    apply_rope,
    gelu_mlp,
    layer_norm,
    rms_norm,
    rope_frequencies,
    swiglu,
)


def init_slot_cache(config: TransformerConfig, num_slots: int, max_len: int,
                    *, device="cuda"):
    c = config
    shape = (c.n_layers, num_slots, max_len, c.kv_heads, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=c.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=c.compute_dtype, device=device),
    }


def _norm1(x, lp, c):
    if c.arch == "gpt2":
        return layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"])
    return rms_norm(x, lp["ln1"]["w"])


def _mlp(x, lp, c, dt):
    if c.arch == "gpt2":
        h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"])
        return gelu_mlp(h, lp["mlp"]["w_in"].to(dt), lp["mlp"]["b_in"].to(dt),
                        lp["mlp"]["w_out"].to(dt), lp["mlp"]["b_out"].to(dt))
    h = rms_norm(x, lp["ln2"]["w"])
    return swiglu(h, lp["mlp"]["w_gate"].to(dt), lp["mlp"]["w_up"].to(dt),
                  lp["mlp"]["w_down"].to(dt))


def _final_logits(x, params, c, dt):
    if c.arch == "gpt2":
        x = layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    else:
        x = rms_norm(x, params["final_norm"]["w"])
    return lm_head(x, params, c)


def embed_tokens(params, tokens, positions, c, dt):
    """Token (+ learned-position / rope-table) embedding. Returns (x,
    rope) where rope is None for gpt2 or the (cos, sin) tables for rope
    archs."""
    x = params["embed"]["tokens"][tokens].to(dt)
    if c.arch == "gpt2":
        x = x + params["embed"]["pos"][positions].to(dt)
        return x, None
    return x, rope_frequencies(c.head_dim, c.max_seq_len,
                               theta=c.rope_theta, device=x.device)


def _qkv(h, lp, dt):
    q = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", h, lp["attn"]["wv"].to(dt))
    return q, k, v


def make_prefill_body(c, dt, positions, rope, slot, *, cache_write=None):
    """Per-layer body for whole-prompt prefill: ``body(x, lp, kc, vc)``
    with one layer's params and its k/v cache [slots, T, KV, Dh]; returns
    the layer's output. Shared by prefill() and prefill_batch() (via
    ``cache_write``) so attention/masking/dtype fixes cannot diverge.

    ``cache_write(kc, k)`` writes a layer's new K (or V) rows into the
    cache in place; the default writes one slot's rows at ``slot``.
    """
    if cache_write is None:
        def cache_write(cache_arr, new):
            cache_arr[slot, :new.shape[1]] = new[0]

    def body(x, lp, kc, vc):
        h = _norm1(x, lp, c)
        q, k, v = _qkv(h, lp, dt)
        if rope is not None:
            q = apply_rope(q, *rope, positions=positions)
            k = apply_rope(k, *rope, positions=positions)
        cache_write(kc, k)
        cache_write(vc, v)
        kf, vf = _expand_gqa(k, v, c)
        o = dot_product_attention(q, kf, vf, causal=True).to(dt)
        o = torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"].to(dt))
        x = x + o
        return x + _mlp(x, lp, c, dt)

    return body


def make_decode_body(c, dt, positions, rope_tables, kmask, barange):
    """Per-layer body for the all-slots decode step: ``body(x, lp, kc,
    vc)`` with one layer's k/v cache [B, T, KV, Dh]. ``rope_tables`` are
    the per-slot [B,1,1,Dh/2] cos/sin gathers (None for gpt2). Each
    slot's new row lands at ``kc[b, pos[b]]``."""

    def rot(t):  # t: [B, 1, H, Dh]
        cb, sb = rope_tables
        t1, t2 = t.float().chunk(2, dim=-1)
        return torch.cat([t1 * cb - t2 * sb, t2 * cb + t1 * sb],
                         dim=-1).to(t.dtype)

    def body(x, lp, kc, vc):
        h = _norm1(x, lp, c)
        q, k, v = _qkv(h, lp, dt)
        if rope_tables is not None:
            q, k = rot(q), rot(k)
        kc[barange, positions] = k[:, 0]
        vc[barange, positions] = v[:, 0]
        kf, vf = _expand_gqa(kc, vc, c)  # [B,T,H,Dh]
        scale = 1.0 / (c.head_dim ** 0.5)
        scores = torch.einsum("bshk,bthk->bhst", (q * scale).float(),
                              kf.float())  # [B, H, 1, T]
        scores = torch.where(kmask[:, None, None, :], scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhst,bthk->bshk", p, vf.float()).to(dt)
        o = torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"].to(dt))
        x = x + o
        return x + _mlp(x, lp, c, dt)

    return body


def sample_tokens(logits, temperature, rng):
    """On-device sampling: greedy where temperature == 0, categorical
    otherwise. logits [B, V] float32, temperature [B]."""
    greedy = logits.argmax(-1)
    temp = temperature.clamp_min(1e-6)[:, None]
    probs = torch.softmax(logits / temp, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=rng)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled)


def _run_layers(body, x, params, cache, c):
    for i, lp in enumerate(_unstack_layers(params["layers"])):
        x = body(x, lp, cache["k"][i], cache["v"][i])
    return x


def prefill(params, tokens, true_len: int, slot: int, cache, *,
            config: TransformerConfig):
    """Run one padded prompt [1, S] and write K/V into cache slot.

    Returns (last_logits [V] float32, cache). ``true_len`` is the
    unpadded prompt length; the returned logits are taken at position
    true_len-1, so right-padding never leaks into the first sampled
    token (causal attention at that position only sees real tokens).
    """
    c = config
    dt = c.compute_dtype
    _, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x, rope = embed_tokens(params, tokens, positions, c, dt)
    body = make_prefill_body(c, dt, positions, rope, slot)
    x = _run_layers(body, x, params, cache, c)
    # LM head on the last real token only: prompt logits are never
    # needed, and skipping the [S, V] head matmul saves most of the
    # prefill's head work.
    xl = x[:, true_len - 1:true_len]
    return _final_logits(xl, params, c, dt)[0, 0], cache


def prefill_batch(params, tokens, true_lens, slots, cache, *,
                  config: TransformerConfig):
    """Batched whole-prompt prefill: N same-bucket prompts in one pass.
    tokens [N, S], true_lens [N], slots [N] (host ints) — distinct
    in-range indices for real rows; PAD rows use an OUT-OF-RANGE index
    (>= the slot count) and write nothing (ray_tpu's scatter
    mode="drop"). Returns (last_logits [N, V], cache).

    Each prompt attends only within itself (batched causal attention),
    exactly as N sequential prefill() calls would.
    """
    c = config
    dt = c.compute_dtype
    N, S = tokens.shape
    device = tokens.device
    n_slots = cache["k"].shape[1]
    slots = [int(s) for s in slots]
    rows = [j for j, s in enumerate(slots) if 0 <= s < n_slots]
    dst = torch.tensor([slots[j] for j in rows], device=device)
    src = torch.tensor(rows, device=device)
    positions = torch.arange(S, device=device)
    x, rope = embed_tokens(params, tokens, positions, c, dt)  # [N,S,D]

    def scatter_rows(cache_arr, new):
        cache_arr[dst, :S] = new[src]

    body = make_prefill_body(c, dt, positions, rope, None,
                             cache_write=scatter_rows)
    x = _run_layers(body, x, params, cache, c)
    lens = torch.as_tensor(true_lens, device=device)
    xl = x[torch.arange(N, device=device), lens - 1][:, None]  # [N,1,D]
    return _final_logits(xl, params, c, dt)[:, 0], cache


def decode(params, tokens, positions, cache, temperature, rng, *,
           config: TransformerConfig):
    """One decode step for all slots: tokens [B], positions [B].

    Writes each slot's new K/V row at its own position, attends with the
    per-slot mask ``k_pos <= pos[b]``, samples on the device (greedy
    where temperature == 0, categorical otherwise) and returns
    (sampled_tokens [B], last_logits [B, V] float32, cache).
    """
    c = config
    dt = c.compute_dtype
    B = tokens.shape[0]
    T = cache["k"].shape[2]
    device = tokens.device
    x, rope = embed_tokens(params, tokens[:, None], positions[:, None],
                           c, dt)  # [B,1,D]
    rope_tables = None
    if rope is not None:
        cos, sin = rope
        # Per-slot rotation tables [B, 1, 1, Dh/2].
        rope_tables = (cos[positions][:, None, None, :],
                       sin[positions][:, None, None, :])
    kmask = torch.arange(T, device=device)[None, :] <= positions[:, None]
    body = make_decode_body(c, dt, positions, rope_tables, kmask,
                            torch.arange(B, device=device))
    x = _run_layers(body, x, params, cache, c)
    logits = _final_logits(x, params, c, dt)[:, 0]  # [B, V]
    toks = sample_tokens(logits, temperature, rng)
    return toks, logits, cache
