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

Beside them: continuation prefill (``prefill_at``, chunks and prefix
hits), the dense prefix cache's row copies (``read_prefix`` /
``install_prefix``), speculative verification (``verify``), the extended
sampling program (``advanced_sample``) and the multi-LoRA hooks.

Every step updates the cache in place (ray_tpu donates it to XLA, which
updates it in place on the device). Sampling (greedy / temperature)
happens on the device: only the sampled token ids [B] need to come back
to the host each step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _expand_gqa,
    _unstack_layers,
    lm_head,
    partition_specs,
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


# -- tensor parallelism ---------------------------------------------------------

def serving_mesh(axis: str, size: int, device_type: str, option: str):
    """The 1-D mesh of ``size`` ranks along ``axis`` that this rank serves
    in, over the default process group; with more ranks than ``size``, the
    rest form further meshes beside it (a ``data`` dim), each serving
    alone. A collective: every rank of the group calls it. Too few ranks
    raise ValueError (the counterpart of ray_tpu's "only N devices
    visible"), as does a world that ``size`` does not divide."""
    from ray_tpu_torch.parallel import MeshConfig

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < size:
        raise ValueError(f"{option}={size} but only {world} ranks in the "
                         f"process group")
    mesh = MeshConfig(**{axis: size}).build(device_type)
    return mesh[axis] if mesh.ndim > 1 else mesh


class TensorParallel:
    """One rank's part of tensor-parallel serving over a 1-D ``tensor``
    mesh (ray_tpu shards the same layout with GSPMD). Heads and FFN hidden
    units split over the mesh (``models.partition_specs``), and the vocab
    in the embedding and the head; each rank holds its shards as plain
    tensors, and the runner's shared pieces meet the other ranks through
    explicit collectives on them:

      - the embedding: a masked lookup in this rank's rows, one all-reduce;
      - attention and the FFN: column-parallel in, row-parallel out, one
        all-reduce after each output projection (``_wo_proj``, ``_mlp``);
      - the head: each rank's vocab shard, all-gathered whole.

    The slot cache holds this rank's kv heads. Explicit collectives on
    local tensors, not DTensor: gloo gathers through DTensor crash ranks
    holding CUDA tensors, where all_reduce and all_gather_into_tensor work
    (tests/gloo_cuda_report.py), so two gloo ranks can share one card.

    The runner functions the engine calls are methods here, with this
    split bound in (``tp=self``)."""

    def __init__(self, mesh):
        from ray_tpu_torch.parallel._collectives import axis_group
        from ray_tpu_torch.parallel.mesh import AXIS_TENSOR

        self.mesh = mesh
        self.group, self.rank, self.size = axis_group(mesh, AXIS_TENSOR)

    def shard_params(self, params, config: TransformerConfig):
        """This rank's shards of a whole parameter tree, as plain tensors
        (every rank passes the same tree; nothing is sent)."""
        from ray_tpu_torch.ops.tree import tree_map
        from ray_tpu_torch.parallel import shard_params

        placed, _ = shard_params(params, self.mesh, partition_specs(config))
        return tree_map(lambda t: t.to_local(), placed)

    def reduce(self, x):
        """The sum over the ranks of their partial ``x``."""
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def lookup(self, table, tokens):
        """Rows ``tokens`` of a table split over its rows (the vocab): each
        rank looks up the ids in its range, zeros elsewhere, and the sum
        over the ranks is exact."""
        n = table.shape[0]
        local = tokens - self.rank * n
        rows = table[local.clamp(0, n - 1)]
        inside = ((local >= 0) & (local < n))[..., None]
        return self.reduce(torch.where(inside, rows, torch.zeros_like(rows)))

    def gather_vocab(self, logits):
        """[..., V/n] vocab shards -> [..., V] on every rank."""
        lead, width = logits.shape[:-1], logits.shape[-1]
        part = logits.reshape(-1, width).contiguous()
        out = part.new_empty((self.size * part.shape[0], width))
        dist.all_gather_into_tensor(out, part, group=self.group)
        return out.view(self.size, -1, width).transpose(0, 1).reshape(*lead, -1)

    def lora(self, tree):
        """This rank's part of LoRAManager.lora_tree() (views): the
        column-parallel targets' B factors keep this rank's output columns,
        the row-parallel output projection's A factor its input rows."""
        out = dict(tree)
        for tgt, f in tree.items():
            if tgt == "scales":
                continue
            a, b = f["A"], f["B"]
            if tgt == "wo":
                n = a.shape[2] // self.size
                a = a[:, :, self.rank * n:(self.rank + 1) * n]
            else:
                n = b.shape[-1] // self.size
                b = b[..., self.rank * n:(self.rank + 1) * n]
            out[tgt] = {"A": a, "B": b}
        return out

    def init_slot_cache(self, config: TransformerConfig, num_slots: int,
                        max_len: int, *, device="cuda"):
        """This rank's part of the slot cache: its kv heads, dim 3 of
        [L, B, T, KV, Dh]."""
        c = config
        shape = (c.n_layers, num_slots, max_len, c.kv_heads // self.size, c.head_dim)
        return {"k": torch.zeros(shape, dtype=c.compute_dtype, device=device),
                "v": torch.zeros(shape, dtype=c.compute_dtype, device=device)}

    def prefill(self, *args, **kw):
        return prefill(*args, tp=self, **kw)

    def prefill_batch(self, *args, **kw):
        return prefill_batch(*args, tp=self, **kw)

    def prefill_at(self, *args, **kw):
        return prefill_at(*args, tp=self, **kw)

    def verify(self, *args, **kw):
        return verify(*args, tp=self, **kw)

    def decode(self, *args, **kw):
        return decode(*args, tp=self, **kw)


def _norm1(x, lp, c):
    if c.arch == "gpt2":
        return layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"])
    return rms_norm(x, lp["ln1"]["w"])


def _mlp(x, lp, c, dt, tp=None):
    """The FFN sublayer. Under tensor parallelism each rank holds its
    share of the hidden units: the output projection's partial sums meet
    in one all-reduce, and the output bias is added once after it."""
    m = lp["mlp"]
    if c.arch == "gpt2":
        h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"])
        b_out = m["b_out"].to(dt)
        out = gelu_mlp(h, m["w_in"].to(dt), m["b_in"].to(dt), m["w_out"].to(dt),
                       b_out if tp is None else 0.0)
        return out if tp is None else tp.reduce(out) + b_out
    h = rms_norm(x, lp["ln2"]["w"])
    out = swiglu(h, m["w_gate"].to(dt), m["w_up"].to(dt), m["w_down"].to(dt))
    return out if tp is None else tp.reduce(out)


def _final_logits(x, params, c, dt, tp=None):
    """Float32 logits; under tensor parallelism each rank's vocab shard's,
    gathered so every rank holds all of them."""
    if c.arch == "gpt2":
        x = layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    else:
        x = rms_norm(x, params["final_norm"]["w"])
    logits = lm_head(x, params, c)
    return logits if tp is None else tp.gather_vocab(logits)


def _token_rows(params, tokens, dt, tp=None):
    """The token embedding's rows for ``tokens``; under tensor parallelism
    the table is split over the vocab (TensorParallel.lookup)."""
    table = params["embed"]["tokens"]
    return (table[tokens] if tp is None else tp.lookup(table, tokens)).to(dt)


def embed_tokens(params, tokens, positions, c, dt, tp=None):
    """Token (+ learned-position / rope-table) embedding. Returns (x,
    rope) where rope is None for gpt2 or the (cos, sin) tables for rope
    archs."""
    x = _token_rows(params, tokens, dt, tp)
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


def _lora_layers_xs(lora):
    """Stacked adapter factors {target: {"A": [n, L, ...], "B": ...}} ->
    one {target: {"A": [n, ...], "B": ...}} per layer (views)."""
    targets = [t for t in lora if t != "scales"]
    n_layers = lora[targets[0]]["A"].shape[1]
    return [{t: {"A": lora[t]["A"][:, i], "B": lora[t]["B"][:, i]}
             for t in targets} for i in range(n_layers)]


def _lora_qkv(h, q, k, v, ll, lora_ctx, dt):
    """Add each projection's gathered low-rank delta (zero for rows on
    the null adapter)."""
    from ray_tpu_torch.llm.lora import lora_delta

    aix, scales = lora_ctx
    out = {"wq": q, "wk": k, "wv": v}
    for tgt, t in out.items():
        if tgt in ll:
            d = lora_delta(h, ll[tgt], aix, scales).to(dt)
            out[tgt] = t + d.reshape(t.shape)
    return out["wq"], out["wk"], out["wv"]


def _wo_proj(o, lp, ll, lora_ctx, dt, tp=None):
    """Output projection with optional LoRA delta (the delta's input is
    the flattened [B, S, H*Dh] attention output). Under tensor
    parallelism ``o`` holds this rank's heads: its partial product (and
    LoRA delta) meets the other ranks' in one all-reduce."""
    out = torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"].to(dt))
    if ll is not None and "wo" in ll:
        from ray_tpu_torch.llm.lora import lora_delta

        aix, scales = lora_ctx
        flat = o.reshape(o.shape[0], o.shape[1], -1)
        out = out + lora_delta(flat, ll["wo"], aix, scales).to(dt)
    return out if tp is None else tp.reduce(out)


def make_prefill_body(c, dt, positions, rope, slot, *, cache_write=None,
                      lora_ctx=None, tp=None):
    """Per-layer body for whole-prompt prefill: ``body(x, lp, kc, vc,
    ll)`` with one layer's params, its k/v cache and its LoRA factors
    (None without LoRA); returns the layer's output. Shared by
    prefill(), prefill_batch() and the paged prefills (via
    ``cache_write``) so attention/masking/dtype fixes cannot diverge.

    ``cache_write(kc, k)`` writes a layer's new K (or V) rows into the
    cache in place; the default writes one slot's rows at ``slot``.
    ``lora_ctx`` is (per-row adapter index [B], per-adapter scales).
    ``tp`` (TensorParallel) runs the layer on this rank's heads and
    hidden units.
    """
    if cache_write is None:
        def cache_write(cache_arr, new):
            cache_arr[slot, :new.shape[1]] = new[0]

    def body(x, lp, kc, vc, ll=None):
        h = _norm1(x, lp, c)
        q, k, v = _qkv(h, lp, dt)
        if ll is not None:
            # Batched multi-adapter LoRA (S-LoRA-style gather; see
            # ray_tpu_torch.llm.lora): per-row adapter index, one pass.
            q, k, v = _lora_qkv(h, q, k, v, ll, lora_ctx, dt)
        if rope is not None:
            q = apply_rope(q, *rope, positions=positions)
            k = apply_rope(k, *rope, positions=positions)
        cache_write(kc, k)
        cache_write(vc, v)
        kf, vf = _expand_gqa(k, v, c)
        o = dot_product_attention(q, kf, vf, causal=True).to(dt)
        x = x + _wo_proj(o, lp, ll, lora_ctx, dt, tp)
        return x + _mlp(x, lp, c, dt, tp)

    return body


def make_decode_body(c, dt, positions, rope_tables, kmask, barange,
                     lora_ctx=None, cache_update=None, cache_view=None, tp=None):
    """Per-layer body for the all-slots decode step: ``body(x, lp, kc,
    vc, ll)`` with one layer's k/v cache. ``rope_tables`` are the
    per-slot [B,1,1,Dh/2] cos/sin gathers (None for gpt2).

    ``cache_update(kc, new [B,KV,Dh])`` writes each slot's new row in
    place (default: at ``kc[b, pos[b]]``), and ``cache_view(kc) -> [B,
    T, KV, Dh]`` is how attention sees the cache (default: identity) —
    together they let the paged runner (llm/kv_pages.py) route the same
    body through a page pool."""
    if cache_update is None:
        def cache_update(cache_arr, new):
            cache_arr[barange, positions] = new
    if cache_view is None:
        def cache_view(cache_arr):
            return cache_arr

    def rot(t):  # t: [B, 1, H, Dh]
        cb, sb = rope_tables
        t1, t2 = t.float().chunk(2, dim=-1)
        return torch.cat([t1 * cb - t2 * sb, t2 * cb + t1 * sb],
                         dim=-1).to(t.dtype)

    def body(x, lp, kc, vc, ll=None):
        h = _norm1(x, lp, c)
        q, k, v = _qkv(h, lp, dt)
        if ll is not None:
            q, k, v = _lora_qkv(h, q, k, v, ll, lora_ctx, dt)
        if rope_tables is not None:
            q, k = rot(q), rot(k)
        cache_update(kc, k[:, 0])
        cache_update(vc, v[:, 0])
        kf, vf = _expand_gqa(cache_view(kc), cache_view(vc), c)  # [B,T,H,Dh]
        scale = 1.0 / (c.head_dim ** 0.5)
        scores = torch.einsum("bshk,bthk->bhst", (q * scale).float(),
                              kf.float())  # [B, H, 1, T]
        scores = torch.where(kmask[:, None, None, :], scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhst,bthk->bshk", p, vf.float()).to(dt)
        x = x + _wo_proj(o, lp, ll, lora_ctx, dt, tp)
        return x + _mlp(x, lp, c, dt, tp)

    return body


def sample_tokens(logits, temperature, rng):
    """On-device sampling: greedy where temperature == 0, categorical
    otherwise. logits [B, V] float32, temperature [B]."""
    greedy = logits.argmax(-1)
    temp = temperature.clamp_min(1e-6)[:, None]
    probs = torch.softmax(logits / temp, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=rng)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled)


# -- extended sampling --------------------------------------------------


def penalize_logits(logits, counts, prompt_mask, presence, frequency,
                    repetition):
    """Apply OpenAI presence/frequency penalties (generated tokens) and
    the HF repetition penalty (prompt + generated) to logits [B, V].

    counts [B, V] int — per-slot generated-token histogram;
    prompt_mask [B, V] bool — token appeared in the prompt.
    """
    seen_gen = counts > 0
    seen_any = seen_gen | prompt_mask
    rep = repetition[:, None]
    logits = torch.where(
        seen_any, torch.where(logits > 0, logits / rep, logits * rep), logits)
    logits = logits - presence[:, None] * seen_gen.to(logits.dtype)
    return logits - frequency[:, None] * counts.to(logits.dtype)


_NEG_INF_SAMPLE = -1e30


def _sort_desc(x):
    """Stable descending sort along the last axis: ties keep the lower
    index first, as jax.lax.top_k orders them."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def filter_top_k_top_p(logits, top_k, top_p, min_p=None):
    """Mask logits outside the per-row top-k / nucleus-p / min-p sets
    to -1e30.

    top_k [B] int (<= 0 disables); top_p [B] float32 (1.0 disables);
    min_p [B] float32 (vLLM semantics: drop tokens with probability
    below min_p * max_prob; 0.0 disables). Ties at the top-k threshold
    keep every tied token.
    """
    _, V = logits.shape
    sorted_desc = _sort_desc(logits).values
    # top-k threshold: the k-th largest value (k clamped into [1, V]).
    k = torch.where(top_k <= 0, V, top_k).clamp(1, V).long()
    kth = sorted_desc.gather(-1, (k - 1)[:, None])
    keep = logits >= kth
    # nucleus: keep the smallest prefix of the sorted distribution whose
    # cumulative probability reaches top_p (the crossing token is kept).
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    in_nucleus = (cum - probs_sorted) < top_p[:, None]
    # top_p == 0.0 would otherwise give an empty nucleus: always keep the
    # argmax (the host mirror's keep_sorted[0] = True).
    in_nucleus[:, 0] = True
    big = torch.where(in_nucleus, sorted_desc, torch.inf)
    p_thresh = big.min(dim=-1, keepdim=True).values
    keep = keep & (logits >= p_thresh)
    if min_p is not None:
        # prob(tok) < min_p * prob(argmax)  <=>
        # logit < max_logit + log(min_p); argmax always survives.
        max_logit = logits.max(dim=-1, keepdim=True).values
        mp = min_p.clamp(0.0, 1.0)[:, None]
        keep = keep & torch.where(
            mp > 0.0, logits >= max_logit + torch.log(mp.clamp_min(1e-10)),
            True)
    return torch.where(keep, logits, _NEG_INF_SAMPLE)


_M32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """(x * m) mod 2^32 for int64 tensors x in [0, 2^32): the product is
    taken in 16-bit halves of m so no intermediate passes 2^63."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """A 32-bit integer mix (lowbias32) of int64 tensors in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniforms(seeds, steps, vocab: int):
    """Uniforms in (0, 1) [B, V] as float64, a pure function of (seed,
    step, token id) computed with integer ops only, so a slot's stream
    does not depend on what else the batch holds, nor on the device.
    The port's stand-in for jax.random.fold_in(PRNGKey(seed), step)."""
    s = seeds.long() & _M32
    t = steps.long() & _M32
    ids = torch.arange(vocab, device=seeds.device, dtype=torch.long)
    h = _hash32(_hash32(s)[:, None] ^ _mul32(t, 0x9E3779B9)[:, None])
    h = _hash32(h ^ _mul32(ids, 0x85EBCA6B)[None, :])
    return ((h >> 8).double() + 0.5) * 2.0 ** -24


def seeded_categorical(logits, seeds, steps):
    """One draw per row from softmax(logits) by Gumbel-max over
    counter_uniforms; rows whose logits are -1e30 never win."""
    u = counter_uniforms(seeds, steps, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return (logits.double() + gumbel).argmax(-1)


def advanced_sample(logits, temps, top_ks, top_ps, min_ps, presence,
                    frequency, repetition, counts, prompt_mask, seeds,
                    steps, bias_ids=None, bias_vals=None,
                    *, max_logprobs: int = 0):
    """Extended sampling program (vLLM SamplingParams parity), run on
    the logits the decode step returns when any active slot needs more
    than greedy/temperature.

    Order (vLLM): penalties -> temperature -> top_k/top_p -> sample.
    Per-slot determinism: a slot's draw is a function of (seed, step)
    only (seeded_categorical), so a request's sample stream is
    independent of batch composition. ray_tpu draws with
    fold_in(PRNGKey(seed), step), which torch cannot reproduce: the same
    seed gives the same stream here, not the JAX engine's.

    Returns (tokens [B], chosen_logprob [B] f32, top_vals [B, N],
    top_ids [B, N] (N = max_logprobs; empty when 0), counts) where
    ``counts`` is updated in place to include the sampled token.
    """
    B, V = logits.shape
    pen = penalize_logits(logits, counts, prompt_mask, presence, frequency,
                          repetition)
    if bias_ids is not None:
        # OpenAI logit_bias: fixed-width per-slot scatter-add (padded
        # entries carry bias 0.0, so a padding id of 0 is a no-op).
        pen = pen.scatter_add(1, bias_ids.long(), bias_vals.to(pen.dtype))
    greedy = pen.argmax(-1)
    scaled = pen / temps.clamp_min(1e-6)[:, None]
    filtered = filter_top_k_top_p(scaled, top_ks, top_ps, min_ps)
    sampled = seeded_categorical(filtered, seeds, steps)
    toks = torch.where(temps <= 0.0, greedy, sampled)
    # Logprobs over the distribution actually sampled from (greedy rows
    # report over the penalized distribution — vLLM reports from the
    # final processed distribution).
    dist = torch.where(temps[:, None] <= 0.0, pen, filtered)
    logp = torch.log_softmax(dist, dim=-1)
    chosen_lp = logp.gather(-1, toks[:, None])[:, 0]
    if max_logprobs > 0:
        top = _sort_desc(logp)
        top_vals = top.values[:, :max_logprobs]
        top_ids = top.indices[:, :max_logprobs]
    else:
        top_vals = logp.new_zeros((B, 0))
        top_ids = toks.new_zeros((B, 0))
    counts[torch.arange(B, device=counts.device), toks] += 1
    return toks, chosen_lp, top_vals, top_ids, counts


def reset_slot_sampling(counts, prompt_mask, slot: int, prompt_hist,
                        first_tok: int):
    """Re-initialize one slot's penalty state at admit time, in place:
    generated counts = just the first sampled token; prompt_mask = the
    prompt's token set."""
    counts[slot] = 0
    counts[slot, first_tok] = 1
    prompt_mask[slot] = prompt_hist.to(prompt_mask.dtype)
    return counts, prompt_mask


# -- prefill / decode ----------------------------------------------------


def _run_layers(body, x, params, cache, c, lora=None):
    layers = _unstack_layers(params["layers"])
    lls = [None] * len(layers) if lora is None else _lora_layers_xs(lora)
    for i, (lp, ll) in enumerate(zip(layers, lls)):
        x = body(x, lp, cache["k"][i], cache["v"][i], ll)
    return x


def _lora_ctx(lora, lora_ix):
    return None if lora is None else (lora_ix, lora["scales"])


def prefill(params, tokens, true_len: int, slot: int, cache, *,
            config: TransformerConfig, lora=None, lora_ix=None, tp=None):
    """Run one padded prompt [1, S] and write K/V into cache slot.

    Returns (last_logits [V] float32, cache). ``true_len`` is the
    unpadded prompt length; the returned logits are taken at position
    true_len-1, so right-padding never leaks into the first sampled
    token (causal attention at that position only sees real tokens).
    ``lora`` is LoRAManager.lora_tree() and ``lora_ix`` [1] the row's
    adapter index. ``tp`` (TensorParallel): ``params`` and ``cache`` are
    this rank's shards, and every rank gets the whole logits.
    """
    c = config
    dt = c.compute_dtype
    _, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x, rope = embed_tokens(params, tokens, positions, c, dt, tp)
    body = make_prefill_body(c, dt, positions, rope, slot,
                             lora_ctx=_lora_ctx(lora, lora_ix), tp=tp)
    x = _run_layers(body, x, params, cache, c, lora)
    # LM head on the last real token only: prompt logits are never
    # needed, and skipping the [S, V] head matmul saves most of the
    # prefill's head work.
    xl = x[:, true_len - 1:true_len]
    return _final_logits(xl, params, c, dt, tp)[0, 0], cache


def prefill_batch(params, tokens, true_lens, slots, cache, *,
                  config: TransformerConfig, lora=None, lora_ix=None, tp=None):
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
    x, rope = embed_tokens(params, tokens, positions, c, dt, tp)  # [N,S,D]

    def scatter_rows(cache_arr, new):
        cache_arr[dst, :S] = new[src]

    body = make_prefill_body(c, dt, positions, rope, None,
                             cache_write=scatter_rows,
                             lora_ctx=_lora_ctx(lora, lora_ix), tp=tp)
    x = _run_layers(body, x, params, cache, c, lora)
    lens = torch.as_tensor(true_lens, device=device)
    xl = x[torch.arange(N, device=device), lens - 1][:, None]  # [N,1,D]
    return _final_logits(xl, params, c, dt, tp)[:, 0], cache


def _offset_embed(params, tokens, positions, c, dt, tp=None):
    """Embedding of rows at global ``positions`` (any shape matching
    ``tokens``): padding rows may index past the position tables, so the
    positions are clamped — those rows are masked out of every later
    attention anyway. Returns (x, safe positions)."""
    safe_pos = positions.clamp_max(c.max_seq_len - 1)
    x = _token_rows(params, tokens, dt, tp)
    if c.arch == "gpt2":
        x = x + params["embed"]["pos"][safe_pos].to(dt)
    return x, safe_pos


def prefill_at(params, tokens, true_len: int, pos0: int, slot: int, cache,
               *, config: TransformerConfig, tp=None):
    """Continuation prefill: write a prompt chunk [1, S] into slot rows
    [pos0, pos0+S) and attend over the slot's full history.

    Unlike ``prefill`` (pos0 == 0, attention within the chunk), each
    query row here also attends to the K/V already in the slot — rows
    written by an installed prefix-cache entry (install_prefix) or by
    earlier chunks of a chunked prefill. Masking is positional
    (``k_pos <= pos0 + i``), so stale rows beyond the written history
    are never attended. Returns (last_logits [V] float32, cache).

    Raises ValueError when pos0 + S passes the cache, where ray_tpu's
    dynamic_update_slice would clamp the start and shift the write onto
    earlier rows (the engines never pass such a chunk).
    """
    _, S = tokens.shape
    T = cache["k"].shape[2]
    if pos0 < 0 or pos0 + S > T:
        raise ValueError(f"chunk rows [{pos0}, {pos0 + S}) pass the cache "
                         f"length {T}")

    def cache_write(cache_arr, new):
        cache_arr[slot, pos0:pos0 + S] = new[0]

    return chunk_prefill(params, tokens, true_len, pos0, cache, config=config,
                         cache_write=cache_write,
                         cache_view=lambda cache_arr: cache_arr[slot:slot + 1],
                         tp=tp)


def chunk_prefill(params, tokens, true_len: int, pos0: int, cache, *,
                  config: TransformerConfig, cache_write, cache_view, tp=None):
    """A chunk [1, S] at global positions [pos0, pos0+S) attending over
    its sequence's history, shared by prefill_at (a dense slot) and
    kv_pages.paged_prefill_at (a block table): ``cache_write(kc, k)``
    writes the chunk's rows in place and ``cache_view(kc) -> [1, T, KV,
    Dh]`` is the sequence's history, masked by position."""
    c = config
    dt = c.compute_dtype
    _, S = tokens.shape
    positions = pos0 + torch.arange(S, device=tokens.device)
    x, safe_pos = _offset_embed(params, tokens, positions, c, dt, tp)
    rope = (None if c.arch == "gpt2" else
            rope_frequencies(c.head_dim, c.max_seq_len, theta=c.rope_theta,
                             device=x.device))

    def body(x, lp, kc, vc, ll=None):
        h = _norm1(x, lp, c)
        q, k, v = _qkv(h, lp, dt)
        if rope is not None:
            q = apply_rope(q, *rope, positions=safe_pos)
            k = apply_rope(k, *rope, positions=safe_pos)
        cache_write(kc, k)
        cache_write(vc, v)
        kf, vf = _expand_gqa(cache_view(kc), cache_view(vc), c)
        o = dot_product_attention(q, kf, vf, causal=True,
                                  q_offset=pos0).to(dt)
        x = x + _wo_proj(o, lp, None, None, dt, tp)
        return x + _mlp(x, lp, c, dt, tp)

    x = _run_layers(body, x, params, cache, c)
    xl = x[:, true_len - 1:true_len]
    return _final_logits(xl, params, c, dt, tp)[0, 0], cache


def read_prefix(cache, slot: int, length: int):
    """Copy the first ``length`` K/V rows of ``slot`` out of the cache
    (fed back via install_prefix on a prefix-cache hit). Returns (k, v)
    of shape [L, length, KV, Dh]. A copy, not a view: the slot's later
    writes must not reach the cached prefix."""
    return (cache["k"][:, slot, :length].clone(),
            cache["v"][:, slot, :length].clone())


def install_prefix(cache, slot: int, k_prefix, v_prefix):
    """Write a cached prefix's K/V rows into slot rows [0, length), in
    place."""
    n = k_prefix.shape[1]
    cache["k"][:, slot, :n] = k_prefix
    cache["v"][:, slot, :n] = v_prefix
    return cache


def verify(params, tokens, positions, cache, *, config: TransformerConfig,
           tp=None):
    """Speculative-decoding verify step: score a window of K proposed
    tokens per slot in ONE target-model pass (greedy acceptance is done
    host-side in the engine).

    tokens [B, K]: token j of slot b sits at global position
    positions[b] + j; its K/V row is written there, and its output
    logits predict position positions[b] + j + 1. Per-slot causal mask:
    ``k_pos <= positions[b] + j``. Rows written for later-rejected
    tokens are stale-but-masked: they sit beyond the slot's rolled-back
    position and every future decode/verify overwrites its own row
    before attending to it. Rows whose position passes the cache write
    nothing (ray_tpu's scatter drops them); their logits are never
    used. Returns (logits [B, K, V] float32, cache).
    """
    c = config
    dt = c.compute_dtype
    B, K = tokens.shape
    T = cache["k"].shape[2]
    device = tokens.device
    posmat = positions[:, None] + torch.arange(K, device=device)[None, :]
    x, safe_pos = _offset_embed(params, tokens, posmat, c, dt, tp)  # [B, K, D]
    rope = None
    if c.arch != "gpt2":
        cos, sin = rope_frequencies(c.head_dim, c.max_seq_len,
                                    theta=c.rope_theta, device=device)
        rope = (cos[safe_pos][:, :, None, :], sin[safe_pos][:, :, None, :])

    def rot(t):  # t: [B, K, H, Dh]; rope tables [B, K, 1, Dh/2]
        cb, sb = rope
        t1, t2 = t.float().chunk(2, dim=-1)
        return torch.cat([t1 * cb - t2 * sb, t2 * cb + t1 * sb],
                         dim=-1).to(t.dtype)

    # [B, K, T]: key row t visible to query j of slot b iff t <= pos[b]+j
    kmask = torch.arange(T, device=device)[None, None, :] <= posmat[:, :, None]
    wb, wj = (posmat < T).nonzero(as_tuple=True)
    wpos = posmat[wb, wj]

    def body(x, lp, kc, vc, ll=None):  # kc/vc: [B, T, KV, Dh]
        h = _norm1(x, lp, c)
        q, k, v = _qkv(h, lp, dt)
        if rope is not None:
            q, k = rot(q), rot(k)
        kc[wb, wpos] = k[wb, wj]
        vc[wb, wpos] = v[wb, wj]
        kf, vf = _expand_gqa(kc, vc, c)  # [B, T, H, Dh]
        scale = 1.0 / (c.head_dim ** 0.5)
        scores = torch.einsum("bqhk,bthk->bhqt", (q * scale).float(),
                              kf.float())  # [B, H, K, T]
        scores = torch.where(kmask[:, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqt,bthk->bqhk", p, vf.float()).to(dt)
        x = x + _wo_proj(o, lp, None, None, dt, tp)
        return x + _mlp(x, lp, c, dt, tp)

    x = _run_layers(body, x, params, cache, c)
    return _final_logits(x, params, c, dt, tp), cache


def decode_rope_tables(rope, positions):
    """Per-slot rotation tables [B, 1, 1, Dh/2] (None for gpt2)."""
    if rope is None:
        return None
    cos, sin = rope
    return (cos[positions][:, None, None, :], sin[positions][:, None, None, :])


def decode(params, tokens, positions, cache, temperature, rng, *,
           config: TransformerConfig, lora=None, lora_ix=None, tp=None):
    """One decode step for all slots: tokens [B], positions [B].

    Writes each slot's new K/V row at its own position, attends with the
    per-slot mask ``k_pos <= pos[b]``, samples on the device (greedy
    where temperature == 0, categorical otherwise) and returns
    (sampled_tokens [B], last_logits [B, V] float32, cache). ``lora_ix``
    [B] is each slot's adapter index. A position past the cache writes
    nothing and reads the position tables at their last row (ray_tpu's
    scatter drops and its gather clamps); its logits are never used.
    """
    c = config
    dt = c.compute_dtype
    B = tokens.shape[0]
    T = cache["k"].shape[2]
    device = tokens.device
    safe_pos = positions.clamp_max(c.max_seq_len - 1)
    x, rope = embed_tokens(params, tokens[:, None], safe_pos[:, None],
                           c, dt, tp)  # [B,1,D]
    kmask = torch.arange(T, device=device)[None, :] <= positions[:, None]
    rows = torch.arange(B, device=device)
    cache_update = None
    # A position past the cache (a draft chain running ahead near the
    # end) writes nothing, as ray_tpu's scatter drops it: one host check
    # a step, and a filtered write only when a row is out.
    inside = positions < T
    if not bool(inside.all()):
        wb = inside.nonzero()[:, 0]
        wpos = positions[wb]

        def cache_update(cache_arr, new):
            cache_arr[wb, wpos] = new[wb]

    body = make_decode_body(c, dt, positions, decode_rope_tables(rope, safe_pos),
                            kmask, rows, lora_ctx=_lora_ctx(lora, lora_ix),
                            cache_update=cache_update, tp=tp)
    x = _run_layers(body, x, params, cache, c, lora)
    logits = _final_logits(x, params, c, dt, tp)[:, 0]  # [B, V]
    toks = sample_tokens(logits, temperature, rng)
    return toks, logits, cache
