"""Paged KV cache: fixed-size pages, block tables, and refcounted sharing
(port of ray_tpu/llm/kv_pages.py).

The dense slot cache (model_runner.init_slot_cache) reserves
``max_seq_len`` rows per slot up front, so short sequences strand memory
and a cached prefix must be *copied* into every slot that reuses it.
Here KV lives in one pool of fixed-size pages

    cache = {"k": [L, P, page, KV, Dh], "v": [L, P, page, KV, Dh]}

and each sequence owns an ordered list of page ids — its *block table*,
a fixed-width ``[B, MAXB]`` tensor (MAXB = ceil(max_len / page)). Decode
gathers the pool by table (``pool[tables] -> [B, MAXB*page, ...]``) and
writes the new row at ``(tables[b, pos//page], pos % page)``; every step
updates the pool in place.

Page 0 is reserved scratch: unused block-table entries are 0, so padded
or stale writes land there harmlessly — the positional mask
(``k_pos <= pos[b]``) already guarantees those rows are never attended.
One write may send many rows to page 0; on CUDA ``index_put_`` then
keeps any one of them, which is harmless for the same reason. A block
table never holds page 0 below its sequence's position.

Sharing is copy-on-write by construction: a prefix-cache entry pins its
pages with a refcount and sharers only ever *read* them — a sequence's
own writes (chunk tail, decode rows) always target pages past the
shared prefix, because installs are page-aligned. ``KVPageAllocator``
does the host-side accounting; it is not thread-safe on its own and
must be driven under the engine lock.

Where ray_tpu's scatters run ``mode="drop"``, the writes here drop
out-of-range page ids explicitly (negative ones too; ``index_put_``
would raise or wrap). Where ray_tpu's ``dynamic_slice`` would clamp a
chunk onto earlier pages, ``paged_prefill_at`` raises.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.llm import model_runner
from ray_tpu_torch.models.transformer import TransformerConfig


class KVPageError(RuntimeError):
    """KV page pool exhausted (or accounting violated)."""


class KVPageAllocator:
    """Host-side page accounting: free stack + per-page refcounts.

    Pages are shared (prefix cache) by increfing; ``free`` decrefs and
    only returns a page to the free stack when its count reaches zero.
    Page 0 is reserved and never allocated."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free stack keeps hot pages hot; page 0 excluded.
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref = [0] * self.num_pages

    def alloc(self, n: int) -> "list[int]":
        """Take ``n`` pages (refcount 1 each). Atomic: raises
        KVPageError without mutating state if the pool can't cover it."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > len(self._free):
            raise KVPageError(
                f"KV page pool exhausted: need {n}, "
                f"{len(self._free)} free of {self.num_pages - 1}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages) -> None:
        for p in pages:
            if self._ref[p] <= 0:
                raise KVPageError(f"incref of free page {p}")
            self._ref[p] += 1

    def free(self, pages) -> None:
        """Decref; pages hitting zero return to the free stack."""
        for p in pages:
            if self._ref[p] <= 0:
                raise KVPageError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def utilization(self) -> float:
        total = self.num_pages - 1
        return (self.num_in_use / total) if total else 0.0

    def stats(self) -> dict:
        return {
            "page_size": self.page_size,
            "pages_total": self.num_pages - 1,
            "pages_in_use": self.num_in_use,
            "pages_free": self.num_free,
            "utilization": self.utilization(),
        }


def init_page_pool(config: TransformerConfig, num_pages: int,
                   page_size: int, *, device="cuda"):
    c = config
    shape = (c.n_layers, num_pages, page_size, c.kv_heads, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=c.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=c.compute_dtype, device=device),
    }


def _paged_rows(new, nb: int, page: int):
    """[N, S, KV, Dh] chunk K/V -> [N, nb, page, KV, Dh] page rows (zero
    padded past S; padding pages map to scratch/overwritten rows)."""
    N, S, KV, Dh = new.shape
    if S < nb * page:
        new = torch.nn.functional.pad(new, (0, 0, 0, 0, 0, nb * page - S))
    return new.reshape(N, nb, page, KV, Dh)


def _page_writer(pages, nb: int, page: int, n_pages: int):
    """``cache_write(pool, new [N, S, KV, Dh])`` scattering each row's
    page rows to ``pages`` [N, nb] in place; ids outside [0, n_pages)
    write nothing (ray_tpu's mode="drop"). The kept ids are found once
    (one host sync), not in every layer."""
    ids = pages.reshape(-1)
    sel = ((ids >= 0) & (ids < n_pages)).nonzero()[:, 0]
    dst = ids[sel]

    def cache_write(cache_arr, new):
        rows = _paged_rows(new, nb, page).reshape(-1, page, *new.shape[2:])
        cache_arr[dst] = rows[sel]

    return cache_write


def paged_prefill(params, tokens, true_len: int, block_table, cache, *,
                  config: TransformerConfig, lora=None, lora_ix=None):
    """Whole-prompt prefill [1, S] writing K/V rows into the pages of
    ``block_table`` [MAXB]: paged_prefill_batch of one. Padding rows past
    the prompt's pages hit table entries of 0 (scratch). Returns
    (last_logits [V], cache)."""
    logits, cache = paged_prefill_batch(params, tokens, [true_len],
                                        block_table[None], cache,
                                        config=config, lora=lora,
                                        lora_ix=lora_ix)
    return logits[0], cache


def paged_prefill_batch(params, tokens, true_lens, block_tables, cache, *,
                        config: TransformerConfig, lora=None, lora_ix=None):
    """Batched whole-prompt prefill over pages: tokens [N, S],
    block_tables [N, MAXB]. Real rows carry in-range page ids (0-padded
    past their pages — scratch); PAD group members carry an OUT-OF-RANGE
    id (>= P) in every entry and write nothing. Returns (last_logits
    [N, V], cache)."""
    c = config
    dt = c.compute_dtype
    N, S = tokens.shape
    device = tokens.device
    page = cache["k"].shape[2]
    nb = -(-S // page)
    positions = torch.arange(S, device=device)
    x, rope = model_runner.embed_tokens(params, tokens, positions, c, dt)
    body = model_runner.make_prefill_body(
        c, dt, positions, rope, None,
        cache_write=_page_writer(block_tables[:, :nb], nb, page,
                                 cache["k"].shape[1]),
        lora_ctx=model_runner._lora_ctx(lora, lora_ix))
    x = model_runner._run_layers(body, x, params, cache, c, lora)
    lens = torch.as_tensor(true_lens, device=device)
    xl = x[torch.arange(N, device=device), lens - 1][:, None]
    return model_runner._final_logits(xl, params, c, dt)[:, 0], cache


def paged_prefill_at(params, tokens, true_len: int, pos0: int, block_table,
                     cache, *, config: TransformerConfig):
    """Continuation prefill over pages: write chunk [1, S] at logical
    positions [pos0, pos0+S) and attend over the sequence's full paged
    history (shared prefix pages included — this is what makes a prefix
    hit a *pin* instead of a copy).

    ``pos0`` must be page-aligned (installs hand out whole pages) and
    ``pos0//page + ceil(S/page) <= MAXB``; ValueError otherwise, where
    ray_tpu's dynamic_slice would clamp and remap the chunk onto earlier
    pages. Returns (last_logits [V], cache)."""
    _, S = tokens.shape
    _, _, page, KV, Dh = cache["k"].shape
    MAXB = block_table.shape[0]
    nb = -(-S // page)
    if pos0 % page or pos0 < 0 or pos0 // page + nb > MAXB:
        raise ValueError(f"chunk at {pos0} of {S} rows does not fit the "
                         f"block table ({MAXB} pages of {page})")
    write = _page_writer(block_table[None, pos0 // page:pos0 // page + nb],
                         nb, page, cache["k"].shape[1])
    return model_runner.chunk_prefill(
        params, tokens, true_len, pos0, cache, config=config,
        cache_write=write,
        cache_view=lambda pool: pool[block_table].reshape(1, MAXB * page,
                                                           KV, Dh))


def paged_decode(params, tokens, positions, block_tables, cache,
                 temperature, rng, *, config: TransformerConfig,
                 lora=None, lora_ix=None):
    """One decode step for all slots over the page pool: tokens [B],
    positions [B], block_tables [B, MAXB]. The new K/V row lands at
    ``(tables[b, pos//page], pos % page)`` *before* the table gather, so
    a freshly reclaimed page's stale rows are overwritten before the
    mask could ever reach them (same invariant as the dense path). The
    gather materialises [B, MAXB*page, KV, Dh] per layer, as ray_tpu's
    does. Returns (sampled_tokens [B], logits [B, V] f32, cache)."""
    c = config
    dt = c.compute_dtype
    B = tokens.shape[0]
    _, _, page, KV, Dh = cache["k"].shape
    T = block_tables.shape[1] * page
    device = tokens.device
    x, rope = model_runner.embed_tokens(params, tokens[:, None],
                                        positions[:, None], c, dt)
    kmask = torch.arange(T, device=device)[None, :] <= positions[:, None]
    barange = torch.arange(B, device=device)
    phys = block_tables[barange, positions // page]          # [B]
    rows = positions % page                                  # [B]

    def cache_update(cache_arr, new):  # new [B, KV, Dh]
        cache_arr[phys, rows] = new

    def cache_view(cache_arr):
        return cache_arr[block_tables].reshape(B, T, KV, Dh)

    body = model_runner.make_decode_body(
        c, dt, positions, model_runner.decode_rope_tables(rope, positions),
        kmask, barange, lora_ctx=model_runner._lora_ctx(lora, lora_ix),
        cache_update=cache_update, cache_view=cache_view)
    x = model_runner._run_layers(body, x, params, cache, c, lora)
    logits = model_runner._final_logits(x, params, c, dt)[:, 0]
    toks = model_runner.sample_tokens(logits, temperature, rng)
    return toks, logits, cache


def read_pages(cache, pages):
    """Copy ``pages`` ([n] int64 tensor) out of the pool: the payload of a
    prefill -> decode handoff. Returns (k, v), each [L, n, page, KV, Dh],
    new tensors on the pool's device."""
    return cache["k"][:, pages], cache["v"][:, pages]


def write_pages(cache, pages, k, v):
    """Install handed-off K/V pages ([L, n, page, KV, Dh]) at ``pages``, in
    place (ray_tpu returns a new pool); ``k``/``v`` may be numpy arrays or
    tensors on any device. Returns the pool."""
    dev, dt = cache["k"].device, cache["k"].dtype
    for key, x in (("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x)  # a copy: a numpy record may be read-only
        cache[key][:, pages] = x.to(device=dev, dtype=dt)
    return cache
