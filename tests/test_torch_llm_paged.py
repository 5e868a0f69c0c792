"""The port's paged KV cache, prefix caching and chunked prefill
(ray_tpu_torch.llm.kv_pages, model_runner.prefill_at / read_prefix /
install_prefix, and the engine's paths through them) against ray_tpu's,
on the CPU from the same parameters: allocators with the same ids and
refcounts, logits within 1e-4, and engines with identical greedy tokens
(after the top-2 margin check) and kv_stats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import kv_pages as jkv
from ray_tpu.llm import model_runner as jmr
from ray_tpu_torch.llm import kv_pages as tkv
from ray_tpu_torch.llm import model_runner as tmr
from torch_llm_helpers import (JMODEL, TMODEL, assert_same, base_params,
                               engine_pair, run, sampling)

TOL = 1e-4
PAGE = 8


@pytest.fixture(scope="module")
def params():
    return base_params()


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (1, n))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def _pool_pages_equal(jcache, tcache, skip=(0,)):
    """The pools agree on every page but the scratch page (where several
    rows may land in one write and either framework keeps any one)."""
    for name in ("k", "v"):
        j = np.asarray(jcache[name])
        t = tcache[name].numpy()
        keep = [p for p in range(j.shape[1]) if p not in skip]
        _close(t[:, keep], j[:, keep])


# -- the allocator ---------------------------------------------------------


def test_allocator_matches_reference_ids_and_refcounts():
    """The same sequence of alloc / incref / free gives the same page ids,
    refcounts, stats and exhaustion errors in both packages."""
    rng = np.random.default_rng(0)
    ja, ta = jkv.KVPageAllocator(12, 4), tkv.KVPageAllocator(12, 4)
    held_j, held_t = [], []
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(0, 5))
            outs = []
            for a, E in ((ja, jkv.KVPageError), (ta, tkv.KVPageError)):
                try:
                    outs.append(a.alloc(n))
                except E:
                    outs.append("exhausted")
            assert outs[0] == outs[1]
            if outs[0] != "exhausted":
                held_j.append(outs[0])
                held_t.append(outs[1])
        elif held_j:
            i = int(rng.integers(0, len(held_j)))
            if op == 1:
                ja.incref(held_j[i])
                ta.incref(held_t[i])
                held_j.append(held_j[i])
                held_t.append(held_t[i])
            else:
                ja.free(held_j.pop(i))
                ta.free(held_t.pop(i))
        assert [ta.refcount(p) for p in range(12)] == [
            ja.refcount(p) for p in range(12)]
        assert ta.stats() == ja.stats()
    assert ta.refcount(0) == 0  # page 0 is never handed out
    with pytest.raises(tkv.KVPageError):
        ta.free([0])


def test_paged_rows_pad_to_whole_pages():
    new = torch.arange(2 * 5 * 1 * 2, dtype=torch.float32).reshape(2, 5, 1, 2)
    rows = tkv._paged_rows(new, 2, 4)
    assert rows.shape == (2, 2, 4, 1, 2)
    assert torch.equal(rows.reshape(2, 8, 1, 2)[:, :5], new)
    assert not rows.reshape(2, 8, 1, 2)[:, 5:].any()


# -- the paged steps ---------------------------------------------------------


def test_paged_steps_match_reference(params):
    """One sequence through the paged prefill, a continuation chunk at a
    page boundary, a batched prefill with a pad member, and decode steps:
    logits within 1e-4 and the same pool contents (scratch page aside)."""
    jp, tp = params
    P, MAXB = 16, 8
    jc = jkv.init_page_pool(JMODEL, P, PAGE)
    tc = tkv.init_page_pool(TMODEL, P, PAGE, device="cpu")
    table = np.zeros((MAXB,), np.int64)
    table[:3] = [3, 7, 5]
    # Whole-prompt prefill of 13 tokens padded to 16.
    toks = np.zeros((1, 16), np.int64)
    toks[0, :13] = _tokens(13, 1)
    jl, jc = jkv.paged_prefill(jp, jnp.asarray(toks, jnp.int32), jnp.int32(13),
                               jnp.asarray(table, jnp.int32), jc, config=JMODEL)
    tl, tc = tkv.paged_prefill(tp, torch.from_numpy(toks), 13,
                               torch.from_numpy(table), tc, config=TMODEL)
    _close(tl, jl)
    # Continuation chunk of 5 tokens at position 16 (page-aligned).
    chunk = np.zeros((1, 8), np.int64)
    chunk[0, :5] = _tokens(5, 2)
    jl, jc = jkv.paged_prefill_at(jp, jnp.asarray(chunk, jnp.int32),
                                  jnp.int32(5), jnp.int32(16),
                                  jnp.asarray(table, jnp.int32), jc,
                                  config=JMODEL)
    tl, tc = tkv.paged_prefill_at(tp, torch.from_numpy(chunk), 5, 16,
                                  torch.from_numpy(table), tc, config=TMODEL)
    _close(tl, jl)
    # Batched prefill: one real member and a pad member whose ids are out
    # of range (>= P) in every entry.
    tables = np.full((2, MAXB), P, np.int64)
    tables[0] = 0
    tables[0, :2] = [9, 2]
    btoks = np.zeros((2, 16), np.int64)
    btoks[0, :11] = _tokens(11, 3)
    lens = np.array([11, 1])
    jl, jc = jkv.paged_prefill_batch(jp, jnp.asarray(btoks, jnp.int32),
                                     jnp.asarray(lens, jnp.int32),
                                     jnp.asarray(tables, jnp.int32), jc,
                                     config=JMODEL)
    tl, tc = tkv.paged_prefill_batch(tp, torch.from_numpy(btoks), lens,
                                     torch.from_numpy(tables), tc,
                                     config=TMODEL)
    _close(tl[0], jl[0])
    _pool_pages_equal(jc, tc)
    # Decode steps for both sequences (slot 0 at 21, slot 1 at 11).
    bt = np.stack([table, tables[0]])
    pos = np.array([21, 11])
    last = np.array([5, 6])
    for _ in range(3):
        jt, jl, jc = jkv.paged_decode(
            jp, jnp.asarray(last, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(bt, jnp.int32), jc, jnp.zeros((2,), jnp.float32),
            jax.random.PRNGKey(0), config=JMODEL)
        tt, tl, tc = tkv.paged_decode(
            tp, torch.from_numpy(last), torch.from_numpy(pos),
            torch.from_numpy(bt), tc, torch.zeros(2), torch.Generator(),
            config=TMODEL)
        _close(tl, jl)
        assert tt.tolist() == np.asarray(jt).tolist()
        last, pos = tt.numpy(), pos + 1
    _pool_pages_equal(jc, tc)


def test_paged_prefill_at_refuses_what_jax_would_clamp(params):
    _, tp = params
    tc = tkv.init_page_pool(TMODEL, 4, PAGE, device="cpu")
    table = torch.tensor([1, 2, 3])
    toks = torch.zeros((1, 8), dtype=torch.long)
    for pos0 in (4, 24):  # not page-aligned / past the table
        with pytest.raises(ValueError):
            tkv.paged_prefill_at(tp, toks, 1, pos0, table, tc, config=TMODEL)


def test_prefill_at_and_prefix_rows_match_reference(params):
    """Dense continuation prefill over an installed prefix: logits within
    1e-4; read_prefix returns a copy the slot's later writes leave alone."""
    jp, tp = params
    jc = jmr.init_slot_cache(JMODEL, 2, 64)
    tc = tmr.init_slot_cache(TMODEL, 2, 64, device="cpu")
    toks = np.zeros((1, 32), np.int64)
    toks[0, :20] = _tokens(20, 4)
    jl, jc = jmr.prefill(jp, jnp.asarray(toks, jnp.int32), jnp.int32(20),
                         jnp.int32(0), jc, config=JMODEL)
    tl, tc = tmr.prefill(tp, torch.from_numpy(toks), 20, 0, tc, config=TMODEL)
    _close(tl, jl)
    jk, jv = jmr.read_prefix(jc, jnp.int32(0), length=16)
    tk, tv = tmr.read_prefix(tc, 0, 16)
    _close(tk, jk)
    jc = jmr.install_prefix(jc, jnp.int32(1), jk, jv)
    tc = tmr.install_prefix(tc, 1, tk, tv)
    chunk = np.zeros((1, 8), np.int64)
    chunk[0, :6] = _tokens(6, 5)
    jl, jc = jmr.prefill_at(jp, jnp.asarray(chunk, jnp.int32), jnp.int32(6),
                            jnp.int32(16), jnp.int32(1), jc, config=JMODEL)
    tl, tc = tmr.prefill_at(tp, torch.from_numpy(chunk), 6, 16, 1, tc,
                            config=TMODEL)
    _close(tl, jl)
    _close(tc["k"][:, 1, :22], np.asarray(jc["k"])[:, 1, :22])
    before = tk.clone()
    tc["k"][:, 0, :16] = 7.0
    assert torch.equal(tk, before)
    with pytest.raises(ValueError):  # ray_tpu would clamp the start
        tmr.prefill_at(tp, torch.from_numpy(chunk), 6, 60, 1, tc, config=TMODEL)


# -- the engines ---------------------------------------------------------------

PROMPTS = ["the quick brown fox jumps over", "hello world",
           "a completely different prompt", "short"]


@pytest.fixture(scope="module")
def dense():
    return engine_pair(max_num_seqs=4)[0]


def _table_invariant(eng):
    """No live sequence's block table reaches page 0 below its position
    (the rows it has written and attends)."""
    for slot, req in enumerate(eng.slots):
        if req is not None:
            n = -(-int(eng.positions[slot]) // eng.page_size)
            assert 0 not in eng._block_tables[slot, :n].tolist()


def _checked_run(eng, prompts, sp):
    for i, p in enumerate(prompts):
        eng.add_request(f"r{i}", p, sp)
    done = {}
    while eng.has_unfinished():
        for out in eng.step():
            done[out.request_id] = out
        _table_invariant(eng)
    return [done[f"r{i}"] for i in range(len(prompts))]


@pytest.mark.parametrize("num_pages", [0, 9])
def test_paged_engine_matches_reference(dense, num_pages):
    """Paged engines (the dense-equivalent pool, and an overcommitted one
    whose admission backs off) give the JAX paged engines' tokens and
    kv_stats, and the dense JAX engine's tokens."""
    jd = dense
    jp, tpg = engine_pair(max_num_seqs=4, kv_page_size=PAGE,
                          kv_num_pages=num_pages)
    js, ts = sampling(max_tokens=12, ignore_eos=True)
    want = run(jp, PROMPTS, js)
    got = _checked_run(tpg, PROMPTS, ts)
    assert_same(jp, want, got, PROMPTS)
    # An overcommitted pool may end a sequence early ("length"): what it
    # gave is the start of the dense engine's tokens.
    for d, g in zip(run(jd, PROMPTS, js), got):
        assert d.token_ids[:len(g.token_ids)] == g.token_ids
        assert len(g.token_ids) == len(d.token_ids) or num_pages
    assert tpg.kv_stats() == jp.kv_stats()
    assert tpg.kv_alloc.num_in_use == 0


def test_pool_exhaustion_finishes_with_length(dense):
    jd = dense
    jp, tpg = engine_pair(max_num_seqs=2, kv_page_size=PAGE,
                          kv_num_pages=4)
    js, ts = sampling(max_tokens=40, ignore_eos=True)
    prompt = [PROMPTS[0][:14]]
    want, got = run(jp, prompt, js), run(tpg, prompt, ts)
    assert got[0].finish_reason == "length" == want[0].finish_reason
    assert_same(jp, want, got, prompt)
    assert tpg.kv_stats() == jp.kv_stats()


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_cache_matches_reference(dense, paged):
    """Two waves over a shared prefix: the second wave hits the cache and
    both give the JAX engine's tokens and kv_stats."""
    jd = dense
    kw = dict(kv_page_size=PAGE) if paged else {}
    je, te = engine_pair(max_num_seqs=2, enable_prefix_caching=True,
                         prefix_block=8, **kw)
    base = "the same long shared prefix of the prompt, "
    waves = [[base + "one", base + "two tl"], [base + "three", base + "fo"]]
    js, ts = sampling(max_tokens=6)
    for wave in waves:
        want, got = run(je, wave, js), run(te, wave, ts)
        assert_same(je, want, got, wave)
    assert te.prefix_cache_hits > 0
    assert te.kv_stats() == je.kv_stats()
    if paged:
        held = {p for e in te._prefix_pool.values() for p in e}
        assert te.kv_alloc.num_in_use == len(held)  # only the pool pins pages


def test_chunked_prefill_matches_reference(dense):
    """Chunked prefill (dense, with a prefix hit) against ray_tpu's, and
    paged chunks (which ray_tpu refuses) against its whole-prompt paged
    engine."""
    jd = dense
    prompts = ["x" * 20 + "the rest of a long prompt", "y" * 50]
    js, ts = sampling(max_tokens=6)
    je, te = engine_pair(max_num_seqs=2, prefill_chunk=8,
                         enable_prefix_caching=True, prefix_block=8)
    for _ in range(2):
        assert_same(je, run(je, prompts, js), run(te, prompts, ts), prompts)
    assert te.kv_stats() == je.kv_stats()
    jp, tp = engine_pair(max_num_seqs=2, kv_page_size=PAGE,
                         tkw=dict(prefill_chunk=16))
    assert_same(jp, run(jp, prompts, js), run(tp, prompts, ts), prompts)
    with pytest.raises(ValueError):  # chunks must start on page boundaries
        engine_pair(kv_page_size=PAGE, tkw=dict(prefill_chunk=12))
