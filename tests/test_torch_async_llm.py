"""The port's AsyncLLMEngine against ray_tpu's on the CPU, both over the
same tiny GPT-2 (tests/torch_llm_helpers.py: f32, params made once):
concurrent callers' tokens, a stream's increments, eviction at a
deadline with TaskTimeoutError (dense and paged: the slot and its pages
are freed), ``snapshot()``, the sync ``generate()`` handing other
requests' outputs to the async driver, and a step that raises.

Greedy tokens are compared exactly after the top-2 margin check of the
JAX outputs. Every await has a timeout of its own, and a scenario that
fails leaves no executor thread parked on a stream for ``asyncio.run`` to
join (``_run``).
"""

import asyncio
import threading
import time

import pytest

from ray_tpu import exceptions as jexceptions
from ray_tpu.llm.engine import AsyncLLMEngine as JAsync
from ray_tpu_torch import exceptions
from ray_tpu_torch.llm import AsyncLLMEngine, RequestOutput
from torch_llm_helpers import assert_same, engine_pair, sampling

WAIT = 60.0
PROMPTS = [[65 + i, 66, 67, 68 + 2 * i] for i in range(4)]
PAGE = 8


def _pair(**kw):
    je, te = engine_pair(max_num_seqs=4, **kw)
    return je, te, JAsync(je), AsyncLLMEngine(te)


def _run(coro, *streaming):
    """``coro`` to its end or WAIT. Streams of the ``streaming`` engines
    still open then get an error, so that no executor thread stays
    parked on an empty stream queue for ``asyncio.run`` to join (ray_tpu's
    stream waits on its queue without a timeout)."""

    async def bounded():
        try:
            return await asyncio.wait_for(coro, timeout=WAIT)
        finally:
            for aeng in streaming:
                for q in list(aeng._streams.values()):
                    q.put(RuntimeError("the test ended before the stream"))

    return asyncio.run(bounded())


async def _gather(aeng, prompts, sp):
    return await asyncio.gather(*[aeng.generate(p, sp) for p in prompts])


@pytest.mark.parametrize("paged", [False, True])
def test_concurrent_callers_share_the_batch(paged):
    """Four concurrent callers get the JAX async engine's tokens, in
    about one request's worth of steps (one running batch)."""
    je, te, ja, ta = _pair(**(dict(kv_page_size=PAGE) if paged else {}))
    js, ts = sampling(max_tokens=12, ignore_eos=True)
    want = _run(_gather(ja, PROMPTS, js))
    got = _run(_gather(ta, PROMPTS, ts))
    assert_same(je, want, got, PROMPTS)
    assert te._step_count < 24, te._step_count
    assert ta.snapshot() == {k: (v if k != "kv" else te.kv_stats())
                             for k, v in ja.snapshot().items()}


def test_callers_arriving_mid_run_join_at_the_next_step():
    """Requests submitted while the driver steps another one are queued
    at its next step: each of 8 tokens finishes within 8 steps of its
    submission (the step under way counts), however often the driver
    takes the engine lock."""
    _, te, _, ta = _pair()
    _, long_sp = sampling(max_tokens=60, ignore_eos=True)
    _, ts = sampling(max_tokens=8, ignore_eos=True)
    finished_at, real = {}, te.step

    def step():
        outs = real()
        for o in outs:
            finished_at[o.request_id] = te._step_count
        return outs

    te.step = step

    async def one(prompt):
        submitted = te._step_count
        out = await ta.generate(prompt, ts)
        return finished_at[out.request_id] - submitted, len(out.token_ids)

    async def scenario():
        agen = await ta.generate(PROMPTS[0], long_sp, stream=True)
        await asyncio.wait_for(agen.__anext__(), WAIT)  # the driver is stepping
        got = await asyncio.gather(*[one(p) for p in PROMPTS[1:]])
        rest = [x async for x in agen]
        return got, rest

    got, rest = _run(scenario(), ta)
    assert all(steps <= 8 and n == 8 for steps, n in got), got
    assert isinstance(rest[-1], RequestOutput) and len(rest[-1].token_ids) == 60


def test_stream_increments_join_to_the_output():
    """stream=True yields each token id once, in order, then the final
    RequestOutput; the same items as ray_tpu's stream."""
    je, te, ja, ta = _pair()

    async def items(aeng, sp):
        agen = await aeng.generate(PROMPTS[1], sp, stream=True)
        return [x async for x in agen]

    js, ts = sampling(max_tokens=9, ignore_eos=True)
    want, got = _run(items(ja, js), ja), _run(items(ta, ts), ta)
    assert isinstance(got[-1], RequestOutput)
    assert all(isinstance(t, int) for t in got[:-1])
    assert got[:-1] == got[-1].token_ids
    assert got[:-1] == want[:-1]
    assert_same(je, [want[-1]], [got[-1]], [PROMPTS[1]])


def _hold_after_first_token(eng, aeng):
    """Make ``eng.step`` wait, once, after a step that left the stream's
    request holding a token, until released; so the test moves the
    stream's deadline while it is mid-decode, however slow the machine."""
    reached, release = threading.Event(), threading.Event()
    real = eng.step

    def step():
        out = real()
        if not release.is_set() and any(
                r is not None and r.request_id in aeng._streams and r.generated
                for r in eng.slots):
            reached.set()
            release.wait(WAIT)
        return out

    eng.step = step
    return reached, release


@pytest.mark.parametrize("paged", [False, True])
def test_deadline_evicts_with_task_timeout(paged):
    """A request whose deadline has passed raises TaskTimeoutError
    (where="llm_decode"); so does one evicted mid-decode, and its slot
    and KV pages are free afterwards. A live request beside them
    finishes with the JAX engine's tokens; snapshot() and kv_stats()
    agree with ray_tpu's after the same sequence."""
    je, te, ja, ta = _pair(**(dict(kv_page_size=PAGE) if paged else {}))

    async def scenario(eng, aeng, sp, timeout_error):
        live = asyncio.ensure_future(aeng.generate(PROMPTS[0], sp))
        with pytest.raises(timeout_error, match="deadline") as late:
            await asyncio.wait_for(
                aeng.generate(PROMPTS[2], sp, deadline=time.time() - 1.0), WAIT)
        # Mid-decode: the stream's request holds a slot (and, paged, its
        # pages) and a token when its deadline is moved into the past.
        reached, release = _hold_after_first_token(eng, aeng)
        agen = await aeng.generate(PROMPTS[3], sp, stream=True)
        assert await asyncio.get_running_loop().run_in_executor(None, reached.wait, WAIT)
        aeng._deadlines[next(iter(aeng._streams))] = 0.0
        release.set()
        first = await asyncio.wait_for(agen.__anext__(), WAIT)
        with pytest.raises(timeout_error, match="deadline"):
            async for _ in agen:
                pass
        out = await asyncio.wait_for(live, WAIT)
        return late.value, first, out, aeng.snapshot()

    js, ts = sampling(max_tokens=40, ignore_eos=True)
    jerr, jfirst, want, jsnap = _run(scenario(je, ja, js, jexceptions.TaskTimeoutError), ja)
    err, first, got, snap = _run(scenario(te, ta, ts, exceptions.TaskTimeoutError), ta)
    assert isinstance(err, TimeoutError) and isinstance(err, exceptions.RayTpuError)
    assert err.where == jerr.where == "llm_decode"
    assert str(err) == str(jerr)
    assert first == jfirst
    assert_same(je, [want], [got], [PROMPTS[0]])
    assert snap["evicted_deadline"] == jsnap["evicted_deadline"] == 2
    assert snap == jsnap
    assert all(s is None for s in te.slots) and not te.waiting
    if paged:
        assert te.kv_alloc.num_in_use == 0


def test_snapshot_keys_match_reference():
    je, te, ja, ta = _pair()
    assert list(ta.snapshot()) == list(ja.snapshot())
    assert ta.snapshot()["slots"] == 4


def test_sync_generate_hands_async_outputs_to_the_driver():
    """A sync generate() stepping the engine while an async request is in
    flight hands that request's output to the AsyncLLMEngine (the
    engine's foreign-output listener): both finish, with ray_tpu's
    tokens."""

    async def scenario(eng, aeng, sp):
        pending = asyncio.ensure_future(aeng.generate(PROMPTS[0], sp))
        await asyncio.sleep(0.05)  # let the driver admit it
        loop = asyncio.get_running_loop()
        sync_out = await loop.run_in_executor(None, lambda: eng.generate([PROMPTS[1]], sp))
        return sync_out[0], await asyncio.wait_for(pending, WAIT)

    je, te, ja, ta = _pair()
    js, ts = sampling(max_tokens=10, ignore_eos=True)
    want = _run(scenario(je, ja, js))
    got = _run(scenario(te, ta, ts))
    assert te._foreign_output_listener == ta._deliver
    assert_same(je, list(want), list(got), PROMPTS[:2])


def test_listener_receives_foreign_outputs():
    """generate() passes every output of a request it did not add to the
    listener, and none of its own."""
    _, te = engine_pair(max_num_seqs=4)
    _, ts = sampling(max_tokens=5, ignore_eos=True)
    seen = []
    te._foreign_output_listener = seen.append
    te.add_request("other", PROMPTS[2], ts)
    mine = te.generate([PROMPTS[0]], ts)
    assert [o.request_id for o in seen] == ["other"]
    assert len(seen[0].token_ids) == 5 and len(mine[0].token_ids) == 5


def test_a_step_that_raises_fails_owned_requests_and_the_loop_goes_on(monkeypatch):
    """When step() raises, the async-owned requests fail with that error
    and leave the engine; the next request is served."""
    _, te, _, ta = _pair()
    _, ts = sampling(max_tokens=4, ignore_eos=True)
    real = te.step
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("step failed")
        return real()

    monkeypatch.setattr(te, "step", flaky)

    async def scenario():
        with pytest.raises(RuntimeError, match="step failed"):
            await asyncio.wait_for(ta.generate(PROMPTS[0], ts), WAIT)
        return await asyncio.wait_for(ta.generate(PROMPTS[1], ts), WAIT)

    out = _run(scenario())
    assert len(out.token_ids) == 4
    assert ta.snapshot()["owned"] == 0 and not te.waiting


def test_generate_from_handoff_waits_for_item_6c():
    """generate_from_handoff, against ray_tpu's: a record the engine
    cannot take raises in the caller with ray_tpu's message (a dense
    engine, then a record missing its K/V), and a prefill_detached record
    decodes to the tokens of the monolithic engines. The name is from
    when the port refused the call until ROADMAP item 6c; it is kept so
    that the test's history stays one line.
    tests/test_torch_llm_disagg.py holds the record itself against
    ray_tpu's."""
    je, te, ja, ta = _pair()
    errors = []
    for aeng in (ja, ta):
        with pytest.raises(ValueError) as e:
            _run(aeng.generate_from_handoff({}))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "handoff decode requires paged KV (kv_page_size > 0)"
    je, te, ja, ta = _pair(kv_page_size=PAGE)
    errors = []
    for aeng in (ja, ta):
        with pytest.raises(ValueError) as e:
            _run(aeng.generate_from_handoff({"prompt_tokens": [1]}))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    jsp, tsp = sampling(max_tokens=6, ignore_eos=True)
    jrec = je.prefill_detached(PROMPTS[0], jsp)
    trec = te.prefill_detached(PROMPTS[0], tsp)
    jout = _run(ja.generate_from_handoff(jrec, jsp))
    tout = _run(ta.generate_from_handoff(trec, tsp))
    assert_same(je, [jout], [tout], [PROMPTS[0]])
