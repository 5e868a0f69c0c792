"""chip_smoke.py's own yardsticks, on the CPU: the tolerance it holds the
backward kernels to, the pair count its bounds are built on, its kernels
line, phase 6's routing and f32 GEMM helpers, phase 7's leaf-wise
comparison, shard slicing and the launch counts its ranks report, and
phase 8's merged-LoRA reference, token check and JSON prefix check,
phase 9's resumed-run check and data-parallel limit, phase 10's
reading of a pipeline rank's failure, and phases 11-19 run on the CPU
(phase 13's two-agent CartPole against two CartPoles; phase 14's
workers' launch counts reach the kernels line)."""

import math

import pytest
import torch

import chip_smoke
from ray_tpu_torch.ops.attention import flash_forward_plain


def _inputs(b, t, h, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=g).to(dtype) for _ in range(4)]


def _dense_backward(q, k, v, o, lse, do, *, round_p: bool):
    """Causal attention backward in f32 from the forward's LSE, as
    (dQ, dK, dV) in the input type. ``round_p`` rounds p and dS to the
    input type before the dV and dK products, as the tensor-core kernels
    do; without it they stay f32, as in the plain version."""
    b, t, h, d = q.shape
    qf, kf, vf, gf, of = (x.float().transpose(1, 2) for x in (q, k, v, do, o))
    s = qf @ kf.transpose(-1, -2) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool).tril()
    p = torch.where(mask, torch.exp(s - lse.reshape(b, h, t, 1)), 0.0)
    delta = (gf * of).sum(-1, keepdim=True)
    ds = p * (gf @ vf.transpose(-1, -2) - delta) / math.sqrt(d)
    r = (lambda x: x.to(q.dtype).float()) if round_p else (lambda x: x)
    dq = ds.to(q.dtype).float() @ kf
    dk = r(ds).transpose(-1, -2) @ qf
    dv = r(p).transpose(-1, -2) @ gf
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_backward_tolerance_tells_rounding_from_faults(dtype):
    """The 16-bit p and dS of the tensor-core kernels pass _BWD_TOL; a 1%
    error in half of dV, and dQ missing one key tile's share in half of
    its rows, fail it."""
    b, t, h, d = 2, 256, 2, 64
    q, k, v, do = _inputs(b, t, h, d, dtype)
    o, lse = flash_forward_plain(q, k, v, causal=True, block_k=t)
    plain = _dense_backward(q, k, v, o, lse, do, round_p=False)
    kernel_like = _dense_backward(q, k, v, o, lse, do, round_p=True)
    for got, ref in zip(kernel_like, plain):
        assert chip_smoke._grad_within(chip_smoke._grad_error(got, ref, dtype), dtype)

    dv = plain[2].float().clone()
    dv[:, t // 2:] *= 0.99
    e = chip_smoke._grad_error(dv.to(dtype), plain[2], dtype)
    assert not chip_smoke._grad_within(e, dtype), e

    tile = chip_smoke._BWD_TILE
    k_cut = k.clone()
    k_cut[:, :tile] = 0  # key tile 0 dropped (q·k = 0 and k = 0 in dQ)
    v_cut = v.clone()
    v_cut[:, :tile] = 0
    dq_cut = _dense_backward(q, k_cut, v_cut, o, lse, do, round_p=True)[0]
    dq = plain[0].clone()
    dq[:, t // 2:] = dq_cut[:, t // 2:]
    e = chip_smoke._grad_error(dq, plain[0], dtype)
    assert not chip_smoke._grad_within(e, dtype), e


def test_backward_tolerance_takes_ragged_and_zero_tiles():
    """T = 100 (a short last tile) and all-zero key tiles (Tq < Tk under
    the causal mask): equal gradients pass, garbage in a zero tile fails."""
    ref = _inputs(1, 100, 2, 16, torch.bfloat16)[0]
    ref[:, 64:] = 0
    assert chip_smoke._grad_within(chip_smoke._grad_error(ref, ref, torch.bfloat16),
                                   torch.bfloat16)
    bad = ref.clone()
    bad[0, 90, 1, 3] = 1e-3
    e = chip_smoke._grad_error(bad, ref, torch.bfloat16)
    assert not chip_smoke._grad_within(e, torch.bfloat16), e


@pytest.mark.parametrize("tq,tk,causal", [(64, 64, True), (64, 200, True),
                                          (200, 64, True), (100, 30, False)])
def test_attended_pairs_counts_the_mask(tq, tk, causal):
    """The bounds count the (query, key) pairs the mask keeps (global
    positions from 0, key j hidden from query i < j)."""
    i = torch.arange(tq)[:, None]
    j = torch.arange(tk)[None, :]
    kept = int((j <= i).sum()) if causal else tq * tk
    assert chip_smoke._attended_pairs(tq, tk, causal) == kept


def test_kernel_summary_names_sources_that_are_built():
    """Every source chip_smoke's kernels line names is one the port builds
    and the one its wrapper routes that type to; every kernel it names has
    a wrapper that counts its launches and its fp32 launches, and each
    (wrapper, type) has one entry."""
    from ray_tpu_torch.ops import _kernels

    kernels = chip_smoke._KERNELS
    assert {source for _, _, source, _ in kernels.values()} <= set(_kernels.SOURCES)
    assert len({(w, fp32) for w, fp32, _, _ in kernels.values()}) == len(kernels)
    for name, (wrapper, fp32, source, line) in kernels.items():
        w = getattr(_kernels, wrapper)
        assert isinstance(w.launches, int) and isinstance(w.launches_fp32, int), name
        assert line in (144, 298, 332), name
        if wrapper != "flash_fwd":
            dtype = torch.float32 if fp32 else torch.bfloat16
            assert _kernels._backward_route(wrapper.rsplit("_", 1)[1], dtype)[0] == source
    assert chip_smoke._launch_counts().keys() == kernels.keys()


def test_copy_check_covers_every_counting_wrapper():
    """chip_smoke requires 0 copies on the main path from every wrapper
    that counts its copies."""
    from ray_tpu_torch.ops import _kernels

    counting = {name for name, obj in vars(_kernels).items()
                if callable(obj) and hasattr(obj, "copies")}
    assert counting == set(chip_smoke._COPYING)


def test_routing_comparison_counts_tokens_routed_differently():
    """Phase 6's routing comparison: zero when the two routings agree; one
    when a single token is sent to other experts (two of its E entries
    change), whatever the devices of the two."""
    from ray_tpu_torch.ops import moe

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 64, 16), generator=g)
    router = torch.randn((16, 8), generator=g)
    kept = moe.route(x, router, top_k=2)[1].sum(-1) > 0  # [n, g, E]
    assert kept.shape == (1, 128, 8) and int(kept.sum(-1).max()) == 2
    assert chip_smoke._routing_mismatches(kept, kept.clone()) == 0
    flipped = kept.clone()
    flipped[0, 37] = flipped[0, 37].roll(1)  # token 37: other experts
    assert int((flipped != kept).sum()) >= 2
    assert chip_smoke._routing_mismatches(flipped, kept) == 1


def test_model_routing_reads_every_moe_layer():
    """Phase 6's routing probe: one bool [n, g, E] per MoE layer, each
    token kept by at most top_k experts; the probe leaves the model's
    moe_swiglu in place and its output unchanged."""
    from ray_tpu_torch import models
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops import moe

    cfg = models.tiny_moe(dtype="float32", attn_impl="reference")
    params = models.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = models.forward(params, tokens, cfg)
    kept = chip_smoke._model_routing(params, tokens, cfg)
    assert transformer.moe_swiglu is moe.moe_swiglu
    assert len(kept) == cfg.n_layers
    for k in kept:
        assert k.shape == (1, 80, cfg.n_experts) and k.dtype == torch.bool
        assert 0 < int(k.sum()) and int(k.sum(-1).max()) <= cfg.expert_top_k
    assert chip_smoke._routing_mismatches(kept[0], kept[1]) > 0
    with torch.no_grad():
        assert torch.equal(models.forward(params, tokens, cfg), want)


@pytest.mark.parametrize("name,f32", [
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_", True),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nt_align1>(cutlass_80_si", True),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", False),
    ("void (anonymous namespace)::flash_bwd_dkv_fp32_kernel<64>(Args)", False),
])
def test_f32_gemm_names(name, f32):
    """The profile's f32 GEMM sum takes cuBLAS's and CUTLASS's f32 FMA
    GEMMs (the first two names as an H100 profile of moe_small's step
    shows them, cut to 80 characters) and no bf16 GEMM, elementwise or
    flash kernel."""
    assert chip_smoke._is_f32_gemm(name) is f32


_H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bounds_count_3xtf32_for_fp32(dtype):
    """The fp32 attention bounds take three TF32 operations on the tensor
    cores for each fp32 one (495 TFLOP/s dense on an H100 SXM); bf16 keeps
    its own 989 TFLOP/s. GPT-2 124M's training shape, causal."""
    b, t, h, d = 8, 1024, 12, 64
    esize = torch.empty((), dtype=dtype).element_size()
    pairs = t * (t + 1) // 2
    rate, by = ((495e12 / 3, "operations (3xTF32)") if dtype == torch.float32
                else (989e12, "operations"))

    def want(nbytes, ops):
        t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else by

    fwd_bytes = 4 * b * t * h * d * esize + b * h * t * 4
    got = chip_smoke._attention_bound_ms(b, t, t, h, d, dtype, True, _H100)
    assert got == pytest.approx(want(fwd_bytes, 4 * b * h * d * pairs), rel=1e-12)

    for dq, products in ((True, 3), (False, 4)):
        x = b * t * h * d * esize
        nbytes = 4 * x + 2 * b * h * t * 4 + (1 if dq else 2) * x
        got = chip_smoke._attention_bwd_bound_ms(b, t, t, h, d, dtype, True, _H100, dq=dq)
        assert got == pytest.approx(want(nbytes, 2 * products * b * h * d * pairs), rel=1e-12)
        assert got[1] == by  # the products bound every backward pass here
    if dtype == torch.float32:  # the numbers the fp32 kernels' notes give
        assert chip_smoke._attention_bwd_bound_ms(
            b, t, t, h, d, dtype, True, _H100, dq=True)[0] == pytest.approx(0.117, abs=5e-4)
        assert chip_smoke._attention_bwd_bound_ms(
            b, t, t, h, d, dtype, True, _H100, dq=False)[0] == pytest.approx(0.156, abs=5e-4)


def test_moe_bound_keeps_the_fma_peak():
    """The dispatch/combine products are torch's f32 GEMMs on the FMA
    units: their bound still reads the 67 TFLOP/s fp32 peak."""
    bw, flops, tf32 = chip_smoke._peaks(_H100)
    assert (bw, flops[torch.float32], tf32) == (3.35e12, 67e12, 495e12)


@pytest.mark.parametrize("ms_dq,ms_dkv,library_ms,ok", [
    (0.3, 0.4, 1.2, True), (0.6, 0.6, 1.2, True), (0.6, 0.7, 1.2, False),
    (1.25, 1.45, 1.23, False)])
def test_pair_speed_check(ms_dq, ms_dkv, library_ms, ok):
    """Phase 2's check on the fp32 backward pair: dQ + dK/dV no slower
    than SDPA's whole backward in the same run."""
    row = {"ms_dq": ms_dq, "ms_dkv": ms_dkv, "library_ms": library_ms}
    assert chip_smoke._pair_no_slower_than_library(row) is ok


@pytest.mark.parametrize("ms,library_ms,ok", [
    (0.18, 0.30, True), (0.30, 0.30, True), (0.31, 0.30, False), (0.46, 0.30, False)])
def test_forward_speed_check(ms, library_ms, ok):
    """Phase 2's check on the fp32 forward: the kernel no slower than
    SDPA's fp32 forward in the same run."""
    row = {"ms": ms, "library_ms": library_ms}
    assert chip_smoke._forward_no_slower_than_library(row) is ok


@pytest.mark.parametrize("tq,tk,causal", [(64, 200, True), (200, 64, True), (100, 30, False)])
def test_forward_bound_counts_tq_and_tk_apart(tq, tk, causal):
    """Where Tq and Tk differ (phase 2's causal Tq < Tk case), the forward
    bound reads q and writes O and LSE at Tq, reads k and v at Tk, and
    counts the attended pairs the mask keeps."""
    b, h, d, dtype = 2, 4, 64, torch.float32
    nbytes = (2 * tq + 2 * tk) * b * h * d * 4 + b * h * tq * 4
    ops = 4 * b * h * d * chip_smoke._attended_pairs(tq, tk, causal)
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, 3 * ops / 495e12 * 1e3
    got = chip_smoke._attention_bound_ms(b, tq, tk, h, d, dtype, causal, _H100)
    assert got[0] == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    assert got[1] == ("bytes" if t_bytes >= t_ops else "operations (3xTF32)")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for shape in ((64, 32), (32,), (4, 8, 16))]


@pytest.mark.parametrize("tol", ["_WORLD1_TOL", "_EXPERT2_TOL"])
def test_leafwise_comparison_tells_a_faulty_leaf(tol):
    """Phase 7's comparison: an equal tree reads 0; a 1e-3 fault (of the
    leaf's max) in one element of one leaf fails both limits, though it is
    far below the other leaves' scale."""
    limit = getattr(chip_smoke, tol)
    ref = _tree()
    ref[2] = ref[2] * 1e-3  # a small leaf: the fault is judged on its own max

    def share(got):
        return chip_smoke._worst_leaf_share([(a - b).abs().max().item()
                                             for a, b in zip(got, ref)],
                                            [b.abs().max().item() for b in ref])

    assert share([t.clone() for t in ref]) == 0.0
    faulty = [t.clone() for t in ref]
    faulty[2][1, 2, 3] += 1e-3 * ref[2].abs().max()
    assert share(faulty) == pytest.approx(1e-3, rel=1e-4) and share(faulty) > limit


def test_rank_counts_are_summed_into_the_kernels_line():
    """Part (b)'s ranks report their launches and copies; they are added to
    the parent's counts of phase 7, kernel by kernel."""
    names = list(chip_smoke._KERNELS)
    total = {"launches": dict.fromkeys(names, 0),
             "copies": dict.fromkeys(chip_smoke._COPYING, 0)}
    total["launches"]["flash_fwd"] = 72  # the parent's world-size-1 steps
    ranks = [{"launches": {k: 12 * (i + 1) for i, k in enumerate(names)},
              "copies": dict.fromkeys(chip_smoke._COPYING, 0)} for _ in range(2)]
    for r in ranks:
        total = chip_smoke._add_counts(total, r)
    assert total["launches"]["flash_fwd"] == 72 + 2 * 12
    assert [total["launches"][k] for k in names[1:]] == [24 * (i + 2) for i in range(5)]
    assert set(total["copies"].values()) == {0}


def test_local_slice_is_the_ranks_shard():
    """The reference's shard a rank compares its gradient with: chunked along
    each Shard dim at the rank's index, whole along Replicate."""
    from torch.distributed.tensor import Replicate, Shard

    full = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    got = chip_smoke._local_slice(full, (Shard(1),), [(1, 2)])
    assert torch.equal(got, full[:, 4:])
    assert torch.equal(chip_smoke._local_slice(full, (Replicate(),), [(1, 2)]), full)


# -- phase 8 (llm) ------------------------------------------------------------


def _tiny_f32():
    from ray_tpu_torch import models

    cfg = models.tiny(vocab_size=512, dtype="float32")
    return cfg, models.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")


def test_merged_lora_weights_equal_the_adapter_path():
    """Check (e)'s reference: the params with the adapter merged in give
    the LoRA path's logits (the runner's gathered deltas) within 1e-4; a
    merge at the wrong scale is told apart."""
    from ray_tpu_torch.llm import lora, model_runner
    from ray_tpu_torch.models import transformer as tfm

    cfg, params = _tiny_f32()
    hdh = cfg.n_heads * cfg.head_dim
    g = torch.Generator().manual_seed(1)
    adapter = {t: (torch.randn((cfg.n_layers, i, 4), generator=g) * 0.3,
                   torch.randn((cfg.n_layers, 4, o), generator=g) * 0.3)
               for t, (i, o) in {"wq": (cfg.d_model, hdh), "wk": (cfg.d_model, hdh),
                                 "wv": (cfg.d_model, hdh),
                                 "wo": (hdh, cfg.d_model)}.items()}
    mgr = lora.LoRAManager(cfg.n_layers, {t: (a.shape[1], b.shape[2])
                                          for t, (a, b) in adapter.items()},
                           max_adapters=2, max_rank=4, device="cpu")
    mgr.add(lora.LoRAAdapter("a", {t: (a.numpy(), b.numpy())
                                   for t, (a, b) in adapter.items()}, alpha=8.0))
    tokens = torch.randint(0, 256, (1, 12), generator=g)
    cache = model_runner.init_slot_cache(cfg, 1, 16, device="cpu")
    got, _ = model_runner.prefill(params, tokens, 12, 0, cache, config=cfg,
                                  lora=mgr.lora_tree(), lora_ix=torch.tensor([1]))
    merged = chip_smoke._merged_lora(params, adapter, 8.0 / 4)
    want = tfm.forward(merged, tokens, cfg)[0, -1]
    assert (got - want).abs().max() < 1e-4
    base = tfm.forward(params, tokens, cfg)[0, -1]
    assert (got - base).abs().max() > 1e-2  # the adapter moves the logits
    wrong = tfm.forward(chip_smoke._merged_lora(params, adapter, 8.0 / 2),
                        tokens, cfg)[0, -1]
    assert (got - wrong).abs().max() > 1e-2


def test_token_check_reports_the_margin_where_requests_part(capsys):
    """The check of checks (a)-(e): equal token lists pass; a list that
    parts (or ends early) fails, after the top-2 margin at the first
    differing token is printed."""
    cfg, params = _tiny_f32()
    prompt = [257, 10, 20, 30]
    ref = [5, 6, 7, 8]
    assert chip_smoke._first_difference(ref, list(ref)) is None
    assert chip_smoke._first_difference([5, 6, 9, 8], ref) == 2
    assert chip_smoke._first_difference([5, 6], ref) == 2
    chip_smoke._check_same_tokens("t", params, cfg, [prompt], [list(ref)], [ref])
    with pytest.raises(SystemExit):
        chip_smoke._check_same_tokens("t", params, cfg, [prompt], [[5, 6, 9, 8]],
                                      [ref])
    out = capsys.readouterr().out
    margin = chip_smoke._margin_at(params, cfg, prompt, ref, 2)
    assert f"parts at token 2, top-2 margin there {margin}" in out
    assert margin >= 0


@pytest.mark.parametrize("text,ok", [
    ('{"a": [1, -2.5e3, "x\\"y"], "b": {}}', True), ('  {"a": [tr', True),
    ('{"a" 1}', False), ("[1e]", False), ('{"a": 1}}', False),
])
def test_json_prefix_check(text, ok):
    """Check (g): a JSON document or any prefix of one passes; a grammar
    break, an incomplete number that ends, or text past the document's
    end is caught."""
    assert chip_smoke._json_prefix_ok(text) is ok


# -- phase 9 (train_backend) ----------------------------------------------------


def _resume_on_cpu(monkeypatch, tmp_path, restore=None):
    """Part (a)'s resumed-run check on tiny() in f32 on the CPU, in a
    session of world size 1; ``restore`` replaces the checkpoint's load."""
    from ray_tpu_torch import models
    from ray_tpu_torch.ops.optim import FusedClipAdamW
    from ray_tpu_torch.train import checkpoint, session

    if restore is not None:
        monkeypatch.setattr(checkpoint, "load_pytree", restore)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg = models.tiny(dtype="float32")
    opt = FusedClipAdamW(learning_rate=1e-2, weight_decay=0.1, clip_norm=1.0)
    g = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 17), generator=g)}
               for _ in range(6)]

    def fresh(seed):
        params = models.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
        return params, opt.init(params)

    session.set_session(session.TrainSession(0, 1, 0))
    try:
        return chip_smoke._resume_check(cfg, opt, batches, fresh, str(tmp_path / "runs"))
    finally:
        session.set_session(None)


def test_resumed_steps_are_checked_bit_for_bit(monkeypatch, tmp_path):
    """Steps 4-6 from the step-3 checkpoint equal the uninterrupted run's
    bit for bit, and the check tells a restore that left the fresh state
    in place."""
    losses, again, bitwise, step_ms, saved, _, _ = _resume_on_cpu(monkeypatch, tmp_path)
    assert bitwise and again == losses[3:] and len(step_ms) == 6
    assert saved == "checkpoint_000000" and all(math.isfinite(x) for x in losses)
    _, _, bitwise, _, _, _, _ = _resume_on_cpu(
        monkeypatch, tmp_path / "faulty", restore=lambda path, target, device: target)
    assert not bitwise


def test_data_parallel_limit_tells_a_faulty_leaf():
    """Part (b)'s limit: two half-batch gradients averaged against the
    whole batch's differ only in the order of their sums (~1e-7 of a
    leaf's max here), far inside 1e-4; a gradient halved in one leaf (a
    sum where the mean belongs) is far outside it."""
    w = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))

    def grad(rows):
        return torch.autograd.grad(torch.tanh(rows @ w.requires_grad_()).pow(2).mean(), w)[0]

    whole, halves = grad(x), (grad(x[:32]) + grad(x[32:])) / 2
    share = chip_smoke._worst_leaf_share([(halves - whole).abs().max().item()],
                                         [whole.abs().max().item()])
    assert share <= chip_smoke._DP2_TOL
    faulty = chip_smoke._worst_leaf_share([(halves * 2 - whole).abs().max().item()],
                                          [whole.abs().max().item()])
    assert faulty > chip_smoke._DP2_TOL


# -- phase 10 (llm_parallel) ----------------------------------------------------


@pytest.mark.parametrize("errors, transport", [
    (['  File "_collectives.py", in _exchange\n    for req in dist.batch_isend_irecv(ops):\n'
      'RuntimeError: Bad address'], True),
    (["RuntimeError: rank(s) [1] of _serving_rank died without a result"], True),
    (["TimeoutError: _serving_rank on 2 ranks did not finish in 180 s"], True),
    (['  File "pp_runner.py", in decode\nIndexError: index 1024 is out of bounds'], False),
    (["ValueError: pipeline_parallel_size=2 but only 1 ranks in the process group"], False),
])
def test_pipeline_failure_must_come_from_the_stage_hop(errors, transport):
    """Phase 10 accepts a pipeline rank's failure only where the stage
    hop's transport raised or ended or stalled a rank."""
    assert chip_smoke._transport_failures(errors) == transport


@pytest.mark.parametrize("name", ["CartPole", "Pendulum"])
def test_rllib_phase_envs_step_as_gymnasium(name):
    """Phase 12's environments, written from gymnasium's equations, give
    gymnasium's CartPole-v1 and Pendulum-v1 observations, rewards,
    terminations and truncations for the same seeds and actions, over
    several episodes (resets without a seed continue the first's
    generator, as gymnasium's do)."""
    import gymnasium
    import numpy as np

    ours, theirs = getattr(chip_smoke, name)(), gymnasium.make(f"{name}-v1")
    rng = np.random.default_rng(0)
    for episode in range(3):
        seed = 5 if episode == 0 else None
        a, b = ours.reset(seed=seed)[0], theirs.reset(seed=seed)[0]
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        for _ in range(600):
            act = (int(rng.integers(0, 2)) if name == "CartPole"
                   else rng.uniform(-2.5, 2.5, (1,)).astype(np.float32))
            o1, r1, t1, u1, _ = ours.step(act)
            o2, r2, t2, u2, _ = theirs.step(act)
            assert np.array_equal(o1, o2) and r1 == r2 and (t1, u1) == (t2, u2)
            if t1 or u1:
                break
    assert ours.observation_space.shape == theirs.observation_space.shape
    if name == "CartPole":
        assert ours.action_space.n == theirs.action_space.n
    else:
        assert np.array_equal(ours.action_space.low, theirs.action_space.low)


def test_rllib_phase_runs_on_the_cpu(capsys):
    """Phase 12 end to end with every module on the CPU (2 PPO
    iterations): its checks pass and it prints its row."""
    row = chip_smoke.phase_rllib({}, device="cpu", ppo_iters=2)
    assert row["ppo"]["restored_next_iteration_bitwise_equal"]
    assert row["dqn"]["learning_iterations"] == row["sac"]["learning_iterations"] == 3
    assert set(row) >= {"ppo", "dqn", "sac", "bc", "marwil", "cql", "impala", "appo"}
    assert "[rllib] " in capsys.readouterr().out


def test_rllib_more_phase_runs_on_the_cpu(capsys):
    """Phase 13 end to end with every module on the CPU (ray_tpu's small
    DreamerV3 test config; the mesh's two ranks on gloo CPU): its checks
    pass, its ranks report no kernel launch and it prints its row."""
    out = chip_smoke.phase_rllib_more({}, device="cpu", small=True)
    row = out["row"]
    assert row["multi_agent_ppo"]["restored_next_iteration_bitwise_equal"]
    assert set(row["multi_agent_ppo"]["rows_per_module"]) == {"p0", "p1"}
    assert row["dreamerv3"]["updates_per_iteration"] == [8, 8]
    assert row["dreamerv3"]["restored_next_update_bitwise_equal"]
    assert row["mesh"]["world1_bitwise_equal"] and row["mesh"]["world2_ranks_bitwise_equal"]
    assert set(out["launches"].values()) == {0}
    assert "[rllib_more] " in capsys.readouterr().out


def test_two_cartpoles_end_when_both_poles_are_done():
    """Phase 13's two-agent CartPole: each pole is a CartPole-v1 stepped by
    its own agent; a done pole's agent leaves, the episode ends with the
    last, and each agent's rewards are its own pole's."""
    env = chip_smoke.TwoCartPoles()
    obs, _ = env.reset(seed=3)
    ref = {a: chip_smoke.CartPole() for a in ("a0", "a1")}
    for i, (a, pole) in enumerate(ref.items()):
        assert (pole.reset(seed=3 + i)[0] == obs[a]).all()
    live, steps = {"a0", "a1"}, 0
    while live:
        acts = {a: (steps + (a == "a1")) % 2 for a in live}
        obs, rew, term, trunc, _ = env.step(acts)
        steps += 1
        for a in acts:
            o, r, te, tr, _ = ref[a].step(acts[a])
            assert (o == obs[a]).all() and r == rew[a]
            if te or tr:
                live.discard(a)
        assert term["__all__"] == (not live and not any(k != "__all__" for k in trunc))
    assert steps < 500


def test_async_phase_runs_on_the_cpu(capsys):
    """Phase 11 end to end on the CPU on a tiny model standing in for
    phase 4's (its tokens from the sync engine as phase 4 makes them)."""
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams

    cfg = dataclasses.replace(models.tiny(vocab_size=512, max_seq_len=1024), dtype="float32")
    params = models.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = LLMEngine(LLMConfig(model=cfg, max_num_seqs=8, max_seq_len=1024, tokenizer="byte"),
                    params, device="cpu")
    words = "the engine answers every request with thirty two tokens "
    prompts = [(words * 5)[:n] for n in (11, 24, 30, 50, 60, 100, 200, 240)]
    outs = eng.generate(prompts, SamplingParams(max_tokens=32, ignore_eos=True))
    shared = {"serve": {"params": params, "prompts": prompts, "model": cfg, "row": {},
                        "tokens": [o.token_ids for o in outs]}}
    row = chip_smoke.phase_async_llm(shared, device="cpu")
    assert row["prequeued"]["steps"] == 31  # one admission, then 31 decode steps
    arriving = row["arriving"]
    assert max(arriving["steps_per_request"]) <= 32
    # from the step that queued it, each takes its 32 tokens' 31 steps
    # (steps_per_request counts from the hand-over, the two others from
    # the caller's read of the count)
    assert [s + h - q for s, h, q in zip(arriving["steps_per_request"],
                                         arriving["steps_to_hand_over"],
                                         arriving["steps_to_queue"])] == [31] * 8
    assert all(0 <= h <= q for h, q in zip(arriving["steps_to_hand_over"],
                                           arriving["steps_to_queue"]))
    assert row["deadline"]["raised_where"] == ["llm_decode"] * 2
    assert "[async_llm] " in capsys.readouterr().out


def _arriving_row(steps, to_hand_over, to_queue):
    return {"steps_per_request": steps, "steps_to_hand_over": to_hand_over,
            "steps_to_queue": to_queue}


def test_arriving_check_counts_from_the_hand_over():
    """The arriving callers' bound (32 steps for 32 tokens) counts from
    each request's hand-over: a step that ends between the caller's read
    of the count and its hand-over is not the engine's."""
    # the late caller of the failures seen on the card: handed over a step after its
    # read, queued at the next, 31 steps from there (32 from the hand-over)
    chip_smoke._check_arriving(
        _arriving_row([32] * 8, [1, 0, 0, 0, 0, 0, 0, 0], [2, 1, 1, 1, 1, 1, 1, 1]), 32)
    with pytest.raises(SystemExit):
        chip_smoke._check_arriving(
            _arriving_row([32, 33, 32, 32, 32, 32, 32, 32], [0] * 8, [1, 2, 1, 1, 1, 1, 1, 1]),
            32)


def test_runtime_phase_runs_on_the_cpu(capsys):
    """Phase 14 end to end on the CPU (50 calls, 1 MiB tensors, a tiny
    model standing in for phase 4's): its checks pass, its workers report
    their counts (none launches a kernel on the CPU) and those counts are
    added into the kernels line as the ranks' are."""
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams

    cfg = dataclasses.replace(models.tiny(vocab_size=512, max_seq_len=1024), dtype="float32")
    params = models.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = LLMEngine(LLMConfig(model=cfg, max_num_seqs=8, max_seq_len=1024, tokenizer="byte"),
                    params, device="cpu")
    words = "the engine answers every request with thirty two tokens "
    prompts = [(words * 5)[:n] for n in (11, 24, 30, 50, 60, 100, 200, 240)]
    outs = eng.generate(prompts, SamplingParams(max_tokens=8, ignore_eos=True))
    shared = {"serve": {"params": params, "prompts": prompts, "model": cfg, "row": {},
                        "tokens": [o.token_ids for o in outs]}}
    out = chip_smoke.phase_runtime(shared, device="cpu", small=True)
    row = out["row"]
    assert row["resources"] == {"CPU": row["resources"]["CPU"], "GPU": 1.0}
    assert row["engine_actor"]["tokens_equal_to_phase_4"]
    assert row["gpu_task"]["bitwise_equal"] and row["pids_left_after_shutdown"] == []
    assert set(out["launches"]) == set(chip_smoke._KERNELS)
    assert set(out["launches"].values()) == {0}
    total = {"launches": dict.fromkeys(chip_smoke._KERNELS, 3),
             "copies": dict.fromkeys(chip_smoke._COPYING, 0)}
    assert chip_smoke._add_counts(total, out)["launches"] == total["launches"]
    worker = {"launches": dict(out["launches"], flash_fwd=1), "copies": out["copies"]}
    assert chip_smoke._add_counts(total, worker)["launches"]["flash_fwd"] == 4
    assert "[runtime] " in capsys.readouterr().out


def test_dag_phase_runs_on_the_cpu(capsys):
    """Phase 15 end to end on the CPU (1 MiB tensors, 4 executes, a tiny
    model standing in for phase 4's and phase 9's): the device and shm
    edges give the driver's draws, the disaggregated DAG gives the
    monolithic engine's tokens, the collectives numpy's, the trainer's
    worker phase 9's losses bit for bit (the resumed fit too); its counts
    (none launches a kernel on the CPU) come back for the kernels line."""
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams

    cfg = dataclasses.replace(models.tiny(vocab_size=512, max_seq_len=1024), dtype="float32")
    params = models.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = LLMEngine(LLMConfig(model=cfg, max_num_seqs=8, max_seq_len=1024, tokenizer="byte"),
                    params, device="cpu")
    words = "the engine answers every request with thirty two tokens "
    prompts = [(words * 5)[:n] for n in (11, 24, 30, 50, 60, 100, 200, 240)]
    outs = eng.generate(prompts, SamplingParams(max_tokens=chip_smoke._DAG_N_NEW,
                                                ignore_eos=True))
    shared = {"serve": {"params": params, "prompts": prompts, "model": cfg, "row": {},
                        "tokens": [o.token_ids for o in outs]},
              "train_backend": chip_smoke._dag_train_reference(True, "cpu")}
    out = chip_smoke.phase_dag(shared, device="cpu", small=True)
    row = out["row"]
    # CPU tensors cross a device edge as host bytes in the slot (on the
    # card only the descriptor does, under 64 KiB)
    assert row["edge"]["bitwise_equal"] and row["edge"]["meta_bytes_per_message"] > 1 << 20
    assert row["edge"]["in_flight"]["bitwise_equal"]
    assert row["disaggregated"]["tokens_equal_to_phase_4"]
    assert row["collective"]["equal_to_numpy"]
    assert row["trainer"]["bitwise_equal_to_phase_9"] and row["trainer"]["resumed_bitwise_equal"]
    assert row["pids_left_after_shutdown"] == []
    assert set(out["launches"]) == set(chip_smoke._KERNELS)
    assert set(out["launches"].values()) == {0}
    assert "[dag] trainer " in capsys.readouterr().out


def test_serve_apps_phase_runs_on_the_cpu(capsys):
    """Phase 16 end to end on the CPU (a tiny model standing in for phase
    4's and for (b)'s GPT-2, at T=64): the OpenAI app and the
    disaggregated app give phase 4's tokens over HTTP, the batched forward
    deployment's rows are within its limit in batches of four, and no
    process is left; the forward replica's counts are added (none
    launches a kernel on the CPU)."""
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams

    cfg = dataclasses.replace(models.tiny(vocab_size=512, max_seq_len=1024), dtype="float32")
    # the weights the replicas build from LLMConfig's seed
    params = models.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = LLMEngine(LLMConfig(model=cfg, max_num_seqs=8, max_seq_len=1024, tokenizer="byte"),
                    params, device="cpu")
    words = "the engine answers every request with thirty two tokens "
    prompts = [(words * 5)[:n] for n in (11, 24, 30, 50, 60, 100, 200, 240)]
    outs = eng.generate(prompts, SamplingParams(max_tokens=8, ignore_eos=True))
    shared = {"serve": {"params": params, "prompts": prompts, "model": cfg, "row": {},
                        "tokens": [o.token_ids for o in outs]}}
    out = chip_smoke.phase_serve_apps(shared, device="cpu", small=True)
    row = out["row"]
    assert row["openai"]["tokens_equal_to_phase_4"]
    assert row["disaggregated"]["tokens_equal_to_phase_4"]
    assert row["disaggregated"]["handoffs"] >= 3 * len(prompts)
    assert sorted(row["forward"]["batch_sizes"]) == [4, 4]
    assert row["forward"]["worst_share_of_max_logit"] <= chip_smoke._SERVE_FWD_TOL
    assert row["pids_left_after_shutdown"] == []
    assert set(out["launches"]) == set(chip_smoke._KERNELS)
    assert set(out["launches"].values()) == {0}
    assert "[serve_apps] disaggregated " in capsys.readouterr().out


def _tiny_serve_shared(n_new=8):
    """Phase 4's record for the CPU tests: a tiny f32 model (its weights
    from LLMConfig's seed, as a replica or a pool worker builds them) and
    its tokens for phase 4's prompts."""
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams

    cfg = dataclasses.replace(models.tiny(vocab_size=512, max_seq_len=1024), dtype="float32")
    params = models.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = LLMEngine(LLMConfig(model=cfg, max_num_seqs=8, max_seq_len=1024, tokenizer="byte"),
                    params, device="cpu")
    words = "the engine answers every request with thirty two tokens "
    prompts = [(words * 5)[:n] for n in (11, 24, 30, 50, 60, 100, 200, 240)]
    outs = eng.generate(prompts, SamplingParams(max_tokens=n_new, ignore_eos=True))
    return {"serve": {"params": params, "prompts": prompts, "model": cfg,
                      "row": {"total_s": 1.0}, "tokens": [o.token_ids for o in outs],
                      "texts": [o.text for o in outs]}}


def test_rllib_remote_phase_runs_on_the_cpu(capsys):
    """Phase 17 end to end on the CPU (2 PPO iterations and 2 of IMPALA):
    PPO with 2 remote runners and 2 remote learners, IMPALA and APPO at
    their defaults pass its checks, no process is left, and it reports no
    kernel launch."""
    out = chip_smoke.phase_rllib_remote({}, device="cpu", small=True)
    row = out["row"]
    assert row["ppo"]["learners_bitwise_equal"] == [True, True]
    assert all(s >= 512 for s in row["ppo"]["env_steps_sampled"])
    assert row["impala"]["iterations"] == 2 and row["appo"]["iterations"] == 1
    assert row["pids_left_after_shutdown"] == []
    assert set(out["launches"]) == set(chip_smoke._KERNELS)
    assert set(out["launches"].values()) == {0}
    assert "[rllib_remote] appo " in capsys.readouterr().out


def test_data_phase_runs_on_the_cpu(capsys):
    """Phase 18 end to end on the CPU (a tiny model at B=2, T=32; phase
    4's tiny stand-in): the Dataset-fed steps equal the direct ones bit
    for bit, the pool of one GPU-leased worker gives phase 4's texts
    (the engine's own), its worker's counts come back (no launch on the
    CPU), no process is left, and the optional libraries are listed."""
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    shared = _tiny_serve_shared()
    out = chip_smoke.phase_data(shared, device="cpu", small=True)
    row = out["row"]
    assert row["train"]["bitwise_equal_to_direct"] and len(row["train"]["losses"]) == 6
    bi = row["batch_inference"]
    assert bi["texts_equal_to_phase_4"] and bi["rows"] == 16 and bi["batches"] == 2
    assert bi["pool"]["spawned"] == 1
    # the texts it held the stage to (phase 4's tokens decoded) are the engine's
    assert shared["serve"]["texts"] == [ByteTokenizer().decode(t)
                                        for t in shared["serve"]["tokens"]]
    assert set(row["optional_libraries"]) == set(chip_smoke._OPTIONAL)
    assert row["pids_left_after_shutdown"] == []
    assert set(out["launches"]) == set(chip_smoke._KERNELS)
    assert set(out["launches"].values()) == {0}
    assert "[data] batch_inference " in capsys.readouterr().out


def test_tune_jobs_phase_runs_on_the_cpu(capsys):
    """Phase 19 end to end on the CPU (a tiny model at B=2, T=32; phase
    9's losses from the driver): the Tuner's trials on half-card leases
    (resources only) pinned to "0" and overlapping, the 3e-4 trial's
    losses and the trainer trial's the driver's bit for bit, the best
    checkpoint its last report's, the workflow resumed once with its GPU
    step run once and stored as a CPU tensor, the job's task printing
    the driver's checksum, the trial actors in the state API and on the
    dashboard, no process left; no kernel launch on the CPU."""
    shared = {"train_backend": chip_smoke._dag_train_reference(True, "cpu")}
    out = chip_smoke.phase_tune_jobs(shared, device="cpu", small=True)
    row = out["row"]
    tune = row["tune"]
    assert sorted(t["lr"] for t in tune["trials"]) == sorted(chip_smoke._TUNE_LRS)
    assert tune["overlapped"] and tune["best_checkpoint_equals_last_report"]
    assert all(t["visible"] == "0" for t in tune["trials"])
    assert row["tune_trainer"]["losses_3e-4_equal_to_phase_9"]
    wf = row["workflow"]
    assert wf["first_run"] != "returned" and wf["status"] == "SUCCESS"
    assert wf["forward_runs"] == 1 and wf["bitwise_equal_to_driver"]
    assert wf["stored_step"] == {"visible": "", "device": "cpu", "dtype": "torch.float32"}
    jobs = row["jobs"]
    assert jobs["status"] == "SUCCEEDED" and jobs["dashboard_gpu_total"] == 1
    assert jobs["trial_actors_in_state_api"] and jobs["trial_actors_in_dashboard"]
    assert jobs["job_task_visible"] == "0" and jobs["job_driver_visible"] == "''"
    assert row["pids_left_after_shutdown"] == []
    assert set(out["launches"]) == set(chip_smoke._KERNELS)
    assert set(out["launches"].values()) == {0}
    assert "[tune_jobs] jobs " in capsys.readouterr().out
