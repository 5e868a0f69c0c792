"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. setup   — build the hand-written kernels from the sources in this
               checkout; print the card's name and power limit.
  2. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes the main path gives it; times of the kernel,
               the plain version and the library call that computes the
               same function; the bound for the same work on this card.
  3. forward — the main path, part 1: GPT-2 124M (full width, random
               weights from a seed) forward at B=4, T=1024 with
               attn_impl="flash", held against attn_impl="reference";
               the flash kernel must launch once per layer per forward.
  4. serve   — the main path, part 2: the LLM engine on GPT-2 124M
               answers 8 byte-tokenised prompts, greedy, 32 tokens each;
               request 0 held against models.generate.

Kernel launch counts are set to 0 just before phase 3 and read just
after phase 4; launches made in phase 2 do not count.

The line before the last holds {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Published peaks (NVIDIA data sheets, dense): memory bytes/s and
# operations/s by input type. fp32 runs on the FMA units, not TF32.
_PEAKS = (
    ("H100 PCIe", 2.0e12, {torch.bfloat16: 756e12, torch.float16: 756e12,
                           torch.float32: 51e12}),
    ("H100 NVL", 3.9e12, {torch.bfloat16: 835e12, torch.float16: 835e12,
                          torch.float32: 60e12}),
    ("H100", 3.35e12, {torch.bfloat16: 989e12, torch.float16: 989e12,
                       torch.float32: 67e12}),
)


def _peaks(name: str):
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops
    raise SystemExit(f"no published peaks on file for {name!r}")


def _time_ms(fn, *, iters: int = 20, flush=None) -> float:
    """Median device time of one call, by CUDA events. ``flush`` (a
    tensor larger than L2) is rewritten before each call so the call
    reads its inputs from device memory, as the bound assumes."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(cond: bool, what: str) -> None:
    if not cond:
        print(f"FAILED: {what}", file=sys.stderr)
        raise SystemExit(1)


def phase_setup():
    from ray_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    libs = _kernels.build()
    print(f"[setup] built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in libs.values()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return smi.splitlines()[0]


def _attention_bound_ms(b, t, h, d, dtype, causal, card):
    bw, flops = _peaks(card)
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * t * h * d * esize + b * h * t * 4  # q,k,v in; O, LSE out
    pairs = t * (t + 1) // 2 if causal else t * t
    ops = 4 * b * h * d * pairs
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# Tolerances of the kernel against its plain version.
#  fp32: only the summation order differs (64-key tiles and WMMA-free FMA
#        in the kernel, 256-key blocks and a matmul in the plain version).
#  bf16/fp16: p is rounded to the input type per tile, relative to the
#        running max at that tile, and the tiles differ (64 vs 256 keys).
_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-3),
        torch.float16: (2e-2, 1e-3)}


def phase_kernels(card: str):
    from ray_tpu_torch.ops.attention import flash_forward_plain
    from ray_tpu_torch.ops._kernels import flash_fwd

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = [(4, 1024, 12, 64, dt, causal)
             for causal in (True, False)
             for dt in (torch.bfloat16, torch.float16, torch.float32)]
    cases.append((1, 2048, 32, 128, torch.bfloat16, True))
    # Ragged edges (T not a multiple of the kernel's 64-row tiles) and the
    # remaining type/head_dim instantiations, at small shapes.
    cases += [(2, 100, 12, 64, torch.bfloat16, True),
              (2, 100, 12, 64, torch.float32, False),
              (1, 200, 4, 128, torch.float32, True),
              (1, 200, 4, 128, torch.float16, False)]
    results = []
    for b, t, h, d, dt, causal in cases:
        # q/k/v as the model makes them: strided views of one fused
        # [B, T, H, 3D] projection.
        qkv = torch.randn((b, t, h, 3 * d), generator=gen, device="cuda",
                          dtype=torch.float32).to(dt)
        q, k, v = qkv.split(d, dim=-1)
        o, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        ro, rlse = flash_forward_plain(q, k, v, causal=causal, block_k=256)
        torch.cuda.synchronize()
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        tol_o, tol_lse = _TOL[dt]
        ms = _time_ms(lambda: flash_fwd(q, k, v, causal=causal,
                                        return_lse=True), flush=flush)
        plain_ms = _time_ms(lambda: flash_forward_plain(
            q, k, v, causal=causal, block_k=256), iters=5, flush=flush)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), flush=flush)
        bound_ms, bound_by = _attention_bound_ms(b, t, h, d, dt, causal, card)
        row = {"shape": [b, t, h, d], "dtype": str(dt).split(".")[-1],
               "causal": causal, "max_abs_err": err_o,
               "max_abs_err_lse": err_lse, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        print("[kernels] flash_fwd " + json.dumps(row))
        _check(math.isfinite(err_o) and err_o <= tol_o,
               f"flash_fwd O error {err_o} > {tol_o} at {row['shape']} {dt}")
        _check(math.isfinite(err_lse) and err_lse <= tol_lse,
               f"flash_fwd LSE error {err_lse} > {tol_lse} at {row['shape']} {dt}")
        results.append(row)
    return results


def _sync_ms(fn, *, iters: int = 5) -> float:
    """Median host time of a call that ends in a device synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(fn, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler: wall time, the device
    time its kernels took (sum of self device times), and the kernels
    that took the most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel events only: an operator's own event also carries its
    # kernels' device time and would count it twice.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top": [{"name": n[:80], "ms": ms, "calls": cnt}
                    for n, ms, cnt in rows[:top]]}


def phase_forward():
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.ops._kernels import flash_fwd

    B, T = 4, 1024
    cfg = models.gpt2_small(max_seq_len=1024, attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_params(gen, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device="cuda")
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    f32 = dataclasses.replace(cfg, dtype="float32")
    f32_ref = dataclasses.replace(ref_cfg, dtype="float32")

    def counted_forward(c):
        before = flash_fwd.launches
        logits = models.forward(params, tokens, c)
        _check(flash_fwd.launches - before == c.n_layers,
               f"flash kernel launched {flash_fwd.launches - before} times "
               f"in one forward, expected {c.n_layers}")
        return logits

    # fp32: only the attention's summation order differs from the
    # reference path, so the logits agree to well under 2e-3.
    lf = counted_forward(f32)
    lr = models.forward(params, tokens, f32_ref)
    err32 = (lf - lr).abs().max().item()
    _check(lf.shape == (B, T, cfg.vocab_size) and bool(lf.isfinite().all()),
           f"fp32 logits shape {tuple(lf.shape)} / non-finite values")
    _check(err32 <= 2e-3, f"fp32 flash logits differ from reference by {err32}")
    del lf, lr
    # bf16 (the model's compute dtype): report the distance.
    lb = counted_forward(cfg)
    lbr = models.forward(params, tokens, ref_cfg)
    _check(bool(lb.isfinite().all()), "bf16 logits are not finite")
    err16 = (lb - lbr).abs().max().item()
    agree = (lb.argmax(-1) == lbr.argmax(-1)).float().mean().item()
    del lb, lbr
    fwd_ms = _sync_ms(lambda: counted_forward(cfg))
    ref_ms = _sync_ms(lambda: models.forward(params, tokens, ref_cfg))
    row = {"batch": B, "seq": T, "fp32_max_abs_err_logits": err32,
           "bf16_max_abs_diff_logits": err16, "bf16_argmax_agreement": agree,
           "forward_ms_bf16_flash": fwd_ms,
           "forward_ms_bf16_reference": ref_ms}
    print("[forward] " + json.dumps(row))
    print("[forward] profile bf16 flash " + json.dumps(
        _profile(lambda: counted_forward(cfg))))
    return row


def _top2_margins(logits):
    top = logits.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1])


def phase_serve():
    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams, model_runner

    eng = LLMEngine(LLMConfig(model="gpt2_small", max_num_seqs=8,
                              max_seq_len=1024, tokenizer="byte"),
                    device="cuda")
    # Mixed bucket lengths (with BOS): 3 x 32, 2 x 64, 1 x 128, 2 x 256.
    words = "the engine answers every request with thirty two tokens "
    prompts = [(words * 5)[:n] for n in (11, 24, 30, 50, 60, 100, 200, 240)]
    n_new = 32
    sp = SamplingParams(max_tokens=n_new, ignore_eos=True)
    for i, p in enumerate(prompts):
        eng.add_request(f"r{i}", p, sp)
    reqs = list(eng.waiting)
    done = {}
    t0 = time.time()  # the engine stamps requests with time.time()
    while eng.has_unfinished():
        for out in eng.step():
            done[out.request_id] = out
    t_end = time.time()
    _check(len(done) == len(prompts), f"{len(done)} of {len(prompts)} finished")
    for rid, out in done.items():
        _check(len(out.token_ids) == n_new and out.finish_reason == "length",
               f"{rid}: {len(out.token_ids)} tokens, {out.finish_reason}")
    ttft = [r.t_first - r.t_add for r in reqs]
    t_first = max(r.t_first for r in reqs)
    decode_tokens = sum(len(o.token_ids) - 1 for o in done.values())
    # Request 0 against the model library's own generate loop (greedy,
    # same params). The top-2 logit margins along request 0's tokens are
    # reported: a bf16 near-tie is where the two paths could part.
    c = eng.model_config
    prompt0 = eng.tokenizer.encode(prompts[0])
    ref = models.generate(eng.params, [prompt0], c, max_new_tokens=n_new,
                          max_len=1024)[0, len(prompt0):].tolist()
    got = done["r0"].token_ids
    seq = torch.tensor([prompt0 + got[:-1]], device="cuda")
    margins = _top2_margins(models.forward(eng.params, seq, c)[0, len(prompt0) - 1:])
    first_diff = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
    _check(first_diff is None,
           f"request 0 differs from models.generate at token {first_diff} "
           f"(top-2 margin there {margins[first_diff or 0].item()}): "
           f"{got} vs {ref}")
    row = {"requests": len(prompts), "tokens_each": n_new,
           "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
           "decode_tokens_per_s": decode_tokens / (t_end - t_first),
           "total_s": t_end - t0, "req0_equal_to_generate": got == ref,
           "req0_min_top2_margin": margins.min().item()}
    print("[serve] " + json.dumps(row))
    # One decode step's device work for all 8 slots (at their last
    # positions; the slots are free, so the rows it writes are stale).
    dev = torch.device("cuda")
    args = (torch.from_numpy(eng.last_tokens).to(dev),
            torch.from_numpy(eng.positions).to(dev))
    temps = torch.from_numpy(eng.temps).to(dev)
    print("[serve] profile decode step " + json.dumps(_profile(
        lambda: model_runner.decode(eng.params, *args, eng.cache, temps,
                                    eng._rng, config=c))))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_setup()
    kernel_rows = phase_kernels(card)
    main_row = kernel_rows[0]  # GPT-2 124M attention: bf16, causal

    from ray_tpu_torch.ops._kernels import flash_fwd

    flash_fwd.launches = 0
    with torch.inference_mode():
        phase_forward()
        phase_serve()
    launches = flash_fwd.launches
    _check(launches > 0, "the main path never launched the flash kernel")
    summary = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:144",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
