"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:
  1. setup   — build the hand-written kernels from the sources in this
               checkout; print the card's name and power limit.
  2. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes the main path gives it; times of the kernel,
               the plain version and the library call that computes the
               same function; the bound for the same work on this card
               and the kernel's share of it (bound / time). The flash
               forward, then the backward pair (dQ, dK/dV), each at
               every shape and type the main path gives it (GPT-2's
               forward and train step, moe_small's train step; bf16 and
               fp32) and at a few others.
  3. forward — the main path, part 1: GPT-2 124M (full width, random
               weights from a seed) forward at B=4, T=1024 with
               attn_impl="flash", held against attn_impl="reference";
               the flash kernel must launch once per layer per forward.
  4. serve   — the main path, part 2: the LLM engine on GPT-2 124M
               answers 8 byte-tokenised prompts, greedy, 32 tokens each;
               request 0 held against models.generate.
  5. train   — the main path, part 3: GPT-2 124M (full width, random
               weights from seed 0) trained at B=8, T=1024 with
               attn_impl="flash", fused chunked CE and FusedClipAdamW. fp32:
               one step's loss and every gradient leaf held against
               attn_impl="reference"; bf16: 6 steps, the loss must fall and
               each of the three kernels must launch once per layer per
               step; step time, tokens/s and one profiled step.
  6. moe     — the main path, part 4: one moe_small MoE layer (f32, x
               [8, 1024, 768]) under autograd on the card against the
               same function on the CPU: no token routed differently,
               then the output, aux and every gradient within 1e-4 of each
               tensor's largest |value|; moe_small (full width, 12
               layers, 8 experts, top-2, random weights from seed 0)
               trained at B=4, T=2048 with attn_impl="flash", bf16: 6
               steps of FusedClipAdamW (falling finite loss, router_aux in
               [1, E], each kernel once per layer per step; step time,
               tokens/s, peak memory, one profiled step with the f32
               GEMM kernels' (dispatch/combine) share of it), then 3
               steps each of FusedClipAdamW and of the optax-style
               chain(clip_by_global_norm, adamw) from the same seed, in
               bf16 and in f32 compute, with the tokens each step routes
               differently in the two runs; losses and grad norms must
               match as stated at _OPTAX_STEP_TOL.

  7. parallel — the main path, part 5: the sharded paths
               (ray_tpu_torch.parallel, DeviceMesh and DTensor). (a) world
               size 1 on NCCL: phase 5's GPT-2 124M through
               make_train_step(mesh=MeshConfig().build()) with
               shard_params: one fp32 step's loss and gradients against
               phase 5's unsharded ones (1e-6 of each leaf's max; bitwise
               equality printed), 6 bf16 steps of FusedClipAdamW (the loss
               falls, each kernel once per layer per step), the step's
               host time beside phase 5's. (b) world size 2, two ranks on
               this one card over gloo (the cases that need no collective
               gloo refuses on CUDA tensors):
               moe_small's fp32 step at B=4, T=2048 with its experts split
               over the two ranks, against the unsharded step: no token
               routed differently, every tensor within 1e-4 of its max;
               the ranks' times are those of a correctness run on a shared
               card.
  8. llm     — the main path, part 6: the rest of the single-device LLM
               plane on GPT-2 124M with phase 4's params (8 slots, 1024
               rows, byte tokenizer). (a) paged KV (16-token pages, bf16):
               phase 4's prompts give phase 4's tokens with the full pool,
               half of it, and a pool too small for all eight at their
               peak (admission backs off); (b) prefix caching, dense and
               paged: eight prompts sharing a 512-token prefix, two waves,
               the second hitting the cache; (c) chunked prefill (chunks of
               128, prompts of 300-900 tokens), dense and paged; (d)
               speculative decoding, 4 proposals a step, from the target's
               own weights read from an .npz (every proposal accepted) and
               from a random 2-layer draft; (e) one rank-8 LoRA adapter in
               a mixed batch: base requests give the base tokens, adapter
               requests the tokens of the weights with the adapter merged
               in; (b)-(e) in f32 compute against the dense f32 engine's
               tokens, with the top-2 margin printed where two part; (f) a
               seeded request with every sampling option gives the same
               tokens alone and in a full batch, and greedy logprobs are
               within 1e-4 of log_softmax of models.forward; (g) guided
               JSON (json_object, json_schema): every output stays in the
               grammar and a finished one parses and meets its schema.
               Prints tokens/s, TTFT, kv_stats, prefix hits, speculative
               acceptance, the pool's bytes beside the dense cache's, and
               the paged decode step's device and wall time beside the
               dense step's.
  9. train_backend — the main path, part 7: the Train backend
               (ray_tpu_torch.train) under a user's data-parallel loop
               (sync_model_params, autograd gradients,
               allreduce_gradients, FusedClipAdamW) on GPT-2 124M in
               bench.py's configuration. (a) A world-size-1 NCCL group
               started by TorchBackend.on_worker_setup: 6 bf16 steps at
               B=8, T=1024 (a batch of its own each, from a seed; finite
               losses), a checkpoint at step 3 through
               CheckpointManager; a fresh state restored from it gives
               steps 4-6 bit for bit (losses and every parameter and
               moment). (b) Two ranks on this card over gloo, half of
               the batch each: their averaged fp32 gradients within 1e-4
               of each leaf's max of one rank's on the whole batch.
 10. llm_parallel — the main path, part 8: GPT-2 124M with phase 4's
               params in f32 served with tensor_parallel_size=2 on two
               gloo ranks of this card: phase 8's prompts give the dense
               f32 engine's greedy tokens on both ranks, each rank's
               cache holds 6 of the 12 kv heads; the tensor-parallel
               decode step's wall and device time beside the dense
               engine's. Then pipeline_parallel_size=2 the same way,
               where gloo's point-to-point transport takes CUDA tensors;
               where it does not, its error is printed (and any other
               error fails the run).
 11. async_llm — the main path, part 9: AsyncLLMEngine over an engine of
               phase 4's setup (GPT-2 124M, phase 4's params, 8 slots):
               8 concurrent asyncio callers with phase 4's prompts, 32
               greedy tokens each, give phase 4's tokens; a streamed
               request's increments, joined, are its output; on a paged
               engine a request whose deadline has passed and one whose
               deadline passes mid-decode raise TaskTimeoutError and
               leave no slot or page behind; a sync generate() beside
               async requests in flight lets both finish. Prints decode
               tokens/s and TTFT beside phase 4's.
 12. rllib   — the main path, part 10: ray_tpu_torch.rllib on the card,
               on CartPole-v1 and Pendulum-v1 written here from
               gymnasium's equations: PPO at its defaults (8 envs,
               64-step fragments, batch 512, 4 epochs of 128-row
               minibatches, hidden (64, 64)) for 5 iterations; one PPO
               learner update on the card against the same update on the
               CPU (1e-4 of each leaf's max); a checkpoint restored into
               a fresh PPO gives the same next iteration's weights bit
               for bit; DQN and SAC for 4 iterations (3 past
               learning_starts); BC and MARWIL on PPO's batches and CQL
               on SAC's transitions for 3 iterations; an IMPALA and an
               APPO learner update on one batch. Every loss finite;
               prints env steps/s sampled and learner update ms.
 13. rllib_more — the main path, part 11: the rest of RLlib that needs
               no runtime. Multi-agent PPO on two CartPole-v1 poles
               written here (RLlib's MultiAgentCartPole shape), a module
               per pole, at PPO's defaults for 3 iterations: every loss
               finite, one learner update on the card against the CPU
               (1e-4 of each leaf's max), a restored checkpoint's next
               iteration bit for bit. DreamerV3 at ray_tpu's defaults on
               CartPole-v1 for 2 iterations past learning_starts: every
               loss term finite; one update on the card against the CPU
               from the same state, batch and Gumbel noise (1e-4 of each
               leaf's max; the same categories drawn, on a draw whose
               every argmax is decided by more than 1e-5); a restored
               checkpoint's next update bit for bit. The learner mesh:
               PPO's update through a world-size-1 NCCL mesh bit for bit
               against the unmeshed one; two gloo ranks on this card,
               half of a 128-row minibatch each, equal to each other bit
               for bit and within 1e-4 of each leaf's max of the whole
               minibatch's update. Prints env steps/s sampled, update ms
               (DreamerV3's, and the two ranks' beside the unmeshed, gloo
               through the host) and DreamerV3's updates per iteration.
 14. runtime — the main path, part 12: the task/actor core
               (ray_tpu_torch.init / remote / get / put / kill /
               shutdown). init() with no num_gpus counts this card as
               GPU: 1; prints its seconds and the lane each native piece
               took (built from ray_tpu_torch/src into
               build/ray_tpu_torch/native). 1,000 no-op tasks and 1,000
               calls of one actor (tasks/s, calls/s). A num_gpus=1 task
               runs the bf16 flash forward at (4, 1024, 12, 64) on q, k, v
               put by the driver: its CUDA result equals the driver's own
               launch bit for bit, and the task sees only its lease; a
               chipless task sees no device. A 256 MiB tensor on the card
               and one on the host, put and got back bit for bit (ms and
               GB/s of each). A num_gpus=1 actor holds phase 4's engine on
               phase 4's weights, passed as object refs, and serves phase
               4's 8 prompts: phase 4's tokens (decode tokens/s beside
               phase 4's). After shutdown() no process the cluster started
               is left.
 15. dag     — the main path, part 13: compiled DAGs, channels, Train's
               trainer and util.collective on the core, with two
               num_gpus=0.5 actors sharing this card (both see it as
               cuda:0). (a) A 256 MiB bf16 tensor drawn by actor A from a
               seed, handed to actor B and on to the driver over two
               with_tensor_transport("device") edges (CUDA IPC: a
               descriptor on the host ring, a device-to-device copy by
               the reader): 20 executes, each bit for bit the driver's own
               draw; ms per execute beside 6 executes of the same DAG on
               the default shm transport (bit for bit too); the device
               edge's meta message under 64 KiB. Then B's work() keeps
               the card reading each received tensor for 32 passes after
               it returns, with 3 executes in flight: 20 results over a
               second device edge, each bit for bit the driver's own
               work() on its own draw (a reader whose copy could land in
               memory those kernels still read would differ). (b) Disaggregated
               serving: a prefill engine on A and a decode engine on B
               (phase 4's configuration, weights rebuilt from phase 4's
               seed, paged bf16 KV in 16-token pages), the DAG
               input -> prefill_detached -> device edge -> decode
               (add_handoff_request, stepped to its end) -> driver serves
               phase 4's 8 prompts one at a time, greedy, 32 tokens:
               phase 4's tokens; per request the time to first token,
               to the last token, the handoff's bytes and ms, beside the
               same DAG over shm. (d) util.collective between A and B:
               allreduce (sum), allgather and broadcast of 1M f32 on the
               card give CUDA tensors equal to numpy's. (c) TorchTrainer
               (ScalingConfig(num_workers=1, use_gpu=True), an NCCL group
               of one) runs phase 9 (a)'s loop on its worker (6 bf16
               steps at B=8, T=1024, a report each, a checkpoint with
               step 3's): its losses equal phase 9 (a)'s bit for bit,
               Result.metrics are the 6th step's, and a second fit
               resumed from the step-3 checkpoint gives steps 4-6 bit for
               bit; each kernel launches once per layer per step in the
               worker; the worker's step host ms beside phase 9's. After
               shutdown() no process the cluster started is left.
 16. serve_apps — the main path, part 14: Serve (ray_tpu_torch.serve)
               and the OpenAI app (ray_tpu_torch.llm.serving) on the
               core, serve.start() with the HTTP proxy on the loopback.
               (a) build_openai_app on phase 4's configuration (its
               weights from the same seed), one replica on num_gpus=1,
               under /v1: phase 4's 8 prompts as concurrent POST
               /v1/completions from threads over urllib give phase 4's
               tokens (by id, vLLM's return_tokens_as_token_ids); a
               streamed chat completion's SSE increments, joined, equal
               its answer; GET /v1/models lists the model. Prints the
               replica's seconds to ready, TTFT (concurrent one-token
               requests) and decode tokens/s through HTTP beside phase
               4's engine and phase 14's actor. (b) GPT-2 124M's bf16
               forward (attn_impl="flash", T=1024) as a deployment on
               num_gpus=0.5 whose __call__ is @serve.batch(max_batch_size
               =4): 8 concurrent handle calls of one row each, each
               within _SERVE_FWD_TOL of a direct forward of the row in
               this process; the batch sizes the replica saw; its flash
               launches are counted. (c) build_disaggregated_app (a
               prefill and a decode replica on num_gpus=0.5 each) after
               (a)'s app is deleted: phase 4's prompts over HTTP give
               phase 4's tokens; the handoff's ms (median) and its share
               of TTFT. After serve.shutdown() and shutdown() no process
               the cluster started is left. serve.run returns once a
               replica's constructor has returned: the first request
               after it (GET /v1/models over HTTP) must be answered
               200, not shed with a 408.
 17. rllib_remote — the main path, part 15: RLlib's remote groups on the
               core. (a) PPO on the script's CartPole at its defaults
               with 2 remote env runners (CPU actors, modules on the
               CPU) and 2 remote learners on the card (num_gpus=0.5
               each), 3 iterations: every loss finite, the learners'
               weights equal bit for bit after each iteration, at least
               the train batch sampled each time; (b) IMPALA at its
               defaults (2 runners, 2 requests in flight each, batch
               512), 3 iterations: at least one learner update each,
               finite losses, the first mean_rho in (0.5, 2); (c) APPO
               at its defaults, 1 iteration, the same checks. Env
               steps/s and update ms beside phase 12's local numbers.
               No process left after shutdown().
 18. data   — the main path, part 16: ray_tpu_torch.data. (a) GPT-2
               124M's tokens for 6 steps at B=8, T=1024, drawn once
               from phase 5's seed, in a Dataset (from_numpy) whose
               iter_torch_batches(device="cuda") feeds 6 bf16 steps of
               phase 5's configuration: the losses equal a direct run on
               the same tokens bit for bit (two runs of each, in
               turns), each kernel launches once per layer per step;
               tokens/s through the Dataset beside the direct run's and
               phase 5's. (b) build_llm_processor on phase 4's
               configuration (its weights from the same seed) on an
               actor pool of one worker holding a GPU lease: phase 4's
               8 prompts twice, greedy, 32 tokens, give phase 4's texts;
               tokens/s (end to end, and the second batch's) beside
               phase 4's; the pool's stats. (c) which of pyarrow, pandas,
               PIL and tensorflow this machine has. No process left
               after shutdown().
 19. tune_jobs — the main path, part 17: Tune, Workflow, job submission,
               the state API and the dashboard on one cluster. (a) A
               Tuner over phase 9 (a)'s bf16 GPT-2 124M steps (B=8,
               T=1024, FusedClipAdamW) as a function trainable on half a
               card a trial (tune.with_resources {"gpu": 0.5}), learning
               rates 3e-4, 1e-3, 1e-4, 3e-5, two trials at a time, ASHA
               (max_t 3 reports of 2 steps, each with a checkpoint): no
               trial error, two trials training at once on device "0",
               the 3e-4 trial's losses phase 9's bit for bit, the best
               Result's checkpoint loaded here equal to its last report's
               parameters (by checksum), each bf16 kernel 12 launches a
               step in the trials' workers; each trial's cold start and
               step ms beside phase 5's, the fit's wall time. (b)
               Tuner(TorchTrainer) over phase 9's loop on a worker of
               half a card, learning rates 3e-4 and 1e-3, 3 steps: the
               3e-4 trial's losses phase 9's bit for bit. (c) A workflow:
               a CPU step makes tokens, a num_gpus=0.5 step returns GPT-2's
               per-row losses (B=4, T=1024, flash) as a CUDA tensor, a
               CPU step gated by an event the driver triggers fails on
               its first run; resume returns the driver's forward bit for
               bit, the GPU step ran once, its stored value loads in a
               worker without a card. (d) The dashboard; a job
               (JobSubmissionClient) joins the cluster and runs one
               num_gpus=1 flash forward whose checksum, printed, is the
               driver's; /api/cluster shows GPU 1, the trial actors are
               in util.state and /api/actors, summarize_tasks counts the
               job's task, /metrics and the Grafana JSON answer. No
               process left after shutdown().

Each path of phases 3-19 is driven with the kernels' launch and copy
counts set to 0 just before it and read just after; launches made in
phase 2 do not count, those of the ranks of phases 7, 9 and 13, of
phase 14's workers, of phase 15's trainer worker (its last report
carries its counts), of phase 16's forward replica, of phase 18's
pool worker (a stage fused after the LLM stage reports them) and of
phase 19's trials, trainer workers, GPU workflow step and job task do;
phase 17's learners and runners run MLPs and report none. No path may make the
wrappers copy an input (the model's q, k, v are views that TMA reads in
place, on each rank's shard too). The kernels line sums the launches of
phases 3-19, one entry for each kernel: a wrapper
sends bf16/fp16 to a wgmma kernel and fp32 to a kernel of its own
(every product in 3xTF32 on the tensor cores), and counts the two apart.
Phase 2 also requires two launches of the fp32 forward and of the fp32
backward kernels to give bitwise-equal results; the fp32 forward to take
no longer than SDPA's fp32 forward at GPT-2 124M's shape; the bf16 dK/dV
kernel alone and the fp32 dQ + dK/dV pair to take no longer than SDPA's
whole backward at GPT-2 124M's training shape.

Phases 11, 12 and 13 reach no Pallas kernel's counterpart (the LLM
runner, RLlib's MLPs and DreamerV3's GRU and MLPs launch none), nor do
phase 15's engines and edges, nor phase 16's LLM replicas, nor phase
17's learners and runners, nor phase 18's LLM pool worker; their
launches are counted all the same, but for phase 17's workers, which
are not asked.

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

import numpy as np
import torch

# Published peaks (NVIDIA data sheets, dense): memory bytes/s,
# operations/s by input type (fp32 on the FMA units, outside the tensor
# cores), and the tensor cores' TF32 rate. The fp32 attention kernels run
# in 3xTF32 (three TF32 products per fp32 product), the f32 GEMMs of
# torch's products on the FMA units.
_PEAKS = (
    ("H100 PCIe", 2.0e12, {torch.bfloat16: 756e12, torch.float16: 756e12,
                           torch.float32: 51e12}, 378e12),
    ("H100 NVL", 3.9e12, {torch.bfloat16: 835e12, torch.float16: 835e12,
                          torch.float32: 60e12}, 417.5e12),
    ("H100", 3.35e12, {torch.bfloat16: 989e12, torch.float16: 989e12,
                       torch.float32: 67e12}, 495e12),
)


def _peaks(name: str):
    """(memory bytes/s, {dtype: operations/s}, TF32 operations/s) of a card."""
    for key, bw, flops, tf32 in _PEAKS:
        if key in name:
            return bw, flops, tf32
    raise SystemExit(f"no published peaks on file for {name!r}")


def _ops_ms(ops, dtype, card):
    """Least time of ``ops`` attention operations in ``dtype`` and what it
    is bound by: fp32 runs in 3xTF32, three TF32 operations on the tensor
    cores for each one; bf16/fp16 at their own rate."""
    _, flops, tf32 = _peaks(card)
    if dtype == torch.float32:
        return 3 * ops / tf32 * 1e3, "operations (3xTF32)"
    return ops / flops[dtype] * 1e3, "operations"


def _time_ms(fn, *, iters: int = 20, flush=None) -> float:
    """Median device time of one call, by CUDA events. A spin kernel of
    about a millisecond holds the stream before each call, so the host
    queues the call's launches ahead of the device and the events time
    the device's work, not the host's gaps between launches. ``flush`` (a
    tensor larger than L2) is rewritten before each call so the call
    reads its inputs from device memory, as the bound assumes."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)  # clock cycles
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


def _attended_pairs(tq, tk, causal):
    """(query, key) pairs the attention computes for one (batch, head):
    causal masks key j for query i < j (global positions from 0)."""
    if not causal:
        return tq * tk
    n = min(tq, tk)
    return n * (n + 1) // 2 + max(tq - tk, 0) * tk


def _attention_bound_ms(b, tq, tk, h, d, dtype, causal, card):
    """Bound of the forward: q [B,Tq,H,D] and k, v [B,Tk,H,D] read once,
    O and the f32 LSE [B*H,Tq] written once; two products of length D per
    attended pair (4*D operations)."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * tq + 2 * tk) * b * h * d * esize + b * h * tq * 4
    t_bytes = nbytes / _peaks(card)[0] * 1e3
    t_ops, by = _ops_ms(4 * b * h * d * _attended_pairs(tq, tk, causal), dtype, card)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else by)


def _attention_bwd_bound_ms(b, tq, tk, h, d, dtype, causal, card, *, dq: bool):
    """Bound of one backward pass. Both read q, dO [B,Tq,H,D], k, v
    [B,Tk,H,D] and the f32 LSE and delta [B*H,Tq]; the dQ pass writes dQ
    and does 3 products of length D per attended pair (S, dP, dQ: 6*D
    operations), the dK/dV pass writes dK and dV and does 4 (S, dP, dV,
    dK: 8*D)."""
    esize = torch.empty((), dtype=dtype).element_size()
    q_bytes, kv_bytes = b * tq * h * d * esize, b * tk * h * d * esize
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * b * h * tq * 4
    nbytes = reads + (q_bytes if dq else 2 * kv_bytes)
    t_bytes = nbytes / _peaks(card)[0] * 1e3
    t_ops, by = _ops_ms((6 if dq else 8) * b * h * d * _attended_pairs(tq, tk, causal),
                        dtype, card)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else by)


def _pair_no_slower_than_library(row) -> bool:
    """Whether a phase-2 backward row's dQ and dK/dV kernels together take
    no longer than the library's whole backward (SDPA's, for the same dO)
    timed in the same run."""
    return row["ms_dq"] + row["ms_dkv"] <= row["library_ms"]


def _forward_no_slower_than_library(row) -> bool:
    """Whether a phase-2 forward row's kernel takes no longer than the
    library's forward (SDPA's) timed in the same run."""
    return row["ms"] <= row["library_ms"]


# Tolerances of the kernel against its plain version.
#  fp32: the kernel takes every product in 3xTF32 (hi.lo + lo.hi + hi.hi
#        of the TF32 halves of each operand, ~2^-22 of each term dropped,
#        the order of fp32's own rounding) and sums in another order
#        (64-key tiles at head_dim 64, at 128 32-key tiles whose halves two
#        warps take and merge, in the kernel; 256-key blocks and a matmul
#        in the plain version). TF32 alone (hi.hi) misses these limits
#        (tests/test_torch_fp32_split.py).
#  bf16/fp16: p is rounded to the input type per tile, relative to the
#        running max at that tile, and the tiles differ (64 vs 256 keys).
_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-3),
        torch.float16: (2e-2, 1e-3)}


def phase_kernels(card: str):
    from ray_tpu_torch.ops.attention import flash_forward_plain
    from ray_tpu_torch.ops._kernels import flash_fwd

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    # (B, Tq, Tk, H, D, dtype, causal)
    cases = [(4, 1024, 1024, 12, 64, dt, causal)
             for causal in (True, False)
             for dt in (torch.bfloat16, torch.float16, torch.float32)]
    # The train steps' (GPT-2's, moe_small's), in both of their types.
    cases += [(8, 1024, 1024, 12, 64, dt, True) for dt in (torch.bfloat16, torch.float32)]
    cases += [(4, 2048, 2048, 12, 64, dt, True) for dt in (torch.bfloat16, torch.float32)]
    cases.append((1, 2048, 2048, 32, 128, torch.bfloat16, True))
    # Ragged edges (T not a multiple of the kernel's 64-row tiles), the
    # remaining type/head_dim instantiations, and a causal Tq < Tk case,
    # at small shapes.
    cases += [(2, 100, 100, 12, 64, torch.bfloat16, True),
              (2, 100, 100, 12, 64, torch.float32, False),
              (1, 200, 200, 4, 128, torch.float32, True),
              (1, 200, 200, 4, 128, torch.float16, False),
              (2, 64, 200, 4, 64, torch.float32, True)]
    results = []
    repeated = False  # the fp32 run-to-run check is made once
    for b, tq, tk, h, d, dt, causal in cases:
        # q/k/v as the model makes them: strided views of one fused
        # [B, T, H, 3D] projection (k and v of a [B, Tk, H, 2D] one where
        # Tk differs).
        qkv = torch.randn((b, tq, h, 3 * d), generator=gen, device="cuda",
                          dtype=torch.float32).to(dt)
        q, k, v = qkv.split(d, dim=-1)
        if tk != tq:
            k, v = torch.randn((b, tk, h, 2 * d), generator=gen,
                               device="cuda").to(dt).split(d, dim=-1)
        o, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        ro, rlse = flash_forward_plain(q, k, v, causal=causal, block_k=256)
        if dt == torch.float32 and not repeated:
            # No atomics and a fixed merge order: a second launch of the
            # fp32 kernel gives the same bits.
            o2, lse2 = flash_fwd(q, k, v, causal=causal, return_lse=True)
            repeated = torch.equal(o, o2) and torch.equal(lse, lse2)
            _check(repeated, f"two launches of the fp32 forward kernel differ at "
                             f"{[b, tq, tk, h, d]} causal={causal}")
            print(f"[kernels] flash_fwd fp32 {[b, tq, tk, h, d]} causal={causal}: "
                  f"two launches bitwise equal")
            del o2, lse2
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
        bound_ms, bound_by = _attention_bound_ms(b, tq, tk, h, d, dt, causal, card)
        row = {"shape": [b, tq, tk, h, d], "dtype": str(dt).split(".")[-1],
               "causal": causal, "max_abs_err": err_o,
               "max_abs_err_lse": err_lse, "ms": ms,
               "bound_share": bound_ms / ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        print("[kernels] flash_fwd " + json.dumps(row))
        _check(math.isfinite(err_o) and err_o <= tol_o,
               f"flash_fwd O error {err_o} > {tol_o} at {row['shape']} {dt}")
        _check(math.isfinite(err_lse) and err_lse <= tol_lse,
               f"flash_fwd LSE error {err_lse} > {tol_lse} at {row['shape']} {dt}")
        results.append(row)
    return results


# Tolerances of the backward kernels against their plain version. A
# gradient [B, T, H, D] is cut into tiles of 64 rows (the kernels' tile)
# per batch and head; per type (rtol, atol, tile):
#     |got - ref| <= rtol * |ref| + atol * rms(ref over its tile)
# for every element, and ||got - ref|| <= tile * ||ref|| over every tile.
# The scale is the tile's, not the tensor's: under the causal mask the
# first keys' dK and dV are many times the typical value.
#  rtol: both sides round an f32 result to the output type, so an
#        element may differ by an ulp of its value: 2^-7 of it (bf16),
#        2^-10 (fp16); fp32 sums in another order (64- or 16-row tiles in
#        the kernels, 256-row blocks and matmuls in the plain version)
#        and takes each product in 3xTF32 (hi.lo + lo.hi + hi.hi of the
#        TF32 halves of each operand), which drops ~2^-22 of each term:
#        the order of fp32's own rounding. TF32 alone (hi.hi) misses the
#        tile limit more than tenfold (tests/test_torch_fp32_split.py).
#  atol, tile: the tensor cores take p and dS rounded to the input type
#        where the plain version forms dV and dK from f32 p and dS; each
#        term of those sums moves by up to half an ulp, an error that
#        scales with the terms, not with the sum's value.
#  Both are set at 2-3x the largest readings on an H100 over these
#  cases and five seeds. A 1% error in half of dV, or dQ missing one
#  key tile in half of its rows, fails them.
_BWD_TOL = {torch.float32: (2.0 ** -20, 2.0 ** -14, 2.0 ** -19),
            torch.bfloat16: (2.0 ** -7, 2.0 ** -4, 2.0 ** -7),
            torch.float16: (2.0 ** -10, 2.0 ** -7, 2.0 ** -10)}
_BWD_TILE = 64


def _tiles(x):
    """[B, T, H, D] as [B, H, ceil(T/64), 64*D] in f32, T padded with zeros."""
    b, t, h, d = x.shape
    x = torch.nn.functional.pad(x.float().transpose(1, 2), (0, 0, 0, -t % _BWD_TILE))
    return x.reshape(b, h, -1, _BWD_TILE * d)


def _grad_error(got, ref, dt) -> dict:
    """A kernel's gradient against its plain version: the largest
    |error|; the largest element error as a share of what _BWD_TOL allows
    it (at most 1 to pass) and the largest tile error ||got - ref|| /
    ||ref|| (at most the tile limit); beside them the median |ref|, the
    median tile rms of ref, and what the element limit allows at both."""
    rtol, atol, _ = _BWD_TOL[dt]
    g, r = _tiles(got), _tiles(ref)
    count = _tiles(torch.ones_like(ref[:1, :, :1])).sum(-1, keepdim=True)
    diff = (g - r).abs()
    ref_norm = r.norm(dim=-1, keepdim=True)
    rms = ref_norm / count.sqrt()
    allowed = (rtol * r.abs() + atol * rms).clamp_min(1e-30)
    tile_err = diff.norm(dim=-1, keepdim=True) / ref_norm.clamp_min(1e-30)
    median_ref, median_rms = ref.float().abs().median().item(), rms.median().item()
    return {"max_abs_err": diff.max().item(),
            "worst_share": (diff / allowed).max().item(),
            "max_tile_err": tile_err.max().item(),
            "median_abs_ref": median_ref, "median_tile_rms": median_rms,
            "allowed_at_medians": rtol * median_ref + atol * median_rms}


def _grad_within(e: dict, dt) -> bool:
    """Whether a _grad_error reading meets _BWD_TOL."""
    return (math.isfinite(e["max_abs_err"]) and e["worst_share"] <= 1.0
            and e["max_tile_err"] <= _BWD_TOL[dt][2])


def phase_kernels_bwd(card: str):
    from ray_tpu_torch.ops._kernels import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from ray_tpu_torch.ops.attention import flash_backward_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    # (B, Tq, Tk, H, D, dtype, causal): the training shape of GPT-2 124M
    # in every type, moe_small's in both of its types, a long head_dim-128
    # shape, ragged T of 100 and 200 in both head dims, and a causal
    # Tq < Tk case whose last key tiles meet no query; the last two shapes
    # in fp32 too (the fp32 dK/dV pass's zero store for such a tile, and
    # its head_dim-128 inner tiles under causal masks).
    cases = [(8, 1024, 1024, 12, 64, dt, causal)
             for causal in (True, False)
             for dt in (torch.bfloat16, torch.float16, torch.float32)]
    cases += [(4, 2048, 2048, 12, 64, dt, True) for dt in (torch.bfloat16, torch.float32)]
    cases += [(1, 2048, 2048, 32, 128, torch.bfloat16, True),
              (2, 100, 100, 12, 64, torch.bfloat16, True),
              (1, 100, 100, 4, 128, torch.float32, False),
              (2, 200, 200, 4, 64, torch.float16, False),
              (1, 200, 200, 4, 128, torch.float16, True),
              (2, 64, 200, 4, 64, torch.bfloat16, True),
              (1, 200, 200, 4, 128, torch.float32, True),
              (2, 64, 200, 4, 64, torch.float32, True)]
    results = []
    repeated = False  # the fp32 run-to-run check is made once
    for b, tq, tk, h, d, dt, causal in cases:
        # q as the model makes it (a strided view of the fused projection),
        # k and v strided views of one [B, Tk, H, 2D] tensor.
        q = torch.randn((b, tq, h, 3 * d), generator=gen, device="cuda").to(dt)[..., :d]
        k, v = torch.randn((b, tk, h, 2 * d), generator=gen,
                           device="cuda").to(dt).split(d, dim=-1)
        do = torch.randn((b, tq, h, d), generator=gen, device="cuda").to(dt)
        o, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(lse.shape).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
        blocks = dict(block_q=min(256, tq), block_k=min(256, tk))
        if tq % blocks["block_q"] or tk % blocks["block_k"]:
            blocks = dict(block_q=tq, block_k=tk)
        plain = flash_backward_plain(q, k, v, o, lse, do, causal=causal, **blocks)
        if dt == torch.float32 and not repeated:
            # The two-pass split has no atomics: a second launch of each
            # fp32 kernel gives the same bits.
            again = (flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
                     *flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
            repeated = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
            _check(repeated, f"two launches of the fp32 backward kernels differ at "
                             f"{[b, tq, tk, h, d]} causal={causal}")
            print(f"[kernels] flash_bwd fp32 {[b, tq, tk, h, d]} causal={causal}: "
                  f"two launches bitwise equal")
            del again
        torch.cuda.synchronize()
        errs = {name: _grad_error(got, ref, dt)
                for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain)}
        ms_dq = _time_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
                         flush=flush)
        ms_dkv = _time_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal),
                          flush=flush)
        plain_ms = _time_ms(lambda: flash_backward_plain(q, k, v, o, lse, do, causal=causal,
                                                         **blocks), iters=5, flush=flush)
        # The library's gradient for the same dO: SDPA's backward alone,
        # run again and again from one forward's saved graph.
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
        library_ms = _time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), flush=flush)
        del out
        row = {"shape": [b, tq, tk, h, d], "dtype": str(dt).split(".")[-1],
               "causal": causal, "errors": errs,
               "tol": dict(zip(("rtol", "atol", "norm"), _BWD_TOL[dt])),
               "ms_dq": ms_dq, "ms_dkv": ms_dkv, "plain_ms": plain_ms,
               "library_ms": library_ms}
        for name, is_dq in (("dq", True), ("dkv", False)):
            row[f"bound_ms_{name}"], row[f"bound_by_{name}"] = _attention_bwd_bound_ms(
                b, tq, tk, h, d, dt, causal, card, dq=is_dq)
            row[f"bound_share_{name}"] = row[f"bound_ms_{name}"] / row[f"ms_{name}"]
        print("[kernels] flash_bwd " + json.dumps(row))
        for name, e in errs.items():
            _check(_grad_within(e, dt),
                   f"flash_bwd {name} outside its tolerance at {row['shape']} "
                   f"{dt} causal={causal}: {e}")
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


def _is_f32_gemm(name: str) -> bool:
    """Whether a kernel is one of the f32 (FMA, not TF32) GEMMs that
    torch's products launch on an H100: cuBLAS's xmma ``f32f32_f32f32``
    and CUTLASS's SIMT ``sgemm`` kernels."""
    return "gemm" in name and ("gemm_f32f32_f32f32" in name or "sgemm" in name)


def _profile(fn, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler: wall time, the device
    time its kernels took (sum of self device times), the kernels that
    took the most, this repo's flash kernels whatever their rank, and
    the device time and calls of all f32 GEMM kernels together."""
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
    f32_gemm = [(ms, cnt) for n, ms, cnt in rows if _is_f32_gemm(n)]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"name": n[:80], "ms": ms, "calls": cnt}
                    for n, ms, cnt in rows[:top]],
            "flash": [{"name": n[:80], "ms": ms, "calls": cnt}
                      for n, ms, cnt in rows if "flash_" in n],
            "f32_gemm": {"ms": sum(ms for ms, _ in f32_gemm),
                         "calls": sum(cnt for _, cnt in f32_gemm),
                         "kernels": len(f32_gemm)}}


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


def phase_serve(shared: dict):
    """Phase 4; keeps in ``shared`` what phase 8 holds its engines
    against: the engine's params, prompts and tokens."""
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
    shared["serve"] = {"params": eng.params, "prompts": prompts, "model": c, "row": row,
                       "tokens": [done[f"r{i}"].token_ids
                                  for i in range(len(prompts))]}
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


# The flash gradients in fp32 against the reference path's: the two
# differ only in the order of the attention's sums (64-row tiles in the
# kernels, one masked softmax in the reference), carried through 12
# layers, so each leaf agrees to 1e-3 of its largest |gradient|.
_TRAIN_GRAD_TOL = 1e-3


def phase_train(shared: dict):
    """Phase 5; keeps in ``shared`` what phase 7 holds its sharded step
    against: the fp32 step's loss and gradients (on the host) and the bf16
    steps' median host time."""
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.models.transformer import loss_and_grads
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.optim import FusedClipAdamW

    B, T, n_steps = 8, 1024, 6
    # bench.py's GPT-2 124M training configuration, with the flash kernels.
    cfg = models.gpt2_small(max_seq_len=T, remat=False, loss_chunk=4096,
                            ce_impl="fused", ce_accuracy=False,
                            attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    kernels = (_kernels.flash_fwd, _kernels.flash_bwd_dq, _kernels.flash_bwd_dkv)

    def counts():
        return [k.launches for k in kernels]

    # fp32: one step's loss and gradients, flash against reference.
    params = models.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg, device="cuda")
    f32 = dataclasses.replace(cfg, dtype="float32")
    before = counts()
    metrics_f, grads_f = loss_and_grads(params, batch, f32)
    _check([a - b for a, b in zip(counts(), before)] == [cfg.n_layers] * 3,
           f"fp32 step launched {[a - b for a, b in zip(counts(), before)]} "
           f"(fwd, dq, dkv), expected {cfg.n_layers} each")
    metrics_r, grads_r = loss_and_grads(
        params, batch, dataclasses.replace(f32, attn_impl="reference"))
    loss_f, loss_r = metrics_f["loss"], metrics_r["loss"]
    worst = 0.0  # the largest max|Δg| / max|g| over the leaves
    for gf, gr in zip(grads_f, grads_r):
        _check(bool(gf.isfinite().all()), "fp32 flash gradient is not finite")
        rel = ((gf - gr).abs().max() / gr.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
    loss_err = abs(loss_f.item() - loss_r.item())
    _check(loss_err <= 1e-4 * abs(loss_r.item()),
           f"fp32 flash loss {loss_f.item()} vs reference {loss_r.item()}")
    _check(worst <= _TRAIN_GRAD_TOL,
           f"fp32 flash gradients differ from reference: worst leaf "
           f"{worst} > {_TRAIN_GRAD_TOL} of its max |g|")
    shared["gpt2_fp32"] = (loss_f.item(), [g.cpu() for g in grads_f])
    del grads_f, grads_r, params

    # bf16: n_steps steps of the train step.
    opt = FusedClipAdamW(learning_rate=3e-4, weight_decay=0.1, clip_norm=1.0)
    state = models.init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                    cfg, opt, device="cuda")
    step = models.make_train_step(cfg, opt)
    losses, norms, step_ms = [], [], []
    for _ in range(n_steps):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())  # a device-to-host sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(metrics["grad_norm"].item())
        per_step = [a - b for a, b in zip(counts(), before)]
        _check(per_step == [cfg.n_layers] * 3,
               f"a bf16 step launched {per_step} (fwd, dq, dkv), expected "
               f"{cfg.n_layers} each")
    _check(all(math.isfinite(x) for x in losses + norms),
           f"non-finite loss or grad_norm: {losses} {norms}")
    _check(losses[-1] < losses[0], f"bf16 loss did not fall: {losses}")
    median_ms = statistics.median(step_ms[1:])  # the first step warms up
    shared["gpt2_bf16_step_ms_median"] = median_ms
    row = {"batch": B, "seq": T, "fp32_loss_flash": loss_f.item(),
           "fp32_loss_abs_err": loss_err,
           "fp32_worst_leaf_grad_err_share": worst,
           "bf16_losses": losses, "bf16_grad_norms": norms,
           "bf16_step_ms": step_ms, "bf16_step_ms_median": median_ms,
           "bf16_tokens_per_s": B * T / (median_ms / 1e3),
           "launches_per_step": cfg.n_layers}
    print("[train] " + json.dumps(row))
    holder = {"state": state}

    def one_step():
        holder["state"], m = step(holder["state"], batch)
        m["loss"].item()

    print("[train] profile bf16 step " + json.dumps(_profile(one_step, top=10)))
    return row


# The MoE layer on the card against the same function on the CPU, in f32:
# only the order of the sums differs (no TF32: main() turns it off), so
# every tensor agrees to 1e-4 of its largest |value| once the routing is
# the same.
_MOE_LAYER_TOL = 1e-4
# The optax-style steps against FusedClipAdamW's: the same update, up to
# the f32 rounding of its last operations. Step 1 starts from the same
# parameters: its loss and grad norm agree to 1e-6 and it routes every
# token alike. Losses agree to 1e-3 over 3 bf16 steps; grad norms to 1e-3
# over 3 steps in f32 compute. The bf16 grad norms part by more than
# 1e-3 at step 3 (PERF.md); they are printed beside the tokens each step
# routes differently in the two runs, not held to a limit.
_OPTAX_STEP_TOL = 1e-3
_SAME_STEP_TOL = 1e-6


def _routing_mismatches(kept_a, kept_b) -> int:
    """Tokens whose set of kept experts differs between two routings
    (bool [..., g, E] each, on any devices)."""
    return int((kept_a.cpu() != kept_b.cpu()).any(-1).sum())


def _moe_layer(x, router_w, w_gate, w_up, w_down, dout, top_k):
    """moe_swiglu under autograd on the inputs' device: (the experts
    keeping each token [n, g, E], out, aux, the gradients of x, router_w,
    w_gate, w_up, w_down for loss = sum(out * dout) + aux)."""
    from ray_tpu_torch.ops import moe

    leaves = [t.detach().requires_grad_() for t in (x, router_w, w_gate, w_up, w_down)]
    with torch.no_grad():
        kept = moe.route(x, router_w, top_k=top_k)[1].sum(-1) > 0
    out, aux = moe.moe_swiglu(*leaves, top_k=top_k)
    grads = torch.autograd.grad((out * dout).sum() + aux, leaves)
    return kept, out.detach(), aux.detach(), grads


def _model_routing(params, inputs, cfg, mesh=None):
    """The experts keeping each token in every MoE layer of one forward
    of the model (no gradient; sharded over ``mesh`` if one is given): one
    bool [n, g, E] per layer, taken from each layer's own moe_swiglu
    inputs."""
    from ray_tpu_torch import models
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops import moe

    kept, moe_swiglu = [], transformer.moe_swiglu

    def spy(x, router_w, *weights, top_k, capacity_factor, **kw):
        group = {k: v for k, v in kw.items() if k == "group_size"}
        kept.append(moe.route(x, router_w, top_k=top_k, capacity_factor=capacity_factor,
                              **group)[1].sum(-1) > 0)
        return moe_swiglu(x, router_w, *weights, top_k=top_k,
                          capacity_factor=capacity_factor, **kw)

    transformer.moe_swiglu = spy
    try:
        with torch.no_grad():
            models.forward(params, inputs, cfg, mesh=mesh)
    finally:
        transformer.moe_swiglu = moe_swiglu
    return kept


def phase_moe(card: str):
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.ops import _kernels, moe, optim

    cfg = models.moe_small(max_seq_len=2048, remat=False, loss_chunk=4096,
                           ce_impl="fused", ce_accuracy=False, attn_impl="flash")
    E, k = cfg.n_experts, cfg.expert_top_k

    # One MoE layer, f32, on the card against the CPU.
    gen = torch.Generator().manual_seed(0)
    D, F = cfg.d_model, cfg.ffn_dim
    inputs = (torch.randn((8, 1024, D), generator=gen),
              torch.randn((D, E), generator=gen) * 0.02,
              torch.randn((E, D, F), generator=gen) * 0.02,
              torch.randn((E, D, F), generator=gen) * 0.02,
              torch.randn((E, F, D), generator=gen) * 0.02 / math.sqrt(2 * cfg.n_layers),
              torch.randn((8, 1024, D), generator=gen))
    kept_cpu, *ref = _moe_layer(*inputs, top_k=k)
    kept_gpu, *got = _moe_layer(*(t.cuda() for t in inputs), top_k=k)
    rerouted = _routing_mismatches(kept_gpu, kept_cpu)
    _check(rerouted == 0, f"the MoE layer routed {rerouted} tokens differently on "
                          f"the card than on the CPU")
    names = ("out", "aux", "d_x", "d_router", "d_w_gate", "d_w_up", "d_w_down")
    ref = ref[:2] + list(ref[2])
    got = got[:2] + list(got[2])
    layer_err = {}
    for name, a, b in zip(names, got, ref):
        layer_err[name] = ((a.cpu() - b).abs().max() / b.abs().max()).item()
        _check(math.isfinite(layer_err[name]) and layer_err[name] <= _MOE_LAYER_TOL,
               f"MoE layer {name} on the card differs from the CPU by "
               f"{layer_err[name]} of its max |value|")
    print("[moe] layer " + json.dumps({
        "x": [8, 1024, D], "experts": E, "top_k": k, "tokens": 8 * 1024,
        "tokens_rerouted": rerouted, "kept_slots": int(kept_cpu.sum()),
        "max_err_share": layer_err}))
    del inputs, ref, got

    kernels = (_kernels.flash_fwd, _kernels.flash_bwd_dq, _kernels.flash_bwd_dkv)

    def counts():
        return [kk.launches for kk in kernels]

    B, T = 4, 2048
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1),
                           generator=torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    batch = {"tokens": tokens}

    def train(opt, n_steps, cfg=cfg, routings=None):
        """n_steps of make_train_step from the seed-0 state; the state, the
        step and each step's (loss, grad_norm, router_aux, ms). A list
        ``routings`` gets, before each step, the routing that step's
        parameters give the batch (outside the step and its counts)."""
        state = models.init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                        cfg, opt, device="cuda")
        step = models.make_train_step(cfg, opt)
        rows = []
        for _ in range(n_steps):
            if routings is not None:
                routings.append(_model_routing(state["params"], tokens[:, :-1], cfg))
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = m["loss"].item()  # a device-to-host sync
            ms = (time.perf_counter() - t0) * 1e3
            rows.append((loss, m["grad_norm"].item(), m["router_aux"].item(), ms))
            per_step = [a - b for a, b in zip(counts(), before)]
            _check(per_step == [cfg.n_layers] * 3,
                   f"a moe_small step launched {per_step} (fwd, dq, dkv), expected "
                   f"{cfg.n_layers} each")
        return state, step, rows

    torch.cuda.reset_peak_memory_stats()
    fused = optim.FusedClipAdamW(learning_rate=3e-4, weight_decay=0.1, clip_norm=1.0)
    state, step, rows = train(fused, 6)
    peak = torch.cuda.max_memory_allocated()
    losses, norms, auxes, step_ms = (list(col) for col in zip(*rows))
    _check(all(math.isfinite(x) for x in losses + norms + auxes),
           f"non-finite loss, grad_norm or router_aux: {rows}")
    _check(losses[-1] < losses[0], f"moe_small loss did not fall: {losses}")
    _check(all(1.0 <= a <= E for a in auxes), f"router_aux outside [1, {E}]: {auxes}")
    median_ms = statistics.median(step_ms[1:])  # the first step warms up
    holder = {"state": state}
    del state

    def one_step():
        holder["state"], m = step(holder["state"], batch)
        m["loss"].item()

    # The f32 GEMM kernels of the step are the dispatch and combine
    # einsums (5 products a layer: 2 forward, 3 backward) and the router's
    # (tiny beside them); their bound is the dispatch/combine work alone:
    # 5 products of 2·n·g·(E·C)·D operations a layer at the f32 peak.
    prof = _profile(one_step, top=10)
    del holder
    g = moe._group_size(B * T, 1024)
    c = moe.expert_capacity(g, E, k, cfg.expert_capacity_factor)
    dc_bound = (cfg.n_layers * 5 * 2 * B * T * E * c * D
                / _peaks(card)[1][torch.float32] * 1e3)
    row = {"batch": B, "seq": T, "params": cfg.num_params(), "losses": losses,
           "grad_norms": norms, "router_aux": auxes, "step_ms": step_ms,
           "step_ms_median": median_ms, "tokens_per_s": B * T / (median_ms / 1e3),
           "peak_memory_bytes": peak, "launches_per_step": cfg.n_layers,
           "f32_gemm_ms": prof["f32_gemm"]["ms"],
           "f32_gemm_share_of_step_device_time":
               prof["f32_gemm"]["ms"] / prof["device_ms"],
           "dispatch_combine_bound_ms": dc_bound,
           "dispatch_combine_bound_share": dc_bound / prof["f32_gemm"]["ms"]}
    print("[moe] train " + json.dumps(row))
    print("[moe] profile bf16 step " + json.dumps(prof))

    # The optax-style path against FusedClipAdamW from the same seed: the
    # same update, through optimizer.update; 3 steps of each in bf16, then
    # in f32 compute. Before each step, the tokens routed differently in
    # the two runs, summed over the layers.
    def chain():
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(3e-4, weight_decay=0.1))

    def rel(a, b):
        return abs(a - b) / abs(b)

    def compare(c):
        routings = ([], [])
        rows_a = train(fused, 3, c, routings[0])[2]
        rows_b = train(chain(), 3, c, routings[1])[2]
        rerouted = [sum(_routing_mismatches(a, b) for a, b in zip(*per_step))
                    for per_step in zip(*routings)]
        _check(rerouted[0] == 0 and rel(rows_b[0][0], rows_a[0][0]) <= _SAME_STEP_TOL
               and rel(rows_b[0][1], rows_a[0][1]) <= _SAME_STEP_TOL,
               f"the first {c.dtype} optax-style step differs from FusedClipAdamW's: "
               f"{rows_b[0]} vs {rows_a[0]}, {rerouted[0]} tokens rerouted")
        return {"losses": [[r[0] for r in rows] for rows in (rows_a, rows_b)],
                "grad_norms": [[r[1] for r in rows] for rows in (rows_a, rows_b)],
                "step_ms": [[r[3] for r in rows] for rows in (rows_a, rows_b)],
                "loss_rel_diff": [rel(b[0], a[0]) for a, b in zip(rows_a, rows_b)],
                "grad_norm_rel_diff": [rel(b[1], a[1]) for a, b in zip(rows_a, rows_b)],
                "tokens_rerouted": rerouted,
                "token_layer_pairs": B * T * cfg.n_layers}

    optax_row = {"bf16": compare(cfg),
                 "f32": compare(dataclasses.replace(cfg, dtype="float32"))}
    print("[moe] optax-style (FusedClipAdamW, chain) " + json.dumps(optax_row))
    _check(all(d <= _OPTAX_STEP_TOL for d in optax_row["bf16"]["loss_rel_diff"]),
           f"bf16 optax-style losses differ from FusedClipAdamW's: {optax_row['bf16']}")
    _check(all(d <= _OPTAX_STEP_TOL for key in ("loss_rel_diff", "grad_norm_rel_diff")
               for d in optax_row["f32"][key]),
           f"f32 optax-style steps differ from FusedClipAdamW's: {optax_row['f32']}")
    return row


# Phase 7's limits. (a) The sharded step at world size 1 against phase 5's
# unsharded one: the same products on the same shards, so each gradient
# leaf agrees to 1e-6 of its largest |value| (bitwise equality is
# expected and printed). (b) moe_small with its experts split over two
# ranks against the unsharded step: no token routed differently, and the
# loss and every gradient within 1e-4 of its largest |value| (the layer's
# limit in phase 6: the sums run in another order).
_WORLD1_TOL = 1e-6
_EXPERT2_TOL = 1e-4
# What part (b) runs on one card: two ranks over gloo, which takes CUDA
# tensors for some collectives only. On torch 2.11.0+cu128 (the card's;
# tests/gloo_cuda_report.py) it takes all_reduce (DTensor's Partial ->
# Replicate) and all_gather_into_tensor, but the functional
# all_gather_tensor behind DTensor's Shard -> Replicate ends both ranks
# (SIGSEGV), and batch_isend_irecv fails. tensor=2 gathers the
# vocab-sharded embedding and head, fsdp=2 every weight, by that
# all-gather: both are shown on the CPU only (tests/test_torch_parallel.py).
# expert=2 needs all_reduce and all_gather_into_tensor alone (ExpertShard's
# gather of the experts' outputs and the backward of its split), so it runs
# here.


def _moe_reference(cfg, B, T):
    """The unsharded (world size 1) fp32 step of moe_small at B x T from the
    seed-0 params: (loss, gradients, the experts keeping each token per
    layer)."""
    from ray_tpu_torch import models
    from ray_tpu_torch.models.transformer import loss_and_grads

    params = models.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1),
                           generator=torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    kept = _model_routing(params, tokens[:, :-1], cfg)
    metrics, grads = loss_and_grads(params, {"tokens": tokens}, cfg)
    return metrics["loss"], grads, kept


def _local_slice(full, placements, coordinate):
    """The shard of ``full`` a rank at ``coordinate`` holds under
    ``placements`` (Shard or Replicate per mesh dim)."""
    from torch.distributed.tensor import Shard

    for p, (index, size) in zip(placements, coordinate):
        if isinstance(p, Shard):
            full = full.chunk(size, dim=p.dim)[index]
    return full


def _expert2_rank(rank, world, cfg_kw, B, T, ref_loss, ref_grads, ref_kept):
    """Part (b), one of two ranks sharing card 0 over gloo: moe_small's fp32
    step with its experts split over the ranks (mesh ("expert",) of 2).
    Returns the tokens routed differently from the reference, per gradient
    leaf the largest |difference| on this rank's shard, the loss, the
    step's host time and this rank's kernel launches and copies."""
    from ray_tpu_torch import models
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.tree import tree_leaves
    from ray_tpu_torch.parallel import MeshConfig, shard_params

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = models.moe_small(**cfg_kw)
    mesh = MeshConfig(data=1, expert=world).build("cuda")
    params, _ = shard_params(
        models.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda"),
        mesh, transformer.partition_specs(cfg))
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1),
                           generator=torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    kept = _model_routing(params, tokens[:, :-1], cfg, mesh=mesh)
    rerouted = sum(_routing_mismatches(a, b) for a, b in zip(kept, ref_kept))
    wrappers = [getattr(_kernels, name) for name in _COPYING]
    for w in wrappers:
        w.launches = w.launches_fp32 = w.copies = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, grads = transformer.loss_and_grads(params, {"tokens": tokens}, cfg, mesh=mesh)
    loss = metrics["loss"].item()
    step_ms = (time.perf_counter() - t0) * 1e3
    coordinate = [(mesh.get_local_rank(d), mesh.size(d)) for d in range(mesh.ndim)]
    max_diff = []
    for g, ref, p in zip(grads, ref_grads, tree_leaves(params)):
        local = g.to_local()
        ref = _local_slice(ref, p.placements, coordinate)
        max_diff.append(0.0 if ref.numel() == 0 else (local - ref).abs().max().item())
    return {"layers": len(kept), "rerouted": rerouted, "loss": loss,
            "loss_diff": abs(loss - ref_loss), "max_diff": max_diff, "step_ms": step_ms,
            "launches": _launch_counts(), "copies": {w.__name__: w.copies for w in wrappers}}


def _worst_leaf_share(max_diffs, ref_max) -> float:
    """The largest max|got - ref| / max|ref| over a tree's leaves, given
    each leaf's largest |difference| and largest |reference value|."""
    return max((d / max(m, 1e-30) for d, m in zip(max_diffs, ref_max)), default=0.0)


def _add_counts(total: dict, counts: dict) -> dict:
    """``total``'s kernel launches and input copies plus ``counts``' (a
    rank's, or a path's: {"launches": {kernel: n}, "copies": {wrapper:
    n}})."""
    return {key: {k: n + counts[key].get(k, 0) for k, n in total[key].items()}
            for key in ("launches", "copies")}


def phase_parallel(shared: dict):
    """Phase 7: the sharded paths (ray_tpu_torch.parallel). Returns the
    kernel launches and input copies that part (b)'s ranks counted."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch import models
    from ray_tpu_torch.models.transformer import loss_and_grads, partition_specs
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.optim import FusedClipAdamW
    from ray_tpu_torch.parallel import MeshConfig, _spawn, shard_params

    # (a) World size 1 on NCCL: phase 5's GPT-2 124M steps through the mesh.
    B, T = 8, 1024
    cfg = models.gpt2_small(max_seq_len=T, remat=False, loss_chunk=4096,
                            ce_impl="fused", ce_accuracy=False, attn_impl="flash")
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1),
                           generator=torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    batch = {"tokens": tokens}
    kernels = (_kernels.flash_fwd, _kernels.flash_bwd_dq, _kernels.flash_bwd_dkv)

    def counts():
        return [k.launches for k in kernels]

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = MeshConfig().build()
            params, _ = shard_params(
                models.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                   device="cuda"), mesh, partition_specs(cfg))
            f32 = dataclasses.replace(cfg, dtype="float32")
            before = counts()
            metrics, grads = loss_and_grads(params, batch, f32, mesh=mesh)
            per_step = [a - b for a, b in zip(counts(), before)]
            _check(per_step == [cfg.n_layers] * 3,
                   f"the sharded fp32 step launched {per_step} (fwd, dq, dkv), expected "
                   f"{cfg.n_layers} each")
            ref_loss, ref_grads = shared["gpt2_fp32"]
            grads = [g.to_local().cpu() for g in grads]
            worst = _worst_leaf_share([(g - r).abs().max().item() for g, r in
                                       zip(grads, ref_grads)],
                                      [r.abs().max().item() for r in ref_grads])
            bitwise = metrics["loss"].item() == ref_loss and all(
                torch.equal(g, r) for g, r in zip(grads, ref_grads))
            _check(worst <= _WORLD1_TOL,
                   f"the sharded fp32 step's gradients differ from phase 5's by {worst} "
                   f"of a leaf's max |g| (limit {_WORLD1_TOL})")
            del grads, params, shared["gpt2_fp32"]

            opt = FusedClipAdamW(learning_rate=3e-4, weight_decay=0.1, clip_norm=1.0)
            params, _ = shard_params(
                models.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                   device="cuda"), mesh, partition_specs(cfg))
            state = {"params": params, "opt_state": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32, device="cuda")}
            step = models.make_train_step(cfg, opt, mesh=mesh)
            losses, step_ms = [], []
            for _ in range(6):
                before = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(m["loss"].item())  # a device-to-host sync
                step_ms.append((time.perf_counter() - t0) * 1e3)
                per_step = [a - b for a, b in zip(counts(), before)]
                _check(per_step == [cfg.n_layers] * 3,
                       f"a sharded bf16 step launched {per_step} (fwd, dq, dkv), expected "
                       f"{cfg.n_layers} each")
            _check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                   f"the sharded bf16 loss did not fall: {losses}")
            del state, params
        finally:
            dist.destroy_process_group()
    median_ms = statistics.median(step_ms[1:])
    print("[parallel] world1 " + json.dumps({
        "mesh": {"data": 1}, "backend": "nccl", "batch": B, "seq": T,
        "fp32_loss": metrics["loss"].item(), "fp32_loss_phase5": ref_loss,
        "fp32_worst_leaf_grad_err_share": worst, "fp32_bitwise_equal_to_phase5": bitwise,
        "bf16_losses": losses, "bf16_step_ms": step_ms,
        "bf16_step_ms_median": median_ms,
        "bf16_step_ms_median_unsharded_phase5": shared["gpt2_bf16_step_ms_median"],
        "launches_per_step": cfg.n_layers}))

    # (b) World size 2 on this one card, over gloo: expert=2. The kernels
    # were built in phase 1; the ranks load them.
    extra = {"launches": dict.fromkeys(_KERNELS, 0), "copies": dict.fromkeys(_COPYING, 0)}
    B, T = 4, 2048
    cfg_kw = dict(max_seq_len=T, remat=False, loss_chunk=4096, ce_impl="fused",
                  ce_accuracy=False, attn_impl="flash", dtype="float32")
    moe_cfg = models.moe_small(**cfg_kw)
    torch.cuda.empty_cache()
    ref_loss, ref_grads, ref_kept = _moe_reference(moe_cfg, B, T)
    ref_loss = ref_loss.item()
    ref_max = [g.abs().max().item() for g in ref_grads]
    ranks = _spawn.run(_expert2_rank, 2, cfg_kw, B, T, ref_loss, ref_grads, ref_kept,
                       timeout=600)
    del ref_grads, ref_kept
    torch.cuda.ipc_collect()  # the ranks read the reference through CUDA IPC
    rerouted = sum(r["rerouted"] for r in ranks)
    worst = _worst_leaf_share([max(d) for d in zip(*(r["max_diff"] for r in ranks))],
                              ref_max)
    loss_share = max(r["loss_diff"] for r in ranks) / abs(ref_loss)
    for r in ranks:
        extra = _add_counts(extra, r)
    print("[parallel] world2 expert2 " + json.dumps({
        "mesh": {"expert": 2}, "backend": "gloo", "ranks_on_one_card": 2,
        "batch": B, "seq": T, "dtype": "float32", "layers_routed": ranks[0]["layers"],
        "tokens_rerouted": rerouted, "loss": ref_loss,
        "loss_err_share": loss_share, "worst_leaf_grad_err_share": worst,
        "step_ms_correctness_run": [r["step_ms"] for r in ranks],
        "launches": [r["launches"] for r in ranks]}))
    _check(all(r["layers"] == moe_cfg.n_layers for r in ranks),
           f"a rank routed {[r['layers'] for r in ranks]} layers, expected "
           f"{moe_cfg.n_layers}")
    _check(rerouted == 0, f"expert=2 routed {rerouted} tokens differently than the "
                          f"unsharded step")
    _check(loss_share <= _EXPERT2_TOL and worst <= _EXPERT2_TOL,
           f"expert=2 differs from the unsharded step: loss {loss_share}, worst leaf "
           f"{worst} of its max (limit {_EXPERT2_TOL})")
    return extra


# Phase 8 (llm): the single-device LLM plane on GPT-2 124M (phase 4's
# params). Paths that run programs of other shapes than the dense greedy
# engine's (prefix hits and chunks through prefill_at, speculative
# windows through verify, LoRA through its gathered deltas) part from it
# at bf16 near-ties without any fault, so they run in f32 compute, as the
# CPU tests do; paged decode has the dense step's shapes after the table
# gather and runs in bf16.


def _first_difference(got, ref):
    """The index of the first token where ``got`` and ``ref`` part (or
    where the shorter ends), or None when they are equal."""
    if got == ref:
        return None
    return next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                min(len(got), len(ref)))


def _margin_at(params, cfg, prompt, ref, i):
    """The top-2 logit margin of the model at ``ref``'s token ``i``."""
    from ray_tpu_torch import models

    seq = torch.tensor([list(prompt) + list(ref[:i])],
                       device=params["embed"]["tokens"].device)
    return _top2_margins(models.forward(params, seq, cfg)[0, -1]).item()


def _check_same_tokens(what, params, cfg, prompts, got, ref):
    """Each request's tokens equal the reference's; at a difference the
    top-2 margin there is printed before the check fails."""
    for i, (prompt, g, r) in enumerate(zip(prompts, got, ref)):
        at = _first_difference(g, r)
        if at is not None:
            print(f"[llm] {what}: request {i} parts at token {at}, top-2 "
                  f"margin there {_margin_at(params, cfg, prompt, r, at)}")
        _check(at is None, f"{what}: request {i} differs from its reference "
               f"at token {at}: {g} vs {r}")


def _merged_lora(params, adapter, scale):
    """``params`` with a LoRA adapter ({target: (A [L, d, r], B [L, r,
    out])}) merged into its attention projections: W + scale * A @ B per
    layer (wo's input is the flattened heads)."""
    attn = dict(params["layers"]["attn"])
    for t, (a, b) in adapter.items():
        w = attn[t]
        delta = torch.einsum("ldr,lro->ldo", a.to(w), b.to(w)) * scale
        attn[t] = w + delta.reshape(w.shape)
    return {**params, "layers": {**params["layers"], "attn": attn}}


def _json_prefix_ok(text) -> bool:
    """Whether every prefix of ``text`` is a prefix of some JSON value
    (the guided engine's contract): the automaton accepts it whole."""
    from ray_tpu_torch.llm.guided import JsonState

    return JsonState().feed_text(text)


def _save_npz(params, path):
    """``params`` as a flat .npz of dotted keys, the format LLMConfig's
    checkpoint paths take."""
    import numpy as np

    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v.float().cpu().numpy()

    walk(params, "")
    np.savez(path, **flat)
    return path


def _serve(eng, prompts, sps):
    """Queue the prompts (one SamplingParams each, or one for all) and
    step the engine to completion. Returns the outputs in prompt order
    and the run's times: wall, TTFT median and max, and decode tokens/s
    (the tokens after each request's first, from the first request's
    first token to the end). ``backoffs`` counts the steps whose
    admission left a slot free while requests waited (the page pool
    refused them)."""
    if not isinstance(sps, (list, tuple)):
        sps = [sps] * len(prompts)
    ids = [f"r{i}" for i in range(len(prompts))]
    for rid, p, sp in zip(ids, prompts, sps):
        eng.add_request(rid, p, sp)
    reqs = list(eng.waiting)
    done, backoffs = {}, 0
    t0 = time.time()  # the engine stamps requests with time.time()
    while eng.has_unfinished():
        free = [i for i, s in enumerate(eng.slots) if s is None]
        for out in eng.step():
            done[out.request_id] = out
        backoffs += bool(eng.waiting) and any(eng.slots[i] is None for i in free)
    t_end = time.time()
    outs = [done[r] for r in ids]
    ttft = [r.t_first - r.t_add for r in reqs]
    t_first = min(r.t_first for r in reqs)
    return outs, {"wall_s": t_end - t0, "ttft_s_median": statistics.median(ttft),
                  "ttft_s_max": max(ttft), "backoffs": backoffs,
                  "decode_tokens_per_s": sum(len(o.token_ids) - 1 for o in outs)
                  / max(t_end - t_first, 1e-9)}


def phase_llm(shared: dict):
    """Phase 8 (llm): the single-device LLM plane on GPT-2 124M with
    phase 4's params, held against phase 4's tokens (bf16) or the dense
    f32 engine's (see the note above _first_difference)."""
    import dataclasses
    import os
    import tempfile

    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm import kv_pages, model_runner
    from ray_tpu_torch.llm.guided import validate_schema
    from ray_tpu_torch.llm.tokenizer import load_tokenizer

    t_phase = time.perf_counter()
    params, prompts, ref16 = (shared["serve"][k]
                              for k in ("params", "prompts", "tokens"))
    cfg = models.gpt2_small()
    f32 = dataclasses.replace(cfg, dtype="float32")
    base = dict(max_num_seqs=8, max_seq_len=1024, tokenizer="byte")

    def engine(c=cfg, p=params, **kw):
        return LLMEngine(LLMConfig(model=c, **{**base, **kw}), p, device="cuda")

    def greedy(n, **kw):
        return SamplingParams(max_tokens=n, ignore_eos=True, **kw)

    tok = load_tokenizer("byte")
    enc = [tok.encode(p) for p in prompts]
    n_new, n16 = 32, 16
    row = {}

    # (a) Paged KV, bf16: the dense-equivalent pool, half of it, and a
    # pool that cannot hold all eight at their peak (admission backs off).
    need = sum(-(-(len(t) + n_new - 1) // 16) for t in enc)
    for name, pages in (("full", 0), ("half", 8 * 64 // 2 + 1),
                        ("tight", need - 16)):
        torch.cuda.reset_peak_memory_stats()
        eng = engine(kv_page_size=16, kv_num_pages=pages)
        outs, times = _serve(eng, prompts, greedy(n_new))
        _check_same_tokens(f"paged ({name} pool)", params, cfg, enc,
                           [o.token_ids for o in outs], ref16)
        _check(eng.kv_alloc.num_in_use == 0, f"paged ({name}) leaked pages")
        _check(name != "tight" or times["backoffs"] > 0,
               "the tight pool never held a request back")
        row[f"paged_{name}"] = {
            **times, "kv_stats": eng.kv_stats(),
            "pool_bytes": sum(t.numel() * t.element_size()
                              for t in eng.cache.values()),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        del eng
    row["dense_cache_bytes"] = (2 * cfg.n_layers * 8 * 1024 * cfg.kv_heads
                                * cfg.head_dim * 2)
    print("[llm] paged " + json.dumps(row))

    # The paged decode step beside the dense one, all 8 slots at position
    # 300 (the rows they read are whatever the caches hold).
    full = engine(kv_page_size=16)
    dense_cache = model_runner.init_slot_cache(cfg, 8, 1024, device="cuda")
    last = torch.zeros(8, dtype=torch.long, device="cuda")
    pos = torch.full((8,), 300, device="cuda")
    temps = torch.zeros(8, device="cuda")
    tables = torch.arange(1, 8 * 64 + 1, device="cuda").reshape(8, 64)
    steps = {
        "paged": _profile(lambda: kv_pages.paged_decode(
            params, last, pos, tables, full.cache, temps, full._rng, config=cfg),
            top=60),
        "dense": _profile(lambda: model_runner.decode(
            params, last, pos, dense_cache, temps, full._rng, config=cfg),
            top=60)}
    # The row writes run as index kernels, the table gather as a gather.
    row["decode_step"] = {k: {
        "wall_ms": v["wall_ms"], "device_ms": v["device_ms"],
        "index_and_gather_kernels": [t for t in v["top"] if any(
            w in t["name"].lower() for w in ("index", "gather"))]}
        for k, v in steps.items()}
    print("[llm] profile decode step " + json.dumps(row["decode_step"]))
    del full, dense_cache

    # The f32 reference: the dense engine, whole-prompt prefill.
    ref_eng = engine(f32)

    def ref32(ps, n):
        return [o.token_ids for o in _serve(ref_eng, ps, greedy(n))[0]]

    # (b) Prefix caching (f32), dense and paged: eight requests sharing a
    # 512-token prefix with distinct 16-64-token tails, in two waves.
    words = "every request of this wave shares one long prefix of tokens. "
    prefix = (words * 10)[:511]  # 512 tokens with BOS
    wave = [prefix + (f" tail {i}: " + "abcdefgh"[i] * 64)[:16 + 6 * i]
            for i in range(8)]
    want = ref32(wave, n16)
    row["prefix"] = {}
    for name, kw in (("dense", {}), ("paged", dict(kv_page_size=16))):
        eng = engine(f32, enable_prefix_caching=True, **kw)
        _serve(eng, wave, greedy(n16))
        outs, times = _serve(eng, wave, greedy(n16))
        _check_same_tokens(f"prefix cache ({name}), wave 2", params, f32,
                           [tok.encode(w) for w in wave],
                           [o.token_ids for o in outs], want)
        _check(eng.prefix_cache_hits > 0, f"prefix cache ({name}): no hits")
        row["prefix"][name] = {"kv_stats": eng.kv_stats(), "wave2": times}
        del eng

    # (c) Chunked prefill (f32), dense and paged, against whole prompts.
    long_prompts = [(words * 20)[:n] for n in (300, 611, 899)]
    want = ref32(long_prompts, n16)
    for name, kw in (("dense", {}), ("paged", dict(kv_page_size=16))):
        eng = engine(f32, prefill_chunk=128, **kw)
        outs, _ = _serve(eng, long_prompts, greedy(n16))
        _check_same_tokens(f"chunked prefill ({name})", params, f32,
                           [tok.encode(p) for p in long_prompts],
                           [o.token_ids for o in outs], want)
        del eng

    # (d) Speculative decoding (f32): the target's own weights from an
    # .npz (every proposal accepted), and a random 2-layer draft.
    want = ref32(prompts, n_new)
    shared["llm_f32"] = {"prompts": prompts, "tokens": want}  # for phase 10
    row["speculative"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        npz = _save_npz(params, os.path.join(tmp, "target.npz"))
        for name, kw in (("self", dict(speculative_model=f32,
                                       speculative_checkpoint_path=npz)),
                         ("2-layer", dict(speculative_model=dataclasses.replace(
                             f32, n_layers=2)))):
            eng = engine(f32, num_speculative_tokens=4, **kw)
            outs, times = _serve(eng, prompts, greedy(n_new))
            _check_same_tokens(f"speculative ({name} draft)", params, f32, enc,
                               [o.token_ids for o in outs], want)
            st = eng.spec_stats
            _check(st["spec_steps"] > 0, f"speculative ({name}): no spec steps")
            _check(name != "self" or st["accepted"] == st["proposed"],
                   f"speculative (self draft) rejected proposals: {st}")
            row["speculative"][name] = {
                **st, "acceptance": st["accepted"] / max(1, st["proposed"]),
                **times}
            del eng

    # (e) LoRA (f32): a random rank-8 adapter on wq/wk/wv/wo at alpha 16;
    # four adapter requests beside four base requests.
    g = torch.Generator().manual_seed(8)
    hdh = cfg.n_heads * cfg.head_dim
    dims = {"wq": (cfg.d_model, hdh), "wk": (cfg.d_model, hdh),
            "wv": (cfg.d_model, hdh), "wo": (hdh, cfg.d_model)}
    adapter = {t: (torch.randn((cfg.n_layers, i, 8), generator=g) * 0.05,
                   torch.randn((cfg.n_layers, 8, o), generator=g) * 0.05)
               for t, (i, o) in dims.items()}
    eng = engine(f32, lora={"max_adapters": 2, "max_rank": 8})
    eng.add_lora("a", {t: (a.numpy(), b.numpy()) for t, (a, b) in adapter.items()},
                 alpha=16.0)
    outs, _ = _serve(eng, prompts, [greedy(n_new, extra={"lora": "a"} if i % 2
                                           else {}) for i in range(8)])
    got = [o.token_ids for o in outs]
    _check_same_tokens("LoRA base requests", params, f32, enc[0::2], got[0::2],
                       want[0::2])
    merged = _merged_lora(params, {t: (a.cuda(), b.cuda())
                                   for t, (a, b) in adapter.items()}, 16.0 / 8)
    want_a = [o.token_ids for o in
              _serve(engine(f32, p=merged), prompts[1::2], greedy(n_new))[0]]
    _check_same_tokens("LoRA adapter requests", merged, f32, enc[1::2],
                       got[1::2], want_a)
    _check(eng.remove_lora("a") and eng.list_loras() == [], "remove_lora failed")
    row["lora_adapter_requests_unlike_base"] = sum(
        a != b for a, b in zip(got[1::2], want[1::2]))
    del eng, merged

    # (f) Extended sampling (f32): a seeded request alone and in a full
    # batch; a greedy request's logprobs against log_softmax.
    seeded = greedy(n_new, temperature=0.8, top_k=50, top_p=0.9, min_p=0.02,
                    presence_penalty=0.3, frequency_penalty=0.2,
                    repetition_penalty=1.1, logit_bias=((101, 2.0), (32, -1.0)),
                    logprobs=5, seed=1234)
    alone = _serve(ref_eng, prompts[:1], seeded)[0][0]
    batch = _serve(ref_eng, prompts, [seeded] + [
        greedy(n_new, temperature=1.0, seed=s) for s in range(7)])[0][0]
    _check(batch.token_ids == alone.token_ids,
           f"the seeded request differs in a full batch: {batch.token_ids} vs "
           f"{alone.token_ids}")
    _check([len(e["top"]) for e in alone.logprobs] == [5] * n_new,
           "the seeded request's logprobs are not 5 per token")
    out = _serve(ref_eng, prompts[:1], greedy(n_new, logprobs=5))[0][0]
    seq = torch.tensor([enc[0] + out.token_ids[:-1]], device="cuda")
    logp = torch.log_softmax(models.forward(params, seq, f32)[0, len(enc[0]) - 1:], -1)
    ref_lp = logp[torch.arange(n_new), torch.tensor(out.token_ids)].cpu()
    lp_err = (torch.tensor([e["logprob"] for e in out.logprobs]) - ref_lp).abs().max()
    _check(lp_err.item() <= 1e-4, f"greedy logprobs differ from log_softmax by {lp_err}")
    row["greedy_logprob_max_abs_err"] = lp_err.item()
    del ref_eng

    # (g) Guided decoding: a json_object and a json_schema request.
    schema = {"type": "object"}
    outs, _ = _serve(engine(max_num_seqs=2), ["Answer in JSON: ", "An object: "], [
        SamplingParams(max_tokens=64, response_format={"type": "json_object"}),
        SamplingParams(max_tokens=64, temperature=0.7, seed=5, response_format={
            "type": "json_schema", "json_schema": {"schema": schema}})])
    row["guided"] = []
    for o in outs:
        _check(_json_prefix_ok(o.text), f"guided output leaves JSON: {o.text!r}")
        if o.finish_reason == "stop":
            _check(o.error is None
                   and validate_schema(json.loads(o.text), schema) is None,
                   f"finished guided output {o.text!r} fails: {o.error}")
        row["guided"].append({"finish_reason": o.finish_reason, "error": o.error,
                              "tokens": len(o.token_ids), "text": o.text[:60]})
    row["phase_s"] = time.perf_counter() - t_phase
    print("[llm] " + json.dumps({k: v for k, v in row.items()
                                 if not k.startswith("paged_")}))
    return row


# Phase 9 (train_backend): the Train backend (ray_tpu_torch.train) driving
# a user's data-parallel loop, as tests/test_train.py:53-93 writes one:
# sync_model_params, autograd gradients, allreduce_gradients, then the
# optimizer. (a) World size 1 on NCCL, the group set up by
# TorchBackend.on_worker_setup: a checkpoint saved at step 3 and restored
# into a fresh state gives steps 4-6 bit for bit. (b) Two ranks on this
# card over gloo, each with half of the batch: their averaged fp32
# gradients against one rank's of the whole batch. The same products; the
# sums over the batch run in another order, so each leaf agrees to 1e-4
# of its largest |value| (phase 6's and phase 7's limit for sums in
# another order).
_DP2_TOL = 1e-4


def _gpt2_train_config(**kw):
    """bench.py's GPT-2 124M training configuration, with the flash kernels."""
    from ray_tpu_torch import models

    return models.gpt2_small(max_seq_len=1024, remat=False, loss_chunk=4096,
                             ce_impl="fused", ce_accuracy=False, attn_impl="flash", **kw)


def _step_batches(cfg, n, B, T, device="cuda"):
    """``n`` batches of B x (T + 1) tokens, batch i from seed 100 + i."""
    return [{"tokens": torch.randint(
        0, cfg.vocab_size, (B, T + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(100 + i))} for i in range(n)]


def _dp_opt(lr: float = 3e-4):
    """Phase 9's optimizer: FusedClipAdamW at bench.py's settings (phase
    19's trials change the learning rate)."""
    from ray_tpu_torch.ops.optim import FusedClipAdamW

    return FusedClipAdamW(learning_rate=lr, weight_decay=0.1, clip_norm=1.0)


def _dp_fresh(cfg, opt, seed, device):
    """Parameters from ``seed`` (a generator on ``device``) and their
    optimizer state."""
    from ray_tpu_torch import models

    params = models.init_params(torch.Generator(device=device).manual_seed(seed), cfg,
                                device=device)
    return params, opt.init(params)


def _dp_steps(params, opt_state, opt, batches, cfg):
    """A user's data-parallel steps: the loss's gradients by autograd
    (models.loss_and_grads), averaged over the session's ranks, then the
    optimizer. Returns (params, opt_state, losses, host ms per step)."""
    from ray_tpu_torch.models.transformer import loss_and_grads
    from ray_tpu_torch.ops.tree import tree_unflatten
    from ray_tpu_torch.train import torch_utils

    losses, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        metrics, grads = loss_and_grads(params, batch, cfg)
        grads = torch_utils.allreduce_gradients(tree_unflatten(params, grads))
        params, opt_state, _ = opt.apply(grads, opt_state, params)
        losses.append(metrics["loss"].item())  # a device-to-host sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return params, opt_state, losses, step_ms


def _resume_check(cfg, opt, batches, fresh, root):
    """Part (a)'s loop in a session of world size 1: steps 1-3 from
    ``fresh(0)``'s state, a checkpoint registered with a CheckpointManager
    under ``root``, steps 4-6; then ``fresh(1)``'s state restored from the
    checkpoint and steps 4-6 again. Returns (losses of steps 1-6, the
    restored run's losses, whether its losses and final state equal the
    uninterrupted run's bit for bit, the host ms of steps 1-6, the
    checkpoint's directory name, seconds to save, seconds to load)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.ops.tree import tree_leaves
    from ray_tpu_torch.train import torch_utils

    params, opt_state = fresh(0)
    params = torch_utils.sync_model_params(params)
    params, opt_state, losses, step_ms = _dp_steps(params, opt_state, opt, batches[:3], cfg)
    manager = train.CheckpointManager(root, num_to_keep=1, score_attribute="loss",
                                      score_order="min")
    staged = train.make_temp_checkpoint_dir()
    t0 = time.perf_counter()
    train.Checkpoint(staged).save_pytree({"params": params, "opt_state": opt_state})
    saved = manager.register(staged, {"loss": losses[-1], "step": 3})
    save_s = time.perf_counter() - t0
    params, opt_state, more, ms = _dp_steps(params, opt_state, opt, batches[3:], cfg)
    p2, s2 = fresh(1)
    t0 = time.perf_counter()
    restored = manager.latest.load_pytree({"params": p2, "opt_state": s2})
    load_s = time.perf_counter() - t0
    p2, s2, again, _ = _dp_steps(restored["params"], restored["opt_state"], opt,
                                 batches[3:], cfg)
    bitwise = again == more and all(
        torch.equal(a, b) for a, b in zip(tree_leaves({"params": params, "opt_state": opt_state}),
                                          tree_leaves({"params": p2, "opt_state": s2})))
    return (losses + more, again, bitwise, step_ms + ms, saved.path.split("/")[-1],
            save_s, load_s)


def _dp2_rank(rank, world, B, ref_grads):
    """Part (b), one of two ranks sharing card 0 over gloo: rank 0's
    params synced, this rank's half of the batch, the gradients averaged.
    Returns per leaf the largest |difference| from the whole batch's
    gradients, the loss of its half, and its kernel launches and copies."""
    from ray_tpu_torch import models
    from ray_tpu_torch.models.transformer import loss_and_grads
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.tree import tree_leaves, tree_unflatten
    from ray_tpu_torch.train import torch_utils
    from ray_tpu_torch.train.session import TrainSession, set_session

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    set_session(TrainSession(rank, world, rank, experiment_name="chip_smoke_dp2"))
    cfg = _gpt2_train_config(dtype="float32")
    params = models.init_params(torch.Generator(device="cuda").manual_seed(rank), cfg,
                                device="cuda")
    # Each rank starts from its own seed; the sync gives all rank 0's.
    params = torch_utils.sync_model_params(params)
    tokens = _step_batches(cfg, 1, B, 1024)[0]["tokens"]
    half = tokens[rank * B // world:(rank + 1) * B // world]
    wrappers = [getattr(_kernels, name) for name in _COPYING]
    for w in wrappers:
        w.launches = w.launches_fp32 = w.copies = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, grads = loss_and_grads(params, {"tokens": half}, cfg)
    grads = torch_utils.allreduce_gradients(tree_unflatten(params, grads))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    max_diff = [(g - r).abs().max().item() for g, r in zip(tree_leaves(grads), ref_grads)]
    set_session(None)
    return {"loss": metrics["loss"].item(), "max_diff": max_diff, "step_ms": step_ms,
            "launches": _launch_counts(), "copies": {w.__name__: w.copies for w in wrappers}}


def phase_train_backend(shared: dict):
    """Phase 9: the Train backend. Returns the kernel launches and input
    copies that part (b)'s ranks counted."""
    import os
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch import models, train
    from ray_tpu_torch.models.transformer import loss_and_grads
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import _spawn
    from ray_tpu_torch.train.session import TrainSession, set_session

    B, T = 8, 1024
    cfg = _gpt2_train_config()
    opt = _dp_opt()
    batches = _step_batches(cfg, 6, B, T)
    kernels = (_kernels.flash_fwd, _kernels.flash_bwd_dq, _kernels.flash_bwd_dkv)

    def fresh(seed):
        return _dp_fresh(cfg, opt, seed, "cuda")

    # (a) World size 1 on NCCL, set up by the backend.
    row = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train.TorchBackend().on_worker_setup(0, 1, "chip_smoke", train.TorchConfig(
            distributed="on", coordinator_address=f"file://{tmp}/store", timeout_s=300))
        row["setup_s"] = time.perf_counter() - t0
        _check(dist.is_initialized() and dist.get_backend() == "nccl",
               "on_worker_setup did not start an NCCL group")
        set_session(TrainSession(0, 1, 0, experiment_name="chip_smoke"))
        try:
            before = [k.launches for k in kernels]
            (losses, again, bitwise, step_ms, saved, row["save_s"],
             row["load_s"]) = _resume_check(cfg, opt, batches, fresh, os.path.join(tmp, "runs"))
            launched = [k.launches - b for k, b in zip(kernels, before)]
        finally:
            set_session(None)
            dist.destroy_process_group()
    row.update({"backend": "nccl", "world_size": 1, "batch": B, "seq": T,
                "losses": losses, "restored_losses_4_6": again,
                "restored_steps_bitwise_equal": bitwise, "checkpoint": saved,
                "step_ms": step_ms, "step_ms_median": statistics.median(step_ms[1:]),
                "step_ms_median_phase5": shared.get("gpt2_bf16_step_ms_median"),
                "launches": launched})
    print("[train_backend] world1 " + json.dumps(row))
    _check(all(math.isfinite(x) for x in losses + again),
           f"the data-parallel loop's losses are not finite: {losses} {again}")
    _check(launched == [9 * cfg.n_layers] * 3,
           f"9 bf16 steps launched {launched} (fwd, dq, dkv), expected "
           f"{9 * cfg.n_layers} each")
    _check(bitwise, f"steps 4-6 from the checkpoint differ from the uninterrupted run: "
                    f"{again} vs {losses[3:]}")
    # Phase 15's trainer runs this loop on a worker: its steps must give
    # these losses.
    shared["train_backend"] = {"losses": losses,
                               "step_ms_median": row["step_ms_median"]}

    # (b) Two gloo ranks on this card, half of the batch each, in fp32.
    f32 = _gpt2_train_config(dtype="float32")
    params = models.init_params(torch.Generator(device="cuda").manual_seed(0), f32,
                                device="cuda")
    _, ref_grads = loss_and_grads(params, batches[0], f32)
    ref_max = [g.abs().max().item() for g in ref_grads]
    del params
    ranks = _spawn.run(_dp2_rank, 2, B, ref_grads, timeout=600)
    del ref_grads
    torch.cuda.ipc_collect()  # the ranks read the reference through CUDA IPC
    worst = _worst_leaf_share([max(d) for d in zip(*(r["max_diff"] for r in ranks))],
                              ref_max)
    extra = {"launches": dict.fromkeys(_KERNELS, 0), "copies": dict.fromkeys(_COPYING, 0)}
    for r in ranks:
        extra = _add_counts(extra, r)
    print("[train_backend] world2 " + json.dumps({
        "backend": "gloo", "ranks_on_one_card": 2, "batch_per_rank": B // 2, "seq": T,
        "dtype": "float32", "rank_losses": [r["loss"] for r in ranks],
        "worst_leaf_grad_err_share": worst, "limit": _DP2_TOL,
        "step_ms_correctness_run": [r["step_ms"] for r in ranks],
        "launches": [r["launches"] for r in ranks]}))
    _check(worst <= _DP2_TOL, f"two ranks' averaged gradients differ from the whole "
                              f"batch's by {worst} of a leaf's max (limit {_DP2_TOL})")
    return extra


# Phase 10 (llm_parallel): tensor- and pipeline-parallel serving of GPT-2
# 124M (phase 4's params, f32 compute) on two gloo ranks of this card,
# against the dense f32 engine's tokens for phase 8's prompts. tensor=2
# needs all_reduce and all_gather_into_tensor, which gloo takes on CUDA
# tensors (tests/gloo_cuda_report.py); the pipeline's stage hop is
# batch_isend_irecv, which gloo refused on CUDA tensors on torch
# 2.11.0+cu128, so the pipeline runs only if the transport takes it, and
# its error is printed otherwise.
_PP_TRANSPORT = ("batch_isend_irecv", "_exchange")


def _transport_failures(errors) -> bool:
    """Whether every error a pipeline rank reported comes from the stage
    hop's transport: raised in it, or a rank it ended or left waiting
    (``_spawn``'s "died" and TimeoutError). Anything else is a fault."""
    return all(any(w in e for w in _PP_TRANSPORT + ("died", "TimeoutError"))
               for e in errors)


def _serving_rank(rank, world, params, prompts, n_new, option):
    """One rank of a tensor- or pipeline-parallel engine on card 0: its
    tokens for ``prompts``, its cache's shape, and (tensor) one decode
    step's wall and device time with the 8 slots at position 300. A
    failure comes back as its traceback."""
    import dataclasses
    import traceback

    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(models.gpt2_small(), dtype="float32")
    try:
        eng = LLMEngine(LLMConfig(model=f32, max_num_seqs=8, max_seq_len=1024,
                                  tokenizer="byte", **{option: 2}), params, device="cuda")
        with torch.inference_mode():
            outs, times = _serve(eng, prompts, SamplingParams(max_tokens=n_new,
                                                              ignore_eos=True))
            out = {"tokens": [o.token_ids for o in outs], "times": times,
                   "cache_k": list(eng.cache["k"].shape)}
            if option == "tensor_parallel_size":
                last = torch.zeros(8, dtype=torch.long, device="cuda")
                pos = torch.full((8,), 300, device="cuda")
                temps = torch.zeros(8, device="cuda")
                out["decode_step"] = _profile(lambda: eng._mr.decode(
                    eng.params, last, pos, eng.cache, temps, eng._rng, config=f32))
            return out
    except Exception:  # noqa: BLE001 - reported and judged by the phase
        return {"error": traceback.format_exc()}


def phase_llm_parallel(shared: dict):
    """Phase 10: tensor_parallel_size=2, then pipeline_parallel_size=2,
    on two gloo ranks of this card."""
    import dataclasses

    from ray_tpu_torch import models
    from ray_tpu_torch.llm import model_runner
    from ray_tpu_torch.llm.tokenizer import load_tokenizer
    from ray_tpu_torch.ops.tree import tree_map
    from ray_tpu_torch.parallel import _spawn

    params = shared["serve"]["params"]
    # Plain copies for the ranks (phase 4 made these under inference_mode;
    # the ranks receive them by CUDA IPC).
    shared_params = tree_map(lambda t: t.clone(), params)
    prompts, want = shared["llm_f32"]["prompts"], shared["llm_f32"]["tokens"]
    n_new = len(want[0])
    f32 = dataclasses.replace(models.gpt2_small(), dtype="float32")
    enc = [load_tokenizer("byte").encode(p) for p in prompts]
    row = {}
    t0 = time.perf_counter()
    tp = _spawn.run(_serving_rank, 2, shared_params, prompts, n_new,
                    "tensor_parallel_size", timeout=600)
    row["tp_s"] = time.perf_counter() - t0
    for rank, r in enumerate(tp):
        _check("error" not in r, f"tensor=2 rank {rank} failed:\n{r.get('error')}")
        _check(r["cache_k"][3] == f32.kv_heads // 2,
               f"tensor=2 rank {rank}'s cache holds {r['cache_k'][3]} kv heads, expected "
               f"{f32.kv_heads // 2} of {f32.kv_heads}")
        _check_same_tokens(f"tensor=2 (rank {rank})", params, f32, enc, r["tokens"], want)
    last = torch.zeros(8, dtype=torch.long, device="cuda")
    pos = torch.full((8,), 300, device="cuda")
    temps = torch.zeros(8, device="cuda")
    dense_cache = model_runner.init_slot_cache(f32, 8, 1024, device="cuda")
    with torch.inference_mode():
        dense = _profile(lambda: model_runner.decode(params, last, pos, dense_cache, temps,
                                                     None, config=f32))
    del dense_cache

    def step(profile):
        return {k: profile[k] for k in ("wall_ms", "device_ms", "device_busy_share")}

    row["tensor2"] = {"backend": "gloo", "ranks_on_one_card": 2,
                      "cache_k_per_rank": tp[0]["cache_k"], "serve": tp[0]["times"],
                      "decode_step_per_rank": [step(r["decode_step"]) for r in tp],
                      "decode_step_dense_f32": step(dense),
                      "decode_step_rank0_top": tp[0]["decode_step"]["top"]}
    t0 = time.perf_counter()
    try:
        pp = _spawn.run(_serving_rank, 2, shared_params, prompts, n_new,
                        "pipeline_parallel_size", timeout=180)
    except (RuntimeError, TimeoutError) as e:  # a rank died or hung
        pp = [{"error": f"{type(e).__name__}: {e}"}] * 2
    row["pp_s"] = time.perf_counter() - t0
    errors = [r["error"] for r in pp if "error" in r]
    if errors:
        # Only the stage hop's transport may fail (an error in it, a rank
        # it ends, a hop that never completes); anything else is a fault.
        _check(_transport_failures(errors),
               f"pipeline=2 failed outside the stage hop:\n{errors[0]}")
        row["pipeline2"] = {"ran": False, "error": errors[0].strip().splitlines()[-1]}
    else:
        for rank, r in enumerate(pp):
            _check(r["cache_k"][0] == f32.n_layers // 2,
                   f"pipeline=2 rank {rank}'s cache holds {r['cache_k'][0]} layers")
            _check_same_tokens(f"pipeline=2 (rank {rank})", params, f32, enc,
                               r["tokens"], want)
        row["pipeline2"] = {"ran": True, "cache_k_per_rank": pp[0]["cache_k"],
                            "serve": pp[0]["times"]}
    del shared_params
    torch.cuda.ipc_collect()
    print("[llm_parallel] " + json.dumps(row))
    return row


# Phase 11 (async_llm): AsyncLLMEngine over phase 4's engine setup.
# Pre-queued, its eight callers hand their requests over before the
# driver thread first steps, so the eight are admitted in one go as phase
# 4's were: the same prefill programs, so bf16 gives phase 4's tokens, not
# a near-tie's other choice. Arriving, the callers come one every
# _ARRIVAL_S while the driver steps the others, and the phase reads how
# many steps each waited.
_ASYNC_WAIT_S = 300.0
_ARRIVAL_S = 0.05


def _check_arriving(arriving: dict, n_new: int) -> None:
    """An arriving caller's request is queued at the driver's next step
    after its hand-over, so it ends within n_new engine steps of the
    hand-over (the step under way counts). Steps before the hand-over
    (the caller reads the count, then generate() hands the request
    over) are not the engine's."""
    _check(max(arriving["steps_per_request"]) <= n_new,
           f"arriving callers waited to be admitted: "
           f"{arriving['steps_per_request']} steps from the hand-over for {n_new} "
           f"tokens (to the hand-over {arriving['steps_to_hand_over']}, to the "
           f"queue {arriving['steps_to_queue']})")


def phase_async_llm(shared: dict, device: str = "cuda"):
    """Phase 11: concurrent asyncio callers, a stream, deadlines (dense
    and paged) and a sync generate() beside the driver, on phase 4's
    model and params."""
    import asyncio

    from ray_tpu_torch.exceptions import TaskTimeoutError
    from ray_tpu_torch.llm import (AsyncLLMEngine, LLMConfig, LLMEngine, RequestOutput,
                                   SamplingParams)

    params, prompts, ref, model = (shared["serve"][k]
                                   for k in ("params", "prompts", "tokens", "model"))
    n_new = len(ref[0])
    sp = SamplingParams(max_tokens=n_new, ignore_eos=True)

    def engine(**kw):
        return LLMEngine(LLMConfig(model=model, max_num_seqs=8, max_seq_len=1024,
                                   tokenizer="byte", **kw), params, device=device)

    eng = engine()
    aeng = AsyncLLMEngine(eng)
    enc = [eng.tokenizer.encode(p) for p in prompts]
    row = {}

    # The engine step at which each request had its first token and its
    # last, as step() left them (the callers themselves see them later).
    first_at, done_at, real_step = {}, {}, eng.step

    def step():
        outs = real_step()
        n = eng._step_count
        for r in [r for r in eng.slots if r is not None and r.generated] + outs:
            first_at.setdefault(r.request_id, n)
        done_at.update((o.request_id, n) for o in outs)
        return outs

    eng.step = step

    # Where a request's steps went before its first: the engine's step
    # count when the caller handed it over (_submit) and when the stepping
    # thread queued it (_admit_inbox, under the engine lock).
    handed_at, queued_at = {}, {}
    real_submit, real_admit_inbox = aeng._submit, aeng._admit_inbox

    def submit(req, sink, deadline):
        handed_at[req.request_id] = eng._step_count
        real_submit(req, sink, deadline)

    def admit_inbox():
        real_admit_inbox()
        for r in eng.waiting:
            queued_at.setdefault(r.request_id, eng._step_count)

    aeng._submit, aeng._admit_inbox = submit, admit_inbox

    async def caller(prompt, delay=0.0):
        """One caller's request, streamed: its output, the seconds to its
        first token and to its end, the engine steps from its submission
        to its first token, to its hand-over and to its queueing, and
        from its hand-over to its last token."""
        if delay:
            await asyncio.sleep(delay)
        t_sub, s_sub = time.time(), eng._step_count
        agen = await aeng.generate(prompt, sp, stream=True)
        t_first = out = None
        async for item in agen:
            if t_first is None:
                t_first = time.time()
            out = item
        return {"out": out, "t_first": t_first, "t_end": time.time(),
                "ttft_s": t_first - t_sub,
                "steps_to_first": first_at[out.request_id] - s_sub,
                "steps": done_at[out.request_id] - handed_at[out.request_id],
                "steps_to_hand_over": handed_at[out.request_id] - s_sub,
                "steps_to_queue": queued_at[out.request_id] - s_sub}

    def summary(got):
        t0 = min(g["t_first"] - g["ttft_s"] for g in got)
        t_first, t_end = min(g["t_first"] for g in got), max(g["t_end"] for g in got)
        ttft = [g["ttft_s"] for g in got]
        return {"callers": len(got), "tokens_each": n_new,
                "ttft_s": ttft, "ttft_s_median": statistics.median(ttft),
                "ttft_s_max": max(ttft),
                "steps_to_first_token": [g["steps_to_first"] for g in got],
                "steps_per_request": [g["steps"] for g in got],
                "steps_to_hand_over": [g["steps_to_hand_over"] for g in got],
                "steps_to_queue": [g["steps_to_queue"] for g in got],
                "decode_tokens_per_s": sum(len(g["out"].token_ids) - 1 for g in got)
                / max(t_end - t_first, 1e-9),
                "wall_s": t_end - t0}

    async def prequeued():
        # Pre-queued: the callers hand their requests over while this
        # holds the engine lock, so the driver queues all eight at one
        # step and they decode as one batch, as phase 4's did.
        with aeng._lock:
            tasks = [asyncio.ensure_future(caller(t)) for t in enc]
            await asyncio.sleep(0)  # each caller runs until it awaits its stream
        return await asyncio.wait_for(asyncio.gather(*tasks), _ASYNC_WAIT_S)

    steps0 = eng._step_count
    got = asyncio.run(prequeued())
    steps = eng._step_count - steps0
    # Queued at one step, the eight take one prefill and n_new - 1 decode
    # steps together, as in phase 4.
    _check(steps == n_new - 1,
           f"the pre-queued requests were not admitted together ({steps} decode "
           f"steps for {n_new} tokens)")
    _check_same_tokens("async callers", params, model, enc,
                       [g["out"].token_ids for g in got], ref)
    serve = shared["serve"].get("row", {})
    row["prequeued"] = {**summary(got), "steps": steps, "equal_to_phase4": True,
                        "phase4_ttft_s_median": serve.get("ttft_s_median"),
                        "phase4_decode_tokens_per_s": serve.get("decode_tokens_per_s")}

    # Callers arriving while the driver steps the others, one every
    # _ARRIVAL_S: each is queued at the driver's next step, so it ends
    # within n_new steps of its submission (the step under way counts).
    async def arriving():
        return await asyncio.wait_for(asyncio.gather(
            *[caller(t, i * _ARRIVAL_S) for i, t in enumerate(enc)]), _ASYNC_WAIT_S)

    got = asyncio.run(arriving())
    row["arriving"] = {**summary(got), "arrival_every_s": _ARRIVAL_S,
                       "equal_to_phase4": sum(g["out"].token_ids == r
                                              for g, r in zip(got, ref))}
    lengths = [len(g["out"].token_ids) for g in got]
    _check(lengths == [n_new] * len(enc), f"arriving callers got {lengths} tokens")
    _check_arriving(row["arriving"], n_new)

    # One streamed request: its increments, joined, are its output.
    async def streamed():
        agen = await aeng.generate(enc[3], sp, stream=True)
        return [item async for item in agen]

    items = asyncio.run(asyncio.wait_for(streamed(), _ASYNC_WAIT_S))
    final = items[-1]
    _check(isinstance(final, RequestOutput) and items[:-1] == final.token_ids
           and len(final.token_ids) == n_new,
           f"the stream's increments {items[:-1]} are not its output")
    row["stream"] = {"increments": len(items) - 1}

    # Deadlines, on a paged engine: one already past (evicted before
    # admission) and one that passes mid-decode; both raise
    # TaskTimeoutError, and afterwards every slot and page is free.
    peng = engine(kv_page_size=16)
    paeng = AsyncLLMEngine(peng)

    async def deadlines():
        with_err = []
        try:
            await asyncio.wait_for(paeng.generate(enc[0], sp, deadline=time.time() - 1.0),
                                   _ASYNC_WAIT_S)
        except TaskTimeoutError as e:
            with_err.append(e.where)
        long_sp = SamplingParams(max_tokens=1000 - len(enc[1]), ignore_eos=True)
        agen = await paeng.generate(enc[1], long_sp, stream=True, deadline=time.time() + 1.0)
        got = 0
        try:
            async for item in agen:
                got += isinstance(item, int)
        except TaskTimeoutError as e:
            with_err.append(e.where)
        return with_err, got

    wheres, streamed_before = asyncio.run(asyncio.wait_for(deadlines(), _ASYNC_WAIT_S))
    snap = paeng.snapshot()
    row["deadline"] = {"raised_where": wheres, "tokens_before_eviction": streamed_before,
                       "snapshot": snap}
    _check(wheres == ["llm_decode", "llm_decode"],
           f"the expired requests raised {wheres}, not TaskTimeoutError twice")
    _check(streamed_before > 0, "the mid-decode request was evicted before decoding")
    _check(snap["evicted_deadline"] == 2 and snap["owned"] == 0 and snap["active"] == 0
           and peng.kv_alloc.num_in_use == 0,
           f"the evicted requests left slots or pages behind: {snap}")

    # A sync generate() while async requests are in flight: both finish.
    async def mixed():
        pending = [asyncio.ensure_future(aeng.generate(t, sp)) for t in enc[:4]]
        await asyncio.sleep(0.05)
        loop = asyncio.get_running_loop()
        sync_outs = await asyncio.wait_for(
            loop.run_in_executor(None, eng.generate, enc[4:], sp), _ASYNC_WAIT_S)
        return sync_outs, await asyncio.wait_for(asyncio.gather(*pending), _ASYNC_WAIT_S)

    sync_outs, async_outs = asyncio.run(mixed())
    lengths = [len(o.token_ids) for o in list(sync_outs) + list(async_outs)]
    _check(lengths == [n_new] * 8, f"sync and async requests sharing the engine gave {lengths}")
    row["sync_beside_async"] = {"finished": len(lengths), "snapshot": aeng.snapshot()}
    print("[async_llm] " + json.dumps(row))
    return row


# Phase 12 (rllib): environments written here from gymnasium's published
# equations (classic_control/cartpole.py and pendulum.py, the v1
# versions, with their time limits), so that nothing needs installing.
class _Discrete:
    def __init__(self, n):
        self.n = n


class _Box:
    def __init__(self, low, high):
        self.low, self.high = (np.asarray(low, np.float32), np.asarray(high, np.float32))
        self.shape = self.low.shape


class CartPole:
    """CartPole-v1: Euler steps of 0.02 s, +1 a step, terminated past
    12 degrees or 2.4 m, truncated at 500 steps."""

    gravity, masscart, masspole, length, force_mag, tau = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    theta_threshold, x_threshold, max_steps = 12 * 2 * math.pi / 360, 2.4, 500

    def __init__(self):
        self.observation_space = _Box([-4.8, -np.inf, -0.418, -np.inf],
                                      [4.8, np.inf, 0.418, np.inf])
        self.action_space = _Discrete(2)
        self._rng = np.random.default_rng()
        self.state = None

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(-0.05, 0.05, size=(4,))
        self.steps = 0
        return np.asarray(self.state, np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        total_mass = self.masspole + self.masscart
        polemass_length = self.masspole * self.length
        force = self.force_mag if int(action) == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * np.square(theta_dot) * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        self.steps += 1
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold or theta > self.theta_threshold)
        return (np.asarray(self.state, np.float32), 1.0, terminated,
                self.steps >= self.max_steps, {})

    def close(self):
        pass


class Pendulum:
    """Pendulum-v1: torque in [-2, 2], steps of 0.05 s, reward -(angle² +
    0.1·speed² + 0.001·torque²), truncated at 200 steps."""

    max_speed, max_torque, dt, g, m, l, max_steps = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0, 200

    def __init__(self):
        self.observation_space = _Box([-1.0, -1.0, -8.0], [1.0, 1.0, 8.0])
        self.action_space = _Box([-2.0], [2.0])
        self._rng = np.random.default_rng()
        self.state = None

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(low=[-math.pi, -1.0], high=[math.pi, 1.0])
        self.steps = 0
        return self._obs(), {}

    def _obs(self):
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], dtype=np.float32)

    def step(self, u):
        th, thdot = self.state
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        angle = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = angle ** 2 + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * self.g / (2 * self.l) * np.sin(th)
                            + 3.0 / (self.m * self.l ** 2) * u) * self.dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        self.state = np.array([th + newthdot * self.dt, newthdot])
        self.steps += 1
        return self._obs(), -costs, False, self.steps >= self.max_steps, {}

    def close(self):
        pass


# One learner update on the card against the same update on the CPU, from
# the same weights and batch: f32 products in another order on the two
# devices, so each leaf agrees to 1e-4 of its largest |value|.
_RL_DEVICE_TOL = 1e-4


def _timed_sampling(algo):
    """Wrap the runner group's sampling to add up its seconds and rows."""
    stats = {"s": 0.0, "rows": 0}
    group = algo.env_runner_group
    real = group.sample_batches

    def sample_batches(weights=None):
        t0 = time.perf_counter()
        out = real(weights)
        stats["s"] += time.perf_counter() - t0
        stats["rows"] += sum(len(b) for b in out)
        return out

    group.sample_batches = sample_batches
    return stats


def _update_ms(learner, batch, n: int = 5) -> float:
    """Median host ms of one learner update on ``batch`` (synchronised;
    the update ends by copying its metrics to the host)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        learner.update(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _finite(metrics: dict, keys) -> bool:
    return all(math.isfinite(metrics[k]) for k in keys)


def phase_rllib(shared: dict, device: str = "cuda", ppo_iters: int = 5):
    """Phase 12: RLlib's algorithms on the local runner and learner, every
    module and learner on ``device``."""
    import tempfile

    from ray_tpu_torch.ops.tree import flatten
    from ray_tpu_torch.rllib import (APPOConfig, BCConfig, CQLConfig, DQNConfig,
                                     IMPALAConfig, MARWILConfig, PPOConfig, SACConfig,
                                     SampleBatch, TorchLearner)
    from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss
    from ray_tpu_torch.rllib.core.learner import make_optimizer

    row = {"device": device}

    # PPO at its defaults: 8 envs, 64-step fragments, batch 512, 4 epochs
    # of 128-row minibatches, hidden (64, 64).
    cfg = PPOConfig().environment(CartPole).learners(device=device).debugging(seed=0)
    ppo = cfg.build()
    sampled = _timed_sampling(ppo)
    batches = []  # each iteration's train batch, advantages attached
    real_update = ppo.learner_group.update_epochs

    def update_epochs(batch, **kw):
        batches.append(batch)
        return real_update(batch, **kw)

    ppo.learner_group.update_epochs = update_epochs
    t0 = time.perf_counter()
    results = [ppo.train() for _ in range(ppo_iters)]
    wall = time.perf_counter() - t0
    keys = ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl", "grad_norm")
    _check(all(_finite(r, keys) for r in results), f"PPO's losses are not finite: {results}")
    row["ppo"] = {"iterations": ppo_iters, "total_loss": [r["total_loss"] for r in results],
                  "episode_return_mean": [r.get("episode_return_mean") for r in results],
                  "wall_s": wall, "sample_s": sampled["s"],
                  "env_steps_per_s_sampled": sampled["rows"] / sampled["s"],
                  "learn_s": wall - sampled["s"]}
    batch = SampleBatch(dict(batches[-1]))
    mb = batch.slice(0, cfg.minibatch_size)
    row["ppo"]["learner_update_ms"] = _update_ms(ppo.learner_group.local, mb)

    # One learner update on the device against the CPU, same weights, same
    # Adam state and the same minibatch.
    state = ppo.learner_group.get_state()
    spec = cfg.rl_module_spec()
    outs = {}
    for dev in (device, "cpu"):
        spec.device = dev
        learner = TorchLearner(spec.build(), make_ppo_loss(cfg), make_optimizer(cfg))
        learner.set_state(state)
        learner.update(SampleBatch(dict(mb)))
        outs[dev] = learner.get_weights()
    worst = max(float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-12))
                for g, c in zip(flatten(outs[device]).values(), flatten(outs["cpu"]).values()))
    row["ppo"]["update_vs_cpu_worst_leaf_share"] = worst
    _check(worst <= _RL_DEVICE_TOL, f"a PPO update on {device} differs from the CPU's by "
                                    f"{worst} of a leaf's max (limit {_RL_DEVICE_TOL})")

    # A checkpoint saved and restored: the next iteration's learning on the
    # same batch (same minibatch order) gives the same bits.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = ppo.save(tmp)
        restored = cfg.build()
        restored.restore(path)
        row["ppo"]["checkpoint_round_trip_s"] = time.perf_counter() - t0
    nxt = []
    for algo in (ppo, restored):
        algo.learner_group.update_epochs(SampleBatch(dict(batch)), num_epochs=cfg.num_epochs,
                                         minibatch_size=cfg.minibatch_size,
                                         rng=np.random.default_rng(1))
        nxt.append(flatten(algo.get_weights()))
    same = all(np.array_equal(nxt[0][k], nxt[1][k]) for k in nxt[0])
    row["ppo"]["restored_next_iteration_bitwise_equal"] = same
    _check(same and restored.iteration == ppo.iteration,
           "the restored PPO's next iteration differs from the original's")

    # DQN and SAC, a few iterations past learning_starts (512 env steps an
    # iteration: iterations 2-4 learn).
    dqn = (DQNConfig().environment(CartPole).training(learning_starts=1024)
           .learners(device=device).debugging(seed=1).build())
    sac = (SACConfig().environment(Pendulum).training(learning_starts=1024)
           .learners(device=device).debugging(seed=2).build())
    for name, algo, keys in (("dqn", dqn, ("qf_loss", "qf_mean", "grad_norm")),
                             ("sac", sac, ("critic_loss", "actor_loss", "alpha_loss",
                                           "grad_norm"))):
        t0 = time.perf_counter()
        res = [algo.train() for _ in range(4)]
        learned = [r for r in res if keys[0] in r]
        _check(len(learned) == 3 and all(_finite(r, keys) for r in learned),
               f"{name} did not learn with finite losses: {res}")
        mb = algo.buffer.sample(algo.algo_config.train_batch_size)
        mb["td_targets"] = np.zeros(len(mb), np.float32)
        if name == "sac":
            mb["noise_pi"] = np.zeros((len(mb), algo.algo_config.action_dim), np.float32)
        row[name] = {"iterations": 4, "learning_iterations": len(learned),
                     "env_steps": res[-1]["num_env_steps_sampled"],
                     "losses": [{k: r[k] for k in keys} for r in learned],
                     "wall_s": time.perf_counter() - t0,
                     "learner_update_ms": _update_ms(algo.learner_group.local, mb)}

    # BC and MARWIL on the PPO phase's batches, rows ordered by env and
    # time with each fragment's end marked truncated (MARWIL's returns run
    # along rows); CQL on SAC's transitions (its actions are continuous).
    frags = []
    for b in batches:
        order = np.lexsort((b["t"], b["env_id"]))
        frag = {k: b[k][order] for k in ("obs", "actions", "rewards", "terminateds",
                                         "truncateds")}
        frag["truncateds"] = frag["truncateds"] | (b["t"][order] == b["t"].max())
        frags.append(frag)
    offline = {k: np.concatenate([f[k] for f in frags]) for k in frags[0]}
    sac_data = dict(sac.buffer.sample(2048))
    for name, c, keys in (
            ("bc", BCConfig().offline(dict(offline)), ("bc_loss",)),
            ("marwil", MARWILConfig().offline(dict(offline)), ("policy_loss", "vf_loss")),
            ("cql", CQLConfig().offline(sac_data).training(
                bc_iters=16, action_low=np.array([-2.0], np.float32),
                action_high=np.array([2.0], np.float32)),
             ("critic_loss", "cql_penalty", "actor_loss"))):
        space = (dict(observation_dim=3, action_dim=1) if name == "cql"
                 else dict(observation_dim=4, action_dim=2))
        algo = c.environment(**space).learners(device=device).debugging(seed=3).build()
        t0 = time.perf_counter()
        res = [algo.train() for _ in range(3)]
        _check(all(_finite(r, keys) for r in res), f"{name}'s losses are not finite: {res}")
        row[name] = {"iterations": 3, "rows": len(algo._dataset),
                     "losses": [{k: r[k] for k in keys} for r in res],
                     "wall_s": time.perf_counter() - t0}

    # IMPALA and APPO: a learner update on one batch of their local runner.
    for name, c in (("impala", IMPALAConfig()), ("appo", APPOConfig())):
        algo = (c.environment(CartPole).env_runners(num_env_runners=0)
                .learners(device=device).debugging(seed=4).build())
        b = algo.env_runner_group.sample(algo.get_weights())
        res = algo.learner_group.local.update(b)
        _check(_finite(res, ("total_loss", "policy_loss", "vf_loss", "grad_norm")),
               f"{name}'s losses are not finite: {res}")
        row[name] = {"batch_rows": len(b), "losses": res,
                     "learner_update_ms": _update_ms(algo.learner_group.local, b)}
    print("[rllib] " + json.dumps(row))
    shared["rllib"] = row
    return row


# Phase 13 (rllib_more): the rest of RLlib that needs no runtime. The
# multi-agent environment has the shape of RLlib's own MultiAgentCartPole
# example: one CartPole-v1 (the class above) per agent, each stepped by its
# own agent's action; an agent whose pole is done stops acting, and the
# episode ends when both are done.
class TwoCartPoles:
    possible_agents = ["a0", "a1"]
    observation_dims = {"a0": 4, "a1": 4}
    action_dims = {"a0": 2, "a1": 2}

    def __init__(self):
        self.poles = {a: CartPole() for a in self.possible_agents}
        self.done = set()

    def reset(self, seed=None):
        self.done = set()
        return {a: pole.reset(seed=None if seed is None else seed + i)[0]
                for i, (a, pole) in enumerate(self.poles.items())}, {}

    def step(self, actions):
        obs, rew, term, trunc = {}, {}, {}, {}
        for a, act in actions.items():
            obs[a], rew[a], te, tr, _ = self.poles[a].step(act)
            if te:
                term[a] = True
            if tr:
                trunc[a] = True
            if te or tr:
                self.done.add(a)
        over = len(self.done) == len(self.poles)
        term["__all__"] = over and not trunc
        trunc["__all__"] = over and bool(trunc)
        return obs, rew, term, trunc, {}

    def close(self):
        pass


def _pole_policy(agent_id, env_index=0, **kw):
    return "p0" if agent_id == "a0" else "p1"


# ray_tpu's own DreamerV3 test config (tests/test_rllib_dreamerv3.py), for
# the CPU run of phase 13; the card runs the defaults.
_DREAMER_SMALL = dict(hidden=32, deter=32, stoch=4, classes=4, batch_size_B=4,
                      batch_length_T=8, horizon_H=5, learning_starts=64, training_ratio=4,
                      num_bins=31)
# The least top-2 gap of a Gumbel argmax that the card-against-CPU update
# of DreamerV3 trusts: the two devices' f32 logits differ by ~1e-6, so a
# larger gap decides both the same way. A full-width update takes ~18,000
# argmaxes, and about one draw in three holds a smaller gap somewhere.
_ARGMAX_MARGIN = 1e-5
_ARGMAX_DRAWS = 10
_DREAMER_LOSSES = ("wm_loss", "recon_loss", "reward_loss", "continue_loss", "kl_dyn",
                   "kl_rep", "actor_loss", "critic_loss", "dream_return_mean",
                   "actor_entropy", "total_wm_loss")


def _worst_leaf(got, want) -> float:
    """The largest max|got - want| / max|want| over two trees' leaves."""
    from ray_tpu_torch.ops.tree import flatten

    got, want = flatten(got), flatten(want)
    return max(float(np.abs(np.asarray(got[k], np.float64) - w).max()
                     / max(np.abs(np.asarray(w, np.float64)).max(), 1e-12))
               for k, w in want.items())


def _bitwise(a, b) -> bool:
    from ray_tpu_torch.ops.tree import flatten

    a, b = flatten(a), flatten(b)
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _ppo_learner(device, state, mesh=None):
    """PPO's learner at its defaults (CartPole's dims, hidden (64, 64)) on
    ``device``, from ``state``, through ``mesh`` if given."""
    from ray_tpu_torch.rllib import PPOConfig, TorchLearner
    from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss
    from ray_tpu_torch.rllib.core.learner import make_optimizer

    cfg = PPOConfig().environment(observation_dim=4, action_dim=2).learners(device=device)
    learner = TorchLearner(cfg.rl_module_spec().build(), make_ppo_loss(cfg),
                           make_optimizer(cfg), mesh=mesh)
    learner.set_state(state)
    return learner


def _mesh_rank(rank, world, device, state, mb):
    """Part (c), one of two gloo ranks sharing the card: PPO's learner
    through a ("data",) mesh of both, each rank handed the whole minibatch
    and keeping its half. Returns the update's metrics, parameters and
    optimizer state, its host ms and this rank's kernel launches."""
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import MeshConfig
    from ray_tpu_torch.rllib import SampleBatch

    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    learner = _ppo_learner(device, state, MeshConfig().build(device))
    metrics = learner.update(SampleBatch(dict(mb)))
    after = learner.get_state()
    wrappers = [getattr(_kernels, name) for name in _COPYING]
    return {"metrics": metrics, "state": after,
            "update_ms": _update_ms(learner, SampleBatch(dict(mb))),
            "launches": _launch_counts(), "copies": {w.__name__: w.copies for w in wrappers}}


def phase_rllib_more(shared: dict, device: str = "cuda", small: bool = False):
    """Phase 13: multi-agent PPO, DreamerV3 and the learner sharded over a
    data mesh, every module and learner on ``device`` (``small``: ray_tpu's
    own small DreamerV3 test config, for a CPU run). Returns the kernel
    launches and input copies that part (c)'s ranks counted, and the
    phase's row."""
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshConfig, _spawn
    from ray_tpu_torch.rllib import DreamerV3Config, PPOConfig, SampleBatch
    from ray_tpu_torch.rllib.algorithms import dreamerv3

    row = {"device": device}

    # (a) Multi-agent PPO at PPO's defaults (8 envs, 64-step fragments,
    # batch 512, 4 epochs of 128-row minibatches), a module per pole.
    cfg = (PPOConfig().environment(TwoCartPoles)
           .multi_agent(policies=["p0", "p1"], policy_mapping_fn=_pole_policy)
           .learners(device=device).debugging(seed=0))
    ma = cfg.build()
    group, stats, batches = ma.env_runner_group, {"s": 0.0, "rows": 0, "calls": 0}, []
    real_sample, real_update = group.sample_fragments, ma.learner_group.update_epochs

    def sample_fragments(weights=None):
        t0 = time.perf_counter()
        out = real_sample(weights)
        stats["s"] += time.perf_counter() - t0
        stats["rows"] += sum(len(f) for fl in out.values() for f in fl)
        stats["calls"] += 1
        return out

    def update_epochs(per_module, **kw):
        batches.append(per_module)
        return real_update(per_module, **kw)

    group.sample_fragments, ma.learner_group.update_epochs = sample_fragments, update_epochs
    iters = 1 if small else 3
    t0 = time.perf_counter()
    results = [ma.train() for _ in range(iters)]
    wall = time.perf_counter() - t0
    keys = ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl", "grad_norm")
    _check(all(_finite(r[mid], keys) for r in results for mid in ("p0", "p1")),
           f"multi-agent PPO's losses are not finite: {results}")
    vector_steps = stats["calls"] * cfg.num_envs_per_env_runner * cfg.rollout_fragment_length
    last = {mid: SampleBatch(dict(b)) for mid, b in batches[-1].items()}
    mb = last["p0"].slice(0, cfg.minibatch_size)
    state = ma.learner_group.learners["p0"].get_state()
    row["multi_agent_ppo"] = {
        "iterations": iters, "rows_per_module": {m: len(b) for m, b in last.items()},
        "total_loss": [{m: r[m]["total_loss"] for m in ("p0", "p1")} for r in results],
        "episode_return_mean": [r.get("episode_return_mean") for r in results],
        "wall_s": wall, "sample_s": stats["s"],
        "agent_steps_per_s_sampled": stats["rows"] / stats["s"],
        "env_steps_per_s_sampled": vector_steps / stats["s"],
        "learner_update_ms": _update_ms(_ppo_learner(device, state), mb)}
    outs = {dev: _ppo_learner(dev, state) for dev in (device, "cpu")}
    for learner in outs.values():
        learner.update(SampleBatch(dict(mb)))
    worst = _worst_leaf(outs[device].get_weights(), outs["cpu"].get_weights())
    row["multi_agent_ppo"]["update_vs_cpu_worst_leaf_share"] = worst
    _check(worst <= _RL_DEVICE_TOL, f"a multi-agent PPO update on {device} differs from the "
                                    f"CPU's by {worst} of a leaf's max (limit {_RL_DEVICE_TOL})")
    with tempfile.TemporaryDirectory() as tmp:
        path = ma.save(tmp)
        restored = cfg.build()
        restored.restore(path)
    ma.learner_group.update_epochs = real_update
    for algo in (ma, restored):
        algo.learner_group.update_epochs({m: SampleBatch(dict(b)) for m, b in last.items()},
                                         num_epochs=cfg.num_epochs,
                                         minibatch_size=cfg.minibatch_size,
                                         rng=np.random.default_rng(1))
    same = _bitwise(ma.get_weights(), restored.get_weights())
    row["multi_agent_ppo"]["restored_next_iteration_bitwise_equal"] = same
    _check(same and restored.iteration == ma.iteration,
           "the restored multi-agent PPO's next iteration differs from the original's")
    ma.cleanup()
    restored.cleanup()

    # (b) DreamerV3 at ray_tpu's defaults on CartPole-v1, 2 iterations past
    # learning_starts (the first already is: 512 rows an iteration).
    dcfg = DreamerV3Config().environment(CartPole).learners(device=device).debugging(seed=0)
    if small:
        dcfg.training(**_DREAMER_SMALL).env_runners(num_envs_per_env_runner=4,
                                                    rollout_fragment_length=16)
    dream = dcfg.build()
    res = []
    t0 = time.perf_counter()
    while sum("wm_loss" in r for r in res) < 2 and len(res) < 10:
        res.append(dream.train())
    wall = time.perf_counter() - t0
    learned = [r for r in res if "wm_loss" in r]
    _check(len(learned) == 2 and all(_finite(r, _DREAMER_LOSSES) for r in learned),
           f"DreamerV3 did not learn with finite losses: {res}")
    # One update on the card against the CPU from the same state, batch and
    # noise, on the first draw whose every argmax (on the CPU) is decided by
    # more than _ARGMAX_MARGIN; the card must then pick every category the
    # CPU picked.
    cpu = dcfg.copy().learners(device="cpu").build()
    rng, skipped = np.random.default_rng(7), 0
    real_argmax = dreamerv3._gumbel_argmax

    def recorded_update(algo, seqs, noise):
        """algo._update, returning each argmax's least top-2 gap and picks."""
        gaps, picks = [], []

        def argmax(logits, gumbel):
            top2 = torch.topk((logits + gumbel).detach(), 2, dim=-1).values
            gaps.append(float((top2[..., 0] - top2[..., 1]).min()))
            picks.append(real_argmax(logits, gumbel))
            return picks[-1]

        dreamerv3._gumbel_argmax = argmax
        try:
            algo._update(seqs, noise)
        finally:
            dreamerv3._gumbel_argmax = real_argmax
        return min(gaps), [p.cpu() for p in picks]

    while True:
        seqs, noise = dict(dream._sample_sequences(rng)), dream._draw_noise()
        cpu.set_extra_state(dream.get_extra_state())
        gap, cpu_picks = recorded_update(cpu, seqs, noise)
        if gap > _ARGMAX_MARGIN or skipped == _ARGMAX_DRAWS - 1:
            break
        skipped += 1
    _check(gap > _ARGMAX_MARGIN, f"{_ARGMAX_DRAWS} DreamerV3 draws each held an argmax "
                                 f"decided by less than {_ARGMAX_MARGIN}")
    _, card_picks = recorded_update(dream, seqs, noise)
    _check(all(torch.equal(a, b) for a, b in zip(card_picks, cpu_picks)),
           f"DreamerV3's update on {device} drew other categories than the CPU's")
    worst = _worst_leaf(dream.get_weights(), cpu.get_weights())
    _check(worst <= _RL_DEVICE_TOL, f"a DreamerV3 update on {device} differs from the CPU's "
                                    f"by {worst} of a leaf's max (limit {_RL_DEVICE_TOL})")
    with tempfile.TemporaryDirectory() as tmp:
        path = dream.save(tmp)
        dream_restored = dcfg.build()
        dream_restored.restore(path)
    seqs = dict(dream._sample_sequences(rng))
    for algo in (dream, dream_restored):
        algo._update(seqs, algo._draw_noise())
    dream_same = _bitwise(dream.get_extra_state(), dream_restored.get_extra_state())
    _check(dream_same, "the restored DreamerV3's next update differs from the original's")
    times = []
    for _ in range(5):
        noise = dream._draw_noise()
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        dream._update(seqs, noise)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    # One update under the profiler (the card only): its launches and the
    # share of its wall time the card is busy.
    profile = (_profile(lambda: dream._update(seqs, dream._draw_noise()), top=4)
               if device != "cpu" else None)
    row["dreamerv3"] = {
        "iterations": len(res), "learning_iterations": len(learned),
        "updates_per_iteration": [r["num_updates"] for r in learned],
        "losses": [{k: r[k] for k in _DREAMER_LOSSES} for r in learned], "wall_s": wall,
        "update_vs_cpu_worst_leaf_share": worst, "argmax_min_gap": gap,
        "draws_skipped_for_near_ties": skipped,
        "restored_next_update_bitwise_equal": dream_same,
        "update_ms": statistics.median(times), "profile_update": profile}
    for algo in (dream, cpu, dream_restored):
        algo.cleanup()

    # (c) The learner mesh. A world-size-1 mesh (NCCL on the card) against
    # the unmeshed learner, bit for bit; then two gloo ranks on this card,
    # half of a 128-row minibatch each, against the whole minibatch's
    # update. gloo carries the all-reduces through the host: not NCCL.
    backend = "nccl" if device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            meshed = _ppo_learner(device, state, MeshConfig().build(device))
            plain = _ppo_learner(device, state)
            m_meshed, m_plain = (x.update(SampleBatch(dict(mb))) for x in (meshed, plain))
            whole = plain.get_state()
            world1_same = m_meshed == m_plain and _bitwise(meshed.get_state(), whole)
            world1_ms = _update_ms(meshed, SampleBatch(dict(mb)))
            plain_ms = _update_ms(plain, SampleBatch(dict(mb)))
        finally:
            dist.destroy_process_group()
    _check(world1_same, f"PPO's update through a world-size-1 {backend} mesh differs from "
                        f"the unmeshed update")
    ranks = _spawn.run(_mesh_rank, 2, device, state, dict(mb), timeout=300)
    ranks_same = all(_bitwise(r["state"], ranks[0]["state"]) and r["metrics"] ==
                     ranks[0]["metrics"] for r in ranks[1:])
    mesh_worst = _worst_leaf(ranks[0]["state"]["params"], whole["params"])
    row["mesh"] = {"rows": len(mb), "world1_backend": backend,
                   "world1_bitwise_equal": world1_same, "world1_update_ms": world1_ms,
                   "unmeshed_update_ms": plain_ms, "world2_backend": "gloo",
                   "ranks_on_one_card": 2, "world2_ranks_bitwise_equal": ranks_same,
                   "world2_worst_leaf_share": mesh_worst,
                   "world2_update_ms": [r["update_ms"] for r in ranks],
                   "launches": [r["launches"] for r in ranks]}
    _check(ranks_same, "the two ranks' parameters or optimizer states differ")
    _check(mesh_worst <= _RL_DEVICE_TOL,
           f"the two ranks' update differs from the whole minibatch's by {mesh_worst} of a "
           f"leaf's max (limit {_RL_DEVICE_TOL})")
    extra = {"launches": dict.fromkeys(_KERNELS, 0), "copies": dict.fromkeys(_COPYING, 0)}
    for r in ranks:
        extra = _add_counts(extra, r)
    print("[rllib_more] " + json.dumps(row))
    return {**extra, "row": row}


# Phase 14's sizes: no-op tasks and actor calls timed, the bytes of each
# tensor put and got, and the flash task's shape (GPT-2 124M's forward,
# bf16).
_RUNTIME_CALLS = 1000
_RUNTIME_PUT_BYTES = 256 << 20
_RUNTIME_FLASH_SHAPE = (4, 1024, 12, 64)


def _worker_counts() -> dict:
    """This process's kernel launches and input copies, as the ranks of
    phases 7, 9 and 13 report them."""
    from ray_tpu_torch.ops import _kernels

    wrappers = [getattr(_kernels, name) for name in _COPYING]
    return {"launches": _launch_counts(), "copies": {w.__name__: w.copies for w in wrappers}}


def _flash_task(q, k, v):
    """Phase 14's GPU task: the flash forward on the leased card (q, k, v
    arrive there as top-level object refs). Returns the output, then this
    worker's counts for the call, its pid, the devices it sees and when
    it started (its inputs had arrived)."""
    import os

    started = time.time()
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import flash_attention

    for name in _COPYING:
        w = getattr(_kernels, name)
        w.launches = w.launches_fp32 = w.copies = 0
    with torch.inference_mode():
        out = flash_attention(q, k, v, causal=True)
    if out.is_cuda:
        torch.cuda.synchronize()
    return out, {**_worker_counts(), "pid": os.getpid(), "started": started,
                 "input_device": q.device.type,
                 "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                 "device_count": torch.cuda.device_count()}


def _chipless_task():
    """Phase 14's chipless task: the devices it sees."""
    import os

    return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count()}


class _EngineActor:
    """Phase 14's GPU actor: an LLMEngine of phase 4's configuration on
    phase 4's weights, which arrive as a tree of object refs (one per
    leaf, each a top-level tensor that lands on the actor's card)."""

    def __init__(self, param_refs, model, device):
        import os

        import ray_tpu_torch
        from ray_tpu_torch.llm import LLMConfig, LLMEngine
        from ray_tpu_torch.ops import _kernels
        from ray_tpu_torch.ops.tree import tree_leaves, tree_map

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for name in _COPYING:
            w = getattr(_kernels, name)
            w.launches = w.launches_fp32 = w.copies = 0
        params = tree_map(lambda r: ray_tpu_torch.get(r, timeout=300), param_refs,
                          is_leaf=lambda x: isinstance(x, ray_tpu_torch.ObjectRef))
        devices = {t.device.type for t in tree_leaves(params)}
        self.eng = LLMEngine(LLMConfig(model=model, max_num_seqs=8, max_seq_len=1024,
                                       tokenizer="byte"), params, device=device)
        self.info = {"pid": os.getpid(), "param_devices": sorted(devices),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def serve(self, prompts, n_new):
        from ray_tpu_torch.llm import SamplingParams

        with torch.inference_mode():
            outs, times = _serve(self.eng, prompts,
                                 SamplingParams(max_tokens=n_new, ignore_eos=True))
        return [o.token_ids for o in outs], times, {**self.info, **_worker_counts()}


def _live(pids) -> list:
    """The pids among ``pids`` that still run (zombies count as gone)."""
    import os

    alive = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    alive.append(pid)
        except OSError:
            pass
    return alive


def _cluster_processes(root: int) -> set:
    """The processes descended from ``root`` that run the port's core (its
    head shards, zygote and workers: ``python -m ray_tpu_torch._private.*``,
    and the workers forked from the zygote)."""
    import os

    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                pass
    out, frontier = set(), {root}
    while frontier:
        frontier = {p for p, pp in parent.items() if pp in frontier} - out
        out |= frontier
    mine = set()
    for pid in out:
        try:
            with open(f"/proc/{pid}/cmdline") as f:
                if "ray_tpu_torch._private." in f.read():
                    mine.add(pid)
        except OSError:
            pass
    return mine


def phase_runtime(shared: dict, device: str = "cuda", small: bool = False):
    """Phase 14: the task/actor core (ray_tpu_torch.init / remote / get /
    put / wait / kill / shutdown) on this machine. Returns the kernel
    launches and input copies that its workers counted (the flash task's
    and the engine actor's), and its row. ``small`` (the CPU test): 50
    calls and 1 MiB tensors instead of 1,000 and 256 MiB."""
    import os

    import ray_tpu_torch
    from ray_tpu_torch._private import evloop, native_sched, shm_store, wirefmt
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.tree import tree_map

    calls = 50 if small else _RUNTIME_CALLS
    put_bytes = (1 << 20) if small else _RUNTIME_PUT_BYTES
    row = {}
    earlier = _cluster_processes(os.getpid())  # another cluster's, exiting
    t0 = time.perf_counter()
    # On the card the GPU comes from detection; the CPU test names one
    # (resources only: nothing there calls CUDA).
    ray_tpu_torch.init(
        object_store_memory=3 * put_bytes + (512 << 20),
        **({} if device == "cuda" else {"num_gpus": 1}))
    row["init_s"] = time.perf_counter() - t0
    row["resources"] = {k: v for k, v in ray_tpu_torch.cluster_resources().items()
                        if k in ("CPU", "GPU")}
    row["native_lanes"] = {
        "object_store (libobjstore.so)": "native" if shm_store._LIB is not None else "none",
        "scheduler (libsched.so)": "native" if native_sched._lib is not None else "python",
        "wire codec (_specenc.so)": "native" if wirefmt.native_active() else "python",
        "event loop (_evloop.so)": "native" if evloop.module() is not None else "python"}
    print("[runtime] init " + json.dumps(row))
    n_cards = torch.cuda.device_count() if device == "cuda" else 1
    _check(row["resources"].get("GPU") == n_cards,
           f"init() counted {row['resources'].get('GPU')} GPUs where torch sees {n_cards}")
    pids = set()
    try:
        @ray_tpu_torch.remote
        def noop():
            return None

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

            def pid(self):
                return os.getpid()

        # Steady state: a first batch of each, untimed, warms the pool,
        # the lease cache and the actor's direct path.
        warm = calls // 5
        ray_tpu_torch.get([noop.remote() for _ in range(warm)], timeout=120)
        t = time.perf_counter()
        out = ray_tpu_torch.get([noop.remote() for _ in range(calls)], timeout=300)
        row["tasks_per_s"] = calls / (time.perf_counter() - t)
        _check(out == [None] * calls, "a no-op task returned something")
        counter = Counter.remote()
        pids.add(ray_tpu_torch.get(counter.pid.remote(), timeout=120))
        ray_tpu_torch.get([counter.inc.remote() for _ in range(warm)], timeout=120)
        t = time.perf_counter()
        out = ray_tpu_torch.get([counter.inc.remote() for _ in range(calls)], timeout=300)
        row["actor_calls_per_s"] = calls / (time.perf_counter() - t)
        _check(out == list(range(warm + 1, warm + calls + 1)),
               "the actor's calls ran out of order")

        # The GPU task: the flash forward on the leased card, against the
        # driver's own launch on the same inputs.
        b, t_, h, d = _RUNTIME_FLASH_SHAPE
        gen = torch.Generator(device=device).manual_seed(14)
        q, k, v = (torch.randn((b, t_, h, d), generator=gen, device=device,
                               dtype=torch.float32).to(torch.bfloat16) for _ in range(3))
        # The driver's own launch is the comparison, not the path: its
        # counts are put back as they were.
        from ray_tpu_torch.ops import _kernels

        saved = [(w, w.launches, w.launches_fp32, w.copies)
                 for w in (getattr(_kernels, name) for name in _COPYING)]
        with torch.inference_mode():
            ref = flash_attention(q, k, v, causal=True)
        for w, n, n_fp32, copies in saved:
            w.launches, w.launches_fp32, w.copies = n, n_fp32, copies
        flash = ray_tpu_torch.remote(num_gpus=1, num_returns=2)(_flash_task)
        # Twice: the first call starts a worker (an interpreter, torch,
        # CUDA, the kernel library), the second finds it warm.
        row["gpu_task_s"], row["gpu_task_to_start_s"] = [], []
        counts = {"launches": dict.fromkeys(_KERNELS, 0), "copies": dict.fromkeys(_COPYING, 0)}
        for _ in range(2):
            t, t_wall = time.perf_counter(), time.time()
            out_ref, meta_ref = flash.remote(*(ray_tpu_torch.put(x) for x in (q, k, v)))
            out = ray_tpu_torch.get(out_ref, timeout=300)
            row["gpu_task_s"].append(time.perf_counter() - t)
            meta = ray_tpu_torch.get(meta_ref, timeout=60)
            pids.add(meta.pop("pid"))
            # From the submit to the task's first line: the worker's
            # start (first call) and the inputs' arrival on its card.
            row["gpu_task_to_start_s"].append(meta.pop("started") - t_wall)
            _check(out.device.type == device,
                   f"the GPU task's result arrived on {out.device.type}, not {device}")
            _check(meta["input_device"] == device,
                   f"the GPU task's inputs arrived on {meta['input_device']}")
            _check(torch.equal(out, ref), "the GPU task's flash forward differs from the "
                                          "driver's launch on the same inputs")
            _check(meta["visible"] == "0" and meta["device_count"] == (device == "cuda"),
                   f"the GPU task saw CUDA_VISIBLE_DEVICES={meta['visible']!r} and "
                   f"{meta['device_count']} devices")
            _check(meta["launches"]["flash_fwd"] == (device == "cuda"),
                   f"the GPU task launched flash_fwd {meta['launches']['flash_fwd']} times")
            counts = _add_counts(counts, meta)
        row["gpu_task"] = {"bitwise_equal": True, "launches": counts["launches"]}
        chipless = ray_tpu_torch.get(ray_tpu_torch.remote(_chipless_task).remote(),
                                     timeout=120)
        pids.add(chipless.pop("pid"))
        _check(chipless == {"visible": "", "device_count": 0},
               f"a chipless task saw {chipless}")

        # Put and get a tensor on the card and one on the host, three
        # rounds each (a round whose put lands on store pages not yet
        # touched pays their first faults).
        row["put_get"] = {}
        for where in dict.fromkeys((device, "cpu")):
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, (put_bytes // 4,), dtype=torch.int32,
                              generator=torch.Generator(device=where).manual_seed(1),
                              device=where)
            sync = torch.cuda.synchronize if where == "cuda" else (lambda: None)
            if where == "cuda":
                # The put's first step alone: the copy to host memory.
                sync()
                t = time.perf_counter()
                x.to("cpu")
                row["put_get_d2h_ms"] = (time.perf_counter() - t) * 1e3
            rounds = []
            for _ in range(3):
                sync()
                t = time.perf_counter()
                ref = ray_tpu_torch.put(x)
                put_s = time.perf_counter() - t
                t = time.perf_counter()
                y = ray_tpu_torch.get(ref, timeout=300)
                sync()
                get_s = time.perf_counter() - t
                _check(y.device.type == where and torch.equal(x, y),
                       f"the {where} tensor came back changed (on {y.device.type})")
                rounds.append((put_s, get_s))
                del y, ref
            put_s, get_s = min(r[0] for r in rounds), min(r[1] for r in rounds)
            row["put_get"][where] = {
                "bytes": put_bytes, "put_ms": [r[0] * 1e3 for r in rounds],
                "get_ms": [r[1] * 1e3 for r in rounds],
                "best_put_GB_per_s": put_bytes / put_s / 1e9,
                "best_get_GB_per_s": put_bytes / get_s / 1e9}
            del x

        # The GPU actor: phase 4's engine on phase 4's weights, passed as
        # object refs; the same 8 prompts give phase 4's tokens.
        serve = shared["serve"]
        param_refs = tree_map(ray_tpu_torch.put, serve["params"])
        n_new = len(serve["tokens"][0])
        Engine = ray_tpu_torch.remote(num_gpus=1)(_EngineActor)
        t = time.perf_counter()
        actor = Engine.remote(param_refs, serve["model"], device)
        # Twice: the first serve is the process's first (cold kernels and
        # handles), the second is warm. Both give phase 4's tokens.
        runs = []
        for _ in range(2):
            tokens, times, ainfo = ray_tpu_torch.get(
                actor.serve.remote(serve["prompts"], n_new), timeout=600)
            runs.append(times)
            for i, (got, want) in enumerate(zip(tokens, serve["tokens"])):
                _check(got == want, f"the engine actor's request {i} differs from "
                                    f"phase 4's: {got} vs {want}")
        row["engine_actor_s"] = time.perf_counter() - t
        pids.add(ainfo["pid"])
        _check(ainfo["param_devices"] == [device],
               f"the actor's weights arrived on {ainfo['param_devices']}")
        _check(ainfo["visible"] == "0", f"the actor saw CUDA_VISIBLE_DEVICES="
                                       f"{ainfo['visible']!r}")
        row["engine_actor"] = {
            "requests": len(tokens), "tokens_equal_to_phase_4": True,
            "decode_tokens_per_s": [r["decode_tokens_per_s"] for r in runs],
            "ttft_s_median": [r["ttft_s_median"] for r in runs],
            "phase_4_decode_tokens_per_s": serve["row"].get("decode_tokens_per_s"),
            "phase_4_ttft_s_median": serve["row"].get("ttft_s_median"),
            "launches": ainfo["launches"]}
        shared["runtime"] = row["engine_actor"]
        counts = _add_counts(counts, ainfo)
        ray_tpu_torch.kill(actor)
        pids |= _cluster_processes(os.getpid()) - earlier
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.time() + 10
    while _live(pids) and time.time() < deadline:
        time.sleep(0.1)
    row["pids_left_after_shutdown"] = _live(pids)
    _check(not row["pids_left_after_shutdown"],
           f"processes left after shutdown(): {row['pids_left_after_shutdown']}")
    print("[runtime] " + json.dumps(row))
    return {**counts, "row": row}


# Phase 15 (dag): compiled DAGs, the CUDA IPC device edge, disaggregated
# serving, Train's trainer and util.collective on the task/actor core.
_DAG_BYTES = 256 << 20
_DAG_EXECUTES = 20
_DAG_SHM_EXECUTES = 6  # the first 4 fill the ring: first touches of its pages
_DAG_META_LIMIT = 64 << 10  # a device edge's descriptor, not its tensors
_DAG_COLLECTIVE_N = 1 << 20
_DAG_N_NEW = 32
# (a)'s in-flight check: passes of work() over each received tensor, and
# the executes in flight at once (under the rings' 4 slots).
_DAG_WORK_PASSES = 32
_DAG_IN_FLIGHT = 3


def _seeded_tensor(seed, nbytes, device):
    """A bf16 tensor of ``nbytes`` drawn from ``seed`` on ``device``: the
    same bits wherever it is drawn on the same kind of device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(nbytes // 2, generator=gen, device=device, dtype=torch.bfloat16)


def _dag_work(x):
    """Phase 15 (a)'s consumer work: _DAG_WORK_PASSES passes over ``x``,
    each reading all of it, queued on the current stream (the caller
    returns long before the card is done)."""
    acc = x.float()
    for _ in range(_DAG_WORK_PASSES):
        acc.mul_(0.5).add_(x)
    return acc


def _collective_input(seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(_DAG_COLLECTIVE_N, generator=gen, device=device)


class _DagActor:
    """Phase 15's actor (0.5 GPU, two of them share the card): an end of
    the device edge, then a prefill or a decode engine of phase 4's
    configuration (its weights rebuilt from phase 4's seed, paged bf16 KV
    in 16-token pages), then a rank of a collective group."""

    def __init__(self, device, nbytes):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device, self.nbytes, self.eng = device, nbytes, None

    def info(self):
        import os

        return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count()}

    def make(self, seed):
        return _seeded_tensor(seed, self.nbytes, self.device)

    def relay(self, x):
        if x.device.type != self.device:
            raise RuntimeError(f"the relay received a tensor on {x.device}")
        return x

    def work(self, x):
        if x.device.type != self.device:
            raise RuntimeError(f"work() received a tensor on {x.device}")
        return _dag_work(x)

    def load_engine(self, model):
        from ray_tpu_torch.llm import LLMConfig, LLMEngine

        self.eng = LLMEngine(LLMConfig(model=model, max_num_seqs=8, max_seq_len=1024,
                                       tokenizer="byte", kv_page_size=16),
                             device=self.device)
        return True

    def prefill(self, prompt):
        from ray_tpu_torch.llm import SamplingParams

        return self.eng.prefill_detached(
            prompt, SamplingParams(max_tokens=_DAG_N_NEW, ignore_eos=True))

    def decode(self, record):
        """Decode a prefill record to its end. Returns the tokens and the
        times on this host's clock."""
        from ray_tpu_torch.llm import SamplingParams

        t_recv = time.time()
        self.eng.add_handoff_request("handoff", record, SamplingParams(
            max_tokens=_DAG_N_NEW, ignore_eos=True))
        out = []
        while self.eng.has_unfinished():
            out += self.eng.step()
        return {"tokens": out[0].token_ids, "t_recv": t_recv, "t_done": time.time(),
                "sealed_at": record["sealed_at"], "kv_on": record["k"].device.type,
                "bytes": sum(record[k].numel() * record[k].element_size() for k in "kv"),
                "pages_left": self.eng.kv_alloc.num_in_use}

    def collective(self, rank, seed):
        """allreduce (sum), allgather and broadcast of a tensor on this
        actor's device, in a group of the two actors."""
        from ray_tpu_torch.util import collective

        g = collective.init_collective_group(2, rank, group_name="chip_smoke_dag")
        ms = {}
        try:
            x = _collective_input(seed + rank, self.device)
            g.barrier()  # both ranks in the group before the timed ops
            for op, fn in (("allreduce", lambda: g.allreduce(x)),
                           ("allgather", lambda: g.allgather(x)),
                           ("broadcast", lambda: g.broadcast(
                               x if rank == 0 else torch.zeros_like(x), src=0))):
                t = time.perf_counter()
                ms[op] = (fn(), (time.perf_counter() - t) * 1e3)
        finally:
            collective.destroy_collective_group("chip_smoke_dag")
        (total, _), (gathered, _), (bcast, _) = ms.values()
        outs = [total, *gathered, bcast]
        return {"devices": sorted({t.device.type for t in outs}),
                "ms": {op: v[1] for op, v in ms.items()},
                "sum": total.cpu().numpy(), "gather": [t.cpu().numpy() for t in gathered],
                "bcast": bcast.cpu().numpy()}


def _dag_train_setup(small):
    """Phase 9 (a)'s configuration (bench.py's GPT-2 124M, B=8, T=1024), or
    for the CPU test a tiny model at B=2, T=32."""
    from ray_tpu_torch import models

    if small:
        return models.tiny(vocab_size=512, max_seq_len=64, attn_impl="flash"), 2, 32
    return _gpt2_train_config(), 8, 1024


def _dag_train_loop(config):
    """Phase 15 (c)'s train_loop_per_worker: phase 9 (a)'s loop on the
    trainer's worker. Six steps from seed 0's state (or steps 4-6 from
    the checkpoint at ``config["resume_from"]``, restored into seed 1's
    state as phase 9 restores it), a report each step, a checkpoint with
    step 3's report. Each report carries this worker's kernel counts and
    the losses so far. Phase 19 (b) runs ``config["steps"]`` steps at
    ``config["lr"]`` (defaults: 6, phase 9's 3e-4)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.train import torch_utils

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in _COPYING:
        w = getattr(_kernels, name)
        w.launches = w.launches_fp32 = w.copies = 0
    device, n_steps = config["device"], config.get("steps", 6)
    cfg, B, T = _dag_train_setup(config["small"])
    opt = _dp_opt(config.get("lr", 3e-4))
    batches = _step_batches(cfg, n_steps, B, T, device)
    if config.get("resume_from"):
        p2, s2 = _dp_fresh(cfg, opt, 1, device)
        state = train.Checkpoint(config["resume_from"]).load_pytree(
            {"params": p2, "opt_state": s2})
        params, opt_state, first = state["params"], state["opt_state"], 3
    else:
        params, opt_state = _dp_fresh(cfg, opt, 0, device)
        params = torch_utils.sync_model_params(params)
        first = 0
    so_far = []
    for i in range(first, n_steps):
        params, opt_state, losses, step_ms = _dp_steps(params, opt_state, opt,
                                                       [batches[i]], cfg)
        so_far += losses
        ckpt = None
        if i == 2:
            staged = train.make_temp_checkpoint_dir()
            train.Checkpoint(staged).save_pytree({"params": params, "opt_state": opt_state})
            ckpt = train.Checkpoint(staged)
        train.report({"loss": losses[0], "losses": list(so_far), "step": i + 1,
                      "step_ms": step_ms[0], **_worker_counts()}, checkpoint=ckpt)


def _dag_train_reference(small, device):
    """Phase 9 (a)'s six losses in this process (the CPU test's stand-in
    for phase 9): a session of world size 1, no process group."""
    from ray_tpu_torch.train.session import TrainSession, set_session

    cfg, B, T = _dag_train_setup(small)
    opt = _dp_opt()
    set_session(TrainSession(0, 1, 0, experiment_name="chip_smoke_reference"))
    try:
        params, opt_state = _dp_fresh(cfg, opt, 0, device)
        _, _, losses, step_ms = _dp_steps(params, opt_state, opt,
                                          _step_batches(cfg, 6, B, T, device), cfg)
    finally:
        set_session(None)
    return {"losses": losses, "step_ms_median": statistics.median(step_ms[1:])}


def _dag_in_flight(a, b, n, nbytes, device):
    """Phase 15 (a)'s in-flight check: A's draw over a device edge to B,
    whose work() leaves the card reading it after the call returns, and
    B's result over a device edge to the driver, _DAG_IN_FLIGHT executes
    in flight at once. Returns the seeds whose result differs from the
    driver's own work() on its own draw, bit for bit."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    with InputNode() as inp:
        x = a.make.bind(inp).with_tensor_transport("device")
        node = b.work.bind(x).with_tensor_transport("device")
    dag = node.experimental_compile()
    dag.ensure_compiled()
    differ = []
    try:
        refs = [dag.execute(seed) for seed in range(min(_DAG_IN_FLIGHT, n))]
        for seed in range(n):
            out = ray_tpu_torch.get(refs[seed], timeout=300)
            if seed + _DAG_IN_FLIGHT < n:
                refs.append(dag.execute(seed + _DAG_IN_FLIGHT))
            if not (out.device.type == device and torch.equal(
                    out, _dag_work(_seeded_tensor(seed, nbytes, device)))):
                differ.append(seed)
            del out
    finally:
        dag.teardown()
    return differ


def _dag_ms(dag, seed, sync):
    """One execute of ``dag`` to its result; (result, ms)."""
    import ray_tpu_torch

    sync()
    t = time.perf_counter()
    out = ray_tpu_torch.get(dag.execute(seed), timeout=300)
    sync()
    return out, (time.perf_counter() - t) * 1e3


def phase_dag(shared: dict, device: str = "cuda", small: bool = False):
    """Phase 15: compiled DAGs over the port's channels, on two 0.5-GPU
    actors sharing this card. (a) a 256 MiB bf16 tensor over two CUDA IPC
    device edges (actor A -> actor B -> driver), 20 executes bitwise
    against the driver's own draw, beside the default shm transport; (b)
    disaggregated serving: prefill engine -> device edge -> decode
    engine, phase 4's prompts give phase 4's tokens; (d) util.collective
    between the two actors; then (c) TorchTrainer runs phase 9 (a)'s
    loop on a GPU worker, and a second fit resumes from its step-3
    checkpoint. Returns the trainer worker's kernel counts and the row.
    ``small`` (the CPU test): 1 MiB tensors, 4 executes, a tiny model."""
    import os
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.dag import CompiledDAG, InputNode

    nbytes = (1 << 20) if small else _DAG_BYTES
    n_exec = 4 if small else _DAG_EXECUTES
    n_shm = 2 if small else _DAG_SHM_EXECUTES
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    serve = shared["serve"]
    row = {}
    earlier = _cluster_processes(os.getpid())
    t_phase = time.perf_counter()
    ray_tpu_torch.init(object_store_memory=512 << 20,
                       **({} if device == "cuda" else {"num_gpus": 1}))
    pids = set()
    counts = {"launches": dict.fromkeys(_KERNELS, 0), "copies": dict.fromkeys(_COPYING, 0)}
    try:
        Actor = ray_tpu_torch.remote(num_gpus=0.5)(_DagActor)
        a, b = Actor.remote(device, nbytes), Actor.remote(device, nbytes)
        infos = ray_tpu_torch.get([a.info.remote(), b.info.remote()], timeout=300)
        pids |= {i.pop("pid") for i in infos}
        row["actors_s"] = time.perf_counter() - t_phase
        want = {"visible": "0", "device_count": int(device == "cuda")}
        _check(infos == [want, want], f"the two 0.5-GPU actors saw {infos}")

        # (a) The device edge alone, beside the shm edge.
        with InputNode() as inp:
            x = a.make.bind(inp).with_tensor_transport("device")
            node = b.relay.bind(x).with_tensor_transport("device")
        dag = node.experimental_compile()
        dag.ensure_compiled()
        reader = dag._channels[dag._plan["output_chans"][0]]
        _dag_ms(dag, 1000, sync)  # warm: the loops' first IPC maps
        ms = []
        for seed in range(n_exec):
            out, t = _dag_ms(dag, seed, sync)
            ms.append(t)
            _check(out.device.type == device and torch.equal(
                out, _seeded_tensor(seed, nbytes, device)),
                f"the device edge's execute {seed} differs from the driver's draw")
            del out
        meta = reader.meta_bytes
        dag.teardown()
        differ = _dag_in_flight(a, b, n_exec, nbytes, device)
        _check(not differ, f"with executes in flight, work()'s results of seeds "
                           f"{differ} differ from the driver's")
        with InputNode() as inp:
            node = b.relay.bind(a.make.bind(inp))
        shm = CompiledDAG(node, channel_capacity=nbytes + (1 << 20))
        shm.ensure_compiled()
        shm_ms = []
        for seed in range(n_shm):
            out, t = _dag_ms(shm, seed, sync)
            shm_ms.append(t)
            _check(out.device.type == device and torch.equal(
                out, _seeded_tensor(seed, nbytes, device)),
                f"the shm edge's execute {seed} differs from the driver's draw")
            del out
        shm.teardown()
        row["edge"] = {"bytes": nbytes, "dtype": "bfloat16", "executes": n_exec,
                       "bitwise_equal": True, "device_ms": ms,
                       "device_ms_median": statistics.median(ms),
                       "in_flight": {"executes": n_exec, "at_once": _DAG_IN_FLIGHT,
                                     "work_passes": _DAG_WORK_PASSES,
                                     "bitwise_equal": True},
                       "shm_ms": shm_ms, "shm_ms_median": statistics.median(shm_ms),
                       "shm_ms_ring_touched": shm_ms[4:],
                       "meta_bytes_per_message": meta, "meta_limit": _DAG_META_LIMIT}
        print("[dag] edge " + json.dumps(row["edge"]))
        # On the card only the descriptor crosses the host; CPU tensors
        # (the CPU test) cross as host bytes in the slot.
        _check(device != "cuda" or (meta is not None and meta < _DAG_META_LIMIT),
               f"the device edge's meta message took {meta} bytes")

        # (b) Disaggregated serving: prefill engine -> decode engine.
        model = "gpt2_small" if not small else serve["model"]
        ray_tpu_torch.get([a.load_engine.remote(model), b.load_engine.remote(model)],
                          timeout=600)
        from ray_tpu_torch.llm.tokenizer import load_tokenizer

        params, prompts, want_tokens = (serve[k] for k in ("params", "prompts", "tokens"))
        enc = [load_tokenizer("byte").encode(p) for p in prompts]
        served = {}
        for edge in ("device", "shm"):
            with InputNode() as inp:
                rec = a.prefill.bind(inp)
                if edge == "device":
                    rec = rec.with_tensor_transport("device")
                node = b.decode.bind(rec)
            # The shm record carries the K/V pages: size for the longest.
            d = CompiledDAG(node, channel_capacity=64 << 20)
            d.ensure_compiled()
            ray_tpu_torch.get(d.execute(prompts[0]), timeout=300)  # warm
            per = []
            for p in prompts:
                t_submit = time.time()
                r = ray_tpu_torch.get(d.execute(p), timeout=300)
                per.append({"ttft_ms": (r["sealed_at"] - t_submit) * 1e3,
                            "last_token_ms": (r["t_done"] - t_submit) * 1e3,
                            "handoff_ms": (r["t_recv"] - r["sealed_at"]) * 1e3,
                            "handoff_bytes": r["bytes"], "kv_on": r["kv_on"],
                            "tokens": r["tokens"], "pages_left": r["pages_left"]})
            d.teardown()
            served[edge] = per
            _check_same_tokens(f"disaggregated ({edge} edge)", params, serve["model"], enc,
                               [r["tokens"] for r in per], want_tokens)
            _check(all(r["pages_left"] == 0 for r in per),
                   f"the decode engine kept pages after the {edge} edge's requests")
        _check(all(r["kv_on"] == device for r in served["device"]),
               "the device edge's K/V did not arrive on the card")
        row["disaggregated"] = {
            "requests": len(prompts), "tokens_each": _DAG_N_NEW,
            "tokens_equal_to_phase_4": True,
            **{f"{edge}_edge": [{k: v for k, v in r.items() if k != "tokens"} for r in per]
               for edge, per in served.items()},
            "ttft_ms_median": {e: statistics.median(r["ttft_ms"] for r in per)
                               for e, per in served.items()},
            "handoff_ms_median": {e: statistics.median(r["handoff_ms"] for r in per)
                                  for e, per in served.items()},
            "handoff_share_of_ttft_median": {
                e: statistics.median(r["handoff_ms"] / (r["ttft_ms"] + r["handoff_ms"])
                                     for r in per) for e, per in served.items()},
            "phase_4_ttft_s_median": serve["row"].get("ttft_s_median")}
        print("[dag] disaggregated " + json.dumps(row["disaggregated"]))

        # (d) util.collective between the two actors.
        ra, rb = ray_tpu_torch.get([a.collective.remote(0, 7), b.collective.remote(1, 7)],
                                   timeout=300)
        xs = [_collective_input(7 + r, device).cpu().numpy() for r in range(2)]
        for r, got in enumerate((ra, rb)):
            _check(got["devices"] == [device], f"rank {r}'s results came back on "
                                               f"{got['devices']}")
            _check(np.array_equal(got["sum"], xs[0] + xs[1])
                   and all(np.array_equal(g, x) for g, x in zip(got["gather"], xs))
                   and np.array_equal(got["bcast"], xs[0]),
                   f"rank {r}'s collectives differ from numpy's")
        row["collective"] = {"elements": _DAG_COLLECTIVE_N, "dtype": "float32",
                             "equal_to_numpy": True, "devices": ra["devices"],
                             "ms_rank_0": ra["ms"], "ms_rank_1": rb["ms"]}
        print("[dag] collective " + json.dumps(row["collective"]))
        pids |= _cluster_processes(os.getpid()) - earlier
        ray_tpu_torch.kill(a)
        ray_tpu_torch.kill(b)

        # (c) TorchTrainer: phase 9 (a)'s loop on a GPU worker.
        ref = shared["train_backend"]
        cfg, _, _ = _dag_train_setup(small)
        backend = train.TorchConfig(device=device, distributed="on", timeout_s=300)
        fits = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, loop_cfg in (("fit", {}), ("resumed", None)):
                if loop_cfg is None:
                    loop_cfg = {"resume_from": fits["fit"].checkpoint.path}
                t = time.perf_counter()
                fits[name] = train.TorchTrainer(
                    _dag_train_loop,
                    train_loop_config={"small": small, "device": device, **loop_cfg},
                    scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
                    run_config=train.RunConfig(
                        name=f"chip_smoke_{name}", storage_path=tmp,
                        checkpoint_config=train.CheckpointConfig(num_to_keep=1)),
                    backend_config=backend).fit()
                fits[name + "_s"] = time.perf_counter() - t
            pids |= _cluster_processes(os.getpid()) - earlier
        hist = {k: fits[k].metrics_history for k in ("fit", "resumed")}
        losses = {k: [m["loss"] for m in h] for k, h in hist.items()}
        last = fits["fit"].metrics
        launched = {k: [h[-1]["launches"][n] for n in ("flash_fwd", "flash_bwd_dq",
                                                        "flash_bwd_dkv")]
                    for k, h in hist.items()}
        row["trainer"] = {
            "losses": losses["fit"], "resumed_losses_4_6": losses["resumed"],
            "phase_9_losses": ref["losses"],
            "bitwise_equal_to_phase_9": losses["fit"] == ref["losses"],
            "resumed_bitwise_equal": losses["resumed"] == ref["losses"][3:],
            "result_step": last["step"], "checkpoint": os.path.basename(
                fits["fit"].checkpoint.path),
            "step_ms": [m["step_ms"] for m in hist["fit"]],
            "step_ms_median": statistics.median([m["step_ms"] for m in hist["fit"]][1:]),
            "step_ms_median_phase_9": ref["step_ms_median"],
            "fit_s": fits["fit_s"], "resumed_fit_s": fits["resumed_s"],
            "launches": launched}
        print("[dag] trainer " + json.dumps(row["trainer"]))
        _check(row["trainer"]["bitwise_equal_to_phase_9"],
               f"the trainer's losses differ from phase 9's: {losses['fit']} vs "
               f"{ref['losses']}")
        _check(row["trainer"]["resumed_bitwise_equal"],
               f"the resumed fit's steps 4-6 differ: {losses['resumed']} vs "
               f"{ref['losses'][3:]}")
        _check(last["step"] == 6 and last["loss"] == ref["losses"][5]
               and last["training_iteration"] == 5,
               f"Result.metrics is not the 6th step's: {last}")
        per_step = cfg.n_layers if device == "cuda" else 0
        _check(launched == {"fit": [6 * per_step] * 3, "resumed": [3 * per_step] * 3},
               f"the trainer's worker launched {launched} (fwd, dq, dkv)")
        for h in hist.values():
            counts = _add_counts(counts, h[-1])
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.time() + 10
    while _live(pids) and time.time() < deadline:
        time.sleep(0.1)
    row["pids_left_after_shutdown"] = _live(pids)
    row["phase_s"] = time.perf_counter() - t_phase
    _check(not row["pids_left_after_shutdown"],
           f"processes left after shutdown(): {row['pids_left_after_shutdown']}")
    print("[dag] " + json.dumps({k: row[k] for k in ("actors_s", "phase_s",
                                                     "pids_left_after_shutdown")}))
    return {**counts, "row": row}


# Phase 16 (serve_apps): Serve and the OpenAI app on the task/actor core.
# (b)'s rows: how many, the positions of each whose logits come back, and
# the limit against a direct forward of the row here, of the row's largest
# |logit|: the replica's batch of 4 and the direct batch of 1 run the
# same kernels on the same bf16 weights, but the GEMMs may take other
# tiles (and so another order of the sums) at another M; 12 layers of
# bf16 (8-bit significand) rounding differences stay well under 2^-5.
_SERVE_FWD_ROWS = 8
_SERVE_FWD_LAST = 8
_SERVE_FWD_TOL = 2.0 ** -5
_SERVE_HTTP_S = 600  # every HTTP call and every wait for a replica


def _http_json(port, path, payload=None, timeout=_SERVE_HTTP_S):
    """(status, JSON body, seconds) of one call to the proxy."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="POST" if data is not None else "GET")
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t


def _sse_events(port, path, payload, timeout=_SERVE_HTTP_S):
    """The JSON events of one SSE response, without the [DONE] mark."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", "Accept": "text/event-stream"},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        text = r.read().decode()
    events = [e[len("data: "):] for e in text.split("\n\n") if e.startswith("data: ")]
    return [json.loads(e) for e in events if e != "[DONE]"]


def _completions(port, path, prompts, n_new, **extra):
    """Phase 4's prompts as concurrent POSTs, greedy, ``n_new`` tokens
    each (ignore_eos): the answers in prompt order, the seconds of each
    and the wall seconds of all."""
    from concurrent.futures import ThreadPoolExecutor

    def one(p):
        status, body, s = _http_json(port, path, {"prompt": p, "max_tokens": n_new,
                                                  "temperature": 0.0, "ignore_eos": True,
                                                  **extra})
        _check(status == 200, f"POST {path} answered {status}")
        return body, s

    t = time.perf_counter()
    with ThreadPoolExecutor(len(prompts)) as ex:
        out = list(ex.map(one, prompts))
    return [o[0] for o in out], [o[1] for o in out], time.perf_counter() - t


def _check_token_ids(what, bodies, ref):
    """Each answer's tokens (named by id in its logprobs) are phase 4's."""
    for i, (body, want) in enumerate(zip(bodies, ref)):
        got = [int(t.split(":", 1)[1]) for t in body["choices"][0]["logprobs"]["tokens"]]
        _check(got == want, f"{what}: request {i} differs from phase 4's: {got} vs {want}")


def _http_timings(port, path, prompts, n_new):
    """TTFT through HTTP (one-token requests, all 8 at once) and decode
    tokens/s (the tokens after each request's first over the wall of the
    n_new-token requests less the median TTFT)."""
    _, ttft, _ = _completions(port, path, prompts, 1)
    bodies, _, wall = _completions(port, path, prompts, n_new)
    for body in bodies:
        _check(body["usage"]["completion_tokens"] == n_new,
               f"an answer has {body['usage']['completion_tokens']} tokens")
    ttft_med = statistics.median(ttft)
    return bodies, {"ttft_s": ttft, "ttft_s_median": ttft_med, "wall_s": wall,
                    "decode_tokens_per_s": len(prompts) * (n_new - 1)
                    / max(wall - ttft_med, 1e-9)}


def phase_serve_apps(shared: dict, device: str = "cuda", small: bool = False):
    """Phase 16: Serve and the OpenAI app on this machine, the HTTP proxy
    on the loopback. (a) build_openai_app on phase 4's configuration,
    one replica on num_gpus=1; (b) a GPT-2 forward deployment with
    @serve.batch on num_gpus=0.5; (c) build_disaggregated_app, a prefill
    and a decode replica on num_gpus=0.5 each. Returns (b)'s replica's
    kernel counts and the row. ``small`` (the CPU test): phase 4's tiny
    stand-in for (b) too, at T=64."""
    import asyncio
    import dataclasses
    import os

    import ray_tpu_torch
    from ray_tpu_torch import models, serve
    from ray_tpu_torch.llm import LLMConfig, build_disaggregated_app, build_openai_app
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    sv = shared["serve"]
    prompts, ref = sv["prompts"], sv["tokens"]
    n_new = len(ref[0])
    model_id = "tiny" if small else "gpt2_small"
    # Phase 4's configuration; its weights come from the same seed.
    cfg = LLMConfig(model=sv["model"], model_id=model_id, max_num_seqs=8,
                    max_seq_len=1024, tokenizer="byte")
    ids = {"logprobs": 1, "return_tokens_as_token_ids": True}
    row = {}
    earlier = _cluster_processes(os.getpid())
    t_phase = time.perf_counter()
    ray_tpu_torch.init(object_store_memory=1 << 30,
                       **({} if device == "cuda" else {"num_gpus": 1}))
    pids = set()
    counts = {"launches": dict.fromkeys(_KERNELS, 0), "copies": dict.fromkeys(_COPYING, 0)}
    try:
        serve.start(http_host="127.0.0.1")
        port = serve.get_proxy_port()

        # (a) The OpenAI app: one replica holding the card. serve.run
        # returns once the replica's constructor has returned, so the
        # first request after it, over HTTP (the proxy's carries a 30 s
        # deadline), is answered at once, without a 408.
        t = time.perf_counter()
        serve.run(build_openai_app(cfg, name="openai", device=device),
                  name="openai", route_prefix="/v1")
        run_s = time.perf_counter() - t
        import urllib.error

        try:
            status, listing, first_s = _http_json(port, "/v1/models")
        except urllib.error.HTTPError as e:  # a 408 would be the replica still building
            status, listing, first_s = e.code, None, None
        ready_s = time.perf_counter() - t
        _check(status == 200, f"the first request after serve.run answered {status}")
        _check([m["id"] for m in listing["data"]] == [model_id],
               f"GET /v1/models listed {listing}")
        bodies, _, _ = _completions(port, "/v1/completions", prompts, n_new, **ids)
        _check_token_ids("the OpenAI app", bodies, ref)
        bodies, timing = _http_timings(port, "/v1/completions", prompts, n_new)
        tok = ByteTokenizer()
        _check([b["choices"][0]["text"] for b in bodies] == [tok.decode(r) for r in ref],
               "the OpenAI app's texts are not phase 4's tokens decoded")
        chat = {"messages": [{"role": "user", "content": prompts[3]}],
                "max_tokens": n_new, "temperature": 0.0, "ignore_eos": True}
        _, answer, _ = _http_json(port, "/v1/chat/completions", chat)
        events = _sse_events(port, "/v1/chat/completions", {**chat, "stream": True})
        joined = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
        _check(joined == answer["choices"][0]["message"]["content"]
               and events[-1]["choices"][0]["finish_reason"] == "length",
               f"the chat stream's increments {joined!r} are not its answer "
               f"{answer['choices'][0]['message']['content']!r}")
        row["openai"] = {"serve_run_s": run_s, "ready_s": ready_s,
                         "first_request_s": first_s,
                         "tokens_equal_to_phase_4": True, "stream_events": len(events),
                         **timing,
                         "phase_4": {k: sv["row"].get(k) for k in
                                     ("ttft_s_median", "decode_tokens_per_s")},
                         "phase_14_actor": shared.get("runtime")}
        print("[serve_apps] openai " + json.dumps(row["openai"]))
        serve.delete("openai")

        # (b) GPT-2's bf16 forward behind @serve.batch on half the card.
        T = 64 if small else 1024
        fcfg = dataclasses.replace(sv["model"] if small else models.gpt2_small(),
                                   max_seq_len=T, attn_impl="flash")
        rng = np.random.default_rng(16)
        rows = rng.integers(0, fcfg.vocab_size, (_SERVE_FWD_ROWS, T)).tolist()

        @serve.deployment(name="gpt2_forward", max_ongoing_requests=16,
                          ray_actor_options={"num_gpus": 0.5})
        class Forward:
            def __init__(self, cfg, device, seed):
                from ray_tpu_torch.ops import _kernels

                for name in _COPYING:
                    w = getattr(_kernels, name)
                    w.launches = w.launches_fp32 = w.copies = 0
                self.cfg, self.device = cfg, device
                self.params = models.init_params(torch.Generator().manual_seed(seed),
                                                 cfg, device=device)
                self.sizes = []

            @serve.batch(max_batch_size=4, batch_wait_timeout_s=1.0)
            async def __call__(self, batch):
                self.sizes.append(len(batch))
                return await asyncio.get_running_loop().run_in_executor(
                    None, self.forward, batch)

            def forward(self, batch):
                with torch.inference_mode():
                    x = torch.tensor(batch, device=self.device)
                    out = models.forward(self.params, x, self.cfg)[:, -_SERVE_FWD_LAST:]
                    return list(out.float().cpu())

            def stats(self):
                return {"sizes": list(self.sizes), "pid": os.getpid(),
                        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                        **_worker_counts()}

        t = time.perf_counter()
        h = serve.run(Forward.bind(fcfg, device, 16), name="forward", proxy=False)
        fwd_run_s = time.perf_counter() - t
        responses = [h.remote(r) for r in rows]
        got = [r.result(timeout_s=_SERVE_HTTP_S) for r in responses]
        fwd_s = time.perf_counter() - t
        stats = h.stats.remote().result(timeout_s=_SERVE_HTTP_S)
        pids.add(stats.pop("pid"))
        # The direct forward here compares; its launches do not count.
        from ray_tpu_torch.ops import _kernels

        saved = [(w, w.launches, w.launches_fp32, w.copies)
                 for w in (getattr(_kernels, name) for name in _COPYING)]
        params = models.init_params(torch.Generator().manual_seed(16), fcfg, device=device)
        worst = 0.0
        with torch.inference_mode():
            for r, g in zip(rows, got):
                want = models.forward(params, torch.tensor([r], device=device),
                                      fcfg)[0, -_SERVE_FWD_LAST:].float().cpu()
                _check(g.shape == want.shape and bool(g.isfinite().all()),
                       f"a forward row came back as {tuple(g.shape)} / non-finite")
                worst = max(worst, ((g - want).abs().max() / want.abs().max()).item())
        del params
        for w, n, n_fp32, copies in saved:
            w.launches, w.launches_fp32, w.copies = n, n_fp32, copies
        _check(worst <= _SERVE_FWD_TOL,
               f"a batched row's logits differ from its direct forward by {worst} of "
               f"their max (limit {_SERVE_FWD_TOL})")
        _check(sorted(stats["sizes"]) == [4, 4], f"the replica's batches: {stats['sizes']}")
        n_batches = len(stats["sizes"])
        flash = stats["launches"]["flash_fwd" if fcfg.dtype != "float32"
                                  else "flash_fwd_fp32"]
        _check(flash == n_batches * fcfg.n_layers * (device == "cuda"),
               f"the forward replica launched the flash forward {flash} times for "
               f"{n_batches} batches of {fcfg.n_layers} layers")
        _check(stats["visible"] == "0", f"the forward replica saw "
                                        f"CUDA_VISIBLE_DEVICES={stats['visible']!r}")
        counts = _add_counts(counts, stats)
        row["forward"] = {"rows": len(rows), "seq": T, "batch_sizes": stats["sizes"],
                          "worst_share_of_max_logit": worst, "limit": _SERVE_FWD_TOL,
                          "serve_run_s": fwd_run_s, "seconds": fwd_s,
                          "launches": stats["launches"]}
        print("[serve_apps] forward " + json.dumps(row["forward"]))
        serve.delete("forward")

        # (c) Disaggregated: a prefill and a decode replica sharing the card.
        t = time.perf_counter()
        dis = serve.run(build_disaggregated_app(cfg, name="disagg", device=device,
                                                ray_actor_options={"num_gpus": 0.5}),
                        name="disagg", route_prefix="/v1")
        run_s = time.perf_counter() - t
        dis.stats.remote().result(timeout_s=_SERVE_HTTP_S)  # both pools answer
        ready_s = time.perf_counter() - t
        bodies, _, _ = _completions(port, "/v1/completions", prompts, n_new, **ids)
        _check_token_ids("the disaggregated app", bodies, ref)
        _, timing = _http_timings(port, "/v1/completions", prompts, n_new)
        hand = dis.stats.remote().result(timeout_s=_SERVE_HTTP_S)["handoff"]
        row["disaggregated"] = {
            "serve_run_s": run_s, "ready_s": ready_s, "tokens_equal_to_phase_4": True,
            **timing,
            "handoffs": hand["count"], "handoff_bytes": hand["bytes"],
            "handoff_ms_median": hand["latency_p50_s"] * 1e3,
            "handoff_ms_p95": hand["latency_p95_s"] * 1e3,
            "handoff_share_of_ttft": hand["latency_p50_s"] / timing["ttft_s_median"]}
        print("[serve_apps] disaggregated " + json.dumps(row["disaggregated"]))
        pids |= _cluster_processes(os.getpid()) - earlier
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    deadline = time.time() + 10
    while _live(pids) and time.time() < deadline:
        time.sleep(0.1)
    row["pids_left_after_shutdown"] = _live(pids)
    row["phase_s"] = time.perf_counter() - t_phase
    _check(not row["pids_left_after_shutdown"],
           f"processes left after shutdown(): {row['pids_left_after_shutdown']}")
    print("[serve_apps] " + json.dumps({k: row[k] for k in ("phase_s",
                                                            "pids_left_after_shutdown")}))
    return {**counts, "row": row}


# Phase 17 (rllib_remote): RLlib's remote groups on the core. The runners
# are CPU actors; the learners hold fractional GPU leases when the device
# is the card (two share it). Each learner is a TorchLearner of MLPs, and
# each runner steps the script's CartPole: neither launches a flash kernel.
_RL_REMOTE_ITERS = 3
_RL_REMOTE_WAIT_S = 600  # every get of the phase


def _learner_weights_equal(rt, learners) -> bool:
    """Whether every learner actor holds the same weights, bit for bit."""
    from ray_tpu_torch.ops.tree import flatten

    per = [flatten(w) for w in rt.get([a.get_weights.remote() for a in learners],
                                      timeout=_RL_REMOTE_WAIT_S)]
    return all(np.array_equal(per[0][k], p[k]) for p in per[1:] for k in per[0])


def _timed_updates(algo, attr="update_epochs", owner=None):
    """Wrap a learner call (the group's update_epochs, or the local
    learner's update) to record the host ms of each call."""
    owner = owner if owner is not None else algo.learner_group
    times = []
    real = getattr(owner, attr)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(owner, attr, timed)
    return times


def phase_rllib_remote(shared: dict, device: str = "cuda", small: bool = False):
    """Phase 17: (a) PPO on the script's CartPole at its defaults with 2
    remote env runners (CPU actors) and 2 remote learners on ``device``
    (for the card, two num_gpus=0.5 leases), 3 iterations; (b) IMPALA
    at its defaults (2 runners, 2 requests in flight each, batch 512), 3
    iterations; (c) APPO at its defaults, 1 iteration. Returns the
    workers' kernel counts (none is read: the learners and runners run
    MLPs, which launch no flash kernel) and the row. ``small`` (the CPU
    test): 2 PPO iterations and 2 of IMPALA."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig, PPOConfig

    iters = 2 if small else _RL_REMOTE_ITERS
    local = shared.get("rllib") or {}
    row = {"device": device}
    earlier = _cluster_processes(os.getpid())
    t_phase = time.perf_counter()
    rt.init(object_store_memory=256 << 20, **({} if device == "cuda" else {"num_gpus": 1}))
    pids = set()
    try:
        # (a) PPO: the runners and learners start together in build().
        t = time.perf_counter()
        ppo = (PPOConfig().environment(CartPole).env_runners(num_env_runners=2)
               .learners(num_learners=2, device=device).debugging(seed=0).build())
        built_s = time.perf_counter() - t
        sampled = _timed_sampling(ppo)
        update_ms = _timed_updates(ppo)
        learners = list(ppo.learner_group.remotes)
        keys = ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl", "grad_norm")
        results, equal, iter_s = [], [], []
        for _ in range(iters):
            t = time.perf_counter()
            r = ppo.train()
            iter_s.append(time.perf_counter() - t)
            results.append(r)
            equal.append(_learner_weights_equal(rt, learners))
        pids |= _cluster_processes(os.getpid()) - earlier
        _check(all(_finite(r, keys) for r in results), f"PPO's losses are not finite: {results}")
        _check(all(equal), f"the two learners' weights differ after an iteration: {equal}")
        steps = [r["num_env_steps_sampled"] for r in results]
        _check(all(s >= ppo.algo_config.train_batch_size for s in steps),
               f"PPO sampled {steps} env steps, fewer than its train batch")
        row["ppo"] = {"iterations": iters, "build_s": built_s, "iteration_s": iter_s,
                      "total_loss": [r["total_loss"] for r in results],
                      "env_steps_sampled": steps, "learners_bitwise_equal": equal,
                      "env_steps_per_s_sampled": sampled["rows"] / sampled["s"],
                      "update_epochs_ms": update_ms,
                      "phase_12_local": {k: (local.get("ppo") or {}).get(k) for k in (
                          "env_steps_per_s_sampled", "learner_update_ms", "wall_s")}}
        print("[rllib_remote] ppo " + json.dumps(row["ppo"]))
        ppo.stop()

        # (b) IMPALA and (c) APPO at their defaults.
        for name, c, n, ratio in (("impala", IMPALAConfig(), iters, "mean_rho"),
                                  ("appo", APPOConfig(), 1, "mean_ratio")):
            t = time.perf_counter()
            algo = c.environment(CartPole).learners(device=device).debugging(seed=4).build()
            built_s = time.perf_counter() - t
            upd = _timed_updates(algo, "update", algo.learner_group.local)
            res, iter_s = [], []
            for _ in range(n):
                t = time.perf_counter()
                res.append(algo.train())
                iter_s.append(time.perf_counter() - t)
            pids |= _cluster_processes(os.getpid()) - earlier
            _check(all(r["num_learner_updates"] >= 1 for r in res)
                   and all(_finite(r, ("total_loss", "policy_loss", "vf_loss", "grad_norm"))
                           for r in res), f"{name} did not learn with finite losses: {res}")
            _check(0.5 < res[0][ratio] < 2.0,
                   f"{name}'s first {ratio} {res[0][ratio]} is not in (0.5, 2)")
            # The first iteration waits for the runners' start (a worker,
            # torch, the environments); the rate is of the later ones.
            later = sum(r["num_env_steps_sampled"] for r in res[1:])
            row[name] = {"iterations": n, "build_s": built_s, "iteration_s": iter_s,
                         "learner_updates": [r["num_learner_updates"] for r in res],
                         ratio: [r[ratio] for r in res],
                         "total_loss": [r["total_loss"] for r in res],
                         "env_steps_per_s_after_first": (later / sum(iter_s[1:])
                                                         if n > 1 else None),
                         "learner_update_ms_median": statistics.median(upd),
                         "phase_12_local_update_ms": (local.get(name) or {}).get(
                             "learner_update_ms")}
            print(f"[rllib_remote] {name} " + json.dumps(row[name]))
            algo.stop()
    finally:
        rt.shutdown()
    deadline = time.time() + 10
    while _live(pids) and time.time() < deadline:
        time.sleep(0.1)
    row["pids_left_after_shutdown"] = _live(pids)
    row["phase_s"] = time.perf_counter() - t_phase
    _check(not row["pids_left_after_shutdown"],
           f"processes left after shutdown(): {row['pids_left_after_shutdown']}")
    print("[rllib_remote] " + json.dumps({k: row[k] for k in ("phase_s",
                                                              "pids_left_after_shutdown")}))
    return {"launches": dict.fromkeys(_KERNELS, 0), "copies": dict.fromkeys(_COPYING, 0),
            "row": row}


# Phase 18 (data): ray_tpu_torch.data feeding phase 5's training, and
# batch inference over an actor pool on the card.
_DATA_STEPS = 6
_DATA_WAIT_S = 600  # the pool's wait for each block
_OPTIONAL = ("pyarrow", "pandas", "PIL", "tensorflow")


def _stamp_batch(batch):
    """A map_batches stage fused after the LLM stage, run in the pool's
    worker as each batch leaves the engine: the time it left, and the
    worker's kernel counts."""
    n = len(batch["prompt"])
    out = dict(batch)
    out["done_at"] = np.full(n, time.time())
    out["counts"] = np.array([json.dumps(_worker_counts())] * n, dtype=object)
    return out


def _optional_libraries() -> dict:
    """Which of Data's optional libraries this machine has (found by
    module spec, none imported), with the installed version."""
    import importlib.metadata
    import importlib.util

    dist = {"PIL": "pillow"}
    found = {}
    for name in _OPTIONAL:
        if importlib.util.find_spec(name) is None:
            found[name] = "missing"
            continue
        try:
            found[name] = importlib.metadata.version(dist.get(name, name))
        except importlib.metadata.PackageNotFoundError:
            found[name] = "found"
    return found


def phase_data(shared: dict, device: str = "cuda", small: bool = False):
    """Phase 18: (a) a Dataset (from_numpy) of phase 5's GPT-2 tokens, B=8,
    T=1024, drawn once from phase 5's seed, feeds 6 bf16 steps of phase
    5's configuration through iter_torch_batches(device=...): the losses
    equal a direct run on the same tokens bit for bit (two runs of each,
    in turns), and each kernel launches once per layer per step; (b) build_llm_processor on phase
    4's configuration (its weights from the same seed) over an actor pool
    of one worker with a GPU lease: phase 4's 8 prompts, twice (two
    batches of 8), greedy, 32 tokens, give phase 4's texts; (c) which of
    Data's optional libraries this machine has. Returns the pool worker's
    kernel counts and the row. ``small`` (the CPU test): a tiny model at
    B=2, T=32, and phase 4's tiny stand-in."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import models
    from ray_tpu_torch.llm import LLMConfig, SamplingParams, build_llm_processor
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.optim import FusedClipAdamW

    row = {"device": device, "optional_libraries": _optional_libraries()}
    print("[data] optional libraries " + json.dumps(row["optional_libraries"]))
    t_phase = time.perf_counter()

    # (a) The Dataset-fed train step against the direct one.
    cfg, B, T = _dag_train_setup(small)
    kernels = (_kernels.flash_fwd, _kernels.flash_bwd_dq, _kernels.flash_bwd_dkv)
    gen = torch.Generator(device=device).manual_seed(0)  # phase 5's seed
    tokens = torch.randint(0, cfg.vocab_size, (_DATA_STEPS * B, T + 1), generator=gen,
                           device=device).cpu().numpy()
    opt = FusedClipAdamW(learning_rate=3e-4, weight_decay=0.1, clip_norm=1.0)
    step = models.make_train_step(cfg, opt)
    launches = [cfg.n_layers if device == "cuda" else 0] * 3

    def run(batches):
        state = models.init_train_state(torch.Generator(device=device).manual_seed(0),
                                        cfg, opt, device=device)
        losses, ms = [], []
        it = iter(batches)
        for _ in range(_DATA_STEPS):
            before = [k.launches for k in kernels]
            t0 = time.perf_counter()
            batch = next(it)
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
            per_step = [k.launches - b for k, b in zip(kernels, before)]
            _check(per_step == launches,
                   f"a step launched {per_step} (fwd, dq, dkv), expected {launches}")
        return losses, ms

    def direct_batches():
        return ({"tokens": torch.from_numpy(tokens[i * B:(i + 1) * B]).to(device)}
                for i in range(_DATA_STEPS))

    def fed_batches():
        return ({"tokens": b["data"]} for b in rd.from_numpy(tokens).iter_torch_batches(
            batch_size=B, device=device, dtypes=torch.int64))

    # In turns (direct, fed, fed, direct): the host's time drifts.
    runs = {"direct": [], "fed": []}
    for name in ("direct", "fed", "fed", "direct"):
        runs[name].append(run(direct_batches() if name == "direct" else fed_batches()))
    direct, fed = runs["direct"][0][0], runs["fed"][0][0]
    _check(all(r[0] == direct for r in runs["direct"] + runs["fed"]),
           f"the Dataset-fed losses {[r[0] for r in runs['fed']]} differ from the direct "
           f"run's {[r[0] for r in runs['direct']]}")
    _check(all(math.isfinite(x) for x in fed), f"non-finite losses: {fed}")
    fed_ms = [ms for r in runs["fed"] for ms in r[1]]
    direct_ms = [ms for r in runs["direct"] for ms in r[1]]
    fed_med = statistics.median(ms for r in runs["fed"] for ms in r[1][1:])
    direct_med = statistics.median(ms for r in runs["direct"] for ms in r[1][1:])
    phase5_ms = shared.get("gpt2_bf16_step_ms_median")
    row["train"] = {"batch": B, "seq": T, "steps": _DATA_STEPS, "losses": fed,
                    "bitwise_equal_to_direct": True, "runs_each": 2, "fed_step_ms": fed_ms,
                    "direct_step_ms": direct_ms,
                    "fed_tokens_per_s": B * T / (fed_med / 1e3),
                    "direct_tokens_per_s": B * T / (direct_med / 1e3),
                    "phase_5_tokens_per_s": B * T / (phase5_ms / 1e3) if phase5_ms else None,
                    "launches_per_step": launches}
    print("[data] train " + json.dumps(row["train"]))

    # (b) Batch inference on an actor pool: one worker, a GPU lease.
    sv = shared["serve"]
    prompts, ref = sv["prompts"], sv["tokens"]
    n_new = len(ref[0])
    texts = [ByteTokenizer().decode(r) for r in ref]
    llm_cfg = LLMConfig(model=sv["model"], max_num_seqs=8, max_seq_len=1024, tokenizer="byte")
    # On the card the stage's own default (a GPU pool of one); the CPU
    # test asks for the same pool, which device="cpu" would not make.
    pool = (None if device == "cuda" else
            rd.ActorPoolStrategy(min_size=1, max_size=1, resources={"GPU": 1}))
    earlier = _cluster_processes(os.getpid())
    rt.init(object_store_memory=256 << 20, **({} if device == "cuda" else {"num_gpus": 1}))
    pids = set()
    ctx = rd.DataContext.get_current()
    try:
        ds = build_llm_processor(
            rd.from_items([{"prompt": p} for p in prompts * 2]), llm_cfg,
            sampling=SamplingParams(max_tokens=n_new, ignore_eos=True), batch_size=len(prompts),
            device=device, compute=pool).map_batches(_stamp_batch)
        op = ds._plan[-2]
        _check(op.compute is not None and op.compute.resources == {"GPU": 1},
               f"the LLM stage's pool asks for {op.compute}")
        op.compute.block_timeout_s = _DATA_WAIT_S
        t = time.perf_counter()
        rows = ds.take_all()
        wall = time.perf_counter() - t
        pids |= _cluster_processes(os.getpid()) - earlier
        stats = dict(ctx.stats.get("actor_pool") or {})
    finally:
        rt.shutdown()
    got = [r["generated_text"] for r in rows]
    _check(got == texts * 2, "the batch stage's texts are not phase 4's: "
                             f"{[i for i, (a, b) in enumerate(zip(got, texts * 2)) if a != b]}")
    counts = json.loads(rows[-1]["counts"])
    done = sorted({float(r["done_at"]) for r in rows})
    warm_s = done[1] - done[0]
    phase4 = sv["row"]
    row["batch_inference"] = {
        "rows": len(rows), "batches": len(done), "texts_equal_to_phase_4": True,
        "wall_s": wall, "tokens_per_s_end_to_end": len(rows) * n_new / wall,
        "second_batch_s": warm_s, "tokens_per_s_second_batch": len(prompts) * n_new / warm_s,
        "pool": stats, "worker_launches": counts["launches"],
        "phase_4": {"total_s": phase4.get("total_s"),
                    "decode_tokens_per_s": phase4.get("decode_tokens_per_s"),
                    "tokens_per_s": (len(prompts) * n_new / phase4["total_s"]
                                     if phase4.get("total_s") else None)}}
    _check(stats.get("spawned") == 1 and stats.get("peak_size") == 1,
           f"the pool's stats: {stats}")
    print("[data] batch_inference " + json.dumps(row["batch_inference"]))
    deadline = time.time() + 10
    while _live(pids) and time.time() < deadline:
        time.sleep(0.1)
    row["pids_left_after_shutdown"] = _live(pids)
    row["phase_s"] = time.perf_counter() - t_phase
    _check(not row["pids_left_after_shutdown"],
           f"processes left after shutdown(): {row['pids_left_after_shutdown']}")
    print("[data] " + json.dumps({k: row[k] for k in ("phase_s", "pids_left_after_shutdown")}))
    return {**counts, "row": row}


# Phase 19 (tune_jobs): Tune, Workflow, job submission, the state API and
# the dashboard on one cluster. (a)'s grid of learning rates, its reports
# (2 steps each, at most 3: ASHA's max_t) and (b)'s; every bounded wait of
# the phase; (c)'s forward batch; the seeds of (c)'s tokens and (d)'s
# flash inputs.
_TUNE_LRS = (3e-4, 1e-3, 1e-4, 3e-5)
_TUNE_STEPS_PER_REPORT = 2
_TUNE_REPORTS = 3
_TUNE_TRAINER_LRS = (3e-4, 1e-3)
_TUNE_TRAINER_STEPS = 3
_TUNE_WAIT_S = 600
_WF_BATCH = (4, 1024)
_WF_SEED = 200
_JOB_SEED = 300


def _proc_start_time() -> float:
    """This process's start on the epoch clock, from /proc."""
    import os

    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def _tree_checksum(tree) -> str:
    """sha256 of every leaf's bytes, in tree_leaves order."""
    import hashlib

    from ray_tpu_torch.ops.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _tune_trial(config):
    """Phase 19 (a)'s function trainable, in a trial actor on half the
    card: phase 9 (a)'s data-parallel bf16 GPT-2 steps (world size 1) at
    ``config["lr"]``, a report every 2 steps with a checkpoint of the
    parameters, its checksum, the losses so far, the step times and this
    worker's kernel counts."""
    import os
    import shutil

    import ray_tpu_torch
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.train.session import TrainSession, set_session

    fn_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in _COPYING:
        w = getattr(_kernels, name)
        w.launches = w.launches_fp32 = w.copies = 0
    device = config["device"]
    cfg, B, T = _dag_train_setup(config["small"])
    opt = _dp_opt(config["lr"])
    params, opt_state = _dp_fresh(cfg, opt, 0, device)
    batches = _step_batches(cfg, _TUNE_REPORTS * _TUNE_STEPS_PER_REPORT, B, T, device)
    info = {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "worker_id": ray_tpu_torch.get_runtime_context().get_worker_id(),
            "proc_start": _proc_start_time(), "fn_start": fn_start}
    losses, step_ms, written = [], [], []
    set_session(TrainSession(0, 1, 0, experiment_name="chip_smoke_tune"))
    try:
        steps_start = time.time()
        for r in range(_TUNE_REPORTS):
            chunk = batches[r * _TUNE_STEPS_PER_REPORT:(r + 1) * _TUNE_STEPS_PER_REPORT]
            params, opt_state, got, ms = _dp_steps(params, opt_state, opt, chunk, cfg)
            losses += got
            step_ms += ms
            steps_end = time.time()
            # Straight where the trial actor keeps its r-th checkpoint, so it
            # copies none of the ~0.5 GB. A Result takes the checkpoint of
            # the last report the controller read, and this thread runs
            # one report ahead of it: the two newest stay, older ones go.
            path = os.path.join(tune.get_trial_dir(), f"checkpoint_{r:06d}")
            train.Checkpoint(path).save_pytree({"params": params})
            written.append(path)
            if len(written) > 2:
                shutil.rmtree(written.pop(0), ignore_errors=True)
            tune.report({"loss": got[-1], "losses": list(losses), "step_ms": list(step_ms),
                         "checksum": _tree_checksum(params), "steps_start": steps_start,
                         "steps_end": steps_end, **info, **_worker_counts()},
                        checkpoint=train.Checkpoint(path))
    finally:
        set_session(None)


def _wf_make_batch(small):
    """Phase 19 (c)'s first step (no lease): B x (T + 1) tokens from a seed."""
    cfg, _, _ = _dag_train_setup(small)
    B, T = (2, 32) if small else _WF_BATCH
    return torch.randint(0, cfg.vocab_size, (B, T + 1),
                         generator=torch.Generator().manual_seed(_WF_SEED))


def _row_losses(params, tokens, cfg):
    """The mean next-token cross-entropy of each row of ``tokens``."""
    from ray_tpu_torch import models

    logits = models.forward(params, tokens[:, :-1], cfg)
    B, T = tokens[:, 1:].shape
    return torch.nn.functional.cross_entropy(
        logits.reshape(B * T, -1).float(), tokens[:, 1:].reshape(-1),
        reduction="none").reshape(B, T).mean(dim=1)


def _wf_forward_loss(tokens, small, device, counter_path):
    """Phase 19 (c)'s GPU step (num_gpus=0.5): GPT-2 124M's forward with
    the flash kernel (weights from seed 0) on the tokens; returns the
    per-row losses as a tensor on ``device``. Each run appends to
    ``counter_path`` and writes beside it this worker's kernel counts,
    its process's start and the step's start and end."""
    from ray_tpu_torch import models
    from ray_tpu_torch.ops import _kernels

    started = time.time()
    with open(counter_path, "a") as f:
        f.write("x")
    for name in _COPYING:
        w = getattr(_kernels, name)
        w.launches = w.launches_fp32 = w.copies = 0
    cfg, _, _ = _dag_train_setup(small)
    params = models.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                device=device)
    with torch.inference_mode():
        losses = _row_losses(params, tokens.to(device), cfg)
    if losses.is_cuda:
        torch.cuda.synchronize()
    with open(counter_path + ".counts", "w") as f:
        json.dump({**_worker_counts(), "proc_start": _proc_start_time(), "started": started,
                   "ended": time.time()}, f)
    return losses


def _wf_finalize(losses, approval, flag_path):
    """Phase 19 (c)'s last step (no lease): fails while ``flag_path`` is
    missing; else the losses on the host and the event's payload."""
    import os

    if not os.path.exists(flag_path):
        raise RuntimeError("finalize fails on its first run")
    return {"losses": losses.cpu(), "approval": approval, "mean": float(losses.mean())}


def _load_stored_step(path):
    """Phase 19 (c)'s check, in a worker that sees no card: the stored
    step value loads (a CPU tensor); its device, dtype and the devices
    this worker sees."""
    import os

    import cloudpickle

    with open(path, "rb") as f:
        value = cloudpickle.loads(f.read())
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": value.device.type, "dtype": str(value.dtype), "value": value}


def _seeded_flash_checksum(device):
    """Phase 19 (d)'s work: the bf16 flash forward on q, k, v drawn from a
    seed on ``device``; sha256 of the output's bytes."""
    import hashlib

    from ray_tpu_torch.ops.attention import flash_attention

    g = torch.Generator(device=device).manual_seed(_JOB_SEED)
    q, k, v = (torch.randn(_RUNTIME_FLASH_SHAPE, generator=g, device=device,
                           dtype=torch.float32).to(torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        out = flash_attention(q, k, v, causal=True)
    return hashlib.sha256(out.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def _job_flash_task(device):
    """Phase 19 (d)'s num_gpus=1 task of the job: the checksum, this
    worker's kernel counts and the devices it sees."""
    import os

    from ray_tpu_torch.ops import _kernels

    for name in _COPYING:
        w = getattr(_kernels, name)
        w.launches = w.launches_fp32 = w.copies = 0
    digest = _seeded_flash_checksum(device)
    return digest, {**_worker_counts(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _job_main(device):
    """Phase 19 (d)'s job entrypoint: joins the cluster it was submitted to
    (RAY_TPU_ADDRESS), runs one num_gpus=1 task and prints its checksum,
    its counts and the devices this driver sees."""
    import os

    import ray_tpu_torch

    ray_tpu_torch.init()
    task = ray_tpu_torch.remote(num_gpus=1)(_job_flash_task)
    digest, counts = ray_tpu_torch.get(task.remote(device), timeout=_TUNE_WAIT_S)
    print("JOB_CHECKSUM " + digest)
    print("JOB_COUNTS " + json.dumps(counts))
    print("JOB_DRIVER_VISIBLE " + repr(os.environ.get("CUDA_VISIBLE_DEVICES")))


def _bounded(fn, what, timeout=_TUNE_WAIT_S):
    """``fn()`` within ``timeout`` seconds; its error re-raised."""
    import threading

    box = {}

    def call():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=call, daemon=True, name=what)
    th.start()
    th.join(timeout)
    _check(not th.is_alive(), f"{what} did not finish in {timeout} s")
    if "error" in box:
        raise box["error"]
    return box["value"]


def phase_tune_jobs(shared: dict, device: str = "cuda", small: bool = False):
    """Phase 19: on one cluster, (a) a Tuner over phase 9 (a)'s bf16 GPT-2
    steps (B=8, T=1024, FusedClipAdamW) as a function trainable on half a
    card per trial (with_resources {"gpu": 0.5}), four learning rates, two
    trials at a time, ASHA (max_t 3 reports of 2 steps): no trial error,
    two trials overlapping on device "0", the 3e-4 trial's losses phase
    9's (or the driver's) bit for bit, the best Result's checkpoint loaded
    here equal to the checksum of its last report, each kernel 12 launches
    a step; (b) Tuner(TorchTrainer) over phase 9's loop on a worker of
    half a card, two learning rates, 3 steps: the 3e-4 trial's losses
    phase 9's; (c) a workflow whose GPU step (num_gpus=0.5) returns GPT-2's
    per-row losses as a CUDA tensor, gated by an event the driver
    triggers, whose last step fails once: run raises, resume returns the
    driver's forward bit for bit, the GPU step ran once and its stored
    value loads in a worker without a card; (d) the dashboard, a job
    (JobSubmissionClient) whose num_gpus=1 task prints the driver's flash
    checksum, the cluster's GPU, the trial actors in the state API and
    /api/actors, the job's task in summarize_tasks, /metrics and the
    Grafana JSON. Returns the workers' kernel counts and the row.
    ``small`` (the CPU test): a tiny model at B=2, T=32."""
    import os
    import tempfile
    import threading
    import uuid

    import ray_tpu_torch as rt
    from ray_tpu_torch import train, tune, workflow
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.util import state as us

    t_phase = time.perf_counter()
    row = {"device": device}
    cfg, B, T = _dag_train_setup(small)
    per_step = cfg.n_layers if device == "cuda" else 0
    ref = shared.get("train_backend") or _dag_train_reference(small, device)
    ref_losses = ref["losses"]
    counts = {"launches": dict.fromkeys(_KERNELS, 0), "copies": dict.fromkeys(_COPYING, 0)}
    earlier = _cluster_processes(os.getpid())
    rt.init(object_store_memory=256 << 20, **({} if device == "cuda" else {"num_gpus": 1}))
    pids = set()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        # (a) The Tuner over GPT-2 trials on half a card each.
        t = time.time()
        grid = _bounded(lambda: tune.Tuner(
            tune.with_resources(_tune_trial, {"gpu": 0.5}),
            param_space={"lr": tune.grid_search(list(_TUNE_LRS)), "device": device,
                         "small": small},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=2,
                scheduler=tune.ASHAScheduler(time_attr="training_iteration",
                                             max_t=_TUNE_REPORTS, grace_period=1,
                                             reduction_factor=2)),
            run_config=tune.RunConfig(name="gpt2", storage_path=tmp)).fit(), "(a)'s fit")
        fit_s = time.time() - t
        pids |= _cluster_processes(os.getpid()) - earlier
        _check(grid.num_errors == 0, f"trial errors: {grid.errors}")
        trials = []
        for r in grid:
            m = r.metrics
            n = len(m["losses"])
            trials.append({
                "lr": r.config["lr"], "reports": len(r.metrics_history), "steps": n,
                "losses": m["losses"], "visible": m["visible"], "pid": m["pid"],
                "worker_id": m["worker_id"],
                "cold_start_s": m["fn_start"] - m["proc_start"],
                "started_after_fit_s": m["fn_start"] - t,
                "steps_window": [m["steps_start"] - t, m["steps_end"] - t],
                "step_ms": m["step_ms"],
                "step_ms_median": statistics.median(m["step_ms"][1:] or m["step_ms"]),
                "launches": m["launches"], "checksum": m["checksum"]})
            counts = _add_counts(counts, m)
            _check(m["visible"] == "0", f"trial lr={r.config['lr']} saw {m['visible']!r}")
            want = [n * per_step] * 3 + [0] * 3
            got = [m["launches"][k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                              "flash_fwd_fp32", "flash_bwd_dq_fp32",
                                              "flash_bwd_dkv_fp32")]
            _check(got == want, f"trial lr={r.config['lr']} launched {got}, expected {want}")
        by_lr = {tr["lr"]: tr for tr in trials}
        first = by_lr[3e-4]
        _check(first["losses"] == ref_losses[:first["steps"]],
               f"the 3e-4 trial's losses {first['losses']} are not the driver's "
               f"{ref_losses[:first['steps']]}")
        windows = sorted(tr["steps_window"] for tr in trials)
        overlapped = any(windows[i + 1][0] < windows[i][1] for i in range(len(windows) - 1))
        _check(overlapped, f"no two trials trained at once: {windows}")
        best = grid.get_best_result()
        loaded = train.Checkpoint(best.checkpoint.path).load_pytree(device=device)
        best_ok = _tree_checksum(loaded["params"]) == best.metrics["checksum"]
        del loaded
        row["tune"] = {
            "trials": trials, "fit_s": fit_s, "best_lr": best.config["lr"],
            "best_checkpoint": os.path.basename(best.checkpoint.path),
            "best_checkpoint_equals_last_report": best_ok, "overlapped": overlapped,
            "losses_3e-4_equal_to_driver": True,
            "step_ms_median_phase_5": shared.get("gpt2_bf16_step_ms_median")}
        print("[tune_jobs] tune " + json.dumps(row["tune"]))
        _check(best_ok, "the best Result's checkpoint is not its last report's parameters")

        # (b) Tuner(TorchTrainer): phase 9's loop on a worker of half a card.
        trainer = train.TorchTrainer(
            _dag_train_loop,
            train_loop_config={"small": small, "device": device,
                               "steps": _TUNE_TRAINER_STEPS},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True,
                                               gpus_per_worker=0.5),
            backend_config=train.TorchConfig(device=device, distributed="on",
                                             timeout_s=300))
        t = time.time()
        tgrid = _bounded(lambda: tune.Tuner(
            trainer,
            param_space={"train_loop_config": {
                "lr": tune.grid_search(list(_TUNE_TRAINER_LRS))}},
            tune_config=tune.TuneConfig(metric="loss", mode="min"),
            run_config=tune.RunConfig(name="trainer", storage_path=tmp)).fit(), "(b)'s fit")
        tfit_s = time.time() - t
        pids |= _cluster_processes(os.getpid()) - earlier
        _check(tgrid.num_errors == 0, f"trainer trial errors: {tgrid.errors}")
        tlosses = {r.config["train_loop_config"]["lr"]: r.metrics["losses"] for r in tgrid}
        _check(tlosses[3e-4] == ref_losses[:_TUNE_TRAINER_STEPS],
               f"the 3e-4 trainer trial's losses {tlosses[3e-4]} are not phase 9's "
               f"{ref_losses[:_TUNE_TRAINER_STEPS]}")
        for r in tgrid:
            counts = _add_counts(counts, r.metrics)
            launched = [r.metrics["launches"][k]
                        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
            _check(launched == [_TUNE_TRAINER_STEPS * per_step] * 3,
                   f"a trainer trial's worker launched {launched}")
        row["tune_trainer"] = {"losses": tlosses, "fit_s": tfit_s,
                               "losses_3e-4_equal_to_phase_9": True}
        print("[tune_jobs] tune_trainer " + json.dumps(
            {**row["tune_trainer"], "losses": {str(k): v for k, v in tlosses.items()}}))

        # (c) A workflow with a GPU step, an event gate and a resume.
        os.environ["RAY_TPU_WORKFLOW_DIR"] = os.path.join(tmp, "workflows")
        counter, flag = os.path.join(tmp, "forward_runs"), os.path.join(tmp, "finalize_ok")
        key, wid = f"approve-{uuid.uuid4().hex[:6]}", f"chip-smoke-{uuid.uuid4().hex[:6]}"
        make = rt.remote(_wf_make_batch)
        fwd = rt.remote(num_gpus=0.5, max_retries=0)(_wf_forward_loss)
        fin = rt.remote(max_retries=0)(_wf_finalize)
        dag = fin.bind(fwd.bind(make.bind(small), small, device, counter),
                       workflow.wait_for_event(key, timeout_s=_TUNE_WAIT_S), flag)
        trigger = threading.Timer(1.0, workflow.trigger_event, (key, "approved"))
        trigger.start()
        t_run = time.time()
        try:
            _bounded(lambda: workflow.run(dag, workflow_id=wid), "(c)'s run")
            first_run = "returned"
        except Exception as e:  # noqa: BLE001 — the class name is the outcome
            first_run = type(e).__name__
        run_s = time.time() - t_run
        trigger.join(timeout=30)
        _check(first_run != "returned" and workflow.get_status(wid) == "FAILED",
               f"the first run {first_run}, status {workflow.get_status(wid)}")
        with open(flag, "w"):
            pass
        t = time.time()
        out = _bounded(lambda: workflow.resume(wid), "(c)'s resume")
        resume_s = time.time() - t
        pids |= _cluster_processes(os.getpid()) - earlier
        with open(counter) as f:
            runs = len(f.read())
        with open(counter + ".counts") as f:
            wf_counts = json.load(f)
        counts = _add_counts(counts, wf_counts)
        tokens = _wf_make_batch(small)
        from ray_tpu_torch import models

        params = models.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                    device=device)
        with torch.inference_mode():
            want = _row_losses(params, tokens.to(device), cfg).cpu()
        del params
        store = workflow._Store(wid)
        step = next(n for n in sorted(os.listdir(store.steps_dir)) if "forward_loss" in n)
        stored = rt.get(rt.remote(_load_stored_step).remote(
            os.path.join(store.steps_dir, step)), timeout=_TUNE_WAIT_S)
        row["workflow"] = {
            "first_run": first_run, "status": workflow.get_status(wid), "run_s": run_s,
            "resume_s": resume_s, "forward_step": {
                "worker_started_after_run_s": wf_counts["proc_start"] - t_run,
                "started_after_run_s": wf_counts["started"] - t_run,
                "s": wf_counts["ended"] - wf_counts["started"]},
            "forward_runs": runs, "losses": out["losses"].tolist(),
            "approval": out["approval"], "bitwise_equal_to_driver": torch.equal(
                out["losses"], want),
            "stored_step": {k: v for k, v in stored.items() if k != "value"},
            "launches": wf_counts["launches"]}
        print("[tune_jobs] workflow " + json.dumps(row["workflow"]))
        _check(runs == 1, f"the GPU step ran {runs} times")
        _check(row["workflow"]["bitwise_equal_to_driver"],
               f"the workflow's losses {out['losses'].tolist()} are not the driver's "
               f"{want.tolist()}")
        _check(out["approval"] == "approved" and row["workflow"]["status"] == "SUCCESS",
               f"the gate gave {out['approval']!r}, status {row['workflow']['status']}")
        _check(stored["visible"] == "" and stored["device"] == "cpu"
               and torch.equal(stored["value"], want),
               f"the stored GPU step loaded as {row['workflow']['stored_step']}")
        _check(wf_counts["launches"]["flash_fwd"] == per_step,
               f"the GPU step launched {wf_counts['launches']}")

        # (d) The dashboard, a job on the card, the state API.
        port = start_dashboard()
        try:
            want_digest = _seeded_flash_checksum(device)
            client = JobSubmissionClient()
            t = time.time()
            job = client.submit_job(
                entrypoint=f"{sys.executable} -c \"import chip_smoke; "
                           f"chip_smoke._job_main('{device}')\"")
            status = client.wait_until_finished(job, timeout_s=_TUNE_WAIT_S)
            job_s = time.time() - t
            logs = client.get_job_logs(job)
            pids |= _cluster_processes(os.getpid()) - earlier
            _check(status == "SUCCEEDED", f"the job ended {status}: {logs[-2000:]}")
            _check("JOB_CHECKSUM " + want_digest in logs,
                   f"the job's logs lack the driver's checksum {want_digest}: {logs[-2000:]}")
            job_counts = json.loads(next(line.split(" ", 1)[1] for line in logs.splitlines()
                                         if line.startswith("JOB_COUNTS ")))
            counts = _add_counts(counts, job_counts)
            gpus = _http_json(port, "/api/cluster")[1]["resources_total"].get("GPU")
            # The trial actors by their workers (a function trial runs on a
            # thread of its actor, which has no task context of its own).
            dash_actors = {a["worker_id"] for a in _http_json(port, "/api/actors")[1]["actors"]}
            state_actors = {a["worker_id"] for a in us.list_actors(limit=100000)}
            trial_actors = {tr["worker_id"] for tr in trials}
            summary = us.summarize_tasks().get("_job_flash_task", {})
            import urllib.request

            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
                metrics = r.read().decode()
            code, grafana, _ = _http_json(port, "/api/grafana_dashboard")
            row["jobs"] = {
                "status": status, "job_s": job_s, "checksum": want_digest,
                "job_task_visible": job_counts["visible"],
                "job_driver_visible": next((line.split(" ", 1)[1] for line in logs.splitlines()
                                            if line.startswith("JOB_DRIVER_VISIBLE ")), None),
                "dashboard_gpu_total": gpus,
                "trial_actors_in_state_api": sorted(trial_actors & state_actors) == sorted(
                    trial_actors),
                "trial_actors_in_dashboard": sorted(trial_actors & dash_actors) == sorted(
                    trial_actors),
                "job_task_summary": summary,
                "tasks_finished_in_metrics": "ray_tpu_tasks_finished_total" in metrics,
                "grafana_panels": len(grafana["panels"]), "launches": job_counts["launches"]}
            print("[tune_jobs] jobs " + json.dumps(row["jobs"]))
            _check(gpus == 1, f"/api/cluster shows GPU {gpus}")
            _check(row["jobs"]["trial_actors_in_state_api"]
                   and row["jobs"]["trial_actors_in_dashboard"],
                   "(a)'s trial actors are missing from the state API or /api/actors")
            _check(summary.get("total", 0) >= 1, f"summarize_tasks: {summary}")
            _check(row["jobs"]["tasks_finished_in_metrics"] and code == 200,
                   "/metrics or /api/grafana_dashboard")
            _check(job_counts["visible"] == "0" and job_counts["launches"]["flash_fwd"]
                   == (1 if device == "cuda" else 0),
                   f"the job's task saw {job_counts['visible']!r} and launched "
                   f"{job_counts['launches']}")
        finally:
            stop_dashboard()
    finally:
        rt.shutdown()
        os.environ.pop("RAY_TPU_WORKFLOW_DIR", None)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.time() + 10
    while _live(pids) and time.time() < deadline:
        time.sleep(0.1)
    row["pids_left_after_shutdown"] = _live(pids)
    row["phase_s"] = time.perf_counter() - t_phase
    _check(not row["pids_left_after_shutdown"],
           f"processes left after shutdown(): {row['pids_left_after_shutdown']}")
    print("[tune_jobs] " + json.dumps({k: row[k] for k in ("phase_s",
                                                           "pids_left_after_shutdown")}))
    return {**counts, "row": row}


# The main path's kernels as the kernels line names them: (the wrapper in
# ray_tpu_torch.ops._kernels that launches it, whether it is the fp32
# kernel, the source under ray_tpu_torch/csrc that holds it, the line of
# ray_tpu/ops/attention.py holding the TPU kernel it replaces). Each
# wrapper sends bf16/fp16 to a wgmma kernel and fp32 to a kernel of its
# own (on the tensor cores in 3xTF32), and counts its fp32 launches apart
# (``launches_fp32``).
_KERNELS = {
    "flash_fwd": ("flash_fwd", False, "flash_fwd.cu", 144),
    "flash_fwd_fp32": ("flash_fwd", True, "flash_fwd.cu", 144),
    "flash_bwd_dq": ("flash_bwd_dq", False, "flash_bwd_dq.cu", 298),
    "flash_bwd_dq_fp32": ("flash_bwd_dq", True, "flash_bwd.cu", 298),
    "flash_bwd_dkv": ("flash_bwd_dkv", False, "flash_bwd_dkv.cu", 332),
    "flash_bwd_dkv_fp32": ("flash_bwd_dkv", True, "flash_bwd.cu", 332),
}
# The wrappers of the TMA kernels: each counts the inputs it copies, and
# the main path must copy none.
_COPYING = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _launch_counts() -> dict:
    """The launches of each kernel of _KERNELS since its wrapper's counts
    were last set to 0."""
    from ray_tpu_torch.ops import _kernels

    counts = {}
    for name, (wrapper, fp32, _, _) in _KERNELS.items():
        w = getattr(_kernels, wrapper)
        counts[name] = w.launches_fp32 if fp32 else w.launches - w.launches_fp32
    return counts


def _case(rows, shape, dtype):
    """The causal phase-2 row at ``shape`` in ``dtype``."""
    return next(r for r in rows
                if r["shape"] == shape and r["dtype"] == dtype and r["causal"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_setup()
    fwd_rows = phase_kernels(card)
    fwd_row = _case(fwd_rows, [4, 1024, 1024, 12, 64], "float32")  # GPT-2 124M's
    _check(_forward_no_slower_than_library(fwd_row),
           f"the fp32 forward kernel ({fwd_row['ms']} ms) is slower than SDPA's fp32 "
           f"forward ({fwd_row['library_ms']} ms) at GPT-2 124M's shape")
    bwd_rows = phase_kernels_bwd(card)
    bwd_row = _case(bwd_rows, [8, 1024, 1024, 12, 64], "bfloat16")  # GPT-2 124M's
    _check(bwd_row["ms_dkv"] <= bwd_row["library_ms"],
           f"the dK/dV kernel ({bwd_row['ms_dkv']} ms) is slower than SDPA's whole "
           f"backward ({bwd_row['library_ms']} ms) at GPT-2 124M's training shape")
    bwd_row = _case(bwd_rows, [8, 1024, 1024, 12, 64], "float32")
    _check(_pair_no_slower_than_library(bwd_row),
           f"the fp32 dQ + dK/dV kernels ({bwd_row['ms_dq']} + {bwd_row['ms_dkv']} ms) "
           f"are slower than SDPA's fp32 backward ({bwd_row['library_ms']} ms) at "
           f"GPT-2 124M's training shape")

    from ray_tpu_torch.ops import _kernels

    wrappers = [getattr(_kernels, name) for name in _COPYING]

    def inference(fn):
        def run():
            with torch.inference_mode():
                fn()
        return run

    # Each path of the main path with the counts set to 0 just before it
    # and read just after; the paths that train must launch every kernel
    # (they take fp32 and bf16 steps). The ranks of phases 7, 9 and 13 and
    # the workers of phase 14 count their own launches and copies, which
    # the phase returns, and they are added.
    shared = {}
    paths = (("forward", inference(phase_forward), False),
             ("serve", inference(lambda: phase_serve(shared)), False),
             ("train", lambda: phase_train(shared), True),
             ("moe", lambda: phase_moe(card), True),
             ("parallel", lambda: phase_parallel(shared), True),
             ("llm", inference(lambda: phase_llm(shared)), False),
             ("train_backend", lambda: phase_train_backend(shared), True),
             ("llm_parallel", lambda: phase_llm_parallel(shared), False),
             ("async_llm", lambda: phase_async_llm(shared), False),
             ("rllib", lambda: phase_rllib(shared), False),
             ("rllib_more", lambda: phase_rllib_more(shared), False),
             ("runtime", lambda: phase_runtime(shared), False),
             ("dag", lambda: phase_dag(shared), False),
             ("serve_apps", lambda: phase_serve_apps(shared), False),
             ("rllib_remote", lambda: phase_rllib_remote(shared), False),
             ("data", lambda: phase_data(shared), False),
             ("tune_jobs", lambda: phase_tune_jobs(shared), False))
    launches = dict.fromkeys(_KERNELS, 0)
    for name, run, must_launch in paths:
        for w in wrappers:
            w.launches = w.launches_fp32 = w.copies = 0
        result = run()
        total = {"launches": _launch_counts(),
                 "copies": {w.__name__: w.copies for w in wrappers}}
        if name in ("parallel", "train_backend", "rllib_more", "runtime", "dag",
                    "serve_apps", "rllib_remote", "data", "tune_jobs"):
            total = _add_counts(total, result)
        counted, copies = total["launches"], total["copies"]
        print(f"[{name}] launches " + json.dumps(counted))
        for kname, n in counted.items():
            _check(n > 0 or not must_launch, f"the {name} path never launched {kname}")
            launches[kname] += n
        for wname, n in copies.items():
            _check(n == 0, f"{wname} copied {n} inputs on the {name} path")
    for kname, n in launches.items():
        _check(n > 0, f"the main path never launched {kname}")
    # Per kernel, from phase 2 at GPT-2 124M's shapes (forward B=4,
    # backward B=8; T=1024, causal) in the kernel's type: (max abs error,
    # ms, bound ms, bound by, plain ms, library ms). The backward pair
    # shares one plain time and one library time, SDPA's backward for the
    # same dO.
    numbers = {}
    for kname, (wrapper, fp32, _, _) in _KERNELS.items():
        dtype = "float32" if fp32 else "bfloat16"
        if wrapper == "flash_fwd":
            r = _case(fwd_rows, [4, 1024, 1024, 12, 64], dtype)
            err, key = r["max_abs_err"], ""
        else:
            r = _case(bwd_rows, [8, 1024, 1024, 12, 64], dtype)
            key = "_dq" if wrapper == "flash_bwd_dq" else "_dkv"
            err = max(r["errors"][g]["max_abs_err"]
                      for g in (("dq",) if key == "_dq" else ("dk", "dv")))
        numbers[kname] = (err, r["ms" + key], r["bound_ms" + key], r["bound_by" + key],
                          r["plain_ms"], r["library_ms"])
    summary = {"kernels": []}
    for kname, (_, _, source, line) in _KERNELS.items():
        err, ms, bound_ms, bound_by, plain_ms, library_ms = numbers[kname]
        summary["kernels"].append({
            "name": kname, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{source}",
            "replaces": f"ray_tpu/ops/attention.py:{line}",
            "launches": launches[kname], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by.split()[0],  # "bytes" or "operations"
            "library_ms": library_ms})
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # Run as the module ``chip_smoke``, not as ``__main__``: phase 14's
    # workers then import its task and actor classes by reference, where
    # cloudpickle would copy ``__main__``'s by value (and torch's backend
    # modules, which they reach, cannot be copied).
    import chip_smoke

    sys.exit(chip_smoke.main())
