"""Train's trainer and the GPU leases it runs on (ray_tpu_torch.train.
TorchTrainer on the task/actor core, CPU only: the "GPU" resource is
counted, no CUDA is called). One cluster, init(num_cpus=4, num_gpus=1):

- fractional leases: two num_gpus=0.5 actors run at once, both pinned to
  the one device (CUDA_VISIBLE_DEVICES="0"); a third waits until one of
  them is killed; a request over 1 that is not whole is refused;
- ScalingConfig(use_gpu=True) asks for "GPU" and its worker schedules;
- two gloo workers of a tiny GPT-2, half the batch each: their averaged
  gradients within 1e-5 of each leaf's max of the whole batch's.

JaxTrainer's machinery (reports, iterations, checkpoints, restarts,
Result) is held against TorchTrainer's in tests/test_torch_dag_parity.py.
Every get and fit is bounded."""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train

T = 60


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=4, num_gpus=1, object_store_memory=64 * 1024 * 1024)
    yield
    rt.shutdown()


def _fit(trainer, timeout=120):
    """trainer.fit() within ``timeout`` seconds (a worker that never
    schedules fails the test instead of hanging it)."""
    box = {}

    def run():
        try:
            box["result"] = trainer.fit()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"fit did not finish in {timeout} s"
    if "error" in box:
        raise box["error"]
    return box["result"]


@rt.remote(num_gpus=0.5)
class Half:
    def visible(self, hold=0.0):
        started = time.time()
        time.sleep(hold)
        return os.environ.get("CUDA_VISIBLE_DEVICES"), started


def test_fractional_gpu_leases_share_a_device():
    a, b = Half.remote(), Half.remote()
    (va, ta), (vb, tb) = rt.get([a.visible.remote(1.0), b.visible.remote(1.0)], timeout=T)
    assert va == vb == "0"
    assert abs(ta - tb) < 1.0  # both held the device at once
    c = Half.remote()
    ref = c.visible.remote()
    done, _ = rt.wait([ref], timeout=3.0)
    assert done == []  # the card's two halves are taken
    rt.kill(a)
    assert rt.get(ref, timeout=T)[0] == "0"
    for h in (b, c):
        rt.kill(h)
    with pytest.raises(ValueError, match="whole number"):
        Half.options(num_gpus=1.5)

    @rt.remote
    def f():
        return 1

    with pytest.raises(ValueError, match="whole number"):
        f.options(resources={"GPU": 2.5}).remote()
    with pytest.raises(ValueError, match="whole number"):
        rt.remote(num_gpus=1.25)(f._fn).remote()


def _report_visible(config):
    train.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "world": train.get_context().get_world_size()})


def test_use_gpu_worker_schedules_on_one_gpu(tmp_path):
    scaling = train.ScalingConfig(use_gpu=True)
    assert scaling.worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    result = _fit(train.TorchTrainer(
        _report_visible, scaling_config=scaling,
        run_config=train.RunConfig(name="gpu", storage_path=str(tmp_path)),
        backend_config=train.TorchConfig(device="cpu")))
    assert result.metrics == {"visible": "0", "world": 1, "training_iteration": 0}
    assert result.error is None and result.checkpoint is None


def _tiny():
    from ray_tpu_torch import models

    return dataclasses.replace(models.tiny(vocab_size=128, max_seq_len=32),
                               dtype="float32")


def _batch():
    rng = np.random.default_rng(3)
    return {"tokens": torch.from_numpy(rng.integers(0, 128, (4, 17)))}


def _dp_grads(config):
    """Rank r's half of the batch, gradients averaged over the group."""
    from ray_tpu_torch import models
    from ray_tpu_torch.models.transformer import loss_and_grads
    from ray_tpu_torch.ops.tree import tree_leaves, tree_unflatten
    from ray_tpu_torch.train import torch_utils

    cfg = _tiny()
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    params = models.init_params(torch.Generator().manual_seed(rank), cfg, device="cpu")
    params = torch_utils.sync_model_params(params)  # rank 0's everywhere
    tokens = _batch()["tokens"]
    half = tokens[rank * len(tokens) // world:(rank + 1) * len(tokens) // world]
    _, grads = loss_and_grads(params, {"tokens": half}, cfg)
    grads = torch_utils.allreduce_gradients(tree_unflatten(params, grads))
    # The whole batch's gradients, here on rank 0's params; reported as
    # one scalar pair per leaf (a large report would meet the open
    # inline-argument fault of ROADMAP.md §3).
    _, whole = loss_and_grads(params, {"tokens": tokens}, cfg)
    train.report({"max_diff": [(g - w).abs().max().item()
                               for g, w in zip(tree_leaves(grads), whole)],
                  "max_whole": [w.abs().max().item() for w in whole],
                  "rank": rank, "world": world})


def test_two_gloo_workers_average_the_whole_batch_gradients(tmp_path):
    result = _fit(train.TorchTrainer(
        _dp_grads, scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="dp", storage_path=str(tmp_path)),
        backend_config=train.TorchConfig(device="cpu")))
    m = result.metrics
    assert m["world"] == 2 and m["rank"] == 0 and len(m["max_diff"]) > 10
    for diff, peak in zip(m["max_diff"], m["max_whole"]):
        assert diff <= 1e-5 * peak
    # the attempt's rendezvous file is gone with its workers
    assert not [f for f in os.listdir(tmp_path / "dp") if f.startswith(".rendezvous")]
