"""Package rules of the PyTorch port (ray_tpu_torch): it imports neither
JAX nor anything of ray_tpu, and its entry points run on the card unless
the caller asks for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch import data, interop, models, parallel, rllib, train
from ray_tpu_torch.llm import (LLMConfig, LLMEngine, LLMPredictor, LLMServer, kv_pages, lora,
                               model_runner)
from ray_tpu_torch.ops import layers
from ray_tpu_torch.ops.optim import FusedClipAdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ray_tpu_torch
CORE = ("ids", "serialization", "shm_store", "external_storage", "dataplane",
        "bulk_transfer", "objcensus", "config", "native_build", "wirefmt",
        "task_spec", "retry", "evloop", "rpc", "faultinject", "scheduler",
        "native_sched", "resource_syncer", "gcs", "gcs_store",
        "gcs_persistence", "head_shards", "runtime", "worker",
        "worker_context", "direct", "node_agent", "zygote", "runtime_env",
        "hermetic", "cgroup", "memory_monitor", "events", "traceplane",
        "profplane", "alertplane", "tsdb", "forensics", "lockwitness",
        "log_monitor", "log_utils", "usage_stats")
names = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                               "ray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
missing = sorted(({"ray_tpu_torch.ops.moe", "ray_tpu_torch.ops.optim",
                  "ray_tpu_torch.ops.ring_attention", "ray_tpu_torch.parallel._spawn",
                  "ray_tpu_torch.parallel.multislice", "ray_tpu_torch.llm.kv_pages",
                  "ray_tpu_torch.llm.lora", "ray_tpu_torch.llm.guided",
                  "ray_tpu_torch.llm.pp_runner", "ray_tpu_torch.train",
                  "ray_tpu_torch.train.backend", "ray_tpu_torch.train.checkpoint",
                  "ray_tpu_torch.train.config", "ray_tpu_torch.train.session",
                  "ray_tpu_torch.train.torch_utils", "ray_tpu_torch.exceptions",
                  "ray_tpu_torch.tune", "ray_tpu_torch.tune.trainable",
                  "ray_tpu_torch.rllib", "ray_tpu_torch.rllib.sample_batch",
                  "ray_tpu_torch.rllib.replay_buffer", "ray_tpu_torch.rllib.connectors",
                  "ray_tpu_torch.rllib.core.rl_module", "ray_tpu_torch.rllib.core.learner",
                  "ray_tpu_torch.rllib.env.env_runner",
                  "ray_tpu_torch.rllib.algorithms.algorithm",
                  "ray_tpu_torch.rllib.algorithms.ppo", "ray_tpu_torch.rllib.algorithms.dqn",
                  "ray_tpu_torch.rllib.algorithms.sac", "ray_tpu_torch.rllib.algorithms.bc",
                  "ray_tpu_torch.rllib.algorithms.marwil", "ray_tpu_torch.rllib.algorithms.cql",
                  "ray_tpu_torch.rllib.algorithms.impala",
                  "ray_tpu_torch.rllib.algorithms.appo",
                  "ray_tpu_torch.rllib.algorithms.dreamerv3",
                  "ray_tpu_torch.rllib.env.multi_agent"}
                 | {"ray_tpu_torch._private." + m for m in CORE}
                 | {"ray_tpu_torch." + m for m in (
                     "api", "actor", "remote_function", "generator",
                     "accelerators", "accelerators.accelerator",
                     "accelerators.cuda", "util", "util.placement_group",
                     "util.scheduling_strategies", "util.serialization",
                     "util.tracing", "util.actor_pool", "util.queue",
                     "util.collective", "dag", "dag.nodes", "dag.channel_exec",
                     "dag.collective_node", "experimental", "experimental.channel",
                     "experimental.tcp_channel", "experimental.device_channel",
                     "train.worker_group", "train.trainer", "util.metrics",
                     "serve", "serve.api", "serve.batching", "serve.controller",
                     "serve.deployment", "serve.grpc_proxy", "serve.handle",
                     "serve.multiplex", "serve.proxy", "serve.replica",
                     "serve.scheduler", "llm.serving", "llm.batch", "data",
                     "data.block", "data.datasource", "data.executor",
                     "data.actor_pool", "data.dataset", "data.preprocessors",
                     "tune.search", "tune.schedulers", "tune.tuner", "workflow",
                     "util.state", "util.metrics_export", "job_submission",
                     "dashboard")})
                 - set(sys.modules))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ray_tpu"
             or m.startswith("ray_tpu."))
print(len(names), missing, bad)
"""


def test_import_pulls_in_neither_jax_nor_ray_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, missing, bad = out.stdout.split(" ", 2)
    assert int(n_modules) >= 154
    assert missing == "[]"  # the MoE ops, the optimizers, the parallel slice,
    # the LLM plane's paged KV, LoRA, guided and pipeline modules, the
    # Train backend, RLlib (multi-agent and DreamerV3 too), Tune's
    # Trainable, the exceptions and the task/actor core (_private, the
    # API, the accelerator managers, util), the DAGs and their channels, util.collective,
    # the trainer, Serve, util.metrics, the LLM's serving deployments, Data,
    # the LLM's batch stage, Tune, Workflow, the state API, the metrics
    # exporter, job submission and the dashboard were imported
    assert bad.strip() == "[]"


ENTRY_POINTS = {
    "init_params": lambda: models.init_params(torch.Generator(), models.tiny()),
    "init_kv_cache": lambda: models.init_kv_cache(models.tiny(), 1, 8),
    "init_train_state": lambda: models.init_train_state(
        torch.Generator(), models.tiny(), FusedClipAdamW()),
    "init_slot_cache": lambda: model_runner.init_slot_cache(models.tiny(), 1, 8),
    "init_page_pool": lambda: kv_pages.init_page_pool(models.tiny(), 2, 4),
    "LoRAManager": lambda: lora.LoRAManager(1, {"wq": (4, 4)}),
    "rope_frequencies": lambda: layers.rope_frequencies(8, 4),
    "params_from_jax": lambda: interop.params_from_jax({"w": np.zeros(2)}),
    "LLMEngine": lambda: LLMEngine(LLMConfig(model="tiny")),
    "LLMServer": lambda: LLMServer(LLMConfig(model="tiny")),
    "LLMPredictor": lambda: LLMPredictor(LLMConfig(model="tiny")),
    "Dataset.iter_torch_batches": lambda: next(data.range(4).iter_torch_batches()),
    "MeshConfig.build": lambda: parallel.MeshConfig().build(),
    "TorchBackend.on_worker_setup": lambda: train.TorchBackend().on_worker_setup(
        0, 1, "g", train.TorchConfig(distributed="on")),
    "load_pytree": lambda: _load_saved_tree(),
    "RLModuleSpec.build": lambda: rllib.RLModuleSpec(4, 2).build(),
    "BCConfig.build": lambda: rllib.BCConfig().offline(
        {"obs": np.zeros((4, 4), np.float32), "actions": np.zeros(4, np.int64)}
    ).environment(observation_dim=4, action_dim=2).build(),
    "DreamerV3Config.build": lambda: rllib.DreamerV3Config().environment(
        observation_dim=4, action_dim=2).build(),
    "PPOConfig.multi_agent.build": lambda: rllib.PPOConfig().environment(
        _TwoAgents).multi_agent(policies=["a0", "a1"],
                                policy_mapping_fn=lambda agent, i=0, **kw: agent).build(),
}


class _TwoAgents(rllib.MultiAgentEnv):
    possible_agents = ["a0", "a1"]
    observation_dims = {"a0": 3, "a1": 3}
    action_dims = {"a0": 2, "a1": 2}

    def reset(self, seed=None):
        return {a: np.zeros(3, np.float32) for a in self.possible_agents}, {}


def _load_saved_tree():
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), "state")
    train.save_pytree({"w": torch.zeros(2)}, path)
    return train.load_pytree(path)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(entry):
    """Called without device=, an entry point targets the card; on a
    machine with no CUDA it fails where torch fails instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default succeeds")
    with pytest.raises((RuntimeError, AssertionError)):
        ENTRY_POINTS[entry]()


def test_package_docstrings_name_what_is_ported():
    """The package and the LLM plane say that Serve and the serving
    deployments are here (no longer a later slice), and util names its
    metrics; the package names Data, the LLM plane its batch stage, and
    RLlib its remote groups (no item still waited for); Tune, Workflow and
    util's state API and exporter are named as ported."""
    import ray_tpu_torch
    from ray_tpu_torch import llm, util

    assert "Serve" in ray_tpu_torch.__doc__ and "serve" in ray_tpu_torch._LAZY
    assert "Data" in ray_tpu_torch.__doc__ and "data" in ray_tpu_torch._LAZY
    assert "item 6e" not in llm.__doc__ and "build_llm_processor" in llm.__doc__
    assert {"LLMPredictor", "build_llm_processor"} <= set(llm.__all__)
    assert "item 7" not in rllib.__doc__ and "num_env_runners > 0" in rllib.__doc__
    # the engine builds tensor- and pipeline-parallel runners (since PR 10)
    assert "NotImplementedError" not in llm.config.__doc__
    assert "TensorParallel" in llm.config.__doc__ and "PPRunner" in llm.config.__doc__
    assert "later slices" not in llm.__doc__ and "LLMServer" in llm.__doc__
    assert {"LLMServer", "build_openai_app", "build_disaggregated_app"} <= set(llm.__all__)
    assert "util.metrics" in util.__doc__
    # Tune, Workflow, the state API and the exporter are here (item 6f and
    # 6g's first part): the docstrings no longer send them to a later item
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import trainable

    assert "workflow" in ray_tpu_torch._LAZY
    assert "6f" not in tune.__doc__ and "runtime core" not in tune.__doc__
    assert "6f" not in trainable.__doc__ and "TrialActor" in trainable.__doc__
    assert {"Tuner", "TuneConfig", "ASHAScheduler", "with_resources", "report",
            "RunConfig"} <= set(tune.__all__)
    assert "util.state" in util.__doc__ and "util.metrics_export" in util.__doc__
    assert "the state API" not in util.__doc__.split("waits")[-1]
