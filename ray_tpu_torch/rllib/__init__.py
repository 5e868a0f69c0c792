"""ray_tpu_torch.rllib: reinforcement learning (port of ray_tpu.rllib).

The env runner steps vectorized envs on the host with one batched policy
forward on the module's device per vector step; the learner runs its
update (autograd, then the optax-style optimizer, in place) on that
device, or over a ``data`` DeviceMesh with the minibatch sharded over its
ranks (``learners(mesh=...)``). Algorithms are Trainables
(``ray_tpu_torch.tune``): PPO (single- and multi-agent), DQN, SAC, BC,
MARWIL, CQL, DreamerV3, IMPALA and APPO train end to end. Env runners
may be remote actors of the port's core (``num_env_runners > 0``: CPU
actors, modules on the CPU), which IMPALA and APPO sample from
asynchronously; learners may be remote actors too (``num_learners >
0``: each updates on its shard of the batch, holding a GPU lease when
its device is CUDA, and the group averages their weights on the
host)."""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig, vtrace
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.connectors import (
    ClipRewards,
    ConnectorPipelineV2,
    ConnectorV2,
    FlattenObservations,
    LambdaConnector,
    NormalizeObservations,
)
from ray_tpu_torch.rllib.core.learner import LearnerGroup, TorchLearner
from ray_tpu_torch.rllib.core.rl_module import (
    DiscreteActorCriticModule,
    RLModule,
    RLModuleSpec,
)
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup, SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.multi_agent import (
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentEnvRunnerGroup,
    shared_policy_mapping_fn,
)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae

__all__ = [
    "APPO",
    "APPOConfig",
    "Algorithm",
    "AlgorithmConfig",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "DQN",
    "DQNConfig",
    "DreamerV3",
    "DreamerV3Config",
    "MARWIL",
    "MARWILConfig",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "MultiAgentEnvRunnerGroup",
    "ReplayBuffer",
    "SAC",
    "SACConfig",
    "ClipRewards",
    "ConnectorPipelineV2",
    "ConnectorV2",
    "FlattenObservations",
    "LambdaConnector",
    "NormalizeObservations",
    "DiscreteActorCriticModule",
    "EnvRunnerGroup",
    "IMPALA",
    "IMPALAConfig",
    "TorchLearner",
    "LearnerGroup",
    "PPO",
    "PPOConfig",
    "RLModule",
    "RLModuleSpec",
    "SampleBatch",
    "SingleAgentEnvRunner",
    "compute_gae",
    "shared_policy_mapping_fn",
    "vtrace",
]
