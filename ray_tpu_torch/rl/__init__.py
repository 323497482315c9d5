"""ray_tpu_torch.rl — the RL stack (new-API shape: EnvRunner/Learner/RLModule).

Counterpart of ``ray_tpu.rl``, with the JAX learners and modules named
as RLlib names its torch ones (``TorchRLModule``, ``PPOTorchLearner``,
``ImpalaTorchLearner``, ``DQNTorchLearner``, ``SACTorchLearner``,
``BCTorchLearner``, ``MultiTorchRLModule``).  Role-equivalent to the
reference's RLlib new API stack (ref: SURVEY.md §2.4 — Algorithm over
EnvRunnerGroup + LearnerGroup; the legacy policy/evaluation stack is
intentionally not replicated).  Learners run on the card unless given
``device="cpu"``; env runners run their module on the CPU.
"""

from .actor_manager import FaultTolerantActorManager  # noqa: F401
from .algorithm import PPO, AlgorithmConfig  # noqa: F401
from .connectors import (ClipActions, ConnectorPipelineV2,  # noqa
                         ConnectorV2, FlattenObs, NormalizeObs,
                         RescaleActions)
from .offline import (BC, BCConfig, BCTorchLearner, OfflineData,  # noqa
                      record_rollouts)
from .sac import (SAC, SACConfig, SACEnvRunner, SACTorchLearner,  # noqa
                  SACTrainConfig, ContinuousModuleSpec,
                  ContinuousReplayBuffer)
from .dqn import (DQN, DQNConfig, DQNEnvRunner, DQNTorchLearner,  # noqa
                  DQNTrainConfig, ReplayBuffer)
from .env_runner import EnvRunnerGroup, SingleAgentEnvRunner  # noqa
from .impala import (IMPALA, Aggregator, ImpalaTorchLearner,  # noqa
                     IMPALAConfig, VTraceConfig)
from .learner import LearnerGroup, PPOConfig, PPOTorchLearner  # noqa
from .multi_agent import (MultiAgentConfig, MultiAgentEnv,  # noqa
                          MultiAgentEnvRunner,
                          MultiAgentEnvRunnerGroup, MultiAgentPPO,
                          MultiTorchRLModule, MultiRLModuleSpec)
from .rl_module import RLModuleSpec, TorchRLModule  # noqa: F401
