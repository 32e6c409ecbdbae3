"""RLlib for the port: every algorithm of the JAX package's `rllib/`.

The on-policy family (PPO, IMPALA, APPO, DDPPO), the off-policy family
from replay buffers (DQN, SAC, TD3, DDPG), multi-agent PPO, ES, offline
JSON I/O and the policy server.  Learners live in the driver on
`AlgorithmConfig.learner_device` ("cuda" by default: they raise without a
card); rollout workers are CPU actors.  `TorchPolicy` takes the place of
the JAX package's `JaxPolicy`.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, PPO  # noqa: F401
from ray_tpu_torch.rllib.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.ddppo import DDPPO, DDPPOConfig  # noqa: F401
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNPolicy, DQNWorker  # noqa: F401
from ray_tpu_torch.rllib.env import (  # noqa: F401
    PendulumEnv,
    SyncVectorEnv,
    SyntheticPixelEnv,
    VectorEnv,
    make_vector_env,
)
from ray_tpu_torch.rllib.es import ES, ESConfig  # noqa: F401
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rllib.models import (  # noqa: F401
    CNNModel,
    GaussianMLPModel,
    MLPModel,
    get_model,
)
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.offline import JsonReader, JsonWriter  # noqa: F401
from ray_tpu_torch.rllib.policy import TorchPolicy  # noqa: F401
from ray_tpu_torch.rllib.policy_server import PolicyClient, PolicyServer  # noqa: F401
from ray_tpu_torch.rllib.replay_buffer import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker  # noqa: F401
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACPolicy, SACWorker  # noqa: F401
from ray_tpu_torch.rllib.sample_batch import SampleBatch  # noqa: F401
from ray_tpu_torch.rllib.td3 import (  # noqa: F401
    DDPG,
    DDPGConfig,
    TD3,
    TD3Config,
    TD3Policy,
)
