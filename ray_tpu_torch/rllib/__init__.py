"""RLlib's on-policy family for the port: PPO (a learner on the card,
rollout workers as CPU actors), IMPALA, APPO and DDPPO.

Exports only what is ported.  The off-policy family (replay buffers,
DQN, SAC, TD3/DDPG), multi-agent, ES, offline I/O and the policy server
of the JAX package's `rllib/` are later slices (ROADMAP, Queue 1).
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, PPO  # noqa: F401
from ray_tpu_torch.rllib.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.ddppo import DDPPO, DDPPOConfig  # noqa: F401
from ray_tpu_torch.rllib.env import (  # noqa: F401
    PendulumEnv,
    SyncVectorEnv,
    SyntheticPixelEnv,
    VectorEnv,
    make_vector_env,
)
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rllib.models import (  # noqa: F401
    CNNModel,
    GaussianMLPModel,
    MLPModel,
    get_model,
)
from ray_tpu_torch.rllib.policy import TorchPolicy  # noqa: F401
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker  # noqa: F401
from ray_tpu_torch.rllib.sample_batch import SampleBatch  # noqa: F401
