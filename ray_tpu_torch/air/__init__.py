from ray_tpu_torch.air.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig  # noqa: F401
from ray_tpu_torch.air import session  # noqa: F401
from ray_tpu_torch.air.result import Result  # noqa: F401
