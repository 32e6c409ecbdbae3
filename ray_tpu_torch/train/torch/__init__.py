from ray_tpu_torch.train.torch.config import TorchConfig  # noqa: F401
from ray_tpu_torch.train.torch.step_probe import StepProbe  # noqa: F401
from ray_tpu_torch.train.torch.train_loop_utils import (  # noqa: F401
    all_reduce_gradients,
    get_data_shard,
    local_mesh,
)
