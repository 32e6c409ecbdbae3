"""Continuous-batching LLM inference engine (iteration-level scheduling,
paged KV cache, dag-channel token streaming): the port of
`ray_tpu/serve/engine/`.  The scheduler, cache bookkeeping and transport
are the reference's; the device programs are `models/llama.py`'s paged
programs in PyTorch, built by `ShardedLLM.engine_programs`."""

from ray_tpu_torch.exceptions import EngineOverloadedError, EngineStreamError  # noqa: F401
from ray_tpu_torch.serve.engine.kv_cache import PageAllocator, PagedKVCache  # noqa: F401
from ray_tpu_torch.serve.engine.loop import (  # noqa: F401
    BufferSink,
    EngineConfig,
    InferenceEngine,
)
from ray_tpu_torch.serve.engine.scheduler import EngineRequest, EngineScheduler  # noqa: F401
