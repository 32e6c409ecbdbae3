"""Training result (analog: reference python/ray/air/result.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint
