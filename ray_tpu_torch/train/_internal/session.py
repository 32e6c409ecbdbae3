"""Per-worker train session: runs the user loop in a thread, queues reports.

Analog of the reference's _TrainSession (reference:
python/ray/train/_internal/session.py:58 — training thread :272, report
queue :295).  The driver polls `next_report()` on every worker actor to
collect synchronized report rounds.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import Checkpoint


class TrainSession:
    def __init__(
        self,
        train_loop: Callable,
        config: Dict[str, Any],
        world_rank: int,
        world_size: int,
        loaded_checkpoint: Optional[Checkpoint] = None,
    ):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = world_rank  # single-node-per-worker for now
        self.loaded_checkpoint = loaded_checkpoint
        self._queue: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

        def _run():
            import inspect

            air_session._set_session(self)
            try:
                takes_config = len(inspect.signature(train_loop).parameters) >= 1
                if takes_config:
                    train_loop(config)
                else:
                    train_loop()
            except BaseException as e:  # noqa: BLE001
                self._error = e
                self._queue.put(("error", f"{e}\n{traceback.format_exc()}"))
            finally:
                self._done.set()
                self._queue.put(("done", None))

        self._thread = threading.Thread(target=_run, daemon=True, name="train-loop")
        self._thread.start()

    def report(self, metrics: Dict[str, Any], checkpoint=None):
        payload = dict(metrics)
        ckpt_data = None
        if checkpoint is not None:
            ckpt_data = checkpoint.to_dict() if isinstance(checkpoint, Checkpoint) else checkpoint
        self._queue.put(("report", (payload, ckpt_data)))

    def next_report(self, timeout: float = 300.0):
        """Blocking: the next (kind, payload) event for the driver."""
        try:
            kind, payload = self._queue.get(timeout=timeout)
        except queue.Empty:
            return ("pending", None)
        return (kind, payload)

    def finished(self) -> bool:
        return self._done.is_set()
