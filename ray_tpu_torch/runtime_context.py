"""Runtime context: who am I, where am I running.

Analog of the reference's ray.runtime_context
(reference: python/ray/runtime_context.py get_runtime_context()).
"""

from __future__ import annotations

from typing import Optional


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    @property
    def job_id(self):
        return self._worker.core_worker.job_id

    @property
    def node_id(self) -> Optional[bytes]:
        return self._worker.core_worker.node_id

    @property
    def worker_id(self):
        return self._worker.core_worker.worker_id

    @property
    def task_id(self) -> Optional[bytes]:
        return self._worker.core_worker.current_task_id

    @property
    def address_info(self) -> dict:
        return {"address": self._worker.address, "session_dir": self._worker.session_dir}

    def get_node_id(self) -> str:
        nid = self.node_id
        return nid.hex() if nid else ""

    def get_job_id(self) -> str:
        return self.job_id.hex()

    def get(self) -> dict:
        return {
            "job_id": self.job_id,
            "node_id": self.node_id,
            "worker_id": self.worker_id,
        }


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch._private import worker as worker_mod

    worker_mod._require_connected()
    return RuntimeContext(worker_mod.global_worker)
