"""Backend interface: per-framework worker-group setup.

Analog of the reference's Backend/BackendConfig (reference:
python/ray/train/backend.py:27 BackendConfig, :40 Backend — on_start /
on_shutdown hooks run by BackendExecutor).
"""

from __future__ import annotations

from typing import Any


class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    def __init__(self, config: BackendConfig):
        self.config = config

    def on_start(self, worker_group, backend_config):
        pass

    def on_shutdown(self, worker_group, backend_config):
        pass
