"""Training session facade: what user train loops call.

Analog of the reference's air.session (reference: python/ray/air/session.py
report/get_world_size/get_world_rank/get_checkpoint backed by the
per-worker _TrainSession, python/ray/train/_internal/session.py:58).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_session_local = threading.local()


def _get_session():
    s = getattr(_session_local, "session", None)
    if s is None:
        raise RuntimeError(
            "session.* can only be called inside a train loop started by a Trainer"
        )
    return s


def _set_session(session):
    _session_local.session = session


def report(metrics: Dict[str, Any], *, checkpoint=None) -> None:
    """Stream metrics (and optionally a checkpoint) to the driver
    (reference: session.report → _TrainSession queue :295)."""
    _get_session().report(metrics, checkpoint)


def get_world_size() -> int:
    return _get_session().world_size


def get_world_rank() -> int:
    return _get_session().world_rank


def get_local_rank() -> int:
    return _get_session().local_rank


def get_checkpoint():
    return _get_session().loaded_checkpoint


def get_trial_name() -> str:
    return getattr(_get_session(), "trial_name", "default")
