"""Public exception hierarchy.

Mirrors the reference's user-visible error taxonomy
(reference: python/ray/exceptions.py — RayError, RayTaskError,
RayActorError, ObjectLostError, GetTimeoutError, …) so code written against
the reference maps one-to-one.
"""

from __future__ import annotations

import traceback


class RayError(Exception):
    """Base class for all framework errors."""


def _tail_block(log_tail: list) -> str:
    """Render a victim's captured log tail for an error message."""
    if not log_tail:
        return ""
    body = "\n".join(f"    {ln}" for ln in log_tail)
    return f"\nLast {len(log_tail)} log line(s) from the worker:\n{body}"


class RayTaskError(RayError):
    """A task raised an exception; the traceback is carried to the caller.

    Stored *as the value* of the task's return objects so that `get` on any
    downstream consumer re-raises it (same contagion semantics as the
    reference: python/ray/exceptions.py RayTaskError.as_instanceof_cause).
    """

    def __init__(
        self,
        function_name: str,
        traceback_str: str,
        cause: Exception | None = None,
        log_tail: list | None = None,
    ):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        # crash forensics (util/OBSERVABILITY.md "Logs"): the victim's
        # last-K captured log lines ride inside the error, so a remote
        # crash is diagnosable from the driver's `ray_tpu_torch.get` alone
        self.log_tail = list(log_tail) if log_tail else []
        super().__init__(f"Task {function_name} failed:\n{traceback_str}{_tail_block(self.log_tail)}")

    @classmethod
    def from_exception(
        cls, function_name: str, exc: Exception, log_tail: list | None = None
    ):
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, cause=exc, log_tail=log_tail)

    def __reduce__(self):
        # The cause crosses process boundaries only if it pickles; the
        # traceback string always survives (reference keeps the same rule).
        cause = self.cause
        try:
            import pickle

            pickle.dumps(cause)
        except Exception:
            cause = None
        return (
            RayTaskError,
            (self.function_name, self.traceback_str, cause, self.log_tail),
        )

    def as_instanceof_cause(self):
        """Return an exception that is also an instance of the cause's class."""
        cause = self.cause
        if cause is None or isinstance(cause, RayTaskError):
            return self
        cause_cls = type(cause)
        if cause_cls is RayTaskError:
            return self
        try:
            derived = type(
                "RayTaskError(" + cause_cls.__name__ + ")",
                (RayTaskError, cause_cls),
                {"__init__": lambda s: None},
            )
            err = derived()
            # the cause's own payload first (e.g. PreemptedError.attempt/
            # .budget), so typed handlers can read its fields off the
            # derived instance; the RayTaskError envelope fields win
            for k, v in vars(cause).items():
                setattr(err, k, v)
            err.function_name = self.function_name
            err.traceback_str = self.traceback_str
            err.cause = cause
            err.log_tail = list(self.log_tail)
            err.args = (
                f"Task {self.function_name} failed:\n{self.traceback_str}"
                f"{_tail_block(self.log_tail)}",
            )
            return err
        except TypeError:
            return self


class TaskCancelledError(RayError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")


class RayActorError(RayError):
    """The actor died before or during this method call."""

    def __init__(
        self, actor_id=None, reason: str = "actor died", log_tail: list | None = None
    ):
        self.actor_id = actor_id
        # the victim's last captured log lines, enriched head-side from
        # the logs pubsub ring when the actor's death is sealed — the
        # dead process can't ship its own forensics
        self.log_tail = list(log_tail) if log_tail else []
        super().__init__(f"Actor {actor_id}: {reason}{_tail_block(self.log_tail)}")


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    pass


class GetTimeoutError(RayError, TimeoutError):
    pass


class ObjectLostError(RayError):
    def __init__(self, object_id=None, reason: str = "object lost"):
        self.object_id = object_id
        super().__init__(f"Object {object_id}: {reason}")


class ObjectStoreFullError(RayError):
    pass


class OwnerDiedError(ObjectLostError):
    pass


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class WorkerCrashedError(RayError):
    pass


class PreemptedError(RayError):
    """The task was killed by the priority-preemptive scheduler to make
    room for higher-band work — a *policy* decision, not a fault.

    Preempted tasks auto-requeue through the normal retry machinery with
    their own preemption budget (``max_preemptions`` /
    ``task_preemption_budget``); this error only reaches callers when
    that budget is exhausted.  ``attempt``/``budget`` carry the
    accounting so callers can distinguish "the cluster was busy with more
    important work" from a crashing task."""

    def __init__(
        self,
        message: str = "task preempted by higher-priority work",
        attempt: int = 0,
        budget: int = 0,
    ):
        self.attempt = int(attempt)
        self.budget = int(budget)
        super().__init__(f"{message} (attempt {self.attempt}/{self.budget})")

    def __reduce__(self):
        # keep attempt/budget across process boundaries (default reduce
        # would replay __init__ with the formatted message only)
        msg = self.args[0] if self.args else "task preempted"
        base = msg.rsplit(" (attempt ", 1)[0]
        return (PreemptedError, (base, self.attempt, self.budget))


class NodeDiedError(RayError):
    pass


class RaySystemError(RayError):
    pass


class HeadUnreachableError(RaySystemError, ConnectionError):
    """The head (GCS) could not be reached within the bounded dial /
    reconnect window.  Typed so callers can tell a briefly-unreachable
    control plane (retryable, e.g. head mid-restart) from a generic RPC
    failure — and so nothing hangs on a 60s timeout to learn it.
    Subclasses ConnectionError so existing transport-error handlers keep
    catching it."""


class DagError(RayError):
    """Base class for compiled-DAG (ray_tpu_torch/dag/) errors."""


class DagExecutionError(DagError):
    """A compiled-DAG step failed at the driver: either a node raised (the
    remote error is ``__cause__``; the graph stays valid) or a channel /
    participant died mid-step (the graph is invalidated)."""


class DagInvalidatedError(DagExecutionError):
    """The compiled graph can no longer execute (severed channel, dead
    participant, timeout desync, or teardown).  Contract: re-compile over
    the surviving actors, or fail — invalidation is never silent."""


class EngineOverloadedError(RayError):
    """The continuous-batching engine's bounded admission queue is full.

    Raised at SUBMIT time (never after queueing) so callers get a fast,
    typed rejection instead of unbounded queue growth; the HTTP proxy
    maps it to 503 with a ``Retry-After`` header — the bounded failure
    mode the chaos/SLO layers certify against."""

    def __init__(self, message: str = "engine overloaded", retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)

    def __reduce__(self):
        # keep retry_after_s across process boundaries (default reduce
        # would replay __init__ with args=(message,) only)
        return (EngineOverloadedError, (self.args[0], self.retry_after_s))


class EngineStreamError(RayError):
    """A token stream from the inference engine broke mid-flight (replica
    died, channel severed, consumer too slow for the backpressure bound).
    Typed so a killed replica yields an error the client can retry on —
    never a silent hang."""


class DeploymentBackpressureError(RayError):
    """Every replica of a deployment is at its admission bound — the
    handle's inflight cap plus the fleet's reported load leave nowhere to
    route.  Raised instead of silently over-admitting onto a saturated
    replica; the HTTP proxy maps it to 503 with ``Retry-After``.  Shedding
    at this layer fires only when the WHOLE fleet is saturated — a single
    replica's overload is retried on the next-least-loaded sibling first
    (serve/handle.py)."""

    def __init__(
        self,
        message: str = "all replicas saturated",
        retry_after_s: float = 1.0,
    ):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)

    def __reduce__(self):
        # keep retry_after_s across process boundaries (default reduce
        # would replay __init__ with args=(message,) only)
        return (DeploymentBackpressureError, (self.args[0], self.retry_after_s))


class ReplicaDrainingError(RayError):
    """The replica is mid-drain (scale-in in progress): it runs its
    in-flight and mailbox-queued work to retirement but refuses NEW
    engine token streams — the one admission whose caller is guaranteed
    to retry (stream_tokens excludes the replica and picks a sibling),
    so a drain is invisible to clients rather than a burst of errors."""


class RuntimeEnvSetupError(RayError):
    pass


class PlacementGroupError(RayError):
    pass


class CrossLanguageError(RayError):
    pass
