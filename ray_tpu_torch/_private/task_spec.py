"""Task specification — the unit handed from submitter to scheduler to executor.

Analog of the reference's TaskSpecification (reference:
src/ray/common/task/task_spec.h and protobuf common.proto TaskSpec), carrying
function identity, arguments (inline values or object refs), resource
demands, retry policy, and placement-group affinity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

NORMAL_TASK = "normal"
ACTOR_CREATION_TASK = "actor_creation"
ACTOR_TASK = "actor_task"

# Argument wire encodings
ARG_VALUE = 0  # inline SerializedObject wire form
ARG_REF = 1  # object id bytes — resolved by the executor before running


@dataclass
class TaskSpec:
    task_id: bytes
    job_id: bytes
    task_type: str = NORMAL_TASK
    # sha1 of the exported function/class blob in the GCS function table
    function_id: bytes = b""
    function_name: str = ""
    method_name: str = ""  # actor tasks
    actor_id: Optional[bytes] = None
    args: List[list] = field(default_factory=list)  # [[ARG_VALUE, wire] | [ARG_REF, id]]
    # object ids pickled INSIDE inlined ARG_VALUE payloads; the head pins
    # these for the task's lifetime exactly like top-level ARG_REF args
    # (borrower protocol, reference: reference_count.cc)
    nested_refs: List[bytes] = field(default_factory=list)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retries_left: int = 0
    # actor creation options
    max_restarts: int = 0
    max_concurrency: int = 1
    name: str = ""  # named actor
    namespace: str = ""
    detached: bool = False
    # placement
    pg_id: Optional[bytes] = None
    pg_bundle_index: int = -1
    node_affinity: Optional[bytes] = None  # node id, soft=false only
    seq_no: int = 0  # per-caller ordering for actor tasks
    caller_id: bytes = b""
    # multi-tenant scheduling band: higher dispatches first; a band-N
    # request that cannot place may preempt band-<N work (gcs/server.py
    # victim selection).  0 = best-effort, 1 = normal (default), 2+ =
    # latency-critical.  Defaults to the submitting driver's job-level
    # priority (ray_tpu_torch.init(priority=...)).
    priority: int = 1
    # actors only: opt in to checkpoint-respawn preemption — the scheduler
    # may run `__ray_save__` (deadline-bounded), release this actor's
    # resources, and respawn-with-`__ray_restore__` when capacity returns
    preemptible: bool = False
    # normal tasks: preemptions tolerated before the return objects seal a
    # typed PreemptedError; -1 = RayConfig.task_preemption_budget
    max_preemptions: int = -1
    # preemptions already suffered (carried across lease-revocation
    # resubmits so the driver-side and head-side halves of the budget
    # can never double-count from zero)
    preempt_count: int = 0
    # which grant path dispatched this task: "head" (scheduler loop),
    # "cached_lease" (driver-held worker lease), or "raylet" (node-local
    # grant).  Tags the flight-recorder queue-wait histograms.
    granted_by: str = "head"
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    # set when the worker owning this actor should claim the real TPU chip
    claim_tpu: bool = False
    # actor creation with the DEFAULT CPU demand: 1 CPU is required to
    # schedule the creation but released once the actor is ALIVE
    # (reference semantics: actors use 0 CPU after creation unless
    # num_cpus was explicit)
    implicit_cpu: bool = False
    # span context when tracing is on (util/tracing.py): trace_id /
    # parent_span_id / span_id — the reference's injected span metadata
    # (tracing_helper.py _DictPropagator)
    trace_ctx: Optional[Dict[str, str]] = None
    # flight-recorder stamps (_private/task_events.py): phase -> wall time.
    # None when recording is off — every downstream stamp site gates on
    # that, so the disabled hot path is one None check.  The dict object is
    # SHARED between the spec and its wire form (to_wire is a shallow copy;
    # from_wire adopts the decoded dict), which is what lets the head stamp
    # dispatch into a spec whose cached submit wire is reused for PUSH_TASK.
    phases: Optional[Dict[str, float]] = None

    def to_wire(self) -> dict:
        return self.__dict__.copy()

    @classmethod
    def from_wire(cls, d: dict) -> "TaskSpec":
        return cls(**d)

    def return_object_ids(self) -> List[bytes]:
        from ray_tpu_torch._private.ids import ObjectID, TaskID

        tid = TaskID(self.task_id)
        return [
            ObjectID.for_task_return(tid, i).binary() for i in range(self.num_returns)
        ]
