"""Actor classes and handles.

Analog of the reference's ActorClass/ActorHandle/ActorMethod
(reference: python/ray/actor.py — ActorClass:161, _remote:657,
ActorMethod:82, ActorHandle:1021).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.ids import ActorID, JobID
from ray_tpu_torch.remote_function import _normalize_resources


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; use .remote()."
        )

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._method_name, args, kwargs, self._num_returns)

    def bind(self, *args, **kwargs):
        """Declare this method as a node in a static dataflow graph
        (compiled actor DAGs, ray_tpu_torch/dag/).  Args may be other bound
        nodes, an InputNode, or plain constants; nothing executes until
        the graph is compiled and driven with ``compiled.execute()``."""
        from ray_tpu_torch.dag.node import ClassMethodNode

        return ClassMethodNode(self._handle, self._method_name, args, kwargs)

    def options(self, num_returns: int = 1, **_):
        return ActorMethod(self._handle, self._method_name, num_returns)


class ActorHandle:
    def __init__(self, actor_id: bytes, class_name: str, function_id: bytes, core_worker):
        self._actor_id = actor_id
        self._class_name = class_name
        self._function_id = function_id
        self._cw = core_worker

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def _invoke(self, method_name: str, args, kwargs, num_returns: int):
        from ray_tpu_torch._private import worker as worker_mod

        cw = worker_mod._require_connected()
        refs = cw.submit_actor_task(
            actor_id=self._actor_id,
            function_id=self._function_id,
            method_name=method_name,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
        )
        return refs[0] if num_returns == 1 else refs

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:8]}…)"

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id, self._class_name, self._function_id))

    @classmethod
    def _from_spec(cls, spec, cw):
        return cls(spec.actor_id, spec.function_name, spec.function_id, cw)


def _rebuild_handle(actor_id: bytes, class_name: str, function_id: bytes) -> ActorHandle:
    from ray_tpu_torch._private import worker as worker_mod

    cw = worker_mod.global_worker.core_worker
    return ActorHandle(actor_id, class_name, function_id, cw)


class ActorClass:
    def __init__(self, cls: type, options: Optional[dict] = None):
        self._cls = cls
        self._options = options or {}
        self._function_id = None
        self._exported_by = None
        self.__name__ = cls.__name__

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._options)

    def __reduce__(self):
        return (ActorClass, (self._cls, self._options))

    def options(self, **new_options):
        merged = {**self._options, **new_options}
        parent = self

        class _Wrapped:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, merged)

        return _Wrapped()

    def _remote(self, args, kwargs, opts) -> ActorHandle:
        from ray_tpu_torch._private import worker as worker_mod

        if opts.get("preemptible"):
            # checkpoint-respawn preemption relies on the sequential
            # actor's one-call-at-a-time lock to fence __ray_save__
            # against in-flight calls; concurrent/async actors run
            # methods outside that lock, so a snapshot could be taken
            # mid-call and acknowledged results silently rolled back on
            # restore — reject loudly instead
            import inspect as _inspect

            if opts.get("max_concurrency", 1) > 1:
                raise ValueError(
                    "preemptible=True requires a sequential actor "
                    "(max_concurrency=1): the checkpoint fence cannot "
                    "cover concurrent method execution"
                )
            if any(
                _inspect.iscoroutinefunction(m)
                for _, m in _inspect.getmembers(
                    self._cls, predicate=_inspect.isfunction
                )
            ):
                raise ValueError(
                    "preemptible=True is not supported for async actors: "
                    "methods run on the actor's event loop outside the "
                    "checkpoint fence"
                )
        cw = worker_mod._require_connected()
        if self._function_id is None or self._exported_by is not cw:
            self._function_id, _ = cw.export_function(self._cls)
            self._exported_by = cw
        actor_id = ActorID.of(cw.job_id).binary()
        pg = opts.get("placement_group")
        pg_id = None
        bundle_index = opts.get("placement_group_bundle_index", -1)
        if pg is not None:
            pg_id = pg.id if isinstance(pg.id, bytes) else pg.id.binary()
        scheduling_strategy = opts.get("scheduling_strategy")
        node_affinity = None
        if scheduling_strategy is not None and hasattr(scheduling_strategy, "node_id"):
            # NodeAffinitySchedulingStrategy (reference:
            # util/scheduling_strategies.py) — pin the actor to a node
            if getattr(scheduling_strategy, "soft", False):
                raise ValueError(
                    "NodeAffinitySchedulingStrategy(soft=True) is not "
                    "supported: affinity here is a hard pin (a soft task "
                    "would silently hang pinned to a dead node)"
                )
            node_affinity = bytes.fromhex(scheduling_strategy.node_id)
        if scheduling_strategy is not None and hasattr(scheduling_strategy, "placement_group"):
            spg = scheduling_strategy.placement_group
            if spg is not None:
                pg_id = spg.id if isinstance(spg.id, bytes) else spg.id.binary()
                bundle_index = getattr(
                    scheduling_strategy, "placement_group_bundle_index", -1
                )
        lifetime = opts.get("lifetime")
        cw.create_actor(
            actor_id=actor_id,
            function_id=self._function_id,
            class_name=self._cls.__name__,
            args=args,
            kwargs=kwargs,
            resources=_normalize_resources(
                opts.get("num_cpus"), opts.get("num_gpus"), opts.get("resources")
            ),
            # default-CPU actors: 1 CPU to schedule creation, 0 held while
            # running (reference actor semantics)
            implicit_cpu=opts.get("num_cpus") is None,
            max_restarts=opts.get("max_restarts", RayConfig.actor_max_restarts),
            max_concurrency=opts.get("max_concurrency", 1),
            name=opts.get("name", ""),
            namespace=opts.get("namespace", ""),
            detached=(lifetime == "detached"),
            pg_id=pg_id,
            pg_bundle_index=bundle_index,
            runtime_env=opts.get("runtime_env"),
            node_affinity=node_affinity,
            # multi-tenant band (None -> the driver's job-level priority);
            # preemptible opts in to checkpoint-respawn eviction via the
            # optional __ray_save__/__ray_restore__ hooks
            priority=opts.get("priority"),
            preemptible=bool(opts.get("preemptible", False)),
        )
        return ActorHandle(actor_id, self._cls.__name__, self._function_id, cw)
