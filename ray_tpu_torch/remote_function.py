"""@remote functions.

Analog of the reference's RemoteFunction (reference:
python/ray/remote_function.py:121 _remote_proxy / :231 _remote and the
@ray.remote decorator in _private/worker.py:2693).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import RayConfig


def _normalize_resources(
    num_cpus=None, num_gpus=None, resources=None, default_cpus=1.0
) -> Dict[str, float]:
    res = {k: v for k, v in (resources or {}).items() if v}
    # CPU stays even when explicitly 0 — num_cpus=0 is the standard pattern
    # for IO-bound tasks/actors and must not fall back to the server default
    res["CPU"] = float(num_cpus) if num_cpus is not None else default_cpus
    if num_gpus is not None and num_gpus > 0:
        res[RayConfig.gpu_resource_name] = float(num_gpus)
    return res


class RemoteFunction:
    def __init__(self, fn, options: Optional[dict] = None):
        self._function = fn
        self._options = options or {}
        self._function_id = None  # exported lazily, per driver connection
        self._exported_by = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._function.__name__}' cannot be called directly; "
            f"use .remote()."
        )

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def __reduce__(self):
        # Ship only the definition; the export cache is per-process runtime
        # state (holds the CoreWorker) and must not cross the boundary.
        return (RemoteFunction, (self._function, self._options))

    def options(self, **new_options):
        """Per-call option override (reference: remote_function.py options())."""
        merged = {**self._options, **new_options}
        parent = self

        class _Wrapped:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, merged)

        return _Wrapped()

    def _remote(self, args, kwargs, opts):
        from ray_tpu_torch._private import worker as worker_mod

        cw = worker_mod._require_connected()
        if self._function_id is None or self._exported_by is not cw:
            self._function_id, _ = cw.export_function(self._function)
            self._exported_by = cw
        num_returns = opts.get("num_returns", 1)
        pg = opts.get("placement_group")
        pg_id = None
        bundle_index = opts.get("placement_group_bundle_index", -1)
        if pg is not None:
            pg_id = pg.id if isinstance(pg.id, bytes) else pg.id.binary()
        scheduling_strategy = opts.get("scheduling_strategy")
        node_affinity = None
        if scheduling_strategy is not None and hasattr(scheduling_strategy, "node_id"):
            if getattr(scheduling_strategy, "soft", False):
                raise ValueError(
                    "NodeAffinitySchedulingStrategy(soft=True) is not "
                    "supported: affinity here is a hard pin (a soft task "
                    "would silently hang pinned to a dead node)"
                )
            node_affinity = bytes.fromhex(scheduling_strategy.node_id)
            if getattr(scheduling_strategy, "placement_group", None):
                pass
        if scheduling_strategy is not None and hasattr(scheduling_strategy, "placement_group"):
            spg = scheduling_strategy.placement_group
            if spg is not None:
                pg_id = spg.id if isinstance(spg.id, bytes) else spg.id.binary()
                bundle_index = getattr(
                    scheduling_strategy, "placement_group_bundle_index", -1
                )
        refs = cw.submit_task(
            function_id=self._function_id,
            function_name=self._function.__name__,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            resources=_normalize_resources(
                opts.get("num_cpus"), opts.get("num_gpus"), opts.get("resources")
            ),
            max_retries=opts.get("max_retries", RayConfig.task_max_retries),
            pg_id=pg_id,
            pg_bundle_index=bundle_index,
            node_affinity=node_affinity,
            runtime_env=opts.get("runtime_env"),
            # multi-tenant band (None -> the driver's job-level priority)
            # and per-task preemption budget (None -> config default)
            priority=opts.get("priority"),
            max_preemptions=opts.get("max_preemptions"),
        )
        return refs[0] if num_returns == 1 else refs


def remote(*args, **kwargs):
    """The @remote decorator: functions → RemoteFunction, classes → ActorClass
    (reference: _private/worker.py:2693)."""
    from ray_tpu_torch.actor import ActorClass

    def make(target, options):
        if isinstance(target, type):
            return ActorClass(target, options)
        if not callable(target):
            raise TypeError("@remote target must be a function or class")
        return RemoteFunction(target, options)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return make(args[0], {})
    if args:
        raise TypeError("@remote options must be keyword arguments")

    def decorator(target):
        return make(target, kwargs)

    return decorator
