"""System config flag table.

Analog of the reference's RAY_CONFIG X-macro table
(reference: src/ray/common/ray_config_def.h — 174 flags materialized into a
RayConfig singleton, overridable via RAY_* env vars and
ray.init(_system_config={...})).  Same semantics here: a declarative table,
`RAY_TPU_<NAME>` env overrides, and a `_system_config` dict at init that is
serialized down to every spawned process.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_"

# name -> (type, default, help)
_CONFIG_DEF: Dict[str, tuple] = {
    # -- timeouts / heartbeats (reference: ray_config_def.h:56-59) --
    "heartbeat_period_ms": (int, 500, "worker/node heartbeat period"),
    "num_heartbeats_timeout": (int, 30, "missed heartbeats before a node is dead"),
    "worker_register_timeout_s": (float, 30.0, "max wait for a worker to register"),
    "connect_timeout_s": (float, 10.0, "TCP connect timeout to head"),
    "rpc_timeout_s": (float, 60.0, "generic control-RPC timeout"),
    # -- scheduling --
    "max_pending_lease_requests": (int, 10, "in-flight lease requests per scheduler tick"),
    "scheduler_spread_threshold": (float, 0.5, "hybrid policy: utilization above which we spread"),
    "scheduler_top_k_fraction": (float, 0.2, "hybrid policy: fraction of nodes in the top-k set"),
    "worker_pool_min_idle": (int, 0, "prestarted idle workers per node"),
    # fork-bomb backstop only — actors each need a worker process, so the
    # real bound is resources/RAM, not this (reference: no total cap;
    # maximum_startup_concurrency caps concurrent STARTS instead)
    "worker_pool_max_workers": (int, 2048, "hard cap of worker processes per node"),
    "worker_startup_concurrency": (
        int,
        0,
        "max concurrently-starting workers per node; 0 = #CPUs (reference: "
        "maximum_startup_concurrency)",
    ),
    "idle_worker_kill_s": (float, 300.0, "kill idle workers after this long"),
    "memory_usage_threshold": (float, 0.95, "node memory fraction above which the OOM policy kills a retriable worker"),
    "memory_monitor_interval_s": (float, 2.0, "OOM policy check period; 0 disables"),
    # -- objects --
    "max_direct_call_object_size": (int, 100 * 1024, "objects <= this inline in the owner store"),
    "enable_direct_actor_calls": (bool, True, "callers push actor tasks straight to the actor's worker (head only for FSM/fallback)"),
    "direct_call_reorder_wait_s": (float, 2.0, "max wait for an out-of-order direct actor call's predecessors"),
    "object_store_memory": (int, 512 * 1024 * 1024, "default shm store capacity (bytes)"),
    "object_transfer_chunk_bytes": (int, 5 * 1024 * 1024, "chunk size for node-to-node object push"),
    "object_spilling_enabled": (bool, True, "spill in-scope objects to disk under memory pressure instead of evicting them"),
    "fetch_warn_timeout_s": (float, 30.0, "warn if an object fetch stalls this long"),
    # -- fault tolerance --
    "task_max_retries": (int, 3, "default retries for normal tasks"),
    "actor_max_restarts": (int, 0, "default restarts for actors"),
    "lineage_max_bytes": (int, 64 * 1024 * 1024, "max lineage kept per owner for reconstruction"),
    "max_object_reconstructions": (int, 3, "re-executions allowed to recover a lost object"),
    "function_fetch_timeout_s": (float, 30.0, "max server-side wait for a function-table KV fetch (widen for chaos/slow CI)"),
    "object_pull_attempts": (int, 3, "backoff-disciplined attempts for a cross-node object pull before declaring it lost"),
    # -- head fault tolerance (gcs/HEAD_FT.md) --
    "head_reconnect_window_s": (float, 0.0, "peers (drivers, workers, raylets) redial a lost head connection with backoff for this long before failing typed; 0 preserves fail-fast HeadUnreachableError semantics"),
    "head_recovery_grace_s": (float, 3.0, "a RESTARTED head holds dispatch this long while live peers re-attach and re-announce state; anything not reconfirmed by the window's end is reaped through the fault FSM / lease revocation / lineage machinery"),
    "head_reattach_retry_s": (float, 0.25, "client-side pause between re-attach attempts that the head asked to retry (e.g. a worker whose raylet has not re-registered yet)"),
    # -- control-plane fast path: worker-lease caching / raylet dispatch /
    #    sharded GCS (gcs/server.py, raylet/lease_agent.py, gcs/shards.py) --
    "lease_cache_enabled": (bool, True, "drivers/workers cache worker leases per resource shape and push S-shaped task queues straight to the leased worker (head round-trip amortized to ~0 per task)"),
    "lease_idle_timeout_s": (float, 2.0, "a cached lease with nothing in flight is returned to the head after this long idle"),
    "lease_max_per_shape": (int, 8, "max concurrent leases a client holds per resource shape"),
    "lease_queue_latency_budget_s": (float, 0.2, "max expected queue-wait a client may build on one lease (queue depth = budget / observed mean task duration): tiny tasks pipeline deep, long tasks spread breadth-first across leases or fall back to the head"),
    "lease_revoke_deadline_s": (float, 2.0, "grace between LEASE_REVOKE and the head SIGKILLing the leased worker; a holder that drains + returns within it keeps every pushed task's single execution"),
    "lease_request_retry_s": (float, 0.25, "client-side negative cache after a denied lease request (denials trigger a head-side worker spawn, so a retry shortly after usually grants)"),
    "raylet_local_dispatch": (bool, True, "raylets grant leases for node-affine work from their local worker pool, band-ordered, reporting grants to the head asynchronously"),
    "gcs_kv_shards": (int, 2, "shard event-loop threads serving the KV / object-locate / actor-directory read planes on their own listeners; 0 = everything on the head loop"),
    # -- multi-tenant priorities / preemption (gcs/server.py) --
    "task_preemption_budget": (int, 16, "default preemptions a normal task tolerates before its returns seal a typed PreemptedError (per-task override: max_preemptions)"),
    "actor_preempt_save_deadline_s": (float, 5.0, "wall-clock budget for a preempted actor's __ray_save__; a missing/late reply escalates to SIGKILL with the restart budget charged"),
    "priority_starvation_s": (float, 30.0, "queued longer than this boosts a task one band, so a starved low-band job still drains under sustained high-band load"),
    "priority_fair_quantum_s": (float, 0.1, "deficit drained from a job's fair-share counter per dispatch (within-band weighted round-robin over queue-wait)"),
    "slo_preempt_sustain_ticks": (int, 2, "consecutive breaching observer ticks before an SLO with preempt_below_band triggers a policy preemption"),
    "slo_preempt_cooldown_s": (float, 5.0, "minimum spacing between SLO-policy preemptions"),
    # -- sampling profiler (_private/profiler.py; RAY_TPU_PROFILER env
    #    gates the plane itself — see the module docstring) --
    "profiler_hz": (int, 67, "wall-clock sampling rate while armed (67 is co-prime with common 10/50/100 Hz periodic work, so the sampler can't alias against it)"),
    "profiler_flush_period_s": (float, 1.0, "how often an armed process ships its folded-stack delta to the head (one batched PROFILE_STATS frame per window, never per sample)"),
    "profiler_max_stacks": (int, 2000, "distinct folded stacks the head keeps per (role, node); overflow folds the smallest counts into a <other> bucket so sample totals stay exact"),
    # -- fault injection (deterministic chaos; see _private/CHAOS.md) --
    "chaos_enable": (bool, False, "make this process chaos-aware: subscribe to runtime arm/disarm pushes"),
    "chaos_seed": (int, 0, "deterministic fault-injection seed (same seed + plan => same per-stream fault sequence)"),
    "chaos_plan": (str, "", "fault-injection plan string, e.g. 'worker:wire.send.sever@TASK_DONE=0.5'; arms at process start when non-empty"),
    # -- collective / gpu --
    "collective_rendezvous_timeout_s": (float, 120.0, "GCS-KV rendezvous wait"),
    "dcn_allreduce_chunk_bytes": (int, 4 * 1024 * 1024, "ring-allreduce chunk over DCN"),
    "collective_socket_buffer_bytes": (int, 4 * 1024 * 1024, "SO_SNDBUF/SO_RCVBUF for dcn ring and p2p sockets; 0 keeps the kernel default (small defaults are what capped the obs path at ~20MB/s)"),
    "gpu_resource_name": (str, "GPU", "resource key for CUDA devices"),
    # -- logging / metrics --
    "event_loop_lag_warn_ms": (int, 500, "warn if the control loop stalls"),
    "metrics_report_period_ms": (int, 2000, "metrics push period"),
    "log_rotation_bytes": (int, 64 * 1024 * 1024, "size-capped copytruncate rotation for worker-*.log (done by the tailing node agent; 0 disables); writers are O_APPEND so rotation never loses the write fd"),
    "log_rotation_backups": (int, 2, "rotated .1..N backups kept per worker log; the log agent reads across the rotation seam"),
    "driver_log_rate_lines_s": (int, 1000, "driver-side flood control: sustained per-source line rate printed to the driver terminal (2x burst); excess collapses into one suppression notice"),
    "error_log_tail_lines": (int, 20, "captured log lines shipped inside structured error records and RayTaskError.log_tail (crash forensics)"),
    # -- serve --
    "serve_drain_deadline_s": (float, 30.0, "graceful-drain budget on scale-in: a draining replica finishes in-flight work within this window or is killed (deadline escalation, recorded as outcome=deadline)"),
    "serve_load_poll_period_s": (float, 1.0, "controller poll period for replica load snapshots piggybacked onto routing publishes for least-pressure routing"),
    # -- compiled actor DAGs (ray_tpu_torch/dag/) --
    "dag_ring_slot_min_bytes": (int, 1 << 20, "minimum slot size for a compiled-DAG shm channel ring (sized at 2x the first payload, floored here; bigger payloads overflow inline onto the carrier conn)"),
    "dag_channel_slots": (int, 4, "slots per compiled-DAG shm channel ring (SPSC depth before the writer back-pressures)"),
    "dag_setup_timeout_s": (float, 30.0, "per-participant deadline for DAG_SETUP/DAG_TEARDOWN negotiation (includes waiting out actor creation)"),
    # -- resident DAG training loop (ray_tpu_torch/train/torch/step_dag.py) --
    "train_dag_pipeline_depth": (int, 2, "steps the resident train DAG keeps in flight at the driver (batch N+1 enters the input ring while the device runs batch N; bounded additionally by dag_channel_slots)"),
    "train_dag_step_timeout_s": (float, 300.0, "deadline for one resident train step's metrics to reach the driver before the graph is declared stuck and invalidated"),
}


class _Config:
    """Singleton holding resolved config values."""

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self.reset()

    def reset(self):
        self._values = {name: default for name, (_, default, _h) in _CONFIG_DEF.items()}
        for name, (typ, _default, _h) in _CONFIG_DEF.items():
            env = os.environ.get(_ENV_PREFIX + name.upper())
            if env is not None:
                self._values[name] = self._parse(typ, env)

    @staticmethod
    def _parse(typ, raw: str):
        if typ is bool:
            return raw.lower() in ("1", "true", "yes")
        return typ(raw)

    def initialize(self, system_config: Dict[str, Any] | None):
        """Apply `_system_config` overrides (e.g. from init / spawned-process env)."""
        if not system_config:
            return
        for k, v in system_config.items():
            if k not in _CONFIG_DEF:
                raise ValueError(f"Unknown system config: {k!r}")
            typ = _CONFIG_DEF[k][0]
            self._values[k] = self._parse(typ, v) if isinstance(v, str) else typ(v)

    def to_json(self) -> str:
        return json.dumps(self._values)

    def initialize_from_json(self, blob: str):
        self.initialize(json.loads(blob))

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name)


RayConfig = _Config()


def describe_flags() -> str:
    lines = []
    for name, (typ, default, help_) in sorted(_CONFIG_DEF.items()):
        lines.append(f"{name} ({typ.__name__}, default {default!r}): {help_}")
    return "\n".join(lines)


def session_root() -> str:
    """Where session directories (logs, the head's WAL, the shm store file)
    live: ``ray_tpu_torch`` under the temp directory, so TMPDIR moves it."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
