"""Per-node metrics agent: a Prometheus scrape endpoint on every node.

Analog of the reference's per-node reporter agent (reference:
dashboard/modules/reporter/reporter_agent.py — psutil node stats +
_private/metrics_agent.py:63 Prometheus export).  Each raylet (and the
head, for its own node) serves ``/metrics`` with node CPU/memory, object
store occupancy, and the cluster's
application metrics (ray_tpu_torch.util.metrics registry, including the
flight-recorder phase histograms) — so a stock Prometheus scrape_config
covers scheduler health node by node.  No device gauges yet: see
``_device_stats_text``.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional


def _node_stats_text(node_id_hex: str, store=None) -> str:
    import psutil

    tags = f'{{NodeId="{node_id_hex}"}}'
    lines = []

    def emit(name, kind, value, help_text):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{tags} {value}")

    emit("node_cpu_percent", "gauge", psutil.cpu_percent(interval=None),
         "CPU utilization of this node (percent)")
    vm = psutil.virtual_memory()
    emit("node_mem_used_bytes", "gauge", vm.used, "Used node memory")
    emit("node_mem_total_bytes", "gauge", vm.total, "Total node memory")
    try:
        la1, la5, la15 = __import__("os").getloadavg()
        emit("node_load1", "gauge", la1, "1-minute load average")
    except OSError:
        pass
    if store is not None:
        emit("object_store_used_bytes", "gauge", store.used(),
             "Bytes allocated in this node's shm object store")
        emit("object_store_capacity_bytes", "gauge", store.capacity(),
             "Capacity of this node's shm object store")
        emit("object_store_num_objects", "gauge", store.num_objects(),
             "Objects resident in this node's shm store")
        emit("object_store_evictions_total", "counter", store.evictions(),
             "LRU evictions since store creation")
    return "\n".join(lines) + "\n"


def _device_stats_text(node_id_hex: str) -> str:
    """Device gauges: none yet.  The agent lives in the head and raylet
    processes, which must never touch CUDA (the zygote they start forks
    pool workers, and a forked child cannot initialise CUDA), so device
    memory is not probed here; GPU gauges come with the device tier
    (ROADMAP, Queue 1)."""
    return ""


async def start_metrics_server(
    node_id_hex: str,
    store=None,
    port: int = 0,
    app_metrics: Optional[Callable[[], object]] = None,
) -> int:
    """Serve /metrics on this node; returns the bound port.

    ``app_metrics`` supplies the application-metrics section as
    Prometheus text (sync or async callable): the head passes a renderer
    over its own kv table, raylets pass an async reader that pulls the
    metrics records from the head.  Without it, the legacy in-process
    fallback (a connected worker's prometheus_text) is attempted."""
    import asyncio

    from aiohttp import web

    from ray_tpu_torch.util import metrics as metrics_mod

    async def handle(_request):
        body = _node_stats_text(node_id_hex, store)
        # off the event loop: the head's RPC loop shares it
        body += await asyncio.get_running_loop().run_in_executor(
            None, _device_stats_text, node_id_hex
        )
        try:
            if app_metrics is not None:
                out = app_metrics()
                if inspect.isawaitable(out):
                    out = await out
                body += out or ""
            else:
                # app metrics live in the cluster KV: only reachable from a
                # connected process (a bare agent serves node stats only).
                # Off-loop: the read is a sync RPC to the head, and this
                # loop may be the head's own RPC loop.
                body += await asyncio.get_running_loop().run_in_executor(
                    None, metrics_mod.prometheus_text
                )
        except Exception:  # graftlint: disable=silent-except -- app-metrics source unavailable (disconnected agent / head mid-restart); node+device stats still serve, by design
            pass
        return web.Response(text=body, content_type="text/plain")

    app = web.Application()
    app.router.add_get("/metrics", handle)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "0.0.0.0", port)
    await site.start()
    return site._server.sockets[0].getsockname()[1]
