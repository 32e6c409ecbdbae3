"""Public Serve API: @deployment, run, shutdown, handles, HTTP ingress.

Analog of the reference's serve.api (reference: python/ray/serve/api.py:455
serve.run; @serve.deployment decorator api.py; HTTP proxy
_private/http_proxy.py:189 — here an aiohttp actor per cluster).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

CONTROLLER_NAME = "_serve_controller"


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)
    route_prefix: Optional[str] = None
    ray_actor_options: Optional[dict] = None
    autoscaling_config: Optional[dict] = None
    max_concurrent_queries: int = 100
    # plain-data config delivered to the instance's reconfigure() — at
    # construction AND in place on redeploys that change only this field
    # (reference: serve deployment user_config lightweight updates)
    user_config: Optional[dict] = None

    def bind(self, *args, **kwargs) -> "Deployment":
        import dataclasses

        return dataclasses.replace(self, init_args=args, init_kwargs=kwargs)

    def options(self, **kw) -> "Deployment":
        import dataclasses

        return dataclasses.replace(self, **kw)


def deployment(_func_or_class=None, *, name: Optional[str] = None, **kwargs):
    """@serve.deployment decorator (reference: serve/api.py)."""

    def deco(target):
        return Deployment(
            func_or_class=target, name=name or target.__name__, **kwargs
        )

    if _func_or_class is not None:
        return deco(_func_or_class)
    return deco


def _get_or_create_controller():
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import ServeController

    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        cls = ray_tpu_torch.remote(ServeController)
        return cls.options(name=CONTROLLER_NAME, lifetime="detached", num_cpus=0).remote()


def run(deployment_obj: Deployment, *, _blocking: bool = False, http_port: Optional[int] = None):
    """Deploy (recursively: Deployment objects in init args become live
    handles — the deployment-graph compose of reference
    serve/_private/deployment_graph_build.py) and return a handle
    (reference: serve.run api.py:455)."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.handle import DeploymentHandle

    controller = _get_or_create_controller()
    # resolve nested Deployment dependencies depth-first: each becomes a
    # DeploymentHandle passed to the parent's constructor
    def _resolve(v):
        if isinstance(v, Deployment):
            return run(v)
        return v

    deployment_obj = deployment_obj.options(
        init_args=tuple(_resolve(a) for a in deployment_obj.init_args),
        init_kwargs={k: _resolve(v) for k, v in deployment_obj.init_kwargs.items()},
    )
    # definition version computed HERE, where the original objects live —
    # the controller only sees deserialized copies, so identity comparison
    # there is meaningless (reference analog: deployment version strings)
    import hashlib

    import cloudpickle

    def_version = hashlib.sha1(
        cloudpickle.dumps(
            (
                deployment_obj.func_or_class,
                deployment_obj.init_args,
                deployment_obj.init_kwargs,
            )
        )
    ).hexdigest()
    ray_tpu_torch.get(
        controller.deploy.remote(
            deployment_obj.name,
            deployment_obj.func_or_class,
            deployment_obj.init_args,
            deployment_obj.init_kwargs,
            deployment_obj.num_replicas,
            deployment_obj.ray_actor_options,
            deployment_obj.route_prefix,
            deployment_obj.autoscaling_config,
            deployment_obj.max_concurrent_queries,
            def_version,
            deployment_obj.user_config,
        ),
        timeout=300,
    )
    if http_port is not None:
        start_http_proxy(http_port)
    return DeploymentHandle(deployment_obj.name, controller)


def get_deployment_handle(name: str):
    from ray_tpu_torch.serve.handle import DeploymentHandle

    return DeploymentHandle(name, _get_or_create_controller())


def list_deployments() -> Dict[str, dict]:
    import ray_tpu_torch

    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.list_deployments.remote(), timeout=30)


def autoscale_tick():
    """Drive one autoscaling pass (tests/cron; the proxy actor also ticks)."""
    import ray_tpu_torch

    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.autoscale_tick.remote(), timeout=60)


def delete(name: str):
    import ray_tpu_torch

    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)


def shutdown():
    import ray_tpu_torch

    for h in _proxy_handles.values():
        try:
            ray_tpu_torch.kill(h)
        except Exception:
            pass
    _proxy_handles.clear()
    _proxy_urls.clear()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    for name in list(list_deployments()):
        delete(name)
    ray_tpu_torch.kill(controller)


_STREAM_END = object()


def _overload_retry_after(exc) -> Optional[float]:
    """If ``exc`` is (or wraps) an overload-shaped error — the engine's
    EngineOverloadedError (replica-local admission queue full) or the
    handle's DeploymentBackpressureError (the WHOLE fleet saturated) —
    its suggested Retry-After in seconds; else None.  Replica-side
    raises reach the proxy wrapped in a RayTaskError whose pickled cause
    survives the hop."""
    from ray_tpu_torch.exceptions import DeploymentBackpressureError, EngineOverloadedError

    seen = 0
    while exc is not None and seen < 8:
        if isinstance(exc, (EngineOverloadedError, DeploymentBackpressureError)):
            return max(0.0, float(getattr(exc, "retry_after_s", 1.0)))
        exc = getattr(exc, "cause", None) or exc.__cause__
        seen += 1
    return None


def _is_replica_local_reject(exc) -> bool:
    """True when ``exc`` wraps a SINGLE replica's rejection (overload or
    mid-drain) rather than fleet-wide saturation — the shape the proxy
    retries on the next-least-loaded replica before shedding 503."""
    from ray_tpu_torch.exceptions import EngineOverloadedError, ReplicaDrainingError

    seen = 0
    while exc is not None and seen < 8:
        if isinstance(exc, (EngineOverloadedError, ReplicaDrainingError)):
            return True
        exc = getattr(exc, "cause", None) or exc.__cause__
        seen += 1
    return False


class HTTPProxy:
    """aiohttp ingress actor, one per node (reference:
    _private/http_proxy.py:189,333 — per-node proxies behind the cluster
    LB).  Its DeploymentHandles route local-first: replicas on the
    proxy's own node are preferred (handle.py _pick_replica).  Requests
    with ?stream=1 iterate a generator deployment and stream NDJSON."""

    def __init__(self, port: int):
        from concurrent.futures import ThreadPoolExecutor

        self.port = port
        self._handles = {}
        self.url = None
        # stream pulls park threads for the stream's lifetime: isolate
        # them from the default executor the non-stream path blocks on
        self._stream_executor = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="serve-stream"
        )

    async def start(self):
        import json

        from aiohttp import web

        import ray_tpu_torch
        from ray_tpu_torch.serve.handle import DeploymentHandle

        controller = _get_or_create_controller()

        async def handler(request):
            from ray_tpu_torch.serve import tracing as serve_tracing

            # request record born at the ingress: serve_proxy_recv is the
            # TTFT/e2e origin (None when recording is off — every stamp
            # below gates on that)
            trace = serve_tracing.new_request()
            routes = ray_tpu_torch.get(controller.routes.remote(), timeout=10)
            path = request.path
            name = None
            for prefix, dep_name in routes.items():
                if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                    name = dep_name
                    break
            if name is None:
                return web.Response(status=404, text="no route")
            if trace is not None:
                trace["deployment"] = name
            if name not in self._handles:
                import asyncio as _aio

                # first touch of a deployment runs a sync SUBSCRIBE RPC in
                # the handle constructor: build it off-loop so the http
                # loop keeps serving (graftsan GS001).  setdefault keeps
                # the winner if two first requests race across the await;
                # the loser's subscription self-prunes via its weakref.
                h = await _aio.get_running_loop().run_in_executor(
                    None, DeploymentHandle, name, controller
                )
                self._handles.setdefault(name, h)
            handle = self._handles[name]
            handle.refresh_if_stale()
            try:
                body = await request.json()
            except Exception:
                body = (await request.read()).decode() or None
            import asyncio
            import functools

            if (
                request.query.get("stream") == "sse"
                or "text/event-stream" in request.headers.get("Accept", "")
            ):
                # continuous-batching engine deployments stream tokens as
                # Server-Sent Events: one `data:` frame per token batch,
                # first frame before generation completes (the dag-channel
                # token stream under handle.stream_tokens).  Admission
                # overload sheds BEFORE the stream opens: 503 +
                # Retry-After, the bounded failure mode.
                from ray_tpu_torch.exceptions import EngineStreamError

                loop = asyncio.get_running_loop()
                it = handle.stream_tokens(body)

                def _next():
                    try:
                        return next(it)
                    except StopIteration:
                        return _STREAM_END

                try:
                    first = await loop.run_in_executor(self._stream_executor, _next)
                except Exception as e:  # noqa: BLE001 -- status line not sent yet: map to HTTP
                    retry = _overload_retry_after(e)
                    if retry is not None:
                        return web.Response(
                            status=503,
                            headers={"Retry-After": str(max(1, int(retry)))},
                            text="engine admission queue full",
                        )
                    return web.Response(status=500, text=f"stream failed: {e}")
                resp = web.StreamResponse(
                    headers={
                        "Content-Type": "text/event-stream",
                        "Cache-Control": "no-cache",
                    }
                )
                await resp.prepare(request)
                try:
                    chunk = first
                    while chunk is not _STREAM_END:
                        await resp.write(
                            (f"data: {json.dumps({'t': chunk})}\n\n").encode()
                        )
                        chunk = await loop.run_in_executor(
                            self._stream_executor, _next
                        )
                    await resp.write(b"event: done\ndata: {}\n\n")
                except Exception as e:  # noqa: BLE001 -- headers sent: the error travels as a typed SSE event
                    kind = (
                        "stream_error"
                        if isinstance(e, EngineStreamError)
                        else type(e).__name__
                    )
                    try:
                        await resp.write(
                            (
                                "event: error\ndata: "
                                + json.dumps({"error": str(e), "type": kind})
                                + "\n\n"
                            ).encode()
                        )
                    except Exception:
                        pass
                    it.close()
                try:
                    await resp.write_eof()
                except Exception:  # noqa: BLE001 -- client hung up mid-stream; nothing left to send
                    pass
                return resp

            if request.query.get("stream") == "1":
                # generator deployments stream over HTTP as NDJSON lines
                # (reference: serve StreamingResponse through the proxy);
                # pulls run on a DEDICATED executor so parked slow streams
                # can't starve the default pool the non-stream gets use
                resp = web.StreamResponse(
                    headers={"Content-Type": "application/x-ndjson"}
                )
                await resp.prepare(request)
                loop = asyncio.get_running_loop()
                it = handle.stream(body)

                def _next():
                    try:
                        return next(it)
                    except StopIteration:
                        return _STREAM_END

                try:
                    while True:
                        chunk = await loop.run_in_executor(
                            self._stream_executor, _next
                        )
                        if chunk is _STREAM_END:
                            break
                        await resp.write(
                            (json.dumps(chunk, default=str) + "\n").encode()
                        )
                except Exception as e:  # noqa: BLE001 — headers already sent
                    # mid-stream failure: the status line is gone, so the
                    # error travels as a final NDJSON line
                    try:
                        await resp.write(
                            (json.dumps({"error": str(e)}) + "\n").encode()
                        )
                    except Exception:
                        pass
                    it.close()
                await resp.write_eof()
                return resp

            from ray_tpu_torch.exceptions import DeploymentBackpressureError

            loop = asyncio.get_running_loop()
            result = None
            last_exc = None
            # a single replica's rejection (overload / mid-drain) retries
            # on the next-least-loaded replica before shedding — 503 only
            # when the WHOLE fleet is saturated (serve/FLEET.md)
            for _attempt in range(3):
                try:
                    if trace is not None:
                        ref = handle.remote(body, _serve_trace=trace)
                    else:
                        ref = handle.remote(body)
                except DeploymentBackpressureError as e:
                    # nothing routable anywhere: shed now
                    return web.Response(
                        status=503,
                        headers={"Retry-After": str(max(1, int(e.retry_after_s)))},
                        text="deployment saturated",
                    )
                try:
                    result = await loop.run_in_executor(
                        None, functools.partial(ray_tpu_torch.get, ref, timeout=120)
                    )
                    last_exc = None
                    break
                except Exception as e:  # noqa: BLE001 -- overload maps to 503, the rest re-raises
                    if not _is_replica_local_reject(e):
                        raise
                    last_exc = e
            if last_exc is not None:
                # every attempt hit a saturated/draining replica: bounded
                # rejection instead of unbounded queueing — clients back
                # off per Retry-After
                retry = _overload_retry_after(last_exc) or 1.0
                return web.Response(
                    status=503,
                    headers={"Retry-After": str(max(1, int(retry)))},
                    text="engine admission queue full",
                )
            if isinstance(result, (dict, list, str, int, float, bool)) or result is None:
                return web.json_response({"result": result})
            return web.Response(body=str(result).encode())

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", handler)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", self.port)
        await site.start()
        actual = site._server.sockets[0].getsockname()[1]
        self.url = f"http://127.0.0.1:{actual}"
        return self.url

    async def ping(self):
        return "ok"


_proxy_handles: Dict[str, Any] = {}
_proxy_urls: Dict[str, str] = {}


def start_http_proxy(port: int = 8000) -> str:
    """Start HTTP ingress: one proxy actor PER ALIVE NODE, each pinned by
    node affinity and routing to its own node's replicas first (reference:
    _private/http_proxy.py — per-node proxies).  The driver's node binds
    ``port``; other nodes bind an ephemeral port (this runtime's test
    clusters share one host, where a fixed port would collide).  Returns
    the driver-node proxy's URL; all of them via proxy_addresses()."""
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    my_node = bytes(worker_mod._require_connected().node_id).hex()
    alive = {n["NodeID"] for n in ray_tpu_torch.nodes() if n["Alive"]}
    # reconcile the cached set against the CURRENT cluster: drop proxies
    # on dead nodes (or from a previous cluster in this process — tests
    # init/shutdown repeatedly), add proxies for newly-joined nodes
    for nid in list(_proxy_handles):
        stale = nid not in alive
        if not stale:
            try:
                ray_tpu_torch.get(_proxy_handles[nid].ping.remote(), timeout=10)
            except Exception:
                stale = True
        if stale:
            try:
                ray_tpu_torch.kill(_proxy_handles[nid])
            except Exception:
                pass
            _proxy_handles.pop(nid, None)
            _proxy_urls.pop(nid, None)
    cls = ray_tpu_torch.remote(HTTPProxy)
    started = []
    for nid in alive:
        if nid in _proxy_handles:
            continue
        h = cls.options(
            num_cpus=0,
            name=f"_serve_http_proxy::{nid}",
            scheduling_strategy=NodeAffinitySchedulingStrategy(nid),
        ).remote(port if nid == my_node else 0)
        _proxy_handles[nid] = h
        started.append(nid)
    for nid in started:
        _proxy_urls[nid] = ray_tpu_torch.get(_proxy_handles[nid].start.remote(), timeout=120)
    return _proxy_urls.get(my_node) or next(iter(_proxy_urls.values()))


def proxy_addresses() -> Dict[str, str]:
    """node id (hex) → that node's proxy URL."""
    return dict(_proxy_urls)
