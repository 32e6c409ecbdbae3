"""ServeController: deployment reconciliation + autoscaling.

Analog of the reference's controller stack (reference:
python/ray/serve/controller.py:61 ServeController actor + control loop
:239; _private/deployment_state.py:958 DeploymentState replica FSM;
_private/autoscaling_policy.py:93 BasicAutoscalingPolicy).  Replicas are
plain actors; the controller reconciles target vs live counts and scales
on reported in-flight load.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


# the methods a draining replica refuses: exactly the ones whose CALLER
# retries a sibling on the typed rejection (stream_tokens' failover loop),
# so refusing them never drops a request.  Unary calls and generic
# streams already in the mailbox were routed BEFORE the handle learned of
# the drain (membership removal + the draining load flag stop new sends),
# so they run to retirement — zero dropped requests is the drain
# contract; the drain deadline bounds the stragglers.  Continuations
# (engine_stream_next/cancel), stats, and load probes must keep flowing
# or the drain protocol starves itself.
_ADMIT_METHODS = frozenset({"engine_stream_start"})

# Replica actor-name scheme.  This string format is a cross-layer
# contract: the head resolves `ray-tpu logs --replica deployment#index`
# by prefix-scanning its named-actor table for it (gcs/server.py
# _resolve_log_entity), and a recovered controller re-acquires living
# replicas the same way — change it in ONE place only.
REPLICA_NAME_PREFIX = "SERVE_REPLICA"


def replica_actor_name(deployment: str, gen: int = 0, rseq: int = 0) -> str:
    return f"{REPLICA_NAME_PREFIX}::{deployment}::{gen}::{rseq}"


def parse_replica_name(name: str) -> Optional[Dict[str, Any]]:
    """Inverse of :func:`replica_actor_name`; None for non-replica names."""
    parts = name.split("::")
    if len(parts) != 4 or parts[0] != REPLICA_NAME_PREFIX:
        return None
    try:
        return {"deployment": parts[1], "gen": int(parts[2]), "rseq": int(parts[3])}
    except ValueError:
        return None


class Replica:
    """Replica actor body: hosts the user callable."""

    def __init__(self, cls_or_fn, init_args, init_kwargs, user_config=None):
        import inspect

        if inspect.isclass(cls_or_fn):
            self.instance = cls_or_fn(*init_args, **(init_kwargs or {}))
        else:
            self.instance = cls_or_fn
        self.inflight = 0
        self.handled = 0
        self.draining = False
        self._streams: Dict[int, Any] = {}
        self._next_stream = 1
        if user_config is not None:
            self.reconfigure(user_config)

    async def handle_request(self, method: str, args, kwargs):
        # async: the worker hosts this actor on an asyncio loop, so batched
        # handlers (serve/batching.py futures) and overlapping requests work
        from ray_tpu_torch.serve import tracing as serve_tracing

        # serve request tracing: the reserved kwarg is popped BEFORE the
        # user callable sees kwargs; replica-side stages (queue wait,
        # batch assembly, prefill/decode) stamp through the contextvar
        # scope.  None (recording off / old caller) costs one check.
        trace = kwargs.pop("_serve_trace", None)
        if self.draining and method in _ADMIT_METHODS:
            from ray_tpu_torch.exceptions import ReplicaDrainingError

            raise ReplicaDrainingError(
                f"replica draining: new {method!r} work rejected"
            )
        serve_tracing.stamp(trace, "serve_replica_recv")
        self.inflight += 1
        err = False
        try:
            target = self.instance if method == "__call__" else getattr(self.instance, method)
            if method == "__call__" and not callable(target):
                raise TypeError("deployment instance is not callable")
            import inspect

            with serve_tracing.request_scope(trace):
                result = target(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
            self.handled += 1
            return result
        except BaseException:
            err = True
            raise
        finally:
            self.inflight -= 1
            serve_tracing.finish_request(trace, error=err)

    async def handle_stream_start(self, method: str, args, kwargs):
        """Start a streaming call: the target returns a (sync or async)
        generator; chunks are pulled with handle_stream_next (reference:
        serve streaming responses / StreamingResponse — their proxy
        iterates the generator; here the HANDLE pulls batches so the
        stream flows through the normal actor-call path)."""
        import inspect

        self.inflight += 1
        try:
            target = (
                self.instance if method == "__call__" else getattr(self.instance, method)
            )
            gen = target(*args, **kwargs)
            if inspect.iscoroutine(gen):
                gen = await gen
        except BaseException:
            self.inflight -= 1  # a failed start must not pin the replica busy
            raise
        sid = self._next_stream
        self._next_stream += 1
        self._streams[sid] = gen
        return sid

    async def handle_stream_next(self, sid: int, max_chunks: int = 16):
        """Pull up to max_chunks items; returns (chunks, done).  Sync
        generators advance in an executor thread so a slow next() cannot
        stall the actor's event loop for other requests."""
        import asyncio
        import inspect

        gen = self._streams.get(sid)
        if gen is None:
            return [], True
        chunks = []
        done = False

        def _pull_sync():
            out = []
            try:
                for _ in range(max_chunks):
                    out.append(next(gen))
            except StopIteration:
                return out, True
            return out, False

        try:
            if inspect.isasyncgen(gen):
                try:
                    for _ in range(max_chunks):
                        chunks.append(await gen.__anext__())
                except StopAsyncIteration:
                    done = True
            else:
                chunks, done = await asyncio.get_running_loop().run_in_executor(
                    None, _pull_sync
                )
        except Exception:
            # only the actor still holding the stream releases the slot —
            # a concurrent cancel may have already popped it
            if self._streams.pop(sid, None) is not None:
                self.inflight -= 1
            raise
        if done:
            if self._streams.pop(sid, None) is not None:
                self.inflight -= 1
                self.handled += 1
        return chunks, done

    async def handle_stream_cancel(self, sid: int):
        """Abandoned stream (consumer broke out / timed out): drop the
        generator and release the inflight slot — phantom inflight would
        otherwise pin autoscaling up and wedge rolling-update drains.
        Async so generator cleanup (finally blocks releasing e.g. an LLM
        engine slot) runs properly on the actor's loop."""
        import inspect

        gen = self._streams.pop(sid, None)
        if gen is None:
            return False
        try:
            if inspect.isasyncgen(gen):
                await gen.aclose()
            else:
                gen.close()
        except Exception:
            pass  # racing __anext__ / user finally errors: slot still frees
        self.inflight -= 1
        return True

    def stats(self):
        return {"inflight": self.inflight, "handled": self.handled}

    def start_drain(self):
        """Enter the drain protocol (serve/FLEET.md): stop admitting new
        work, let in-flight requests and streams run to retirement.
        Idempotent; the controller's drainer polls drain_status until idle
        or the deadline."""
        self.draining = True
        return True

    def drain_status(self):
        """Is this replica safe to tear down?  Generic work is covered by
        inflight + the generator-stream table; engine deployments
        additionally expose engine_idle() (scheduler queue empty, no
        active slots, token-stream outboxes fully consumed)."""
        idle = self.inflight == 0 and not self._streams
        if idle and hasattr(self.instance, "engine_idle"):
            try:
                idle = bool(self.instance.engine_idle())
            except Exception:
                idle = False  # can't prove idle: keep draining
        return {"draining": self.draining, "inflight": self.inflight, "idle": idle}

    def load(self):
        """Cheap load snapshot for least-pressure routing: generic
        inflight plus engine pressure (queue depth, KV-page fraction)
        when the instance exposes engine_load().  Piggybacked onto the
        controller's routing publishes — handles never probe replicas."""
        out: Dict[str, Any] = {
            "inflight": float(self.inflight),
            "draining": bool(self.draining),
        }
        if hasattr(self.instance, "engine_load"):
            try:
                out.update(self.instance.engine_load())
            except Exception:
                pass  # engine mid-init: generic inflight still routes
        return out

    def reconfigure(self, user_config):
        """Apply a user_config IN PLACE — no restart (reference:
        serve/_private/replica.py reconfigure)."""
        if hasattr(self.instance, "reconfigure"):
            self.instance.reconfigure(user_config)
        return True

    def node_id(self) -> str:
        """Which node hosts this replica (locality-aware routing)."""
        import os

        return os.environ.get("RAY_TPU_NODE_ID", "")


class ServeController:
    """Detached actor: owns every deployment's goal state.

    Goal state is CHECKPOINTED to the head KV on every mutation and
    recovered on construction, so a controller crash/restart finds its
    deployments — and re-acquires the still-living replica actors by
    name — instead of losing everything (reference:
    python/ray/serve/controller.py:154 checkpoint,
    :305 _recover_config_from_checkpoint)."""

    CKPT_KEY = "serve:controller:ckpt"

    def __init__(self):
        self.deployments: Dict[str, dict] = {}
        self.version = 0
        self._recover()
        # head fault tolerance: after this worker's CoreWorker reattaches
        # to a restarted head, re-sync replica state — probe every
        # replica, drop the dead, respawn to target, and re-publish so
        # handles refresh their (possibly stale) routing tables
        try:
            self._core().on_reattach(self._schedule_resync)
        except Exception:
            pass  # no runtime yet (unit-test construction): resync is moot
        # a poller thread piggybacks replica load snapshots onto routing
        # publishes (least-pressure routing needs a fleet-wide view the
        # per-client inflight counter can't give).  The head's SLO scale
        # directives (serve:fleet) wait for the serve fleet plane (ROADMAP,
        # Queue 1: The serve fleet plane: scale_on_slo and the fleet
        # directives).
        try:
            self._start_load_poller()
        except Exception:
            pass  # unit-test construction without a cluster

    def _schedule_resync(self):
        """Runs on the reattach-callback thread: route the resync through
        our OWN actor handle so it serializes with deploy/scale on the
        actor executor instead of mutating deployment state from a
        foreign thread mid-rolling-replace."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.api import CONTROLLER_NAME

        try:
            me = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            me.resync_after_head_restart.remote()
        except Exception:  # noqa: BLE001
            logger.exception("post-restart serve resync could not be scheduled")

    def resync_after_head_restart(self):
        import ray_tpu_torch

        changed = False
        for name, dep in list(self.deployments.items()):
            probes = [(r, r.stats.remote()) for r in list(dep["replicas"])]
            dead = []
            for r, ref in probes:
                try:
                    ray_tpu_torch.get(ref, timeout=30)
                except Exception:
                    dead.append(r)
            for r in dead:
                try:
                    idx = dep["replicas"].index(r)
                except ValueError:
                    continue
                dep["replicas"].pop(idx)
                gone = dep["replica_names"].pop(idx)
                dep.get("replica_nodes", {}).pop(gone, None)
                changed = True
            before = len(dep["replicas"])
            self._reconcile(name)
            changed = changed or len(dep["replicas"]) != before
        # always republish: handles may hold replica handles whose actor
        # entries the restarted head reaped — a version bump makes them
        # re-pull instead of erroring against ghosts
        self.version += 1
        self._checkpoint()
        for name in self.deployments:
            self._publish_update(name)
        return changed

    # -------------------------------------------------- checkpoint/recover

    def _core(self):
        from ray_tpu_torch._private import worker as worker_mod

        return worker_mod._require_connected()

    def _checkpoint(self):
        """Serialize every deployment's goal state (definition included,
        via the same serializer actors use) + live replica names."""
        import pickle

        from ray_tpu_torch._private import serialization

        state = {}
        for name, d in self.deployments.items():
            state[name] = {
                "definition": serialization.serialize(
                    (d["cls"], d["init_args"], d["init_kwargs"])
                ).to_wire(),
                "target": d["target"],
                "actor_options": d["actor_options"],
                "route_prefix": d["route_prefix"],
                "autoscaling": d["autoscaling"],
                "max_concurrent_queries": d["max_concurrent_queries"],
                "def_version": d.get("def_version", ""),
                "user_config": d.get("user_config"),
                "gen": d.get("gen", 0),
                "rseq": d.get("rseq", 0),
                "replica_names": list(d.get("replica_names", [])),
            }
        try:
            self._core().kv_put(
                self.CKPT_KEY, pickle.dumps({"state": state, "version": self.version})
            )
        except Exception:
            pass  # a lost checkpoint degrades recovery, never serving

    def _recover(self):
        import pickle

        from ray_tpu_torch._private.serialization import SerializedObject
        from ray_tpu_torch._private import serialization

        try:
            blob = self._core().kv_get(self.CKPT_KEY)
        except Exception:
            return
        if not blob:
            return
        import ray_tpu_torch

        data = pickle.loads(blob)
        self.version = data.get("version", 0)
        for name, s in data.get("state", {}).items():
            cls, init_args, init_kwargs = serialization.deserialize(
                SerializedObject.from_wire(s["definition"])
            )
            dep = {
                "name": name,
                "cls": cls,
                "init_args": init_args,
                "init_kwargs": init_kwargs,
                "target": s["target"],
                "actor_options": s["actor_options"],
                "route_prefix": s["route_prefix"],
                "autoscaling": s["autoscaling"],
                "max_concurrent_queries": s["max_concurrent_queries"],
                "def_version": s.get("def_version", ""),
                "user_config": s.get("user_config"),
                "gen": s.get("gen", 0),
                "rseq": s.get("rseq", 0),
                "replicas": [],
                "replica_names": [],
            }
            self.deployments[name] = dep
            # re-acquire replicas that survived the controller: they are
            # NAMED actors, so the new controller finds them by name and
            # keeps serving without a cold start
            for rn in s.get("replica_names", []):
                try:
                    h = ray_tpu_torch.get_actor(rn)
                except Exception:
                    continue
                dep["replicas"].append(h)
                dep["replica_names"].append(rn)
            self._reconcile(name)
        if self.deployments:
            self.version += 1
            for name in self.deployments:
                self._publish_update(name)
            self._checkpoint()

    def _publish_update(self, name: str):
        """Push the version bump to every handle (reference analog:
        LongPollHost notifying LongPollClients, _private/long_poll.py:184).
        Handles mark themselves stale and re-pull on their next request.
        Replica load snapshots piggyback on the same message — a handle
        absorbs them without an RPC, and load-only publishes (same
        version) never force a membership re-pull."""
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch._private.protocol import MsgType

        message: Dict[str, Any] = {"version": self.version}
        dep = self.deployments.get(name)
        if dep is not None:
            message["replica_names"] = list(dep.get("replica_names", []))
            message["loads"] = dict(dep.get("replica_loads") or {})
        try:
            cw = worker_mod._require_connected()
            cw.request(
                MsgType.PUBLISH,
                {"channel": f"serve:{name}", "message": message},
            )
        except Exception:
            pass  # handles still converge via their pull path

    # ---------------------------------------------------------- fleet plane

    def _fleet_event(self, message: str, **fields):
        """source=serve_fleet timeline event, fire-and-forget (same rule
        as chaos strikes: bookkeeping must not park the control path on a
        head that is mid-restart)."""
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch._private.protocol import MsgType

        try:
            cw = worker_mod._require_connected()
        except Exception:
            return
        payload = {
            "severity": "INFO",
            "source": "serve_fleet",
            "message": message,
            "fields": fields,
        }

        async def _send():
            try:
                await cw.conn.send(MsgType.RECORD_EVENT, payload)
            except (ConnectionError, OSError):
                pass

        try:
            cw.io.spawn(_send())
        except Exception:  # graftlint: disable=silent-except -- event bookkeeping is best-effort; the state change already landed
            pass

    def _start_load_poller(self):
        import threading

        t = threading.Thread(
            target=self._load_poller_loop, daemon=True, name="serve-load-poller"
        )
        t.start()

    def _load_poller_loop(self):
        """Poll every replica's load() each serve_load_poll_period_s and
        piggyback the snapshots onto a same-version publish.  Runs on a
        daemon thread: reads take list() snapshots and writes publish
        REPLACEMENT dicts (the _resolve_replica_node rule), so the actor
        thread never sees a half-mutated view."""
        import time as _time

        import ray_tpu_torch
        from ray_tpu_torch._private.config import RayConfig

        while True:
            _time.sleep(max(0.1, float(RayConfig.serve_load_poll_period_s)))
            try:
                for name, dep in list(self.deployments.items()):
                    replicas = list(dep.get("replicas", []))
                    names = list(dep.get("replica_names", []))
                    if not replicas or len(replicas) != len(names):
                        continue  # mid-mutation snapshot: next tick
                    refs = []
                    for r, rn in zip(replicas, names):
                        try:
                            refs.append((rn, r.load.remote()))
                        except Exception:
                            continue
                    loads = {}
                    for rn, ref in refs:
                        try:
                            loads[rn] = ray_tpu_torch.get(ref, timeout=5)
                        except Exception:
                            continue  # dead/wedged replica: unreported
                    dep["replica_loads"] = loads
                    self._publish_update(name)
            except Exception:  # noqa: BLE001
                # a torn-down cluster mid-poll must not kill the thread
                # with a stack trace storm; next tick re-probes
                _time.sleep(1.0)

    def deploy(
        self,
        name: str,
        cls_or_fn,
        init_args,
        init_kwargs,
        num_replicas: int,
        ray_actor_options: Optional[dict],
        route_prefix: Optional[str],
        autoscaling_config: Optional[dict],
        max_concurrent_queries: int,
        def_version: str = "",
        user_config: Optional[dict] = None,
    ):
        import time as _time

        import ray_tpu_torch

        dep = self.deployments.get(name)
        redeploy = False
        reconfigure = False
        if dep is None:
            dep = {
                "name": name,
                "replicas": [],
                "replica_names": [],
                "gen": 0,
                "rseq": 0,
                "route_prefix": route_prefix or f"/{name}",
                "max_concurrent_queries": max_concurrent_queries,
                "autoscaling": autoscaling_config,
            }
            self.deployments[name] = dep
        else:
            # version-gated rolling update ONLY when the definition changed
            # (caller-computed hash — the objects we hold are deserialized
            # copies, so identity checks are meaningless here); a plain
            # scale-up/down keeps warm replicas.  A user_config change
            # alone RECONFIGURES live replicas in place — no restart
            # (reference: deployment_state.py lightweight-update path)
            redeploy = bool(def_version) and dep.get("def_version") != def_version
            reconfigure = not redeploy and dep.get("user_config") != user_config
        dep["target"] = num_replicas
        dep["cls"] = cls_or_fn
        dep["init_args"] = init_args
        dep["init_kwargs"] = init_kwargs
        dep["actor_options"] = ray_actor_options or {}
        dep["max_concurrent_queries"] = max_concurrent_queries
        dep["def_version"] = def_version
        dep["user_config"] = user_config
        if route_prefix is not None:
            dep["route_prefix"] = route_prefix
        dep["autoscaling"] = autoscaling_config
        old = []
        if redeploy:
            old = self._rolling_replace(name)
        else:
            self._reconcile(name)
            if reconfigure and dep["replicas"]:
                # per-replica: one wedged replica must not leave the set
                # serving a silent old/new MIX — any replica that fails to
                # acknowledge is killed and respawned (the fresh replica
                # gets the new user_config at construction)
                refs = [
                    (r, r.reconfigure.remote(user_config)) for r in list(dep["replicas"])
                ]
                failed = []
                for r, ref in refs:
                    try:
                        ray_tpu_torch.get(ref, timeout=60)
                    except Exception:
                        failed.append(r)
                for r in failed:
                    try:
                        idx = dep["replicas"].index(r)
                    except ValueError:
                        continue
                    dep["replicas"].pop(idx)
                    gone = dep["replica_names"].pop(idx)
                    dep.get("replica_nodes", {}).pop(gone, None)
                    try:
                        ray_tpu_torch.kill(r)
                    except Exception:
                        pass
                if failed:
                    self._reconcile(name)
        self.version += 1
        self._checkpoint()
        self._publish_update(name)
        if old:
            # retire the previous generation OFF the actor's call path: the
            # controller must keep serving get_handles (handles are
            # refreshing right now because of the publish above).  The
            # retirer waits out a cut-over grace, then drains in-flight
            # requests (bounded) before killing.
            import threading

            threading.Thread(
                target=self._retire_replicas, args=(old,), daemon=True
            ).start()
        return True

    def _retire_replicas(self, old: list):
        import time as _time

        import ray_tpu_torch

        _time.sleep(1.0)  # publish propagation grace
        deadline = _time.time() + 30.0
        draining = list(old)
        from ray_tpu_torch.exceptions import GetTimeoutError

        while draining and _time.time() < deadline:
            # submit all probes first so the waits overlap; judge each
            # per-replica: one crashed replica must not abort the drain for
            # the healthy ones, and a TIMEOUT means busy (a long handler
            # blocks stats) — exactly who needs the drain
            refs = [(r, r.stats.remote()) for r in draining]
            still = []
            for r, ref in refs:
                try:
                    s = ray_tpu_torch.get(ref, timeout=10)
                except GetTimeoutError:
                    still.append(r)
                    continue
                except Exception:
                    continue  # actor dead: nothing to drain
                if s["inflight"] > 0:
                    still.append(r)
            draining = still
            if draining:
                _time.sleep(0.5)
        for victim in old:
            try:
                ray_tpu_torch.kill(victim)
            except Exception:
                pass

    def _spawn_replica(self, dep: dict):
        """Replicas are NAMED actors (SERVE_REPLICA::<dep>::<gen>::<seq>)
        so a recovered controller can re-acquire the living ones
        (reference analog: the reference's named replica actors,
        _private/deployment_state.py ReplicaName)."""
        import ray_tpu_torch

        rname = replica_actor_name(
            dep["name"], dep.get("gen", 0), dep.get("rseq", 0)
        )
        dep["rseq"] = dep.get("rseq", 0) + 1
        actor_cls = ray_tpu_torch.remote(Replica)
        opts = dict(dep["actor_options"])
        opts["name"] = rname
        handle = actor_cls.options(**opts).remote(
            dep["cls"], dep["init_args"], dep["init_kwargs"],
            user_config=dep.get("user_config"),
        )
        # resolve which node the replica landed on OFF the deploy path
        # (construction may be slow); handles use it for local-first
        # routing and converge via their pull fallback
        import threading

        threading.Thread(
            target=self._resolve_replica_node, args=(dep, rname, handle), daemon=True
        ).start()
        return handle, rname

    def _resolve_replica_node(self, dep: dict, rname: str, handle):
        import ray_tpu_torch

        try:
            nid = ray_tpu_torch.get(handle.node_id.remote(), timeout=300)
        except Exception:
            return
        # this runs on a daemon thread while the actor thread may iterate
        # dep['replica_nodes'] (_rolling_replace's comprehension, the
        # checkpoint walk): publish a REPLACEMENT dict instead of mutating
        # in place — dict assignment is atomic, iterators see old or new,
        # never "changed size during iteration"
        nodes = dict(dep.get("replica_nodes") or {})
        nodes[rname] = nid
        dep["replica_nodes"] = nodes

    def _rolling_replace(self, name: str) -> list:
        """Spin up the new generation, wait until it answers, swap it in,
        and RETURN the old replicas — the caller kills them only after the
        version publish (+grace), so handles never route to a dead set."""
        import ray_tpu_torch

        dep = self.deployments[name]
        dep["gen"] = dep.get("gen", 0) + 1
        dep["rseq"] = 0
        spawned = [self._spawn_replica(dep) for _ in range(dep["target"])]
        fresh = [h for h, _ in spawned]
        try:
            ray_tpu_torch.get([r.stats.remote() for r in fresh], timeout=120)
        except Exception:
            pass  # serve whatever came up; reconcile repairs stragglers
        old, dep["replicas"] = dep["replicas"], fresh
        dep["replica_names"] = [n for _, n in spawned]
        live = set(dep["replica_names"])
        dep["replica_nodes"] = {
            k: v for k, v in dep.get("replica_nodes", {}).items() if k in live
        }
        return old

    def _reconcile(self, name: str):
        dep = self.deployments[name]
        while len(dep["replicas"]) < dep["target"]:
            h, rname = self._spawn_replica(dep)
            dep["replicas"].append(h)
            dep["replica_names"].append(rname)
        victims = []
        while len(dep["replicas"]) > dep["target"]:
            # scale-in is GRACEFUL: the victim leaves the routing lists
            # now (the caller's publish stops new traffic), stops
            # admitting (start_drain), and a background drainer waits out
            # its in-flight work before teardown — zero dropped requests
            # on scale-in (serve/FLEET.md drain protocol)
            victim = dep["replicas"].pop()
            gone = dep["replica_names"].pop()
            dep.get("replica_nodes", {}).pop(gone, None)
            victims.append((victim, gone))
        if victims:
            self._drain_replicas(name, victims)

    def _drain_replicas(self, name: str, victims: list):
        import threading

        for victim, _ in victims:
            try:
                victim.start_drain.remote()
            except Exception:
                pass  # dead already: the drainer treats it as retired
        threading.Thread(
            target=self._drain_and_kill, args=(name, victims), daemon=True
        ).start()

    def _drain_and_kill(self, name: str, victims: list):
        """Background drainer: poll drain_status until every victim is
        idle or RayConfig.serve_drain_deadline_s elapses, then kill.  A
        victim that retires inside the window dies with nothing in
        flight (outcome=clean); deadline escalation is the bounded
        failure mode (outcome=deadline) — a wedged stream consumer must
        not pin cards forever."""
        import time as _time

        import ray_tpu_torch
        from ray_tpu_torch._private.config import RayConfig
        from ray_tpu_torch.exceptions import GetTimeoutError

        deadline = _time.time() + float(RayConfig.serve_drain_deadline_s)
        pending = list(victims)
        outcomes = {rn: "deadline" for _, rn in victims}
        while pending and _time.time() < deadline:
            refs = [(v, rn, v.drain_status.remote()) for v, rn in pending]
            still = []
            for v, rn, ref in refs:
                try:
                    st = ray_tpu_torch.get(ref, timeout=10)
                except GetTimeoutError:
                    still.append((v, rn))  # busy (a long handler blocks)
                    continue
                except Exception:
                    outcomes[rn] = "clean"  # already dead: nothing to drop
                    continue
                if st.get("idle"):
                    outcomes[rn] = "clean"
                else:
                    still.append((v, rn))
            pending = still
            if pending:
                _time.sleep(0.25)
        for victim, rn in victims:
            try:
                ray_tpu_torch.kill(victim)
            except Exception:
                pass
        for _, rn in victims:
            outcome = outcomes[rn]
            self._fleet_event(
                f"serve fleet drained replica {rn} ({outcome})",
                deployment=name,
                replica=rn,
                outcome=outcome,
            )

    def get_handles(self, name: str):
        dep = self.deployments.get(name)
        if dep is None:
            return None
        nodes = dep.get("replica_nodes", {})
        return {
            "replicas": dep["replicas"],
            # node hex per replica ("" while still resolving): handles
            # prefer same-node replicas (per-node proxy local-first path)
            "replica_nodes": [nodes.get(rn, "") for rn in dep["replica_names"]],
            "replica_names": list(dep["replica_names"]),
            # freshest load snapshots (the poller also pushes these over
            # pubsub between pulls — least-pressure routing inputs)
            "replica_loads": dict(dep.get("replica_loads") or {}),
            "max_concurrent_queries": dep["max_concurrent_queries"],
            "version": self.version,
        }

    def routes(self) -> Dict[str, str]:
        return {d["route_prefix"]: name for name, d in self.deployments.items()}

    def autoscale_tick(self):
        """One autoscaling pass: resize targets from reported in-flight
        load (reference: BasicAutoscalingPolicy.get_decision_num_replicas)."""
        import math

        import ray_tpu_torch

        for name, dep in self.deployments.items():
            cfg = dep.get("autoscaling")
            if not cfg:
                continue
            try:
                stats = ray_tpu_torch.get(
                    [r.stats.remote() for r in dep["replicas"]], timeout=5
                )
            except Exception:
                continue
            total_inflight = sum(s["inflight"] for s in stats)
            target_per = cfg.get("target_num_ongoing_requests_per_replica", 1)
            desired = math.ceil(total_inflight / max(target_per, 1e-9)) or cfg.get("min_replicas", 1)
            desired = max(cfg.get("min_replicas", 1), min(cfg.get("max_replicas", 8), desired))
            if desired != dep["target"]:
                dep["target"] = desired
                self._reconcile(name)
                self.version += 1
                self._checkpoint()
                self._publish_update(name)
        return self.version

    def delete_deployment(self, name: str):
        import ray_tpu_torch

        dep = self.deployments.pop(name, None)
        if dep:
            for r in dep["replicas"]:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
        self.version += 1
        self._checkpoint()
        self._publish_update(name)
        return True

    def list_deployments(self):
        return {
            name: {
                "num_replicas": len(d["replicas"]),
                "target": d["target"],
                "route_prefix": d["route_prefix"],
            }
            for name, d in self.deployments.items()
        }
