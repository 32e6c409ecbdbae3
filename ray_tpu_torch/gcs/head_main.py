"""Head process entry: runs the HeadServer until killed.

Analog of the reference's `gcs_server` binary entry
(reference: src/ray/gcs/gcs_server/gcs_server_main.cc) — spawned by
ray_tpu_torch.init() on the driver node or by `ray-tpu start --head`.
Prints ``PORT <n>`` on stdout once listening so the parent can connect.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys


async def _amain(args):
    from ray_tpu_torch._private.config import RayConfig

    if args.system_config:
        RayConfig.initialize_from_json(args.system_config)
    from ray_tpu_torch.gcs.server import HeadServer

    server = HeadServer(
        host=args.host,
        port=args.port,
        resources=json.loads(args.resources) if args.resources else None,
        session_dir=args.session_dir,
        store_capacity=args.object_store_memory,
    )
    port = await server.start()
    print(f"PORT {port}", flush=True)
    # join the structured log plane: stderr (→ head.log) is wrapped,
    # stdout stays raw — it is the PORT handshake pipe the parent reads,
    # not a log.  basicConfig's StreamHandler captured the REAL stderr at
    # startup; re-point it at the wrapper so logging output is stamped
    # once instead of landing raw beside a structured duplicate.
    from ray_tpu_torch._private import log_plane

    if log_plane.install(node="head", wrap_stdout=False, logging_handler=False):
        for h in logging.getLogger().handlers:
            if isinstance(h, logging.StreamHandler) and h.stream is sys.stderr.raw:
                h.stream = sys.stderr

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()


def main():
    # on-demand stack dumps, same registration as every worker:
    # `kill -USR1 <head pid>` writes all thread tracebacks to head.log
    from ray_tpu_torch._private.profiler import install_sigusr1

    install_sigusr1()
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default="")
    parser.add_argument("--session-dir", default="")  # "" = the default root
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--system-config", default=os.environ.get("RAY_TPU_SYSTEM_CONFIG", ""))
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args()
    logging.basicConfig(
        level=args.log_level,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
        stream=sys.stderr,
    )
    profile_path = os.environ.get("RAY_TPU_HEAD_PROFILE", "")
    if profile_path:
        # DEPRECATED alias for the old cProfile hack: now routes through
        # the cluster sampling profiler (_private/profiler.py) — arms
        # head-role sampling at startup and writes the head's folded
        # stacks (flamegraph collapsed format, not pstats) to the path on
        # exit.  Prefer `ray-tpu profile` / RAY_TPU_PROFILER=1.
        print(
            "RAY_TPU_HEAD_PROFILE is deprecated: arming the sampling "
            "profiler for the head role; output is collapsed-stack text "
            f"at {profile_path} (use `ray-tpu profile` instead)",
            file=sys.stderr,
            flush=True,
        )
        # arm THIS process directly — never via os.environ, which every
        # head-spawned worker inherits (dict(os.environ) in the spawn
        # path): the alias promises head-role profiling, not a silently
        # armed sampler in every worker on the node.  An explicit
        # RAY_TPU_PROFILER=0 (plane excised) still wins inside arm().
        from ray_tpu_torch._private import profiler

        profiler.maybe_init_from_env("head")
        profiler.arm()
    try:
        asyncio.run(_amain(args))
    finally:
        if profile_path:
            from ray_tpu_torch._private import profiler

            # lifetime view: a mid-run cluster-wide disarm (any
            # `ray-tpu profile snapshot`) retires the sampler but must
            # not empty the exit dump the operator asked for
            stacks = profiler.local_totals(lifetime=True)
            if stacks:
                with open(profile_path, "w") as f:
                    f.write(profiler.folded_text(stacks))


if __name__ == "__main__":
    main()
