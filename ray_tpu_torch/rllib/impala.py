"""IMPALA: asynchronous actor-learner with V-trace correction.

The port of the JAX package's `rllib/impala.py` (reference:
rllib/execution/learner_thread.py:17 LearnerThread,
multi_gpu_learner_thread.py:20 + :184 _MultiGPULoaderThread — the loader
overlaps host→device copies with the learner's compute).  Rollout actors
stream fragments continuously with whatever weights they last received;
the driver feeds a host queue; a loader thread stages each fragment onto
the learner's device while the learner thread updates on the previous
one; V-trace (`TorchPolicy.learn_on_fragment`) corrects the policy lag.

On the card the loader copies from pinned host memory on a side CUDA
stream and records an event; the learner thread makes its own stream
wait on that event and marks the tensors as used there
(`record_stream`), so the copy overlaps the previous update and no block
is reused while the update still reads it.  The driver reads the
broadcast weights through `TorchPolicy.get_weights`, which takes the
policy's lock against the learner thread's optimizer steps.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, episode_summary, make_workers, spaces
from ray_tpu_torch.rllib.sample_batch import ACTIONS, DONES, LOGPS, OBS, REWARDS


@dataclass
class IMPALAConfig(AlgorithmConfig):
    # learner updates per train() call
    num_batches_per_iter: int = 8
    # refresh the broadcast weights after this many learner updates
    broadcast_interval: int = 1

    def build(self) -> "IMPALA":
        return IMPALA(self)


class _LoaderThread(threading.Thread):
    """Stages host fragments onto the learner's device ahead of use
    (reference: _MultiGPULoaderThread, multi_gpu_learner_thread.py:184)."""

    def __init__(self, device, host_q: "queue.Queue", device_q: "queue.Queue"):
        super().__init__(name="impala-loader", daemon=True)
        self.device = device
        self.host_q = host_q
        self.device_q = device_q
        self.error: Optional[BaseException] = None
        self.stopped = False
        self._stream = None  # the copies' side stream, made on first use

    def _stage(self, batch):
        """(tensors on the device, the copy's event or None)."""
        import torch

        obs = np.asarray(batch[OBS])
        if obs.dtype != np.uint8:
            # pixel frames stay uint8 end-to-end (4x smaller copy; the
            # model normalizes on the device)
            obs = obs.astype(np.float32)
        host = {
            OBS: obs,
            ACTIONS: np.asarray(batch[ACTIONS], np.int64),
            LOGPS: np.asarray(batch[LOGPS], np.float32),
            REWARDS: np.asarray(batch[REWARDS], np.float32),
            DONES: np.asarray(batch[DONES], np.float32),
        }
        # fragments from the object store are read-only views
        host = {k: torch.from_numpy(np.require(v, requirements="CW")) for k, v in host.items()}
        if self.device.type != "cuda":
            return host, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            staged = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def run(self):
        while not self.stopped:
            try:
                item = self.host_q.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                self.device_q.put(None)
                return
            batch, bootstrap = item
            try:
                staged, event = self._stage(batch)
            except Exception as e:  # noqa: BLE001 — train() raises it
                self.error = e
                return
            # bounded put that honors stop: the learner may already be gone
            while not self.stopped:
                try:
                    self.device_q.put((staged, bootstrap, event), timeout=0.5)
                    break
                except queue.Full:
                    continue


class _LearnerThread(threading.Thread):
    """Consumes device-staged fragments, applies the V-trace update
    (reference: LearnerThread, learner_thread.py:17).  `device_updates`
    counts the updates by the device their fragment was on."""

    def __init__(self, policy, device_q: "queue.Queue"):
        super().__init__(name="impala-learner", daemon=True)
        self.policy = policy
        self.device_q = device_q
        self.num_updates = 0
        self.device_updates: Counter = Counter()
        self.last_metrics: Dict[str, float] = {}
        self.error: Optional[BaseException] = None
        self.stopped = False

    def run(self):
        import torch

        while not self.stopped:
            try:
                item = self.device_q.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                return
            batch, bootstrap, event = item
            try:
                if event is not None:
                    stream = torch.cuda.current_stream(self.policy.device)
                    stream.wait_event(event)
                    for t in batch.values():
                        t.record_stream(stream)
                self.last_metrics = self.policy.learn_on_fragment(batch, bootstrap)
                self.device_updates[batch[OBS].device.type] += 1
            except Exception as e:  # noqa: BLE001
                # surface to the driver (train() raises) instead of dying
                # silently and hanging the update-count loop
                self.error = e
            self.num_updates += 1


class IMPALA(Algorithm):
    def _extra_policy_config(self) -> Dict[str, Any]:
        return {}

    def __init__(self, config: IMPALAConfig):
        super().__init__(config)
        from ray_tpu_torch.rllib.policy import TorchPolicy

        obs_shape, num_actions = spaces(config)
        policy_config = {**config.policy_config(), **self._extra_policy_config()}
        self.policy = TorchPolicy(
            obs_shape=obs_shape,
            num_actions=num_actions,
            seed=config.seed,
            num_devices=config.num_learner_devices,
            device=config.learner_device,
            **policy_config,
        )
        self.workers = make_workers(
            config, policy_config, [{"seed": config.seed + i} for i in range(config.num_rollout_workers)]
        )
        self._inflight: Dict[Any, Any] = {}  # sample ref -> worker
        self._host_q: "queue.Queue" = queue.Queue(maxsize=8)
        self._device_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._loader = _LoaderThread(self.policy.device, self._host_q, self._device_q)
        self._learner = _LearnerThread(self.policy, self._device_q)
        self._loader.start()
        self._learner.start()
        self._weights_ref = None
        self._weights_at_update = -1

    def _current_weights_ref(self):
        if (
            self._weights_ref is None
            or self._learner.num_updates - self._weights_at_update
            >= self.config.broadcast_interval
        ):
            self._weights_ref = ray_tpu_torch.put(self.policy.get_weights())
            self._weights_at_update = self._learner.num_updates
        return self._weights_ref

    def _raise_thread_error(self):
        for thread in (self._loader, self._learner):
            if thread.error is not None:
                raise RuntimeError(f"IMPALA {thread.name} failed") from thread.error

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        target = self._learner.num_updates + cfg.num_batches_per_iter
        steps = 0
        # prime: every worker keeps exactly one fragment in flight
        for w in self.workers:
            if w not in self._inflight.values():
                self._inflight[w.sample_fragment.remote(cfg.rollout_fragment_length)] = w
        while self._learner.num_updates < target:
            self._raise_thread_error()
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1, timeout=60)
            if not ready:
                continue
            ref = ready[0]
            w = self._inflight.pop(ref)
            batch, bootstrap = ray_tpu_torch.get(ref, timeout=60)
            steps += int(np.asarray(batch[ACTIONS]).size)  # [T] or [T, N]
            self._host_q.put((batch, bootstrap))
            # async continuation: latest weights out, next fragment in
            w.set_weights.remote(self._current_weights_ref())
            self._inflight[w.sample_fragment.remote(cfg.rollout_fragment_length)] = w

        # the final update of the iteration may have been the failing one
        self._raise_thread_error()
        stats = ray_tpu_torch.get([w.episode_stats.remote() for w in self.workers], timeout=120)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "timesteps_this_iter": steps,
            "num_learner_updates": self._learner.num_updates,
            "learner_device_updates": dict(self._learner.device_updates),
            **episode_summary(stats),
            "time_this_iter_s": time.time() - t0,
            **self._learner.last_metrics,
        }

    def stop(self):
        self._loader.stopped = True
        self._learner.stopped = True
        try:
            self._host_q.put_nowait(None)  # wake the loader if idle; both
        except queue.Full:  # threads also exit via their stopped flags
            pass
        super().stop()
