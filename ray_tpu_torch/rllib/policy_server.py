"""Policy server + client: external envs drive training over HTTP.

Analog of the reference's external-env interface (reference:
rllib/env/policy_server_input.py:26 PolicyServerInput +
rllib/env/policy_client.py — an environment OUTSIDE the cluster asks the
server for actions and logs rewards; completed episodes become training
batches).  The server wraps a TorchPolicy: /get_action records
(obs, action, logp, value) rows, /log_returns attaches rewards, and
finished episodes accumulate into GAE-ready SampleBatches that a PPO
loop drains with ``sample_batch``.  The port of the JAX package's
`rllib/policy_server.py`, over a TorchPolicy on whatever device it was
built on.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.rollout_worker import compute_gae
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    VALUES,
    SampleBatch,
)


class _Episode:
    def __init__(self):
        self.rows: Dict[str, list] = {
            k: [] for k in (OBS, ACTIONS, REWARDS, DONES, LOGPS, VALUES)
        }
        self.pending_reward = 0.0


class PolicyServer:
    """Serves actions from a policy and collects experience."""

    def __init__(self, policy, host: str = "127.0.0.1", port: int = 0):
        self.policy = policy
        self.host = host
        self.port = port
        self._episodes: Dict[str, _Episode] = {}
        self._complete: List[SampleBatch] = []
        self._lock = threading.Lock()
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self.total_steps = 0

    # ----------------------------------------------------------- handlers

    def _handle(self, route: str, payload: dict) -> dict:
        if route == "/start_episode":
            eid = payload["episode_id"]
            with self._lock:
                self._episodes[eid] = _Episode()
            return {"ok": True}
        if route == "/get_action":
            eid = payload["episode_id"]
            obs = np.asarray(payload["observation"], np.float32)
            action, logp, value = self.policy.compute_actions(obs[None])
            with self._lock:
                ep = self._episodes[eid]
                # reward logged since the last action belongs to that action
                if ep.rows[ACTIONS]:
                    ep.rows[REWARDS].append(ep.pending_reward)
                    ep.rows[DONES].append(False)
                ep.pending_reward = 0.0
                ep.rows[OBS].append(obs)
                ep.rows[ACTIONS].append(int(action[0]))
                ep.rows[LOGPS].append(float(logp[0]))
                ep.rows[VALUES].append(float(value[0]))
            return {"action": int(action[0])}
        if route == "/log_returns":
            eid = payload["episode_id"]
            with self._lock:
                self._episodes[eid].pending_reward += float(payload["reward"])
            return {"ok": True}
        if route == "/end_episode":
            eid = payload["episode_id"]
            with self._lock:
                ep = self._episodes.pop(eid, None)
                if ep is not None and ep.rows[ACTIONS]:
                    ep.rows[REWARDS].append(ep.pending_reward)
                    ep.rows[DONES].append(True)
                    batch = SampleBatch(
                        {k: np.asarray(v) for k, v in ep.rows.items()}
                    )
                    batch = compute_gae(batch, 0.0, self.policy.gamma, 0.95)
                    self._complete.append(batch)
                    self.total_steps += len(batch)
            return {"ok": True}
        raise ValueError(f"unknown route {route}")

    # ------------------------------------------------------------- server

    def start(self) -> str:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                try:
                    out = outer._handle(self.path, payload)
                    code = 200
                except Exception as e:  # noqa: BLE001
                    out, code = {"error": str(e)}, 400
                body = json.dumps(out).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return f"http://{self.host}:{self.port}"

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None

    def sample_batch(self, min_steps: int = 1) -> Optional[SampleBatch]:
        """Drain completed episodes once at least min_steps accumulated."""
        with self._lock:
            have = sum(len(b) for b in self._complete)
            if have < min_steps:
                return None
            batches, self._complete = self._complete, []
        return SampleBatch.concat_samples(batches)


class PolicyClient:
    """External-env side (reference: rllib/env/policy_client.py)."""

    def __init__(self, address: str):
        self.address = address.rstrip("/")
        self._n = 0

    def _post(self, route: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.address + route,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def start_episode(self) -> str:
        self._n += 1
        eid = f"ep_{self._n}"
        self._post("/start_episode", {"episode_id": eid})
        return eid

    def get_action(self, episode_id: str, observation) -> int:
        out = self._post(
            "/get_action",
            {"episode_id": episode_id, "observation": np.asarray(observation).tolist()},
        )
        return out["action"]

    def log_returns(self, episode_id: str, reward: float):
        self._post("/log_returns", {"episode_id": episode_id, "reward": float(reward)})

    def end_episode(self, episode_id: str):
        self._post("/end_episode", {"episode_id": episode_id})
