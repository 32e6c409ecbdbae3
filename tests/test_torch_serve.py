"""ray_tpu_torch's Serve layer on the CPU: the cases of tests/test_serve.py
that need no engine, on the port's runtime.

Each test starts its own cluster (as tests/test_serve.py does) and shuts it
down; every `get` carries a timeout, so a wedged cluster fails the test
instead of hanging the sweep.  HTTP proxies bind ephemeral ports, so this
file can run beside tests/test_serve.py.
"""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve


@pytest.fixture
def cluster():
    info = rt.init(num_cpus=4)
    try:
        yield info
    finally:
        rt.shutdown()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.headers, resp.read()


def test_function_deployment(cluster):
    @serve.deployment
    def square(x):
        return x * x

    handle = serve.run(square.bind())
    assert rt.get(handle.remote(7), timeout=120) == 49


def test_class_deployment_with_state(cluster):
    @serve.deployment(name="adder")
    class Adder:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, x):
            return x + self.offset

        def peek(self):
            return self.offset

    handle = serve.run(Adder.bind(10))
    assert rt.get(handle.remote(5), timeout=120) == 15
    assert rt.get(handle.method("peek").remote(), timeout=60) == 10


def test_multiple_replicas_round_robin(cluster):
    @serve.deployment(num_replicas=2)
    class Who:
        def __call__(self, _):
            import os

            return os.getpid()

    handle = serve.run(Who.bind())
    pids = set(rt.get([handle.remote(None) for _ in range(8)], timeout=120))
    assert len(pids) == 2


def test_batching(cluster):
    @serve.deployment
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        async def __call__(self, x):
            return await self.handle(x)

        def sizes(self):
            return self.batch_sizes

    handle = serve.run(Batched.bind())
    results = rt.get([handle.remote(i) for i in range(8)], timeout=120)
    assert sorted(results) == [0, 2, 4, 6, 8, 10, 12, 14]
    sizes = rt.get(handle.method("sizes").remote(), timeout=60)
    assert max(sizes) > 1, f"requests were never coalesced: {sizes}"


def test_torch_model_deployment(cluster):
    """A torch module behind a deployment, on the CPU of a pool worker
    (the analog of tests/test_serve.py's jitted-jax deployment)."""

    @serve.deployment
    class TorchModel:
        def __init__(self):
            import torch

            self.w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))

        def __call__(self, x):
            import torch

            return float((torch.tensor(x, dtype=torch.float32) @ self.w).sum())

    handle = serve.run(TorchModel.bind())
    out = rt.get(handle.remote([[1.0] * 8] * 8), timeout=180)
    assert isinstance(out, float)


def test_http_proxy(cluster):
    @serve.deployment(route_prefix="/double")
    def double(x):
        return x * 2

    serve.run(double.bind())
    url = serve.start_http_proxy(port=0)
    deadline = time.time() + 60
    while True:
        try:
            _, raw = _post(url + "/double", 21, timeout=30)
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(1)
    assert json.loads(raw)["result"] == 42


def test_http_engine_stream_is_not_ported(cluster):
    """Server-Sent Events token streams are the serve engine's (ported:
    tests/test_torch_serve_engine.py).  A deployment that hosts no engine
    has none to stream: the proxy answers 500 at once, and the handle's
    stream_tokens raises the replica's AttributeError, typed."""

    @serve.deployment(name="sse_echo")
    def sse_echo(x):
        return x

    handle = serve.run(sse_echo.bind())
    url = serve.start_http_proxy(port=0)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url + "/sse_echo?stream=sse", 1)
    assert err.value.code == 500
    assert err.value.read().decode().startswith("stream failed")
    with pytest.raises(AttributeError, match="engine_stream_start"):
        next(handle.stream_tokens(1))


def test_config_update_propagates_to_live_handle(cluster):
    @serve.deployment(name="versioned")
    def v1(x):
        return ("v1", x)

    handle = serve.run(v1.bind())
    assert tuple(rt.get(handle.remote(1), timeout=120)) == ("v1", 1)

    @serve.deployment(name="versioned")
    def v2(x):
        return ("v2", x)

    serve.run(v2.bind())  # rolling replace publishes the version bump
    deadline = time.time() + 60
    while True:
        got = tuple(rt.get(handle.remote(2), timeout=60))
        if got == ("v2", 2):
            break
        assert got == ("v1", 2)  # old generation may serve during rollout
        assert time.time() < deadline, "handle never saw the new version"
        time.sleep(0.5)


def test_deployment_graph_composition(cluster):
    @serve.deployment(name="embedder")
    def embed(x):
        return x * 10

    @serve.deployment(name="ranker")
    class Ranker:
        def __init__(self, embedder):
            self.embedder = embedder  # a DeploymentHandle inside the replica

        def __call__(self, x):
            import ray_tpu_torch

            return ray_tpu_torch.get(self.embedder.remote(x), timeout=60) + 1

    handle = serve.run(Ranker.bind(embed.bind()))
    assert rt.get(handle.remote(4), timeout=120) == 41
    assert "embedder" in serve.list_deployments()


def test_controller_recovery_after_kill(cluster):
    @serve.deployment(name="counter", num_replicas=1)
    class Counter:
        def __init__(self):
            self.n = 0

        def __call__(self):
            self.n += 1
            return self.n

    handle = serve.run(Counter.bind())
    assert rt.get(handle.remote(), timeout=120) == 1
    assert rt.get(handle.remote(), timeout=60) == 2

    rt.kill(rt.get_actor("_serve_controller"))
    time.sleep(1.0)

    from ray_tpu_torch.serve.api import _get_or_create_controller

    _get_or_create_controller()
    deps = serve.list_deployments()
    assert "counter" in deps, deps
    assert deps["counter"]["num_replicas"] == 1
    # the replica actor itself survived: the counter continues
    assert rt.get(serve.get_deployment_handle("counter").remote(), timeout=60) == 3


@serve.deployment(name="echo_from_schema")
def _echo_for_schema(x):
    return {"echo": x}


def test_declarative_schema_apply(cluster):
    from ray_tpu_torch.serve import schema as serve_schema

    cfg = {
        "deployments": [
            {"name": "echo_from_schema", "import_path": "tests.test_torch_serve:_echo_for_schema", "num_replicas": 2}
        ]
    }
    out = serve_schema.apply(cfg)
    assert out["applied"] == ["echo_from_schema"]
    assert serve.list_deployments()["echo_from_schema"]["target"] == 2
    handle = serve.get_deployment_handle("echo_from_schema")
    assert rt.get(handle.remote(3), timeout=120) == {"echo": 3}
    with pytest.raises(ValueError):
        serve_schema.ServeApplicationSchema.from_dict({"deployments": []})
    with pytest.raises(ValueError):
        serve_schema.DeploymentSchema.from_dict({"name": "x", "import_path": "a:b", "bogus": 1})


@serve.deployment(name="reconf")
class _Reconfigurable:
    def __init__(self):
        import uuid

        self.token = uuid.uuid4().hex  # changes iff the instance restarts
        self.threshold = 0

    def reconfigure(self, user_config):
        self.threshold = user_config.get("threshold", 0)

    def __call__(self, _x):
        return {"token": self.token, "threshold": self.threshold}


def test_user_config_reconfigures_live_replicas(cluster):
    from ray_tpu_torch.serve import schema as serve_schema

    def cfg(threshold):
        return {"deployments": [{"name": "reconf", "import_path": "tests.test_torch_serve:_Reconfigurable",
                                 "user_config": {"threshold": threshold}}]}

    serve_schema.apply(cfg(5))
    handle = serve.get_deployment_handle("reconf")
    first = rt.get(handle.remote(0), timeout=120)
    assert first["threshold"] == 5
    assert serve_schema.apply(cfg(9))["applied"] == ["reconf"]
    deadline = time.time() + 30
    while time.time() < deadline:
        cur = rt.get(handle.remote(0), timeout=120)
        if cur["threshold"] == 9:
            break
        time.sleep(0.2)
    assert cur["threshold"] == 9, cur
    assert cur["token"] == first["token"]  # reconfigured in place, not restarted


def test_http_streaming_endpoint(cluster):
    @serve.deployment(name="http_streamer")
    def http_streamer(n):
        for i in range(int(n)):
            yield {"i": i}

    serve.run(http_streamer.bind())
    url = serve.start_http_proxy(0)
    headers, raw = _post(url + "/http_streamer?stream=1", 5)
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [line for line in raw.decode().splitlines() if line]
    assert [json.loads(line)["i"] for line in lines] == [0, 1, 2, 3, 4]


def test_per_node_http_proxies(cluster):
    @serve.deployment(name="pp_echo")
    def pp_echo(x):
        return {"got": x}

    serve.run(pp_echo.bind())
    url = serve.start_http_proxy(0)
    addrs = serve.proxy_addresses()
    assert len(addrs) == len([n for n in rt.nodes() if n["Alive"]])
    assert url in addrs.values()
    for u in addrs.values():
        assert json.loads(_post(u + "/pp_echo", 7)[1])["result"] == {"got": 7}


def test_streaming_deployment(cluster):
    @serve.deployment(name="streamer")
    class Streamer:
        def __call__(self, n):
            for i in range(n):
                yield {"token": i}

        async def agen(self, n):
            for i in range(n):
                yield i * 10

    handle = serve.run(Streamer.bind())
    assert [c["token"] for c in handle.stream(40)] == list(range(40))
    assert list(handle.method("agen").stream(5)) == [0, 10, 20, 30, 40]
    it = handle.stream(1000)
    assert next(it)["token"] == 0
    it.close()  # abandoned: the cancel RPC releases the replica-side slot

    from ray_tpu_torch.serve.api import _get_or_create_controller

    info = rt.get(_get_or_create_controller().get_handles.remote("streamer"), timeout=30)
    deadline = time.time() + 10
    while time.time() < deadline:
        stats = rt.get(info["replicas"][0].stats.remote(), timeout=30)
        if stats["inflight"] == 0:
            break
        time.sleep(0.2)
    assert stats["inflight"] == 0 and stats["handled"] >= 2


def test_handle_prefers_local_replicas():
    """Locality is the routing tiebreak, not a filter."""
    from ray_tpu_torch.serve.handle import DeploymentHandle

    class FakeReplica:
        def __init__(self, aid):
            self._actor_id = aid

    h = DeploymentHandle("t", None)  # no controller needed
    h._replicas = [FakeReplica(b"a"), FakeReplica(b"b")]
    h._replica_names = ["ra", "rb"]
    h._replica_nodes = ["node_a", "node_b"]
    h._my_node = "node_b"
    h._max_inflight = 2
    h._version = 1
    h._last_refresh = time.monotonic()
    h._last_refresh_attempt = h._last_refresh

    assert h._pick_replica()[0] == b"b"  # equal pressure: local wins the tie
    assert h._pick_replica()[0] == b"a"  # local carries load: idle remote wins
    h._inflight = {b"a": 2, b"b": 1}
    assert h._pick_replica()[0] == b"b"
