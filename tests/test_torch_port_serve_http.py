"""The port's HTTP server and micro-batcher (cnn_pde_tpu_torch/serve_http.py,
serve_batch.py) on the CPU: the cases of tests/test_serve_http.py and
tests/test_serve_batch.py, on port predict fns, with the port server's
responses held against the JAX server's for the same weights (labels
equal, probabilities and logits within 1e-4, the port's full-model bound
against JAX).
"""

import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from cnn_pde_tpu.models import MNISTClassifier as JaxMNIST
from cnn_pde_tpu.serve import make_predict_fn as jax_predict_fn
from cnn_pde_tpu.serve_http import serve_http as jax_serve_http
from cnn_pde_tpu_torch.compat import state_dict_from_jax
from cnn_pde_tpu_torch.models import build_model
from cnn_pde_tpu_torch.serve import make_predict_fn
from cnn_pde_tpu_torch.serve_batch import MicroBatcher
from cnn_pde_tpu_torch.serve_http import serve_http

OUTPUTS = ("labels", "probs", "logits")


def _weights(seed):
    model = JaxMNIST()
    params, state = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(seed)))
    port = build_model("mnist", device="cpu")
    port.load_state_dict(state_dict_from_jax(params, state, "mnist"),
                         strict=True)
    return model, params, state, port


def _fns(port, buckets=None):
    return {o: make_predict_fn(port, output=o, buckets=buckets)
            for o in OUTPUTS}


@pytest.fixture(scope="module")
def servers():
    """The port server and the JAX server on the same MNIST weights."""
    model, params, state, port = _weights(0)
    fns = _fns(port)
    port_srv = serve_http(fns, port=0, background=True)
    jax_srv = jax_serve_http({o: jax_predict_fn(model, params, state,
                                                output=o) for o in OUTPUTS},
                             port=0, background=True)
    yield port_srv, jax_srv, fns
    port_srv.shutdown()
    jax_srv.shutdown()


def _url(srv):
    return f"http://{srv.host}:{srv.port}"


def _post(url, body, content_type, accept=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": content_type,
                                          **({"Accept": accept}
                                             if accept else {})})
    return urllib.request.urlopen(req, timeout=60)


def _npy(x):
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def _post_npy(base, x, output=None):
    query = f"?output={output}" if output else ""
    with _post(f"{base}/predict{query}", _npy(x), "application/x-npy",
               accept="application/x-npy") as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


@pytest.mark.parametrize("output", OUTPUTS)
def test_http_predict_npy_and_json_match_jax_server(servers, output):
    port_srv, jax_srv, fns = servers
    batch = np.random.default_rng(1).random((4, 1, 28, 28)).astype(
        np.float32)
    want = fns[output](batch).numpy()
    replies = {}
    for name, srv in (("port", port_srv), ("jax", jax_srv)):
        base = _url(srv)
        with _post(f"{base}/predict?output={output}", _npy(batch),
                   "application/x-npy") as r:
            npy_json = json.load(r)
        with _post(f"{base}/predict?output={output}",
                   json.dumps(batch.tolist()).encode(),
                   "application/json") as r:
            json_json = json.load(r)
        assert npy_json["output"] == output
        assert npy_json["shape"] == list(want.shape)
        assert npy_json["data"] == json_json["data"]
        replies[name] = np.asarray(npy_json["data"])
        raw = _post_npy(base, batch, output)
        np.testing.assert_array_equal(raw, np.asarray(npy_json["data"],
                                                      raw.dtype))
    np.testing.assert_array_equal(replies["port"], want)
    if output == "labels":
        np.testing.assert_array_equal(replies["port"], replies["jax"])
    else:
        np.testing.assert_allclose(replies["port"], replies["jax"],
                                   rtol=0, atol=1e-4)
    if output == "probs":
        np.testing.assert_allclose(replies["port"].sum(-1), 1.0, rtol=1e-5)


def test_http_health_and_errors(servers):
    port_srv, jax_srv, _ = servers
    for srv in (port_srv, jax_srv):
        base = _url(srv)
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.load(r)
        assert health["ok"] and set(health["outputs"]) == set(OUTPUTS)
        for path, body, ctype in (("/predict?output=nope", b"{}",
                                   "application/json"),
                                  ("/predict", b"not npy",
                                   "application/x-npy"),
                                  ("/predict", _npy(np.zeros((2, 3), np.float32)),
                                   "application/x-npy")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, body, ctype)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nowhere", timeout=60)
        assert e.value.code == 404


def test_http_keep_alive_connection_reuse(servers):
    """HTTP/1.1: one socket serves many requests, and a request after an
    error response still works on it (Content-Length on every path)."""
    port_srv, _, fns = servers
    conn = http.client.HTTPConnection(port_srv.host, port_srv.port,
                                      timeout=60)
    rng = np.random.default_rng(2)
    sockets = set()
    for _ in range(3):
        img = rng.random((1, 1, 28, 28)).astype(np.float32)
        conn.request("POST", "/predict?output=labels", _npy(img),
                     {"Content-Type": "application/x-npy",
                      "Accept": "application/x-npy"})
        r = conn.getresponse()
        data = r.read()
        assert r.status == 200 and r.version == 11
        np.testing.assert_array_equal(
            np.load(io.BytesIO(data), allow_pickle=False),
            fns["labels"](img).numpy())
        sockets.add(id(conn.sock))
    conn.request("POST", "/predict", b"not npy",
                 {"Content-Type": "application/x-npy"})
    r = conn.getresponse()
    assert r.status == 400 and b"bad batch" in r.read()
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read())["ok"]
    sockets.add(id(conn.sock))
    conn.close()
    assert len(sockets) == 1


def test_http_metrics_endpoint(servers):
    """/metrics: counts and latency percentiles; with micro-batched fns the
    coalescing ratio too."""
    port_srv, _, fns = servers
    img = np.random.default_rng(3).random((3, 1, 28, 28)).astype(np.float32)
    _post_npy(_url(port_srv), img, "labels")
    with urllib.request.urlopen(f"{_url(port_srv)}/metrics",
                                timeout=60) as r:
        m = json.load(r)
    assert m["requests"] >= 1 and m["images"] >= 3
    lat = m["predict_ms"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert "microbatch" not in m

    mb_srv = serve_http({"labels": fns["labels"]}, port=0, background=True,
                        microbatch=8)
    try:
        _post_npy(_url(mb_srv), img)
        with urllib.request.urlopen(f"{_url(mb_srv)}/metrics",
                                    timeout=60) as r:
            m = json.load(r)
        assert m["microbatch"] == {"dispatches": 1, "requests": 1,
                                   "coalescing": 1.0}
    finally:
        mb_srv.shutdown()


def _const(v):
    return lambda x: torch.full((x.shape[0],), float(v))


def test_http_reload_hot_swaps_weights():
    """POST /reload swaps the fns (micro-batching re-applied); a server
    without a reload_fn refuses with 400."""
    version = {"v": 0}

    def reload_fn():
        version["v"] += 1
        return {"labels": _const(version["v"])}

    srv = serve_http({"labels": _const(0)}, port=0, background=True,
                     microbatch=4, reload_fn=reload_fn)
    img = np.zeros((2, 1, 8, 8), np.float32)
    try:
        np.testing.assert_array_equal(_post_npy(_url(srv), img), [0.0, 0.0])
        for expect in (1.0, 2.0):
            with _post(f"{_url(srv)}/reload", b"", "application/json") as r:
                rep = json.load(r)
            assert rep["ok"] and rep["outputs"] == ["labels"]
            np.testing.assert_array_equal(_post_npy(_url(srv), img),
                                          [expect, expect])
        assert hasattr(next(iter(srv.predict_fns.values())), "n_dispatches")
    finally:
        srv.shutdown()
    srv2 = serve_http({"labels": _const(9)}, port=0, background=True)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{_url(srv2)}/reload", b"", "application/json")
        assert e.value.code == 400
    finally:
        srv2.shutdown()


def test_reload_watch_follows_checkpoint_mtime(tmp_path):
    ckpt = tmp_path / "best.ckpt"
    ckpt.write_bytes(b"v0")
    version = {"v": 0}

    def reload_fn():
        version["v"] += 1
        return {"labels": _const(version["v"])}

    srv = serve_http({"labels": _const(0)}, port=0, background=True,
                     reload_fn=reload_fn, reload_watch_paths=[str(ckpt)],
                     reload_watch_interval=0.1)
    img = np.zeros((1, 1, 8, 8), np.float32)
    try:
        assert _post_npy(_url(srv), img)[0] == 0.0
        time.sleep(0.3)
        ckpt.write_bytes(b"v1")
        deadline = time.time() + 5.0
        while time.time() < deadline and _post_npy(_url(srv), img)[0] == 0:
            time.sleep(0.1)
        assert _post_npy(_url(srv), img)[0] >= 1.0
    finally:
        srv.shutdown()
    assert srv._watch_stop.is_set()


def test_reload_under_concurrent_load():
    """Concurrent traffic across five reloads: every reply complete and
    from some weight version."""
    version = {"v": 0}

    def reload_fn():
        version["v"] += 1
        return {"labels": _const(version["v"])}

    srv = serve_http({"labels": _const(0)}, port=0, background=True,
                     microbatch=8, reload_fn=reload_fn)
    img = np.zeros((1, 1, 8, 8), np.float32)
    seen, errors = set(), []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                out = _post_npy(_url(srv), img)
                assert out.shape == (1,)
                seen.add(float(out[0]))
            except Exception as e:  # any failure under a swap is a bug
                errors.append(e)
                return

    threads = [threading.Thread(target=client) for _ in range(6)]
    try:
        for t in threads:
            t.start()
        for _ in range(5):
            time.sleep(0.1)
            with _post(f"{_url(srv)}/reload", b"", "application/json") as r:
                assert json.load(r)["ok"]
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        srv.shutdown()
    assert not errors, errors[:3]
    assert not any(t.is_alive() for t in threads)
    assert len(seen) >= 3 and seen <= {float(v) for v in range(6)}


def test_http_full_stack_buckets_microbatch_reload():
    """Buckets, micro-batching and a reload through the endpoint, on port
    predicts of two weight sets: concurrent odd-size requests answer as
    the per-request predict, and after the reload as the new weights'."""
    _, _, _, first = _weights(0)
    _, _, _, second = _weights(1)
    buckets = (8, 32)
    srv = serve_http({"labels": make_predict_fn(first, "labels", buckets)},
                     port=0, background=True, microbatch=16,
                     microbatch_wait_ms=5.0,
                     reload_fn=lambda: {"labels": make_predict_fn(
                         second, "labels", buckets)})
    rng = np.random.default_rng(4)
    try:
        imgs = [rng.random((b, 1, 28, 28)).astype(np.float32)
                for b in (1, 3, 1, 5, 1, 1)]
        outs = [None] * len(imgs)
        ts = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, _post_npy(_url(srv), imgs[i]))) for i in range(len(imgs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        ref1 = make_predict_fn(first, "labels")
        for img, out in zip(imgs, outs):
            np.testing.assert_array_equal(out, ref1(img).numpy())
        with _post(f"{_url(srv)}/reload", b"", "application/json") as r:
            assert json.load(r)["ok"]
        img = rng.random((5, 1, 28, 28)).astype(np.float32)
        np.testing.assert_array_equal(
            _post_npy(_url(srv), img),
            make_predict_fn(second, "labels")(img).numpy())
    finally:
        srv.shutdown()


class CountingPredict:
    """A per-row function (a tensor out, as a port predict returns) that
    records the batch sizes it was called with."""

    def __init__(self):
        self.batches = []
        self.lock = threading.Lock()

    def __call__(self, x):
        with self.lock:
            self.batches.append(int(x.shape[0]))
        x = torch.as_tensor(np.asarray(x))
        return x.sum(dim=tuple(range(1, x.ndim))) * 2.0


def test_microbatch_results_match_per_request():
    fn = CountingPredict()
    rng = np.random.default_rng(5)
    with MicroBatcher(fn, max_batch=16, max_wait_ms=20.0) as mb:
        reqs = [rng.random((b, 3, 4)).astype(np.float32)
                for b in (1, 2, 1, 5, 1)]
        results = [None] * len(reqs)
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, mb(reqs[i])))
            for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    for r, x in zip(results, reqs):
        assert isinstance(r, np.ndarray)
        np.testing.assert_array_equal(r, fn(x).numpy())
    assert mb.n_requests == len(reqs)


def test_microbatch_coalesces_concurrent_singles():
    fn = CountingPredict()
    mb = MicroBatcher(fn, max_batch=32, max_wait_ms=50.0, buckets=(1, 8, 32))
    n = 8
    xs = [np.full((1, 2), float(i), np.float32) for i in range(n)]
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = mb(xs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    mb.close()
    for i in range(n):
        np.testing.assert_allclose(results[i], [i * 2.0 * 2])
    assert len(fn.batches) < n, fn.batches
    assert all(b in (1, 8, 32) for b in fn.batches), fn.batches


def test_microbatch_oversize_and_error_paths():
    fn = CountingPredict()
    with MicroBatcher(fn, max_batch=4, max_wait_ms=1.0) as mb:
        x = np.ones((9, 2), np.float32)  # above every bucket
        np.testing.assert_array_equal(mb(x), fn(x).numpy())
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return torch.zeros(x.shape[0])

    with MicroBatcher(flaky, max_batch=4, max_wait_ms=1.0) as mb:
        with pytest.raises(RuntimeError, match="boom"):
            mb(np.ones((1, 2), np.float32))
        assert mb(np.ones((2, 2), np.float32)).shape == (2,)
    with pytest.raises(ValueError):
        MicroBatcher(fn, max_batch=0)


def test_microbatched_model_equals_per_request_predict():
    """A port model's predict behind the micro-batcher: each coalesced,
    padded request's outputs equal its own call (labels exactly, logits
    within 1e-6 of the largest entry)."""
    _, _, _, port = _weights(2)
    rng = np.random.default_rng(6)
    reqs = [rng.random((b, 1, 28, 28)).astype(np.float32)
            for b in (1, 4, 2, 7, 1, 3, 5, 1)]
    for output in ("labels", "logits"):
        fn = make_predict_fn(port, output=output)
        results = [None] * len(reqs)
        with MicroBatcher(fn, max_batch=16, max_wait_ms=20.0,
                          buckets=(4, 16)) as mb:
            threads = [threading.Thread(
                target=lambda i=i: results.__setitem__(i, mb(reqs[i])))
                for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        for r, x in zip(results, reqs):
            want = fn(x).numpy()
            if output == "labels":
                np.testing.assert_array_equal(r, want)
            else:
                assert np.abs(r - want).max() <= 1e-6 * np.abs(want).max()


def test_http_microbatch_end_to_end():
    fn = CountingPredict()
    server = serve_http({"labels": fn}, port=0, background=True,
                        microbatch=16, microbatch_wait_ms=10.0)
    try:
        xs = [np.full((1, 2), float(i), np.float32) for i in range(4)]
        results = [None] * len(xs)

        def post(i):
            req = urllib.request.Request(
                f"{_url(server)}/predict",
                data=json.dumps(xs[i].tolist()).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                results[i] = json.loads(resp.read())["data"]

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i in range(len(xs)):
            np.testing.assert_allclose(results[i], [i * 2.0 * 2])
    finally:
        server.shutdown()
