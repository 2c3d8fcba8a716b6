"""A minimal HTTP serving endpoint (stdlib only) — port of
``cnn_pde_tpu/serve_http.py``, the network-facing complement to
``serve.make_predict_fn``:

    POST /predict   body = a .npy batch (NCHW float32, np.save bytes) or a
                    JSON nested array; query ?output=labels|probs|logits
                    (default: the server's ``default_output``, which the
                    serve CLI sets from --output).  Responds JSON
                    {"output": ..., "shape": ..., "data": [...]} or, with
                    Accept: application/x-npy, raw .npy bytes.
    GET  /healthz   {"ok": true, "requests": N, "outputs": [...]}
    GET  /metrics   request/image counts, recent predict-latency
                    percentiles, micro-batch coalescing stats
    POST /reload    weight hot-swap without downtime (when the server was
                    built with a reload_fn; the serve CLI's builds a fresh
                    model from its weight source and warms its graphs)

A ThreadingHTTPServer runs one handler thread a connection; they call the
predict fns concurrently.  A captured predict (``serve.make_predict_fn``
on a CUDA model) serialises its callers on one lock a model, and a reload
swaps in the predict fns of another model, so requests in flight finish on
the old model and its graphs while new ones go to the new.
"""

from __future__ import annotations

import collections
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .serve_batch import to_host

__all__ = ["PredictServer", "serve_http", "watch_and_reload"]


def watch_and_reload(server, paths, interval_s=10.0, verbose=True):
    """Poll checkpoint ``paths`` (files or directories) in a daemon
    thread; when any mtime advances, call ``server.reload()`` — training
    writes a new best checkpoint, serving follows automatically.  The
    port's checkpoints are written to a temporary file and renamed; a
    reload that fails (a file caught mid-write) logs and retries on the
    next tick.  Returns a ``threading.Event`` — set it to stop the
    watcher."""
    stop = threading.Event()

    def mtime():
        m = 0.0
        for p in paths:
            try:
                if os.path.isdir(p):
                    m = max(m, os.path.getmtime(p))
                    for dp, _, fs in os.walk(p):
                        for f in fs:
                            m = max(m, os.path.getmtime(
                                os.path.join(dp, f)))
                else:
                    m = max(m, os.path.getmtime(p))
            except OSError:
                pass  # absent / being replaced right now
        return m

    def run():
        last = mtime()
        while not stop.wait(interval_s):
            cur = mtime()
            if cur > last:
                try:
                    server.reload()
                    last = cur
                    if verbose:
                        print("[reload-watch] checkpoint changed; "
                              "hot-swapped weights", flush=True)
                except Exception as e:  # retry next tick (mid-write etc.)
                    if verbose:
                        print(f"[reload-watch] reload failed ({e}); "
                              "retrying next tick", flush=True)

    threading.Thread(target=run, daemon=True,
                     name="reload-watch").start()
    return stop


class PredictServer:
    """Wraps a predict callable in a ThreadingHTTPServer.

    ``predict_fns``: dict output-name -> callable(images)->array (build with
    serve.make_predict_fn for each output you want to expose), or a single
    callable (exposed as 'default').
    """

    def __init__(self, predict_fns, host="127.0.0.1", port=0,
                 default_output=None, reload_fn=None):
        if callable(predict_fns):
            predict_fns = {"default": predict_fns}
        self.predict_fns = predict_fns
        self._reload_fn = reload_fn
        self.default_output = (default_output if default_output is not None
                               else next(iter(sorted(predict_fns))))
        if self.default_output not in predict_fns:
            raise ValueError(f"default_output {self.default_output!r} not in "
                             f"{sorted(predict_fns)}")
        self.n_requests = 0
        self.n_images = 0
        self._latencies_ms = collections.deque(maxlen=2048)  # recent window
        self._count_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 => persistent connections: a client reusing its
            # connection skips the per-request TCP handshake AND the
            # per-connection handler-thread spawn (ThreadingHTTPServer
            # spawns one thread per CONNECTION, not per request).  Safe
            # because _send always sets Content-Length.
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code, payload, content_type="application/json"):
                body = (json.dumps(payload).encode()
                        if content_type == "application/json" else payload)
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/healthz":
                    self._send(200, {"ok": True,
                                     "requests": outer.n_requests,
                                     "outputs": sorted(outer.predict_fns)})
                elif path == "/metrics":
                    self._send(200, outer.metrics())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path == "/reload":
                    if outer._reload_fn is None:
                        return self._send(
                            400, {"error": "no reload_fn configured"})
                    try:
                        outputs = outer.reload()
                    except Exception as e:
                        return self._send(
                            500, {"error": f"reload failed: {e}"})
                    return self._send(200, {"ok": True, "outputs": outputs})
                if path != "/predict":
                    return self._send(404, {"error": "not found"})
                params = dict(kv.split("=", 1) for kv in query.split("&")
                              if "=" in kv)
                name = params.get("output", outer.default_output)
                fn = outer.predict_fns.get(name)
                if fn is None:
                    return self._send(
                        400, {"error": f"unknown output {name!r}",
                              "outputs": sorted(outer.predict_fns)})
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                try:
                    if self.headers.get("Content-Type", "").startswith(
                            "application/json"):
                        batch = np.asarray(json.loads(raw), np.float32)
                    else:
                        batch = np.load(io.BytesIO(raw), allow_pickle=False)
                except Exception as e:  # malformed body is a client error
                    return self._send(400, {"error": f"bad batch: {e}"})
                t0 = time.perf_counter()
                try:
                    out = to_host(fn(batch))
                except Exception as e:  # shape/dtype mismatch etc.
                    return self._send(400, {"error": f"predict failed: {e}"})
                dt_ms = (time.perf_counter() - t0) * 1e3
                with outer._count_lock:  # handler threads share the counters
                    outer.n_requests += 1
                    outer.n_images += int(batch.shape[0])
                    outer._latencies_ms.append(dt_ms)
                if "application/x-npy" in self.headers.get("Accept", ""):
                    buf = io.BytesIO()
                    np.save(buf, out)
                    return self._send(200, buf.getvalue(),
                                      content_type="application/x-npy")
                self._send(200, {"output": name, "shape": list(out.shape),
                                 "data": out.tolist()})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]

    def reload(self):
        """Zero-downtime weight hot-swap (also served at POST /reload):
        call the configured ``reload_fn`` for a fresh predict-fns dict and
        swap it in atomically (in-flight requests finish on the old fns).
        The new fns are ready to serve when ``reload_fn`` returns (the
        serve CLI's have their graphs captured).  Old MicroBatchers are
        closed after a grace period so requests that already grabbed them
        still complete."""
        new = self._reload_fn()
        if callable(new):
            new = {"default": new}
        if not new:
            raise ValueError("reload_fn returned no predict fns")
        old, self.predict_fns = self.predict_fns, new  # atomic under GIL
        if self.default_output not in new:
            self.default_output = next(iter(sorted(new)))
        stale = [fn for fn in old.values()
                 if fn not in new.values() and callable(
                     getattr(fn, "close", None))]
        if stale:
            t = threading.Timer(5.0, lambda: [fn.close() for fn in stale])
            t.daemon = True
            t.start()
        return sorted(new)

    def metrics(self):
        """Serving observability snapshot (also served at GET /metrics):
        request/image counts, recent predict-latency percentiles (host-
        observed, includes any micro-batch coalescing wait), and — when
        predict fns are MicroBatchers — the device-dispatch statistics
        that show the coalescing ratio."""
        with self._count_lock:
            lat = sorted(self._latencies_ms)
            out = {"requests": self.n_requests, "images": self.n_images}
        if lat:
            def pct(p):
                return round(lat[min(len(lat) - 1,
                                     int(p / 100.0 * len(lat)))], 3)

            out["predict_ms"] = {"mean": round(sum(lat) / len(lat), 3),
                                 "p50": pct(50), "p95": pct(95),
                                 "p99": pct(99), "window": len(lat)}
        mb = {"dispatches": 0, "requests": 0}
        for fn in self.predict_fns.values():
            if hasattr(fn, "n_dispatches"):  # MicroBatcher
                mb["dispatches"] += fn.n_dispatches
                mb["requests"] += fn.n_requests
        if mb["requests"]:
            mb["coalescing"] = round(mb["requests"]
                                     / max(mb["dispatches"], 1), 2)
            out["microbatch"] = mb
        return out

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        watch = getattr(self, "_watch_stop", None)
        if watch is not None:
            watch.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for fn in self.predict_fns.values():
            close = getattr(fn, "close", None)  # MicroBatcher workers
            if callable(close):
                close()


def serve_http(predict_fns, host="127.0.0.1", port=8000, background=False,
               default_output=None, microbatch=0, microbatch_wait_ms=2.0,
               microbatch_pipeline=2, reload_fn=None,
               reload_watch_paths=None, reload_watch_interval=10.0):
    """Start serving; returns the PredictServer.  ``background=True`` runs
    the accept loop in a daemon thread (for tests / embedding);
    ``default_output`` names the fn served when /predict has no ?output=.

    ``microbatch`` > 0 wraps every predict fn in a ``MicroBatcher``
    (serve_batch.py): concurrent requests coalesce into one padded
    predict call of up to that many rows, waiting at most
    ``microbatch_wait_ms`` for company, with up to ``microbatch_pipeline``
    coalesced batches in flight at once.

    ``reload_fn`` () -> predict-fns dict enables POST /reload: zero-
    downtime weight hot-swap (re-read the checkpoint, rebuild the fns);
    micro-batch wrapping is re-applied automatically on reload.
    ``reload_watch_paths`` additionally starts a ``watch_and_reload``
    poller (every ``reload_watch_interval`` s) so new checkpoints are
    picked up without any client action."""

    def _wrap(fns):
        if callable(fns):
            fns = {"default": fns}
        if not microbatch:
            return fns
        from .serve_batch import MicroBatcher

        return {name: MicroBatcher(fn, max_batch=microbatch,
                                   max_wait_ms=microbatch_wait_ms,
                                   pipeline=microbatch_pipeline)
                for name, fn in fns.items()}

    server = PredictServer(
        _wrap(predict_fns), host=host, port=port,
        default_output=default_output,
        reload_fn=(None if reload_fn is None
                   else (lambda: _wrap(reload_fn()))))
    if reload_watch_paths and server._reload_fn is not None:
        server._watch_stop = watch_and_reload(
            server, reload_watch_paths,
            interval_s=max(float(reload_watch_interval), 0.1))
    if background:
        server.start_background()
    else:
        print(f"serving on http://{server.host}:{server.port} "
              f"(POST /predict, GET /healthz)", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
    return server
