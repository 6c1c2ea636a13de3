"""HTTP front end of the streaming DepthEngine, stdlib only.

Counterpart of ``camradepth_tpu/serving_http.py``: the same endpoints,
status codes, JSON keys and error texts, over any engine of the port
(a ``.pth`` checkpoint, or a serving artifact of ``interop/export.py``).

  python -m camradepth_tpu_torch.cli serve ... --http-port 8080

API (all responses JSON unless noted):
  GET  /healthz   liveness + engine serving stats
  GET  /metrics   the stats in Prometheus text format
  GET  /v1/info   model/engine geometry (batch, HxW, channels, wire caps)
  POST /v1/depth  body: one ``.npy`` array, float32 ``[H, W, C]`` or
                  ``[b, H, W, C]`` (b <= engine batch; padded inside).
                  WIRE engines (serve --wire + data.wire_radar_cap)
                  instead take an ``.npz`` with ``image_u8`` [H, W, 3]
                  uint8, ``radar_idx`` [cap] int32 and ``radar_val``
                  [cap, R] float32 (optionally [b, ...] batched), decoded
                  on the device (``data/wire.py``; caps are in /v1/info).
                  Response: ``.npz`` with ``depth`` [b, H, W] metric
                  metres (or the raw inverse encoding of an engine built
                  with decode_depth=False) and ``seg`` [b, H, W] labels
                  when the variant has a supervised seg head.

Concurrent requests coalesce into one device batch
(:class:`BatchAggregator`), whose thread makes every device call; with a
batch window of 0 a lock serializes the handlers' device calls instead.
The engine's forward enters ``torch.inference_mode`` itself, in whichever
thread calls it. The ThreadingHTTPServer keeps I/O (request reads,
response writes) concurrent.

An engine on a serving mesh (``DepthEngine(mesh=...)``, one process per
rank) is served by rank 0 alone, through :class:`MeshLeader`: each batch
it serves (a coalesced round of the aggregator) is first broadcast to the
other ranks, which :func:`follow` it until a stop message.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from camradepth_tpu_torch.serving import SERVE_WIRE_KEYS, item_arr


def _concat_requests(arrs):
    """Concatenate request payloads along the batch axis — dense
    feature arrays or wire request dicts (one round never mixes: a
    given engine accepts exactly one of the two)."""
    if isinstance(arrs[0], dict):
        return {k: np.concatenate([a[k] for a in arrs]) for k in arrs[0]}
    return np.concatenate(arrs)


class BatchAggregator:
    """Cross-request micro-batching (the TF-Serving pattern): concurrent
    single-frame POSTs coalesce into one device batch instead of
    serializing as batch-1 calls, so the engine serves whole batches
    under concurrent load.

    A request blocks until its frames are served. The collector takes
    whatever is pending the moment the device frees up, waiting at most
    ``max_wait_ms`` after a round's first arrival to let stragglers
    join; requests that would overflow the engine batch stay queued for
    the next round (FIFO, so no starvation)."""

    def __init__(self, engine, max_wait_ms: float = 3.0):
        self.engine = engine
        self.max_wait = max_wait_ms / 1000.0
        self._cv = threading.Condition()
        self._pending = []  # [dict(arr, event, result, error)]
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def infer(self, arr) -> dict:
        req = {"arr": arr, "event": threading.Event(), "result": None,
               "error": None}
        with self._cv:
            if not self._running:
                # a request racing server teardown must fail fast — once
                # close()'s final sweep has run, nothing would ever set
                # this event
                raise RuntimeError("server shutting down")
            self._pending.append(req)
            self._cv.notify()
        req["event"].wait()
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    def _take_round(self):
        """Wait for work, give stragglers max_wait to join, then take
        the longest FIFO prefix that fits the engine batch."""
        with self._cv:
            while self._running and not self._pending:
                self._cv.wait()
            if not self._running:
                return []
            deadline = time.monotonic() + self.max_wait
            while self._running:
                have = sum(item_arr(r["arr"]).shape[0]
                           for r in self._pending)
                left = deadline - time.monotonic()
                if have >= self.engine.batch_size or left <= 0:
                    break
                self._cv.wait(timeout=left)
            batch, used = [], 0
            while self._pending:
                n = item_arr(self._pending[0]["arr"]).shape[0]
                if used + n > self.engine.batch_size:
                    break
                used += n
                batch.append(self._pending.pop(0))
            return batch

    def _loop(self):
        while self._running:
            batch = self._take_round()
            if not batch:
                continue
            try:
                x = _concat_requests([r["arr"] for r in batch])
                out = self.engine.infer_batch(x)
                off = 0
                for r in batch:
                    n = item_arr(r["arr"]).shape[0]
                    r["result"] = {k: v[off: off + n]
                                   for k, v in out.items()}
                    off += n
            except Exception as e:  # surface to every waiting request
                for r in batch:
                    r["error"] = e
            finally:
                for r in batch:
                    r["event"].set()

    def close(self):
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout=5)
        with self._cv:  # infer() refuses new work once _running is
            # False, so this sweep under the lock sees every request
            leftover, self._pending = self._pending, []
        for r in leftover:  # unblock anything still queued
            r["error"] = RuntimeError("server shutting down")
            r["event"].set()


def _broadcast(message=None):
    """Rank 0's ``message`` on every rank of the process group."""
    import torch.distributed as dist

    box = [message]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class MeshLeader:
    """Rank 0's engine on a serving mesh, as the front end calls it: each
    batch (and a warm-up) is broadcast to the other ranks before rank 0
    runs it, so that every rank runs the same forward; :meth:`stop` ends
    the other ranks' :func:`follow`. Other attributes are the engine's."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def warmup(self) -> None:
        if not self.engine._warmed:
            _broadcast(("warmup", None))
            self.engine.warmup()

    def infer_batch(self, features):
        _broadcast(("batch", features))
        return self.engine.infer_batch(features)

    def stop(self) -> None:
        _broadcast(("stop", None))


def follow(engine) -> None:
    """A rank other than 0 of a serving mesh: run each batch rank 0's
    :class:`MeshLeader` broadcasts, until its stop message."""
    while True:
        kind, features = _broadcast()
        if kind == "stop":
            return
        if kind == "warmup":
            engine.warmup()
        else:
            engine.infer_batch(features)


def make_handler(engine, cfg, aggregator: Optional[BatchAggregator] = None):
    lock = threading.Lock()
    h, w = cfg.model.img_size
    c = cfg.model.input_channels

    class Handler(BaseHTTPRequestHandler):
        # quiet request logging (stdout belongs to the stats line)
        def log_message(self, *a):  # noqa: D102
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._json(200, {"status": "ok", **engine.stats()})
            elif self.path == "/metrics":
                # Prometheus text exposition format (stdlib-only)
                s = engine.stats()
                lines = []
                for k, v in s.items():
                    name = f"camradepth_{k}"
                    kind = ("counter" if k in ("frames", "batches")
                            else "gauge")
                    lines.append(f"# TYPE {name} {kind}")
                    lines.append(f"{name} {v}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/info":
                plan = getattr(engine, "wire_plan", None)
                self._json(200, {
                    "batch_size": engine.batch_size,
                    "img_size": [h, w],
                    "input_channels": c,
                    "decode_depth": engine.decode_depth,
                    "max_depth": float(cfg.data.max_depth),
                    "wire": plan is not None,
                    **({"wire_radar_cap": plan.radar_cap,
                        "wire_radar_channels": plan.n_radar_ch}
                       if plan is not None else {}),
                })
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def _wire_request(self, npz, plan):
            """Validate + normalize an .npz wire body -> (request, err).
            Shapes are pinned to the engine's plan, whose caps the
            engine's batches are padded to (published in /v1/info)."""
            missing = [k for k in SERVE_WIRE_KEYS if k not in npz.files]
            if missing:
                return None, f"wire request missing keys {missing}"
            img, idx, val = (npz[k] for k in SERVE_WIRE_KEYS)
            if img.ndim == 3:
                img, idx, val = img[None], idx[None], val[None]
            b = img.shape[0]
            if not (img.shape == (b, h, w, 3) and img.dtype == np.uint8
                    and idx.shape == (b, plan.radar_cap)
                    and val.shape == (b, plan.radar_cap,
                                      plan.n_radar_ch)
                    and np.issubdtype(idx.dtype, np.integer)
                    and 0 < b <= engine.batch_size):
                return None, (
                    f"expected image_u8 uint8 [b<={engine.batch_size},"
                    f" {h}, {w}, 3], radar_idx int [b, "
                    f"{plan.radar_cap}], radar_val [b, "
                    f"{plan.radar_cap}, {plan.n_radar_ch}] (or all "
                    f"unbatched); got image {img.dtype} "
                    f"{list(img.shape)}, idx {idx.dtype} "
                    f"{list(idx.shape)}, val {list(val.shape)}"
                )
            if idx.min() < 0 or idx.max() >= h * w:
                # out-of-range flat indices would be silently dropped
                # (>= h*w) or wrapped (negative) by the device scatter —
                # wrong-geometry clients must get a 400, not wrong depth
                return None, (
                    f"radar_idx values must be flat pixel indices in "
                    f"[0, {h * w}) for the {h}x{w} geometry; got range "
                    f"[{int(idx.min())}, {int(idx.max())}]"
                )
            return {
                "image_u8": np.ascontiguousarray(img),
                "radar_idx": np.ascontiguousarray(idx, np.int32),
                "radar_val": np.ascontiguousarray(val, np.float32),
            }, None

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/depth":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            plan = getattr(engine, "wire_plan", None)
            try:
                n = int(self.headers.get("Content-Length", 0))
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
            except Exception as e:  # malformed body -> client error
                self._json(400, {"error": f"expected a .npy/.npz body: {e}"})
                return
            if isinstance(arr, np.lib.npyio.NpzFile):
                if plan is None:
                    self._json(400, {"error": (
                        "this engine serves dense .npy requests; wire "
                        ".npz bodies need `serve --wire` with "
                        "data.wire_radar_cap set"
                    )})
                    return
                arr, err = self._wire_request(arr, plan)
                if err is not None:
                    self._json(400, {"error": err})
                    return
            elif plan is not None:
                self._json(400, {"error": (
                    "this engine serves compact wire requests: POST an "
                    ".npz with image_u8 [H, W, 3] uint8, radar_idx "
                    f"[{plan.radar_cap}] int32, radar_val "
                    f"[{plan.radar_cap}, {plan.n_radar_ch}] float32 "
                    "(see /v1/info)"
                )})
                return
            else:
                if arr.ndim == 3:
                    arr = arr[None]
                if (arr.ndim != 4 or arr.shape[1:] != (h, w, c)
                        or arr.shape[0] > engine.batch_size
                        or arr.shape[0] == 0):
                    self._json(400, {"error": (
                        f"expected float32 [b<={engine.batch_size}, {h}, "
                        f"{w}, {c}] (or unbatched [H, W, C]), got "
                        f"{arr.dtype} {list(arr.shape)}"
                    )})
                    return
                arr = np.ascontiguousarray(arr, np.float32)
            if aggregator is not None:
                try:
                    out = aggregator.infer(arr)
                except RuntimeError as e:
                    self._json(503, {"error": str(e)})
                    return
            else:
                with lock:  # device calls serialized; I/O is not
                    out = engine.infer_batch(arr)
            buf = io.BytesIO()
            np.savez(buf, **out)
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-npz")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def start_server(engine, cfg, host: str = "0.0.0.0", port: int = 8080,
                 batch_window_ms: float = 3.0,
                 ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Start the server on a daemon thread; returns (server, thread).
    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``server.server_address[1]``. Call ``server.shutdown()`` to stop.
    ``batch_window_ms > 0`` turns on cross-request micro-batching
    (:class:`BatchAggregator`); 0 serializes requests one by one."""
    engine.warmup()  # build the kernels before the first request
    agg = (BatchAggregator(engine, batch_window_ms)
           if batch_window_ms > 0 else None)
    srv = ThreadingHTTPServer((host, port),
                              make_handler(engine, cfg, agg))
    srv._camradepth_aggregator = agg  # for shutdown/tests
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def serve_forever(engine, cfg, host: str, port: int,
                  batch_window_ms: float = 3.0) -> None:
    """Blocking CLI entry: serve until SIGINT, then print final stats. On
    a serving mesh rank 0 serves through a :class:`MeshLeader` and stops
    the other ranks at the end; they follow it."""
    from camradepth_tpu_torch.parallel import multihost

    if getattr(engine, "mesh", None) is not None:
        if not multihost.is_primary():
            follow(engine)
            return
        leader = MeshLeader(engine)
        try:
            _serve_until_interrupted(leader, cfg, host, port, batch_window_ms)
        finally:
            leader.stop()
        return
    _serve_until_interrupted(engine, cfg, host, port, batch_window_ms)


def _serve_until_interrupted(engine, cfg, host, port, batch_window_ms):
    srv, t = start_server(engine, cfg, host, port,
                          batch_window_ms=batch_window_ms)
    print(json.dumps({
        "serving": f"http://{host}:{srv.server_address[1]}",
        "batch_size": engine.batch_size,
    }), flush=True)
    try:
        t.join()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        if srv._camradepth_aggregator is not None:
            srv._camradepth_aggregator.close()
        print(json.dumps(engine.stats()), flush=True)
