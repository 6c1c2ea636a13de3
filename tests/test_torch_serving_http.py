"""The port's HTTP front end (camradepth_tpu_torch.serving_http) against the
JAX package's (camradepth_tpu.serving_http), on the CPU.

- Both handlers serve one stub engine each (the same class, no model), so
  no JAX function is compiled: the same requests give the same status
  codes, content types and JSON bodies, byte for byte, and the same
  arrays in the ``.npz`` answers, on a dense and on a wire engine.
- The port's ``BatchAggregator`` passes the three cases of
  ``tests/test_serving_http.py:34-97``: coalescing, FIFO overflow into
  the next round, and an engine error reaching every waiter.
- A real engine of the ``tiny_test_config`` widths behind
  ``start_server``: concurrent single-frame requests coalesce, and each
  answer equals ``infer_batch`` of its frame bit for bit.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

from camradepth_tpu import serving_http as jax_http
from camradepth_tpu_torch import serving_http as http
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.serving import DepthEngine
from tests.torch_port import one_torch_thread  # noqa: F401

H, W, C = 4, 6, 7
PLAN = SimpleNamespace(radar_cap=5, n_radar_ch=4)
CFG = SimpleNamespace(model=SimpleNamespace(img_size=(H, W),
                                            input_channels=C),
                      data=SimpleNamespace(max_depth=80.0))


class _StubEngine:
    """The engine surface the handlers read; answers encode the input."""

    def __init__(self, wire_plan=None):
        self.batch_size = 2
        self.decode_depth = True
        self.wire_plan = wire_plan

    def warmup(self):
        pass

    def stats(self):
        return {"batch_ms_p50": 1.5, "frames": 3.0, "batches": 2.0,
                "elapsed_s": 0.25, "frames_per_sec": 12.0}

    def infer_batch(self, x):
        if isinstance(x, dict):
            depth = x["image_u8"][..., 0].astype(np.float32) + x[
                "radar_val"].sum()
        else:
            depth = x[..., 0] * 2.0
        return {"depth": depth, "seg": (depth > 1).astype(np.uint8)}


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _ask(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture(scope="module")
def servers():
    """(JAX port, port's port) for a dense and a wire stub engine, served
    request by request (batch window 0)."""
    out, started = {}, []
    for kind, plan in (("dense", None), ("wire", PLAN)):
        for name, mod in (("jax", jax_http), ("port", http)):
            srv, _ = mod.start_server(_StubEngine(plan), CFG, "127.0.0.1", 0,
                                      batch_window_ms=0)
            started.append(srv)
            out[kind, name] = srv.server_address[1]
    yield out
    with ThreadPoolExecutor(len(started)) as pool:  # each waits a poll
        list(pool.map(lambda srv: srv.shutdown(), started))
    for srv in started:
        srv.server_close()


rng = np.random.default_rng(0)
FRAME = rng.standard_normal((H, W, C)).astype(np.float32)
WIRE = dict(image_u8=rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
            radar_idx=np.array([0, 3, 7, 11, 23], np.int32),
            radar_val=rng.standard_normal((5, 4)).astype(np.float32))
REQUESTS = {
    "healthz": ("dense", "/healthz", None),
    "metrics": ("dense", "/metrics", None),
    "info": ("dense", "/v1/info", None),
    "info_wire": ("wire", "/v1/info", None),
    "get_404": ("dense", "/v2/nothing", None),
    "post_404": ("dense", "/v1/nothing", _npy(FRAME)),
    "malformed": ("dense", "/v1/depth", b"not an array"),
    "wrong_shape": ("dense", "/v1/depth", _npy(FRAME[:, :3])),
    "too_many": ("dense", "/v1/depth", _npy(np.stack([FRAME] * 3))),
    "npz_to_dense": ("dense", "/v1/depth", _npz(**WIRE)),
    "dense": ("dense", "/v1/depth", _npy(FRAME)),
    "dense_batch": ("dense", "/v1/depth", _npy(np.stack([FRAME] * 2))),
    "npy_to_wire": ("wire", "/v1/depth", _npy(FRAME)),
    "wire_missing_keys": ("wire", "/v1/depth",
                          _npz(image_u8=WIRE["image_u8"])),
    "wire_out_of_range": ("wire", "/v1/depth", _npz(**{
        **WIRE, "radar_idx": np.array([0, 1, 2, 3, H * W], np.int32)})),
    "wire_wrong_cap": ("wire", "/v1/depth", _npz(**{
        **WIRE, "radar_val": WIRE["radar_val"][:4]})),
    "wire": ("wire", "/v1/depth", _npz(**WIRE)),
}


@pytest.mark.parametrize("case", list(REQUESTS))
def test_handler_answers_as_the_jax_handler(servers, case):
    kind, path, body = REQUESTS[case]
    got = _ask(servers[kind, "port"], path, body)
    want = _ask(servers[kind, "jax"], path, body)
    assert got[:2] == want[:2]
    if got[1] == "application/x-npz":
        a, b = np.load(io.BytesIO(got[2])), np.load(io.BytesIO(want[2]))
        assert a.files == b.files == ["depth", "seg"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        assert got[2] == want[2]
    if got[1] == "application/json" and got[0] != 200:
        assert "error" in json.loads(got[2])


class _CountingEngine:
    """Counts infer_batch calls; the output encodes the input order."""

    def __init__(self, batch_size):
        self.batch_size = batch_size
        self.calls = []

    def infer_batch(self, x):
        self.calls.append(x.shape[0])
        return {"depth": x[..., 0] * 2.0}


class _Boom:
    batch_size = 2

    def infer_batch(self, x):
        raise RuntimeError("device fell over")


@pytest.mark.parametrize("case", ["coalesce", "fifo_overflow", "error"])
def test_batch_aggregator(case):
    """The cases of tests/test_serving_http.py:34-97."""
    n, batch, wait = {"coalesce": (4, 4, 1000.0),
                      "fifo_overflow": (3, 2, 500.0),
                      "error": (2, 2, 500.0)}[case]
    eng = _Boom() if case == "error" else _CountingEngine(batch)
    agg = http.BatchAggregator(eng, max_wait_ms=wait)
    try:
        xs = [np.full((1, 2, 2, 3), float(i), np.float32) for i in range(n)]
        with ThreadPoolExecutor(n) as pool:
            futs = [pool.submit(agg.infer, x) for x in xs]
            if case == "error":
                for f in futs:
                    with pytest.raises(RuntimeError, match="fell over"):
                        f.result(timeout=30)
                return
            outs = [f.result(timeout=30) for f in futs]
        for i, o in enumerate(outs):  # each result reaches its request
            np.testing.assert_array_equal(o["depth"],
                                          np.full((1, 2, 2), 2.0 * i))
        # four 1-frame requests run as one batch; three over a batch of 2
        # as a full round and a spill
        assert sorted(eng.calls) == ([4] if case == "coalesce" else [1, 2])
    finally:
        agg.close()


def test_real_engine_behind_the_server():
    cfg = tiny_test_config()
    model = create_model(cfg.model, device="cpu", seed=5)
    engine = DepthEngine(cfg, model, batch_size=2, device="cpu")
    srv, thread = http.start_server(engine, cfg, "127.0.0.1", 0,
                                    batch_window_ms=200.0)
    port = srv.server_address[1]
    try:
        h, w = cfg.model.img_size
        frames = np.random.default_rng(1).standard_normal(
            (2, h, w, cfg.model.input_channels)).astype(np.float32)
        engine.reset_stats()
        barrier = threading.Barrier(2)

        def post(x):
            barrier.wait(timeout=30)
            return _ask(port, "/v1/depth", _npy(x))

        with ThreadPoolExecutor(2) as pool:
            answers = list(pool.map(post, frames))
        served_batches = engine.stats()["batches"]
        for x, (code, kind, body) in zip(frames, answers):
            assert (code, kind) == (200, "application/x-npz")
            got = np.load(io.BytesIO(body))
            assert got.files == ["depth"]
            np.testing.assert_array_equal(
                got["depth"], engine.infer_batch(x[None])["depth"])
        assert served_batches < len(frames)  # the requests coalesced
        info = json.loads(_ask(port, "/v1/info")[2])
        assert info["batch_size"] == 2 and info["img_size"] == [h, w]
    finally:
        srv.shutdown()
        srv.server_close()
        srv._camradepth_aggregator.close()
        thread.join(timeout=30)
        assert not thread.is_alive()
