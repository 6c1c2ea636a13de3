"""Streaming inference engine, PyTorch port.

Counterpart of the dense path of ``camradepth_tpu/serving.py``:

- a fixed-batch forward; a tail batch is padded by repeating its last
  frame and the padding is dropped from the results (``:232-241``);
- a batcher thread stacks host frames ahead of the device, and up to
  ``inflight`` batches stay queued on the device, so the copy back of
  batch N runs while batch N+1 computes;
- frames go host -> device from pinned memory with ``non_blocking=True``;
  results come back in ``_materialize``, the only point that blocks;
- depth is returned decoded to metres (inverse encoding,
  dataloader.py:243-245), and a supervised seg branch's labels as the
  argmax of its final logits;
- per-batch latency and throughput counters;
- with a wire plan, requests are compact wire dicts (``image_u8``,
  ``radar_idx``, ``radar_val``; ``data/wire.py``), decoded on the device
  into the dense feature stack, bit for bit, before the forward
  (``:59-95``, ``:141-183``);
- with ``forward_fn``, the engine serves a prebuilt forward, the
  ``torch.export`` serving artifact of ``interop/export.py``
  (``:99-176``, ``load_engine`` ``:428-442``);
- with ``mesh`` (a ``parallel/mesh.ServingMesh``), the engine serves on a
  ``data`` x ``sp`` layout of ranks, one per process (``:99-177``): every
  rank is handed the same batch, each ``data`` group takes its rows of it
  and each ``sp`` rank its rows of the image (``parallel/spatial.py``), and
  the maps are gathered to rank 0, whose results are the whole batch's;
  the other ranks' results are empty. Every rank calls the engine in the
  same order (``serving_http.follow`` does it for a server).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.config import ExperimentConfig
from camradepth_tpu_torch.data import wire as wire_codec
from camradepth_tpu_torch.interop.flax_convert import load_reference_checkpoint
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.parallel import spatial


class ServingForward(torch.nn.Module):
    """The serving forward as a module, ``x -> {"depth": [B, H, W], "seg":
    [B, H, W] | None}``: final depth clipped to [0, 1] and, with
    ``decode_depth``, decoded to metres as ``max_depth * (1 - d)``, and the
    argmax labels of the final seg logits of a supervised seg branch,
    uint8 when ``num_classes <= 255`` (``camradepth_tpu/serving.py:
    33-56``). It sets no grad mode of its own, so that ``torch.export``
    can trace it (under ``torch.no_grad()``)."""

    def __init__(self, cfg: ExperimentConfig, model,
                 decode_depth: bool = True):
        super().__init__()
        self.model = model
        self.max_depth = float(cfg.data.max_depth)
        self.decode_depth = decode_depth
        self.uint8_labels = cfg.model.num_classes <= 255

    def forward(self, x: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        out = self.model(x)
        depth = out["depth"]["final_depth"][..., 0].clamp(0.0, 1.0)
        if self.decode_depth:
            depth = self.max_depth * (1.0 - depth)
        seg = out["seg"]["final_seg"]
        if seg is not None:
            seg = seg.argmax(dim=-1)
            if self.uint8_labels:
                seg = seg.to(torch.uint8)
        return {"depth": depth, "seg": seg}


def make_serving_forward(cfg: ExperimentConfig, model,
                         decode_depth: bool = True):
    """The serving forward ``fwd(x) -> {"depth", "seg"}`` of
    :class:`ServingForward`, under ``torch.inference_mode``."""
    module = ServingForward(cfg, model, decode_depth)

    def fwd(x: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        with torch.inference_mode():
            return module(x)

    return fwd


# the wire keys a serving request needs (the GT never ships)
SERVE_WIRE_KEYS = ("image_u8", "radar_idx", "radar_val")

# a stream item: a dense feature stack, or a compact wire request
Item = Union[np.ndarray, Dict[str, np.ndarray]]


def make_serving_forward_wire(cfg: ExperimentConfig, model,
                              decode_depth: bool = True):
    """The serving forward over compact wire requests: ``fwd({image_u8,
    radar_idx, radar_val}) -> {depth, seg}``, the request decoded on the
    device into the dense features the dense forward takes, so both serve
    the same outputs."""
    dense = make_serving_forward(cfg, model, decode_depth)

    def fwd(req: Dict[str, torch.Tensor]
            ) -> Dict[str, Optional[torch.Tensor]]:
        feats = wire_codec.decode_wire_micro(
            {k: req[k] for k in SERVE_WIRE_KEYS})["features"]
        return dense(feats)

    return fwd


def item_arr(x: Item) -> np.ndarray:
    """The array of a stream item that carries its leading dims (the
    dense stack, or a wire request's image)."""
    return x["image_u8"] if isinstance(x, dict) else x


def _item_rows(x: Item) -> list:
    if isinstance(x, dict):
        return [{k: v[i] for k, v in x.items()}
                for i in range(item_arr(x).shape[0])]
    return list(x)


def _item_stack(rows: list) -> Item:
    if isinstance(rows[0], dict):
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    return np.stack(rows)


class DepthEngine:
    def __init__(
        self,
        cfg: ExperimentConfig,
        model,
        batch_size: int = 8,
        device="cuda",
        wire_plan=None,
        decode_depth: bool = True,
        forward_fn=None,
        mesh=None,
    ):
        """Serve ``model`` (a port ``CamRaDepth``, moved to ``device``) at
        a fixed ``batch_size``, depth in metres, or with ``decode_depth``
        False in the model's inverse encoding. With ``wire_plan`` (a
        ``data/wire.py`` WirePlan) the requests are compact wire dicts,
        whose channels must be the model's. ``forward_fn`` replaces the
        model's forward with a prebuilt ``fwd(x) -> {depth, seg}`` on
        ``device`` (a serving artifact, whose weights and ``decode_depth``
        are baked in; ``model`` may then be None); it takes no wire plan,
        as an artifact bakes a dense input signature. ``mesh`` serves on a
        layout of ranks (module docstring); it takes no artifact, whose
        partitioning is fixed at export time, and a wire plan only without
        spatial sharding, as the wire decode is frame-local. Raises when
        ``device`` is CUDA and no card is there."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.decode_depth = decode_depth
        self.wire_plan = wire_plan
        h, w = cfg.model.img_size
        self._in_shape = (batch_size, h, w, cfg.model.input_channels)
        if wire_plan is not None:
            if forward_fn is not None:
                raise ValueError(
                    "wire_plan and forward_fn (deployment artifact) are "
                    "mutually exclusive: artifacts bake a dense-features "
                    "input signature at export time")
            if 3 + wire_plan.n_radar_ch != cfg.model.input_channels:
                raise ValueError(
                    f"wire plan carries 3+{wire_plan.n_radar_ch} channels "
                    f"but the model expects {cfg.model.input_channels}")
        if mesh is not None:
            if forward_fn is not None:
                raise ValueError(
                    "forward_fn (deployment artifact) and mesh are mutually "
                    "exclusive: an artifact's partitioning is fixed at export "
                    "time")
            if wire_plan is not None and mesh.rows is not None:
                raise ValueError(
                    "wire_plan cannot be combined with spatial sharding: the "
                    "on-device scatter decode is frame-local; use batch "
                    "(data) sharding only")
            if batch_size % mesh.layout.data:
                raise ValueError(
                    f"batch {batch_size} is not divisible by data_parallel "
                    f"{mesh.layout.data}")
        self.mesh = mesh
        self.model = None if model is None else model.to(self.device).eval()
        if forward_fn is not None:
            self._fwd = forward_fn
        elif self.model is None:
            raise ValueError("DepthEngine needs a model or a forward_fn")
        elif wire_plan is not None:
            self._fwd = make_serving_forward_wire(cfg, self.model,
                                                  decode_depth)
        else:
            self._fwd = make_serving_forward(cfg, self.model, decode_depth)
        if mesh is not None and mesh.rows is not None:
            whole = self._fwd

            def rows_fwd(x):
                with spatial.sharded(mesh.rows):
                    return whole(x)

            self._fwd = rows_fwd
        self.frames_served = 0
        self.batches_served = 0
        self._warmed = False
        self._t_start: Optional[float] = None
        self._batch_times: list = []

    def _warm_input(self) -> Item:
        if self.wire_plan is None:
            return np.zeros(self._in_shape, np.float32)
        b, p = self.batch_size, self.wire_plan
        h, w = self.cfg.model.img_size
        return {"image_u8": np.zeros((b, h, w, 3), np.uint8),
                "radar_idx": np.zeros((b, p.radar_cap), np.int32),
                "radar_val": np.zeros((b, p.radar_cap, p.n_radar_ch),
                                      np.float32)}

    def warmup(self) -> None:
        """One forward on zeros, outside the serving timers; on the card
        it also builds the kernels."""
        self._fwd(self._to_device(self._share(self._warm_input())))[
            "depth"].cpu()
        self._warmed = True

    def _copy(self, a: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(a)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        return x

    def _share(self, features: Item) -> Item:
        """This rank's rows of a whole batch: its ``data`` rows, and of
        each frame its ``sp`` rows."""
        if self.mesh is None:
            return features
        b = self.mesh.batch_rows(self.batch_size)
        if isinstance(features, dict):
            return {k: v[b] for k, v in features.items()}
        if self.mesh.rows is None:
            return features[b]
        return features[b, self.mesh.rows.rows(features.shape[1])]

    def _to_device(self, features: Item):
        """A dense stack as the fp32 input of the forward, a wire
        request's arrays in their own dtypes."""
        if isinstance(features, dict):
            return {k: self._copy(np.ascontiguousarray(v))
                    for k, v in features.items()}
        return self._copy(np.ascontiguousarray(features, np.float32))

    def _dispatch(self, features: Item):
        """Pad, copy to the device and enqueue the forward without waiting
        for it: the returned handle is work in flight. ``features`` is a
        dense [b, H, W, C] stack, or a wire request dict (wire engines
        only)."""
        if not self._warmed:
            # a cold first request must not pollute the serving stats
            self.warmup()
        if isinstance(features, dict):
            if self.wire_plan is None:
                raise ValueError(
                    "this engine was built without a wire plan; wire "
                    "requests need a wire engine")
            features = {k: np.asarray(features[k]) for k in SERVE_WIRE_KEYS}
        n = item_arr(features).shape[0]
        if n > self.batch_size:
            raise ValueError(
                f"batch of {n} frames exceeds the engine batch "
                f"{self.batch_size}"
            )
        if n < self.batch_size:
            k = self.batch_size - n

            def pad(v):
                return np.concatenate([v, np.repeat(v[-1:], k, axis=0)],
                                      axis=0)

            features = ({key: pad(v) for key, v in features.items()}
                        if isinstance(features, dict) else pad(features))
        if self._t_start is None:
            self._t_start = time.perf_counter()
        t0 = time.perf_counter()
        out = self._fwd(self._to_device(self._share(features)))
        return out, n, t0

    def _materialize(self, handle) -> Dict[str, np.ndarray]:
        """Wait for a handle's results, copy them to the host and strip
        the tail padding. The recorded batch time spans dispatch to
        materialization."""
        out, n, t0 = handle
        if self.mesh is not None:
            out = {k: None if v is None else self.mesh.gather(v)
                   for k, v in out.items()}
        result = {}
        if out["depth"] is not None:  # None off rank 0 of a mesh
            result["depth"] = out["depth"][:n].cpu().numpy()
            if out["seg"] is not None:
                result["seg"] = out["seg"][:n].cpu().numpy()
        self._batch_times.append(time.perf_counter() - t0)
        self.frames_served += n
        self.batches_served += 1
        return result

    def infer_batch(self, features: Item) -> Dict[str, np.ndarray]:
        """features: [b <= batch_size, H, W, C], or a wire request dict of
        [b, ...] arrays; pads the tail inside."""
        if not isinstance(features, dict):
            features = np.asarray(features)
        return self._materialize(self._dispatch(features))

    def infer_stream(
        self,
        frames: Iterable[Item],
        prefetch: int = 2,
        inflight: int = 2,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Stream feature stacks or wire requests; yields per-frame
        results in order. Items are single frames ([H, W, C], or a dict of
        one frame's wire arrays) or batches ([b, H, W, C], or a dict of
        [b, ...] arrays); a batch of exactly ``batch_size`` passes
        through, any other is re-chunked."""
        q_in: queue.Queue = queue.Queue(maxsize=prefetch)
        sentinel = object()

        def batcher():
            # an exception travels through the queue: raised in this
            # thread it would leave the consumer waiting forever
            try:
                buf = []
                for f in frames:
                    if isinstance(f, dict):
                        f = {k: np.asarray(v) for k, v in f.items()
                             if k in SERVE_WIRE_KEYS}
                    else:
                        f = np.asarray(f)
                    if item_arr(f).ndim == 4:
                        nb = item_arr(f).shape[0]
                        if not buf and nb in (self.batch_size, 0):
                            if nb:
                                q_in.put(f)
                            continue
                        buf.extend(_item_rows(f))
                    else:
                        buf.append(f)
                    while len(buf) >= self.batch_size:
                        q_in.put(_item_stack(buf[: self.batch_size]))
                        buf = buf[self.batch_size:]
                if buf:
                    q_in.put(_item_stack(buf))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q_in.put(e)
            else:
                q_in.put(sentinel)

        thread = threading.Thread(target=batcher, daemon=True)
        thread.start()
        inflight = max(1, inflight)
        pending: deque = deque()

        def drain_one():
            handle = pending.popleft()
            out = self._materialize(handle)
            for i in range(handle[1]):
                yield {k: v[i] for k, v in out.items()}

        while True:
            item = q_in.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                while pending:  # finish the work in flight, then raise
                    yield from drain_one()
                raise item
            pending.append(self._dispatch(item))
            if len(pending) >= inflight:
                yield from drain_one()
        while pending:
            yield from drain_one()
        thread.join()

    def reset_stats(self) -> None:
        """Zero the serving counters and timers."""
        self.frames_served = 0
        self.batches_served = 0
        self._t_start = None
        self._batch_times = []

    def stats(self) -> Dict[str, float]:
        elapsed = (
            time.perf_counter() - self._t_start if self._t_start else 0.0
        )
        lat = {}
        if self._batch_times:
            bt = np.asarray(self._batch_times) * 1000.0
            lat = {
                "batch_ms_p50": float(np.percentile(bt, 50)),
                "batch_ms_p95": float(np.percentile(bt, 95)),
            }
        return {
            **lat,
            "frames": float(self.frames_served),
            "batches": float(self.batches_served),
            "elapsed_s": elapsed,
            "frames_per_sec": (
                self.frames_served / elapsed if elapsed > 0 else 0.0
            ),
        }


def load_engine(
    cfg: ExperimentConfig,
    checkpoint: str,
    batch_size: int = 8,
    device="cuda",
    wire_plan=None,
    mesh=None,
) -> DepthEngine:
    """A warmed-up engine serving a reference ``.pth`` checkpoint, dense or
    (with ``wire_plan``) over compact wire requests, or a serving artifact
    of ``cli export --format artifact`` (``interop/export.py``), dense
    only: its input signature is fixed at export time. ``mesh`` (a
    ``parallel/mesh.ServingMesh``) serves the checkpoint on a layout of
    ranks; every rank calls this."""
    from camradepth_tpu_torch.interop.export import (
        artifact_engine,
        is_artifact,
    )

    dev = resolve_device(device)
    if is_artifact(checkpoint):
        if wire_plan is not None:
            raise ValueError(
                "serving artifacts bake a dense input signature: wire "
                "serving needs a .pth checkpoint")
        engine = artifact_engine(checkpoint, cfg, batch_size=batch_size,
                                 device=dev, mesh=mesh)
    else:
        state = load_reference_checkpoint(checkpoint)
        model = create_model(cfg.model, device=dev, state_dict=state)
        engine = DepthEngine(cfg, model, batch_size=batch_size, device=dev,
                             wire_plan=wire_plan, mesh=mesh)
    engine.warmup()
    return engine
