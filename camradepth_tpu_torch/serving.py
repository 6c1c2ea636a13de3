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
- per-batch latency and throughput counters.

The mesh, compact-wire and exported-artifact arguments of the JAX engine
are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from camradepth_tpu_torch import resolve_device
from camradepth_tpu_torch.config import ExperimentConfig
from camradepth_tpu_torch.interop.flax_convert import load_reference_checkpoint
from camradepth_tpu_torch.models.camradepth import create_model


def make_serving_forward(cfg: ExperimentConfig, model):
    """The serving forward ``fwd(x) -> {"depth": [B, H, W], "seg": [B, H,
    W] | None}``: final depth clipped to [0, 1] and decoded to metres as
    ``max_depth * (1 - d)``, and the argmax labels of the final seg logits
    of a supervised seg branch, uint8 when ``num_classes <= 255``
    (``camradepth_tpu/serving.py:33-56``)."""

    def fwd(x: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        with torch.inference_mode():
            out = model(x)
            depth = out["depth"]["final_depth"][..., 0].clamp(0.0, 1.0)
            depth = cfg.data.max_depth * (1.0 - depth)
            seg = out["seg"]["final_seg"]
            if seg is not None:
                seg = seg.argmax(dim=-1)
                if cfg.model.num_classes <= 255:
                    seg = seg.to(torch.uint8)
        return {"depth": depth, "seg": seg}

    return fwd


class DepthEngine:
    def __init__(
        self,
        cfg: ExperimentConfig,
        model,
        batch_size: int = 8,
        device="cuda",
    ):
        """Serve ``model`` (a port ``CamRaDepth``, moved to ``device``) at
        a fixed ``batch_size``. Raises when ``device`` is CUDA and no card
        is there."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        h, w = cfg.model.img_size
        self._in_shape = (batch_size, h, w, cfg.model.input_channels)
        self._fwd = make_serving_forward(cfg, self.model)
        self.frames_served = 0
        self.batches_served = 0
        self._warmed = False
        self._t_start: Optional[float] = None
        self._batch_times: list = []

    def warmup(self) -> None:
        """One forward on zeros, outside the serving timers; on the card
        it also builds the kernels."""
        x = torch.zeros(self._in_shape, dtype=torch.float32,
                        device=self.device)
        self._fwd(x)["depth"].cpu()
        self._warmed = True

    def _to_device(self, features: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(features, np.float32))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        return x

    def _dispatch(self, features: np.ndarray):
        """Pad, copy to the device and enqueue the forward without waiting
        for it: the returned handle is work in flight."""
        if not self._warmed:
            # a cold first request must not pollute the serving stats
            self.warmup()
        n = features.shape[0]
        if n > self.batch_size:
            raise ValueError(
                f"batch of {n} frames exceeds the engine batch "
                f"{self.batch_size}"
            )
        if n < self.batch_size:
            k = self.batch_size - n
            features = np.concatenate(
                [features, np.repeat(features[-1:], k, axis=0)], axis=0
            )
        if self._t_start is None:
            self._t_start = time.perf_counter()
        t0 = time.perf_counter()
        out = self._fwd(self._to_device(features))
        return out, n, t0

    def _materialize(self, handle) -> Dict[str, np.ndarray]:
        """Wait for a handle's results, copy them to the host and strip
        the tail padding. The recorded batch time spans dispatch to
        materialization."""
        out, n, t0 = handle
        result = {"depth": out["depth"][:n].cpu().numpy()}
        if out["seg"] is not None:
            result["seg"] = out["seg"][:n].cpu().numpy()
        self._batch_times.append(time.perf_counter() - t0)
        self.frames_served += n
        self.batches_served += 1
        return result

    def infer_batch(self, features: np.ndarray) -> Dict[str, np.ndarray]:
        """features: [b <= batch_size, H, W, C]; pads the tail inside."""
        return self._materialize(self._dispatch(np.asarray(features)))

    def infer_stream(
        self,
        frames: Iterable[np.ndarray],
        prefetch: int = 2,
        inflight: int = 2,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Stream feature stacks; yields per-frame results in order. Items
        are single frames [H, W, C] or batches [b, H, W, C]; a batch of
        exactly ``batch_size`` passes through, any other is re-chunked."""
        q_in: queue.Queue = queue.Queue(maxsize=prefetch)
        sentinel = object()

        def batcher():
            # an exception travels through the queue: raised in this
            # thread it would leave the consumer waiting forever
            try:
                buf = []
                for f in frames:
                    f = np.asarray(f)
                    if f.ndim == 4:
                        if not buf and f.shape[0] in (self.batch_size, 0):
                            if f.shape[0]:
                                q_in.put(f)
                            continue
                        buf.extend(list(f))
                    else:
                        buf.append(f)
                    while len(buf) >= self.batch_size:
                        q_in.put(np.stack(buf[: self.batch_size]))
                        buf = buf[self.batch_size:]
                if buf:
                    q_in.put(np.stack(buf))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q_in.put(e)
            else:
                q_in.put(sentinel)

        thread = threading.Thread(target=batcher, daemon=True)
        thread.start()
        inflight = max(1, inflight)
        pending: deque = deque()

        def drain_one():
            out = self._materialize(pending.popleft())
            for i in range(out["depth"].shape[0]):
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
) -> DepthEngine:
    """A warmed-up engine serving a reference ``.pth`` checkpoint."""
    dev = resolve_device(device)
    state = load_reference_checkpoint(checkpoint)
    model = create_model(cfg.model, device=dev, state_dict=state)
    engine = DepthEngine(cfg, model, batch_size=batch_size, device=dev)
    engine.warmup()
    return engine
