"""Input pipeline: threaded host loader -> fixed-shape numpy batches.

The package's own copy of ``camradepth_tpu/data/pipeline.py``: a thread
pool decodes jpgs (cv2), loads the .npy artifacts and assembles the
reference channel stack (``data/channels.py``), or with a wire plan the
compact wire example (``data/wire.py``), which the consumer decodes on the
device; batches are fixed-shape numpy, and an eval batch pads its ragged
tail by repeating the last frame and marks it in ``batch["valid"]``. The
caller copies batches to the device. In a multi-process run each rank's
train loader reads its strided share of the train rows (``process_shard``
of :func:`make_loaders`).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from pathlib import Path
from typing import Dict, Iterator, Sequence

import numpy as np

from camradepth_tpu_torch.config import ConfigError, DataConfig
from camradepth_tpu_torch.data import channels as ch
from camradepth_tpu_torch.data import wire as wire_codec
from camradepth_tpu_torch.data.split import load_split, split_ranges

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _imread_resized(path: str, hw) -> np.ndarray:
    """cv2.imread (BGR) + INTER_NEAREST resize to (H, W)
    (dataloader.py:225-227)."""
    if cv2 is None:
        raise RuntimeError("cv2 is needed to decode the jpg artifacts")
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    h, w = hw
    if img.shape[:2] != (h, w):
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)
    return img


def _load_npy(path: str) -> np.ndarray:
    """np.load through mmap (each artifact is read once), or eagerly for
    files mmap cannot serve."""
    try:
        return np.load(path, mmap_mode="r")
    except ValueError:
        return np.load(path)


def load_frame_arrays(row: Sequence[str], cfg: DataConfig
                      ) -> Dict[str, np.ndarray]:
    """Read the artifacts one frame needs (skips types the channel flags
    don't use)."""
    arrays: Dict[str, np.ndarray] = {}
    arrays["image"] = _imread_resized(str(row[0]), cfg.image_dimension)
    arrays["gt"] = _load_npy(str(row[6]))
    arrays["mseg"] = _load_npy(str(row[3]))
    if cfg.filtered_radar:
        arrays["radar_filtered"] = _load_npy(str(row[2]))
    elif not cfg.sparse_lidar:
        arrays["radar"] = _load_npy(str(row[1]))
        if cfg.rad_vel:
            arrays["rad_vel"] = _load_npy(str(row[5]))
        if cfg.im_uv:
            arrays["im_uv"] = _load_npy(str(row[4]))
    return arrays


class NuscenesFrames:
    """Random-access frame store over a split table (reference
    NuscenesDataset, dataloader.py:197-336). With ``wire_plan`` set its
    items are compact wire examples (``data/wire.py``) in place of the
    dense feature stack."""

    def __init__(self, rows: np.ndarray, cfg: DataConfig, seed: int = 0,
                 wire_plan=None):
        self.rows = rows
        self.cfg = cfg
        self.wire_plan = wire_plan
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.rows)

    def name(self, index: int) -> str:
        # frame id derived from the gt path (dataloader.py:332)
        return Path(str(self.rows[index][6])).name.split(".")[0] + ".png"

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        arrays = load_frame_arrays(self.rows[index], self.cfg)
        if self.wire_plan is not None:
            out = wire_codec.encode_frame_wire(arrays, self.cfg,
                                               self.wire_plan)
        else:
            out = ch.assemble_frame(arrays, self.cfg, rng=self._rng)
        out["index"] = np.int32(index)
        return out


class BatchLoader:
    """Threaded, prefetching batch iterator with fixed shapes.

    Yields dicts of stacked numpy arrays. Drops the ragged tail batch when
    shuffling (training) and pads + masks it otherwise (evaluation), so
    every frame counts.
    """

    def __init__(
        self,
        frames: NuscenesFrames,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.frames = frames
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Make the next ``iter`` give epoch ``epoch``'s order (0-based),
        as the ``epoch + 1``-th iteration of a fresh loader would: a
        resumed run then sees the batches of an uninterrupted one."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.frames)
        if self.shuffle:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        order = np.arange(len(self.frames))
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(order)
        for b in range(len(self)):
            yield order[b * self.batch_size: (b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            window: collections.deque = collections.deque()
            batches = self._index_batches()

            def submit_next():
                try:
                    idx = next(batches)
                except StopIteration:
                    return False
                futs = [pool.submit(self.frames.__getitem__, int(i))
                        for i in idx]
                window.append(futs)
                return True

            for _ in range(self.prefetch):
                if not submit_next():
                    break
            while window:
                futs = window.popleft()
                submit_next()
                examples = [f.result() for f in futs]
                pad = self.batch_size - len(examples)
                valid = np.ones((self.batch_size,), np.float32)
                if pad:
                    examples.extend([examples[-1]] * pad)
                    valid[len(examples) - pad:] = 0.0
                batch = {k: np.stack([e[k] for e in examples])
                         for k in examples[0]}
                batch["valid"] = valid
                yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def make_loaders(cfg: DataConfig, batch_size: int, split_path=None,
                 wire: bool = False, wire_eval: bool = False,
                 process_shard=None):
    """Train/val/test loaders over a split file (reference
    make_dataloaders, dataloader.py:22-50): train = the first rows,
    shuffled; val = the next ones; test = the remainder. A split with no
    rows for a part gives None for it.

    ``wire`` makes the train loader's items compact wire examples,
    ``wire_eval`` those of val and test (``camradepth_tpu/data/
    pipeline.py:204-275``). All of them share one plan, probed once from
    the head of the split, so every loader has the same shapes. Where the
    codec does not suit the config or the data, the loaders stay dense,
    or with ``data.wire_format=on`` this raises :class:`ConfigError`.

    ``process_shard=(rank, world)``: the train rows are cut to a multiple of
    ``world`` (every rank then has as many batches) and this rank reads the
    strided rows ``[rank::world]``; ``batch_size`` is then the rank's share
    of the global batch. Val and test stay whole on every rank."""
    rows = load_split(split_path or cfg.split_path)
    tr, va, te = split_ranges(len(rows), cfg.effective_train_val_split)
    plan = None
    if (wire or wire_eval) and len(rows):
        plan = wire_codec.plan_wire(rows, cfg)
        if plan is None and cfg.wire_format == "on":
            raise ConfigError(
                "data.wire_format=on, but the wire codec does not cover "
                "this channel config or dataset (sparse_lidar, im_uv, "
                "images that are not uint8, or radar too dense); use "
                "wire_format=auto or off")

    def mk(r, shuffle, wire_loader, shard=False):
        if len(r) == 0:
            return None
        sel = rows[list(r)]
        if shard and process_shard is not None:
            rank, world = process_shard
            sel = sel[:len(sel) // world * world][rank::world]
            if len(sel) == 0:
                return None
        frames = NuscenesFrames(sel, cfg,
                                wire_plan=plan if wire_loader else None)
        return BatchLoader(frames, batch_size, shuffle=shuffle,
                           num_workers=cfg.num_workers,
                           prefetch=cfg.prefetch)

    return {"train": mk(tr, True, wire, shard=True),
            "val": mk(va, False, wire_eval),
            "test": mk(te, False, wire_eval)}
