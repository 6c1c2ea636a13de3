"""External-network adapters of the offline prep's flow and seg stages.

Counterpart of ``camradepth_tpu/dataprep/adapters.py``. The reference
computes optical flow with a RAFT checkpoint (scripts/cal_flow.py:18-21,
26-93) and vehicle masks with a detectron2 Panoptic-DeepLab model remapped
through mseg (scripts/semantic_seg.py:89-171). The prep keeps those stages
pluggable (``dataprep/stages.py``): any callable with the right contract
slots in. This module builds such callables:

- :func:`raft_estimator` and :func:`panoptic_estimator`: an official
  ``.pth`` (raft-things/raft-kitti; panoptic_deeplab_R101_os32_cityscapes)
  in this package's own RAFT-large (``models/raft.py``) and
  Panoptic-DeepLab (``models/panoptic_deeplab.py``). The kind names that
  select them, ``jax-raft`` and ``jax-panoptic``, are the JAX package's,
  so that its command lines run unchanged; here they name these PyTorch
  models.
- :func:`raft_flow_from_torchscript`: ``estimator(im1, im2) -> [H,W,2]``
  with RAFT's conventions: RGB 0..255 float input, replicate-padding to a
  multiple of 8 (cal_flow.py uses RAFT's InputPadder), the output cropped
  back. Takes modules that return a flow tensor, a (low, up) pair, or a
  list of iterates.
- :func:`seg_classmap_from_torchscript`: ``estimator(im) -> [H,W]`` int64
  class ids, the argmax over the module's [1,C,H,W] logits.

Each runs on ``device`` (default ``"cuda"``, which raises without a card)
and returns numpy arrays, as the stages expect.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable, Union

import numpy as np
import torch

from camradepth_tpu_torch import resolve_device


def _pad_to_multiple(t, mult: int):
    """Replicate-pad an [N,C,H,W] tensor so H and W divide ``mult``
    (RAFT's InputPadder semantics, mode='replicate', pad at bottom and
    right like its 'kitti' mode)."""
    h, w = t.shape[-2:]
    ph = (mult - h % mult) % mult
    pw = (mult - w % mult) % mult
    if ph or pw:
        t = torch.nn.functional.pad(t, (0, pw, 0, ph), mode="replicate")
    return t, (h, w)


def _first_flow_like(out):
    """The final [1,2,H',W'] flow tensor of the module's return value (a
    tensor, a (low, up) tuple, or a list of iterates)."""
    if isinstance(out, (list, tuple)):
        out = out[-1]
    if not torch.is_tensor(out):
        raise TypeError(f"flow module returned {type(out)!r}")
    if out.ndim != 4 or out.shape[1] != 2:
        raise ValueError(
            f"expected [N,2,H,W] flow, got {tuple(out.shape)}"
        )
    return out


def _image_tensor(im: np.ndarray, dev) -> torch.Tensor:
    """[H,W,3] uint8 -> [1,3,H,W] float32 on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(im)).permute(
        2, 0, 1).float()[None].to(dev)


def raft_flow_from_torchscript(
    path: Union[str, Path],
    device="cuda",
    iters: int = 20,
) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Load a TorchScript RAFT export and wrap it in the pipeline's
    ``flow_estimator(im1, im2) -> [H,W,2] float32`` contract.

    ``im1``/``im2`` are [H,W,3] RGB uint8 frames. The module is called
    as ``module(image1, image2)`` with 0..255 float tensors (RAFT's
    own convention, cal_flow.py:62-66); modules whose forward takes an
    ``iters`` argument are called with it first.
    """
    dev = resolve_device(device)
    module = torch.jit.load(str(path), map_location=dev)
    module.eval()

    def estimator(im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        t1, (h, w) = _pad_to_multiple(_image_tensor(im1, dev), 8)
        t2, _ = _pad_to_multiple(_image_tensor(im2, dev), 8)
        with torch.no_grad():
            try:
                out = module(t1, t2, iters)
            except (RuntimeError, TypeError):
                out = module(t1, t2)
        flow = _first_flow_like(out)
        flow = flow[0, :, :h, :w].permute(1, 2, 0)
        return flow.cpu().numpy().astype(np.float32)

    return estimator


def seg_classmap_from_torchscript(
    path: Union[str, Path],
    device="cuda",
) -> Callable[[np.ndarray], np.ndarray]:
    """Load a TorchScript segmentation export (e.g. a Panoptic-DeepLab
    semantic head, semantic_seg.py:89-171) and wrap it in the
    pipeline's ``seg_estimator(im) -> [H,W] int64`` class-map contract.

    ``im`` is an [H,W,3] RGB uint8 frame; the module receives a
    0..1-normalized [1,3,H,W] float tensor and must return [1,C,H,W]
    logits (or a dict with a ``sem_seg``/``out``/``logits`` entry). Class
    ids come from the channel argmax; the mseg universal->mseg-194 remap
    happens downstream in stages.semantic_seg_artifact.
    """
    dev = resolve_device(device)
    module = torch.jit.load(str(path), map_location=dev)
    module.eval()

    def estimator(im: np.ndarray) -> np.ndarray:
        t, (h, w) = _pad_to_multiple(_image_tensor(im, dev) / 255.0, 32)
        with torch.no_grad():
            out = module(t)
        if isinstance(out, dict):
            for k in ("sem_seg", "out", "logits"):
                if k in out:
                    out = out[k]
                    break
        if not torch.is_tensor(out) or out.ndim != 4:
            raise TypeError(
                "seg module must return [1,C,H,W] logits, got "
                f"{type(out)!r}"
            )
        cls = out[0, :, :h, :w].argmax(dim=0)
        return cls.cpu().numpy().astype(np.int64)

    return estimator


def _official_state(ckpt: Union[str, Path]):
    state = torch.load(str(ckpt), map_location="cpu")
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


def raft_estimator(
    ckpt: Union[str, Path],
    iters: int = 20,
    device="cuda",
) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """RAFT-large flow (``--flow jax-raft``): an official RAFT .pth
    state_dict (raft-things/raft-kitti, the checkpoints scripts/cal_flow.py
    uses) in ``models/raft.py``, wrapped in the pipeline's
    ``flow_estimator(im1, im2) -> [H,W,2]`` contract. The frames are
    edge-padded to a multiple of 8 and the flow cropped back, as the JAX
    package's ``jax_raft_estimator`` does."""
    from camradepth_tpu_torch.models.raft import raft_flow_fn

    run = raft_flow_fn(_official_state(ckpt), iters=iters, device=device)

    def estimator(im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        h, w = im1.shape[:2]
        ph = (8 - h % 8) % 8
        pw = (8 - w % 8) % 8
        a = np.pad(im1, ((0, ph), (0, pw), (0, 0)), mode="edge")
        b = np.pad(im2, ((0, ph), (0, pw), (0, 0)), mode="edge")
        flow = run(a[None], b[None])
        return flow[0, :h, :w].cpu().numpy().astype(np.float32)

    return estimator


def make_flow_estimator(kind: str, ckpt: str = "", device="cuda", **kw):
    """Factory used by the CLI: 'lk' (built-in pyramidal Lucas-Kanade),
    'jax-raft' (an official .pth in this package's RAFT-large),
    'torchscript'/'raft' (TorchScript export), or 'none'."""
    if kind in ("none", ""):
        return None
    if kind == "lk":
        from camradepth_tpu_torch.ops.optical_flow import lk_flow

        return functools.partial(lk_flow, device=device)
    if kind == "jax-raft":
        if not ckpt:
            raise ValueError(
                f"--flow {kind} requires --flow-ckpt <official RAFT .pth>"
            )
        return raft_estimator(ckpt, device=device, **kw)
    if kind in ("torchscript", "raft"):
        if not ckpt:
            raise ValueError(
                f"--flow {kind} requires --flow-ckpt <torchscript file>"
            )
        return raft_flow_from_torchscript(ckpt, device=device, **kw)
    raise ValueError(f"unknown flow estimator {kind!r}")


def panoptic_estimator(
    ckpt: Union[str, Path],
    device="cuda",
) -> Callable[[np.ndarray], np.ndarray]:
    """Panoptic-DeepLab R101-os32 (``--seg jax-panoptic``): the official
    panoptic_deeplab_R101_os32_cityscapes.pth in
    ``models/panoptic_deeplab.py`` (loaded by registration order and
    shape, as the JAX loader does), wrapped in the pipeline's
    ``seg_estimator(im) -> [H,W] int64`` contract. Returns cityscapes
    trainIds: pair it with remap='cityscapes' (21-class training labels)
    or 'vehicle_cityscapes' (the reference's semantic_seg.py vehicle
    mask)."""
    from camradepth_tpu_torch.models.panoptic_deeplab import (
        PanopticDeepLab,
        classmap_fn,
        load_state_dict_by_order,
    )

    model = load_state_dict_by_order(PanopticDeepLab(), _official_state(ckpt))
    return classmap_fn(model, device=device)


def make_seg_estimator(kind: str, ckpt: str = "", device="cuda", **kw):
    """Factory used by the CLI: 'jax-panoptic' (the official .pth in this
    package's Panoptic-DeepLab), 'torchscript' (Panoptic-DeepLab-style
    export) or 'none'."""
    if kind in ("none", ""):
        return None
    if kind == "jax-panoptic":
        if not ckpt:
            raise ValueError(
                f"--seg {kind} requires --seg-ckpt <official "
                "panoptic_deeplab_R101_os32_cityscapes.pth>"
            )
        return panoptic_estimator(ckpt, device=device, **kw)
    if kind in ("torchscript", "panoptic-deeplab"):
        if not ckpt:
            raise ValueError(
                f"--seg {kind} requires --seg-ckpt <torchscript file>"
            )
        return seg_classmap_from_torchscript(ckpt, device=device, **kw)
    raise ValueError(f"unknown seg estimator {kind!r}")
