"""Carry JAX/Flax parameters across to the port, and load reference
checkpoints.

The port's native checkpoint is the reference ``state_dict``. Parameters
trained by the JAX package come across through :func:`state_dict_from_flax`,
the package's own copy of ``_flax_path_to_torch_key`` and
``_tensor_to_torch`` (``camradepth_tpu/interop/torch_convert.py:145-194``)
with the tree walked by hand, so that JAX is not needed:

  flax (JAX package)                   torch (reference / port)
  ------------------------------------ ----------------------------------
  dest_encoder/block2_3/attn/q         dest_encoder.block2.3.attn.q
  Conv kernel [kh,kw,I,O]              weight [O,I,kh,kw] (also depthwise)
  Dense kernel [I,O]                   conv1d 1x1 weight [O,I,1]
  GroupNorm scale/bias                 weight/bias
  */conv + */norm in a ConvLayer       *.model.0 / *.model.1
  depth_upsample_3/conv_0/conv         depth_upsample.3.conv_0.model.0
    (a ``tpu_decoder`` TPUDecoder stage: no reference counterpart; the
    port's own layout, models/camradepth.py)
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

_SEG_HEADS = (
    "seg_conv_stage_4",
    "seg_conv_final",
    "unsup_stage_4",
    "unsup_final",
)


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[List[str], object]]:
    for key in sorted(tree):
        value = tree[key]
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield list(path), value


def state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax parameter tree (nested mappings of arrays) -> reference-format
    ``state_dict`` of numpy arrays, which ``create_model`` loads."""
    return {
        _flax_path_to_torch_key(keys): _tensor_to_torch(np.asarray(v), keys)
        for keys, v in _leaves(params)
    }


def _tensor_to_torch(v: np.ndarray, keys) -> np.ndarray:
    if keys[-1] != "kernel":
        return v
    if v.ndim == 4:
        return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW (incl depthwise)
    if v.ndim == 2:
        # token-space Dense layers came from conv1d 1x1 [O,I,1]
        return v.T[:, :, None]
    return v


def _flax_path_to_torch_key(keys) -> str:
    keys = list(keys)
    leaf = keys.pop()
    # ConvLayer context: path ends (..., <convlayer>, 'conv'|'norm') where
    # <convlayer> is from_encoder_*, layers_* or a TPUDecoder's conv_*.
    # Bare seg heads end (<seg_head>, 'conv').
    parts = []
    for idx, k in enumerate(keys):
        m = re.fullmatch(r"block(\d)_(\d+)", k)
        if m:
            parts += [f"block{m.group(1)}", m.group(2)]
            continue
        m = re.fullmatch(r"(depth_upsample|seg_upsample)_(\d+)", k)
        if m:
            parts += [m.group(1), m.group(2)]
            continue
        m = re.fullmatch(r"layers_(\d+)", k)
        if m:
            parts += ["layers", m.group(1)]
            continue
        if k == "dwconv":
            parts += ["dwconv", "dwconv"]
            continue
        prev = keys[idx - 1] if idx else ""
        in_convlayer = bool(
            re.fullmatch(r"layers_\d+", prev)
            or re.fullmatch(r"from_encoder_\d", prev)
            or re.fullmatch(r"conv_\d+", prev)
        )
        if k == "conv" and prev in _SEG_HEADS:
            continue  # bare Conv2d: drop the wrapper level
        if k == "conv" and in_convlayer:
            parts.append("model.0")
            continue
        if k == "norm" and in_convlayer:
            parts.append("model.1")
            continue
        parts.append(k)
    leaf_name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return ".".join(parts + [leaf_name])


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` and return its state_dict with the
    ``module.`` (DataParallel) prefix stripped (runner.py:124-132 load
    path). Loaded with ``weights_only=True``: tensors and plain containers
    only, no arbitrary unpickling."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return {k.removeprefix("module."): v for k, v in sd.items()}
