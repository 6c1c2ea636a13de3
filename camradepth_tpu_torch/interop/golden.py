"""Deterministic weights and inputs of the committed goldens.

The package's own copy of ``camradepth_tpu/interop/golden.py:38-111``.
``tests/goldens/flagship_*.npz`` hold the reference model's outputs for
weights that :func:`synth_state_values` makes from the committed key ->
shape table and for the input of :func:`golden_input`;
``tests/goldens/tpu_decoder_128x256.npz`` holds the JAX package's outputs
of the ``tpu_decoder`` variant for flax parameters that
:func:`synth_flax_params` makes from its committed ``a/b/c`` -> shape
table (plain nested dicts here: no flax). The synthesis rule is part of
that contract: one ``np.random.default_rng(seed)`` stream over the keys in
sorted order, norm scales near 1, everything else small-amplitude normal.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Tuple

import numpy as np

GOLDEN_SEED = 42
INPUT_SEED = 7


def synth_state_values(
    shapes: Dict[str, Tuple[int, ...]], seed: int = GOLDEN_SEED
) -> Dict[str, np.ndarray]:
    """Deterministic state_dict values from a key -> shape table."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        shape = tuple(shapes[key])
        g = rng.standard_normal(shape).astype(np.float32)
        if key.endswith(".weight") and len(shape) == 1:
            out[key] = (1.0 + 0.02 * g).astype(np.float32)  # norm scale
        elif key.endswith(".bias"):
            out[key] = (0.02 * g).astype(np.float32)
        else:
            out[key] = (0.05 * g).astype(np.float32)
    return out


def golden_input(
    hw: Tuple[int, int], channels: int = 7, seed: int = INPUT_SEED
) -> np.ndarray:
    """[1, H, W, C] float32 NHWC input (normalized-image scale)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, hw[0], hw[1], channels)).astype(
        np.float32
    )


def flax_param_shapes(params: Mapping, prefix: str = ""
                      ) -> Dict[str, Tuple[int, ...]]:
    """Flatten a nested parameter tree (mappings of arrays) to an
    ``a/b/c`` -> shape table."""
    out = {}
    for key, value in params.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flax_param_shapes(value, path + "/"))
        else:
            out[path] = tuple(value.shape)
    return out


def synth_flax_params(
    shapes: Dict[str, Tuple[int, ...]], seed: int = GOLDEN_SEED
) -> Dict[str, object]:
    """Deterministic flax parameter values from an ``a/b/c`` -> shape
    table, as nested dicts: the one-stream, sorted-keys rule of
    :func:`synth_state_values` with flax leaf names (``scale`` near 1,
    ``bias`` small, kernels small-amplitude normal)."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, object] = {}
    for key in sorted(shapes):
        g = rng.standard_normal(tuple(shapes[key])).astype(np.float32)
        if key.endswith("/scale"):
            value = (1.0 + 0.02 * g).astype(np.float32)
        elif key.endswith("/bias"):
            value = (0.02 * g).astype(np.float32)
        else:
            value = (0.05 * g).astype(np.float32)
        *parents, leaf = key.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def shapes_from_json(s: str) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v) for k, v in json.loads(s).items()}
