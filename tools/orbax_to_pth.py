#!/usr/bin/env python3
"""A JAX run's Orbax checkpoint as a ``.pth`` the PyTorch port loads, for
every model variant, the ``tpu_decoder`` one included.

    python tools/orbax_to_pth.py --checkpoint RUN_DIR|CKPT_DIR --out W.pth \\
        [--preset base] [--tpu-decoder] [--set model.FIELD=VALUE ...]

The JAX package's ``cli export --format pth`` writes the reference layout,
which the ``tpu_decoder`` variant does not have, so it refuses that
variant. This script imports both packages and edits neither: it restores
the checkpoint with ``camradepth_tpu.utils.checkpoint.restore_checkpoint``
(a run directory gives its best checkpoint, else its newest), holds its
parameters to the tree of the config's JAX model (every leaf there, with
its shape), maps them with the port's
``interop/flax_convert.state_dict_from_flax`` and holds the result to the
port's model of the same config (every key, with its shape). It writes
``{"state_dict": ...}`` in the port's layout: ``cli test``, ``cli serve``,
``cli export`` and ``load_engine`` take it with the same ``--preset`` and
``--tpu-decoder``. Exits 2, writing nothing, when the checkpoint does not
fit the config.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def model_configs(preset: str, tpu_decoder: bool,
                  overrides: Sequence[str] = ()):
    """(the JAX package's, the port's) experiment config of one model."""
    import dataclasses

    from camradepth_tpu import config as jax_config
    from camradepth_tpu_torch import config as port_config

    out = []
    for mod in (jax_config, port_config):
        cfg = mod.preset(preset)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, tpu_decoder=tpu_decoder))
        out.append(mod.apply_overrides(cfg, list(overrides)))
    return tuple(out)


def checkpoint_path(path: str) -> Path:
    """``path``, or for a run directory its best checkpoint (else its
    newest), as the JAX CLI picks one."""
    from camradepth_tpu.utils import checkpoint as ck

    p = Path(path)
    if p.is_dir() and not p.name.startswith(("ckpt_epoch_",
                                             "ckpt_preempt_epoch_")):
        best = ck.best_checkpoint(p) or ck.latest_checkpoint(p)
        if best is None:
            raise ValueError(f"{path} holds no ckpt_epoch_* / "
                             "ckpt_preempt_epoch_* checkpoints")
        return best
    return p


def _leaves(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def convert(jax_cfg, port_cfg, checkpoint: str) -> Dict[str, np.ndarray]:
    """The port's state_dict of the checkpoint's parameters; raises
    ValueError where the checkpoint does not fit the config."""
    import jax
    import jax.numpy as jnp

    from camradepth_tpu.models.camradepth import CamRaDepth
    from camradepth_tpu.utils import checkpoint as ck
    from camradepth_tpu_torch.interop.flax_convert import state_dict_from_flax

    state = ck.restore_checkpoint(checkpoint_path(checkpoint), None)
    saved = (state["params"] if isinstance(state, dict) and "params" in state
             else state[0] if isinstance(state, (list, tuple)) else state)
    model = CamRaDepth(jax_cfg.model)
    h, w = jax_cfg.model.img_size
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, h, w, jax_cfg.model.input_channels)),
        deterministic=True)["params"], jax.random.PRNGKey(0))
    have = {path: np.asarray(v) for path, v in _leaves(saved)}
    want = dict(_leaves(shapes))
    bad = [("/".join(p), "missing" if p not in have else
            f"shape {have[p].shape} vs {tuple(s.shape)}")
           for p, s in want.items()
           if p not in have or have[p].shape != tuple(s.shape)]
    if bad:
        raise ValueError(
            f"{checkpoint} does not fit the '{jax_cfg.name}' config"
            f"{' + tpu_decoder' if jax_cfg.model.tpu_decoder else ''}: "
            f"{len(bad)} of {len(want)} parameters, e.g. {bad[0][0]} "
            f"({bad[0][1]}); pass the run's --preset, --tpu-decoder and "
            "--set flags")
    params = {}
    for path in want:
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(have[path], dtype=np.float32)
    sd = state_dict_from_flax(params)
    import torch

    from camradepth_tpu_torch.models.camradepth import CamRaDepth as Port

    with torch.device("meta"):
        own = Port(port_cfg.model).state_dict()
    wrong = sorted(set(own) ^ set(sd)) + [
        k for k in own if k in sd and tuple(sd[k].shape) != tuple(
            own[k].shape)]
    if wrong:
        raise ValueError(f"the mapped parameters miss the port's model: "
                         f"{len(wrong)} keys, e.g. {wrong[0]}")
    return sd


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True,
                   help="a JAX run directory or one of its ckpt_* dirs")
    p.add_argument("--out", required=True, help="the .pth to write")
    p.add_argument("--preset", default="base")
    p.add_argument("--tpu-decoder", action="store_true")
    p.add_argument("--set", action="append", dest="set_overrides",
                   default=[], metavar="SECTION.FIELD=VALUE")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    try:
        jax_cfg, port_cfg = model_configs(args.preset, args.tpu_decoder,
                                          args.set_overrides)
        sd = convert(jax_cfg, port_cfg, args.checkpoint)
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, args.out)
    print(f"wrote {len(sd)} tensors to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
