"""One rank of tests/test_torch_search.py's gloo group (CPU, fp32), forked
by tests/torch_ranks.py:

    python tests/torch_ranks.py tests._torch_search_child 2 <port>
        <cli_port> <split.npy> <out_dir>

The rank joins a process group of ``world`` ranks and runs, on the toy
depth model (:class:`ToyDepth`, the torch twin of the JAX tests' two-conv
model) with the same initial weights on every rank:

  1. ``vmapped_trials`` of 4 trials for one step, with the trial axis
     sharded over the ranks and in one process (every rank alone);
  2. ``vmapped_halving`` 4 -> 2 trials (both rungs sharded: the survivors
     move between ranks) and 4 -> 1 (the last rung replicated on every
     rank), sharded and in one process;
  3. then, in a new group, ``cli.main(["search", "--vmap-trials",
     "--data-parallel", world, ...])`` for one step at tiny widths,
     recording the results that rank 0 printed.

Writes ``rank<rank>.json`` into ``out_dir``. The test module imports the
toy model and data from here, so this module changes nothing at import
(no vmapped search builds a metric writer: TensorBoard stays importable
for the tests that share the test module's process).
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from camradepth_tpu_torch import cli
from camradepth_tpu_torch.config import tiny_test_config
from camradepth_tpu_torch.parallel import multihost
from camradepth_tpu_torch.train import search

SPACES = {"learning_rate": ([1e-4, 1e-2], "log"),
          "weight_decay": ([1e-6, 1e-3], "log")}
# the widths of the ranks' cli search
TINY = ["model.img_size=32,64", "model.dims=16,32,32,64",
        "model.ff_expansion=2,2,2,2", "model.depths=1,1,1,1",
        "model.mid_channels=32", "data.image_dimension=32,64",
        "data.num_workers=1"]
CLI_ARGS = ["search", "--vmap-trials", "--num-trials", "4",
            "--trial-steps", "1", "--train-val-split", "4,2",
            "--batch-size", "2", "--desired-batch-size", "4",
            "--compute-dtype", "float32", "--device", "cpu"]


class ToyDepth(nn.Module):
    """The torch twin of ``tests/test_search_profiling.py``'s two-conv toy
    model: a 3x3 conv to 8 channels, tanh GELU, a 1x1 conv to 4, sigmoid,
    the channel mean; NHWC in, the ``multitask_loss`` prediction dict
    out."""

    def __init__(self):
        super().__init__()
        self.feat = nn.Conv2d(7, 8, 3, padding=1)
        self.head = nn.Conv2d(8, 4, 1)

    def forward(self, x):
        h = F.gelu(self.feat(x.permute(0, 3, 1, 2)), approximate="tanh")
        d = torch.sigmoid(self.head(h)).mean(1, keepdim=True)
        d = d.permute(0, 2, 3, 1)
        return {"depth": {"final_depth": d,
                          "intermediate_depths": (None, None, d[:, ::4, ::4],
                                                  d[:, ::2, ::2])},
                "seg": {"final_seg": None, "intermediate_seg": None,
                        "unsup_map": None}}

    def load_flax(self, params) -> "ToyDepth":
        """Take the JAX toy's parameters (HWIO kernels)."""
        sd = {}
        for name in ("feat", "head"):
            sd[f"{name}.weight"] = torch.from_numpy(np.asarray(
                params[name]["kernel"]).transpose(3, 2, 0, 1).copy())
            sd[f"{name}.bias"] = torch.from_numpy(np.asarray(
                params[name]["bias"]).copy())
        self.load_state_dict(sd)
        return self


def toy_batches(seed: int, n: int = 2, accum: int = 2, bs: int = 2,
                hw=(32, 64)):
    """``n`` optimizer-step stacks [accum, bs, H, W, ...] of the JAX
    tests' kind (sparse-ish positive GT)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    return [{"features": rng.standard_normal(
                (accum, bs, h, w, 7)).astype(np.float32),
             "gt_depth": (np.abs(rng.standard_normal((accum, bs, h, w)))
                          * 0.1).astype(np.float32)}
            for _ in range(n)]


def toy_model(seed: int = 0) -> ToyDepth:
    torch.manual_seed(seed)
    return ToyDepth()


def _losses(results):
    return [[r["overrides"]["learning_rate"], r["val_loss"],
             r.get("rung", 0), r["steps"]] for r in results]


def main(rank, world, argv):
    torch.set_num_threads(1)
    port, cli_port = int(argv[0]), int(argv[1])
    split, out_dir = argv[2], Path(argv[3])
    cfg = tiny_test_config()
    batches = toy_batches(9)
    out = {}
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    runs = {
        "trials": lambda shard: search.vmapped_trials(
            cfg, SPACES, num_trials=4, num_steps=1, seed=3,
            batches=batches, shard_trials=shard, model=toy_model(),
            device="cpu"),
        "halving_sharded": lambda shard: search.vmapped_halving(
            cfg, SPACES, num_trials=4, min_steps=1, max_steps=2, eta=2,
            seed=6, batches=batches, shard_trials=shard, model=toy_model(),
            device="cpu"),
        "halving_replicated": lambda shard: search.vmapped_halving(
            cfg, SPACES, num_trials=4, min_steps=1, max_steps=4, eta=4,
            seed=6, batches=batches, shard_trials=shard, model=toy_model(),
            device="cpu"),
    }
    for name, run in runs.items():
        out[name] = {"sharded": _losses(run(True)[2]),
                     "single": _losses(run(False)[2])}
    multihost.shutdown()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli_rc"] = cli.main(CLI_ARGS + [
            "--coordinator", f"127.0.0.1:{cli_port}", "--num-processes",
            str(world), "--process-id", str(rank), "--data-parallel",
            str(world), "--split", split] + [
                a for s in TINY for a in ("--set", s)])
    out["cli_out"] = buf.getvalue()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    print(f"[{rank}] DONE", flush=True)
