"""One rank of tests/test_torch_parallel.py's gloo group (CPU, fp32),
forked by tests/torch_ranks.py:

    python tests/torch_ranks.py tests._torch_parallel_child 2 <port>
        <cli_port> <split.npy> <out_dir>

The rank joins a process group of ``world`` ranks and runs, against the
port's single-process step over the joined microbatches (computed once,
shared by the layouts), at tiny widths with both focal CE terms on
(supervised_seg, seg_inter_loss) and dropout at the ModelConfig rates, on
microbatches where the last rank's rows hold at most 10 % valid GT and
95 % ignored labels:

  1. two optimizer steps of DDP and of FSDP2;
  2. ``grad_parity`` on both layouts;
  3. the per-rank-normalizer step (each rank's masked means over its own
     rows, averaged by DDP), which must miss the gradient limit;
  4. then, in a new group, ``cli.main(["train", "--coordinator", ...])``
     under FSDP2 for one step, recording the parameters the step produced
     (gathered on rank 0) and which writer each rank had.

Writes ``rank<rank>.json`` (and on rank 0 ``step_params.pt``) into
``out_dir``.
"""

import sys
from pathlib import Path

# the metric writer would import TensorBoard, which pulls in TensorFlow
# here (~17 s); it then writes its JSONL alone
sys.modules["tensorboard"] = None

import dataclasses  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from camradepth_tpu_torch import cli  # noqa: E402
from camradepth_tpu_torch.parallel import gradcheck as gc  # noqa: E402
from camradepth_tpu_torch.parallel import multihost  # noqa: E402
from camradepth_tpu_torch.parallel.mesh import Layout  # noqa: E402
from camradepth_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from camradepth_tpu_torch.train.losses import multitask_loss  # noqa: E402
from camradepth_tpu_torch.train.step import (  # noqa: E402
    build_gt,
    prepare_microbatch,
)


def per_rank_loss(cfg, model, micro, generator):
    """The naive port: each rank's masked means over its own rows, the
    gradient then averaged over the ranks (hence / count)."""
    from camradepth_tpu_torch.parallel.mesh import batch_shard, unwrap

    micro = prepare_microbatch(cfg, micro)
    unwrap(model).set_generator(generator)
    loss, metrics = multitask_loss(model(micro["features"]),
                                   build_gt(micro), cfg)
    return loss / batch_shard(model).count, metrics


def summary(r):
    return {k: r[k] for k in ("loss_rel", "grad_norm_rel", "grad_rel",
                              "grad_worst", "params_rel", "param_rel",
                              "param_worst", "param_max_change_lr",
                              "metrics")}


def main(rank, world, argv):
    torch.set_num_threads(1)
    port, cli_port = int(argv[0]), int(argv[1])
    split, out_dir = argv[2], Path(argv[3])
    layouts = {"ddp": Layout(world, 1), "fsdp": Layout(1, world)}
    out = {}
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    cfg = gc.check_config(dropout=True, supervised_seg=True)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                seg_inter_loss=True))
    mbs = gc.parity_microbatches(cfg, 2, 2 * world, seed=7, ranks=world)
    ref = gc.reference_steps(cfg, mbs)
    out["reference"] = ref[1]
    for kind, layout in layouts.items():
        out[kind] = summary(gc.step_parity(layout, cfg, mbs, reference=ref))
    out["per_rank"] = summary(gc.step_parity(
        layouts["ddp"], cfg, mbs, reference=ref, loss_fn=per_rank_loss))
    for kind, layout in layouts.items():
        out[f"grad_parity_{kind}"] = gc.grad_parity(layout)
    multihost.shutdown()

    class Recording(trainer_mod.Trainer):
        def train(self):
            best = super().train()
            state = multihost.full_state(self.model, None)["state_dict"]
            if multihost.is_primary():
                torch.save(state, out_dir / "step_params.pt")
            out["cli_writer"] = type(self.writer).__name__
            out["cli_steps"] = self.training_steps
            return best

    trainer_mod.Trainer = Recording
    out["cli_rc"] = cli.main([
        "train", "--coordinator", f"127.0.0.1:{cli_port}",
        "--num-processes", str(world), "--process-id", str(rank), "--fsdp",
        str(world), "--split", split, "--train-val-split", "2,2",
        "--batch-size", str(world), "--num-epochs", "1", "--run-dir",
        str(out_dir / "run"), "--save-model", "--device", "cpu",
        "--compute-dtype", "float32", "--set", "data.num_workers=1",
        "--set", "train.log_every=1", "--set", "model.img_size=32,64",
        "--set", "model.dims=16,32,32,64", "--set",
        "model.ff_expansion=2,2,2,2", "--set", "model.depths=1,1,1,1",
        "--set", "model.mid_channels=32", "--set",
        "data.image_dimension=32,64"])
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    print(f"[{rank}] DONE", flush=True)
