"""Command-line interface of the PyTorch/CUDA port: ``prep``, ``train``,
``distill``, ``search``, ``test``, ``serve``, ``export``,
``validate-data``, ``viz``, ``summary``, ``inspect``, ``doctor`` and
``bench``.

  python -m camradepth_tpu_torch.cli prep --data-root NUSC --out D \\
      [--mini] [--stages split,images,...] [--flow lk|jax-raft|raft|none \\
      --flow-ckpt F] [--seg jax-panoptic|torchscript|none --seg-ckpt S \\
      --seg-remap cityscapes|...] [--device cuda|cpu]
  python -m camradepth_tpu_torch.cli train --preset base --split S.npy \\
      [--run-dir R] [--save-model] [--set train.num_epochs=1] [--device ..]
  torchrun --nproc-per-node N -m camradepth_tpu_torch.cli train \\
      --multihost --data-parallel N|--fsdp N --run-dir R ...
  python -m camradepth_tpu_torch.cli train --coordinator HOST:PORT \\
      --num-processes N --process-id I --data-parallel N --run-dir R ...
  torchrun --nproc-per-node 2 -m camradepth_tpu_torch.cli train \\
      --multihost --spatial-parallel 2 --run-dir R ...
  python -m camradepth_tpu_torch.cli distill --tpu-decoder --split S.npy \\
      --teacher-checkpoint T.pth [--alpha 0.7] [--run-dir R] [--save-model]
  python -m camradepth_tpu_torch.cli search --split S.npy --vmap-trials \\
      [--halving --min-steps 1] [--num-trials 8] [--trial-steps 50] \\
      [--data-parallel N --coordinator HOST:PORT ...]
  python -m camradepth_tpu_torch.cli test  --preset base --split S.npy \\
      --checkpoint W.pth|A.pt2 [--report-json R.json] [--device cuda|cpu]
  python -m camradepth_tpu_torch.cli serve --preset base --split S.npy \\
      --checkpoint W.pth|A.pt2 --out served/ [--limit N] [--device cuda|cpu]
  python -m camradepth_tpu_torch.cli serve --preset base \\
      --checkpoint W.pth|A.pt2 --http-port 8080 [--http-host H]
  torchrun --nproc-per-node N -m camradepth_tpu_torch.cli serve \\
      --multihost --data-parallel D --spatial-parallel S --checkpoint W.pth \\
      --split S.npy|--http-port 8080 ...
  python -m camradepth_tpu_torch.cli export --preset base --checkpoint W.pth \\
      --out A.pt2 --format artifact [--serve-batch 8] [--dynamic-batch] \\
      [--artifact-dtype float32|bfloat16] [--device cuda|cpu]
  python -m camradepth_tpu_torch.cli validate-data --split S.npy | \
      --data-dir D [--image-dimension 416,800] [--limit N] [--no-decode]
  python -m camradepth_tpu_torch.cli viz --split S.npy \
      --checkpoint W.pth|A.pt2 [--out viz_out] [--num-vis 25] [--device ..]
  python -m camradepth_tpu_torch.cli summary --preset base \
      [--summary-batch 8] [--project-scaling weak|strong]
  python -m camradepth_tpu_torch.cli inspect PATH
  python -m camradepth_tpu_torch.cli doctor [--timeout 60]
  python -m camradepth_tpu_torch.cli bench [--train]

The counterparts of ``camradepth_tpu.cli``'s ``cmd_prep``
(``camradepth_tpu/cli.py:258-310``), ``cmd_train``
(``camradepth_tpu/cli.py:314-349``), ``cmd_distill`` (``:353-397``),
``cmd_search`` (``:568-652``), ``cmd_test`` (``:402-462``), ``cmd_serve`` (``:655-852``), ``cmd_export``
(``:514-565``), ``cmd_validate_data`` (``:930-958``), ``cmd_viz``
(``:465-512``), ``cmd_summary`` (``:856-928``), ``cmd_inspect``
(``:961-1052``), ``cmd_doctor`` (``:1055-1123``) and ``cmd_bench``
(``:1126-1134``), with the same flags where they apply. ``prep`` runs the
offline data prep (``dataprep/``) over a nuScenes world, which needs the
nuscenes-devkit (without it: exit code 2); ``--flow jax-raft`` and
``--seg jax-panoptic`` keep the JAX package's names for this package's
RAFT-large and Panoptic-DeepLab. ``train`` runs
:class:`train.trainer.Trainer` and prints the best validation loss; its
checkpoints are ``.pth`` files that ``test``, ``serve`` and ``export``
load. Both train on one device, or on several processes, one device
each: ``--multihost`` (under ``torchrun``) or ``--coordinator`` with
``--num-processes`` and ``--process-id`` start the process group (NCCL on
the card, gloo on the CPU, and gloo for ranks that outnumber the host's
cards) before anything touches the device, and ``--data-parallel`` /
``--fsdp`` / ``--spatial-parallel`` size the layout (``parallel/mesh.py``:
DDP, FSDP2, both as HSDP, or sp = 2 alone, each rank running its rows of
every image), as the JAX flags do, with the JAX package's refusals
(``_auto_mesh``). ``distill`` trains a
student (usually
``--tpu-decoder``) against a frozen parity teacher
(:class:`train.distill.DistillTrainer`) from a reference ``.pth``, a port
trainer checkpoint or a run directory (its best checkpoint). ``test``
prints the reference metric report and writes the same report JSON keys
as ``camradepth_tpu.cli test --report-json`` (with ``iou`` for a
supervised seg preset); ``serve`` streams the split through
:class:`serving.DepthEngine`, writes ``NNNNN_depth.npy`` per frame (and
``NNNNN_seg.npy``, uint8 labels, for a supervised seg preset) and prints
the same stats line, or with ``--http-port`` serves the engine over HTTP
(``serving_http.py``). ``export --format artifact`` writes a serving
artifact (``interop/export.py``: ``torch.export`` with the weights
inside, the kernels as operators) that ``test`` and ``serve`` take in
place of a checkpoint; ``--format pth`` writes the reference layout.
``serve`` also runs on a mesh of processes, one device each:
``--data-parallel`` shards each batch's frames, ``--spatial-parallel``
each frame's rows (``parallel/spatial.py``), started as ``train`` starts
its processes (ranks that outnumber the host's cards share them over
gloo, as NCCL refuses two ranks on one card); rank 0 alone writes the
maps or runs the HTTP front end.
``validate-data`` checks a prepared dataset's artifacts against the
loader's frame contract (``data/split.validate_split``) and touches no
device. ``viz`` writes prediction collages (``viz.py``) from a ``.pth``
or an artifact. ``summary`` prints the parameter table and the
analytic FLOPs and floor on the H100 (``utils/roofline.py``; with
``--project-scaling``, ``utils/scaling.py``) from a model on the ``meta``
device, and ``inspect`` identifies an artifact, ``.pth``, run directory
or split as one JSON object: neither touches a card. ``doctor`` reports
the card, nvcc, the kernel build and the host library, and exits 1 when
no card answers. ``bench`` (``bench.py``) prints one JSON line of
frames/s on the card with its roofline share.
``--tpu-decoder`` selects the ``tpu_decoder`` variant; its checkpoints
are the port's own layout, so a reference-format ``.pth`` is refused for
it, and its deployment format is the artifact. ``--wire auto|on`` (or
``--set data.wire_format=...``) ships compact wire batches
(``data/wire.py``), decoded on the device, on all four commands but
artifacts, which take dense batches.

``--checkpoint`` is a reference-format ``.pth``, loaded strictly (for
``train``: a warm start, shape-matching, or a full trainer checkpoint),
or for ``test`` and ``serve`` a serving artifact. An Orbax checkpoint of
the JAX package reaches the port as a ``.pth`` (``_ORBAX_ROUTE``). The
model commands take the JAX package's ``--mini-dataset`` (every split
row a test row) and ``--tpu-tuned`` (its TPU-tuned config, unchanged;
``search --vmap-trials`` refuses it, as torch.func cannot recompute).
One flag is new: ``--device`` (default ``cuda``, which raises without a
card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
from pathlib import Path

import numpy as np


class UserError(ValueError):
    """A CLI user error (bad flag, value or combination): printed as one
    line and exit code 2."""


# How an Orbax checkpoint of the JAX package reaches the port.
_ORBAX_ROUTE = ("an Orbax checkpoint of the JAX package comes across as a "
                ".pth written by `camradepth_tpu.cli export --format pth`, "
                "or for any variant, --tpu-decoder included, by `python "
                "tools/orbax_to_pth.py --checkpoint RUN --out W.pth`")


def _add_tpu_decoder_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tpu-decoder", action="store_true",
                   help="the tpu_decoder variant: the half- and full-"
                        "resolution decoder stages convolve at their input "
                        "resolution, 128 wide, and upsample by depth-to-"
                        "space; not weight-compatible with reference "
                        "checkpoints")


def _with_tpu_decoder(cfg, args):
    if args.tpu_decoder:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    tpu_decoder=True))
    return cfg


def _refuse_layout(cfg, checkpoint, e: RuntimeError) -> None:
    """A strict load that failed for a ``tpu_decoder`` model, as one line:
    the variant's TPUDecoder stages and subpixel head are the port's own
    layout, which no reference-format ``.pth`` has. Any other error goes
    on as it is."""
    if cfg.model.tpu_decoder and "loading state_dict" in str(e):
        raise UserError(
            f"{checkpoint} does not fit the tpu_decoder variant, whose "
            "TPUDecoder stages and subpixel head have no reference layout; "
            "give a checkpoint of a tpu_decoder run") from e


def _add_wire_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--wire", default=None, choices=["auto", "on", "off"],
                   help="compact wire batches (uint8 image + sparse radar "
                        "and GT, decoded on the device, bit for bit with "
                        "the dense stack): auto falls back to dense where "
                        "the codec does not cover the config, on refuses "
                        "(sets data.wire_format)")


# --tpu-tuned: the JAX package's TPU-tuned training shape
# (camradepth_tpu/cli.py:143-188), applied as it applies it: one
# microbatch of 6 padded to 8 (by setdefault, so --batch-size and
# --desired-batch-size win), both remats on, and wire_format auto unless
# --wire is given
_TPU_TUNED_TRAIN = dict(batch_size=6, desired_batch_size=6,
                        pad_microbatch_to=8)
_TPU_TUNED_MODEL = dict(remat_encoder=True, remat_decoder=True)


def _add_mini_tuned_flags(p: argparse.ArgumentParser) -> None:
    """``--mini-dataset`` and ``--tpu-tuned``, which the JAX package gives
    every model command (``_add_common_model_flags``,
    ``camradepth_tpu/cli.py:31``, ``:44-50``)."""
    p.add_argument("--mini-dataset", action="store_true",
                   help="every split row is a test row (sets "
                        "data.mini_dataset)")
    p.add_argument("--tpu-tuned", action="store_true",
                   help="the JAX package's TPU-tuned training shape: one "
                        "microbatch of 6 padded to 8 dummy-masked samples, "
                        "encoder and decoder recomputation, wire format "
                        "auto; the same config here (not tuned for the "
                        "H100)")


def _mini_tuned_data_kw(args) -> dict:
    """The data fields that --mini-dataset, --wire and --tpu-tuned set."""
    kw = {}
    if args.mini_dataset:
        kw["mini_dataset"] = True
    if args.wire is not None:
        kw["wire_format"] = args.wire
    elif args.tpu_tuned:
        kw["wire_format"] = "auto"
    return kw


def _add_common_flags(p: argparse.ArgumentParser,
                      device: bool = True) -> None:
    p.add_argument("--preset", default="base",
                   choices=["base", "base_rgb", "supervised_seg",
                            "unsupervised_seg", "sup_unsup_seg",
                            "sup_unsup_seg_rgb"],
                   help="published experiment preset (args.py:72-122)")
    p.add_argument("--split", default=None, help="(N,7) split .npy path")
    p.add_argument("--checkpoint", default=None,
                   help="reference-format .pth (loaded strictly), or for "
                        "test and serve a serving artifact")
    p.add_argument("--max-distances", default=None,
                   help="comma list of metric caps in metres (default "
                        "100,50)")
    p.add_argument("--set", action="append", dest="set_overrides",
                   default=None, metavar="SECTION.FIELD=VALUE",
                   help="override a config field by dotted path (sections "
                        "model, data), e.g. --set data.mini_dataset=1 (every "
                        "split row is a test row) or --set "
                        "model.compute_dtype=float32; repeatable, applied "
                        "last")
    if device:
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; cpu runs "
                            "the kernels' plain versions)")
    _add_tpu_decoder_flag(p)
    _add_wire_flag(p)
    _add_mini_tuned_flags(p)


def _build_config(args):
    from camradepth_tpu_torch import config as C

    try:
        cfg = C.preset(args.preset)
        data_kw = {}
        if args.split:
            data_kw["split_path"] = args.split
        if args.max_distances:
            data_kw["max_distances"] = tuple(
                float(v) for v in args.max_distances.split(","))
        data_kw.update(_mini_tuned_data_kw(args))
        if data_kw:
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
        if args.tpu_tuned:
            cfg = cfg.replace(
                train=dataclasses.replace(cfg.train, **_TPU_TUNED_TRAIN),
                model=dataclasses.replace(cfg.model, **_TPU_TUNED_MODEL))
        cfg = _with_tpu_decoder(cfg, args)
        if args.set_overrides:
            cfg = C.apply_overrides(cfg, args.set_overrides)
    except ValueError as e:  # bad --set path or value, preset invariants
        raise UserError(str(e)) from e
    return cfg


def _build_train_config(args):
    """The train config from the flags, as the JAX package's
    ``_build_config_inner`` (``camradepth_tpu/cli.py:127-190``) for the
    flags the port takes; ``--set`` applies last."""
    from camradepth_tpu_torch import config as C

    try:
        cfg = C.preset(args.preset)
        data_kw = {}
        if args.split:
            data_kw["split_path"] = args.split
        if args.train_val_split:
            n_tr, n_va = (int(v) for v in args.train_val_split.split(","))
            data_kw["train_val_split"] = (n_tr, n_va)
        data_kw.update(_mini_tuned_data_kw(args))
        if data_kw:
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
        train_kw = {}
        if args.batch_size is not None and args.desired_batch_size is None:
            # keep the accumulation invariant when only batch_size is given
            train_kw["desired_batch_size"] = args.batch_size
        for flag in ("batch_size", "desired_batch_size", "learning_rate",
                     "num_steps", "num_epochs", "checkpoint", "output_dir",
                     "run_name"):
            v = getattr(args, flag)
            if v is not None:
                train_kw[flag] = v
        if args.tpu_tuned:
            for k, v in _TPU_TUNED_TRAIN.items():
                train_kw.setdefault(k, v)
        if args.pad_microbatch is not None:
            train_kw["pad_microbatch_to"] = args.pad_microbatch
        if args.save_model:
            train_kw["save_model"] = True
        if args.async_checkpoint:
            train_kw["async_checkpoint"] = True
        if args.checkpoint:
            train_kw["load_ckpt"] = True
        if args.num_epochs is not None:
            train_kw["num_steps"] = None  # an epoch count, not a step budget
        if train_kw:
            cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                        **train_kw))
        model_kw = dict(_TPU_TUNED_MODEL) if args.tpu_tuned else {}
        if args.compute_dtype:
            model_kw["compute_dtype"] = args.compute_dtype
        if model_kw:
            cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                        **model_kw))
        mesh_kw = {}
        if args.data_parallel is not None:
            mesh_kw["data_parallel"] = args.data_parallel
        if args.fsdp is not None:
            mesh_kw["fsdp_parallel"] = args.fsdp
        if args.spatial_parallel is not None:
            mesh_kw["spatial_parallel"] = args.spatial_parallel
        if mesh_kw:
            cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, **mesh_kw))
        cfg = _with_tpu_decoder(cfg, args)
        if args.set_overrides:
            cfg = C.apply_overrides(cfg, args.set_overrides)
    except ValueError as e:  # bad --set path or value, preset invariants
        raise UserError(str(e)) from e
    return cfg


def _start_processes(args) -> bool:
    """Join the process group of a multi-process ``train``, ``distill`` or
    ``serve`` (``camradepth_tpu/cli.py:313-330``), before anything touches
    the device; True when this call started it."""
    from camradepth_tpu_torch.parallel import multihost

    if not (args.multihost or args.coordinator):
        if args.num_processes is not None or args.process_id is not None:
            raise UserError("--num-processes and --process-id need "
                            "--coordinator")
        return False
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        raise UserError(
            "--coordinator requires --num-processes and --process-id")
    try:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, device=args.device)
    except ValueError as e:  # no torchrun environment, bad combination
        raise UserError(str(e)) from e
    return True


def _train_and_report(args, make_trainer) -> int:
    """Join the process group the flags ask for, run ``make_trainer()``'s
    training, print the best validation loss (on the primary), and leave
    the group this command started, whatever was raised."""
    from camradepth_tpu_torch.parallel import multihost

    started = _start_processes(args)
    try:
        best = make_trainer().train()
        if multihost.is_primary():
            print(f"best val loss: {best:.6f}")
    finally:
        if started:
            multihost.shutdown()
    return 0


# the label space that each seg estimator emits, and the remaps that read it
_SEG_LABEL_SPACES = {
    "jax-panoptic": ("cityscapes", "vehicle_cityscapes"),
    "torchscript": ("merged", "vehicle"),
    "panoptic-deeplab": ("merged", "vehicle"),
}


def cmd_prep(args) -> int:
    """The offline data prep (``camradepth_tpu/cli.py:258-310``): a nuScenes
    world through the ten stages of ``dataprep/pipeline.py`` into the
    ``prepared_data/`` artifacts that train and test read. Checks in the
    JAX package's order: the --seg-remap label space (before any import,
    so it answers without the devkit), then the nuscenes-devkit (absent:
    its message, exit code 2), then the estimators on --device."""
    # a remap that does not match the estimator's label space would write
    # wrong but valid-looking *_mseg.npy artifacts with no error
    allowed = _SEG_LABEL_SPACES.get(args.seg)
    if allowed is not None and args.seg_remap not in allowed:
        space = ("cityscapes trainIds" if args.seg == "jax-panoptic"
                 else "mseg-universal ids")
        raise UserError(
            f"--seg {args.seg} produces {space}; --seg-remap must be one of "
            f"{allowed} (got '{args.seg_remap}')")

    from camradepth_tpu_torch.dataprep.pipeline import (
        ALL_STAGES,
        run_pipeline,
    )

    try:
        from nuscenes.nuscenes import NuScenes
    except ImportError:
        print(
            "error: the 'prep' command needs the nuscenes-devkit "
            "(not installed in this environment). Precomputed artifacts in "
            "the reference format are consumed directly by 'train'/'test'.",
            file=sys.stderr,
        )
        return 2
    nusc = NuScenes(args.version, dataroot=args.data_root, verbose=False)
    stages = tuple(args.stages.split(",")) if args.stages else ALL_STAGES
    from camradepth_tpu_torch.dataprep.adapters import (
        make_flow_estimator,
        make_seg_estimator,
    )

    flow_estimator = make_flow_estimator(args.flow, ckpt=args.flow_ckpt,
                                         device=args.device)
    seg_estimator = make_seg_estimator(args.seg, ckpt=args.seg_ckpt,
                                       device=args.device)
    run_pipeline(nusc, args.out, stage_names=stages, mini=args.mini,
                 flow_estimator=flow_estimator,
                 seg_estimator=seg_estimator,
                 seg_remap=args.seg_remap, device=args.device)
    return 0


def cmd_train(args) -> int:
    from camradepth_tpu_torch.train.trainer import Trainer

    return _train_and_report(args, lambda: Trainer(
        _build_train_config(args), run_dir=args.run_dir, device=args.device))


def _teacher_state(teacher_cfg, path: str, strict: bool):
    """The teacher's fp32 state_dict from a reference ``.pth``, a port
    trainer checkpoint, or a run directory (its best checkpoint, else its
    newest), as ``camradepth_tpu/cli.py:197-255`` loads a teacher. Strict:
    every tensor of the teacher's model must be there with its shape (a
    teacher with random heads would poison the dense targets), else one
    line names the mismatch. Not strict: the mismatched tensors keep a
    fresh init."""
    import torch

    from camradepth_tpu_torch.interop.flax_convert import (
        load_reference_checkpoint,
    )
    from camradepth_tpu_torch.models.camradepth import (
        CamRaDepth,
        create_model,
    )
    from camradepth_tpu_torch.utils import checkpoint as ckpt_util

    p = Path(path)
    if p.is_dir() and not p.name.startswith(("ckpt_epoch_",
                                             "ckpt_preempt_epoch_")):
        best = ckpt_util.best_checkpoint(p) or ckpt_util.latest_checkpoint(p)
        if best is None:
            raise UserError(f"{path} holds no ckpt_epoch_* / "
                            "ckpt_preempt_epoch_* checkpoints")
        print(f"using best checkpoint {best.name}")
        p = best
    if p.is_dir() or p.suffix != ".pth":
        raise UserError(f"{p}: the port loads .pth teachers only; "
                        f"{_ORBAX_ROUTE}")
    saved = load_reference_checkpoint(str(p))
    with torch.device("meta"):
        own = CamRaDepth(teacher_cfg.model).state_dict()
    bad = [k for k, v in own.items()
           if k not in saved or tuple(saved[k].shape) != tuple(v.shape)]
    if not bad:
        return {k: saved[k] for k in own}
    if strict:
        variant = " + tpu_decoder" if teacher_cfg.model.tpu_decoder else ""
        raise UserError(
            f"{path} does not fit the teacher ({teacher_cfg.name}{variant}): "
            f"{len(bad)} of {len(own)} tensors are missing or of another "
            f"shape, e.g. {bad[0]}; pass the teacher's --preset and "
            "--teacher-tpu-decoder, or --no-strict-teacher")
    model = create_model(teacher_cfg.model, device="cpu", train=True)
    ckpt_util.partial_restore(saved, model)
    return model.state_dict()


def cmd_distill(args) -> int:
    """Distill a parity teacher into the (usually ``--tpu-decoder``)
    student: dense per-pixel targets from the teacher, mixed with the
    lidar GT loss by ``--alpha``."""
    from camradepth_tpu_torch.train.distill import (
        DistillTrainer,
        check_pairing,
    )
    from camradepth_tpu_torch.train.trainer import run_layout

    def make_trainer():
        cfg = _build_train_config(args)
        # the layout's refusals before the teacher loads
        run_layout(cfg, args.run_dir)
        teacher_cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, tpu_decoder=args.teacher_tpu_decoder,
            # remat changes only the backward; the teacher never trains
            remat_encoder=False, remat_decoder=False,
            remat_decoder_small=False))
        try:
            check_pairing(cfg, teacher_cfg, args.alpha)
        except ValueError as e:
            raise UserError(str(e)) from e
        state = _teacher_state(teacher_cfg, args.teacher_checkpoint,
                               strict=not args.no_strict_teacher)
        return DistillTrainer(
            cfg, teacher_cfg, state, alpha=args.alpha,
            temperature=args.temperature,
            # a student --checkpoint (resume or continue) keeps its weights
            init_from_teacher=not args.no_teacher_init
            and not args.checkpoint,
            run_dir=args.run_dir, device=args.device)

    return _train_and_report(args, make_trainer)


# the default search space (camradepth_tpu/cli.py:590-595): log-spaced
# around the published learning rate 6e-5
_DEFAULT_SPACES = {"learning_rate": ((1e-5, 1e-3), "log"),
                   "weight_decay": ((1e-6, 1e-2), "log")}


def cmd_search(args) -> int:
    """Hyperparameter search (``camradepth_tpu/cli.py:568-652``): sample
    configs from typed spaces, train each for ``--trial-steps`` optimizer
    steps through the Trainer (``--halving``: successive halving), or all
    at once as one vmapped program (``--vmap-trials``, optimizer
    hyperparameters only), the trial axis sharded over the process group's
    ranks with ``--data-parallel``; one JSON line per result, then the
    best config."""
    from camradepth_tpu_torch.config import ConfigError
    from camradepth_tpu_torch.parallel import multihost
    from camradepth_tpu_torch.train import search

    trial_ranks = args.data_parallel
    cfg = _build_train_config(argparse.Namespace(
        **{**vars(args), "data_parallel": None}))
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, num_steps=args.trial_steps, save_model=False))
    if args.space:
        try:
            spaces = {k: (tuple(v[0]), v[1])
                      for k, v in json.loads(args.space).items()}
        except (ValueError, TypeError, IndexError, AttributeError) as e:
            raise UserError(f"--space is not a JSON object of "
                            f"[[lo, hi], mode] pairs: {e}") from e
    else:
        spaces = dict(_DEFAULT_SPACES)
    if trial_ranks and not args.vmap_trials:
        raise UserError("--data-parallel shards the trial axis of "
                        "--vmap-trials; the sequential search takes none")
    if args.tpu_tuned and args.vmap_trials:
        raise UserError(
            "--tpu-tuned turns on remat_encoder and remat_decoder, which "
            "--vmap-trials cannot run (torch.func has no recomputation); "
            "drop --tpu-tuned, or search without --vmap-trials")
    if args.vmap_trials:  # the refusals before any data loads
        try:
            search._check_vmap_spaces(spaces)
        except ValueError as e:
            raise UserError(str(e)) from e
        search.check_vmappable(cfg)
    started = _start_processes(args)
    try:
        if trial_ranks and multihost.process_count() != trial_ranks:
            raise UserError(
                f"--data-parallel {trial_ranks} shards the trials over "
                f"{trial_ranks} processes, the process group has "
                f"{multihost.process_count()} (start them with "
                "--coordinator/--num-processes/--process-id or --multihost)")
        if args.vmap_trials:
            from camradepth_tpu_torch.data.pipeline import make_loaders

            loaders = make_loaders(cfg.data, cfg.train.batch_size)
            kw = dict(num_trials=args.num_trials, seed=args.seed,
                      loaders=loaders, shard_trials=bool(trial_ranks),
                      device=args.device)
            try:
                if args.halving:
                    best, best_loss, results = search.vmapped_halving(
                        cfg, spaces, min_steps=args.min_steps,
                        max_steps=args.trial_steps, **kw)
                else:
                    best, best_loss, results = search.vmapped_trials(
                        cfg, spaces, num_steps=args.trial_steps, **kw)
            except ValueError as e:
                if isinstance(e, ConfigError) or not (
                        "train split too small" in str(e)
                        or "must divide" in str(e)):
                    raise
                print(f"error: {e}", file=sys.stderr)
                return 2
        elif args.halving:
            best, best_loss, results = search.successive_halving_search(
                cfg, spaces, num_trials=args.num_trials,
                min_steps=args.min_steps, max_steps=args.trial_steps,
                seed=args.seed, device=args.device)
        else:
            best, best_loss, results = search.random_search(
                cfg, spaces, num_trials=args.num_trials, seed=args.seed,
                device=args.device)
        if multihost.is_primary():
            for r in results:
                print(json.dumps(r))
            print(f"best config: {json.dumps(best)} "
                  f"(val loss {best_loss:.6f})")
    finally:
        if started:
            multihost.shutdown()
    return 0


def _check_args(args, artifacts: bool = True) -> None:
    if not args.checkpoint:
        raise UserError(f"--checkpoint required for {args.command}")
    from camradepth_tpu_torch.interop.export import is_artifact

    if artifacts and is_artifact(args.checkpoint):
        return
    if Path(args.checkpoint).suffix != ".pth":
        what = " or serving artifacts" if artifacts else ""
        raise UserError(
            f"{args.checkpoint}: the port loads reference-format .pth "
            f"checkpoints{what} only; {_ORBAX_ROUTE}")


def _load_model(cfg, checkpoint: str, device, train: bool = False):
    """The model of ``cfg`` with the ``.pth`` weights, loaded strictly; a
    reference checkpoint given for the ``tpu_decoder`` variant is refused
    in one line."""
    from camradepth_tpu_torch.interop.flax_convert import (
        load_reference_checkpoint,
    )
    from camradepth_tpu_torch.models.camradepth import create_model

    try:
        return create_model(cfg.model, device=device, train=train,
                            state_dict=load_reference_checkpoint(checkpoint))
    except RuntimeError as e:
        _refuse_layout(cfg, checkpoint, e)
        raise


def _load_artifact(cfg, path: str, device):
    """(call, header) of a serving artifact whose geometry is the
    config's; a JAX artifact, a corrupt file or another geometry is a
    user error."""
    from camradepth_tpu_torch.interop.export import (
        check_geometry,
        load_serving_artifact,
        read_header,
    )

    try:
        check_geometry(read_header(path)[0], cfg)
        return load_serving_artifact(path, device)
    except (ValueError, OSError) as e:  # not an artifact of ours, or none
        raise UserError(str(e)) from e


def _refuse_mesh(cfg, args) -> None:
    """A ``mesh.*`` layout is training's: ``serve`` takes its layout from
    ``--data-parallel`` and ``--spatial-parallel``, and ``test`` scores on
    one process, as the JAX package's ``cli test`` does."""
    m = cfg.mesh
    flags = [f for f in ("data_parallel", "spatial_parallel")
             if args.command == "test" and getattr(args, f) is not None]
    if flags or m.data_parallel > 1 or m.fsdp_parallel > 1 \
            or m.spatial_parallel > 1:
        where = ("serve takes its layout from --data-parallel and "
                 "--spatial-parallel" if args.command == "serve" else
                 "test scores on one process, as the JAX package's cli test "
                 "does; serve on a mesh with cli serve --data-parallel / "
                 "--spatial-parallel")
        what = (f"--{flags[0].replace('_', '-')}" if flags
                else "a mesh.* layout (training's)")
        raise UserError(f"{what} is not taken here: {where}")


def _refuse_wire_on(cfg) -> None:
    if cfg.data.wire_format == "on":
        raise UserError(
            "data.wire_format=on is incompatible with artifact serving: "
            "artifacts bake a dense input signature; use wire auto or off")


def cmd_test(args) -> int:
    from camradepth_tpu_torch import resolve_device
    from camradepth_tpu_torch.data.pipeline import make_loaders
    from camradepth_tpu_torch.data.wire import resolve_wire_ship
    from camradepth_tpu_torch.evaluation.harness import (
        evaluate,
        format_report,
        make_artifact_test_step,
    )
    from camradepth_tpu_torch.interop.export import is_artifact

    _check_args(args)
    cfg = _build_config(args)
    _refuse_mesh(cfg, args)
    dev = resolve_device(args.device)
    if is_artifact(args.checkpoint):
        # score the program that will serve, on dense batches
        _refuse_wire_on(cfg)
        call, header = _load_artifact(cfg, args.checkpoint, dev)
        bs = header["batch_size"] or args.test_batch
        if args.test_batch != bs:
            print(f"note: artifact batch size is {bs}; overriding "
                  f"--test-batch {args.test_batch}")
        loader = make_loaders(cfg.data, batch_size=bs)["test"]
        if loader is None:
            raise UserError("the split has no test frames")
        report = evaluate(cfg, None, loader, device=dev,
                          test_step=make_artifact_test_step(cfg, call,
                                                            header))
    else:
        # a wire test loader ships only the seg plane the IoU reads
        wire = cfg.data.wire_format != "off"
        loader = make_loaders(resolve_wire_ship(cfg) if wire else cfg.data,
                              batch_size=args.test_batch,
                              wire_eval=wire)["test"]
        if loader is None:
            raise UserError("the split has no test frames")
        model = _load_model(cfg, args.checkpoint, dev)
        report = evaluate(cfg, model, loader, device=dev)
    print(format_report(cfg, report))
    if args.report_json:
        Path(args.report_json).write_text(
            json.dumps({k: float(v) for k, v in report.items()}, indent=1)
        )
        print(f"wrote {args.report_json}")
    return 0


def http_wire_plan(cfg):
    """The wire plan of an HTTP engine, which has no dataset to probe for
    point caps: from ``data.wire_radar_cap`` (``camradepth_tpu/cli.py:
    724-770``); None serves dense requests (wire ``auto`` without a cap,
    or a channel set the codec does not cover)."""
    from camradepth_tpu_torch.data.wire import (
        WirePlan,
        radar_channel_count,
        wire_supported,
    )

    on = cfg.data.wire_format == "on"
    if not wire_supported(cfg.data):
        if on:
            raise UserError(
                "data.wire_format=on is unsupported for this channel "
                "config (im_uv / sparse_lidar need the dense request "
                "format); use wire auto or off")
        return None
    if not cfg.data.wire_radar_cap:
        if on:
            raise UserError(
                "HTTP wire serving needs an explicit request shape: pass "
                "--set data.wire_radar_cap=N (no dataset to probe point "
                "caps from)")
        return None
    n_radar_ch = radar_channel_count(cfg.data)
    if cfg.model.input_channels <= 3:
        raise UserError(
            "data.wire_radar_cap set but the model takes no radar channels "
            f"(input_channels={cfg.model.input_channels}): wire serving "
            "needs a camera+radar preset")
    if n_radar_ch != cfg.model.input_channels - 3:
        raise UserError(
            f"model/data channel mismatch: the data config carries "
            f"{n_radar_ch} radar channels but the model expects "
            f"{cfg.model.input_channels - 3} (input_channels="
            f"{cfg.model.input_channels}); fix the preset/--set pairing "
            "before wire serving")
    return WirePlan(radar_cap=cfg.data.wire_radar_cap, gt_cap=0,
                    n_radar_ch=n_radar_ch)


def cmd_serve(args) -> int:
    """Serve over a split or HTTP, on one process or on a mesh of them
    (``--data-parallel`` x ``--spatial-parallel`` ranks); the process
    group this command starts is left at the end, whatever was raised."""
    from camradepth_tpu_torch.interop.export import is_artifact
    from camradepth_tpu_torch.parallel import multihost
    from camradepth_tpu_torch.parallel.mesh import serving_layout

    _check_args(args)
    cfg = _build_config(args)
    _refuse_mesh(cfg, args)
    artifact = is_artifact(args.checkpoint)
    # every refusal of the layout comes before any process starts
    layout = serving_layout(args.data_parallel or 1,
                            args.spatial_parallel or 1,
                            cfg.model.img_size[0], args.serve_batch,
                            artifact, cfg.data.wire_format)
    started = _start_processes(args)
    try:
        return _serve(args, cfg, artifact, layout)
    finally:
        if started:
            multihost.shutdown()


def _serve(args, cfg, artifact: bool, layout) -> int:
    from camradepth_tpu_torch.data.pipeline import make_loaders
    from camradepth_tpu_torch.data.wire import is_wire_micro
    from camradepth_tpu_torch.parallel import multihost
    from camradepth_tpu_torch.parallel.mesh import serving_mesh
    from camradepth_tpu_torch.serving import SERVE_WIRE_KEYS, load_engine

    mesh = serving_mesh(layout, cfg.model.img_size[0])
    primary = multihost.is_primary()
    http = args.http_port is not None
    if artifact:
        _refuse_wire_on(cfg)
    # compact wire requests (camradepth_tpu/cli.py:703-783), decoded on
    # the device by the engine: over HTTP with data.wire_radar_cap's
    # shape, over a split with the loaders' plan ("auto" stays dense where
    # the codec does not suit the data: the plan is None, and under
    # spatial sharding, whose decode would not be frame-local)
    wire = (cfg.data.wire_format != "off" and not artifact
            and (layout is None or layout.sp == 1))
    loader = wire_plan = None
    if http:
        wire_plan = http_wire_plan(cfg) if wire else None
    elif wire:
        loaders = make_loaders(cfg.data, batch_size=args.serve_batch,
                               wire_eval=True)
        loader = loaders["test"] or loaders["val"]
        if loader is None:
            raise UserError("the split has no test/val frames")
        wire_plan = loader.frames.wire_plan
    try:
        engine = load_engine(cfg, args.checkpoint,
                             batch_size=args.serve_batch, device=args.device,
                             wire_plan=wire_plan, mesh=mesh)
    except RuntimeError as e:
        _refuse_layout(cfg, args.checkpoint, e)
        raise
    except ValueError as e:
        # a wire plan of other channels than the model's; an artifact of
        # another geometry, of the JAX package, or corrupt
        raise UserError(str(e)) from e
    except OSError as e:  # no such artifact (a .pth goes to torch.load)
        if not artifact:
            raise
        raise UserError(str(e)) from e
    if http:
        from camradepth_tpu_torch.serving_http import serve_forever

        serve_forever(engine, cfg, args.http_host, args.http_port,
                      batch_window_ms=args.http_batch_window_ms)
        return 0
    if loader is None:
        # batched to the engine's size (a fixed-batch artifact serves its
        # own), so whole batches pass through without a restack
        loaders = make_loaders(cfg.data, batch_size=engine.batch_size)
        loader = loaders["test"] or loaders["val"]
        if loader is None:
            raise UserError("the split has no test/val frames")
    out_dir = Path(args.out)
    if primary:
        out_dir.mkdir(parents=True, exist_ok=True)

    def frames():
        # whole batches pass through infer_stream without a restack; the
        # loader pads and masks the tail, so only valid rows go on
        for batch in loader:
            valid = batch["valid"].astype(bool)
            if is_wire_micro(batch):
                item = {k: batch[k] for k in SERVE_WIRE_KEYS}
                yield item if valid.all() else {k: v[valid]
                                                for k, v in item.items()}
                continue
            feats = batch["features"][..., : cfg.model.input_channels]
            yield feats if valid.all() else feats[valid]

    n = 0
    # on a mesh every rank streams the same frames; rank 0 gets the maps
    for i, res in enumerate(engine.infer_stream(frames(),
                                                inflight=args.inflight)):
        if primary:
            np.save(out_dir / f"{i:05d}_depth.npy", res["depth"])
            if "seg" in res:
                np.save(out_dir / f"{i:05d}_seg.npy", res["seg"])
        n += 1
        if args.limit and n >= args.limit:
            break
    stats = engine.stats()
    # "frames" = frames written (--limit can stop mid-batch); the engine's
    # own count stays available as frames_processed
    stats["frames_processed"] = stats.pop("frames", 0.0)
    if primary:
        print(json.dumps({**stats, "frames": n}))
    return 0


def cmd_export(args) -> int:
    """Export a checkpoint: the reference-format ``.pth`` or a serving
    artifact (``interop/export.py``: weights inside, runs with no model
    code or config; the deployment format of the ``tpu_decoder`` variant,
    which has no reference layout)."""
    import torch

    from camradepth_tpu_torch import resolve_device

    _check_args(args, artifacts=False)
    cfg = _build_config(args)
    if args.format == "artifact":
        from camradepth_tpu_torch.interop.export import (
            export_serving_artifact,
        )

        model = _load_model(cfg, args.checkpoint,
                            resolve_device(args.device))
        header = export_serving_artifact(
            cfg, model, args.out, batch_size=args.serve_batch,
            artifact_dtype=args.artifact_dtype,
            dynamic_batch=args.dynamic_batch)
        print(f"wrote serving artifact to {args.out} (batch "
              f"{header['batch_size'] or 'dynamic'}, traced on "
              f"{header['platforms'][0]}, {header['artifact_dtype']} "
              "weights)")
        return 0
    if cfg.model.tpu_decoder:
        raise UserError(
            "the TPU architecture variant (--tpu-decoder) has no "
            "reference-format representation: its subpixel decoder stages "
            "do not exist in the reference model. Use --format artifact "
            "(its deployment path) or export a parity-architecture "
            "checkpoint.")
    model = _load_model(cfg, args.checkpoint, "cpu", train=True)
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd, "lr": cfg.train.learning_rate}, args.out)
    print(f"wrote {len(sd)} tensors to {args.out}")
    return 0


def cmd_validate_data(args) -> int:
    """Check a prepared dataset (a split table, or a directory globbed into
    one) against the loader's frame contract: one line per error, then a
    summary; exit code 0 when clean, 1 with errors, 2 unless exactly one
    of --split and --data-dir is given."""
    from camradepth_tpu_torch.data.split import (
        MAX_ERRORS,
        build_split_from_dir,
        load_split,
        validate_split,
    )

    if bool(args.split) == bool(args.data_dir):
        print("error: give exactly one of --split / --data-dir",
              file=sys.stderr)
        return 2
    rows = (load_split(args.split) if args.split
            else build_split_from_dir(args.data_dir))
    hw = tuple(int(v) for v in args.image_dimension.split(","))
    r = validate_split(rows, image_dimension=hw, limit=args.limit,
                       decode_images=not args.no_decode)
    for i, msg in r["errors"]:
        print(f"row {i}: {msg}")
    n_err = len(r["errors"])
    extra = " (further errors suppressed)" if n_err >= MAX_ERRORS else ""
    status = "OK" if r["ok"] else f"{n_err} errors"
    print(f"checked {r['checked']} rows: {status}{extra}")
    return 0 if r["ok"] else 1


def cmd_viz(args) -> int:
    """Prediction collages of the test (or val) frames, from a ``.pth``
    (reference or trainer checkpoint) or a serving artifact."""
    import torch

    from camradepth_tpu_torch import resolve_device
    from camradepth_tpu_torch.data.pipeline import make_loaders
    from camradepth_tpu_torch.interop.export import is_artifact, read_header
    from camradepth_tpu_torch.viz import run_visualization

    _check_args(args)
    cfg = _build_config(args)
    dev = resolve_device(args.device)
    predict = model = None
    batch_size = args.test_batch
    if is_artifact(args.checkpoint):
        try:
            header = read_header(args.checkpoint)[0]
        except (ValueError, OSError) as e:
            raise UserError(str(e)) from e
        if tuple(header["img_size"]) != tuple(cfg.model.img_size):
            raise UserError(
                f"artifact geometry {header['img_size']} does not match "
                f"the '{cfg.name}' config's {list(cfg.model.img_size)} — "
                "pass the preset it was exported from")
        call, header = _load_artifact(cfg, args.checkpoint, dev)
        batch_size = header["batch_size"] or args.test_batch
        max_depth = float(header["max_depth"])
        decode = bool(header["decode_depth"])
        n_in = cfg.model.input_channels

        def predict(feats):
            x = torch.from_numpy(np.ascontiguousarray(feats[..., :n_in]))
            out = call(x.to(dev))
            depth = out["depth"].float().cpu().numpy()
            if decode:  # the collages take the [0, 1] inverse encoding
                depth = 1.0 - depth / max_depth
            seg = out["seg"]
            return depth, None if seg is None else seg.cpu().numpy()
    else:
        model = _load_model(cfg, args.checkpoint, dev)
    loaders = make_loaders(cfg.data, batch_size=batch_size)
    loader = loaders["test"] or loaders["val"]
    if loader is None:
        raise UserError("the split has no test/val frames")
    n = run_visualization(cfg, model, loader, args.out, args.num_vis,
                          predict=predict, device=dev)
    print(f"wrote {n} collages to {args.out}")
    return 0


# the measured single-card train step that anchors --project-scaling: the
# bf16 step of base at 416x800, batch 2 x 3, on an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit (PERF.md section 5, chip_smoke.py phase (h))
H100_STEP_MS = 1782.76


def cmd_summary(args) -> int:
    """Model summary: the per-module parameter table and the analytic
    per-frame FLOPs with their compute floor on the card
    (``utils/roofline.py``), from a model on the ``meta`` device: no
    weights, no CUDA context."""
    import torch

    from camradepth_tpu_torch.models.camradepth import create_model
    from camradepth_tpu_torch.utils import roofline as rl

    cfg = _build_config(args)
    model = create_model(cfg.model, device="meta")
    h, w = cfg.model.img_size
    b = args.summary_batch

    def count(mod):
        return sum(p.numel() for p in mod.parameters())

    total = count(model)
    print(f"CamRaDepth preset={cfg.name} img={h}x{w} "
          f"in_ch={cfg.model.input_channels} depths={cfg.model.depths}"
          + (" [tpu_decoder]" if cfg.model.tpu_decoder else ""))
    print(f"{'module':<40}{'params':>14}")
    for name, child in sorted(model.named_children()):
        if count(child):
            print(f"{name:<40}{count(child):>14,}")
    print(f"{'TOTAL':<40}{total:>14,}  "
          f"({total * 4 / 1e6:.1f} MB fp32)")

    r = rl.forward_roofline(cfg.model, b)
    gf = sum(op.flops for op in r.matmuls) / b / 1e9
    floor_ms = r.t_matmul_floor / b * 1e3
    peak = rl.peak_for(torch.finfo(model.dtype).bits)
    print(f"matmul GFLOPs/frame: {gf:.1f}  "
          f"(wgmma-tile-padded attainable floor at batch {b}: "
          f"{floor_ms:.2f} ms/frame on an H100 at {peak / 1e12:.0f} "
          f"TFLOP/s {cfg.model.compute_dtype} — compute term only; cli "
          "bench adds the kernels' and the unfused eager bytes terms)")

    if args.project_scaling:
        from camradepth_tpu_torch.utils import scaling

        step_ms = args.step_time_ms
        if step_ms is None:
            step_ms = H100_STEP_MS
        pts = scaling.project_dp_scaling(
            total, step_ms / 1e3, n_chips=[1, 2, 4, 8, 16, 32, 64],
            mode=args.project_scaling)
        frames = cfg.train.desired_batch_size or cfg.train.batch_size
        print()
        print(scaling.format_projection(
            pts, args.project_scaling, total, frames_per_step=frames))
    return 0


_CKPT_NAME = re.compile(r"ckpt_(?:preempt_)?epoch_")


def _run_dir_checkpoints(path: Path):
    """The checkpoint entries of a run directory (or of one checkpoint
    named ``ckpt_...``), as the JAX package's ``cli inspect`` lists them:
    names, bytes, epoch and eval loss, or epoch and step of a preempt save;
    a port checkpoint is a ``.pth`` file, an Orbax one a directory (never
    opened)."""
    from camradepth_tpu_torch.utils.checkpoint import _PREEMPT, _REGULAR, _stem

    candidates = ([path] if _CKPT_NAME.match(path.name)
                  else sorted(path.glob("ckpt_epoch_*_loss_*"))
                  + sorted(path.glob("ckpt_preempt_epoch_*_step_*")))
    out = []
    for p in candidates:
        m = _REGULAR.match(_stem(p))
        pm = None if m else _PREEMPT.match(_stem(p))
        if not m and not pm:
            continue
        size = (p.stat().st_size if p.is_file() else
                sum(f.stat().st_size for f in p.rglob("*") if f.is_file()))
        entry = {"name": p.name, "bytes": size}
        if m:
            entry.update(epoch=int(m.group(1)), eval_loss=float(m.group(2)))
        else:
            # graceful-shutdown save: epoch = epochs completed, no val loss
            entry.update(epoch=int(pm.group(1)), step=int(pm.group(2)),
                         preempt=True)
        out.append(entry)
    return candidates, out


def cmd_inspect(args) -> int:
    """Identify and summarize a file this package writes or reads, as one
    JSON object, touching no device: a serving artifact (its header and
    blob bytes), a reference or trainer ``.pth``, a run directory of
    ``.pth`` checkpoints or of Orbax ones (names and sizes; Orbax is not
    imported), or a split table."""
    import torch

    from camradepth_tpu_torch.interop.export import is_artifact, read_header
    from camradepth_tpu_torch.utils.checkpoint import latest_checkpoint

    path = Path(args.path)
    if not path.exists():
        print(f"error: {path} does not exist", file=sys.stderr)
        return 2
    info: dict = {"path": str(path)}
    if path.is_file() and is_artifact(str(path)):
        try:
            header, blob_bytes = read_header(str(path))
        except ValueError as e:  # a JAX artifact or a bad magic
            raise UserError(str(e)) from e
        info.update(type="torch-export-artifact", header=header,
                    blob_bytes=blob_bytes)
    elif path.is_dir() or _CKPT_NAME.match(path.name):
        candidates, ckpts = _run_dir_checkpoints(path)
        if not ckpts:
            print(f"error: {path} holds no ckpt_epoch_* / "
                  "ckpt_preempt_epoch_* checkpoints", file=sys.stderr)
            return 2
        latest = latest_checkpoint(path if candidates != [path]
                                   else path.parent)
        files = any(p.is_file() for p in candidates)
        info.update(type="run-dir" if files else "orbax-run-dir",
                    checkpoints=ckpts,
                    latest=str(latest) if latest else None)
    elif path.suffix == ".pth":
        state = torch.load(str(path), map_location="cpu", weights_only=True)
        sd = state.get("state_dict", state) if isinstance(state, dict) \
            else state
        try:
            n_params = int(sum(v.numel() for v in sd.values()))
        except AttributeError:
            n_params = None
        info.update(
            type="reference-pth", tensors=len(sd), params=n_params,
            extra_keys=sorted(k for k in state if k != "state_dict")
            if isinstance(state, dict) and "state_dict" in state else [],
        )
    elif path.suffix == ".npy":
        rows = np.load(str(path), allow_pickle=True)
        info.update(type="split-table", shape=list(rows.shape))
        if rows.ndim == 2 and rows.shape[1] == 7 and len(rows):
            info["first_row"] = [str(v) for v in rows[0]]
    else:
        print(f"error: unrecognized artifact {path} (expected a "
              "StableHLO artifact, .pth, Orbax dir, or split .npy)",
              file=sys.stderr)
        return 2
    print(json.dumps(info, indent=1))
    return 0


# run in a subprocess by cmd_doctor: CUDA's first touch can hang where a
# driver or card is wedged, so it happens where a timeout can end it
_DOCTOR_PROBE = (
    "import torch\n"
    "print('torch', torch.__version__, '| cuda', torch.version.cuda)\n"
    "if not torch.cuda.is_available():\n"
    "    raise SystemExit('torch.cuda.is_available() is False')\n"
    "for i in range(torch.cuda.device_count()):\n"
    "    p = torch.cuda.get_device_properties(i)\n"
    "    print(f'device {i}: {p.name}, {p.total_memory / 2**30:.2f} GiB, '\n"
    "          f'{p.multi_processor_count} SMs')\n"
)


def _tool_line(cmd, timeout: float) -> str:
    """The last line ``cmd`` prints, or why it printed none."""
    import subprocess

    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except OSError as e:
        return f"MISSING ({e.strerror})"
    except subprocess.TimeoutExpired:
        return f"no answer in {timeout:.0f}s"
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return f"FAILED rc={proc.returncode}: {proc.stderr.strip()[-200:]}"
    return lines[-1]


def cmd_doctor(args) -> int:
    """Environment health report: the card (probed in a subprocess bounded
    by --timeout: name, count, memory, power limit), nvcc and the kernel
    build directory, the native host library, and the optional modules.
    Exit code 1 when no card answers; it never hangs and leaves this
    process without a CUDA context."""
    import shutil
    import subprocess

    from camradepth_tpu_torch import native
    from camradepth_tpu_torch.ops import _build

    ok = True
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _DOCTOR_PROBE], capture_output=True,
            text=True, timeout=args.timeout)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            ok = False
            print(f"card: NONE answered (rc={proc.returncode}: "
                  f"{proc.stderr.strip()[-300:]})")
    except subprocess.TimeoutExpired:
        ok = False
        print(f"card: NONE answered (CUDA init hung > {args.timeout:.0f}s)")
    print("nvidia-smi: " + _tool_line(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], args.timeout))
    try:
        nvcc = _build.nvcc_path()
        print(f"nvcc: {nvcc} ({_tool_line([nvcc, '--version'], 60)})")
    except RuntimeError as e:
        print(f"nvcc: MISSING ({e})")
    bdir = _build.build_dir()
    built = sorted(p.stem.removeprefix("lib") for p in bdir.glob("lib*.so"))
    pending = sorted(p.name for p in bdir.glob("*.tmp"))
    print(f"kernel build dir: {bdir} ({len(built)} of {len(_build.SIGNATURES)}"
          " libraries built"
          + (f"; build in progress or cut: {', '.join(pending)}"
             if pending else "") + ")")
    try:
        native.library()
        print(f"native host library: ok ({native.build_info['path']}, "
              f"{native.build_info['gxx']})")
    except native.NativeCompileError as e:
        print(f"native host library: MISSING ({e})")
    for mod, why in (("cv2", "jpg decode (loader, prep)"),
                     ("torch", "everything"),
                     ("nuscenes", "offline prep only")):
        try:
            __import__(mod)
            print(f"{mod}: ok ({why})")
        except ImportError:
            print(f"{mod}: missing ({why})")
    free_gb = shutil.disk_usage(_build.BUILD_ROOT.parents[1]).free / 2 ** 30
    print(f"free disk at the build dir: {free_gb:.1f} GiB")
    return 0 if ok else 1


def cmd_bench(args) -> int:
    from camradepth_tpu_torch import bench

    return bench.main(["--train"] if args.train else [])


def _add_train_flags(p: argparse.ArgumentParser,
                     layout: bool = True) -> None:
    """The flags of ``train``, which ``distill`` shares (``search`` takes
    them without the layout flags)."""
    p.add_argument("--preset", default="base",
                   choices=["base", "base_rgb", "supervised_seg",
                            "unsupervised_seg", "sup_unsup_seg",
                            "sup_unsup_seg_rgb"],
                   help="published experiment preset (args.py:72-122)")
    p.add_argument("--split", default=None, help="(N,7) split .npy path")
    p.add_argument("--train-val-split", default=None, metavar="NTR,NVA",
                   help="train and val row counts of the split")
    p.add_argument("--checkpoint", default=None,
                   help="warm start: a reference .pth (shape-matching "
                        "params) or a trainer checkpoint (full state)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--desired-batch-size", type=int, default=None,
                   help="effective batch via gradient accumulation "
                        "(args.py:31); defaults to --batch-size when that "
                        "is given")
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--num-epochs", type=int, default=None,
                   help="train this many epochs (clears the step budget)")
    p.add_argument("--pad-microbatch", type=int, default=None,
                   help="pad each training microbatch to this size with "
                        "dummy samples that every loss term ignores")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--run-name", default=None)
    p.add_argument("--run-dir", default=None,
                   help="explicit run directory (default: auto-indexed "
                        "Output/<arch>/<run>/<n>)")
    p.add_argument("--save-model", action="store_true",
                   help="write a checkpoint at each new best val loss")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write best-val checkpoints on a background thread")
    p.add_argument("--compute-dtype", default=None,
                   choices=["bfloat16", "float32"])
    _add_tpu_decoder_flag(p)
    _add_wire_flag(p)
    _add_mini_tuned_flags(p)
    p.add_argument("--set", action="append", dest="set_overrides",
                   default=None, metavar="SECTION.FIELD=VALUE",
                   help="override a config field by dotted path (sections "
                        "model, data, train, mesh); repeatable, applied "
                        "last")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu runs "
                        "the kernels' plain versions); under a process "
                        "group each rank takes its own card")
    _add_process_flags(p)
    if not layout:
        p.set_defaults(fsdp=None, spatial_parallel=None)
        return
    p.add_argument("--data-parallel", type=int, default=None,
                   help="data-axis ranks (DDP; -1 sizes it from the ranks "
                        "and the batch); batches shard jointly over data x "
                        "fsdp")
    p.add_argument("--fsdp", type=int, default=None,
                   help="fsdp-axis ranks (FSDP2: parameters, gradients and "
                        "optimizer state sharded)")
    p.add_argument("--spatial-parallel", type=int, default=None,
                   help="sp-axis ranks (2, alone, as the JAX package "
                        "trains): every rank holds the whole batch and "
                        "runs its rows of each image, partitioned at /32")


def _add_process_flags(p: argparse.ArgumentParser) -> None:
    """The flags that start a multi-process run (train, distill, serve)."""
    p.add_argument("--multihost", action="store_true",
                   help="join the process group from torchrun's "
                        "environment (one process per device)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="start the process group at this address (needs "
                        "--num-processes and --process-id; the explicit "
                        "form of --multihost)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def main(argv=None) -> int:
    from camradepth_tpu_torch.config import ConfigError

    parser = argparse.ArgumentParser(
        prog="camradepth_tpu_torch",
        description="CamRaDepth on PyTorch/CUDA: prep, train, distill, "
                    "search, test, serve, export, validate-data, viz, "
                    "summary, inspect, doctor and bench",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prep", help="offline data preparation (10 stages) "
                                    "of a nuScenes world")
    p.add_argument("--data-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--mini", action="store_true")
    p.add_argument("--stages", default=None,
                   help="comma list; default all")
    p.add_argument("--flow", default="lk",
                   choices=["lk", "none", "jax-raft", "raft", "torchscript"],
                   help="optical-flow estimator: built-in pyramidal LK, a "
                        "RAFT TorchScript export (--flow-ckpt), this "
                        "package's RAFT-large fed an official .pth "
                        "(jax-raft, the JAX package's name for it), or "
                        "none (expects precomputed *_flow.npy)")
    p.add_argument("--flow-ckpt", default="",
                   help="official RAFT .pth for --flow jax-raft, TorchScript "
                        "file for raft/torchscript (reference "
                        "scripts/cal_flow.py:18-21)")
    p.add_argument("--seg", default="none",
                   choices=["none", "jax-panoptic", "torchscript",
                            "panoptic-deeplab"],
                   help="semantic-seg estimator: 'jax-panoptic' (the "
                        "official panoptic_deeplab_R101_os32_cityscapes"
                        ".pth in this package's Panoptic-DeepLab; the JAX "
                        "package's name for it), a TorchScript export "
                        "(--seg-ckpt) or none (expects precomputed "
                        "*_mseg.npy; scripts/semantic_seg.py)")
    p.add_argument("--seg-ckpt", default="",
                   help="checkpoint for --seg (official .pth for "
                        "jax-panoptic, TorchScript file otherwise)")
    p.add_argument("--seg-remap", default="merged",
                   choices=["merged", "vehicle", "cityscapes",
                            "vehicle_cityscapes"],
                   help="estimator label space + artifact: mseg-universal "
                        "-> 21-class ('merged') / vehicle mask "
                        "('vehicle'); cityscapes trainIds -> 21-class "
                        "('cityscapes') / vehicle mask "
                        "('vehicle_cityscapes', semantic_seg.py:163-166). "
                        "Use the cityscapes pair with --seg jax-panoptic")
    p.add_argument("--device", default="cuda",
                   help="torch device of the estimators and the radar "
                        "raster (default cuda; cpu runs them on the host)")
    p.set_defaults(fn=cmd_prep)

    p = sub.add_parser("train", help="train a model variant on one device or "
                                     "across processes")
    _add_train_flags(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "distill",
        help="distill a parity teacher checkpoint into the --tpu-decoder "
             "variant (dense per-pixel teacher targets)")
    _add_train_flags(p)
    p.add_argument("--teacher-checkpoint", required=True,
                   help="teacher weights: a reference .pth, a trainer "
                        "checkpoint, or a run dir (its best checkpoint)")
    p.add_argument("--teacher-tpu-decoder", action="store_true",
                   help="the teacher itself is a tpu_decoder model")
    p.add_argument("--no-strict-teacher", action="store_true",
                   help="allow a partly matching teacher checkpoint (its "
                        "mismatched tensors keep a fresh init)")
    p.add_argument("--alpha", type=float, default=0.7,
                   help="objective mix: alpha * distill + (1 - alpha) * GT "
                        "multitask loss (default 0.7; 1.0 = distillation "
                        "alone)")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="softmax temperature of the seg-logit KL terms")
    p.add_argument("--no-teacher-init", action="store_true",
                   help="skip the shape-matching warm start of the student "
                        "from the teacher (skipped anyway when --checkpoint "
                        "gives a student)")
    p.set_defaults(fn=cmd_distill)

    p = sub.add_parser(
        "search", help="hyperparameter search: random, successive halving, "
                       "or every trial at once (--vmap-trials)")
    _add_train_flags(p, layout=False)
    p.add_argument("--num-trials", type=int, default=10,
                   help="reference default args.random_search_num_trials")
    p.add_argument("--trial-steps", type=int, default=50,
                   help="optimizer-step budget per trial")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the sampled trials (numpy default_rng)")
    p.add_argument("--space", default=None,
                   help='JSON {"field": [[lo,hi],"log|float|int|item"], ...};'
                        " model./data. prefixes route to those config trees")
    p.add_argument("--halving", action="store_true",
                   help="successive halving: all trials start at "
                        "--min-steps, each rung keeps the best 1/3 with a "
                        "3x budget up to --trial-steps")
    p.add_argument("--vmap-trials", action="store_true",
                   help="train every trial at once as one vmapped program "
                        "(learning_rate/weight_decay only), the trial axis "
                        "sharded over --data-parallel processes; with "
                        "--halving survivors continue from their state")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="with --vmap-trials: shard the trial axis over this "
                        "many processes (num-trials must divide)")
    p.add_argument("--min-steps", type=int, default=10,
                   help="rung-0 step budget for --halving")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("test", help="test-split metric report")
    p.add_argument("--report-json", default=None, metavar="PATH",
                   help="also write the metric dict as JSON")
    _add_common_flags(p)
    p.add_argument("--test-batch", type=int, default=8)
    # the JAX package's cli test takes no layout: refused in one line
    for flag in ("--data-parallel", "--spatial-parallel"):
        p.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("serve", help="streaming batched inference over a "
                                     "split")
    _add_common_flags(p)
    p.add_argument("--out", default="served")
    p.add_argument("--serve-batch", type=int, default=8)
    p.add_argument("--limit", type=int, default=0,
                   help="stop after N frames (0 = all)")
    p.add_argument("--inflight", type=int, default=2,
                   help="batches kept queued on the device so the copy "
                        "back overlaps the next batch's compute")
    p.add_argument("--http-port", type=int, default=None,
                   help="serve the engine over HTTP on this port "
                        "(serving_http.py) instead of streaming the split")
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-batch-window-ms", type=float, default=3.0,
                   help="how long a batch waits for concurrent requests to "
                        "join it (0: serve each request alone)")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="shard each serving batch's frames over this many "
                        "ranks (one process each; --serve-batch must divide)")
    p.add_argument("--spatial-parallel", type=int, default=None,
                   help="shard each frame's rows over this many ranks (halo "
                        "rows, cross-rank GroupNorm sums; at most the "
                        "image's rows at /32, 13 at 416x800); combinable with "
                        "--data-parallel, rank = data x sp + sp index")
    _add_process_flags(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export",
                       help="export a checkpoint: reference-format .pth or "
                            "a self-contained serving artifact")
    _add_common_flags(p)
    p.add_argument("--out", required=True)
    p.add_argument("--format", choices=("pth", "artifact"), default="pth",
                   help="pth: the reference state dict; artifact: the "
                        "torch.export serving forward with its weights, "
                        "which test and serve take with no model code "
                        "(the deployment path of --tpu-decoder)")
    p.add_argument("--serve-batch", type=int, default=8,
                   help="batch size of an artifact")
    p.add_argument("--artifact-dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="weight dtype of an artifact; bfloat16 halves the "
                        "file and changes nothing on a bfloat16-compute "
                        "config (the default presets)")
    p.add_argument("--dynamic-batch", action="store_true",
                   help="export an artifact with a symbolic batch "
                        "dimension (serves any batch size) instead of "
                        "--serve-batch")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "validate-data",
        help="artifact-contract checker for a prepared dataset (catches "
             "the sorted-glob column shift, missing files, wrong shapes "
             "and dtypes)")
    p.add_argument("--split", default=None, help="(N,7) split .npy")
    p.add_argument("--data-dir", default=None,
                   help="prepared_data dir to glob instead of a split")
    p.add_argument("--image-dimension", default="416,800", metavar="H,W")
    p.add_argument("--limit", type=int, default=0,
                   help="check only the first N rows (0 = all)")
    p.add_argument("--no-decode", action="store_true",
                   help="skip the jpg decode (faster)")
    p.set_defaults(fn=cmd_validate_data)

    p = sub.add_parser("viz", help="prediction collages")
    _add_common_flags(p)
    p.add_argument("--out", default="viz_out")
    p.add_argument("--num-vis", type=int, default=25)
    p.add_argument("--test-batch", type=int, default=8)
    p.set_defaults(fn=cmd_viz)

    p = sub.add_parser(
        "summary",
        help="model summary: per-module params + analytic FLOPs/floor on "
             "the H100 (shapes only; no CUDA context)")
    _add_common_flags(p, device=False)
    p.add_argument("--summary-batch", type=int, default=8,
                   help="batch size for the FLOPs/floor analysis (cli "
                        "bench's batch)")
    p.add_argument("--project-scaling", choices=["weak", "strong"],
                   default=None,
                   help="also print the analytic data-parallel scaling "
                        "projection over NVLink (utils/scaling.py; a "
                        "projection, not a measurement)")
    p.add_argument("--step-time-ms", type=float, default=None,
                   help="measured single-card train-step ms to anchor "
                        f"--project-scaling (default {H100_STEP_MS}: the "
                        "bf16 step of base, batch 2 x 3, on an NVIDIA H100 "
                        "80GB HBM3 at 700 W)")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser(
        "inspect",
        help="summarize an artifact, .pth, run dir or split .npy as one "
             "JSON object, touching no device")
    p.add_argument("path")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser(
        "doctor",
        help="environment health report (bounded card probe, nvcc and the "
             "kernel build, native host library, optional modules)")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="seconds to wait for the card to answer before "
                        "declaring it unreachable")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("bench", help="headline throughput benchmark on the "
                                     "card (one JSON line)")
    p.add_argument("--train", action="store_true",
                   help="also time the train step (batch 6 padded to 8, "
                        "both remats)")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (UserError, ConfigError, NotImplementedError) as e:
        # ConfigError: a configuration the library refuses;
        # NotImplementedError: an option of a slice still to come, raised
        # by the library with its ROADMAP item
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
