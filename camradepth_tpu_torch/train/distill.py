"""Teacher -> student distillation: reference weights into the
``tpu_decoder`` variant.

Counterpart of ``camradepth_tpu/train/distill.py``. The ``tpu_decoder``
variant is not weight-compatible with reference checkpoints: only the
encoder and the low-resolution decoder carry over by shape. A user with
a trained reference ``.pth`` gets the variant by

1. a shape-matching warm start of the student from the teacher's weights
   (the subpixel stages keep their init), then
2. a short dense distillation: the student trains against the parity
   teacher's per-pixel predictions, mixed with the sparse lidar GT loss
   as ``alpha * distill + (1 - alpha) * multitask GT``.

Each microbatch is padded (``train.pad_microbatch_to``), decoded if it
came as a compact wire batch, and run through the teacher under
``torch.no_grad()`` in eval mode, then through the student. The GT terms
mask the padded rows themselves; the dense distill terms, which a padded
row would pollute, are weighted by a per-row valid mask. The teacher
holds its weights in the compute dtype, cast once (the same bits a cast at
each use gives), and its activations never enter autograd. The optimizer
step is :func:`train.step.train_step`'s, with this objective.

Under a multi-device layout the student is wrapped as the trainer's model
is, after its warm start; the teacher stays whole and unwrapped on every
rank (``camradepth_tpu/train/distill.py:311-320``) and runs on the rank's
rows. The distillation mean and the GT terms are the global batch's
(``train/losses.py``). Under sp teacher and student run on the rank's
rows of every image, the teacher sharded too; each per-sample mean over
the pixels is the sum over the sp group of the ranks' per-sample sums
over the whole image's pixel count (the ranks' rows are uneven), so every
rank holds the whole samples' terms.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from camradepth_tpu_torch.config import ExperimentConfig
from camradepth_tpu_torch.models.camradepth import create_model
from camradepth_tpu_torch.parallel import spatial
from camradepth_tpu_torch.parallel.mesh import batch_shard, row_shard, unwrap
from camradepth_tpu_torch.train.losses import masked_mean, multitask_loss
from camradepth_tpu_torch.train.step import (
    model_inputs,
    prepare_microbatch,
    train_step,
)
from camradepth_tpu_torch.train.trainer import Trainer
from camradepth_tpu_torch.utils import checkpoint as ckpt_util


def _per_sample_mean(v: torch.Tensor, shard=None) -> torch.Tensor:
    """The mean over all pixels of each sample of ``v`` [B, h, ...] -> [B];
    under an sp ``shard`` (``v`` this rank's rows) the sum over the group
    of the ranks' per-sample sums over the whole image's pixel count."""
    dims = tuple(range(1, v.ndim))
    if shard is None:
        return v.mean(dim=dims)
    return shard.sum_grad(v.sum(dim=dims)) / shard.global_count(
        v[0].numel())


def _per_sample_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                          beta: float = 1.0, shard=None) -> torch.Tensor:
    """Dense SmoothL1, the mean over all pixels of each sample -> [B]: the
    teacher's prediction is a target at every pixel."""
    diff = torch.abs(target - pred)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _per_sample_mean(loss, shard)


def _per_sample_kl(student_logits: torch.Tensor,
                   teacher_logits: torch.Tensor,
                   temperature: float, shard=None) -> torch.Tensor:
    """KL(teacher || student) over the class axis (last, NHWC) of the
    logits divided by ``temperature``, times T^2 (Hinton et al. 2015), the
    mean over pixels of each sample -> [B]; in fp32."""
    t = float(temperature)
    t_logits = teacher_logits.float() / t
    p_t = F.softmax(t_logits, dim=-1)
    log_t = F.log_softmax(t_logits, dim=-1)
    log_s = F.log_softmax(student_logits.float() / t, dim=-1)
    kl = torch.sum(p_t * (log_t - log_s), dim=-1) * (t * t)
    return _per_sample_mean(kl, shard)


def distill_terms(student_pred: Mapping, teacher_pred: Mapping,
                  cfg: ExperimentConfig, temperature: float = 1.0,
                  shard=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The per-sample distillation objective [B] and its scalar terms
    (``camradepth_tpu/train/distill.py:86-129``). The heads are weighted
    as in the GT multitask loss (``train.loss_weights``, normalized by
    their sum): the depth heads by dense SmoothL1, the seg heads by the
    temperature-scaled KL, zero where either side has no such head. The
    argmax ``unsup_map`` is not distilled. Under an sp ``shard`` the
    predictions are this rank's rows, and every term is the whole
    image's."""
    w = cfg.train.loss_weights
    s_d, t_d = student_pred["depth"], teacher_pred["depth"]
    l_final = _per_sample_smooth_l1(s_d["final_depth"][..., 0],
                                    t_d["final_depth"][..., 0], shard=shard)
    l_d4 = _per_sample_smooth_l1(s_d["intermediate_depths"][3][..., 0],
                                 t_d["intermediate_depths"][3][..., 0],
                                 shard=shard)
    l_d3 = _per_sample_smooth_l1(s_d["intermediate_depths"][2][..., 0],
                                 t_d["intermediate_depths"][2][..., 0],
                                 shard=shard)
    zeros = torch.zeros_like(l_final)
    s_seg, t_seg = student_pred["seg"], teacher_pred["seg"]

    def kl(key):
        if s_seg[key] is None or t_seg[key] is None:
            return zeros
        return _per_sample_kl(s_seg[key], t_seg[key], temperature, shard)

    l_seg, l_seg_i = kl("final_seg"), kl("intermediate_seg")
    total = (w[0] * l_final + w[1] * l_d4 + w[2] * l_d3 + w[3] * l_seg
             + w[4] * l_seg_i) / sum(w)
    terms = {
        "distill_depth_final": l_final.mean(),
        "distill_depth_stage4": l_d4.mean(),
        "distill_depth_stage3": l_d3.mean(),
        "distill_seg_final": l_seg.mean(),
        "distill_seg_inter": l_seg_i.mean(),
    }
    return total, terms


def distill_loss(cfg: ExperimentConfig, model, micro: Dict,
                 generator: Optional[torch.Generator], *, teacher,
                 alpha: float, temperature: float):
    """(loss, metrics) of one distillation microbatch: the microbatch loss
    that ``train_step`` takes as ``loss_fn`` (``camradepth_tpu/train/
    distill.py:146-210``)."""
    orig_b = (micro["features"] if "features" in micro
              else micro["image_u8"]).shape[0]
    # teacher and student both read the padded, decoded features
    micro = prepare_microbatch(cfg, micro)
    x, gt, gt_shard = model_inputs(model, micro)
    b = x.shape[0]
    valid = (torch.arange(b, device=x.device) < orig_b).float()
    rows = row_shard(model)
    unwrap(model).set_generator(generator)
    with spatial.sharded(rows):
        with torch.no_grad():
            teacher_pred = teacher(x)
        pred = model(x)
    per_sample, terms = distill_terms(pred, teacher_pred, cfg, temperature,
                                      rows)
    del teacher_pred
    shard = batch_shard(model)
    if shard is not None:
        # each term is a mean over this rank's rows, as many on every rank
        terms = {k: shard.sum(v) / shard.count for k, v in terms.items()}
    # under sp every rank holds the whole samples' terms: no shard here
    l_distill = masked_mean(per_sample, valid, shard)
    l_gt, gt_metrics = multitask_loss(pred, gt, cfg, gt_shard)
    total = alpha * l_distill + (1.0 - alpha) * l_gt
    metrics = {"loss": total, "loss_distill": l_distill, "loss_gt": l_gt,
               "rmse_m": gt_metrics["rmse_m"], **terms}
    return total, metrics


def check_pairing(cfg: ExperimentConfig, teacher_cfg: ExperimentConfig,
                  alpha: float) -> None:
    """The checks of ``camradepth_tpu/train/distill.py:253-278``: alpha in
    [0, 1]; teacher and student share the input size and channels and the
    seg heads (a seg mismatch would zero the seg KL terms silently)."""
    if not 0.0 <= float(alpha) <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    t, s = teacher_cfg.model, cfg.model
    if tuple(t.img_size) != tuple(s.img_size):
        raise ValueError("teacher and student must share img_size "
                         f"({t.img_size} vs {s.img_size})")
    if t.input_channels != s.input_channels:
        raise ValueError("teacher and student must share input_channels "
                         f"({t.input_channels} vs {s.input_channels})")
    for f in ("supervised_seg", "unsupervised_seg", "num_classes"):
        tv, sv = getattr(t, f), getattr(s, f)
        if tv != sv:
            raise ValueError(
                f"teacher and student must share model.{f} ({tv} vs {sv})"
                " - a mismatch drops the seg distillation terms silently")


class DistillTrainer(Trainer):
    """A Trainer whose objective distills a frozen teacher into the
    (usually ``tpu_decoder``) student (``camradepth_tpu/train/distill.py:
    231-309``). ``teacher_state`` is the teacher's fp32 state_dict in the
    port's layout, complete for ``teacher_cfg.model``. Validation stays
    GT-based: the val loss and RMSE measure the student against lidar, so
    best-checkpoint selection and early stopping mean what they mean in a
    normal run."""

    def __init__(self, cfg: ExperimentConfig, teacher_cfg: ExperimentConfig,
                 teacher_state: Mapping[str, torch.Tensor],
                 alpha: float = 0.5, temperature: float = 1.0,
                 init_from_teacher: bool = True, **kwargs):
        check_pairing(cfg, teacher_cfg, alpha)
        self._alpha = float(alpha)
        self._temperature = float(temperature)
        self._teacher_cfg = teacher_cfg
        self._teacher_state = teacher_state
        self._init_from_teacher = init_from_teacher
        super().__init__(cfg, **kwargs)

    def _prepare_model(self, restored: bool) -> None:
        """The frozen teacher, and the student's warm start from it, before
        the student is wrapped."""
        self.teacher = create_model(self._teacher_cfg.model,
                                    device=self.device,
                                    state_dict=self._teacher_state)
        for p in self.teacher.parameters():
            p.requires_grad_(False)
        # a restored state keeps its parameters: they belong with the
        # restored optimizer moments (an auto-resume, or a --checkpoint)
        if self._init_from_teacher and restored:
            self._say("#### teacher warm start SKIPPED: a checkpoint was "
                      "restored (resume takes precedence)")
        if self._init_from_teacher and not restored:
            # from the fp32 weights, not the teacher's compute-dtype copy
            done = ckpt_util.partial_restore(dict(self._teacher_state),
                                             self.model, verbose=False)
            self._say(f"#### teacher warm start: {len(done.transferred)}/"
                      f"{done.total} param tensors transferred")
        self._teacher_state = None  # the caller's; the teacher holds a copy

    def _train_step(self, micro, gens, lr):
        loss_fn = functools.partial(distill_loss, teacher=self.teacher,
                                    alpha=self._alpha,
                                    temperature=self._temperature)
        return train_step(self.cfg, self.model, self.optimizer, micro, gens,
                          lr, loss_fn=loss_fn)
