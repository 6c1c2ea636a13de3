"""The distillation trainer's warm start and argument checks, on the CPU
(beside tests/test_torch_distill.py, whose JAX step they do not
need; a file of 8 or fewer tests queues behind the suite's longest file
under ``--dist loadfile``): no restored tensor of the student shares
storage with the teacher's, which is frozen in eval mode; DistillTrainer
refuses a bad alpha and a teacher of another geometry or head set.
"""

import dataclasses

import pytest
import torch

from camradepth_tpu_torch.train import distill
from camradepth_tpu_torch.utils import checkpoint as ckpt_util
from tests.test_torch_distill_cli import (  # noqa: F401
    _trainer_cfgs,
    corpus,
    no_tensorboard,
)
from tests.torch_port import one_torch_thread  # noqa: F401


def test_warm_start_shares_no_storage_with_the_teacher(corpus, tmp_path,
                                                       capsys):
    split, _, path = corpus
    cfg, teacher_cfg = _trainer_cfgs(split)
    state = ckpt_util.restore_checkpoint(path)["state_dict"]
    tr = distill.DistillTrainer(cfg, teacher_cfg, state,
                                run_dir=str(tmp_path / "run"), device="cpu")
    assert "#### teacher warm start: 155/177 param tensors transferred" in (
        capsys.readouterr().out)
    student = {k: v for k, v in tr.model.state_dict().items()}
    shared = {v.untyped_storage().data_ptr() for v in state.values()} | {
        p.untyped_storage().data_ptr() for p in tr.teacher.parameters()}
    moved = [k for k, v in student.items()
             if k in state and v.shape == state[k].shape]
    assert len(moved) == 155
    assert all(torch.equal(student[k], state[k]) for k in moved)
    assert not any(v.untyped_storage().data_ptr() in shared
                   for v in student.values())
    # the teacher is frozen in eval mode and holds its weights once
    assert not tr.teacher.training
    assert not any(p.requires_grad for p in tr.teacher.parameters())


@pytest.mark.parametrize("change,match", [
    ({"alpha": 1.5}, "alpha"),
    ({"alpha": -0.1}, "alpha"),
    ({"img_size": (64, 128)}, "img_size"),
    ({"input_channels": 3}, "input_channels"),
    ({"supervised_seg": True}, "supervised_seg"),
])
def test_distill_trainer_checks_its_arguments(change, match):
    cfg, teacher_cfg = _trainer_cfgs("unused.npy")
    change = dict(change)
    alpha = change.pop("alpha", 0.5)
    teacher_cfg = teacher_cfg.replace(model=dataclasses.replace(
        teacher_cfg.model, **change))
    with pytest.raises(ValueError, match=match):
        distill.DistillTrainer(cfg, teacher_cfg, {}, alpha=alpha,
                               loaders={}, device="cpu")
