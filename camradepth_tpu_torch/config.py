"""Configuration for the PyTorch/CUDA port of CamRaDepth.

The package's own copy of the parts of ``camradepth_tpu/config.py`` that
serving, training, the data pipeline and the CLI read:
:class:`ModelConfig`, :class:`DataConfig`, :class:`TrainConfig`,
:class:`ExperimentConfig`, :func:`preset`, :func:`apply_overrides`
(``--set``), :func:`num_epochs_for_steps` and :func:`tiny_test_config`,
and :class:`MeshConfig`, the layout of multi-device training
(``parallel/mesh.py``). Field names and defaults are those of the JAX
package, so one set of keyword arguments builds both configs and a JAX
config maps onto this one field for field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Optional, Tuple

# ImageNet normalization constants. The reference normalizes cv2's BGR
# image with these RGB-ordered statistics; the quirk is kept for weight
# compatibility (data/channels.py).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ConfigError(ValueError):
    """A configuration the port refuses (a bad value or an unsupported
    combination found at construction time); the CLI prints it as one
    line and exits 2, as it does its own user errors."""


MODEL_VARIANTS = (
    "base (rgb)",
    "base",
    "supervised_seg",
    "unsupervised_seg",
    "sup_unsup_seg",
    "sup_unsup_seg (rgb)",
)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (reference CamRaDepth.py:20-57)."""

    img_size: Tuple[int, int] = (416, 800)
    dims: Tuple[int, int, int, int] = (64, 128, 160, 256)
    heads: Tuple[int, int, int, int] = (1, 2, 4, 8)
    ff_expansion: Tuple[int, int, int, int] = (8, 8, 4, 4)
    sr_ratios: Tuple[int, int, int, int] = (8, 4, 2, 1)
    depths: Tuple[int, int, int, int] = (3, 10, 16, 5)
    mid_channels: int = 128
    input_channels: int = 7
    num_classes: int = 21
    unsup_classes: int = 19
    supervised_seg: bool = False
    unsupervised_seg: bool = False
    groupnorm_divisor: int = 16
    drop_path_rate: float = 0.1
    dropout_rate: float = 0.2  # Dropout2d in the decoder (CamRaDepth.py:96)
    qkv_bias: bool = True
    # Compute dtype of the forward pass ("bfloat16" or "float32"). GroupNorm
    # affines and statistics stay float32.
    compute_dtype: str = "bfloat16"
    # The two ``use_pallas_*`` switches select TPU kernels in the JAX
    # package. The port has one implementation per device (the Hopper
    # kernel on a CUDA tensor, the plain PyTorch version on a CPU tensor),
    # so it ignores them; they stay only so that a JAX config maps onto
    # this one field for field.
    use_pallas_attention: bool = False
    use_pallas_resize: bool = False
    # Recompute in the backward pass (torch.utils.checkpoint): every decoder
    # stage, every encoder block, or the decoder stages up to quarter
    # resolution (camradepth_tpu/config.py:87-96).
    remat_decoder: bool = False
    remat_encoder: bool = False
    remat_decoder_small: bool = False
    # The documented architecture variant whose half- and full-resolution
    # decoder stages and final depth head convolve at their input
    # resolution and upsample by depth-to-space (``--tpu-decoder``); not
    # weight-compatible with reference checkpoints.
    tpu_decoder: bool = False

    def __post_init__(self):
        for name in ("dims", "heads", "ff_expansion", "sr_ratios", "depths"):
            v = getattr(self, name)
            if len(v) != 4:
                raise ValueError(f"{name} must have 4 stages, got {v}")
        if self.input_channels <= 0:
            raise ValueError("input_channels must be > 0")
        for d in self.dims:
            if d % self.groupnorm_divisor:
                raise ValueError(
                    f"dims must be divisible by groupnorm_divisor, got {d}"
                )

    @property
    def stage_strides(self) -> Tuple[int, int, int, int]:
        return (4, 8, 16, 32)

    def feature_shape(self, stage: int) -> Tuple[int, int]:
        s = self.stage_strides[stage]
        return (self.img_size[0] // s, self.img_size[1] // s)


@dataclass(frozen=True)
class DataConfig:
    """Input-pipeline options (reference args.py:14-22, 190-198)."""

    split_path: str = "original_split.npy"
    image_dimension: Tuple[int, int] = (416, 800)
    max_depth: float = 100.0
    # Evaluation caps in inverse space (args.py:15, runner.py:451-492).
    max_distances: Tuple[float, ...] = (100.0, 50.0)
    train_val_split: Tuple[int, int] = (17902, 2237)
    mini_dataset: bool = False
    num_workers: int = 8
    prefetch: int = 2
    # Channel-assembly flags (args.py:190-198 defaults).
    sparse_lidar: bool = False
    filtered_radar: bool = False
    lidar_ratio: Tuple[float, float] = (0.75, 0.25)
    sparse_depth_uv: bool = True
    im_uv: bool = False
    rad_vel: bool = True
    # Assemble and wire-encode frames with the C++ host code (native.py,
    # built with g++ at first use): bit for bit with numpy, and outside the
    # interpreter lock, so the loader's threads run in parallel. A frame it
    # does not cover (sparse_lidar, fp16 sources) takes numpy; a failed
    # build raises. False assembles every frame with numpy.
    native_assemble: bool = True
    # The compact wire format (data/wire.py): the loaders ship the uint8
    # image and the radar and GT points, decoded on the device into the
    # dense feature stack, bit for bit. "auto" takes it where the codec
    # covers the channel config and falls back to dense batches; "on"
    # raises there; "off" keeps the dense path everywhere.
    wire_format: str = "off"
    wire_radar_cap: int = 0  # points per frame; 0 = probe the dataset
    wire_gt_cap: int = 0  # points per frame; 0 = probe (dense if larger)
    # Ship the seg label planes. batch["seg"] feeds only the supervised
    # seg loss and the IoU, batch["seg_inter"] only train.seg_inter_loss
    # on top of it; data/wire.resolve_wire_ship narrows both to what a
    # config reads (and refuses an explicit False that a config needs).
    wire_ship_seg: bool = True
    wire_ship_seg_inter: bool = True

    def __post_init__(self):
        if self.wire_format not in ("off", "auto", "on"):
            raise ConfigError(
                f"data.wire_format must be off|auto|on, got "
                f"{self.wire_format!r}")

    @property
    def effective_train_val_split(self) -> Tuple[int, int]:
        return (0, 0) if self.mini_dataset else self.train_val_split

    @property
    def num_samples(self) -> int:
        return sum(self.effective_train_val_split)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization settings of single-device training (reference
    args.py:29-42, 105-122; ``camradepth_tpu/config.py:197-274``)."""

    batch_size: int = 2
    desired_batch_size: int = 6
    learning_rate: float = 6e-5
    div_factor: float = 2.0
    final_div_factor: float = 1e4
    pct_start: float = 0.15
    num_epochs: int = 30
    num_steps: Optional[int] = 60_000
    early_stopping_thresh: int = 6
    stop_after: Optional[int] = None
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    # Deep-supervision loss weights [final, stage4, stage3, seg_final,
    # seg_inter] (runner.py:213-215). The reference model returns no
    # intermediate seg, so the last weight only inflates the denominator.
    loss_weights: Tuple[float, float, float, float, float] = (1, 1, 1, 0.2,
                                                               0.2)
    seg_inter_loss: bool = False
    # Pad each training microbatch with dummy samples up to this size; the
    # dummies are no-ops for every masked loss term.
    pad_microbatch_to: Optional[int] = None
    seed: int = 0
    checkpoint: Optional[str] = None
    load_ckpt: bool = False
    save_model: bool = False
    # write best-val checkpoints on a background thread
    async_checkpoint: bool = False
    # SIGTERM during train() saves a full checkpoint at the next
    # optimizer-step boundary; auto-resume continues from it
    graceful_preemption: bool = True
    # dtype of batch["features"] on its way to the device: "auto" ships
    # bf16 when the model computes in bf16 (its first op casts the input,
    # so this is exact) and fp32 otherwise
    transfer_dtype: str = "auto"  # auto | float32 | bfloat16
    # microbatch stacks assembled and copied ahead on a worker thread
    prefetch_batches: int = 2
    output_dir: str = "Output"
    arch_name: str = "Transformer"
    run_name: str = "current"
    log_every: int = 50

    def __post_init__(self):
        if self.desired_batch_size % self.batch_size:
            raise ValueError(
                "desired_batch_size must be a multiple of batch_size"
            )

    @property
    def update_interval(self) -> int:
        """Gradient-accumulation factor (args.py:132)."""
        return self.desired_batch_size // self.batch_size


@dataclass(frozen=True)
class MeshConfig:
    """The layout of multi-device training (``camradepth_tpu/config.py:
    276-289``): the global batch shards jointly over ``data`` x ``fsdp``
    ranks, parameters and optimizer state over ``fsdp`` (FSDP2), replicated
    over ``data`` (DDP when ``fsdp`` is 1). ``data_parallel = -1`` sizes the
    data axis from the world size and the batch (``parallel/mesh.py``).
    ``spatial_parallel`` is taken as the JAX package takes it: training
    shards each image's rows over sp = 2 ranks alone, with the JAX
    package's refusals of the rest (``parallel/mesh.training_layout``);
    serving on a mesh takes its layout from ``cli serve``'s flags
    (``parallel/mesh.serving_layout``)."""

    data_axis: str = "data"
    fsdp_axis: str = "fsdp"
    sp_axis: str = "sp"
    data_parallel: int = -1
    fsdp_parallel: int = 1
    spatial_parallel: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    name: str = "base"

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _variant_flags(model_name: str) -> Tuple[bool, bool, int]:
    """Map a reference model-variant string to (supervised_seg,
    unsupervised_seg, input_channels) — args.py:156-167."""
    if model_name not in MODEL_VARIANTS:
        raise ValueError(f"Model type invalid: {model_name}")
    sup = model_name in ("sup_unsup_seg", "sup_unsup_seg (rgb)", "supervised_seg")
    unsup = model_name in ("sup_unsup_seg", "sup_unsup_seg (rgb)", "unsupervised_seg")
    rgb_only = model_name in ("base (rgb)", "sup_unsup_seg (rgb)")
    input_channels = 3 if rgb_only else 7
    return sup, unsup, input_channels


# The six published experiment presets (args.py:85-122).
_PRESET_NAMES: Mapping[str, str] = {
    "base_rgb": "base (rgb)",
    "base": "base",
    "supervised_seg": "supervised_seg",
    "unsupervised_seg": "unsupervised_seg",
    "sup_unsup_seg": "sup_unsup_seg",
    "sup_unsup_seg_rgb": "sup_unsup_seg (rgb)",
}


def preset(name: str, **overrides) -> ExperimentConfig:
    """Build one of the six published experiment configurations."""
    if name not in _PRESET_NAMES:
        raise ValueError(
            f"Unknown preset {name!r}; choose from {sorted(_PRESET_NAMES)}"
        )
    sup, unsup, in_ch = _variant_flags(_PRESET_NAMES[name])
    model = ModelConfig(
        supervised_seg=sup,
        unsupervised_seg=unsup,
        input_channels=in_ch,
    )
    cfg = ExperimentConfig(model=model, name=name)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def _coerce_override(raw: str, current):
    """Parse an override string against the current field value's type,
    as ``camradepth_tpu/config.py:353-399`` does for the types the port's
    config holds: none/null clears an optional field; bools take
    1/0/true/false/yes/no/on/off; numeric tuples take comma lists (ints
    stay ints unless the value needs a float)."""
    s = raw.strip()
    if s.lower() in ("none", "null"):
        return None  # clears an Optional field (train.num_steps, ...)
    if isinstance(current, bool):
        low = s.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"expected a boolean, got {raw!r}")
    if isinstance(current, int):
        return int(s)
    if isinstance(current, float):
        return float(s)
    if current is None:
        # an Optional field at None: a number if the value reads as one
        # (train.pad_microbatch_to), else the string (train.checkpoint)
        try:
            f = float(s)
            return int(f) if f == int(f) and "." not in s else f
        except ValueError:
            return s
    if isinstance(current, tuple):
        parts = [p.strip() for p in s.strip("()").split(",") if p.strip()]
        ref = list(current) + [current[-1]] * (len(parts) - len(current))
        out = []
        for p, r in zip(parts, ref):
            f = float(p)
            out.append(int(f) if isinstance(r, int) and f == int(f) else f)
        return tuple(out)
    return s


def apply_overrides(cfg: ExperimentConfig, pairs) -> ExperimentConfig:
    """Dotted ``section.field=value`` overrides, as the JAX package's
    ``apply_overrides`` (``camradepth_tpu/config.py:402-445``): sections
    ``model``, ``data``, ``train`` and ``mesh``, plus the top-level
    ``name``. Values are coerced against the current field's type and
    ``__post_init__`` checks re-run."""
    sections = ("model", "data", "train", "mesh")
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(
                f"--set expects section.field=value, got {pair!r}"
            )
        path, _, raw = pair.partition("=")
        path = path.strip()
        if "." not in path:
            if path != "name":
                raise ValueError(
                    f"--set path {path!r} must be section.field with "
                    f"section in {sections} (or 'name')"
                )
            cfg = cfg.replace(name=raw.strip())
            continue
        section, _, fname = path.partition(".")
        if section not in sections:
            raise ValueError(
                f"unknown config section {section!r}; choose from "
                f"{sections}"
            )
        sub = getattr(cfg, section)
        valid = {f.name for f in dataclasses.fields(sub)}
        if fname not in valid:
            raise ValueError(
                f"unknown field {section}.{fname}; available: "
                f"{sorted(valid)}"
            )
        value = _coerce_override(raw, getattr(sub, fname))
        cfg = cfg.replace(
            **{section: dataclasses.replace(sub, **{fname: value})}
        )
    return cfg


def num_epochs_for_steps(cfg: ExperimentConfig) -> int:
    """Auto-derived epoch count when training is step-budgeted
    (args.py:141-143; ``camradepth_tpu/config.py:448-456``)."""
    if cfg.train.num_steps is None:
        return cfg.train.num_epochs
    train_n = cfg.data.effective_train_val_split[0]
    if train_n <= 0:
        return cfg.train.num_epochs
    return max(1, cfg.train.num_steps * cfg.train.batch_size // train_n)


def tiny_test_config(**overrides) -> ExperimentConfig:
    """A miniature config for unit tests (``camradepth_tpu/config.py:
    459-481``)."""
    model = ModelConfig(
        img_size=(64, 128),
        dims=(16, 32, 32, 64),
        heads=(1, 2, 4, 8),
        ff_expansion=(2, 2, 2, 2),
        sr_ratios=(8, 4, 2, 1),
        depths=(1, 1, 1, 1),
        mid_channels=32,
        input_channels=7,
        groupnorm_divisor=16,
        drop_path_rate=0.0,
        compute_dtype="float32",
        use_pallas_attention=False,
    )
    train = TrainConfig(batch_size=2, desired_batch_size=4, num_steps=None,
                        num_epochs=1)
    data = DataConfig(image_dimension=(64, 128), train_val_split=(4, 2))
    cfg = ExperimentConfig(model=model, data=data, train=train, name="tiny")
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
