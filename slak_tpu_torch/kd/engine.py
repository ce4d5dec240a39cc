"""Knowledge-distillation engine: port of ``slak_tpu/kd/engine.py`` (the
reference's ``engine_kd.train_one_epoch``, engine_kd.py:86-277, and the
``main_KD.py`` wiring).

One call of the step from :func:`make_kd_train_step`:
  1. writes this iteration's lr and weight decay into the student's
     optimizer and the KD heads' (``kd_params``: the FD projection, the MGD
     generator; their own AdamW, same lr and wd);
  2. runs the frozen teacher on the images (``teacher_apply``: eval, no
     graph, every teacher parameter ``requires_grad=False``), then the
     student's train forward (``forward_features(return_stages=True)``,
     the mean pool, LN and head; stage 4 is the FD / MGD feature) and the
     loss of ``distill_type`` (None / KD / NKD / FD / FD+KD / FD+NKD /
     MGD), one micro-batch as the JAX step runs, and its backward; under
     data parallel (a process ``group``) the batch is this rank's shard,
     the teacher runs on the shard, drop-path and MGD-mask draws are the
     global batch's, and the student's and the heads' gradients and the
     loss are averaged over the group in the coalesced all-reduce;
  3. clips and steps the student (its global gradient norm is the metric
     ``grad_norm``) and, apart, the heads on their own norm;
  4. masks, prunes and regrows the student's weights (DST reads the
     student's Adam moments) and updates its EMA, as the train step does
     (``train/engine.py`` ``masks_and_ema``).

A teacher is frozen by :func:`freeze`; ``teacher_apply(images, plain)``
takes NHWC images in the compute dtype and returns float32 logits and the
final-stage feature (N, H, W, C). :func:`make_teacher_apply` makes it for a
SLaK / ConvNeXt teacher (its eval route: the kernels on the card);
the zoo's teachers (``models/vit.py``, ``swin.py``, ``cswin.py``,
``resnet.py``, ``mobile.py``) have a ``teacher_apply`` method.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from slak_tpu_torch.kd import losses as KL
from slak_tpu_torch.models.layers import global_batch_shard
from slak_tpu_torch.parallel.mesh import all_reduce_
from slak_tpu_torch.sparsity.masking import MaskConfig
from slak_tpu_torch.train.engine import (TrainConfig, TrainState, _loss,
                                         masks_and_ema, optimizer_step)
from slak_tpu_torch.train.optim import make_adamw, param_groups, set_lr_wd

DISTILL_TYPES = ("None", "KD", "NKD", "FD", "FD+KD", "FD+NKD", "MGD")

TeacherApply = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class KDConfig:
    distill_type: str = "NKD"     # one of DISTILL_TYPES
    temp: float = 1.0             # KD temperature (main_KD flag --T)
    hard: bool = False
    alpha: float = 0.1            # vanilla-KD mixing weight
    nkd_temp: float = 1.0
    nkd_alpha: float = 1.0
    fd_loss_type: str = "smoothL1"  # --FDLoss_type
    lr_fd: float = 1.0              # FD loss weight (--lr_fd)
    mgd: KL.MGDConfig = KL.MGDConfig()

    def __post_init__(self):
        if self.distill_type not in DISTILL_TYPES:
            raise ValueError(f"distill_type {self.distill_type!r}: one of "
                             f"{'/'.join(DISTILL_TYPES)}")


def init_kd_params(generator: Optional[torch.Generator], kd_cfg: KDConfig,
                   student_channels: int, teacher_channels: int,
                   device=None) -> nn.ModuleDict:
    """The trainable KD heads: ``fd_proj`` (a 1x1 conv, student to teacher
    channels) for FD where the channels differ, ``mgd`` for MGD; drawn on
    the CPU from ``generator``, then moved to ``device``."""
    p = nn.ModuleDict()
    dt = kd_cfg.distill_type
    if "FD" in dt and student_channels != teacher_channels:
        p["fd_proj"] = KL.he_conv(student_channels, teacher_channels, 1,
                                  generator)
    if dt == "MGD":
        p["mgd"] = KL.mgd_init(generator, student_channels, teacher_channels)
    return p.to(device)


def kd_opt_init(kd_params: nn.ModuleDict) -> Optional[torch.optim.AdamW]:
    """AdamW over the heads (weight decay off for biases), or None when
    there are none."""
    named = list(kd_params.named_parameters())
    return make_adamw(param_groups(named)) if named else None


def freeze(module: nn.Module) -> nn.Module:
    """Eval mode, and no parameter requires a gradient: the teacher's
    forward then records no graph and launches no backward kernel."""
    module.eval()
    module.requires_grad_(False)
    return module


def make_teacher_apply(teacher_model) -> TeacherApply:
    """A SLaK / ConvNeXt teacher, frozen: ``teacher_apply(images, plain=
    False) -> (logits, feature)``, NHWC images in the compute dtype, the
    stage-4 feature as (N, H, W, C); ``plain`` runs the kernels' plain
    versions."""
    freeze(teacher_model)

    @torch.no_grad()
    def teacher_apply(images, plain: bool = False):
        teacher_model.eval()
        x = images.permute(0, 3, 1, 2).contiguous()
        feat = teacher_model.forward_features(x, plain,
                                              return_stages=True)[-1]
        return teacher_model.stage4_logits(feat), feat.permute(0, 2, 3, 1)

    return teacher_apply


def make_kd_train_step(student_model, teacher_apply: TeacherApply,
                       kd_cfg: KDConfig, train_cfg: TrainConfig,
                       mask_cfg: Optional[MaskConfig],
                       lr_schedule: np.ndarray,
                       wd_schedule: Optional[np.ndarray] = None,
                       plain: bool = False, group=None):
    """Returns ``train_step(state, kd_params, kd_opt, (images, targets),
    generator=None) -> (state, kd_params, kd_opt, metrics)``: ``state`` the
    student's (``train.engine.create_train_state``), ``kd_params`` from
    :func:`init_kd_params`, ``kd_opt`` from :func:`kd_opt_init`; images
    NHWC; targets int labels or soft (N, classes) ones. ``generator``
    draws the drop-path masks and MGD's channel mask. ``plain`` runs the
    kernels' plain versions, the teacher's too. ``group``: a process group
    over which the batch is sharded (each rank passes its shard, in rank
    order, and the same generator state). The optimizer is AdamW, as in
    the JAX step; ``update_freq`` is not split (one micro-batch)."""
    if train_cfg.opt != "adamw":
        raise ValueError("the distillation step's optimizer is AdamW")
    dt = kd_cfg.distill_type
    dtype = train_cfg.compute_dtype
    growth_reads_grads = mask_cfg is not None and mask_cfg.growth_mode in (
        "gradient", "mix")

    def loss_fn(model, kd_params, images, targets, logits_t, feat_t,
                generator):
        feat = model.forward_features(images.permute(0, 3, 1, 2)
                                      .contiguous(), plain, generator,
                                      return_stages=True)[-1]
        logits = model.stage4_logits(feat)
        feat_s = feat.permute(0, 2, 3, 1)

        def ce():
            return _loss(logits, targets, train_cfg.smoothing)

        def nkd():
            return KL.nkd_loss(logits, logits_t, targets, kd_cfg.nkd_temp,
                               kd_cfg.nkd_alpha)

        def kd():
            return KL.kd_loss(logits, targets, logits_t, kd_cfg.temp,
                              kd_cfg.hard, kd_cfg.alpha)

        if dt == "None":
            return ce()
        if dt == "KD":
            return kd()
        if dt == "NKD":
            return nkd()
        if dt.startswith("FD"):
            fs = feat_s
            if "fd_proj" in kd_params:
                fs = KL.conv_same(feat, kd_params["fd_proj"]).permute(
                    0, 2, 3, 1)
            loss_dis = KL.fd_loss(fs, feat_t, kd_cfg.fd_loss_type)
            base = nkd() if "NKD" in dt else kd() if "KD" in dt else ce()
            return base + loss_dis * kd_cfg.lr_fd
        return ce() + KL.mgd_loss(generator, kd_params["mgd"], feat_s,
                                  feat_t, kd_cfg.mgd)

    def train_step(state: TrainState, kd_params: nn.ModuleDict,
                   kd_opt: Optional[torch.optim.Optimizer], batch,
                   generator: Optional[torch.Generator] = None):
        images, targets = batch
        model = state.model
        model.train()
        dev = next(model.parameters()).device
        images = images.to(device=dev, dtype=dtype)
        targets = targets.to(dev)
        it = state.step
        lr = float(lr_schedule[min(it, len(lr_schedule) - 1)])
        wd = train_cfg.weight_decay if wd_schedule is None else \
            float(wd_schedule[min(it, len(wd_schedule) - 1)])
        opts = [state.optimizer] + ([kd_opt] if kd_opt is not None else [])
        for opt in opts:
            set_lr_wd(opt, lr, wd)
            opt.zero_grad(set_to_none=True)

        logits_t, feat_t = teacher_apply(images, plain)
        shard = (0, 1) if group is None else (dist.get_rank(group),
                                              dist.get_world_size(group))
        with global_batch_shard(*shard):
            loss = loss_fn(model, kd_params, images, targets, logits_t,
                           feat_t, generator)
            loss.backward()
        loss = loss.detach().clone()

        named = state.named_params()
        kd_named = dict(kd_params.named_parameters())
        if group is not None:
            all_reduce_([p.grad for p in list(named.values())
                         + list(kd_named.values()) if p.grad is not None]
                        + [loss], "mean", group)
        gnorm, raw_grads = optimizer_step(state.optimizer, named,
                                          train_cfg.clip_grad,
                                          growth_reads_grads)
        if kd_opt is not None:
            optimizer_step(kd_opt, kd_named, train_cfg.clip_grad)
        masks_and_ema(state, named, mask_cfg, train_cfg, raw_grads)
        metrics = {"loss": loss, "lr": torch.tensor(lr), "grad_norm": gnorm,
                   "weight_decay": torch.tensor(wd)}
        return state, kd_params, kd_opt, metrics

    return train_step
