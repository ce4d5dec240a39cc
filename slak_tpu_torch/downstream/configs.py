"""Downstream-transfer recipes: port of ``slak_tpu/downstream/configs.py``
(typed equivalents of the reference's mmseg / mmdet config files,
``segmentation/configs/*.py``, ``detection/configs/*.py``), built on the
port's :class:`~slak_tpu_torch.models.slak.SLaKConfig`.

Numbers from the reference configs:
  * ADE20K UperNet: crop 512^2, AdamW lr 2e-4 (80k, T) / 6e-5 (160k), wd
    0.05, poly power 1.0, linear warmup, no decay for norms and biases
    (``upernet_slak_tiny_512_80k_ade20k_ss.py:47-58``).
  * COCO Cascade Mask R-CNN: 3x schedule, GIoU, 4conv1fc heads, layer
    decay 0.7, backbone sparse + width 1.3
    (``cascade_mask_rcnn_slak_tiny_...3x_coco_in1k.py:15-27,135-141``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from slak_tpu_torch.downstream.segmentation import UperNetConfig
from slak_tpu_torch.models.backbone import BackboneConfig
from slak_tpu_torch.models.slak import SLaKConfig


@dataclasses.dataclass(frozen=True)
class SegRecipe:
    backbone: BackboneConfig
    head: UperNetConfig
    crop_size: int = 512
    lr: float = 2e-4
    weight_decay: float = 0.05
    betas: Tuple[float, float] = (0.9, 0.999)
    max_iters: int = 80_000
    warmup_iters: int = 800
    warmup_ratio: float = 1e-6
    poly_power: float = 1.0
    min_lr: float = 0.0
    batch_size: int = 32          # global (ref: 8/GPU x 4 GPUs)
    eval_stride: int = 341        # slide-mode test stride
    num_classes: int = 150


@dataclasses.dataclass(frozen=True)
class DetRecipe:
    backbone: BackboneConfig
    lr: float = 1e-4
    weight_decay: float = 0.05
    layer_decay: float = 0.7
    layer_decay_num_layers: int = 6
    epochs: int = 36              # 3x schedule
    ms_train_range: Tuple[int, int] = (480, 800)
    giou: bool = True
    heads: str = "4conv1fc"
    num_classes: int = 80


def _slak_backbone(depths, dims, drop_path, sparse=True) -> BackboneConfig:
    return BackboneConfig(
        model=SLaKConfig(
            depths=depths, dims=dims, kernel_size=(51, 49, 47, 13, 5),
            decom=True, branch_bn=True, width_factor=1.3,
            drop_path_rate=drop_path,
            layer_scale_init_value=1.0),  # ref seg config: 1.0
        out_indices=(0, 1, 2, 3),
        sparse=sparse)


def poly_schedule(base_lr: float, max_iters: int, warmup_iters: int,
                  warmup_ratio: float, power: float = 1.0,
                  min_lr: float = 0.0) -> np.ndarray:
    """mmseg poly LR with linear warmup, as a per-iteration array."""
    it = np.arange(max_iters, dtype=np.float32)
    warm = base_lr * (warmup_ratio + (1 - warmup_ratio)
                      * np.minimum(it / max(warmup_iters, 1), 1.0))
    poly = (base_lr - min_lr) * (1 - it / max_iters) ** power + min_lr
    return np.where(it < warmup_iters, warm, poly).astype(np.float32)


SEG_CONFIGS = {
    # upernet_slak_tiny_512_80k_ade20k_ss.py
    "upernet_slak_tiny_512_80k_ade20k": SegRecipe(
        backbone=_slak_backbone((3, 3, 9, 3), (96, 192, 384, 768), 0.1),
        head=UperNetConfig(in_channels=(124, 249, 499, 998)),
        max_iters=80_000, lr=2e-4),
    "upernet_slak_tiny_512_160k_ade20k": SegRecipe(
        backbone=_slak_backbone((3, 3, 9, 3), (96, 192, 384, 768), 0.1),
        head=UperNetConfig(in_channels=(124, 249, 499, 998)),
        max_iters=160_000, lr=6e-5),
    "upernet_slak_small_512_160k_ade20k": SegRecipe(
        backbone=_slak_backbone((3, 3, 27, 3), (96, 192, 384, 768), 0.3),
        head=UperNetConfig(in_channels=(124, 249, 499, 998)),
        max_iters=160_000, lr=6e-5),
    "upernet_slak_base_512_160k_ade20k": SegRecipe(
        backbone=_slak_backbone((3, 3, 27, 3), (128, 256, 512, 1024), 0.4),
        head=UperNetConfig(in_channels=(166, 332, 665, 1331)),
        max_iters=160_000, lr=6e-5),
}

DET_CONFIGS = {
    # cascade_mask_rcnn_slak_tiny_...3x_coco_in1k.py
    "cascade_mask_rcnn_slak_tiny_3x_coco": DetRecipe(
        backbone=_slak_backbone((3, 3, 9, 3), (96, 192, 384, 768), 0.2)),
}
