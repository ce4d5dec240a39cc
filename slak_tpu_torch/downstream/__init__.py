"""Downstream transfer: UperNet segmentation and Cascade Mask R-CNN
detection on the SLaK backbone, their recipes, metrics and CLIs (port of
``slak_tpu.downstream``)."""

from slak_tpu_torch.downstream.segmentation import (
    UperNetConfig, init_upernet, upernet_forward, seg_loss,
)
from slak_tpu_torch.downstream.configs import (
    SEG_CONFIGS, DET_CONFIGS, SegRecipe, DetRecipe,
)

__all__ = ["UperNetConfig", "init_upernet", "upernet_forward", "seg_loss",
           "SEG_CONFIGS", "DET_CONFIGS", "SegRecipe", "DetRecipe"]
