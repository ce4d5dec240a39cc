"""Eval step (port of ``slak_tpu/train/engine.py`` ``make_eval_step``,
reference engine.py:142-178): logits, CE loss and top-1/5 per batch."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from slak_tpu_torch.models.slak import SLaK, apply
from slak_tpu_torch.train import losses as L


def make_eval_step(model: SLaK, compute_dtype: Optional[torch.dtype] = None
                   ) -> Callable[[Tuple[torch.Tensor, torch.Tensor]],
                                 Dict[str, torch.Tensor]]:
    """Returns ``eval_step((images, labels))`` on NHWC images, run on the
    model's device in ``compute_dtype`` (default: the model's)."""
    dtype = compute_dtype or getattr(model, "compute_dtype", torch.float32)
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch):
        images, labels = batch
        images = images.to(device=device, dtype=dtype)
        labels = labels.to(device)
        logits = apply(model, images)
        return {
            "logits": logits,
            "loss": L.cross_entropy(logits, labels),
            "acc1": L.accuracy_topk(logits, labels, 1),
            "acc5": L.accuracy_topk(logits, labels, 5),
            "n": torch.tensor(float(labels.shape[0])),
        }

    return eval_step
