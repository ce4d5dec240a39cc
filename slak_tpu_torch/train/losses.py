"""Losses and metrics (port of ``slak_tpu/train/losses.py``): the timm
pair the reference trains with -- label-smoothing CE for int labels,
soft-target CE for mixup's soft targets -- plain CE and top-k accuracy
(timm1/utils/metrics.py:25)."""

from __future__ import annotations

import torch


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """timm LabelSmoothingCrossEntropy: (1-eps)*nll + eps*mean(-logprobs)."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, labels[:, None].long())[:, 0]
    smooth = -logprobs.mean(-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_cross_entropy(logits: torch.Tensor,
                              target: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: batch mean of sum(-t * logprobs)."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return (-target.float() * logprobs).sum(-1).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -logprobs.gather(-1, labels[:, None].long())[:, 0].mean()


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 1) -> torch.Tensor:
    """Fraction of rows whose label is among the k largest logits; k is
    clamped to the class count."""
    topk = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    return (topk == labels[:, None]).any(-1).float().mean()
