"""Eval losses and metrics (port of ``slak_tpu/train/losses.py``, eval
half): cross-entropy and top-k accuracy (timm1/utils/metrics.py:25)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -logprobs.gather(-1, labels[:, None].long())[:, 0].mean()


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 1) -> torch.Tensor:
    """Fraction of rows whose label is among the k largest logits; k is
    clamped to the class count."""
    topk = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    return (topk == labels[:, None]).any(-1).float().mean()
