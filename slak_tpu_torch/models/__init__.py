"""Model registry of the port: :func:`create_model`."""

from __future__ import annotations

import torch

from slak_tpu_torch import resolve_device
from slak_tpu_torch.models.slak import (MODEL_REGISTRY, SLaK, SLaKConfig,
                                        apply, config_for, merge_model)

__all__ = ["MODEL_REGISTRY", "SLaK", "SLaKConfig", "apply", "create_model",
           "merge_model"]


def create_model(name: str, device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, **kw) -> SLaK:
    """Build ``name`` (``slak_tpu`` registry names and config keywords),
    initialize it from ``seed`` with a ``torch.Generator``, and return it in
    eval mode on ``device`` (CUDA unless ``device="cpu"`` is asked for).
    Parameters are float32; ``dtype`` is the compute dtype that
    ``train.engine.make_eval_step`` runs the images in."""
    dev = resolve_device(device)
    model = SLaK(config_for(name, **kw))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.compute_dtype = dtype
    return model.to(dev).eval()
