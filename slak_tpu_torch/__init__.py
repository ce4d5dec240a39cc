"""PyTorch / CUDA port of :mod:`slak_tpu` for one NVIDIA H100 (sm_90a).

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``utils/``, ``train/``) and never imports JAX or :mod:`slak_tpu`: what it
needs from there (constants, the checkpoint mapping) is copied.

Activations are NCHW (the reference's layout). Every TPU kernel on the
eval path is a hand-written CUDA kernel under ``ops/csrc/``, built with
``nvcc`` on first use (``ops/_build.py``); each wrapper runs its plain
PyTorch version for CPU tensors and launches its kernel for CUDA tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Raises when no device is given and no CUDA device is present; the CPU
    (where the plain PyTorch versions stand in for the kernels) has to be
    asked for explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels")
    return torch.device("cuda")
