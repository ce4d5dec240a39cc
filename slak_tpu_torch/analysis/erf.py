"""Effective-receptive-field analysis: port of ``slak_tpu/analysis/erf.py``
(the reference's ``erf/visualize_erf.py`` + ``erf/analyze_erf.py``):

  * the gradient of the ReLU'd central output activation (summed over
    channels) with respect to the input, ReLU'd and summed over batch and
    channels, is the contribution map (``visualize_erf.py:46-55``);
  * log10(1 + x), rescaled to [0, 1], and the high-contribution area ratio
    at thresholds {0.2, 0.3, 0.5, 0.99} (``analyze_erf.py:54-76``).

The public functions keep the JAX package's layout: NHWC samples in, a
``feature_fn(x) -> (N, H', W', C)`` feature map, an (H, W) numpy map out.
``torch.autograd.grad`` takes the place of ``jax.grad``; through the port's
eval route (``SLaK.forward_features(..., return_stages=True)`` with the
model in eval mode) the backward runs K1 on flipped taps and the fused
tail's K8 / K9 backward kernels.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch


def get_input_grad(feature_fn: Callable[[torch.Tensor], torch.Tensor],
                   samples) -> np.ndarray:
    """``feature_fn(x) -> (N, H', W', C)`` final feature map; samples: NHWC
    (a tensor, or a numpy array taken as a CPU tensor). Returns the (H, W)
    aggregated input-gradient map (visualize_erf.py:46-55)."""
    if not isinstance(samples, torch.Tensor):
        samples = torch.from_numpy(np.asarray(samples))
    x = samples.detach().requires_grad_(True)
    with torch.enable_grad():
        out = feature_fn(x)
        h, w = out.shape[1] // 2, out.shape[2] // 2
        central = torch.relu(out[:, h, w, :].float()).sum()
        (grad,) = torch.autograd.grad(central, x)
    return torch.relu(grad.float()).sum((0, 3)).cpu().numpy()


def erf_contribution(feature_fn, batches: Iterable,
                     return_count: bool = False):
    """Average the contribution map over image batches (the reference uses
    50 single-image batches at 1024x1024, ``visualize_erf.py:58-122``);
    maps that are not finite are skipped. With ``return_count``, returns
    (map, number of batches averaged)."""
    total, n = None, 0
    for samples in batches:
        m = get_input_grad(feature_fn, samples)
        if not np.all(np.isfinite(m)):
            continue
        total = m if total is None else total + m
        n += 1
    avg = total / max(n, 1)
    return (avg, n) if return_count else avg


def get_rectangle(data: np.ndarray, thresh: float
                  ) -> Optional[Tuple[int, float]]:
    """Smallest centered square holding > thresh of the total contribution
    (analyze_erf.py:54-62): (side, area ratio), or None."""
    h, w = data.shape
    all_sum = np.sum(data)
    for i in range(1, h // 2):
        area = data[h // 2 - i:h // 2 + 1 + i, w // 2 - i:w // 2 + 1 + i]
        if np.sum(area) / all_sum > thresh:
            return i * 2 + 1, ((i * 2 + 1) / h) ** 2
    return None


def analyze_erf(data: np.ndarray,
                thresholds=(0.2, 0.3, 0.5, 0.99)) -> dict:
    """log10(1+x), rescale to [0,1], report area ratios
    (analyze_erf.py:64-76)."""
    data = np.log10(data + 1)
    data = data / np.max(data)
    out = {}
    for t in thresholds:
        r = get_rectangle(data, t)
        out[t] = {"side": r[0], "area_ratio": r[1]} if r else None
    return {"normalized": data, "ratios": out}
