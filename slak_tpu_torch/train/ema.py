"""Sparse-aware EMA: port of ``slak_tpu/train/ema.py`` (the reference's
``ModelEma.update(model, mask)``, model_sema.py:67-91).

  * unmasked tensor: ema <- decay * ema + (1 - decay) * model
  * masked tensor:   ema <- (decay * ema + (1 - decay) * model) * mask
                            + (mask & (ema == 0)) * decay * model
    (pruned positions go to zero; a freshly grown one lands at model).

The EMA covers the model's parameters and its floating-point buffers (the
BN running stats), keyed by the state_dict names, in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def model_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Parameters and float buffers by name (what the EMA tracks)."""
    out = {n: p for n, p in model.named_parameters()}
    out.update({n: b for n, b in model.named_buffers()
                if b.is_floating_point()})
    return out


def ema_init(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: t.detach().float().clone()
            for n, t in model_tensors(model).items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
               decay: float,
               masks: Optional[Dict[str, torch.Tensor]] = None):
    """One EMA update, in place; the unmasked tensors in one foreach pass
    (a few launches for the ~250 tensors, not a few each)."""
    masks = masks or {}
    plain_e, plain_m = [], []
    for name, m in model_tensors(model).items():
        e = ema[name]
        mf = m.detach().float()
        if name not in masks:
            plain_e.append(e)
            plain_m.append(mf)
            continue
        mask = masks[name]
        fresh = ((e == 0.0) & (mask != 0.0)).float()
        e.mul_(decay).add_(mf, alpha=1.0 - decay).mul_(mask)
        e.add_(fresh * decay * mf)
    if plain_e:
        torch._foreach_mul_(plain_e, decay)
        torch._foreach_add_(plain_e, plain_m, alpha=1.0 - decay)
