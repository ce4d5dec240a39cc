"""Optimizer layer: AdamW with timm-style parameter groups and the ConvNeXt
layer-decay LR scaling.

Port of ``slak_tpu/train/optim.py`` on the port's (the reference's)
parameter names:
  * :func:`cosine_schedule_array`, the reference's per-iteration schedule
    (utils.py:428-445);
  * :func:`layer_id_for_param` / :func:`layer_decay_scales`
    (optim_factory.py:32-70, main.py:363-369);
  * :func:`param_groups`: weight decay off for 1-D params and biases, one
    torch param group per (decay on/off, layer scale);
  * :func:`make_adamw` / :func:`set_lr_wd`: ``torch.optim.AdamW`` carries
    the update (the JAX package computes it outside any kernel too); each
    iteration writes ``lr * lr_scale`` and ``wd * wd_on`` into the groups,
    which gives ``adamw_update``'s math: p *= 1 - lr_g * wd, then
    p -= lr_g * mhat / (sqrt(vhat) + eps);
  * :func:`global_grad_norm` / :func:`clip_grads`: the global-norm clip of
    ``adamw_update`` (scale min(1, clip / (norm + 1e-6)));
  * :class:`Adan` / :func:`make_adan`: the Adaptive Nesterov optimizer of
    ``adan_update`` (the fork's timm1/optim/adan.py), on the same groups;
    ``set_lr_wd`` drives it as it drives AdamW;
  * :func:`adam_momentum`: exp_avg / (sqrt(exp_avg_sq) + 1e-8), the score
    momentum growth reads (sparse_core.py:362-370), for either optimizer
    (Adan keeps m and n under AdamW's state names, as timm's does).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

NUM_LAYERS = 12


def cosine_schedule_array(base_value: float, final_value: float, epochs: int,
                          niter_per_ep: int, warmup_epochs: int = 0,
                          start_warmup_value: float = 0.0,
                          warmup_steps: int = -1) -> np.ndarray:
    """The reference's per-iteration schedule: linear warmup, then cosine
    from ``base_value`` to ``final_value``."""
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters) \
        if warmup_iters > 0 else np.array([])
    n = epochs * niter_per_ep - warmup_iters
    iters = np.arange(n)
    sched = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / max(n, 1)))
    out = np.concatenate([warmup, sched])
    assert len(out) == epochs * niter_per_ep
    return out.astype(np.float32)


def layer_id_for_param(name: str) -> int:
    """ConvNeXt 12-bucket layer id of a parameter name
    (``downsample_layers.{i}...`` / ``stages.{i}.{j}...``)."""
    m = re.match(r"downsample_layers\.(\d+)", name)
    if m:
        stage = int(m.group(1))
        if stage == 0:
            return 0
        if stage in (1, 2):
            return stage + 1
        return NUM_LAYERS
    m = re.match(r"stages\.(\d+)\.(\d+)", name)
    if m:
        stage, block = int(m.group(1)), int(m.group(2))
        if stage in (0, 1):
            return stage + 1
        if stage == 2:
            return 3 + block // 3
        return NUM_LAYERS
    return NUM_LAYERS + 1


def layer_decay_scales(layer_decay: float) -> Tuple[float, ...]:
    """values[i] = layer_decay ** (13 - i), i in [0, 13]."""
    return tuple(layer_decay ** (NUM_LAYERS + 1 - i)
                 for i in range(NUM_LAYERS + 2))


def param_groups(named_params: Iterable[Tuple[str, torch.Tensor]],
                 layer_decay: Optional[float] = None,
                 skip_list: Tuple[str, ...] = ()) -> List[Dict]:
    """torch param groups: ``{"params", "names", "wd_on", "lr_scale"}``,
    one group per (wd_on, lr_scale) pair, in first-seen order."""
    scales = layer_decay_scales(layer_decay) if layer_decay else None
    groups: Dict[Tuple[float, float], Dict] = {}
    for name, p in named_params:
        no_decay = p.ndim <= 1 or name.endswith(".bias") or name in skip_list
        wd_on = 0.0 if no_decay else 1.0
        scale = scales[layer_id_for_param(name)] if scales else 1.0
        g = groups.setdefault((wd_on, scale), {
            "params": [], "names": [], "wd_on": wd_on, "lr_scale": scale})
        g["params"].append(p)
        g["names"].append(name)
    return list(groups.values())


def make_adamw(groups: List[Dict], betas=(0.9, 0.999),
               eps: float = 1e-8) -> torch.optim.AdamW:
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas), eps=eps,
                             weight_decay=0.0)


ADAN_BETAS = (0.98, 0.92, 0.99)


class Adan(torch.optim.Optimizer):
    """Adan (arXiv 2208.06677) as ``slak_tpu.train.optim.adan_update``:
    per parameter the state ``exp_avg`` (m), ``exp_avg_diff`` (v),
    ``exp_avg_sq`` (n), ``pre_grad`` and ``step``; on the first step
    pre_grad is the gradient itself (so g - pre_grad = 0). With
    lr_g = group lr and wd_g = group weight decay:

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) (g - pre_grad)
        n = b3 n + (1 - b3) (g + b2 (g - pre_grad))^2
        step = (m / bc1 + b2 v / bc2) / (sqrt(n) / sqrt(bc3) + eps)
        p = (p - lr_g step) / (1 + lr_g wd_g)

    The update runs as ``torch._foreach_*`` passes over each group."""

    def __init__(self, params, lr: float = 0.0, betas=ADAN_BETAS,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            b1, b2, b3 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            for p in ps:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for k in ("exp_avg", "exp_avg_diff", "exp_avg_sq"):
                        st[k] = torch.zeros_like(p, dtype=torch.float32)
                    st["pre_grad"] = p.grad.float().clone()
            count = self.state[ps[0]]["step"] + 1
            bc1, bc2, bc3 = (1.0 - b ** count for b in (b1, b2, b3))
            sts = [self.state[p] for p in ps]
            g = [p.grad.float() for p in ps]
            m, v, n, pre = ([st[k] for st in sts] for k in (
                "exp_avg", "exp_avg_diff", "exp_avg_sq", "pre_grad"))
            gd = torch._foreach_sub(g, pre)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, gd, alpha=1.0 - b2)
            u = torch._foreach_add(g, gd, alpha=b2)
            torch._foreach_mul_(u, u)
            torch._foreach_mul_(n, b3)
            torch._foreach_add_(n, u, alpha=1.0 - b3)
            denom = torch._foreach_sqrt(n)
            torch._foreach_div_(denom, math.sqrt(bc3))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(m, bc1)
            torch._foreach_add_(upd, torch._foreach_div(v, bc2), alpha=b2)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(ps, upd, alpha=-lr)
            torch._foreach_div_(ps, 1.0 + lr * wd)
            for st, gi in zip(sts, g):
                st["step"] = count
                st["pre_grad"].copy_(gi)


def make_adan(groups: List[Dict], betas=ADAN_BETAS,
              eps: float = 1e-8) -> Adan:
    return Adan(groups, lr=0.0, betas=tuple(betas), eps=eps,
                weight_decay=0.0)


def set_lr_wd(opt: torch.optim.Optimizer, lr: float, wd: float):
    """This iteration's lr and weight decay into every group."""
    for g in opt.param_groups:
        g["lr"] = lr * g["lr_scale"]
        g["weight_decay"] = wd * g["wd_on"]


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


def clip_grads(grads: List[torch.Tensor], norm: torch.Tensor,
               clip: float):
    """In place: grads *= min(1, clip / (norm + 1e-6))."""
    scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)


def adam_momentum(opt: torch.optim.Optimizer,
                  named_params: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """{name: exp_avg / (sqrt(exp_avg_sq) + 1e-8)} for every parameter the
    optimizer has state for."""
    out = {}
    for name, p in named_params.items():
        st = opt.state.get(p)
        if st and "exp_avg" in st:
            out[name] = st["exp_avg"] / (st["exp_avg_sq"].sqrt() + 1e-8)
    return out
