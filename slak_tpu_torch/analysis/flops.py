"""Sparsity-aware FLOPs counter: port of ``slak_tpu/analysis/flops.py``
(the reference's ``FLOPs_counter.py:29-141``).

Multiply-adds of every conv and linear at ``input_size``, each scaled by
the nonzero fraction of its weight (``(weight != 0).sum()``,
``FLOPs_counter.py:46-59``), so a sparse model reports its effective
FLOPs. The shapes are static, so the module's parameters are walked
directly instead of hooked. Reported in multiply-adds like the reference
(its "FLOPs" are MACs: SLaK-T = 5.0G).
"""

from __future__ import annotations

import torch

from slak_tpu_torch.models.slak import SLaK


def _nnz_frac(w: torch.Tensor) -> float:
    return float((w != 0).float().mean())


def count_model_flops(model: SLaK, input_size: int = 224,
                      multiply_adds: bool = True) -> dict:
    """Per-component MACs of ``model`` at ``input_size``: {"total",
    "per_layer" (stem, downsample1-3, stage0-3, head), "params",
    "nonzero_params"}. Conv cost = H_out*W_out * kh*kw*Cin/groups * Cout *
    nnz_frac; linear cost = positions * Cin*Cout * nnz_frac
    (FLOPs_counter.py:46-75). ``multiply_adds=False`` doubles every count.
    """
    cfg = model.cfg
    dims = cfg.widened_dims
    total = 0.0
    per_layer = {}
    hw = input_size // 4                     # after the stem

    def conv_cost(h, w, kh, kw, cin, cout, weight, groups=1):
        return h * w * (kh * kw * (cin // groups)) * cout * _nnz_frac(weight)

    c = conv_cost(hw, hw, 4, 4, cfg.in_chans, dims[0],
                  model.downsample_layers[0][0].weight)
    per_layer["stem"] = c
    total += c
    for i in range(4):
        if i > 0:
            hw //= 2
            c = conv_cost(hw, hw, 2, 2, dims[i - 1], dims[i],
                          model.downsample_layers[i][1].weight)
            per_layer[f"downsample{i}"] = c
            total += c
        stage = 0.0
        for blk in model.stages[i]:
            lk = blk.large_kernel
            convs = ([lk.lkb_reparam] if hasattr(lk, "lkb_reparam")
                     else [b.conv for b in lk.branches()])
            for conv in convs:
                kh, kw = conv.weight.shape[-2:]
                stage += conv_cost(hw, hw, kh, kw, dims[i], dims[i],
                                   conv.weight, groups=dims[i])
            n_pos = hw * hw
            stage += n_pos * dims[i] * 4 * dims[i] \
                * _nnz_frac(blk.pwconv1.weight)
            stage += n_pos * 4 * dims[i] * dims[i] \
                * _nnz_frac(blk.pwconv2.weight)
        per_layer[f"stage{i}"] = stage
        total += stage
    head = dims[-1] * model.head.weight.shape[0] \
        * _nnz_frac(model.head.weight)
    per_layer["head"] = head
    total += head
    if not multiply_adds:
        total *= 2
        per_layer = {k: v * 2 for k, v in per_layer.items()}
    params = list(model.parameters())
    return {"total": total, "per_layer": per_layer,
            "params": sum(p.numel() for p in params),
            "nonzero_params": sum(int((p != 0).sum()) for p in params)}
