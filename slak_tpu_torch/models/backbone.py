"""Multi-scale feature backbone for dense prediction: port of
``slak_tpu/models/backbone.py`` (the reference's mmseg / mmdet SLaK
backbones, ``segmentation/slak.py:181-350``, ``detection/slak.py``).

:class:`Backbone` is the port's :class:`~slak_tpu_torch.models.slak.SLaK`
(its module names, so a classifier checkpoint loads into it) plus a
channels-first LayerNorm ``norm{i}`` (eps 1e-6) for each ``out_indices``
entry; the forward returns those normed stage outputs (NCHW) from
``SLaK.forward_features(return_stages=True)``. The classifier head and the
final norm stay, unused, for checkpoint compatibility, as ``init_backbone``
keeps them.

``sparse`` mode: :func:`derive_masks` takes the masks from the nonzero
weights of a loaded sparse checkpoint (``segmentation/slak.py:317-326``),
and the forward multiplies the weights by them (``:328-335``) through
``torch.func.functional_call``, so the gradients of the masked weights are
masked too, as ``jax.grad`` of ``apply_mask_to_tree`` gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from slak_tpu_torch.models.slak import LayerNorm, SLaK, SLaKConfig
from slak_tpu_torch.sparsity.masking import select_maskable


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    model: SLaKConfig = SLaKConfig()
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    sparse: bool = False


class Backbone(SLaK):
    """SLaK with per-stage output norms ``norm{i}``."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__(cfg.model)
        self.bcfg = cfg
        dims = cfg.model.widened_dims
        for i in cfg.out_indices:
            setattr(self, f"norm{i}", LayerNorm(dims[i],
                                                channels_first=True))

    def forward(self, x, plain: bool = False, generator=None,
                masks: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, ...]:
        """NCHW images in the compute dtype -> the tuple of normed NCHW
        stage features at ``out_indices`` (``slak_tpu``'s
        ``backbone_forward``; the mode is the model's). In
        ``sparse`` mode ``masks`` ({parameter name: mask}) multiply the
        weights they name for this forward."""
        if self.bcfg.sparse and masks is not None:
            named = dict(self.named_parameters())
            masked = {n: named[n] * m.to(named[n].dtype)
                      for n, m in masks.items()}
            return torch.func.functional_call(self, masked,
                                              (x, plain, generator))
        feats = self.forward_features(x, plain, generator,
                                      return_stages=True)
        return tuple(getattr(self, f"norm{i}")(feats[i])
                     for i in self.bcfg.out_indices)


def init_backbone(cfg: BackboneConfig, generator: Optional[torch.Generator]
                  = None, device=None) -> Backbone:
    """The backbone with the reference init (``SLaK.reset_parameters``;
    the norms at identity, as mm* ``init_weights`` leaves them), in train
    mode, on ``device`` (CPU unless given)."""
    model = Backbone(cfg)
    model.reset_parameters(generator)
    with torch.no_grad():
        for i in cfg.out_indices:
            n = getattr(model, f"norm{i}")
            n.weight.fill_(1.0)
            n.bias.zero_()
    return model.to(device) if device is not None else model


def load_backbone_norms(model: Backbone, sd: Dict[str, torch.Tensor],
                        out_indices: Sequence[int]) -> Backbone:
    """Copy ``norm{i}.weight`` / ``.bias`` from a state dict into the
    model; norms missing from it stay as they are."""
    with torch.no_grad():
        for i in out_indices:
            wk, bk = f"norm{i}.weight", f"norm{i}.bias"
            if wk in sd:
                n = getattr(model, f"norm{i}")
                n.weight.copy_(torch.as_tensor(sd[wk]))
                n.bias.copy_(torch.as_tensor(sd[bk]))
    return model


def derive_masks(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Sparse-eval masks from the nonzero weights: every parameter with
    ndim >= 2 (``select_maskable``), 1.0 where it is nonzero."""
    sel = select_maskable(dict(model.named_parameters()))
    return {n: (w.detach() != 0.0).float() for n, w in sel.items()}
