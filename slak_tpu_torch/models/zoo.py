"""The KD teacher zoo's shared pieces and registry.

The teachers (``vit.py``, ``swin.py``, ``cswin.py``, ``resnet.py``,
``mobile.py``) port ``slak_tpu/models/{vit,swin,cswin,resnet,mobile}.py``
with timm's module names (the names ``slak_tpu/utils/convert_teachers.py``
reads), so a timm ``state_dict`` loads with ``load_state_dict``. They take
NHWC images and return ``(float32 logits, final-stage feature (N, H, W,
C))`` as the JAX ``apply`` functions do, in eval mode only. Parameters
are float32, cast to the compute dtype where they are used; LN computes
its statistics in float32 and BN its eval transform in float32, both
returning the input's dtype. The JAX package adds float32 biases to
products in the compute dtype, which promotes a bf16 product to float32;
:func:`dense` and :func:`matmul` keep that promotion (so a bf16 ViT, Swin
or CSWin computes in float32 from its first biased linear on, as the JAX
one does). No Pallas kernel is reached by any of them in ``slak_tpu``: the
port runs stock torch ops (no ``scaled_dot_product_attention``, whose
rounding differs).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from slak_tpu_torch import resolve_device
from slak_tpu_torch.models.layers import trunc_normal_


def dense(x: torch.Tensor, lin: nn.Linear,
          wdtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``jnp.dot(x, w.astype(wdtype)) + b`` (``wdtype`` x's by default):
    the weight rounded to ``wdtype``, the product in the promoted dtype of
    x and the weight, then the float32 bias (promoting a bf16 product to
    float32)."""
    w = lin.weight.to(wdtype or x.dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    y = F.linear(x.to(dt), w.to(dt))
    return y if lin.bias is None else y + lin.bias


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two (``jnp.einsum``'s)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval BatchNorm on NCHW as ``slak_tpu.ops.batchnorm.batch_norm(train=
    False)``: (x - mean) * (rsqrt(var + eps) * scale) + bias in float32,
    returned in x's dtype."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    y = ((x.float() - bn.running_mean.float()[:, None, None])
         * (inv * bn.weight.float())[:, None, None]
         + bn.bias.float()[:, None, None])
    return y.to(x.dtype)


def he_normal_(w: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: N(0, 2 / fan_in), the JAX zoo's conv init."""
    with torch.no_grad():
        return nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_in),
                               generator=generator)


class Teacher(nn.Module):
    """A teacher: ``forward(images NHWC) -> (logits, feature NHWC)``."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator``: trunc-normal(0.02) linear
        weights and tables, N(0, 2 / fan_in) conv weights, zero biases,
        unit norms, BN at identity."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    trunc_normal_(m.weight, 0.02, generator)
                elif isinstance(m, nn.Conv2d):
                    fan = m.weight[0].numel()
                    he_normal_(m.weight, fan, generator)
                elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                    m.reset_parameters()
                    continue
                else:
                    continue
                if m.bias is not None:
                    m.bias.zero_()
            self._reset_extra(generator)
        return self

    def _reset_extra(self, generator):
        """Family parameters outside Linear / Conv2d / norms."""

    @property
    def feature_channels(self) -> int:
        """C of the feature map (the KD CLI's ``teacher_channels``,
        ``slak_tpu/kd/main.py:71-145``)."""
        raise NotImplementedError

    def teacher_apply(self) -> Callable:
        """This teacher frozen (eval, no parameter requiring a gradient):
        ``fn(images, plain=False) -> (logits, feature)``, no graph; ``plain``
        is accepted for the KD step's signature (no kernel runs here)."""
        self.eval()
        self.requires_grad_(False)

        @torch.no_grad()
        def fn(images, plain: bool = False):
            return self(images)

        return fn


def family_of(name: str) -> Optional[str]:
    """The zoo family of a teacher name (``kd/main.py``'s dispatch,
    ``slak_tpu/kd/main.py:71-145``), or None for a SLaK / ConvNeXt."""
    if name.startswith(("vit", "deit")):
        return "vit"
    if name.startswith("cswin"):
        return "cswin"
    if name.startswith("swin"):
        return "swin"
    if name.startswith("resnet"):
        return "resnet"
    if name.startswith(("mobilenet", "efficientnet", "tf_efficientnet")):
        return "mobile"
    return None


def registry() -> Dict[str, Callable]:
    """Name -> config constructor of every zoo teacher."""
    from slak_tpu_torch.models import cswin, mobile, resnet, swin, vit
    out = {}
    for mod in (vit, swin, cswin, resnet, mobile):
        out.update({n: getattr(mod, n) for n in mod.NAMES})
    return out


def create_teacher(name: str, num_classes: int = 1000, img_size: int = 224,
                   device=None, seed: int = 0) -> Teacher:
    """A zoo teacher by name at ``num_classes`` (and, for the
    transformers, ``img_size``), random weights from ``seed``, in eval
    mode on ``device`` (CUDA unless the CPU is asked for)."""
    reg = registry()
    if name not in reg:
        raise ValueError(f"unknown teacher {name!r}; have {sorted(reg)}")
    kw = {"num_classes": num_classes}
    if family_of(name) in ("vit", "swin", "cswin"):
        kw["img_size"] = img_size
    dev = resolve_device(device)
    model = reg[name](**kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
