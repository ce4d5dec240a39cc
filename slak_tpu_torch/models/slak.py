"""The SLaK model family in PyTorch (NCHW), eval and train forward.

Port of ``slak_tpu/models/slak.py`` with the reference's module names
(models/SLaK.py:60-235), so a released ``.pth`` loads with
``load_state_dict``:

  downsample_layers.0 = (Conv2d 4x4/s4, LayerNorm channels_first)
  downsample_layers.i = (LayerNorm channels_first, Conv2d 2x2/s2)
  stages.i.j.large_kernel.{LoRA1,LoRA2,small_conv,lkb_origin}.{conv,bn}
  stages.i.j.large_kernel.lkb_reparam        (after merge)
  stages.i.j.{norm,pwconv1,pwconv2,gamma}, norm, head

Eval block (every stage): the branch BNs fold into the taps and the small
branch into LoRA1 (``ops/depthwise.py``), the pair runs as two K1 launches
(``ops/dwconv.py``), and the folded bias, LN, MLP, gamma and residual run
as one K2/K3 launch (``ops/mlp.py``) on the NCHW activation. The folded
taps and packed MLP weights are cached per block and compute dtype, and
rebuilt when a parameter changes. ``plain=True`` runs the same route
through the plain PyTorch versions of the kernels.

Train block (``model.train()``, the route of ``slak_tpu``
``forward_features(train=True)`` with its TPU layout gates dropped): LoRA1
and LoRA2 each run the stats-fused conv (K4, with the K1 dgrad and the
wgrad kernel in its backward) and their own BN from the kernel's sums;
the small branch runs ``F.conv2d`` + train BN; the three outputs are
summed. The tail runs :class:`~slak_tpu_torch.ops.mlp.FusedMlp` (K2
forward, K8 backward) where C <= 256 (stages 1-2 of SLaK-T), and the plain
composition under torch autograd above that, as the JAX route does
(``TRAIN_WIDE_MLP_BWD = False``). BN running stats update the module
buffers in place.

The compute dtype is the input's: parameters stay float32 and are rounded
to it where they are used, as in ``slak_tpu``, so autograd returns float32
gradients.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from slak_tpu_torch.models.layers import (LN_EPS, drop_path, gelu,
                                          layer_norm, trunc_normal_)
from slak_tpu_torch.ops.batchnorm import batch_norm_train, fold_bn
from slak_tpu_torch.ops.depthwise import (_pad_center, bn_branch_train,
                                          depthwise_conv2d, fold_branches,
                                          run_taps)
from slak_tpu_torch.ops.mlp import (BWD_C_MAX, FusedMlp, fused_mlp,
                                    fused_mlp_plain, pack_mlp)


@dataclasses.dataclass(frozen=True)
class SLaKConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    kernel_size: Tuple[int, ...] = (51, 49, 47, 13, 5)  # 4 stage Ks + small
    width_factor: float = 1.0
    decom: bool = True               # reference flag ``Decom``
    branch_bn: bool = True           # reference flag ``bn``
    num_classes: int = 1000
    in_chans: int = 3
    drop_path_rate: float = 0.0
    layer_scale_init_value: float = 1e-6
    head_init_scale: float = 1.0

    @property
    def widened_dims(self) -> Tuple[int, ...]:
        return tuple(int(d * self.width_factor) for d in self.dims)

    @property
    def small_kernel(self) -> int:
        return self.kernel_size[-1]

    def stage_kernel(self, i: int) -> int:
        return self.kernel_size[i]


class LayerNorm(nn.Module):
    """The reference LayerNorm: channels_last, or channels_first (NCHW)."""

    def __init__(self, c: int, eps: float = LN_EPS,
                 channels_first: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps
        self.dim = 1 if channels_first else -1

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dim)


def _conv(x, conv: nn.Conv2d):
    """A dense conv in the input's dtype (stem and downsample)."""
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)[:, None,
                                                                  None]


class ConvBN(nn.Module):
    """One branch: depthwise conv (no bias) [+ BatchNorm2d]."""

    def __init__(self, c: int, kh: int, kw: int, bn: bool):
        super().__init__()
        self.conv = nn.Conv2d(c, c, (kh, kw), 1, (kh // 2, kw // 2),
                              groups=c, bias=False)
        if bn:
            self.bn = nn.BatchNorm2d(c)

    def folded(self):
        """(taps (C, kh, kw), scale or None, bias or None) for eval."""
        w = self.conv.weight[:, 0]
        if not hasattr(self, "bn"):
            return w, None, None
        bn = self.bn
        m, a = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                       bn.eps)
        return w, m, a


class ReparamLargeKernelConv(nn.Module):
    """LoRA1 (K, s) + LoRA2 (s, K) [+ small_conv (s, s)], or lkb_origin
    (K, K) [+ small_conv] when not decomposed; lkb_reparam after merge."""

    def __init__(self, c: int, k: int, s: int, decom: bool, bn: bool):
        super().__init__()
        self.kernel_size = k
        if decom:
            self.LoRA1 = ConvBN(c, k, s, bn)
            self.LoRA2 = ConvBN(c, s, k, bn)
        else:
            self.lkb_origin = ConvBN(c, k, k, bn)
        if s < k:
            self.small_conv = ConvBN(c, s, s, bn)

    def branches(self):
        return [getattr(self, n) for n in ("LoRA1", "LoRA2", "lkb_origin",
                                           "small_conv") if hasattr(self, n)]

    def train_forward(self, x, plain: bool = False):
        """Sum of the branches in train mode, each rounded to x's dtype
        (``_lk_forward(train=True)``): the large BN branches through the
        stats-fused conv, the small one (and BN-less ones) through
        ``F.conv2d``."""
        out = None
        for name in ("LoRA1", "LoRA2", "lkb_origin", "small_conv"):
            br = getattr(self, name, None)
            if br is None:
                continue
            if hasattr(br, "bn") and name != "small_conv":
                y = bn_branch_train(x, br.conv.weight, br.bn, plain)
            else:
                y = depthwise_conv2d(x, br.conv.weight)
                if hasattr(br, "bn"):
                    bn = br.bn
                    y = batch_norm_train(y, bn.weight, bn.bias,
                                         bn.running_mean, bn.running_var,
                                         bn.momentum, bn.eps)
            out = y if out is None else out + y
        return out

    def eval_taps(self):
        """(taps list, bias_total or None) of the eval fold."""
        if hasattr(self, "lkb_reparam"):
            return [self.lkb_reparam.weight[:, 0]], self.lkb_reparam.bias
        ws, scales, biases = zip(*(b.folded() for b in self.branches()))
        return fold_branches(ws, scales, biases)


def merge_lk(lk: ReparamLargeKernelConv) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN and merge every branch into one (C, 1, K, K) conv + bias
    (reference models/SLaK.py:102-122; the decomposed pair zero-pads into
    the K x K window, exact for stride-1 same-padded convs)."""
    k = lk.kernel_size
    eq_w = eq_b = None
    for br in lk.branches():
        w, m, a = br.folded()
        if m is not None:
            w = w * m[:, None, None]
        else:
            a = torch.zeros(w.shape[0], device=w.device)
        w = _pad_center(w, k, k)
        eq_w = w if eq_w is None else eq_w + w
        eq_b = a if eq_b is None else eq_b + a
    return eq_w[:, None], eq_b


class Block(nn.Module):
    def __init__(self, c: int, k: int, s: int, decom: bool, bn: bool,
                 ls_init: float):
        super().__init__()
        self.large_kernel = ReparamLargeKernelConv(c, k, s, decom, bn)
        self.norm = LayerNorm(c)
        self.pwconv1 = nn.Linear(c, 4 * c)
        self.pwconv2 = nn.Linear(4 * c, c)
        if ls_init > 0:
            self.gamma = nn.Parameter(ls_init * torch.ones(c))
        self.drop_path_rate = 0.0            # set by SLaK from the config
        self._cache: Dict = {}

    def _version(self):
        return tuple((t.data_ptr(), t._version) for t in
                     list(self.parameters()) + list(self.buffers()))

    def prepared(self, dtype: torch.dtype, device: torch.device):
        """(taps, MlpWeights) for this compute dtype: the folded taps rounded
        to it, and the MLP weights packed with the folded bias."""
        key = (dtype, device)
        ver = self._version()
        hit = self._cache.get(key)
        if hit is not None and hit[0] == ver:
            return hit[1]
        with torch.no_grad():
            taps, bias = self.large_kernel.eval_taps()
            taps = [t.to(dtype).float().contiguous() for t in taps]
            pk = pack_mlp(self.norm.weight, self.norm.bias,
                          self.pwconv1.weight.t(), self.pwconv1.bias,
                          self.pwconv2.weight.t(), self.pwconv2.bias,
                          getattr(self, "gamma", None), bias, dtype)
        self._cache[key] = (ver, (taps, pk))
        return taps, pk

    def forward(self, x, plain: bool = False, generator=None):
        if self.training:
            return self._train_forward(x, plain, generator)
        taps, pk = self.prepared(x.dtype, x.device)
        y = run_taps(x, taps, plain)
        mlp = fused_mlp_plain if plain else fused_mlp
        return mlp(y, x, pk, channel_dim=1)

    def _train_forward(self, x, plain, generator):
        """``_block_forward(train=True)``: the branches, then the fused tail
        (C <= 256) or the plain composition in the same rounding order
        (slak_tpu/models/slak.py:702-715); drop-path multiplies the branch
        outside the fused tail."""
        y = self.large_kernel.train_forward(x, plain)
        rate = self.drop_path_rate
        gamma = getattr(self, "gamma", None)
        if x.shape[1] <= BWD_C_MAX:
            if gamma is None:
                gamma = torch.ones_like(self.norm.weight)
            args = (y, x, self.norm.weight, self.norm.bias,
                    self.pwconv1.weight, self.pwconv1.bias,
                    self.pwconv2.weight, self.pwconv2.bias, gamma)
            if rate > 0.0:
                branch = FusedMlp.apply(*args, False, plain)
                return x + drop_path(branch, rate, generator, train=True)
            return FusedMlp.apply(*args, True, plain)
        cdt = y.dtype
        h = layer_norm(y, self.norm.weight, self.norm.bias, dim=1)
        h = h.permute(0, 2, 3, 1)
        h = F.linear(h, self.pwconv1.weight.to(cdt)) + \
            self.pwconv1.bias.to(cdt)
        h = gelu(h)
        h = F.linear(h, self.pwconv2.weight.to(cdt)) + \
            self.pwconv2.bias.to(cdt)
        if gamma is not None:
            h = h * gamma.to(cdt)
        h = drop_path(h.permute(0, 3, 1, 2), rate, generator, train=True)
        return (x + h).contiguous()


class SLaK(nn.Module):
    """SLaK / ConvNeXt classifier; ``forward`` takes NCHW images (the
    module-level :func:`apply` takes NHWC ones)."""

    def __init__(self, cfg: SLaKConfig):
        super().__init__()
        self.cfg = cfg
        dims = cfg.widened_dims
        self.downsample_layers = nn.ModuleList()
        self.downsample_layers.append(nn.Sequential(
            nn.Conv2d(cfg.in_chans, dims[0], 4, 4),
            LayerNorm(dims[0], channels_first=True)))
        for i in range(3):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm(dims[i], channels_first=True),
                nn.Conv2d(dims[i], dims[i + 1], 2, 2)))
        self.stages = nn.ModuleList()
        for i in range(4):
            self.stages.append(nn.Sequential(*[
                Block(dims[i], cfg.stage_kernel(i), cfg.small_kernel,
                      cfg.decom, cfg.branch_bn, cfg.layer_scale_init_value)
                for _ in range(cfg.depths[i])]))
        # stochastic depth rises linearly over the blocks (_dp_rates)
        blocks = [b for st in self.stages for b in st]
        for j, b in enumerate(blocks):
            b.drop_path_rate = (cfg.drop_path_rate * j / (len(blocks) - 1)
                                if len(blocks) > 1 else 0.0)
        self.norm = nn.LayerNorm(dims[-1], eps=LN_EPS)
        self.head = nn.Linear(dims[-1], cfg.num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference init: trunc_normal(.02) conv/linear weights, zero
        biases, unit LN/BN, gamma = layer_scale_init_value, head scaled."""
        cfg = self.cfg
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    trunc_normal_(m.weight, 0.02, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (LayerNorm, nn.LayerNorm)):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
                elif isinstance(m, Block) and hasattr(m, "gamma"):
                    m.gamma.fill_(cfg.layer_scale_init_value)
            self.head.weight.mul_(cfg.head_init_scale)
            self.head.bias.mul_(cfg.head_init_scale)
        return self

    def forward_features(self, x, plain: bool = False, generator=None):
        """NCHW images in the compute dtype -> pooled, normed features."""
        for i in range(4):
            ds = self.downsample_layers[i]
            if i == 0:
                x = ds[1](_conv(x, ds[0]))
            else:
                x = _conv(ds[0](x), ds[1])
            for blk in self.stages[i]:
                x = blk(x, plain, generator)
        pooled = x.mean((2, 3))
        return layer_norm(pooled, self.norm.weight, self.norm.bias)

    def forward(self, x, plain: bool = False, generator=None):
        """NCHW images -> (N, num_classes) float32 logits. In eval no graph
        is recorded; in train mode ``generator`` draws the drop-path
        masks."""
        if not self.training:
            with torch.no_grad():
                return self._logits(x, plain, None)
        return self._logits(x, plain, generator)

    def _logits(self, x, plain, generator):
        feats = self.forward_features(x, plain, generator)
        return (feats.float() @ self.head.weight.to(feats.dtype).float().t()
                + self.head.bias.float())


def apply(model: SLaK, x_nhwc: torch.Tensor, plain: bool = False,
          generator=None) -> torch.Tensor:
    """(N, H, W, C) images -> (N, num_classes) float32 logits, like
    ``slak_tpu.models.slak.apply``; the compute dtype is the images'. The
    model's mode (``train()``/``eval()``) picks the route."""
    return model(x_nhwc.permute(0, 3, 1, 2).contiguous(), plain, generator)


def merge_model(model: SLaK) -> SLaK:
    """A copy of ``model`` with every large-kernel conv reparameterized into
    one ``lkb_reparam`` conv (reference ``merge_kernel``)."""
    out = copy.deepcopy(model)
    for stage in out.stages:
        for blk in stage:
            lk = blk.large_kernel
            with torch.no_grad():
                w, b = merge_lk(lk)
            k = lk.kernel_size
            rep = nn.Conv2d(w.shape[0], w.shape[0], k, 1, k // 2,
                            groups=w.shape[0], bias=True).to(w.device)
            with torch.no_grad():
                rep.weight.copy_(w)
                rep.bias.copy_(b)
            for n in ("LoRA1", "LoRA2", "lkb_origin", "small_conv"):
                if hasattr(lk, n):
                    delattr(lk, n)
            lk.lkb_reparam = rep
            blk._cache = {}
    return out


# ---------------------------------------------------------------------------
# registry (reference models/SLaK.py:264-286, convnext.py:164-201)
# ---------------------------------------------------------------------------


def _convnext_kw(kw):
    kw.setdefault("kernel_size", (7, 7, 7, 7, 100))
    kw.setdefault("decom", False)
    kw.setdefault("branch_bn", False)
    return kw


_SPECS = {
    "SLaK_debug": ((1, 1, 2, 1), (8, 16, 24, 32), False),
    "SLaK_tiny": ((3, 3, 9, 3), (96, 192, 384, 768), False),
    "SLaK_small": ((3, 3, 27, 3), (96, 192, 384, 768), False),
    "SLaK_base": ((3, 3, 27, 3), (128, 256, 512, 1024), False),
    "SLaK_large": ((3, 3, 27, 3), (192, 384, 768, 1536), False),
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768), True),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768), True),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024), True),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536), True),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048), True),
}
MODEL_REGISTRY = tuple(_SPECS)


def config_for(name: str, **kw) -> SLaKConfig:
    if name not in _SPECS:
        raise ValueError(f"unknown model {name!r}; have {sorted(_SPECS)}")
    depths, dims, convnext = _SPECS[name]
    if convnext:
        kw = _convnext_kw(kw)
    elif name == "SLaK_debug":
        kw.setdefault("kernel_size", (13, 11, 9, 7, 5))
    return SLaKConfig(depths=depths, dims=dims, **kw)
