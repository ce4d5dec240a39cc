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
as one K2/K3 launch (``ops/mlp.py``) on the NCHW activation. Without a
graph the folded taps and packed MLP weights are cached per block and
compute dtype, and rebuilt when a parameter changes. With a graph being
recorded (grad enabled and the input or a block parameter requiring a
gradient: differentiated eval, e.g. the ERF analysis) the fold runs inside
the graph, uncached, and the block runs :class:`~slak_tpu_torch.ops.dwconv.
DwconvTaps` (K1; dx by K1 on flipped taps) and
:class:`~slak_tpu_torch.ops.mlp.FusedMlp` (K2; K8 backward at C <= 256,
K9 above), so every parameter gets its gradient through the fold, as
``jax.grad`` of the JAX eval forward gives it. ``plain=True`` runs the
same routes through the plain PyTorch versions of the kernels.

Dual eval stages (``eval_layout="dual"``, the route of ``slak_tpu``
``_stage_forward_dual``): a no-graph eval stage whose blocks are all
decomposed pairs keeps the activation in both orientations, xh (N, C, H, W)
and xq (N, C, W, H), made by one contiguous H<->W copy at stage entry;
each block is one K10 launch (``ops/dwpair.py``, mode ``dualboth``, the raw
pair y1 and y2 in the q orientation) and one K12 launch (``ops/mlp.py``
``fused_mlp_dual``: y1 + y2^T, the tail, oh and -- but on the stage's last
block -- oq); oh leaves the stage. SLaK-T runs all four stages so: 18 K10 +
18 K12 launches a forward, no K1 and no K2/K3.

Train block (``model.train()``, the route of ``slak_tpu``
``forward_features(train=True)`` with its TPU layout gates dropped): LoRA1
and LoRA2 each run the stats-fused conv (K4, with the K1 dgrad and the
wgrad kernel in its backward) and their own BN from the kernel's sums;
the small branch runs ``F.conv2d`` + train BN; the three outputs are
summed. The tail runs :class:`~slak_tpu_torch.ops.mlp.FusedMlp` (K2
forward, K8 backward) where C <= 256 (stages 1-2 of SLaK-T); above that
(stages 3-4) :data:`TRAIN_WIDE_MLP_BWD` picks ``FusedMlp`` with the K9
backward (True) or the plain composition under torch autograd (False, the
JAX route's value). BN running stats update the module buffers in
place. ``SLaKConfig.remat`` runs each train block under
``torch.utils.checkpoint`` (:meth:`SLaK._remat_block`).
``SLaKConfig.bn_axis_name`` names the process group
(``parallel/mesh.py``, ``"data"``) over which every train-mode branch BN
averages its batch statistics (SyncBN); eval reads the running stats and
never reduces.

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
import torch.utils.checkpoint

from slak_tpu_torch.models.layers import (LN_EPS, drop_path, drop_path_keep,
                                          gelu, layer_norm, trunc_normal_)
from slak_tpu_torch.ops.batchnorm import (batch_norm_train, fold_bn,
                                          running_stats_frozen)
from slak_tpu_torch.ops.depthwise import (_pad_center, bn_branch_train,
                                          depthwise_conv2d, fold_branches,
                                          run_taps)
from slak_tpu_torch.ops.dwpair import dwpair, dwpair_plain
from slak_tpu_torch.ops.mlp import (BWD_C_MAX, FusedMlp, fused_mlp,
                                    fused_mlp_dual, fused_mlp_dual_plain,
                                    fused_mlp_plain, pack_mlp)

EVAL_LAYOUTS = ("auto", "cmajor", "dual", "nhwc")

# The train tails wider than BWD_C_MAX (SLaK-T's stages 3-4): True runs
# them through FusedMlp (K2 forward, K9 backward), False through the
# unfused composition under torch autograd. The counterpart of slak_tpu's
# TRAIN_WIDE_MLP_BWD (models/slak.py:342-352), False there by a v5e
# measurement that does not carry over; set here by an in-call A/B of the
# bf16 batch-128 train step on the H100 (chip_smoke.py phase mlp_bwd_ab,
# PERF.md section 6).
TRAIN_WIDE_MLP_BWD = True


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
    # Eval activation layout, slak_tpu's SLaKConfig.eval_layout. "auto",
    # "cmajor" and "nhwc" all mean this port's one NCHW route (the pair as
    # two K1 launches, the tail as one K2/K3 launch a block): the JAX
    # package's C-major and NHWC layouts put the batch or the channels on
    # the TPU's 128-lane axis, and the CUDA kernels address NCHW directly
    # through strides. "dual" runs the dual eval stages (module docstring).
    eval_layout: str = "auto"
    # Per-block activation rematerialization of the train forward
    # (slak_tpu's SLaKConfig.remat): each train block runs under
    # torch.utils.checkpoint, so only the block boundaries stay live
    # across the backward and each block's interior is computed again
    # there (see SLaK._remat_block).
    remat: bool = False
    # SyncBN over this mesh axis if set (slak_tpu's
    # SLaKConfig.bn_axis_name): the name of a process group registered by
    # parallel.mesh.init_distributed, "data" for the whole world
    bn_axis_name: Optional[str] = None

    def __post_init__(self):
        if self.eval_layout not in EVAL_LAYOUTS:
            raise ValueError(f"eval_layout must be one of "
                             f"{'/'.join(EVAL_LAYOUTS)}, got "
                             f"{self.eval_layout!r}")

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

    def train_forward(self, x, plain: bool = False, group=None):
        """Sum of the branches in train mode, each rounded to x's dtype
        (``_lk_forward(train=True)``): the large BN branches through the
        stats-fused conv, the small one (and BN-less ones) through
        ``F.conv2d``; every BN's statistics averaged over ``group`` when
        one is given."""
        out = None
        for name in ("LoRA1", "LoRA2", "lkb_origin", "small_conv"):
            br = getattr(self, name, None)
            if br is None:
                continue
            if hasattr(br, "bn") and name != "small_conv":
                y = bn_branch_train(x, br.conv.weight, br.bn, plain, group)
            else:
                y = depthwise_conv2d(x, br.conv.weight)
                if hasattr(br, "bn"):
                    bn = br.bn
                    y = batch_norm_train(y, bn.weight, bn.bias,
                                         bn.running_mean, bn.running_var,
                                         bn.momentum, bn.eps, group=group)
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
        self.bn_axis_name: Optional[str] = None   # likewise
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

    def forward(self, x, plain: bool = False, generator=None, keep=None):
        """``keep``: the train forward's drop-path draw
        (:func:`~slak_tpu_torch.models.layers.drop_path_keep`), drawn
        from ``generator`` when not given."""
        if self.training:
            return self._train_forward(x, plain, generator, keep)
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad
                                       for p in self.parameters())):
            return self._eval_graph_forward(x, plain)
        taps, pk = self.prepared(x.dtype, x.device)
        y = run_taps(x, taps, plain)
        mlp = fused_mlp_plain if plain else fused_mlp
        return mlp(y, x, pk, channel_dim=1)

    def _eval_graph_forward(self, x, plain):
        """The eval block with autograd: the fold and the packing in the
        graph (never cached), the taps rounded to x's dtype as
        :meth:`prepared` rounds them, the folded bias into ``FusedMlp`` as
        its ``pre_bias``."""
        taps, bias = self.large_kernel.eval_taps()
        taps = [t.to(x.dtype).float() for t in taps]
        y = run_taps(x, taps, plain)
        gamma = getattr(self, "gamma", None)
        if gamma is None:
            gamma = torch.ones_like(self.norm.weight)
        return FusedMlp.apply(y, x, self.norm.weight, self.norm.bias,
                              self.pwconv1.weight, self.pwconv1.bias,
                              self.pwconv2.weight, self.pwconv2.bias, gamma,
                              True, plain, bias)

    def _train_forward(self, x, plain, generator, keep=None):
        """``_block_forward(train=True)``: the branches, then the fused tail
        (C <= 256, or wider with :data:`TRAIN_WIDE_MLP_BWD`) or the plain
        composition in the same rounding order
        (slak_tpu/models/slak.py:702-715); drop-path multiplies the branch
        outside the fused tail."""
        group = None
        if self.bn_axis_name is not None:
            from slak_tpu_torch.parallel.mesh import axis_group
            group = axis_group(self.bn_axis_name)
        y = self.large_kernel.train_forward(x, plain, group)
        rate = self.drop_path_rate
        gamma = getattr(self, "gamma", None)
        if x.shape[1] <= BWD_C_MAX or TRAIN_WIDE_MLP_BWD:
            if gamma is None:
                gamma = torch.ones_like(self.norm.weight)
            args = (y, x, self.norm.weight, self.norm.bias,
                    self.pwconv1.weight, self.pwconv1.bias,
                    self.pwconv2.weight, self.pwconv2.bias, gamma)
            if rate > 0.0:
                branch = FusedMlp.apply(*args, False, plain)
                return x + drop_path(branch, rate, generator, train=True,
                                     keep=keep)
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
        h = drop_path(h.permute(0, 3, 1, 2), rate, generator, train=True,
                      keep=keep)
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
            b.bn_axis_name = cfg.bn_axis_name
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

    def _stage_dual_ok(self, i: int, x: torch.Tensor) -> bool:
        """Whether stage i runs dual (``_stage_resident_ok``'s structural
        conditions): eval, ``eval_layout="dual"``, no graph being recorded,
        and every block a BN'd LoRA1 (K, s) + LoRA2 (s, K) pair, K > s,
        with at most a BN'd small branch that fits inside LoRA1. The JAX
        gate's TPU conditions are dropped: K >= 31 (the banded kernels'
        MXU break-even), the batch blocks of 128 lanes, running on a TPU,
        and ``fused_mlp_ok``'s VMEM budget for the MLP weights."""
        if self.training or self.cfg.eval_layout != "dual":
            return False
        blocks = self.stages[i]
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for p in blocks.parameters())):
            return False
        for blk in blocks:
            lk = blk.large_kernel
            names = {n for n in ("LoRA1", "LoRA2", "lkb_origin",
                                 "small_conv", "lkb_reparam")
                     if hasattr(lk, n)}
            if not {"LoRA1", "LoRA2"} <= names or \
                    names - {"LoRA1", "LoRA2", "small_conv"}:
                return False
            if not all(hasattr(b, "bn") for b in lk.branches()):
                return False
            kh, kw = lk.LoRA1.conv.weight.shape[-2:]
            if kw >= kh or tuple(lk.LoRA2.conv.weight.shape[-2:]) != (kw, kh):
                return False
            if hasattr(lk, "small_conv"):
                sh, sw = lk.small_conv.conv.weight.shape[-2:]
                if sh > kh or sw > kw:
                    return False
        return True

    def _stage_forward_dual(self, i: int, x: torch.Tensor,
                            plain: bool) -> torch.Tensor:
        """A dual eval stage (``_stage_forward_dual``): one H<->W copy in,
        then K10 (``dualboth``, raw pair) and K12 a block; oh out."""
        pair = dwpair_plain if plain else dwpair
        mlp = fused_mlp_dual_plain if plain else fused_mlp_dual
        blocks = self.stages[i]
        xh = x.contiguous()
        xq = xh.transpose(2, 3).contiguous()
        for j, blk in enumerate(blocks):
            (w1, w2), pk = blk.prepared(x.dtype, x.device)
            y1, y2 = pair(xh, w1, w2, "dualboth", xq=xq, sum_out=False)
            xh, xq = mlp(y1, y2, xh, pk, emit_q=j < len(blocks) - 1)
            del y1, y2
        return xh

    @staticmethod
    def _remat_block(blk: Block, x, plain, generator):
        """One train block under ``torch.utils.checkpoint`` (non-reentrant):
        the recompute in the backward must give the first pass's values
        and leave the state as the first pass left it. So the drop-path
        draw is made here, once, and handed to both passes (the
        checkpoint restores torch's default generators, not the step's
        explicit one), and the recompute leaves the BN running stats
        alone (the first pass updated them; both normalize by the
        batch's statistics)."""
        keep = None
        if blk.drop_path_rate > 0.0:
            keep = drop_path_keep(x.shape[0], blk.drop_path_rate, generator,
                                  x.device)
        passes = []

        def run(x):
            with running_stats_frozen(bool(passes)):
                passes.append(None)
                return blk(x, plain, generator, keep)

        return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)

    def forward_features(self, x, plain: bool = False, generator=None,
                         return_stages: bool = False):
        """NCHW images in the compute dtype -> pooled, normed features, or
        with ``return_stages`` the list of the four stage outputs (NCHW),
        as ``slak_tpu`` ``forward_features(return_stages=True)``."""
        stages = []
        for i in range(4):
            ds = self.downsample_layers[i]
            if i == 0:
                x = ds[1](_conv(x, ds[0]))
            else:
                x = _conv(ds[0](x), ds[1])
            if self._stage_dual_ok(i, x):
                x = self._stage_forward_dual(i, x, plain)
            elif self.training and self.cfg.remat and \
                    torch.is_grad_enabled():
                for blk in self.stages[i]:
                    x = self._remat_block(blk, x, plain, generator)
            else:
                for blk in self.stages[i]:
                    x = blk(x, plain, generator)
            stages.append(x)
        if return_stages:
            return stages
        return self._pool(x)

    def _pool(self, x):
        return layer_norm(x.mean((2, 3)), self.norm.weight, self.norm.bias)

    def _head(self, feats):
        return (feats.float() @ self.head.weight.to(feats.dtype).float().t()
                + self.head.bias.float())

    def stage4_logits(self, x):
        """Stage 4's output (NCHW) -> (N, num_classes) float32 logits, as
        ``forward`` ends: the mean pool and LN in the compute dtype, the
        head in float32 (the KD step's student and teacher logits)."""
        return self._head(self._pool(x))

    def forward(self, x, plain: bool = False, generator=None):
        """NCHW images -> (N, num_classes) float32 logits. In eval no graph
        is recorded; in train mode ``generator`` draws the drop-path
        masks."""
        if not self.training:
            with torch.no_grad():
                return self._logits(x, plain, None)
        return self._logits(x, plain, generator)

    def _logits(self, x, plain, generator):
        return self._head(self.forward_features(x, plain, generator))


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
