"""Tensor (channel) parallel eval: port of ``slak_tpu/parallel/tp.py``.

Beyond the reference, which only data-parallels: the channel axis of one
eval forward is split over the ranks of a process group, so that every
rank holds a slice of the weights and of each activation. Activations are
NCHW, so a channel shard is a contiguous block of every image.

Mapping (the Megatron recipe, adapted to a ConvNet whose depthwise convs
are channel-local):

  * the depthwise large-kernel pair and its folded branch BNs: local, no
    communication (the eval fold of ``ops/depthwise.py`` on the shard's
    branches, then K1 on its band route, or on K6's Toeplitz kernel on
    stage 4's 7x7 maps, at the shard's width);
  * LayerNorm over channels: per-token sums of x and x^2 all-reduced (one
    call for both), normalized by the REAL width;
  * the block MLP: ``all_gather`` of the LN output to (N, C, H, W),
    pwconv1 column-sharded, GELU local, pwconv2 row-sharded, an
    all-reduce, and the rank keeps its own C/D slice for the residual (the
    all-reduce + slice form rather than ``reduce_scatter``, which gloo
    lacks); the products are ``torch.matmul``, as the JAX module computes
    them with ``jnp.dot`` outside any Pallas kernel;
  * downsample convs: contraction (input channels) sharded, an all-reduce,
    the rank's slice; the stem conv output-sharded (its input is the
    replicated image);
  * head: contraction-sharded, an all-reduce.

Widths that do not divide the group (SLaK-T at width 1.3: 124 / 249 / 499 /
998) are zero-padded up to a multiple of it (:func:`pad_for_tp`): LN
scale/bias and every tap, bias and affine pad with 0, the BN running
variance with 1 (the fold stays finite and its multiplier is 0), so the pad
lanes are exactly 0 at every layer and every cross-channel reduction,
normalized by the real width, is unchanged. Eval only (the running stats
are read, never written).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from slak_tpu_torch.models.layers import LN_EPS, gelu
from slak_tpu_torch.ops.batchnorm import BN_EPS, fold_bn
from slak_tpu_torch.ops.depthwise import fold_branches, run_taps
from slak_tpu_torch.parallel.mesh import all_gather_cat

BRANCHES = ("LoRA1", "LoRA2", "lkb_origin", "small_conv")


def _round_up(n: int, d: int) -> int:
    return -(-n // d) * d


def _pad_dims(t: torch.Tensor, dims, d: int, value: float = 0.0
              ) -> torch.Tensor:
    pad = [0] * (2 * t.ndim)
    for dim in dims:
        pad[2 * (t.ndim - 1 - dim) + 1] = _round_up(t.shape[dim], d) \
            - t.shape[dim]
    if not any(pad):
        return t
    return F.pad(t, pad, value=value)


def _is_downsample_conv(name: str) -> bool:
    """The 2x2 convs of downsample layers 1-3 (layer 0's ``.1`` is the
    stem's LayerNorm)."""
    return name.startswith("downsample_layers.") and \
        name.endswith(".1.weight") and \
        not name.startswith("downsample_layers.0.")


def pad_for_tp(sd: Dict[str, torch.Tensor], d: int
               ) -> Dict[str, torch.Tensor]:
    """The state dict with every channel axis zero-padded up to a multiple
    of ``d``; BN running variances pad with 1. The stem's RGB input and
    the head's classes stay as they are."""
    out = {}
    for name, t in sd.items():
        if t.ndim == 0:
            dims = ()
        elif name == "head.weight":
            dims = (1,)
        elif name == "head.bias":
            dims = ()
        elif name.endswith(("pwconv1.weight", "pwconv2.weight")):
            dims = (0, 1)
        elif _is_downsample_conv(name):
            dims = (0, 1)
        else:             # depthwise / stem conv weights, per-channel vectors
            dims = (0,)
        out[name] = _pad_dims(t, dims, d, 1.0 if name.endswith(
            "running_var") else 0.0)
    return out


def shard_state(sd: Dict[str, torch.Tensor], d: int, r: int
                ) -> Dict[str, torch.Tensor]:
    """Rank ``r``'s slices of a padded state dict: pwconv1 by output rows,
    pwconv2, the downsample convs and the head by input channels, every
    other channel axis (depthwise taps, the stem's output, per-channel
    vectors) by channel."""
    out = {}
    for name, t in sd.items():
        if t.ndim == 0 or name == "head.bias":
            out[name] = t
            continue
        dim = 1 if (name in ("head.weight",)
                    or name.endswith("pwconv2.weight")
                    or _is_downsample_conv(name)) else 0
        n = t.shape[dim] // d
        out[name] = t.narrow(dim, r * n, n).contiguous()
    return out


def _cvec(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


class TpApply:
    """The channel-sharded eval forward of ``model`` on this rank:
    ``tp(x_nhwc) -> (N, num_classes)`` float32 logits, every rank of
    ``group`` calling it with the same images; the compute dtype is the
    images'. The weights are read, padded and sliced when it is built.
    ``plain`` runs the kernels' plain versions on any device."""

    def __init__(self, model, group=None, plain: bool = False):
        self.cfg = model.cfg
        self.group = dist.group.WORLD if group is None else group
        self.d = dist.get_world_size(self.group)
        self.r = dist.get_rank(self.group)
        self.plain = plain
        with torch.no_grad():
            sd = {k: v.detach() for k, v in model.state_dict().items()}
            self.sd = shard_state(pad_for_tp(sd, self.d), self.d, self.r)
        self._folds: Dict[torch.dtype, List] = {}

    def _fold(self, dtype) -> List[Tuple[List[torch.Tensor],
                                         Optional[torch.Tensor]]]:
        """Per block (stage order): the shard's folded taps rounded to
        ``dtype`` (as ``Block.prepared`` rounds them) and the summed bias."""
        if dtype in self._folds:
            return self._folds[dtype]
        sd, out = self.sd, []
        with torch.no_grad():
            for i, depth in enumerate(self.cfg.depths):
                for j in range(depth):
                    p = f"stages.{i}.{j}.large_kernel."
                    if p + "lkb_reparam.weight" in sd:
                        taps = [sd[p + "lkb_reparam.weight"][:, 0]]
                        bias = sd[p + "lkb_reparam.bias"]
                    else:
                        ws, scales, biases = [], [], []
                        for b in BRANCHES:
                            if p + b + ".conv.weight" not in sd:
                                continue
                            ws.append(sd[p + b + ".conv.weight"][:, 0])
                            if p + b + ".bn.weight" in sd:
                                m, a = fold_bn(
                                    sd[p + b + ".bn.weight"],
                                    sd[p + b + ".bn.bias"],
                                    sd[p + b + ".bn.running_mean"],
                                    sd[p + b + ".bn.running_var"], BN_EPS)
                            else:
                                m, a = None, sd.get(p + b + ".conv.bias")
                            scales.append(m)
                            biases.append(a)
                        taps, bias = fold_branches(ws, scales, biases)
                    out.append(([t.to(dtype).float().contiguous()
                                 for t in taps], bias))
        self._folds[dtype] = out
        return out

    def _layer_norm(self, x, scale, bias, c_full):
        """LN over dim 1 (the full channel axis) from this shard: the
        per-token sums all-reduced, normalized by the real width."""
        xf = x.float()
        m = torch.stack([xf.sum(1), xf.square().sum(1)], 1)
        dist.all_reduce(m, group=self.group)
        mu = m[:, 0:1] / c_full
        var = m[:, 1:2] / c_full - mu.square()
        y = (xf - mu) * torch.rsqrt(var + LN_EPS)
        y = y * _cvec(scale.float(), x.ndim) + _cvec(bias.float(), x.ndim)
        return y.to(x.dtype)

    def _local(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        n = full.shape[dim] // self.d
        return full.narrow(dim, self.r * n, n)

    def _block(self, x, i, j, taps, lk_bias, c_full):
        sd, p, dt = self.sd, f"stages.{i}.{j}.", x.dtype
        y = run_taps(x, taps, self.plain)
        if lk_bias is not None:
            y = y + _cvec(lk_bias.to(dt), 4)
        h = self._layer_norm(y, sd[p + "norm.weight"], sd[p + "norm.bias"],
                             c_full)
        h = all_gather_cat(h, 1, self.group).permute(0, 2, 3, 1)
        a = torch.matmul(h, sd[p + "pwconv1.weight"].to(dt).t()) \
            + sd[p + "pwconv1.bias"].to(dt)
        g = gelu(a)
        o = torch.matmul(g.float(), sd[p + "pwconv2.weight"].to(dt).float()
                         .t())
        dist.all_reduce(o, group=self.group)
        o = self._local(o, 3).to(dt) + sd[p + "pwconv2.bias"].to(dt)
        if p + "gamma" in sd:
            o = o * sd[p + "gamma"].to(dt)
        return (x + o.permute(0, 3, 1, 2)).contiguous()

    def _downsample(self, x, i):
        sd, p, dims = self.sd, f"downsample_layers.{i}.", \
            self.cfg.widened_dims
        dt = x.dtype
        if i == 0:
            x = F.conv2d(x, sd[p + "0.weight"].to(dt), None, 4) \
                + _cvec(sd[p + "0.bias"].to(dt), 4)
            return self._layer_norm(x, sd[p + "1.weight"], sd[p + "1.bias"],
                                    dims[0])
        x = self._layer_norm(x, sd[p + "0.weight"], sd[p + "0.bias"],
                             dims[i - 1])
        o = F.conv2d(x, sd[p + "1.weight"].to(dt), None, 2).float()
        dist.all_reduce(o, group=self.group)
        return (self._local(o, 1).to(dt)
                + _cvec(sd[p + "1.bias"].to(dt), 4)).contiguous()

    @torch.no_grad()
    def forward_features(self, x_nchw: torch.Tensor,
                         return_stages: bool = False):
        """NCHW images (replicated) -> the pooled, normed features' shard,
        or with ``return_stages`` the four stage outputs' shards."""
        dims = self.cfg.widened_dims
        folds = iter(self._fold(x_nchw.dtype))
        x, stages = x_nchw, []
        for i, depth in enumerate(self.cfg.depths):
            x = self._downsample(x, i)
            for j in range(depth):
                taps, bias = next(folds)
                x = self._block(x, i, j, taps, bias, dims[i])
            stages.append(x)
        if return_stages:
            return stages
        return self._layer_norm(x.mean((2, 3)), self.sd["norm.weight"],
                                self.sd["norm.bias"], dims[-1])

    @torch.no_grad()
    def __call__(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        feats = self.forward_features(
            x_nhwc.permute(0, 3, 1, 2).contiguous())
        w = self.sd["head.weight"].to(feats.dtype).float()
        logits = feats.float() @ w.t()
        dist.all_reduce(logits, group=self.group)
        return logits + self.sd["head.bias"].float()


def make_tp_apply(model, group=None, plain: bool = False) -> TpApply:
    """The channel-sharded eval forward of ``model`` over ``group`` (the
    world when None): ``fn(x_nhwc) -> logits``, as ``slak_tpu``'s
    ``make_tp_apply(model, mesh)(params, state, x)``; widths that do not
    divide the group are zero-padded (:func:`pad_for_tp`, exact)."""
    return TpApply(model, group, plain)
