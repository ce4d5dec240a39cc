"""CSWin Transformer KD teacher: port of ``slak_tpu/models/cswin.py`` (the
reference's CSWin, cswin.py:246-418) under the official names
(``stage1_conv_embed.{0, 2}``, ``stage{i}.{j}.{norm1, qkv,
attns.{0,1}.get_v, proj, norm2, mlp.fc1, mlp.fc2}``, ``merge{i}.{conv,
norm}``, ``norm``, ``head``).

Cross-shaped window attention: the first half of the heads and channels
attends within vertical stripes (H x split), the second half within
horizontal ones (split x W) (``cswin.py:151-163``); LePE, a depthwise 3x3
conv on V, runs per window with zero padding at the stripe edges
(``:87-118``). The last stage, or any map no larger than the split, takes
full attention (``:146-150``). A block holds two half-width LePE convs
(``attns.0``, ``attns.1``) where its stage's map at the configured image
size is larger than the split, else one (the official layout); the forward
concatenates them into the one full-width LePE that the JAX function
splits as the map at hand asks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from slak_tpu_torch.models.layers import LN_EPS, gelu
from slak_tpu_torch.models.layers import trunc_normal_
from slak_tpu_torch.models.vit import _Mlp, ln
from slak_tpu_torch.models.zoo import Teacher, dense

NAMES = ("cswin_tiny", "cswin_small", "cswin_base")


@dataclasses.dataclass(frozen=True)
class CSWinConfig:
    embed_dim: int = 64
    depths: Tuple[int, ...] = (1, 2, 21, 1)
    split_sizes: Tuple[int, ...] = (1, 2, 7, 7)
    num_heads: Tuple[int, ...] = (2, 4, 8, 16)
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    img_size: int = 224
    drop_path_rate: float = 0.0


def _stripe_attn(q, k, v, lepe_w, lepe_b, heads: int, sh: int, sw: int):
    """Attention within (sh, sw) windows plus LePE; q/k/v (N, H, W, C)."""
    n, h, w, c = q.shape
    hd = c // heads

    def windows(t):
        t = t.reshape(n, h // sh, sh, w // sw, sw, heads, hd)
        return t.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, heads, sh * sw, hd)

    qw, kw, vw = windows(q), windows(k), windows(v)
    att = torch.matmul(qw.float(), kw.float().transpose(-2, -1)) \
        / math.sqrt(hd)
    att = F.softmax(att, dim=-1).to(q.dtype)
    dt = torch.promote_types(att.dtype, vw.dtype)
    out = torch.matmul(att.to(dt), vw.to(dt))
    out = out.reshape(n, h // sh, w // sw, heads, sh, sw, hd)
    out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(n, h, w, c)

    vwin = v.reshape(n, h // sh, sh, w // sw, sw, c)
    vwin = vwin.permute(0, 1, 3, 5, 2, 4).reshape(-1, c, sh, sw)
    lepe = F.conv2d(vwin, lepe_w.to(v.dtype), None, 1, 1, groups=c)
    lepe = lepe + lepe_b.to(lepe.dtype)[:, None, None]
    lepe = lepe.reshape(n, h // sh, w // sw, c, sh, sw)
    lepe = lepe.permute(0, 1, 4, 2, 5, 3).reshape(n, h, w, c)
    return out + lepe


class _LePE(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.get_v = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class _CSWinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, split: int, branches: int,
                 mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.attns = nn.ModuleList([_LePE(dim // branches)
                                    for _ in range(branches)])
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.heads, self.split = heads, split

    def forward(self, x, last_stage: bool):
        n, h, w, c = x.shape
        y = ln(x, self.norm1)
        q, k, v = dense(y, self.qkv).chunk(3, dim=-1)
        lw = torch.cat([a.get_v.weight for a in self.attns], 0)
        lb = torch.cat([a.get_v.bias for a in self.attns], 0)
        if last_stage or h <= self.split:
            out = _stripe_attn(q, k, v, lw, lb, self.heads, h, w)
        else:
            ch, hh = c // 2, self.heads // 2
            o1 = _stripe_attn(q[..., :ch], k[..., :ch], v[..., :ch],
                              lw[:ch], lb[:ch], hh, h, self.split)
            o2 = _stripe_attn(q[..., ch:], k[..., ch:], v[..., ch:],
                              lw[ch:], lb[ch:], hh, self.split, w)
            out = torch.cat([o1, o2], dim=-1)
        x = x + dense(out, self.proj)
        y = gelu(dense(ln(x, self.norm2), self.mlp.fc1))
        return x + dense(y, self.mlp.fc2).to(x.dtype)


class _Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, 2 * dim, 3, 2, 1)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)


class CSWin(Teacher):
    def __init__(self, cfg: CSWinConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.stage1_conv_embed = nn.Sequential(
            nn.Conv2d(3, d, 7, 4, 2), nn.Identity(),
            nn.LayerNorm(d, eps=LN_EPS))
        reso = cfg.img_size // 4
        for i in range(4):
            dim = d * 2 ** i
            last = i == 3 or reso <= cfg.split_sizes[i]
            setattr(self, f"stage{i + 1}", nn.ModuleList([
                _CSWinBlock(dim, cfg.num_heads[i], cfg.split_sizes[i],
                            1 if last else 2, cfg.mlp_ratio)
                for _ in range(cfg.depths[i])]))
            if i < 3:
                setattr(self, f"merge{i + 1}", _Merge(dim))
                reso = (reso + 1) // 2
        self.norm = nn.LayerNorm(d * 8, eps=LN_EPS)
        self.head = nn.Linear(d * 8, cfg.num_classes)

    @property
    def feature_channels(self) -> int:
        return self.cfg.embed_dim * 8

    def _reset_extra(self, generator):
        for i in range(4):
            for blk in getattr(self, f"stage{i + 1}"):
                for a in blk.attns:
                    trunc_normal_(a.get_v.weight, 0.02, generator)

    @staticmethod
    def _conv(x, conv: nn.Conv2d):
        """NHWC conv in x's dtype, the bias cast to it."""
        y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), None,
                     conv.stride, conv.padding)
        return (y + conv.bias.to(y.dtype)[:, None, None]).permute(0, 2, 3, 1)

    def forward(self, x):
        """(N, H, W, 3) -> (logits, final feature map (N, h, w, 8C))."""
        emb = self.stage1_conv_embed
        x = ln(self._conv(x, emb[0]), emb[2])
        for i in range(4):
            for blk in getattr(self, f"stage{i + 1}"):
                x = blk(x, i == 3)
            if i < 3:
                mg = getattr(self, f"merge{i + 1}")
                x = ln(self._conv(x, mg.conv), mg.norm)
        feature = x
        pooled = ln(x, self.norm).mean((1, 2))
        logits = dense(pooled, self.head).float()
        return logits, feature


def cswin_tiny(**kw) -> CSWin:
    return CSWin(CSWinConfig(**kw))


def cswin_small(**kw) -> CSWin:
    kw.setdefault("depths", (2, 4, 32, 2))
    return CSWin(CSWinConfig(**kw))


def cswin_base(**kw) -> CSWin:
    kw.setdefault("embed_dim", 96)
    kw.setdefault("depths", (2, 4, 32, 2))
    kw.setdefault("num_heads", (4, 8, 16, 32))
    return CSWin(CSWinConfig(**kw))
