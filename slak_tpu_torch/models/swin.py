"""Swin Transformer (tiny) KD teacher: port of ``slak_tpu/models/swin.py``
(the reference's ``swin_tiny_patch4_window7_224`` teacher,
main_KD.py:413-449) under timm's names (``patch_embed.{proj, norm}``,
``layers.i.blocks.j.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.i.downsample.{norm, reduction}``, ``norm``, ``head``).

Windowed attention with the relative position bias (its index a
non-persistent buffer, recomputed), shifted windows on odd blocks only
where the map is larger than the window (``swin.py:162-163``), with the
-100 mask across the shifted windows' boundaries (``:113-131``). The patch
merge concatenates the 2 x 2 neighbours in timm's order (h0w0, h1w0, h0w1,
h1w1), so a timm state_dict loads unpermuted; the JAX package concatenates
(h0w0, h0w1, h1w0, h1w1) and permutes the merge's parameters when it
converts (``utils/convert_teachers.py``). The feature is the final 7 x 7
map before the last norm.
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
from slak_tpu_torch.models.zoo import Teacher, dense, matmul

NAMES = ("swin_tiny_patch4_window7_224",)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    img_size: int = 224
    drop_path_rate: float = 0.0


def rel_bias_index(window: int) -> torch.Tensor:
    """(w^2, w^2) index into the (2w - 1)^2 bias table (``_rel_bias_index``,
    timm's ``relative_position_index``)."""
    ar = torch.arange(window)
    coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    return rel[0] * (2 * window - 1) + rel[1]


def shift_mask(h: int, w: int, window: int, shift: int,
               device=None) -> torch.Tensor:
    """(windows, w^2, w^2): -100 between tokens of different regions of
    the shifted map, else 0."""
    img = torch.zeros((h, w), dtype=torch.int64, device=device)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(h // window, window, w // window, window)
    mw = mw.permute(0, 2, 1, 3).reshape(-1, window * window)
    return torch.where(mw[:, :, None] != mw[:, None, :], -100.0, 0.0)


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             rel_bias_index(window), persistent=False)
        self.heads, self.window = heads, window

    def forward(self, x, shift: int):
        """x: (N, H, W, C), H and W multiples of the window."""
        n, h, w, c = x.shape
        win, heads = self.window, self.heads
        hd = c // heads
        if shift:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        xw = x.reshape(n, h // win, win, w // win, win, c)
        xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
        b = xw.shape[0]
        qkv = dense(xw, self.qkv).reshape(b, -1, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        att = torch.matmul(q.float(), k.float().transpose(-2, -1)) \
            / math.sqrt(hd)
        bias = self.relative_position_bias_table[self.relative_position_index]
        att = att + bias.permute(2, 0, 1)[None]
        if shift:
            am = shift_mask(h, w, win, shift, x.device)
            nw = am.shape[0]
            att = att.reshape(n, nw, heads, win * win, -1) + am[None, :, None]
            att = att.reshape(-1, heads, win * win, win * win)
        att = F.softmax(att, dim=-1).to(xw.dtype)
        out = matmul(att, v).transpose(1, 2).reshape(b, -1, c)
        out = dense(out, self.proj)
        out = out.reshape(n, h // win, w // win, win, win, c)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)
        if shift:
            out = torch.roll(out, (shift, shift), (1, 2))
        return out


class _SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, shift: int):
        x = x + self.attn(ln(x, self.norm1), shift)
        y = gelu(dense(ln(x, self.norm2), self.mlp.fc1))
        return x + dense(y, self.mlp.fc2).to(x.dtype)


class _PatchMerge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return dense(ln(x, self.norm), self.reduction)


class Swin(Teacher):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, cfg.patch_size,
                                          cfg.patch_size)
        self.patch_embed.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.layers = nn.ModuleList()
        for i, depth in enumerate(cfg.depths):
            dim = d * 2 ** i
            layer = nn.Module()
            layer.blocks = nn.ModuleList([
                _SwinBlock(dim, cfg.num_heads[i], cfg.window, cfg.mlp_ratio)
                for _ in range(depth)])
            if i < 3:
                layer.downsample = _PatchMerge(dim)
            self.layers.append(layer)
        self.norm = nn.LayerNorm(d * 8, eps=LN_EPS)
        self.head = nn.Linear(d * 8, cfg.num_classes)

    @property
    def feature_channels(self) -> int:
        return self.cfg.embed_dim * 8

    def _reset_extra(self, generator):
        for layer in self.layers:
            for blk in layer.blocks:
                trunc_normal_(blk.attn.relative_position_bias_table, 0.02,
                              generator)

    def forward(self, x):
        """(N, H, W, 3) -> (logits, final feature map (N, h, w, 8C))."""
        cfg = self.cfg
        pe = self.patch_embed
        x = F.conv2d(x.permute(0, 3, 1, 2), pe.proj.weight.to(x.dtype), None,
                     cfg.patch_size)
        x = x + pe.proj.bias.to(x.dtype)[:, None, None]
        x = ln(x.permute(0, 2, 3, 1), pe.norm)
        for i, layer in enumerate(self.layers):
            for j, blk in enumerate(layer.blocks):
                shift = cfg.window // 2 if (j % 2 == 1
                                            and x.shape[1] > cfg.window) \
                    else 0
                x = blk(x, shift)
            if i < 3:
                x = layer.downsample(x)
        feature = x
        pooled = ln(x, self.norm).mean((1, 2))
        logits = dense(pooled, self.head).float()
        return logits, feature


def swin_tiny_patch4_window7_224(**kw) -> Swin:
    return Swin(SwinConfig(**kw))
