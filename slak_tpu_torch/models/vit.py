"""Vision Transformer (DeiT-style) KD teacher: port of
``slak_tpu/models/vit.py`` (the reference's ViT / DeiT teacher path,
main_KD.py:413-449) under timm's names (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.i.{norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2}``, ``norm``, ``head``).

Attention is plain torch ops in the JAX function's rounding order: the
scores in float32, the softmax, a cast to the block input's dtype, then
the product with V. The feature is the patch tokens after the final norm,
(N, grid, grid, C), 14 x 14 at 224^2 (``vit.py:124-130``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from slak_tpu_torch.models.layers import LN_EPS, gelu, layer_norm
from slak_tpu_torch.models.layers import trunc_normal_
from slak_tpu_torch.models.zoo import Teacher, dense, matmul

NAMES = ("vit_base_patch16_224", "vit_small_patch16_224",
         "deit_tiny_patch16_224")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    in_chans: int = 3
    img_size: int = 224
    drop_path_rate: float = 0.0

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


def ln(x, norm: nn.LayerNorm):
    return layer_norm(x, norm.weight, norm.bias, LN_EPS)


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.heads = heads

    def forward(self, x):
        n, t, d = x.shape
        hd = d // self.heads
        qkv = dense(x, self.qkv).reshape(n, t, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        att = torch.matmul(q.float(), k.float().transpose(-2, -1)) \
            / math.sqrt(hd)
        att = F.softmax(att, dim=-1).to(x.dtype)
        out = matmul(att, v).transpose(1, 2).reshape(n, t, d)
        return dense(out, self.proj, x.dtype)


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class _Block(nn.Module):
    def __init__(self, d: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = _Attention(d, heads)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = _Mlp(d, hidden)

    def forward(self, tok):
        tok = tok + self.attn(ln(tok, self.norm1))
        h = gelu(dense(ln(tok, self.norm2), self.mlp.fc1))
        return tok + dense(h, self.mlp.fc2).to(tok.dtype)


class ViT(Teacher):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(cfg.in_chans, d, cfg.patch_size,
                                          cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.blocks = nn.ModuleList([
            _Block(d, cfg.num_heads, int(d * cfg.mlp_ratio))
            for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, cfg.num_classes)

    @property
    def feature_channels(self) -> int:
        return self.cfg.embed_dim

    def _reset_extra(self, generator):
        self.cls_token.zero_()
        trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, x):
        """(N, H, W, 3) -> (logits, patch feature (N, gh, gw, C))."""
        cfg = self.cfg
        n = x.shape[0]
        pe = self.patch_embed.proj
        tok = F.conv2d(x.permute(0, 3, 1, 2), pe.weight.to(x.dtype), None,
                       cfg.patch_size)
        tok = tok + pe.bias.to(tok.dtype)[:, None, None]
        tok = tok.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(tok.dtype).expand(n, 1, cfg.embed_dim)
        tok = torch.cat([cls, tok], dim=1) + self.pos_embed.to(tok.dtype)
        for blk in self.blocks:
            tok = blk(tok)
        tok = ln(tok, self.norm)
        logits = dense(tok[:, 0], self.head).float()
        feature = tok[:, 1:].reshape(n, cfg.grid, cfg.grid, cfg.embed_dim)
        return logits, feature


def vit_base_patch16_224(**kw) -> ViT:
    return ViT(ViTConfig(**kw))


def vit_small_patch16_224(**kw) -> ViT:
    kw.setdefault("embed_dim", 384)
    kw.setdefault("num_heads", 6)
    return ViT(ViTConfig(**kw))


def deit_tiny_patch16_224(**kw) -> ViT:
    kw.setdefault("embed_dim", 192)
    kw.setdefault("num_heads", 3)
    return ViT(ViTConfig(**kw))
