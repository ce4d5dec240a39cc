"""K1/K4: same-padded stride-1 depthwise conv with rectangular taps (NCHW),
and its autograd Functions (eval and train).

Kernel: ``csrc/dwconv.cu`` (replaces ``slak_tpu/ops/pallas_banded.py``
``dwconv_banded_cmajor`` and, with the BN-sum epilogue,
``dwconv_banded_stats_cmajor``). :func:`dwconv` and :func:`dwconv_stats`
launch it for CUDA tensors and run :func:`dwconv_plain` /
:func:`dwconv_stats_plain` for CPU tensors.

:class:`DwconvTaps` is the differentiable eval conv (the counterpart of
``depthwise_conv2d_banded``'s custom VJP): ``sum_i conv(x, taps_i)`` as
K1 launches into one output; backward = K1 on each tap tensor flipped on
both axes, the launches adding into one dx, and the tap gradients from the
``ops/dwconv_wgrad.py`` kernel where they are asked for.

:class:`DwconvBnStats` is the counterpart of
``depthwise_conv2d_banded_stats`` / ``dwconv_banded_stats_cmajor_vjp``:
forward = K4 (y, sum y, sum y^2); backward = the sums' cotangents folded
into ``dy_eff = dy + ds1 + 2 y ds2`` (rounded to the compute dtype), dgrad =
K1 with the taps flipped on both axes, wgrad = the
``ops/dwconv_wgrad.py`` kernel.

Taps are ``(C, kh, kw)`` float32, already rounded to the compute dtype by
the caller (``models/slak.py`` folds and rounds them once per model), so
the kernel and the plain version multiply the same values. Both accumulate
in fp32 and round once on the store; with ``out`` given the result is added
to ``out`` in place -- the second branch of the decomposed pair adds into
the first one's output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

launch_count = 0               # K1 launches (forward and dgrad)
stats_launch_count = 0         # K4 launches (the stats variant)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, w: torch.Tensor, out: Optional[torch.Tensor]):
    if x.ndim != 4 or w.ndim != 3:
        raise ValueError(f"want x (N,C,H,W) and w (C,kh,kw), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"channel mismatch {tuple(x.shape)} vs "
                         f"{tuple(w.shape)}")
    if w.shape[1] % 2 != 1 or w.shape[2] % 2 != 1:
        raise ValueError(f"taps must be odd, got {tuple(w.shape[1:])}")
    if w.dtype != torch.float32:
        raise TypeError(f"taps must be float32, got {w.dtype}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("out must match x in shape, dtype and device")


def dwconv_plain(x: torch.Tensor, w: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: fp32 grouped conv on the input's values, one rounding
    to x.dtype (after the add into ``out`` when given)."""
    _check(x, w, out)
    kh, kw = w.shape[1], w.shape[2]
    y = F.conv2d(x.float(), w[:, None], padding=(kh // 2, kw // 2),
                 groups=x.shape[1])
    if out is None:
        return y.to(x.dtype)
    out.copy_(out.float() + y)
    return out


def dwconv_stats_plain(x: torch.Tensor, w: torch.Tensor):
    """Plain version of the stats variant: (y, s1, s2) with s1, s2 the fp32
    per-channel sums of the rounded y and y^2 over (N, H, W)."""
    y = dwconv_plain(x, w)
    yf = y.float()
    return y, yf.sum((0, 2, 3)), yf.square().sum((0, 2, 3))


@functools.lru_cache(maxsize=None)
def _entry():
    from slak_tpu_torch.ops._build import load
    fn = load("dwconv").slak_dwconv
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _stats_entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwconv")
    scratch = lib.slak_dwconv_stats_scratch
    scratch.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    fn = lib.slak_dwconv_stats
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return scratch, fn


def _check_cuda(name, x, w, out=None):
    _check(x, w, out)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if w.device != x.device:
        raise ValueError("taps and input on different devices")
    if not (x.is_contiguous() and w.is_contiguous()
            and (out is None or out.is_contiguous())):
        raise ValueError(f"{name} needs contiguous tensors")


def dwconv_stats(x: torch.Tensor, w: torch.Tensor):
    """(conv(x, w), s1, s2): the conv and the fp32 per-channel sums of its
    stored output and of the output's square over (N, H, W)."""
    if x.device.type == "cpu":
        return dwconv_stats_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv_stats runs on cuda or cpu, not {x.device}")
    _check_cuda("dwconv_stats", x, w)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    scratch_fn, fn = _stats_entries()
    n_part = scratch_fn(N, C, H, W, kh, kw)
    if n_part < 0:
        raise RuntimeError(f"dwconv_stats: no tile fits {tuple(x.shape)} "
                           f"with taps {(kh, kw)}")
    out = torch.empty_like(x)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device)
    sums = torch.empty(2, C, dtype=torch.float32, device=x.device)
    err = fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
             part.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
             N, C, H, W, kh, kw,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwconv_stats kernel launch failed: cudaError "
                           f"{err}")
    global stats_launch_count
    stats_launch_count += 1
    return out, sums[0], sums[1]


def dwconv(x: torch.Tensor, w: torch.Tensor,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv(x, w) (+ out, in place, when given). x: (N, C, H, W) float32 or
    bfloat16, contiguous; w: (C, kh, kw) float32."""
    if x.device.type == "cpu":
        return dwconv_plain(x, w, out)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv runs on cuda or cpu, not {x.device}")
    _check_cuda("dwconv", x, w, out)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    accumulate = out is not None
    if out is None:
        out = torch.empty_like(x)
    err = _entry()(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
             N, C, H, W, kh, kw, int(accumulate),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwconv kernel launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
    return out


def conv_taps(x: torch.Tensor, taps, plain: bool = False) -> torch.Tensor:
    """sum_i conv(x, taps_i): one K1 launch per tap tensor, all adding into
    one output. ``plain`` runs the plain version on any device."""
    conv = dwconv_plain if plain else dwconv
    y = conv(x, taps[0])
    for t in taps[1:]:
        y = conv(x, t, out=y)
    return y


class DwconvTaps(torch.autograd.Function):
    """``sum_i conv(x, taps_i)`` with its backward: ``apply(x, plain,
    *taps)``. x: (N, C, H, W) in the compute dtype; taps: (C, kh, kw)
    float32 each, already rounded to the compute dtype (the eval fold's).
    dx = sum_i conv(dy, flip(taps_i)) in x's dtype; each tap gradient
    (float32) only where ``needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, x, plain, *taps):
        x = x.contiguous()
        taps = [t.contiguous() for t in taps]
        ctx.save_for_backward(x, *taps)
        ctx.plain = plain
        return conv_taps(x, taps, plain)

    @staticmethod
    def backward(ctx, dy):
        from slak_tpu_torch.ops.dwconv_wgrad import (dwconv_wgrad,
                                                     dwconv_wgrad_plain)
        x, *taps = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = conv_taps(dy, [t.flip(1, 2).contiguous() for t in taps],
                           ctx.plain)
        wgrad = dwconv_wgrad_plain if ctx.plain else dwconv_wgrad
        dtaps = [wgrad(x, dy, *t.shape[1:]) if need else None
                 for t, need in zip(taps, ctx.needs_input_grad[2:])]
        return (dx, None, *dtaps)


class DwconvBnStats(torch.autograd.Function):
    """(y, s1, s2) = (conv(x, w), sum y, sum y^2) with the train backward.

    x: (N, C, H, W) in the compute dtype; w: the branch's (C, 1, kh, kw)
    float32 weight, rounded to the compute dtype for the products (the
    JAX kernels' ``build_banded(w).astype(x.dtype)``); its gradient comes
    back in float32. ``plain`` runs the plain versions on any device."""

    @staticmethod
    def forward(ctx, x, w, plain=False):
        taps = w[:, 0].to(x.dtype).float().contiguous()
        x = x.contiguous()
        y, s1, s2 = (dwconv_stats_plain if plain else dwconv_stats)(x, taps)
        ctx.save_for_backward(x, taps, y)
        ctx.plain = plain
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        from slak_tpu_torch.ops.dwconv_wgrad import (dwconv_wgrad,
                                                     dwconv_wgrad_plain)
        x, taps, y = ctx.saved_tensors
        g = (torch.zeros_like(y, dtype=torch.float32) if dy is None
             else dy.float())
        if ds1 is not None:
            g += ds1[:, None, None]
        if ds2 is not None:
            g.addcmul_(y.float(), ds2[:, None, None], value=2.0)
        g = g.to(y.dtype).contiguous()
        kh, kw = taps.shape[1:]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            flipped = taps.flip(1, 2).contiguous()
            dx = (dwconv_plain if ctx.plain else dwconv)(g, flipped)
        if ctx.needs_input_grad[1]:
            wgrad = dwconv_wgrad_plain if ctx.plain else dwconv_wgrad
            dw = wgrad(x, g, kh, kw)[:, None]
        return dx, dw, None
