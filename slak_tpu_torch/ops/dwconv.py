"""K1: same-padded stride-1 depthwise conv with rectangular taps (NCHW).

Kernel: ``csrc/dwconv.cu`` (replaces ``slak_tpu/ops/pallas_banded.py``
``dwconv_banded_cmajor``). :func:`dwconv` launches it for CUDA tensors and
runs :func:`dwconv_plain` for CPU tensors.

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

launch_count = 0

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


@functools.lru_cache(maxsize=None)
def _entry():
    from slak_tpu_torch.ops._build import load
    fn = load("dwconv").slak_dwconv
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dwconv(x: torch.Tensor, w: torch.Tensor,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv(x, w) (+ out, in place, when given). x: (N, C, H, W) float32 or
    bfloat16, contiguous; w: (C, kh, kw) float32."""
    if x.device.type == "cpu":
        return dwconv_plain(x, w, out)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv runs on cuda or cpu, not {x.device}")
    _check(x, w, out)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwconv takes float32 or bfloat16, not {x.dtype}")
    if w.device != x.device:
        raise ValueError("taps and input on different devices")
    if not (x.is_contiguous() and w.is_contiguous()
            and (out is None or out.is_contiguous())):
        raise ValueError("dwconv needs contiguous tensors")
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
