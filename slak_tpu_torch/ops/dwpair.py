"""K10: the decomposed large-kernel pair in one pass over x (NCHW).

Kernel: ``csrc/dwpair.cu`` (replaces ``slak_tpu/ops/pallas_banded.py``
``dwpair_fused_cmajor`` and its four mode kernels). :func:`dwpair` launches
it for CUDA tensors and runs :func:`dwpair_plain` for CPU tensors.

``y = conv(x, w1) + conv(x, w2)``, both stride 1 and same-padded, with w1
the (K, s) taps (LoRA1, the small branch folded in) and w2 the (s, K) taps
(LoRA2), both ``(C, kh, kw)`` float32 already rounded to the compute dtype.
The four TPU modes (``tmode``) are a 2 x 2 choice:

  ``kernel``    branch 2 reads x with the (s, K) taps; summed output;
  ``input``     branch 2 reads ``xq`` (x with H and W swapped, (N, C, W, H)
                contiguous; made here when not given) with the transposed
                (K, s) taps; summed output;
  ``dualout``   as ``kernel``, but with ``sum_out=False`` branch 2 is
                written in the q orientation;
  ``dualboth``  as ``input``, and with ``sum_out=False`` the raw pair.

With ``sum_out=False`` a dual-out mode returns ``(y1 (N, C, H, W), y2 (N,
C, W, H))`` unsummed -- the dual eval stage's MLP kernel adds them; the
single-out modes ignore it, as the JAX function does. Rounding follows
``_pair_body``: each branch accumulates in fp32 and is rounded to the
compute dtype, and the two are added in the compute dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

pair_launch_count = 0       # K10 launches

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# tmode -> (dual input stream, dual output stream), pallas_banded._PAIR_MODES
MODES = {"kernel": (False, False), "input": (True, False),
         "dualout": (False, True), "dualboth": (True, True)}


def _check(x, w1, w2, tmode, xq):
    if tmode not in MODES:
        raise ValueError(f"tmode must be one of {sorted(MODES)}, got "
                         f"{tmode!r}")
    if x.ndim != 4 or w1.ndim != 3 or w2.ndim != 3:
        raise ValueError(f"want x (N,C,H,W), w1 (C,K,s), w2 (C,s,K); got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    c, K, s = w1.shape
    if x.shape[1] != c or tuple(w2.shape) != (c, s, K):
        raise ValueError(f"w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} "
                         f"are not a (K, s) / (s, K) pair for "
                         f"{tuple(x.shape)}")
    if K % 2 != 1 or s % 2 != 1 or K < s:
        raise ValueError(f"taps must be odd with K >= s, got ({K}, {s})")
    if w1.dtype != torch.float32 or w2.dtype != torch.float32:
        raise TypeError("taps must be float32")
    n, _, h, w = x.shape
    if xq is not None and (tuple(xq.shape) != (n, c, w, h)
                           or xq.dtype != x.dtype
                           or xq.device != x.device):
        raise ValueError(f"xq must be x with H and W swapped, "
                         f"{(n, c, w, h)} {x.dtype}; got {tuple(xq.shape)} "
                         f"{xq.dtype}")


def dwpair_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 tmode: str = "kernel", xq: Optional[torch.Tensor] = None,
                 sum_out: bool = True):
    """Plain version: each branch an fp32 grouped conv of the input's values
    rounded to x.dtype, branch 2 on ``xq`` with the transposed taps in the
    dual-in modes; the sum in x.dtype."""
    _check(x, w1, w2, tmode, xq)
    dual_in, dual_out = MODES[tmode]
    c, K, s = w1.shape
    dt = x.dtype
    y1 = F.conv2d(x.float(), w1[:, None], padding=(K // 2, s // 2),
                  groups=c).to(dt)
    if dual_in:
        if xq is None:
            xq = x.transpose(2, 3).contiguous()
        y2q = F.conv2d(xq.float(), w2.transpose(1, 2)[:, None],
                       padding=(K // 2, s // 2), groups=c).to(dt)
    else:
        y2q = F.conv2d(x.float(), w2[:, None], padding=(s // 2, K // 2),
                       groups=c).to(dt).transpose(2, 3)
    if dual_out and not sum_out:
        return y1, y2q.contiguous()
    return y1 + y2q.transpose(2, 3)


@functools.lru_cache(maxsize=None)
def _entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwpair")
    ok = lib.slak_dwpair_ok
    ok.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 7
    ok.restype = ctypes.c_int
    fn = lib.slak_dwpair
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return ok, fn


def dwpair(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           tmode: str = "kernel", xq: Optional[torch.Tensor] = None,
           sum_out: bool = True):
    """The pair in one launch: y, or with a dual-out ``tmode`` and
    ``sum_out=False`` the raw pair (y1, y2 in the q orientation). x (and
    xq): float32 or bfloat16, contiguous; w1, w2: float32."""
    if x.device.type == "cpu":
        return dwpair_plain(x, w1, w2, tmode, xq, sum_out)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwpair runs on cuda or cpu, not {x.device}")
    _check(x, w1, w2, tmode, xq)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwpair takes float32 or bfloat16, not {x.dtype}")
    dual_in, dual_out = MODES[tmode]
    raw = dual_out and not sum_out
    if dual_in and xq is None:
        xq = x.transpose(2, 3).contiguous()
    tensors = [x, w1, w2] + ([xq] if dual_in else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("dwpair: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dwpair needs contiguous tensors")
    n, c, h, w = x.shape
    K, s = w1.shape[1:]
    ok, fn = _entries()
    if not ok(n, c, h, w, K, s, int(dual_in), int(raw)):
        raise ValueError(f"dwpair: taps ({K}, {s}) on {tuple(x.shape)} do "
                         f"not fit the kernel (s in 3/5/7 and a row tile of "
                         f"the map in 96 KB of shared memory)")
    y = torch.empty_like(x)
    y2q = torch.empty(n, c, w, h, dtype=x.dtype, device=x.device) \
        if raw else None
    err = fn(_DTYPES[x.dtype], x.data_ptr(),
             xq.data_ptr() if dual_in else None, w1.data_ptr(),
             w2.data_ptr(), y.data_ptr(), None if y2q is None
             else y2q.data_ptr(), n, c, h, w, K, s, int(dual_in), int(raw),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwpair kernel launch failed: cudaError {err}")
    global pair_launch_count
    pair_launch_count += 1
    return (y, y2q) if raw else y
