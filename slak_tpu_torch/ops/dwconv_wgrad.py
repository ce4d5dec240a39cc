"""K5/K7: the weight gradient of the same-padded depthwise conv (NCHW).

Kernel: ``csrc/dwconv_wgrad.cu`` (replaces ``slak_tpu/ops/pallas_banded.py``
``wgrad_banded_cmajor`` + ``band_extract`` and, on the 7x7 maps,
``wgrad_banded2d_cmajor`` + ``band_extract2d``). :func:`dwconv_wgrad`
launches it for CUDA tensors and runs :func:`dwconv_wgrad_plain` for CPU
tensors.

``dw[c, i, j] = sum_{n,h,w} dy[n,c,h,w] * x[n,c,h+i-kh//2, w+j-kw//2]``
with x zero outside the map: products of the inputs' values (bf16 x and
the rounded cotangent on the bf16 route) summed in fp32, a float32
(C, kh, kw) result.
"""

from __future__ import annotations

import ctypes
import functools

import torch

launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_TARGET = 1056            # about 8 blocks on each of 132 SMs


def _check(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int):
    if x.ndim != 4 or dy.shape != x.shape:
        raise ValueError(f"want x and dy (N,C,H,W) alike, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"taps must be odd, got {(kh, kw)}")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("x and dy differ in dtype or device")


def dwconv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, kh: int,
                       kw: int) -> torch.Tensor:
    """Plain version: ``torch.nn.grad.conv2d_weight(groups=C)`` in fp32 on
    the inputs' values. Returns (C, kh, kw) float32."""
    _check(x, dy, kh, kw)
    C = x.shape[1]
    dw = torch.nn.grad.conv2d_weight(x.float(), (C, 1, kh, kw), dy.float(),
                                     padding=(kh // 2, kw // 2), groups=C)
    return dw[:, 0]


def n_chunks(N: int, C: int) -> int:
    """Batch chunks a launch splits the reduction into: enough blocks
    (C * chunks) to fill the card, at most one a sample."""
    per = -(-N // max(1, min(N, -(-_BLOCKS_TARGET // C))))
    return -(-N // per)


@functools.lru_cache(maxsize=None)
def _entry():
    from slak_tpu_torch.ops._build import load
    fn = load("dwconv_wgrad").slak_dwconv_wgrad
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dwconv_wgrad(x: torch.Tensor, dy: torch.Tensor, kh: int,
                 kw: int) -> torch.Tensor:
    """The (C, kh, kw) float32 tap gradient of conv(x, w) for the output
    cotangent dy. x, dy: (N, C, H, W) float32 or bfloat16, contiguous."""
    if x.device.type == "cpu":
        return dwconv_wgrad_plain(x, dy, kh, kw)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv_wgrad runs on cuda or cpu, not "
                           f"{x.device}")
    _check(x, dy, kh, kw)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwconv_wgrad takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("dwconv_wgrad needs contiguous tensors")
    N, C, H, W = x.shape
    chunks = n_chunks(N, C)
    part = torch.empty(chunks, C, kh, kw, dtype=torch.float32,
                       device=x.device)
    dw = torch.empty(C, kh, kw, dtype=torch.float32, device=x.device)
    err = _entry()(_DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(),
                   part.data_ptr(), dw.data_ptr(), N, C, H, W, kh, kw,
                   chunks, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwconv_wgrad kernel launch failed: cudaError "
                           f"{err}")
    global launch_count
    launch_count += 1
    return dw
