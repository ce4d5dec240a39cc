"""K11: the depthwise conv as per-channel banded products with g taps
stacked along M and a shift-add (NCHW).

Kernel: ``csrc/dwconv_stacked.cu`` (replaces ``slak_tpu/ops/
pallas_banded.py`` ``dwconv_banded_stacked_cmajor``). It computes K1's
function, ``conv(x, w)`` with odd ``(C, kh, kw)`` float32 taps (the band
along H, kw tap columns), so :func:`~slak_tpu_torch.ops.dwconv.dwconv_plain`
is its plain version: :func:`dwconv_stacked` launches the kernel for CUDA
tensors and runs it for CPU tensors. bf16 runs the products on the tensor
cores (mma.sync, fp32 accumulation), fp32 on the CUDA cores. No route of
the port dispatches to it; ``tools/probe_stacked.py`` holds it against K1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from slak_tpu_torch.ops.dwconv import _check, _check_cuda, _DTYPES
from slak_tpu_torch.ops.dwconv import dwconv_plain

stacked_launch_count = 0    # K11 launches


def stack_group(h: int, kw: int) -> int:
    """Tap columns a chunk stacks along M: as many whole H-row bands as fill
    the kernel's 64-row tile (the TPU's ``stack_group`` filled its 128
    lanes)."""
    return max(1, min(kw, 64 // h))


@functools.lru_cache(maxsize=None)
def _entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwconv_stacked")
    ok = lib.slak_dwconv_stacked_ok
    ok.argtypes = [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5
    ok.restype = ctypes.c_int
    fn = lib.slak_dwconv_stacked
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return ok, fn


def dwconv_stacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv(x, w) through K11. x: (N, C, H, W) float32 or bfloat16,
    contiguous, H <= 64; w: (C, kh, kw) float32."""
    if x.device.type == "cpu":
        return dwconv_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv_stacked runs on cuda or cpu, not "
                           f"{x.device}")
    _check(x, w, None)
    _check_cuda("dwconv_stacked", x, w)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    ok, fn = _entries()
    dt = _DTYPES[x.dtype]
    if not ok(dt, N, C, H, W, kh, kw):
        raise ValueError(f"dwconv_stacked: {tuple(x.shape)} with taps "
                         f"{(kh, kw)} does not fit (H <= 64 and one plane's "
                         f"band, products and output in 200 KB of shared "
                         f"memory)")
    out = torch.empty_like(x)
    err = fn(dt, x.data_ptr(), w.data_ptr(), out.data_ptr(), N, C, H, W, kh,
             kw, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwconv_stacked kernel launch failed: cudaError "
                           f"{err}")
    global stacked_launch_count
    stacked_launch_count += 1
    return out
