"""K2/K3: the fused ConvNeXt block tail
``res + gamma * (GELU(LN(y + pre_bias) @ W1 + b1) @ W2 + b2)``.

Kernel: ``csrc/mlp.cu`` (replaces ``slak_tpu/ops/pallas_mlp.py``
``_mlp_fused_2d`` and ``_mlp_cmajor_2d``). :func:`fused_mlp` launches it
for CUDA tensors and runs :func:`fused_mlp_plain` for CPU tensors.

The activation may hold its channels on any axis (``channel_dim``): the
kernel addresses tokens and channels through strides, so NHWC (the
tokens-major ``fused_mlp``), (C, M) (the channel-major
``fused_mlp_cmajor``) and this port's NCHW all run without a transpose.

Weights are packed once per model by :func:`pack_mlp` into
:class:`MlpWeights`: W1^T (4C, C) and W2^T (C, 4C) -- the ``nn.Linear``
orientation -- in the compute dtype, zero-padded to the kernel's tiles, and
the per-channel vectors in fp32.
Rounding follows the JAX kernels (``_reference_mlp``): LN statistics in
fp32, h and g rounded to the compute dtype before each product, fp32
accumulation, one rounding on the store.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

launch_count = 0

LN_EPS = 1e-6               # the block's LayerNorm (models/layers.py)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F_ALIGN = 64               # the hidden width is padded to this (mlp.cu)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class MlpWeights(NamedTuple):
    w1: torch.Tensor         # W1^T (Fp, Cp) compute dtype, zero-padded
    w2: torch.Tensor         # W2^T (Cp, Fp) compute dtype, zero-padded
    b1: torch.Tensor         # (Fp,) fp32, zero-padded
    vec: torch.Tensor        # (5, C) fp32: ln_scale, ln_bias, b2, gamma, pre_bias
    c: int
    f: int


def pack_mlp(ln_scale, ln_bias, w1, b1, w2, b2, gamma=None, pre_bias=None,
             dtype=torch.float32) -> MlpWeights:
    """Pack the tail's parameters. w1: (C, 4C), w2: (4C, C) -- the JAX
    orientation, i.e. ``pwconv1.weight.t()``; gamma defaults to ones and
    pre_bias (the folded conv bias added before the LN) to zeros."""
    c, f = w1.shape
    dev = w1.device
    cp, fp = _round_up(c, 16), _round_up(f, _F_ALIGN)
    w1p = torch.zeros(fp, cp, dtype=dtype, device=dev)
    w1p[:f, :c] = w1.t().to(dtype)
    w2p = torch.zeros(cp, fp, dtype=dtype, device=dev)
    w2p[:c, :f] = w2.t().to(dtype)
    b1p = torch.zeros(fp, dtype=torch.float32, device=dev)
    b1p[:f] = b1.float()
    ones = torch.ones(c, dtype=torch.float32, device=dev)
    zeros = torch.zeros(c, dtype=torch.float32, device=dev)
    vec = torch.stack([ln_scale.float(), ln_bias.float(), b2.float(),
                       ones if gamma is None else gamma.float(),
                       zeros if pre_bias is None else pre_bias.float()])
    return MlpWeights(w1p, w2p, b1p, vec.contiguous(), c, f)


def fused_mlp_plain(y: torch.Tensor, res: torch.Tensor, pk: MlpWeights,
                    channel_dim: int = -1,
                    add_residual: bool = True) -> torch.Tensor:
    """Plain version, the composition of ``_reference_mlp``; products of
    compute-dtype values summed in fp32."""
    c, f = pk.c, pk.f
    ln_s, ln_b, b2, gamma, pre = pk.vec
    yl = y.movedim(channel_dim, -1)
    yf = yl.float() + pre
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).square().mean(-1, keepdim=True)
    h = ((yf - mu) * torch.rsqrt(var + LN_EPS) * ln_s + ln_b).to(y.dtype)
    a = h.float() @ pk.w1[:f, :c].float().t() + pk.b1[:f]
    g = F.gelu(a).to(y.dtype)
    o = (g.float() @ pk.w2[:c, :f].float().t() + b2) * gamma
    if add_residual:
        o = res.movedim(channel_dim, -1).float() + o
    return o.to(y.dtype).movedim(-1, channel_dim).contiguous()


def token_strides(shape, channel_dim: int) -> Tuple[int, int, int, int, int]:
    """(n_outer, P, sN, sC, sP) of a contiguous tensor whose channels sit on
    ``channel_dim``: token t = n*P + p lies at n*sN + c*sC + p*sP."""
    d = channel_dim % len(shape)
    c = shape[d]
    n_outer = 1
    for s in shape[:d]:
        n_outer *= s
    p = 1
    for s in shape[d + 1:]:
        p *= s
    return n_outer, p, c * p, p, 1


@functools.lru_cache(maxsize=None)
def _entry():
    from slak_tpu_torch.ops._build import load
    fn = load("mlp").slak_fused_mlp
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_mlp(y: torch.Tensor, res: Optional[torch.Tensor], pk: MlpWeights,
              channel_dim: int = -1,
              add_residual: bool = True) -> torch.Tensor:
    """The fused tail on y (and the shortcut res), channels on
    ``channel_dim``. Returns a new tensor shaped like y."""
    if y.device.type == "cpu":
        return fused_mlp_plain(y, res, pk, channel_dim, add_residual)
    if y.device.type != "cuda":
        raise RuntimeError(f"fused_mlp runs on cuda or cpu, not {y.device}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp takes float32 or bfloat16, not {y.dtype}")
    if y.shape[channel_dim] != pk.c:
        raise ValueError(f"channels {y.shape[channel_dim]} vs weights {pk.c}")
    if pk.w1.dtype != y.dtype or pk.w2.dtype != y.dtype:
        raise TypeError("weights packed for another dtype")
    tensors = [y, pk.w1, pk.w2, pk.b1, pk.vec]
    if add_residual:
        if res is None or res.shape != y.shape or res.dtype != y.dtype:
            raise ValueError("res must match y in shape and dtype")
        tensors.append(res)
    if any(t.device != y.device for t in tensors):
        raise ValueError("fused_mlp: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp needs contiguous tensors")
    n_outer, p, s_n, s_c, s_p = token_strides(y.shape, channel_dim)
    fp, cp = pk.w1.shape
    out = torch.empty_like(y)
    err = _entry()(_DTYPES[y.dtype], y.data_ptr(),
             (res if add_residual else y).data_ptr(), out.data_ptr(),
             pk.w1.data_ptr(), pk.w2.data_ptr(), pk.b1.data_ptr(),
             pk.vec.data_ptr(), n_outer, p, s_n, s_c, s_p, pk.c, cp, fp,
             int(add_residual),
             torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: cudaError {err}")
    global launch_count
    launch_count += 1
    return out
