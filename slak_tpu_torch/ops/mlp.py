"""K2/K3/K8: the fused ConvNeXt block tail
``res + gamma * (GELU(LN(y + pre_bias) @ W1 + b1) @ W2 + b2)`` and its
backward.

Kernels: ``csrc/mlp.cu`` (replaces ``slak_tpu/ops/pallas_mlp.py``
``_mlp_fused_2d`` and ``_mlp_cmajor_2d``) and ``csrc/mlp_bwd.cu``
(replaces ``_mlp_bwd_2d``). :func:`fused_mlp` and :func:`fused_mlp_bwd`
launch them for CUDA tensors and run :func:`fused_mlp_plain` /
:func:`fused_mlp_bwd_plain` for CPU tensors. :class:`FusedMlp` is the
autograd Function of the train route (``fused_mlp``'s custom VJP): K2
forward, K8 backward, for C <= 256 only.

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

launch_count = 0            # K2/K3 launches
bwd_launch_count = 0        # K8 launches

LN_EPS = 1e-6               # the block's LayerNorm (models/layers.py)
BWD_C_MAX = 256             # the fused backward's width (pallas_mlp.py:73)
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327

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


def fused_mlp_bwd_plain(y: torch.Tensor, dout: torch.Tensor, pk: MlpWeights,
                        channel_dim: int = -1):
    """Plain version of the backward, a transcription of
    ``_mlp_bwd_kernel`` with its rounding points (h, g, do and da rounded
    to y's dtype before the products that use them) and exact erf.
    Returns (dy in y's dtype, dW1 (4C, C), dW2 (C, 4C), db1, db2, dgamma,
    dln_scale, dln_bias), the weight gradients in ``nn.Linear``
    orientation, all float32 but dy."""
    c, f = pk.c, pk.f
    cdt = y.dtype
    ln_s, ln_b, b2, gamma, pre = pk.vec
    yl = y.movedim(channel_dim, -1)
    shape = yl.shape
    yf = yl.reshape(-1, c).float() + pre
    dl = dout.movedim(channel_dim, -1).reshape(-1, c).float()
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    xhat = (yf - mu) * inv
    hb = (xhat * ln_s + ln_b).to(cdt).float()
    w1 = pk.w1[:f, :c].float()                  # W1^T (4C, C)
    w2 = pk.w2[:c, :f].float()                  # W2^T (C, 4C)
    a = hb @ w1.t() + pk.b1[:f]
    erf_a = torch.erf(a * _INV_SQRT2)
    gb = (0.5 * a * (1.0 + erf_a)).to(cdt).float()
    o_pre = gb @ w2.t() + b2
    dgamma = (dl * o_pre).sum(0)
    do = dl * gamma
    db2 = do.sum(0)
    dob = do.to(cdt).float()
    dw2 = dob.t() @ gb
    dg = dob @ w2
    gp = 0.5 * (1.0 + erf_a) + a * _INV_SQRT_2PI * torch.exp(-0.5 * a * a)
    da = dg * gp
    db1 = da.sum(0)
    dab = da.to(cdt).float()
    dw1 = dab.t() @ hb
    dh = dab @ w1
    dlns = (dh * xhat).sum(0)
    dlnb = dh.sum(0)
    dxh = dh * ln_s
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    dy = (inv * (dxh - m1 - xhat * m2)).to(cdt).reshape(shape)
    return (dy.movedim(-1, channel_dim).contiguous(), dw1, dw2, db1, db2,
            dgamma, dlns, dlnb)


@functools.lru_cache(maxsize=None)
def _bwd_entries():
    from slak_tpu_torch.ops._build import load
    lib = load("mlp_bwd")
    tile = lib.slak_mlp_bwd_tile
    tile.argtypes = [ctypes.c_int] * 3
    tile.restype = ctypes.c_int
    fn = lib.slak_mlp_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 19
                   + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return tile, fn


def fused_mlp_bwd(y: torch.Tensor, dout: torch.Tensor, pk: MlpWeights,
                  channel_dim: int = -1):
    """The tail's backward from its input y and output cotangent dout
    (channels on ``channel_dim``); returns what
    :func:`fused_mlp_bwd_plain` returns. C <= 256."""
    if y.device.type == "cpu":
        return fused_mlp_bwd_plain(y, dout, pk, channel_dim)
    if y.device.type != "cuda":
        raise RuntimeError(f"fused_mlp_bwd runs on cuda or cpu, not "
                           f"{y.device}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp_bwd takes float32 or bfloat16, not "
                        f"{y.dtype}")
    if y.shape[channel_dim] != pk.c or pk.c > BWD_C_MAX:
        raise ValueError(f"channels {y.shape[channel_dim]} vs weights "
                         f"{pk.c} (at most {BWD_C_MAX})")
    if pk.w1.dtype != y.dtype or dout.dtype != y.dtype \
            or dout.shape != y.shape:
        raise TypeError("dout and the packed weights must match y")
    tensors = [y, dout, pk.w1, pk.w2, pk.b1, pk.vec]
    if any(t.device != y.device for t in tensors):
        raise ValueError("fused_mlp_bwd: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp_bwd needs contiguous tensors")
    dt = _DTYPES[y.dtype]
    fp, cp = pk.w1.shape
    tile_fn, fn = _bwd_entries()
    bt = tile_fn(dt, cp, fp)              # the kernels' token tile
    if bt < 0:
        raise ValueError(f"fused_mlp_bwd: C = {pk.c} does not fit a block")
    n_outer, p, s_n, s_c, s_p = token_strides(y.shape, channel_dim)
    tokens = n_outer * p
    tp = _round_up(tokens, bt)
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    grid = min(tp // bt, sms)
    gemm_tile = 128 if y.dtype == torch.bfloat16 else 64

    def splits(m, n):
        """Token splits of a weight-gradient GEMM: about two blocks an SM,
        at least 128 tokens a split."""
        tiles = -(-m // gemm_tile) * -(-n // gemm_tile)
        return max(1, min(-(-tp // 128), -(-2 * sms // tiles)))
    s1, s2 = splits(fp, cp), splits(2 * cp, fp)
    dev, f32 = y.device, torch.float32
    dy = torch.empty_like(y)
    hs = torch.empty(tp, cp, dtype=y.dtype, device=dev)
    dd = torch.empty(tp, 2 * cp, dtype=y.dtype, device=dev)
    gs = torch.empty(tp, fp, dtype=y.dtype, device=dev)
    das = torch.empty_like(gs)
    stats = torch.empty(tp, 2, dtype=f32, device=dev)
    vpart_a = torch.empty(grid, fp + 5 * cp, dtype=f32, device=dev)
    vpart_b = torch.empty(grid, 2 * cp, dtype=f32, device=dev)
    wpart1 = torch.empty(s1, fp, cp, dtype=f32, device=dev)
    wpart2 = torch.empty(s2, 2 * cp, fp, dtype=f32, device=dev)
    dw1 = torch.empty(fp, cp, dtype=f32, device=dev)
    dw2 = torch.empty(2 * cp, fp, dtype=f32, device=dev)
    dvec = torch.empty(fp + 5 * cp, dtype=f32, device=dev)
    err = fn(dt, y.data_ptr(), dout.data_ptr(), dy.data_ptr(),
             pk.w1.data_ptr(), pk.w2.data_ptr(), pk.b1.data_ptr(),
             pk.vec.data_ptr(), hs.data_ptr(), dd.data_ptr(), gs.data_ptr(),
             das.data_ptr(), stats.data_ptr(), vpart_a.data_ptr(),
             vpart_b.data_ptr(), wpart1.data_ptr(), wpart2.data_ptr(),
             dw1.data_ptr(), dw2.data_ptr(), dvec.data_ptr(), n_outer, p,
             s_n, s_c, s_p, pk.c, cp, fp, bt, grid, s1, s2,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd kernel launch failed: cudaError "
                           f"{err}")
    global bwd_launch_count
    bwd_launch_count += 1
    c, f = pk.c, pk.f
    # dvec: db1 (fp) | db2 | sum_t dout | dlns | dlnb | dgamma (cp each)
    db2, _, dlns, dlnb, dgamma = dvec[fp:].view(5, cp)[:, :c]
    return (dy, dw1[:f, :c], dw2[:c, :f], dvec[:f], db2, dgamma, dlns,
            dlnb)


class FusedMlp(torch.autograd.Function):
    """The train route's fused tail on an NCHW activation (the counterpart
    of ``fused_mlp``'s custom VJP): K2 forward, K8 backward. Inputs are the
    block's float32 parameters in ``nn.Linear`` orientation (w1 (4C, C),
    w2 (C, 4C)); they are packed in y's dtype for each call. The forward
    saves y only; the backward recomputes. Raises above C = 256 (the
    block routes wider tails through the plain composition)."""

    @staticmethod
    def forward(ctx, y, res, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                add_residual=True, plain=False):
        if y.shape[1] > BWD_C_MAX:
            raise ValueError(f"FusedMlp: C = {y.shape[1]} > {BWD_C_MAX}; "
                             f"the fused backward covers C <= {BWD_C_MAX}")
        pk = pack_mlp(ln_scale, ln_bias, w1.t(), b1, w2.t(), b2, gamma,
                      None, y.dtype)
        y = y.contiguous()
        fwd = fused_mlp_plain if plain else fused_mlp
        out = fwd(y, res.contiguous() if add_residual else None, pk, 1,
                  add_residual)
        ctx.save_for_backward(y)
        ctx.pk, ctx.add_residual, ctx.plain = pk, add_residual, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        (y,) = ctx.saved_tensors
        bwd = fused_mlp_bwd_plain if ctx.plain else fused_mlp_bwd
        dy, dw1, dw2, db1, db2, dgamma, dlns, dlnb = bwd(
            y, dout.contiguous(), ctx.pk, 1)
        dres = dout if ctx.add_residual else None
        return (dy, dres, dlns, dlnb, dw1, db1, dw2, db2, dgamma, None,
                None)
