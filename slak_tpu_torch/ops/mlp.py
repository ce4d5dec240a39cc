"""K2/K3/K8/K9/K12: the fused ConvNeXt block tail
``res + gamma * (GELU(LN(y + pre_bias) @ W1 + b1) @ W2 + b2)``, its
backward, and its dual-orientation variant.

Kernels: ``csrc/mlp.cu`` (replaces ``slak_tpu/ops/pallas_mlp.py``
``_mlp_fused_2d`` and ``_mlp_cmajor_2d``) and ``csrc/mlp_bwd.cu``, two
entry points over one launch sequence: ``slak_mlp_bwd`` (K8, replaces
``_mlp_bwd_2d``, C <= 256, dy in y's dtype) and ``slak_mlp_bwd_wide``
(K9, replaces ``_mlp_bwd_chunked_2d``, any C, dy in float32).
:func:`fused_mlp`, :func:`fused_mlp_bwd` and :func:`fused_mlp_bwd_wide`
launch them for CUDA tensors and run :func:`fused_mlp_plain`,
:func:`fused_mlp_bwd_plain` and :func:`fused_mlp_bwd_wide_plain` for CPU
tensors. :class:`FusedMlp` is the autograd Function of ``fused_mlp``'s
custom VJP: K2 forward, K8 backward at C <= 256 and K9 above, as
``_vjp_bwd`` picks.

The backward's launches (the LayerNorm prep, the GELU product, dh, the
LayerNorm backward, the token reductions and dgamma; in bf16 the products
run as TMA-fed ``wgmma``, in float32 as 3xTF32 on ``wgmma``, each operand
split into big and small TF32 parts, as accurate as fp32) have plain
versions :func:`mlp_bwd_prep_plain`, :func:`mlp_bwd_act_plain`,
:func:`mlp_bwd_dh_plain`, :func:`mlp_bwd_lnb_plain` and
:func:`mlp_bwd_wgrad_plain`; :func:`fused_mlp_bwd_launches_plain` is their
composition (the CPU tests hold it to the kernels' plain versions and to
the Pallas kernels), and :func:`mlp_bwd_wgrad_tf32_mirror` follows the
float32 token reductions' split, k blocks and sum order. With
``dy_only`` the backward gives dy alone (the input gradient with frozen
weights: the ERF): the kernels skip the token reductions, dgamma and the
sums that only the parameter gradients read, and dy has the same bits as
in the full mode.

In bf16, ``mlp.cu`` first writes h = LN(y + pre_bias) into a workspace
(the wrapper allocates ``slak_fused_mlp_workspace`` bytes), then runs the
rest as one TMA + wgmma kernel up to 256 channels, or as two TMA + wgmma
GEMMs through g above. :func:`mlp_ln_plain`, :func:`mlp_gelu_gemm_plain`
and :func:`mlp_residual_gemm_plain` are those launches' plain versions;
:func:`fused_mlp_plain` is their composition.

In float32 (the ERF's route) both products run as 3xTF32 on TMA-fed
``wgmma`` (``csrc/tf32_gemm.cuh``, shared with the backward): every operand
is stored as its big and small TF32 planes (:func:`tf32_split_plain`) and
each k step runs three TF32 products, summed in fp32 per 32-deep k block,
as accurate as fp32 FFMA. The launches: the weights' split, the LayerNorm
into h's planes (:func:`mlp_ln_f32_plain`), g = GELU(h W1 + b1) into g's
planes (:func:`mlp_gelu_f32_plain`), and g W2 with the residual epilogue
(:func:`mlp_out_f32_plain`); :func:`fused_mlp_f32_launches_plain` is their
composition. What bounds it on the card is the three TF32 passes' 4 T C
4C operations each, not the bytes; the exact-erf GELU of the first
product's epilogue and g's planes (two T x 4C fp32 round trips) are its
CUDA-core and memory work.

K12 (``slak_fused_mlp_dual`` in ``csrc/mlp.cu``, replaces
``fused_mlp_cmajor_dual_raw``) is a variant of the K2/K3 kernel family, as
K3 is: :func:`fused_mlp_dual` runs the tail on ``y1 + y2^T`` (the raw pair
of the dual eval stage's conv, y2 in the q orientation (N, C, W, H)),
summed in the compute dtype before the fp32 LayerNorm, and writes the
output in NCHW and, with ``emit_q``, also in the q orientation;
:func:`fused_mlp_dual_plain` is its plain version.

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
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

launch_count = 0            # K2/K3 launches
dual_launch_count = 0       # K12 launches
tf32_launch_count = 0       # float32 K2/K3 launches (3xTF32; also counted above)
bwd_launch_count = 0        # K8 launches
wide_bwd_launch_count = 0   # K9 launches
bwd_dy_launch_count = 0     # K8 launches in dy-only mode (also counted above)
wide_bwd_dy_launch_count = 0    # K9 launches in dy-only mode (likewise)

LN_EPS = 1e-6               # the block's LayerNorm (models/layers.py)
BWD_C_MAX = 256             # the fused backward's width (pallas_mlp.py:73)
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F_ALIGN = 64               # the hidden width is padded to this (mlp.cu)
_TOKEN_TILE = 128           # fp32 K2/K3/K12 and K8/K9 pad the tokens to this


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


def mlp_ln_plain(y: torch.Tensor, pk: MlpWeights,
                 channel_dim: int = -1) -> torch.Tensor:
    """Plain version of the bf16 route's LayerNorm launch
    (``ln_bf16_kernel``): h = LN(y + pre_bias), tokens-major (T, C), fp32
    statistics, rounded to y's dtype."""
    ln_s, ln_b, _, _, pre = pk.vec
    yf = y.movedim(channel_dim, -1).reshape(-1, pk.c).float() + pre
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).square().mean(-1, keepdim=True)
    return ((yf - mu) * torch.rsqrt(var + LN_EPS) * ln_s + ln_b).to(y.dtype)


def mlp_gelu_gemm_plain(h: torch.Tensor, pk: MlpWeights) -> torch.Tensor:
    """Plain version of the first GEMM (``gemm_kernel<GELU>``): g =
    GELU(h W1 + b1) (T, 4C), products of h's dtype summed in fp32, exact
    erf, rounded to h's dtype."""
    a = h.float() @ pk.w1[:pk.f, :pk.c].float().t() + pk.b1[:pk.f]
    return F.gelu(a).to(h.dtype)


def mlp_residual_gemm_plain(g: torch.Tensor, res: Optional[torch.Tensor],
                            pk: MlpWeights, shape, channel_dim: int = -1,
                            add_residual: bool = True) -> torch.Tensor:
    """Plain version of the second GEMM (``gemm_kernel<residual>``) and of
    the fused kernel's epilogue: out = res + gamma (g W2 + b2), one
    rounding, shaped ``shape`` with the channels on ``channel_dim``."""
    return _residual_out(g.float() @ pk.w2[:pk.c, :pk.f].float().t(), res,
                         pk, shape, channel_dim, add_residual, g.dtype)


def _residual_out(o, res, pk, shape, channel_dim, add_residual, dtype):
    """res + gamma (o + b2) for the (T, C) fp32 product o, rounded to
    dtype once, shaped ``shape`` with the channels on ``channel_dim``."""
    _, _, b2, gamma, _ = pk.vec
    o = (o + b2) * gamma
    shape = list(shape)
    tl_shape = shape[:channel_dim % len(shape)] + \
        shape[channel_dim % len(shape) + 1:] + [pk.c]
    o = o.reshape(tl_shape)
    if add_residual:
        o = res.movedim(channel_dim, -1).float() + o
    return o.to(dtype).movedim(-1, channel_dim).contiguous()


def fused_mlp_plain(y: torch.Tensor, res: torch.Tensor, pk: MlpWeights,
                    channel_dim: int = -1,
                    add_residual: bool = True) -> torch.Tensor:
    """Plain version, the composition of ``_reference_mlp``: the LayerNorm,
    the GELU GEMM and the residual GEMM (the bf16 route's three launches
    above 256 channels; the fused kernel computes the same below)."""
    g = mlp_gelu_gemm_plain(mlp_ln_plain(y, pk, channel_dim), pk)
    return mlp_residual_gemm_plain(g, res, pk, y.shape, channel_dim,
                                   add_residual)


def tf32_split_plain(x: torch.Tensor) -> torch.Tensor:
    """The big and small TF32 planes of a float32 (R, K) matrix, (2 R, K)
    big rows first, as ``split_tf32`` (``csrc/tf32_gemm.cuh``) makes them:
    big = x rounded to TF32 (to nearest, ties away from zero, the low 13
    bits cleared), small = (x - big) rounded the same way."""
    def tf32(v):
        u = v.contiguous().view(torch.int32)
        return ((u + 0x1000) & -0x2000).view(torch.float32)
    big = tf32(x)
    return torch.cat([big, tf32(x - big)])


def _tf32_product(ap: torch.Tensor, bp: torch.Tensor) -> torch.Tensor:
    """A B^T from the planes of A (2 M, K) and B (2 N, K) as the kernel's
    three TF32 products: small A x big B + big A x small B + big A x big
    B, in float32 (small x small dropped)."""
    a, a_s = ap.chunk(2)
    b, b_s = bp.chunk(2)
    return a_s @ b.t() + a @ b_s.t() + a @ b.t()


def mlp_ln_f32_plain(y: torch.Tensor, pk: MlpWeights,
                     channel_dim: int = -1) -> torch.Tensor:
    """Plain version of the float32 route's LayerNorm launch
    (``simt_ln_kernel``): h = LN(y + pre_bias) with its tokens padded to a
    multiple of 128 and its channels to Cp, zeros there, as its TF32
    planes (2 Tp, Cp)."""
    h = mlp_ln_plain(y, pk, channel_dim)
    t = h.shape[0]
    cp = pk.w1.shape[1]
    hp = h.new_zeros(_round_up(t, _TOKEN_TILE), cp)
    hp[:t, :pk.c] = h
    return tf32_split_plain(hp)


def mlp_gelu_f32_plain(hp: torch.Tensor, pk: MlpWeights) -> torch.Tensor:
    """Plain version of the float32 route's first product
    (``tf32_gemm_kernel<GeluFwd>``): from h's planes (2 Tp, Cp), g =
    GELU(h W1 + b1) (exact erf) through the three TF32 products with W1's
    planes, as g's planes (2 Tp, Fp)."""
    a = _tf32_product(hp, tf32_split_plain(pk.w1)) + pk.b1
    return tf32_split_plain(F.gelu(a))


def mlp_out_f32_plain(gp: torch.Tensor, res: Optional[torch.Tensor],
                      pk: MlpWeights, shape, channel_dim: int = -1,
                      add_residual: bool = True) -> torch.Tensor:
    """Plain version of the float32 route's second product
    (``tf32_gemm_kernel<F32>``) and residual launch (``simt_out_kernel``):
    from g's planes (2 Tp, Fp), out = res + gamma (g W2 + b2) through the
    three TF32 products with W2's planes, the real tokens and channels,
    shaped ``shape`` with the channels on ``channel_dim``."""
    t = math.prod(shape) // pk.c
    o = _tf32_product(gp, tf32_split_plain(pk.w2))[:t, :pk.c]
    return _residual_out(o, res, pk, shape, channel_dim, add_residual,
                         torch.float32)


def fused_mlp_f32_launches_plain(y: torch.Tensor, res: Optional[torch.Tensor],
                                 pk: MlpWeights, channel_dim: int = -1,
                                 add_residual: bool = True) -> torch.Tensor:
    """The composition of the float32 route's launches' plain versions:
    the LayerNorm into h's planes, the GELU product into g's planes, the
    second product with the residual epilogue."""
    gp = mlp_gelu_f32_plain(mlp_ln_f32_plain(y, pk, channel_dim), pk)
    return mlp_out_f32_plain(gp, res, pk, y.shape, channel_dim, add_residual)


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


def bind(lib: ctypes.CDLL):
    """The typed C entry points of a loaded ``csrc/mlp.cu`` library:
    (slak_fused_mlp_workspace, slak_fused_mlp, slak_fused_mlp_dual)."""
    ws = lib.slak_fused_mlp_workspace
    ws.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int]
    ws.restype = ctypes.c_longlong
    fn = lib.slak_fused_mlp
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    dual = lib.slak_fused_mlp_dual
    dual.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                     + [ctypes.c_longlong] + [ctypes.c_int] * 5
                     + [ctypes.c_void_p] * 2)
    dual.restype = ctypes.c_int
    return ws, fn, dual


@functools.lru_cache(maxsize=None)
def _entries():
    from slak_tpu_torch.ops._build import load
    return bind(load("mlp"))


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
    dt = _DTYPES[y.dtype]
    ws_fn, fn, _ = _entries()
    nbytes = ws_fn(dt, n_outer * p, cp, fp)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=y.device) \
        if nbytes else None
    out = torch.empty_like(y)
    err = fn(dt, y.data_ptr(), (res if add_residual else y).data_ptr(),
             out.data_ptr(), pk.w1.data_ptr(), pk.w2.data_ptr(),
             pk.b1.data_ptr(), pk.vec.data_ptr(), n_outer, p, s_n, s_c, s_p,
             pk.c, cp, fp, int(add_residual),
             None if ws is None else ws.data_ptr(),
             torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: cudaError {err}")
    global launch_count, tf32_launch_count
    launch_count += 1
    tf32_launch_count += y.dtype == torch.float32
    return out


def _check_dual(y1, y2, res, pk):
    if y1.ndim != 4 or y2.ndim != 4:
        raise ValueError(f"want y1 (N,C,H,W) and y2 (N,C,W,H), got "
                         f"{tuple(y1.shape)} and {tuple(y2.shape)}")
    n, c, h, w = y1.shape
    if tuple(y2.shape) != (n, c, w, h) or y2.dtype != y1.dtype:
        raise ValueError(f"y2 must be (N, C, W, H) = {(n, c, w, h)} in "
                         f"{y1.dtype}, got {tuple(y2.shape)} {y2.dtype}")
    if res.shape != y1.shape or res.dtype != y1.dtype:
        raise ValueError("res must match y1 in shape and dtype")
    if c != pk.c:
        raise ValueError(f"channels {c} vs weights {pk.c}")


def fused_mlp_dual_plain(y1: torch.Tensor, y2: torch.Tensor,
                         res: torch.Tensor, pk: MlpWeights,
                         emit_q: bool = True):
    """Plain version of K12 (``_reference_mlp_dual``): (oh, oq), oq the
    same values in the q orientation or None without ``emit_q``."""
    _check_dual(y1, y2, res, pk)
    oh = fused_mlp_plain(y1 + y2.transpose(2, 3), res, pk, 1)
    return oh, (oh.transpose(2, 3).contiguous() if emit_q else None)


def fused_mlp_dual(y1: torch.Tensor, y2: torch.Tensor, res: torch.Tensor,
                   pk: MlpWeights, emit_q: bool = True):
    """K12: the tail on ``y1 + y2^T`` with the shortcut res (y1, res NCHW,
    y2 (N, C, W, H)). Returns (oh NCHW, oq (N, C, W, H) or None)."""
    if y1.device.type == "cpu":
        return fused_mlp_dual_plain(y1, y2, res, pk, emit_q)
    if y1.device.type != "cuda":
        raise RuntimeError(f"fused_mlp_dual runs on cuda or cpu, not "
                           f"{y1.device}")
    _check_dual(y1, y2, res, pk)
    if y1.dtype not in _DTYPES:
        raise TypeError(f"fused_mlp_dual takes float32 or bfloat16, not "
                        f"{y1.dtype}")
    if pk.w1.dtype != y1.dtype or pk.w2.dtype != y1.dtype:
        raise TypeError("weights packed for another dtype")
    tensors = [y1, y2, res, pk.w1, pk.w2, pk.b1, pk.vec]
    if any(t.device != y1.device for t in tensors):
        raise ValueError("fused_mlp_dual: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp_dual needs contiguous tensors")
    n, c, h, w = y1.shape
    fp, cp = pk.w1.shape
    dt = _DTYPES[y1.dtype]
    ws_fn, _, dual = _entries()
    nbytes = ws_fn(dt, n * h * w, cp, fp)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=y1.device) \
        if nbytes else None
    oh = torch.empty_like(y1)
    oq = torch.empty_like(y2) if emit_q else None
    err = dual(
        dt, y1.data_ptr(), y2.data_ptr(), res.data_ptr(), oh.data_ptr(),
        None if oq is None else oq.data_ptr(), pk.w1.data_ptr(),
        pk.w2.data_ptr(), pk.b1.data_ptr(), pk.vec.data_ptr(), n, c, h, w,
        cp, fp, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(y1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_dual kernel launch failed: cudaError "
                           f"{err}")
    global dual_launch_count
    dual_launch_count += 1
    return oh, oq


_NO_PARAMS = (None,) * 7


def fused_mlp_bwd_plain(y: torch.Tensor, dout: torch.Tensor, pk: MlpWeights,
                        channel_dim: int = -1, dy_only: bool = False):
    """Plain version of the backward, a transcription of
    ``_mlp_bwd_kernel`` with its rounding points (h, g, do and da rounded
    to y's dtype before the products that use them) and exact erf.
    Returns (dy in y's dtype, dW1 (4C, C), dW2 (C, 4C), db1, db2, dgamma,
    dln_scale, dln_bias), the weight gradients in ``nn.Linear``
    orientation, all float32 but dy; ``dy_only``: (dy, None, ..., None),
    dy from the same operations."""
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
    do = dl * gamma
    dob = do.to(cdt).float()
    dg = dob @ w2
    gp = 0.5 * (1.0 + erf_a) + a * _INV_SQRT_2PI * torch.exp(-0.5 * a * a)
    da = dg * gp
    dab = da.to(cdt).float()
    dh = dab @ w1
    dxh = dh * ln_s
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    dy = (inv * (dxh - m1 - xhat * m2)).to(cdt).reshape(shape)
    dy = dy.movedim(-1, channel_dim).contiguous()
    if dy_only:
        return (dy,) + _NO_PARAMS
    gb = (0.5 * a * (1.0 + erf_a)).to(cdt).float()
    dgamma = (dl * (gb @ w2.t() + b2)).sum(0)
    return (dy, dab.t() @ hb, dob.t() @ gb, da.sum(0), do.sum(0), dgamma,
            (dh * xhat).sum(0), dh.sum(0))


def mlp_bwd_prep_plain(y: torch.Tensor, dout: torch.Tensor, pk: MlpWeights,
                       channel_dim: int = -1):
    """Plain version of the backward's first launch (``wide_prep_kernel``):
    (h, do, mean, inv, db2, sum_t dout): h = LN(y + pre_bias) and do =
    dout * gamma rounded to y's dtype, tokens-major (T, C); each token's
    fp32 statistics (T, 1); the fp32 column sums of the unrounded do and of
    dout."""
    ln_s, ln_b, _, gamma, pre = pk.vec
    yf = y.movedim(channel_dim, -1).reshape(-1, pk.c).float() + pre
    dl = dout.movedim(channel_dim, -1).reshape(-1, pk.c).float()
    mu = yf.mean(-1, keepdim=True)
    inv = torch.rsqrt((yf - mu).square().mean(-1, keepdim=True) + LN_EPS)
    h = ((yf - mu) * inv * ln_s + ln_b).to(y.dtype)
    do = dl * gamma
    return h, do.to(y.dtype), mu, inv, do.sum(0), dl.sum(0)


def mlp_bwd_act_plain(h: torch.Tensor, do: torch.Tensor, pk: MlpWeights):
    """Plain version of the GELU product launch (``bwd_gemm_kernel`` with
    its GELU epilogue in bf16, ``wide_simt_kernel<true>`` in fp32): a = h
    W1^T + b1 and dg = do W2 summed in fp32, then (g, da, db1): g = GELU(a)
    and da = dg gelu'(a) rounded to h's dtype (T, 4C), exact erf, and db1 =
    the fp32 column sums of the unrounded da."""
    c, f = pk.c, pk.f
    a = h.float() @ pk.w1[:f, :c].float().t() + pk.b1[:f]
    erf_a = torch.erf(a * _INV_SQRT2)
    g = 0.5 * a * (1.0 + erf_a)
    gp = 0.5 * (1.0 + erf_a) + a * _INV_SQRT_2PI * torch.exp(-0.5 * a * a)
    da = (do.float() @ pk.w2[:c, :f].float()) * gp
    return g.to(h.dtype), da.to(h.dtype), da.sum(0)


def mlp_bwd_dh_plain(da: torch.Tensor, pk: MlpWeights) -> torch.Tensor:
    """Plain version of the dh product launch: dh = da W1 (T, C), fp32."""
    return da.float() @ pk.w1[:pk.f, :pk.c].float()


def mlp_bwd_lnb_plain(y: torch.Tensor, dh: torch.Tensor, mu: torch.Tensor,
                      inv: torch.Tensor, pk: MlpWeights,
                      channel_dim: int = -1, dy_dtype=torch.float32):
    """Plain version of the LayerNorm-backward launch (``wide_lnb_kernel``):
    xhat from y and the prep launch's statistics, then (dy, dln_scale,
    dln_bias): dy = inv (dxh - mean_c dxh - xhat mean_c(dxh xhat)) with
    dxh = dh ln_scale, in ``dy_dtype`` and y's layout; the fp32 column sums
    of dh xhat and of dh."""
    ln_s, pre = pk.vec[0], pk.vec[4]
    yl = y.movedim(channel_dim, -1)
    xhat = (yl.reshape(-1, pk.c).float() + pre - mu) * inv
    dxh = dh * ln_s
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    dy = (inv * (dxh - m1 - xhat * m2)).to(dy_dtype).reshape(yl.shape)
    return (dy.movedim(-1, channel_dim).contiguous(), (dh * xhat).sum(0),
            dh.sum(0))


def mlp_bwd_wgrad_plain(h, do, dout, g, da, sum_dout, pk: MlpWeights,
                        channel_dim: int = -1):
    """Plain version of the token-reduction launches and ``dgamma_kernel``:
    (dW1 (4C, C), dW2 (C, 4C), dgamma): dW1 = da^T h and dW2 = do^T g
    summed in fp32, and dgamma = sum_f W2^T M + b2 sum_t dout with M =
    dout^T g (the per-token g W2^T is never formed)."""
    dl = dout.movedim(channel_dim, -1).reshape(-1, pk.c).float()
    gf = g.float()
    m = dl.t() @ gf
    w2 = pk.w2[:pk.c, :pk.f].float()
    return (da.float().t() @ h.float(), do.float().t() @ gf,
            (w2 * m).sum(1) + pk.vec[2] * sum_dout)


def mlp_bwd_wgrad_tf32_mirror(h, do, dout, g, da, sum_dout, pk: MlpWeights,
                              splits=(1, 1), channel_dim: int = -1):
    """Plain mirror of the float32 token reductions as the card runs them
    (``wgrad_tf32_kernel``), for the tests: the tokens padded with zeros to
    a multiple of 128; both operands split into big and small TF32 parts;
    each 32-token k block's three products (small A x big B, big A x small
    B, big A x big B) into a fresh partial, added in fp32 into its token
    split's sums in order; the splits' sums added in order (``splits``: the
    two products' token splits, ``_gemm_splits``'). A is da (dW1^T = da^T
    h) or g ([do | dout]^T g, whose transpose is dW2 beside M); then dgamma
    as :func:`mlp_bwd_wgrad_plain` forms it. Returns what
    :func:`mlp_bwd_wgrad_plain` returns."""
    c = pk.c
    dl = dout.movedim(channel_dim, -1).reshape(-1, c).float()
    t = dl.shape[0]
    tp = _round_up(t, _TOKEN_TILE)

    def reduce(a, b, n_splits):
        a = torch.cat([a.float(), a.new_zeros(tp - t, a.shape[1])])
        b = torch.cat([b.float(), b.new_zeros(tp - t, b.shape[1])])
        ab, as_ = tf32_split_plain(a).chunk(2)
        bb, bs = tf32_split_plain(b).chunk(2)
        kb_total = tp // 32
        kb_split = -(-kb_total // n_splits)
        total = None
        for k0 in range(0, kb_total, kb_split):
            s = torch.zeros(a.shape[1], b.shape[1])
            for kb in range(k0, min(kb_total, k0 + kb_split)):
                r = slice(32 * kb, 32 * kb + 32)
                s = s + (as_[r].t() @ bb[r] + ab[r].t() @ bs[r]
                         + ab[r].t() @ bb[r])
            total = s if total is None else total + s
        return total
    dw1t = reduce(da, h, splits[0])                      # (F, C)
    dw2t_m = reduce(g, torch.cat([do.float(), dl], 1), splits[1])
    m = dw2t_m[:, c:].t()                                # M (C, F)
    w2 = pk.w2[:c, :pk.f].float()
    return (dw1t, dw2t_m[:, :c].t(),
            (w2 * m).sum(1) + pk.vec[2] * sum_dout)


def fused_mlp_bwd_launches_plain(y: torch.Tensor, dout: torch.Tensor,
                                 pk: MlpWeights, channel_dim: int = -1,
                                 dy_dtype=None):
    """The composition of the backward's launches' plain versions, in the
    kernels' order: prep, the GELU product, dh, the LayerNorm backward, the
    token reductions and dgamma. Returns what :func:`fused_mlp_bwd_plain`
    returns, dy in ``dy_dtype`` (y's dtype by default: K8; K9 gives
    float32)."""
    h, do, mu, inv, db2, sum_dout = mlp_bwd_prep_plain(y, dout, pk,
                                                       channel_dim)
    g, da, db1 = mlp_bwd_act_plain(h, do, pk)
    dy, dlns, dlnb = mlp_bwd_lnb_plain(y, mlp_bwd_dh_plain(da, pk), mu, inv,
                                       pk, channel_dim, dy_dtype or y.dtype)
    dw1, dw2, dgamma = mlp_bwd_wgrad_plain(h, do, dout, g, da, sum_dout, pk,
                                           channel_dim)
    return dy, dw1, dw2, db1, db2, dgamma, dlns, dlnb


@functools.lru_cache(maxsize=None)
def _bwd_entries():
    """The typed C entry points of ``csrc/mlp_bwd.cu``:
    (slak_mlp_bwd_workspace, slak_mlp_bwd (K8), slak_mlp_bwd_wide (K9))."""
    from slak_tpu_torch.ops._build import load
    lib = load("mlp_bwd")
    ws = lib.slak_mlp_bwd_workspace
    ws.argtypes = [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
    ws.restype = ctypes.c_longlong
    out = [ws]
    for fn in (lib.slak_mlp_bwd, lib.slak_mlp_bwd_wide):
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        out.append(fn)
    return tuple(out)


def _gemm_splits(tp: int, fp: int, cp: int, dtype: torch.dtype, sms: int):
    """Token splits of the two weight-gradient products (Fp x Cp and
    Fp x 2 Cp outputs): 128 x 128 tiles on persistent blocks, one an SM, so
    as many splits as fill the SMs in one wave, each split at least one k
    block (64 tokens in bf16, 32 in fp32)."""
    kb = 64 if dtype == torch.bfloat16 else 32

    def splits(n):
        tiles = -(-fp // 128) * -(-n // 128)
        return max(1, min(tp // kb, sms // tiles))
    return splits(cp), splits(2 * cp)


def _check_bwd(name, y, dout, pk, channel_dim):
    if y.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {y.dtype}")
    if y.shape[channel_dim] != pk.c:
        raise ValueError(f"channels {y.shape[channel_dim]} vs weights {pk.c}")
    if pk.w1.dtype != y.dtype or dout.dtype != y.dtype \
            or dout.shape != y.shape:
        raise TypeError("dout and the packed weights must match y")
    tensors = [y, dout, pk.w1, pk.w2, pk.b1, pk.vec]
    if any(t.device != y.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def fused_mlp_bwd(y: torch.Tensor, dout: torch.Tensor, pk: MlpWeights,
                  channel_dim: int = -1, dy_only: bool = False):
    """K8: the tail's backward from its input y and output cotangent dout
    (channels on ``channel_dim``); returns what
    :func:`fused_mlp_bwd_plain` returns (``dy_only``: dy alone). C <= 256
    on every device (wider tails are :func:`fused_mlp_bwd_wide`'s). One
    launch sequence serves K8 and K9 (``slak_mlp_bwd``: dy in y's
    dtype)."""
    if pk.c > BWD_C_MAX:
        raise ValueError(f"fused_mlp_bwd: C = {pk.c} > {BWD_C_MAX} "
                         f"(fused_mlp_bwd_wide covers it)")
    if y.device.type == "cpu":
        return fused_mlp_bwd_plain(y, dout, pk, channel_dim, dy_only)
    if y.device.type != "cuda":
        raise RuntimeError(f"fused_mlp_bwd runs on cuda or cpu, not "
                           f"{y.device}")
    _check_bwd("fused_mlp_bwd", y, dout, pk, channel_dim)
    out = _launch_bwd(y, dout, pk, channel_dim, False, dy_only)
    global bwd_launch_count, bwd_dy_launch_count
    bwd_launch_count += 1
    bwd_dy_launch_count += dy_only
    return out


def pick_fc(c4: int, itemsize: int) -> int:
    """The hidden-chunk width of ``_mlp_bwd_chunked_2d`` (``_pick_fc``,
    pallas_mlp.py:390-395): about 1024 (bf16) or 512 (fp32) units, rounded
    up to 128."""
    target = 1024 if itemsize < 4 else 512
    nf = -(-c4 // target)
    return -(-(-(-c4 // nf)) // 128) * 128


def fused_mlp_bwd_wide_plain(y: torch.Tensor, dout: torch.Tensor,
                             pk: MlpWeights, channel_dim: int = -1,
                             dy_only: bool = False):
    """Plain version of K9, a transcription of ``_mlp_bwd_chunked_kernel``
    with its rounding points (h, g, do and da rounded to y's dtype before
    the products that use them), its hidden chunks (:func:`pick_fc`), dh
    summed over the chunks in fp32 and the LayerNorm backward after the
    last one; exact erf. Returns what :func:`fused_mlp_bwd_plain` returns,
    but dy in float32 (the TPU kernel's dy output is float32 too);
    ``dy_only``: dy alone, from the same operations."""
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
    do = dl * gamma
    dob = do.to(cdt).float()
    db2 = do.sum(0)
    dgamma = dl.sum(0) * b2                     # b2's share of dgamma
    w1 = pk.w1[:f, :c].float()                  # W1^T (4C, C)
    w2 = pk.w2[:c, :f].float()                  # W2^T (C, 4C)
    b1 = pk.b1[:f]
    fc = pick_fc(f, torch.tensor([], dtype=cdt).element_size())
    dh = torch.zeros_like(yf)
    dw1, dw2, db1 = [], [], []
    for f0 in range(0, f, fc):
        w1c, w2c = w1[f0:f0 + fc], w2[:, f0:f0 + fc]
        a = hb @ w1c.t() + b1[f0:f0 + fc]
        erf_a = torch.erf(a * _INV_SQRT2)
        gp = (0.5 * (1.0 + erf_a)
              + a * _INV_SQRT_2PI * torch.exp(-0.5 * a * a))
        da = (dob @ w2c) * gp
        dab = da.to(cdt).float()
        dh = dh + dab @ w1c
        if dy_only:
            continue
        gb = (0.5 * a * (1.0 + erf_a)).to(cdt).float()
        dgamma = dgamma + (dl * (gb @ w2c.t())).sum(0)
        dw2.append(dob.t() @ gb)
        db1.append(da.sum(0))
        dw1.append(dab.t() @ hb)
    dxh = dh * ln_s
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    dy = (inv * (dxh - m1 - xhat * m2)).reshape(shape)
    dy = dy.movedim(-1, channel_dim).contiguous()
    if dy_only:
        return (dy,) + _NO_PARAMS
    return (dy, torch.cat(dw1), torch.cat(dw2, 1), torch.cat(db1), db2,
            dgamma, (dh * xhat).sum(0), dh.sum(0))


def fused_mlp_bwd_wide(y: torch.Tensor, dout: torch.Tensor, pk: MlpWeights,
                       channel_dim: int = -1, dy_only: bool = False):
    """K9: the tail's backward at any width (the kernel of the wide stages,
    C > 256); returns what :func:`fused_mlp_bwd_wide_plain` returns (dy in
    float32; ``dy_only``: dy alone)."""
    if y.device.type == "cpu":
        return fused_mlp_bwd_wide_plain(y, dout, pk, channel_dim, dy_only)
    if y.device.type != "cuda":
        raise RuntimeError(f"fused_mlp_bwd_wide runs on cuda or cpu, not "
                           f"{y.device}")
    _check_bwd("fused_mlp_bwd_wide", y, dout, pk, channel_dim)
    out = _launch_bwd(y, dout, pk, channel_dim, True, dy_only)
    global wide_bwd_launch_count, wide_bwd_dy_launch_count
    wide_bwd_launch_count += 1
    wide_bwd_dy_launch_count += dy_only
    return out


def _launch_bwd(y, dout, pk, channel_dim, wide, dy_only):
    """One launch of ``slak_mlp_bwd`` (dy in y's dtype) or, ``wide``,
    ``slak_mlp_bwd_wide`` (dy in float32) on checked CUDA tensors; with
    ``dy_only`` the parameter gradients are neither computed nor
    allocated."""
    dt = _DTYPES[y.dtype]
    fp, cp = pk.w1.shape
    n_outer, p, s_n, s_c, s_p = token_strides(y.shape, channel_dim)
    tp = _round_up(n_outer * p, _TOKEN_TILE)
    dev, f32 = y.device, torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s1, s2 = _gemm_splits(tp, fp, cp, y.dtype, sms)
    ws_fn, k8, k9 = _bwd_entries()
    ws = torch.empty(ws_fn(dt, tp, cp, fp, s1, s2), dtype=torch.uint8,
                     device=dev)
    dy = torch.empty(y.shape, dtype=f32 if wide else y.dtype, device=dev)
    if dy_only:
        dw1 = dw2 = dvec = None
    else:
        dw1 = torch.empty(fp, cp, dtype=f32, device=dev)
        dw2 = torch.empty(2 * cp, fp, dtype=f32, device=dev)
        dvec = torch.empty(fp + 5 * cp, dtype=f32, device=dev)
    err = (k9 if wide else k8)(
        dt, y.data_ptr(), dout.data_ptr(), dy.data_ptr(), pk.w1.data_ptr(),
        pk.w2.data_ptr(), pk.b1.data_ptr(), pk.vec.data_ptr(), ws.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (dw1, dw2, dvec)),
        n_outer, p, s_n, s_c, s_p, pk.c, cp, fp, s1, s2, int(dy_only),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        name = "fused_mlp_bwd_wide" if wide else "fused_mlp_bwd"
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if dy_only:
        return (dy,) + _NO_PARAMS
    c, f = pk.c, pk.f
    # dvec: db1 (fp) | db2 | sum_t dout | dlns | dlnb | dgamma (cp each)
    db2, _, dlns, dlnb, dgamma = dvec[fp:].view(5, cp)[:, :c]
    return (dy, dw1[:f, :c], dw2[:c, :f], dvec[:f], db2, dgamma, dlns,
            dlnb)


class FusedMlp(torch.autograd.Function):
    """The fused tail on an NCHW activation, the counterpart of
    ``fused_mlp``'s custom VJP: K2 forward; K8 backward at C <= 256 and K9
    above (``_vjp_bwd``'s pick). Inputs are the block's float32 parameters
    in ``nn.Linear`` orientation (w1 (4C, C), w2 (C, 4C)) and, last, the
    folded conv bias ``pre_bias`` (None for zeros); they are packed in y's
    dtype for each call. The forward saves y only; the backward recomputes, and
    gives ``d pre_bias = sum over tokens of dy`` (``_vjp_bwd`` l.821-823).
    When no parameter (nor ``pre_bias``) needs a gradient, as in the ERF
    with frozen weights, the backward runs in dy-only mode and returns None
    for each parameter.
    """

    @staticmethod
    def forward(ctx, y, res, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                add_residual=True, plain=False, pre_bias=None):
        pk = pack_mlp(ln_scale, ln_bias, w1.t(), b1, w2.t(), b2, gamma,
                      pre_bias, y.dtype)
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
        if y.shape[1] <= BWD_C_MAX:
            bwd = fused_mlp_bwd_plain if ctx.plain else fused_mlp_bwd
        else:
            bwd = fused_mlp_bwd_wide_plain if ctx.plain else \
                fused_mlp_bwd_wide
        need = ctx.needs_input_grad         # 11 long when pre_bias is left out
        dy_only = not any(need[2:9] + need[11:])
        dy, dw1, dw2, db1, db2, dgamma, dlns, dlnb = bwd(
            y, dout.contiguous(), ctx.pk, 1, dy_only=dy_only)
        dres = dout if ctx.add_residual else None
        dpre = dy.float().sum((0, 2, 3)) if need[-1] and len(need) > 11 \
            else None
        return (dy.to(y.dtype), dres, dlns, dlnb, dw1, db1, dw2, db2, dgamma,
                None, None, dpre)[:len(need)]
