"""K11: the depthwise conv as per-channel banded products with g taps
stacked along M and a shift-add (NCHW).

Kernel: ``csrc/dwconv_stacked.cu`` (replaces ``slak_tpu/ops/
pallas_banded.py`` ``dwconv_banded_stacked_cmajor``). It computes K1's
function, ``conv(x, w)`` with odd ``(C, kh, kw)`` float32 taps (the band
along H, kw tap columns), so :func:`~slak_tpu_torch.ops.dwconv.dwconv_plain`
is its plain version: :func:`dwconv_stacked` launches the kernel for CUDA
tensors and runs it for CPU tensors. bf16 takes ``stacked_band_kernel``
(:func:`stacked_route`: maps up to 64 a side; tensor-core products
over a chunk of images, the stacked band's rows shared by every B
fragment, a warp-local shift-add; counted in ``stacked_band_launch_count``
besides ``stacked_launch_count``), fp32 ``stacked_f32_kernel`` (CUDA-core
FMAs). :func:`dwconv_stacked_mirror` repeats the bf16 kernel's
decomposition in plain PyTorch. No route of the port dispatches to K11;
``tools/probe_stacked.py`` holds it against K1's band launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from slak_tpu_torch.ops.dwconv import _check, _check_cuda, _DTYPES
from slak_tpu_torch.ops.dwconv import dwconv_plain

stacked_launch_count = 0        # K11 launches
stacked_band_launch_count = 0   # bf16 K11 launches on stacked_band_kernel
                                # (also above)

STACKED_MAX = 64                # the bf16 kernel's H and W
_WARPS = 8                      # warps a block of the bf16 kernel


def stack_group(h: int, kw: int) -> int:
    """Tap columns a chunk stacks along M: as many whole H-row bands as fill
    the kernel's 64-row tile (the TPU's ``stack_group`` filled its 128
    lanes)."""
    return max(1, min(kw, 64 // h))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def live_masks(H: int, kh: int, kw: int, g: int, mq: int, kt: int
               ) -> list:
    """Each chunk's live 16 x 16 band tiles as the kernel marks them
    (``live_mask``), bit 4 mt + kt: a row t*H + h of a live tap (q*g + t <
    kw) and a column k < H with |k - h| <= kh // 2."""
    pk, out = kh // 2, []
    for q in range(_cdiv(kw, g)):
        rows, m = min(g, kw - q * g) * H, 0
        for mt in range(mq):
            for k in range(kt):
                k0, k1 = 16 * k, min(16 * k + 15, H - 1)
                if any(k0 <= r % H + pk and k1 >= r % H - pk
                       for r in range(16 * mt, min(16 * mt + 16, rows))):
                    m |= 1 << (4 * mt + k)
        out.append(m)
    return out


def stacked_band_geometry(N: int, C: int, H: int, W: int, kh: int, kw: int
                          ) -> Optional[dict]:
    """The bf16 kernel's geometry (``band_geom`` in csrc/dwconv_stacked.cu),
    None where it does not take the shapes: g taps a chunk, nc chunks, MQ
    m-tiles a chunk (g*H to 16), KT k-tiles (H to 16), NZ n-tiles of Z an
    image (W + g - 1 to 8), WZ n-tiles a warp tile, TPI warp tiles an image
    (1 where g > 1: a warp tile is the whole image), RPI staged rows an
    image, NB images a chunk, CPB chunks a block, bpc blocks a channel,
    the shared bytes and the blocks of the launch."""
    if not (1 <= H <= STACKED_MAX and 1 <= W <= STACKED_MAX and N >= 1
            and C >= 1 and kh % 2 == 1 and kw % 2 == 1):
        return None
    g = stack_group(H, kw)
    nc, mq, kt = _cdiv(kw, g), _cdiv(g * H, 16), _cdiv(H, 16)
    nz = _cdiv(W + g - 1, 8)
    if g == 1:                       # Toeplitz tiles, K1's band kernel's
        wz = 4 if mq <= 2 else 2
    else:
        wz = 8 if mq <= 2 else 4
    if g > 1 and nz > wz:
        return None
    tpi = _cdiv(nz, wz)
    rpi = max(8 * nz + (nc - 1) * g, kw // 2 + 8 * _cdiv(W, 8))
    p = 16 * kt + 8
    bpi = _cdiv(H, 8) * _cdiv(W, 8)
    pre = (8 if mq == 1 else 16) * _WARPS
    nb = max(1, min(_WARPS // tpi, pre // bpi, N))
    if nb * bpi > pre:
        return None
    chunks = _cdiv(N, nb)
    per = min(_cdiv(1024, C), chunks)
    cpb = _cdiv(chunks, per)
    zr, zp = (g - 1) * H, 8 * wz + 8
    b_bytes = 16 * _cdiv(nb * rpi * p * 2, 16)
    tiles = 2 * mq - 1 if g == 1 else mq * kt
    smem = (nc * tiles * 16 * 24 * 2 + 16 * _cdiv(4 * nc, 16)
            + 2 * b_bytes + _WARPS * zr * zp * 4)
    if smem > 200 * 1024:
        return None
    bpc = _cdiv(chunks, cpb)
    return dict(g=g, nc=nc, MQ=mq, KT=kt, NZ=nz, WZ=wz, TPI=tpi, RPI=rpi,
                NB=nb, CPB=cpb, bpc=bpc, smem=smem, blocks=C * bpc)


def stacked_band(w: torch.Tensor, H: int, geom: dict, dtype: torch.dtype
                 ) -> torch.Tensor:
    """The stacked bands (C, nc, 16 MQ, 16 KT) in ``dtype`` (the kernel's
    bf16; exact for taps already rounded to it), as float32: chunk q, row
    t*H + h, column k holds w[k - h + kh/2, q*g + t], zero for the dead
    taps q*g + t >= kw, off the taps and in the padding."""
    C, kh, kw = w.shape
    g, nc = geom["g"], geom["nc"]
    m = torch.arange(16 * geom["MQ"], device=w.device)
    k = torch.arange(16 * geom["KT"], device=w.device)
    t, h = m // H, m % H
    j = torch.arange(nc, device=w.device)[:, None] * g + t[None]  # (nc, M)
    i = k[None, :] - h[:, None] + kh // 2                         # (M, K)
    ok = ((t < g)[None, :, None] & (j < kw)[..., None]
          & ((i >= 0) & (i < kh) & (k[None, :] < H))[None])
    band = w[:, i.clamp(0, kh - 1)[None], j.clamp(0, kw - 1)[..., None]]
    return (band * ok).to(dtype).float()


def dwconv_stacked_mirror(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's decomposition in plain PyTorch (any dtype, any
    device): the same function as :func:`dwconv_plain` where
    :func:`stacked_band_geometry` takes the shapes. Each plane staged
    transposed (row u = column u - kw/2, zero outside the map, RPI rows an
    image); each chunk q one product of its stacked band (:func:`stacked_band`,
    in x's dtype) with the staged rows shifted by q*g, all chunks summed
    into Z (fp32, 16 MQ rows x 8 NZ columns); then out[h][w] = Z[h][w] +
    Z[H + h][w + 1] + .. + Z[(g-1) H + h][w + g - 1], in that order, rounded
    once to x.dtype."""
    _check(x, w, None)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    geom = stacked_band_geometry(N, C, H, W, kh, kw)
    if geom is None:
        raise ValueError(f"the stacked band kernel takes no {tuple(x.shape)} "
                         f"with taps {(kh, kw)}")
    g, nc, rpi = geom["g"], geom["nc"], geom["RPI"]
    u_n = 8 * geom["NZ"]
    A = stacked_band(w.to(x.device).float(), H, geom, x.dtype)
    staged = torch.zeros(N, C, rpi, 16 * geom["KT"], device=x.device)
    staged[:, :, kw // 2:kw // 2 + W, :H] = x.float().transpose(2, 3)
    Z = torch.zeros(N, C, 16 * geom["MQ"], u_n, device=x.device)
    for q in range(nc):
        B = staged[:, :, q * g:q * g + u_n]                   # (N, C, U, K)
        Z += torch.einsum("cmk,ncuk->ncmu", A[:, q], B)
    out = Z[:, :, :H, :W]
    for t in range(1, g):
        out = out + Z[:, :, t * H:(t + 1) * H, t:t + W]
    return out.to(x.dtype)


def stacked_band_products(H: int, W: int, kh: int, kw: int, N: int = 1,
                          C: int = 1) -> int:
    """The m16n8k16 products the bf16 kernel issues for N x C planes: per
    image and chunk, each live band tile (:func:`live_masks`; at g = 1 each
    (m-tile, k-tile) on a diagonal d with 16 |d| - 15 <= kh // 2, as the
    Toeplitz tiles are skipped) times the image's NZ n-tiles."""
    geom = stacked_band_geometry(N, C, H, W, kh, kw)
    mq = geom["MQ"]
    if geom["g"] == 1:
        tiles = kw * sum(mq - abs(d) for d in range(1 - mq, mq)
                         if 16 * abs(d) - 15 <= kh // 2)
    else:
        tiles = sum(bin(m).count("1") for m in live_masks(
            H, kh, kw, geom["g"], mq, geom["KT"]))
    return N * C * geom["NZ"] * tiles


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
    geom = lib.slak_dwconv_stacked_geom
    geom.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    geom.restype = ctypes.c_int
    return ok, fn, geom


def stacked_band_kernel_geometry(N: int, C: int, H: int, W: int, kh: int,
                                 kw: int) -> dict:
    """The geometry the bf16 kernel's host code computes (built on first
    use), the keys of :func:`stacked_band_geometry` it reports."""
    v = (ctypes.c_longlong * 13)()
    if _entries()[2](N, C, H, W, kh, kw, v) != 0:
        raise ValueError(f"the stacked band kernel takes no {(N, C, H, W)} "
                         f"with taps {(kh, kw)}")
    keys = ("g", "nc", "MQ", "KT", "NZ", "WZ", "TPI", "RPI", "NB", "CPB",
            "bpc", "smem", "blocks")
    return dict(zip(keys, (int(n) for n in v)))


def stacked_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel :func:`dwconv_stacked` launches for these operands:
    "band" (bf16, ``stacked_band_kernel``) or "simt" (fp32); raises
    ValueError, naming the limits, for bf16 shapes the band kernel does
    not take (:func:`stacked_band_geometry` None: a side above
    STACKED_MAX; where g > 1, W + g - 1 past one warp tile's columns;
    shared memory above 200 KB)."""
    _check(x, w, None)
    if x.dtype != torch.bfloat16:
        return "simt"
    if stacked_band_geometry(*x.shape, w.shape[1], w.shape[2]) is None:
        raise ValueError(
            f"dwconv_stacked: bf16 {tuple(x.shape)} with taps "
            f"{tuple(w.shape[1:])} does not fit the stacked band kernel (H "
            f"and W at most {STACKED_MAX}; for g = min(kw, 64 // H) > 1, "
            f"W + g - 1 within 32 columns, 64 where g*H <= 32; 200 KB of "
            f"shared memory)")
    return "band"


def dwconv_stacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv(x, w) through K11. x: (N, C, H, W) float32 or bfloat16,
    contiguous, H <= 64; w: (C, kh, kw) float32."""
    if x.device.type == "cpu":
        return dwconv_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv_stacked runs on cuda or cpu, not "
                           f"{x.device}")
    _check_cuda("dwconv_stacked", x, w)
    route = stacked_route(x, w)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    ok, fn, _ = _entries()
    dt = _DTYPES[x.dtype]
    if route == "simt" and not ok(dt, N, C, H, W, kh, kw):
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
    global stacked_launch_count, stacked_band_launch_count
    stacked_launch_count += 1
    stacked_band_launch_count += route == "band"
    return out
