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

Two kernels serve K10 on the card, chosen from the shapes
(:func:`pair_band_route`): the dual eval stage's launch -- bf16,
``dualboth``, the raw pair, taps (K, 5) / (5, K) with K > 5, a square map
of side at most ``BAND_MAX`` -- takes the band kernel
(``slak_dwpair_band``, both branches as per-channel banded products on
the tensor cores in one launch, counted in ``pair_band_launch_count``
besides ``pair_launch_count``); everything else (fp32, the summed modes,
other taps, larger or non-square maps) takes ``dwpair_kernel``, the taps
on the CUDA cores. :func:`launch` launches one named route (the probes
hold them against each other). :func:`dwpair_band_mirror` repeats the
band kernel's decomposition in plain PyTorch, and
:func:`pair_band_geometry` / :func:`pair_band_blocks` its launch
geometry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from slak_tpu_torch.ops import dwconv as K1

pair_launch_count = 0       # K10 launches
pair_band_launch_count = 0  # K10 launches on the band route (also above)

BAND_MAX = 64               # the band kernel's map side: 4 tiles of 16

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


# --- the band kernel's route, geometry and decomposition --------------------

def pair_band_route(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    tmode: str, sum_out: bool) -> bool:
    """True where :func:`dwpair` launches the band kernel, decided from the
    shapes alone: bf16, ``tmode="dualboth"`` with ``sum_out=False`` (the
    raw pair of the dual eval stage), taps (K, 5) / (5, K) with K > 5, and
    a square map (H == W) of side at most BAND_MAX -- all four SLaK-T
    stages at 224^2, stage 4's (13, 5) on 7x7 too. Non-square maps stay on
    ``dwpair_kernel``: there the two branches' long axes differ (H for
    branch 1, W for branch 2), so they would need different m-tile counts,
    and no dual stage has one."""
    N, C, H, W = x.shape
    K, s = w1.shape[1], w1.shape[2]
    return (x.dtype == torch.bfloat16 and tmode == "dualboth"
            and not sum_out and s == 5 and K > 5
            and tuple(w2.shape[1:]) == (s, K) and H == W
            and 1 <= H <= BAND_MAX and N >= 1)


def pair_band_geometry(N: int, C: int, H: int, W: int, K: int) -> dict:
    """The band kernel's launch geometry (``pair_band_geom`` in
    csrc/dwpair.cu), for a square map of side H = W: MT m-tiles of 16 along
    the side, NTI n-tiles of 8 an image, RPI staged rows an image, WN
    n-tiles a warp tile, BPI 8 x 8 blocks a plane, NB images a chunk, CPB
    chunks a block, bpc blocks a channel and branch, blocks in all (both
    branches), smem shared bytes a block. Both branches store as
    ``ops/dwconv.py``'s (K, 5) orientation does (``long_h``): row m along
    the long axis, columns f contiguous."""
    if H != W or not 1 <= H <= BAND_MAX or K <= 5 or K % 2 == 0:
        raise ValueError(f"the band kernel takes (K, 5) / (5, K) taps, K > "
                         f"5 odd, on square maps up to {BAND_MAX}, not K = "
                         f"{K} on {(H, W)}")
    mt, nti = -(-H // 16), -(-H // 8)
    bpi = (-(-H // 8)) ** 2
    wn = 4 if mt <= 2 else 2
    nb = max(1, min(8 * wn // nti, (8 if mt == 1 else 16) * 8 // bpi, N))
    chunks = -(-N // nb)
    per = min(-(-1024 // C), chunks)
    cpb = -(-chunks // per)
    bpc = -(-chunks // cpb)
    rpi, pitch = 8 * nti + 4, 16 * mt + 8
    smem = 5 * (2 * mt - 1) * 16 * 24 * 2 + 2 * (
        -(-(nb * rpi * pitch * 2) // 16) * 16)
    return dict(long_h=True, N=N, C=C, K=K, L=H, F=H, MT=mt, NTI=nti,
                RPI=rpi, WN=wn, BPI=bpi, NB=nb, CPB=cpb, bpc=bpc,
                blocks=2 * C * bpc, smem=smem)


def pair_band_blocks(g: dict) -> torch.Tensor:
    """The kernel's block -> work map: (blocks, 4) rows (branch, channel,
    first image, end image) for blockIdx.x = 0 .. blocks - 1; branch 0
    writes y1 from xq, branch 1 y2q from x. Each block walks its images
    in chunks of NB and stores them as ``ops/dwconv.py``'s
    ``_band_store_order`` lists for its run (``long_h``)."""
    b = torch.arange(g["blocks"])
    per = g["C"] * g["bpc"]
    branch, rem = b // per, b % per
    first = (rem // g["C"]) * g["CPB"] * g["NB"]
    end = torch.clamp(first + g["CPB"] * g["NB"], max=g["N"])
    return torch.stack([branch, rem % g["C"], first, end], 1)


def dwpair_band_mirror(x: torch.Tensor, xq: torch.Tensor, w1: torch.Tensor,
                       w2: torch.Tensor, sums: bool = False):
    """The band kernel's decomposition in plain PyTorch (any dtype, any
    device): the raw pair (y1, y2 in the q orientation) of
    ``dwpair_plain(x, w1, w2, "dualboth", xq, sum_out=False)`` for taps
    (K, 5) / (5, K) already rounded to bf16 on a square map up to
    BAND_MAX. Branch 1 stages xq as it lies (long axis H contiguous) and
    its tiles are y1[h][w]; branch 2 stages x as it lies (long axis W) and
    its tiles are y2q[w][h]; both through ``ops/dwconv.py``'s band tiles
    and ``band_acc``. Each branch's fp32 sums are rounded once to x.dtype,
    or with ``sums`` returned as they are."""
    _check(x, w1, w2, "dualboth", xq)
    N, C, H, W = x.shape
    K = w1.shape[1]
    if w1.shape[2] != 5:
        raise ValueError(f"the band kernel takes (K, 5) taps, not "
                         f"{tuple(w1.shape[1:])}")
    g = pair_band_geometry(N, C, H, W, K)
    xq = x.transpose(2, 3) if xq is None else xq
    y1 = K1.band_acc(xq, K1.band_tiles(w1.to(x.device), True, g["MT"]), g)
    y2q = K1.band_acc(x, K1.band_tiles(w2.to(x.device), False, g["MT"]), g)
    if sums:
        return y1, y2q
    return y1.to(x.dtype), y2q.to(x.dtype)


# --- the launches ------------------------------------------------------------

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


@functools.lru_cache(maxsize=None)
def _band_entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwpair")
    fn = lib.slak_dwpair_band
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    geom = lib.slak_dwpair_band_geom
    geom.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    geom.restype = ctypes.c_int
    return fn, geom


def pair_band_kernel_geometry(N: int, C: int, H: int, W: int, K: int
                              ) -> dict:
    """The geometry the band kernel's host code computes (built on first
    use), the keys of :func:`pair_band_geometry` it reports."""
    v = (ctypes.c_longlong * 8)()
    if _band_entries()[1](N, C, H, W, K, 5, v) != 0:
        raise ValueError(f"the band kernel takes no {(N, C, H, W)} with "
                         f"taps ({K}, 5)")
    keys = ("MT", "NTI", "RPI", "NB", "CPB", "bpc", "blocks", "smem")
    return {k: int(n) for k, n in zip(keys, v)}


def launch(route: str, x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           tmode: str = "kernel", xq: Optional[torch.Tensor] = None,
           sum_out: bool = True):
    """One K10 launch on ``route``, counted: "band" (``dwpair_band_kernel``,
    the shapes :func:`pair_band_route` takes) or "simt"
    (``dwpair_kernel``, every mode and dtype). :func:`dwpair` picks the
    route; probes call this to hold one route against the other at the
    same shapes. Returns what :func:`dwpair` returns."""
    if route not in ("band", "simt"):
        raise ValueError(f"route is 'band' or 'simt', not {route!r}")
    if x.device.type != "cuda":
        raise RuntimeError(f"dwpair runs on cuda or cpu, not {x.device}")
    _check(x, w1, w2, tmode, xq)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwpair takes float32 or bfloat16, not {x.dtype}")
    band = route == "band"
    if band and not pair_band_route(x, w1, w2, tmode, sum_out):
        raise ValueError(f"the band kernel takes bf16 dualboth raw pairs "
                         f"with (K, 5) taps, K > 5, on square maps up to "
                         f"{BAND_MAX}; not {x.dtype} {tmode} sum_out="
                         f"{sum_out} taps {tuple(w1.shape[1:])} on "
                         f"{tuple(x.shape)}")
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
    y = torch.empty_like(x)
    y2q = torch.empty(n, c, w, h, dtype=x.dtype, device=x.device) \
        if raw else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if band:
        err = _band_entries()[0](x.data_ptr(), xq.data_ptr(), w1.data_ptr(),
                                 w2.data_ptr(), y.data_ptr(),
                                 y2q.data_ptr(), n, c, h, w, K, s, stream)
    else:
        ok, fn = _entries()
        if not ok(n, c, h, w, K, s, int(dual_in), int(raw)):
            raise ValueError(f"dwpair: taps ({K}, {s}) on {tuple(x.shape)} "
                             f"do not fit the kernel (s in 3/5/7 and a row "
                             f"tile of the map in 96 KB of shared memory)")
        err = fn(_DTYPES[x.dtype], x.data_ptr(),
                 xq.data_ptr() if dual_in else None, w1.data_ptr(),
                 w2.data_ptr(), y.data_ptr(),
                 None if y2q is None else y2q.data_ptr(), n, c, h, w, K, s,
                 int(dual_in), int(raw), stream)
    if err != 0:
        raise RuntimeError(f"dwpair {route} kernel launch failed: cudaError "
                           f"{err}")
    global pair_launch_count, pair_band_launch_count
    pair_launch_count += 1
    pair_band_launch_count += band
    return (y, y2q) if raw else y


def dwpair(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           tmode: str = "kernel", xq: Optional[torch.Tensor] = None,
           sum_out: bool = True):
    """The pair in one launch: y, or with a dual-out ``tmode`` and
    ``sum_out=False`` the raw pair (y1, y2 in the q orientation). x (and
    xq): float32 or bfloat16, contiguous; w1, w2: float32. The route is
    :func:`pair_band_route`'s."""
    if x.device.type == "cpu":
        return dwpair_plain(x, w1, w2, tmode, xq, sum_out)
    _check(x, w1, w2, tmode, xq)
    route = "band" if pair_band_route(x, w1, w2, tmode, sum_out) else "simt"
    return launch(route, x, w1, w2, tmode, xq, sum_out)
