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

:func:`dwconv_probe` (K13, ``slak_dwconv_probe``, replaces
``tools/probe_overhead.py`` ``run_variant``, the probe of K1's fixed cost)
is K1 on (K, 5) taps with a tap limit: only the first ``ntaps`` of the 5
tap columns, and with ``ntaps = 0`` a copy of the W-padded input's first W
columns (x shifted right by 2, zero columns on the left), as the TPU
copy-only twin writes. bf16 probes the band kernel (:func:`probe_route`;
``ntaps = 5`` is K1's band launch, fewer taps ``dwconv_band_probe_kernel``;
counted in ``probe_band_launch_count`` besides ``probe_launch_count``),
fp32 the tiled kernel; :func:`dwconv_probe_band_mirror` repeats the band
route's decomposition.

Taps are ``(C, kh, kw)`` float32, already rounded to the compute dtype by
the caller (``models/slak.py`` folds and rounds them once per model), so
the kernel and the plain version multiply the same values. Both accumulate
in fp32 and round once on the store; with ``out`` given the result is added
to ``out`` in place -- the second branch of the decomposed pair adds into
the first one's output.

Two kernels serve K1/K4 on the card, chosen by dtype and shape
(:func:`band_route`): bf16 maps with (K, 5) or (5, K) taps take the band
route (``slak_dwconv_band``, per-channel banded products on the tensor
cores, counted in ``band_launch_count`` / ``band_stats_launch_count``
besides ``launch_count`` / ``stats_launch_count``): whole images on
``dwconv_band_kernel`` where both axes are at most ``BAND_WHOLE_MAX``
(SLaK-T's stages at 224^2), F-slices of an image on
``dwconv_band_slice_kernel`` above (K <= ``BAND_K_MAX``, the long tap
axis at most ``BAND_MAX``: the seg crop's 128^2 stage 1, any input above
256^2); everything else (fp32 K4, square taps, longer taps or axes)
takes the tiled kernel. fp32 K1 with (K, 5) or (5, K)
taps at any map size (:func:`band_f32_route`) takes the 3xTF32 band
kernel of ``csrc/dwconv_f32.cu`` (``slak_dwconv_band_f32``, counted in
``tf32_launch_count`` besides ``launch_count``), and so does fp32 K4 on the
same shapes, with the sums in its epilogue (``slak_dwconv_band_f32_stats``,
route "band_f32", counted in ``tf32_stats_launch_count`` besides
``stats_launch_count``). bf16 K1 and K4 on maps with H * W <= ``P_MAX`` (stage 4's
7x7), any odd taps (:func:`toeplitz2d_route`, checked first), take K6's
kernel, ``csrc/dwconv2d.cu`` (``ops/dwconv2d.py``: one dense product a
channel with the batch on the tensor cores' rows, counted in
``toeplitz_launch_count`` / ``toeplitz_stats_launch_count`` besides
``launch_count`` / ``stats_launch_count``). :func:`launch` and
:func:`launch_stats` launch one named route (the probes hold them against
each other).
:func:`dwconv_band_mirror` and :func:`dwconv_band_stats_mirror` repeat the
band route's decomposition in plain PyTorch: the Toeplitz band tiles, the
staged operand with its halo rows, the shifted rows, the padded tiles
(above 64: the F-slices, the m-bands and the live diagonals), and the K4
partial sums in the kernel's order;
:func:`dwconv_band_f32_mirror` repeats the fp32 kernel's (the TF32 split
of both operands, the live diagonals, the row tiles with their halo, the
three products, the scatter back) and :func:`dwconv_band_f32_stats_mirror`
its K4 sums in the kernel's block and thread order
(:func:`band_f32_stats_sums`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

launch_count = 0               # K1 launches (forward and dgrad)
stats_launch_count = 0         # K4 launches (the stats variant)
probe_launch_count = 0         # K13 launches (the tap-limited probe)
probe_band_launch_count = 0    # K13 launches on the band kernel (also above)
band_launch_count = 0          # K1 launches on the band route (also above)
band_stats_launch_count = 0    # K4 launches on the band route (also above)
tf32_launch_count = 0          # fp32 K1 launches on the 3xTF32 band route
                               # (also in launch_count)
tf32_stats_launch_count = 0    # fp32 K4 launches on the 3xTF32 band route
                               # (also in stats_launch_count)
toeplitz_launch_count = 0      # K1 launches on K6's kernel (also above)
toeplitz_stats_launch_count = 0    # K4 launches on K6's kernel (also above)

BAND_WHOLE_MAX = 64            # dwconv_band_kernel: both map axes, whole
                               # images in 4 tiles of 16
BAND_MAX = 512                 # dwconv_band_slice_kernel: the long tap
                               # axis (F-slices along the other, any size)
BAND_K_MAX = 65                # the slice kernel's taps: 2 live diagonals
                               # each side
F32_ND_MAX = 9                 # the fp32 band kernel's live diagonals
P_MAX = 64                     # K6's kernel: H * W, 8 n-tiles of pixels

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


# --- the band kernel's decomposition in plain PyTorch -----------------------

_THREADS, _WARPS = 256, 8          # the band kernel's block


def band_geometry(N: int, C: int, H: int, W: int, kh: int, kw: int
                  ) -> dict:
    """The band route's launch geometry (``band_geom`` / ``slice_geom`` in
    csrc/dwconv.cu): long_h ((K, 5) taps), the long-tap axis L and the
    other axis F, MT m-tiles of 16 along L, bpc blocks a channel, CPB
    chunks a block, and ``slice``: False where both map axes are at most
    BAND_WHOLE_MAX (:func:`_whole_geometry`), else True
    (:func:`_slice_geometry`)."""
    if max(H, W) <= BAND_WHOLE_MAX:
        return _whole_geometry(N, C, H, W, kh, kw)
    return _slice_geometry(N, C, H, W, kh, kw)


def _whole_geometry(N, C, H, W, kh, kw) -> dict:
    """``dwconv_band_kernel``'s geometry: NTI n-tiles of 8 an image, RPI
    staged rows an image, WN n-tiles a warp tile, BPI 8 x 8 blocks a
    plane, NB whole images a chunk."""
    long_h = kw == 5
    K, L, F = (kh, H, W) if long_h else (kw, W, H)
    mt, nti = -(-L // 16), -(-F // 8)
    bpi = -(-H // 8) * -(-W // 8)
    wn = 4 if mt <= 2 else 2
    nb = max(1, min(8 * wn // nti, (8 if mt == 1 else 16) * _WARPS // bpi, N))
    chunks = -(-N // nb)
    per = min(-(-1024 // C), chunks)
    cpb = -(-chunks // per)
    return dict(slice=False, long_h=long_h, K=K, L=L, F=F, MT=mt, NTI=nti,
                RPI=8 * nti + 4, WN=wn, BPI=bpi, NB=nb, CPB=cpb,
                bpc=-(-chunks // cpb),
                smem=5 * (2 * mt - 1) * 768
                + 2 * -(-nb * (8 * nti + 4) * (16 * mt + 8) * 2 // 16) * 16)


_SLICE_PRE = 16                  # 8 x 8 blocks a lane stages (kSlicePre)


def _slice_geometry(N, C, H, W, kh, kw) -> dict:
    """``dwconv_band_slice_kernel``'s geometry: F cut into NS slices of FS
    = 8 NTI rows (as few as the lanes' staging registers allow, FS / 8
    times the LB 8 x 8 blocks along L at most 128, of equal size to 8), a
    chunk one slice of one image staged as its FS rows between the 2 rows
    of F on each side (RPI = FS + 4, zero off the map); L in NMB m-bands of
    MBR <= 4 m-tiles; NG groups of WN = 2 n-tiles of the slice; a warp's
    unit one (m-band, n-tile group); DL live diagonals of 16 x 16 band
    tiles on each side of the main one; about 512 blocks a launch
    (channels times runs of CPB chunks)."""
    long_h = kw == 5
    K, L, F = (kh, H, W) if long_h else (kw, W, H)
    mt, lb = -(-L // 16), -(-L // 8)
    nmb = -(-mt // 4)
    ftiles = -(-F // 8)
    ns = -(-ftiles // (_SLICE_PRE * _WARPS // lb))
    nti = -(-ftiles // ns)
    chunks = N * ns
    per = min(-(-512 // C), chunks)
    cpb = -(-chunks // per)
    p = 16 * mt + 8
    return dict(slice=True, long_h=long_h, K=K, L=L, F=F, MT=mt, LB=lb,
                NS=ns, NTI=nti, FS=8 * nti, RPI=8 * nti + 4, P=p, NMB=nmb,
                MBR=-(-mt // nmb), WN=2, NG=-(-nti // 2),
                DL=(K // 2 + 15) // 16, CPB=cpb, bpc=-(-chunks // cpb),
                smem=5 * 5 * 768 + 2 * -(-(8 * nti + 4) * p * 2 // 16) * 16)


def band_tiles(w: torch.Tensor, long_h: bool, mt: int) -> torch.Tensor:
    """The channel's band tiles as the kernel builds them: (C, 5, 2 MT - 1,
    16, 16), tile d - (MT - 1) of tap j holding t(16 d + col - r + K/2, j)
    at (r, col), zero off the taps and for tiles off the band, in bf16
    (exact for taps already rounded to bf16), as float32."""
    t = (w if long_h else w.transpose(1, 2)).float()        # (C, K, 5)
    K = t.shape[1]
    d = torch.arange(-(mt - 1), mt, device=w.device)
    r = torch.arange(16, device=w.device)
    k = 16 * d[:, None, None] + r[None, None, :] - r[None, :, None] + K // 2
    ok = (k >= 0) & (k < K) & (16 * d.abs() - 15 <= K // 2)[:, None, None]
    D = t[:, k.clamp(0, K - 1)] * ok[None, ..., None]   # (C, ND, 16, 16, 5)
    return D.permute(0, 4, 1, 2, 3).to(torch.bfloat16).float()


def band_acc(xs: torch.Tensor, D: torch.Tensor, g: dict) -> torch.Tensor:
    """The fp32 output tiles of every image as a band kernel forms them,
    as they lie: xs (N, C, F, L), each plane with the long tap axis L
    contiguous; D the band tiles (:func:`band_tiles`); returns (N, C, L,
    F), C[m][f] of each image. The staged operand holds each image's F rows
    (F padded to 8) between 2 zero halo rows, stacked over the images; each
    n-tile's 8 rows are shifted by the tap j; the band tiles' products are
    summed over the k-tiles on the band. g: the geometry's MT, NTI, RPI
    and K."""
    N, C, F, L = xs.shape
    dev = xs.device
    mt, nti, rpi = g["MT"], g["NTI"], g["RPI"]
    Lp = 16 * mt
    # staged: (C, N * RPI, Lp), row img * RPI + 2 + f
    staged = torch.zeros(C, N, rpi, Lp, device=dev)
    staged[:, :, 2:2 + F, :L] = xs.float().transpose(0, 1)
    staged = staged.reshape(C, N * rpi, Lp)
    T = N * nti
    nt = torch.arange(T, device=dev)
    img, f0 = nt // nti, (nt % nti) * 8
    rows = img * rpi + f0                               # (T,)
    acc = torch.zeros(C, T, Lp, 8, device=dev)
    for j in range(5):
        B = staged[:, (rows[:, None] + j + torch.arange(8, device=dev)
                       )]                               # (C, T, 8, Lp)
        for m in range(mt):
            for k in range(mt):
                if 16 * abs(k - m) - 15 > g["K"] // 2:
                    continue                            # off the band
                A = D[:, j, k - m + mt - 1]             # (C, 16, 16)
                acc[:, :, 16 * m:16 * m + 16] += torch.einsum(
                    "crk,ctnk->ctrn", A, B[..., 16 * k:16 * k + 16])
    # tile (m, f) of n-tile nt -> image img, C[m][f]
    m = torch.arange(Lp, device=dev)
    f = f0[:, None] + torch.arange(8, device=dev)       # (T, 8)
    ok = (m[None, :, None] < L) & (f[:, None, :] < F)   # (T, Lp, 8)
    flat = (img[:, None, None] * (L * F) + m[None, :, None] * F
            + f[:, None, :])[ok]
    os = torch.zeros(C, N * L * F, device=dev)
    os[:, flat] = acc[:, ok]
    return os.reshape(C, N, L, F).transpose(0, 1)


def band_slice_acc(xs: torch.Tensor, D: torch.Tensor, g: dict
                   ) -> torch.Tensor:
    """The fp32 output tiles as the slice kernel forms them: xs (N, C, F,
    L) as :func:`band_acc` takes it, D the live band tiles
    (:func:`band_tiles` at MT = DL + 1: diagonals -DL .. DL); returns (N,
    C, L, F). Slice by slice: the staged rows f0 - 2 .. f0 + FS + 1 (zero
    off the map), L padded to 16 MT; m-band by m-band, each m-tile's
    accumulator summing, tap j by tap, the live diagonals' products
    D_j[d] x (the rows shifted by j, k-tile m-tile + d), d from -DL."""
    N, C, F, L = xs.shape
    mt_n, fs, dl = g["MT"], g["FS"], g["DL"]
    xp = torch.zeros(N, C, g["NS"] * fs + 4, 16 * mt_n, device=xs.device)
    xp[:, :, 2:2 + F, :L] = xs.float()
    out = torch.zeros(N, C, 16 * mt_n, g["NS"] * fs, device=xs.device)
    for sl in range(g["NS"]):
        f0 = sl * fs
        staged = xp[:, :, f0:f0 + fs + 4]
        for mb in range(g["NMB"]):
            m0 = mb * g["MBR"]
            for mt in range(m0, min(m0 + g["MBR"], mt_n)):
                acc = torch.zeros(N, C, 16, fs, device=xs.device)
                for j in range(5):
                    for d in range(-dl, dl + 1):
                        kt = mt + d
                        if 0 <= kt < mt_n:
                            acc += torch.einsum(
                                "crk,ncfk->ncrf", D[:, j, d + dl],
                                staged[:, :, j:j + fs, 16 * kt:16 * kt + 16])
                out[:, :, 16 * mt:16 * mt + 16, f0:f0 + fs] = acc
    return out[:, :, :L, :F]


def _band_tile_products(x, w, g):
    """The fp32 output tile of every image (N, C, H*W) as the band route
    forms it (:func:`band_acc`, :func:`band_slice_acc` on the slice
    geometry): (K, 5) stages x transposed and its tiles are out[h][w],
    (5, K) stages x as it lies and its tiles are out transposed."""
    N, C, H, W = x.shape
    if g["slice"]:
        D = band_tiles(w.to(x.device), g["long_h"], g["DL"] + 1)
        acc = functools.partial(band_slice_acc, D=D, g=g)
    else:
        D = band_tiles(w.to(x.device), g["long_h"], g["MT"])
        acc = functools.partial(band_acc, D=D, g=g)
    if g["long_h"]:
        return acc(x.transpose(2, 3)).reshape(N, C, H * W)
    return acc(x).transpose(2, 3).reshape(N, C, H * W)


def dwconv_band_mirror(x: torch.Tensor, w: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The band route's decomposition in plain PyTorch (any dtype, any
    device): the same function as :func:`dwconv_plain` for taps (K, 5) or
    (5, K) already rounded to bf16 on the shapes :func:`band_takes`
    accepts (whole images up to BAND_WHOLE_MAX a side, F-slices above);
    fp32 sums, one rounding to x.dtype (after the add into ``out``)."""
    _check(x, w, out)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    if not band_takes(H, W, kh, kw):
        raise ValueError(f"the band route takes (K, 5) or (5, K) taps on "
                         f"maps up to {BAND_WHOLE_MAX} a side, or K <= "
                         f"{BAND_K_MAX} with the long axis up to "
                         f"{BAND_MAX}; not {(kh, kw)} on {(H, W)}")
    os = _band_tile_products(x, w, band_geometry(N, C, H, W, kh, kw))
    y = os.reshape(x.shape)
    if out is None:
        return y.to(x.dtype)
    out.copy_(out.float() + y)
    return out


def _block_sum(v: torch.Tensor, warps: int = _WARPS) -> torch.Tensor:
    """The kernels' block reduction of (..., 32 warps) fp32 values (256 by
    default): a butterfly over each warp's 32 lanes (``warp_sum``), then
    the warps' sums added in order from 0."""
    v = v.reshape(*v.shape[:-1], warps, 32)
    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    total = torch.zeros(v.shape[:-2], device=v.device)
    for i in range(warps):
        total = total + v[..., i, 0]
    return total


def _partials_sum(part: torch.Tensor) -> torch.Tensor:
    """The stats reduce kernels' sum of (C, bpc) partials a channel:
    thread t the partials t, t + 256, .. in order, then a block reduction
    (``dwconv_stats_reduce``, ``band_f32_stats_reduce``)."""
    C, bpc = part.shape
    items = -(-bpc // _THREADS) * _THREADS
    part = torch.nn.functional.pad(part, (0, items - bpc)).reshape(
        C, -1, _THREADS)
    t = torch.zeros(C, _THREADS, device=part.device)
    for i in range(part.shape[1]):
        t = t + part[:, i]
    return _block_sum(t)


def _band_store_order(g: dict, N: int, H: int, W: int) -> torch.Tensor:
    """The order of the band route's stores: (bpc, 256, S), for block grp
    of a channel and thread t the flat index n * H * W + h * W + w of its
    s-th stored value, -1 for none (:func:`_band_store_blocks`, padded)."""
    blocks = list(_band_store_blocks(g, N, H, W))
    S = max(b.shape[1] for b in blocks)
    return torch.stack([torch.nn.functional.pad(b, (0, S - b.shape[1]),
                                                value=-1) for b in blocks])


def _band_store_blocks(g: dict, N: int, H: int, W: int):
    """Each block's store order in turn, (256, S_b): the whole-image
    kernel's (:func:`_whole_store_block`; also K10's band kernel, whose
    geometry has no ``slice``) or the slice kernel's
    (:func:`_slice_store_block`)."""
    fn = _slice_store_block if g.get("slice") else _whole_store_block
    for grp in range(g["bpc"]):
        yield fn(g, N, H, W, grp)


def _whole_store_block(g: dict, N: int, H: int, W: int, grp: int
                       ) -> torch.Tensor:
    """Block grp of ``dwconv_band_kernel``: a thread (warp, lane) stores
    chunk by chunk its warp tiles wt = warp, warp + 8, .., each n-tile nn,
    m-tile mt, half hf of the fragment, then the pair's two values: (K, 5)
    at (h, w) = (16 mt + 8 hf + lane / 4, 8 f + 2 (lane % 4) + e), (5, K)
    transposed, at (8 f + lane / 4, 16 mt + 8 hf + 2 (lane % 4) + e)."""
    nb, cpb, nti, wn, mt = g["NB"], g["CPB"], g["NTI"], g["WN"], g["MT"]
    lane = torch.arange(32)
    gid, tig = (lane // 4)[None], (lane % 4)[None]          # (1, 32)
    warp = torch.arange(_WARPS)[:, None]                    # (8, 1)
    n_end = min(N, (grp + 1) * cpb * nb)
    slots = []
    for n in range(grp * cpb * nb, n_end, nb):
        T = min(nb, n_end - n) * nti
        wt_max = -(-T // wn)
        for k in range(-(-wt_max // _WARPS)):
            wt = warp + k * _WARPS
            for nn in range(wn):
                nt = wt * wn + nn                           # (8, 1)
                img, f0 = nt // nti, (nt % nti) * 8
                ok_t = (wt < wt_max) & (nt < T)
                for m in range(mt):
                    for hf in range(2):
                        for e in range(2):
                            if g["long_h"]:
                                r = 16 * m + 8 * hf + gid
                                cc = f0 + 2 * tig + e
                            else:
                                r = f0 + gid
                                cc = 16 * m + 8 * hf + 2 * tig + e
                            ok = ok_t & (r < H) & (cc < W)
                            flat = (n + img) * H * W + r * W + cc
                            slots.append(torch.where(ok, flat, -1))
    return torch.stack(slots, -1).reshape(_THREADS, -1)


def _slice_store_block(g: dict, N: int, H: int, W: int, grp: int
                       ) -> torch.Tensor:
    """Block grp of ``dwconv_band_slice_kernel``: a thread (warp, lane)
    stores chunk by chunk (chunk q: image q / NS, rows f0 = FS (q % NS) ..
    of F) its units wt = warp, warp + 8, .. (m-band wt % NMB, n-tile group
    wt / NMB), each of the group's two n-tiles nn (8 rows of F from f =
    f0 + 8 (2 (wt / NMB) + nn)), the band's m-tiles, the fragment's halves
    hf, then the pair's two values: (K, 5) at (h, w) = (16 mt + 8 hf +
    lane / 4, f + 2 (lane % 4) + e), (5, K) at (f + lane / 4, 16 mt + 8 hf
    + 2 (lane % 4) + e)."""
    q0 = grp * g["CPB"]
    q = torch.arange(q0, min(N * g["NS"], q0 + g["CPB"]))
    n, f0 = q // g["NS"], (q % g["NS"]) * g["FS"]
    units, mbr = g["NMB"] * g["NG"], g["MBR"]
    rounds = -(-units // _WARPS)
    # dims: (chunk, round, nn, i, hf, e, warp, lane)
    sh = (-1, 1, 1, 1, 1, 1, 1, 1)
    n, f0 = n.reshape(sh), f0.reshape(sh)
    wt = (torch.arange(rounds).reshape(1, -1, 1, 1, 1, 1, 1, 1) * _WARPS
          + torch.arange(_WARPS).reshape(1, 1, 1, 1, 1, 1, -1, 1))
    nn = torch.arange(2).reshape(1, 1, -1, 1, 1, 1, 1, 1)
    i = torch.arange(4).reshape(1, 1, 1, -1, 1, 1, 1, 1)
    hf = torch.arange(2).reshape(1, 1, 1, 1, -1, 1, 1, 1)
    e = torch.arange(2).reshape(1, 1, 1, 1, 1, -1, 1, 1)
    lane = torch.arange(32).reshape(1, 1, 1, 1, 1, 1, 1, -1)
    gid, tig = lane // 4, lane % 4
    mb, ng = wt % g["NMB"], wt // g["NMB"]
    m0 = mb * mbr
    ntl = ng * 2 + nn
    mt = m0 + i
    f = f0 + 8 * ntl
    ok = ((wt < units) & (ntl < g["NTI"]) & (i < torch.clamp(
        g["MT"] - m0, max=mbr)))
    if g["long_h"]:
        r, cc = 16 * mt + 8 * hf + gid, f + 2 * tig + e
    else:
        r, cc = f + gid, 16 * mt + 8 * hf + 2 * tig + e
    ok = ok & (r < H) & (cc < W)
    flat = torch.where(ok, n * (H * W) + r * W + cc, -1)
    # -> (warp, lane, chunk, round, nn, i, hf, e)
    return flat.permute(6, 7, 0, 1, 2, 3, 4, 5).reshape(_THREADS, -1)


def band_stats_sums(y: torch.Tensor, kh: int, kw: int):
    """(s1, s2) of the stored y as the band kernel's stats variant sums
    them: each thread the values it stores (``_band_store_order``) and
    their squares in fp32, in order; a block reduction a (image run,
    channel) partial; then ``dwconv_stats_reduce``: thread i the partials
    i, i + 256, .. in order, and a block reduction."""
    N, C, H, W = y.shape
    g = band_geometry(N, C, H, W, kh, kw)
    order = _band_store_order(g, N, H, W).to(y.device)   # (bpc, 256, S)
    flat = y.float().transpose(0, 1).reshape(C, -1)
    vals = torch.where(order >= 0, flat[:, order.clamp(min=0)],
                       torch.zeros((), device=y.device))  # (C, bpc, 256, S)
    s = torch.zeros(vals.shape[:-1], device=y.device)
    q = torch.zeros_like(s)
    for i in range(vals.shape[-1]):
        v = vals[..., i]
        s = s + v
        q = q + v * v
    return _partials_sum(_block_sum(s)), _partials_sum(_block_sum(q))


def dwconv_band_stats_mirror(x: torch.Tensor, w: torch.Tensor):
    """The band kernel's stats variant in plain PyTorch: (y, s1, s2) with
    y from :func:`dwconv_band_mirror` and the sums of the rounded y in the
    kernel's order (:func:`band_stats_sums`)."""
    y = dwconv_band_mirror(x, w)
    return (y, *band_stats_sums(y, w.shape[1], w.shape[2]))


# --- the fp32 band kernel's decomposition in plain PyTorch -----------------

_F32_WARPS = 8                   # warps a block of the fp32 band kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _f32_band(K: int, L: int):
    """(ND, s, e_lo, LTs): the fewest live diagonals of 8 x 8 band tiles
    over the k-tiles' shifts s (k-tile kt holds k = 8 kt - s + [0, 8); the
    first of equals), the first live diagonal e = kt - nt and the map's
    k-tiles at that shift (``f32_geom`` in csrc/dwconv_f32.cu)."""
    pk, lt = K // 2, _cdiv(L, 8)
    best = None
    for s in range(8):
        lts = (L - 1 + s) // 8 + 1
        lo = max((s - pk) // 8, 1 - lt)
        hi = min((7 + pk + s) // 8, lts - 1)
        if best is None or hi - lo + 1 < best[0]:
            best = (hi - lo + 1, s, lo, lts)
    return best


def band_f32_geometry(N: int, C: int, H: int, W: int, kh: int, kw: int
                      ) -> dict:
    """The fp32 band kernel's launch geometry (``f32_geom`` in
    csrc/dwconv_f32.cu): long_h ((K, 5) taps), the long axis L, the other
    F, LT n-tiles of 8 along L, the live diagonals ND, the k-tiles' shift
    s, the first live diagonal e_lo and the map's k-tiles LTs (see
    :func:`_f32_band`), MW n-tiles of 8 a warp tile (4, or LT below),
    warp tiles (32 rows x 8 MW columns, a warp each) a block WL along L
    and WF along the rows, the blocks lblocks along L,
    fblocks along F and gblocks of images a channel (``stack``: NB whole
    images a block, RPI = F + 2 rows each; else BF rows of F a block), the
    staged rows SR, k columns KC and pitch P, the taps' table length, the
    shared bytes and the blocks of the launch."""
    long_h = kw == 5
    K, L, F = (kh, H, W) if long_h else (kw, W, H)
    lt = _cdiv(L, 8)
    nd, shift, e_lo, lts = _f32_band(K, L)
    mw = lt if lt < 3 else 4
    wl = min(_cdiv(lt, mw), _F32_WARPS)
    wf_max = max(1, _F32_WARPS // wl)
    nb = min(N, (32 * wf_max + 2) // (F + 2))
    stack = nb >= 2
    if stack:
        wf, rpi, bf, fblocks, gblocks = (_cdiv(nb * (F + 2) - 2, 32), F + 2,
                                         F, 1, _cdiv(N, nb))
    else:
        nb, rpi = 1, 0
        wf = min(wf_max, _cdiv(F, 32))
        bf, fblocks, gblocks = 32 * wf, _cdiv(F, 32 * wf), N
    sr, kc = 32 * wf + 4, 8 * min(lts, mw * wl + nd - 1)
    p = (sr + (8 - sr) % 32) if long_h else (kc + (4 - kc) % 32)
    tab = 8 * nd + 8
    x_off = _cdiv(10 * tab, 32) * 32
    lblocks = _cdiv(lt, mw * wl)
    return dict(long_h=long_h, K=K, L=L, F=F, LT=lt, ND=nd, s=shift,
                e_lo=e_lo, LTs=lts, MW=mw, WL=wl, WF=wf,
                lblocks=lblocks, fblocks=fblocks, gblocks=gblocks,
                stack=stack, NB=nb, RPI=rpi, BF=bf, SR=sr, KC=kc, P=p,
                tab=tab, warps=wf * wl,
                smem=4 * (x_off + (kc if long_h else sr) * p),
                blocks=C * gblocks * fblocks * lblocks)


def band_f32_blocks(g: dict, N: int):
    """The blocks of a channel in launch order: (n0, nimg, f_lo, rows,
    nt_lo, nt_hi, kt_lo, kt_hi) -- the images, the first row of F and the
    output rows (stacked: image n0 + r // RPI, row r % RPI), the n-tiles
    along L and the k-tiles staged (k-tile kt: k = 8 kt - s + [0, 8))."""
    for gb in range(g["gblocks"]):
        for fb in range(g["fblocks"]):
            for lb in range(g["lblocks"]):
                if g["stack"]:
                    n0 = gb * g["NB"]
                    nimg = min(g["NB"], N - n0)
                    f_lo, rows = 0, nimg * g["RPI"] - 2
                else:
                    n0, nimg, f_lo = gb, 1, fb * g["BF"]
                    rows = min(g["BF"], g["F"] - f_lo)
                nt_lo = lb * g["WL"] * g["MW"]
                nt_hi = min(g["LT"], nt_lo + g["WL"] * g["MW"])
                yield (n0, nimg, f_lo, rows, nt_lo, nt_hi,
                       max(0, nt_lo + g["e_lo"]),
                       min(g["LTs"], nt_hi + g["e_lo"] + g["ND"] - 1))


def _f32_rows(g: dict, blk, r: torch.Tensor):
    """(image, f, inside) of a block's output-row coordinates r: inside =
    a row of an image of the block (stacked: not between images)."""
    n0, nimg, f_lo = blk[:3]
    if g["stack"]:
        img = torch.div(r, g["RPI"], rounding_mode="floor")
        f = r - img * g["RPI"]
    else:
        img, f = torch.zeros_like(r), f_lo + r
    return img, f, (img >= 0) & (img < nimg) & (f >= 0) & (f < g["F"])


def band_f32_tile_index(g: dict, blk, H: int, W: int) -> torch.Tensor:
    """(32 WF, 8 (nt_hi - nt_lo)) flat indices n H W + h W + w of the
    outputs a block stores from its tile (rows r, columns m from 8 nt_lo),
    -1 where it stores none."""
    n0, _, _, rows, nt_lo, nt_hi = blk[:6]
    r = torch.arange(32 * g["WF"])[:, None]
    m = 8 * nt_lo + torch.arange(8 * (nt_hi - nt_lo))[None, :]
    img, f, ok = _f32_rows(g, blk, r)
    ok = ok & (r < rows) & (m < g["L"])
    pos = m * W + f if g["long_h"] else f * W + m
    return torch.where(ok, (n0 + img) * (H * W) + pos, -1)


def _tf32_planes(v: torch.Tensor):
    """(big, small) TF32 planes of v, as ``split`` in csrc/dwconv_f32.cu
    (``ops/mlp.py``'s :func:`tf32_split_plain`)."""
    from slak_tpu_torch.ops.mlp import tf32_split_plain
    return tf32_split_plain(v.reshape(1, -1)).reshape(2, *v.shape).unbind(0)


def band_f32_table(w: torch.Tensor, g: dict) -> torch.Tensor:
    """The taps' band table a channel, (C, 5, 2, TAB), big and small TF32
    planes: entry u of tap j is t(u + 8 e_lo - 7 + K/2 - s, j), zero off
    the taps."""
    t = (w if g["long_h"] else w.transpose(1, 2)).float()      # (C, K, 5)
    ti = torch.arange(g["tab"], device=w.device) + 8 * g["e_lo"] - 7 \
        + g["K"] // 2 - g["s"]
    ok = (ti >= 0) & (ti < g["K"])
    tab = t[:, ti.clamp(0, g["K"] - 1)] * ok[None, :, None]    # (C, TAB, 5)
    return torch.stack(_tf32_planes(tab.transpose(1, 2)), 2)


def dwconv_band_f32_mirror(x: torch.Tensor, w: torch.Tensor,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The fp32 band kernel's decomposition in plain PyTorch (any device):
    the same function as :func:`dwconv_plain` for float32 x and (K, 5) or
    (5, K) taps within F32_ND_MAX live diagonals. Block by block: the
    staged rows (the outputs' rows and 2 more on each side, zero outside
    the map and between stacked images) over the (shifted) k-tiles the
    block's band reaches, both operands split into TF32 planes, for each
    tap j the band of live 8 x 8 tiles D_j[e], e_lo <= e < e_lo + ND, and
    the three products (small x big, big x small, big x big) into a
    partial added into the sums, scattered back to the map; with ``out``,
    added to it."""
    _check(x, w, out)
    if x.dtype != torch.float32:
        raise TypeError(f"the fp32 band kernel takes float32, not {x.dtype}")
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    if not band_f32_route(x, w):
        raise ValueError(f"the fp32 band kernel takes (K, 5) or (5, K) taps "
                         f"within {F32_ND_MAX} live diagonals, not "
                         f"{(kh, kw)} on {(H, W)}")
    g = band_f32_geometry(N, C, H, W, kh, kw)
    dev = x.device
    # (N, C, F, L) shifted by s and padded to whole k-tiles: column k' holds
    # k = k' - s
    xs = x.transpose(2, 3) if g["long_h"] else x
    xs = F.pad(xs, (g["s"], 8 * g["LTs"] - g["L"] - g["s"]))
    tab = band_f32_table(w.to(dev), g)                         # (C, 5, 2, T)
    R, e_lo = 32 * g["WF"], g["e_lo"]
    y = torch.zeros(C, N * H * W, device=dev)
    for blk in band_f32_blocks(g, N):
        n0, _, _, _, nt_lo, nt_hi, kt_lo, kt_hi = blk
        img, f, ok = _f32_rows(g, blk, torch.arange(-2, R + 2))
        staged = xs[(n0 + img).clamp(0, N - 1), :, f.clamp(0, g["F"] - 1),
                    8 * kt_lo:8 * kt_hi] * ok[:, None, None]    # (SR, C, kc)
        ab, a_s = _tf32_planes(staged.transpose(0, 1))
        k = 8 * kt_lo + torch.arange(8 * (kt_hi - kt_lo), device=dev)
        m = 8 * nt_lo + torch.arange(8 * (nt_hi - nt_lo), device=dev)
        e = k[:, None] // 8 - m[None, :] // 8 - e_lo
        live = (e >= 0) & (e < g["ND"])
        u = (8 * e + k[:, None] % 8 - m[None, :] % 8 + 7).clamp(
            0, g["tab"] - 1)
        acc = torch.zeros(C, R, m.numel(), device=dev)
        for j in range(5):
            tb, ts = (tab[:, j, p][:, u] * live for p in (0, 1))
            a, s_ = ab[:, j:j + R], a_s[:, j:j + R]
            acc += s_ @ tb + a @ ts + a @ tb
        idx = band_f32_tile_index(g, blk, H, W).to(dev)
        y[:, idx[idx >= 0]] = acc[:, idx >= 0]
    y = y.reshape(C, N, H, W).transpose(0, 1)
    if out is None:
        return y.contiguous()
    out.copy_(out + y)
    return out


def band_f32_store_order(g: dict, N: int, H: int, W: int) -> torch.Tensor:
    """The order of the fp32 band kernel's stores, (bpc, 32 warps, S): for
    block b of a channel (:func:`band_f32_blocks`' order) and thread (warp
    wf WL + wl, lane) the flat index n H W + h W + w of its s-th stored
    value, -1 for none. A thread stores, for each f-tile ft and half hf,
    row r = 32 wf + 16 ft + 8 hf + lane / 4 (not past the block's rows, not
    between stacked images), each n-tile nt of its warp tile and e < 2,
    column m = 8 (nt_lo + wl MW + nt) + 2 (lane % 4) + e (on the map)."""
    lane = torch.arange(32).reshape(1, 1, 1, 1, 1, -1)
    warp = torch.arange(g["warps"]).reshape(-1, 1, 1, 1, 1, 1)
    ft = torch.arange(2).reshape(1, -1, 1, 1, 1, 1)
    hf = torch.arange(2).reshape(1, 1, -1, 1, 1, 1)
    nt = torch.arange(g["MW"]).reshape(1, 1, 1, -1, 1, 1)
    e = torch.arange(2).reshape(1, 1, 1, 1, -1, 1)
    wf, wl = warp // g["WL"], warp % g["WL"]
    r = 32 * wf + 16 * ft + 8 * hf + lane // 4
    blocks = []
    for blk in band_f32_blocks(g, N):
        n0, _, _, rows, nt_lo = blk[:5]
        m = 8 * (nt_lo + wl * g["MW"] + nt) + 2 * (lane % 4) + e
        img, f, ok = _f32_rows(g, blk, r)
        ok = ok & (r < rows) & (m < g["L"])
        pos = m * W + f if g["long_h"] else f * W + m
        flat = torch.where(ok, (n0 + img) * (H * W) + pos, -1)
        # -> (warp, lane, ft, hf, nt, e)
        blocks.append(flat.permute(0, 5, 1, 2, 3, 4).reshape(
            32 * g["warps"], -1))
    return torch.stack(blocks)


def band_f32_stats_sums(y: torch.Tensor, kh: int, kw: int):
    """(s1, s2) of the stored fp32 y as the fp32 band kernel's stats
    variant sums them: each thread the values it stores
    (:func:`band_f32_store_order`) and their squares, in order; a block
    reduction over the block's warps a partial; then
    ``band_f32_stats_reduce``: thread i the partials i, i + 256, .. in
    order, and a block reduction (where a channel has one block, its
    partial is the sum)."""
    N, C, H, W = y.shape
    g = band_f32_geometry(N, C, H, W, kh, kw)
    order = band_f32_store_order(g, N, H, W).to(y.device)
    flat = y.float().transpose(0, 1).reshape(C, -1)
    vals = torch.where(order >= 0, flat[:, order.clamp(min=0)],
                       torch.zeros((), device=y.device))  # (C, bpc, T, S)
    s = torch.zeros(vals.shape[:-1], device=y.device)
    q = torch.zeros_like(s)
    for i in range(vals.shape[-1]):
        v = vals[..., i]
        s = s + v
        q = q + v * v
    parts = (_block_sum(t, g["warps"]) for t in (s, q))      # (C, bpc)
    if order.shape[0] == 1:
        return tuple(t[:, 0] for t in parts)
    return tuple(_partials_sum(t) for t in parts)


def dwconv_band_f32_stats_mirror(x: torch.Tensor, w: torch.Tensor):
    """The fp32 band kernel's stats variant (K4) in plain PyTorch: (y, s1,
    s2) with y from :func:`dwconv_band_f32_mirror` and the sums of y in
    the kernel's order (:func:`band_f32_stats_sums`)."""
    y = dwconv_band_f32_mirror(x, w)
    return (y, *band_f32_stats_sums(y, w.shape[1], w.shape[2]))


def band_f32_route(x: torch.Tensor, w: torch.Tensor) -> bool:
    """True where the CUDA wrappers launch the fp32 band kernel: float32,
    taps (K, 5) or (5, K) with K != 5, at most F32_ND_MAX live diagonals
    (every K up to 65, any K where the long axis is at most 40), any map
    size."""
    kh, kw = w.shape[1], w.shape[2]
    if x.dtype != torch.float32 or (kh == 5) == (kw == 5):
        return False
    K, L = (kh, x.shape[2]) if kw == 5 else (kw, x.shape[3])
    return _f32_band(K, L)[0] <= F32_ND_MAX


def toeplitz2d_route(x: torch.Tensor, w: torch.Tensor) -> bool:
    """True where the CUDA wrappers launch K6's kernel
    (``csrc/dwconv2d.cu``): bf16 and H * W <= P_MAX, any odd taps (stage
    4's 7x7 maps, taken before the band route)."""
    return (x.dtype == torch.bfloat16
            and x.shape[2] * x.shape[3] <= P_MAX)


def band_takes(H: int, W: int, kh: int, kw: int) -> bool:
    """The shapes the band route takes: taps (K, 5) or (5, K) with K != 5
    on maps with both axes at most BAND_WHOLE_MAX (``dwconv_band_kernel``)
    or, above, with K <= BAND_K_MAX and the long tap axis at most BAND_MAX
    (``dwconv_band_slice_kernel``, F any size)."""
    if (kh == 5) == (kw == 5):
        return False
    if max(H, W) <= BAND_WHOLE_MAX:
        return True
    K, L = (kh, H) if kw == 5 else (kw, W)
    return K <= BAND_K_MAX and L <= BAND_MAX and H * W <= 1 << 30


def band_route(x: torch.Tensor, w: torch.Tensor) -> bool:
    """True where the CUDA wrappers launch the band route: bf16 on the
    shapes :func:`band_takes` accepts."""
    return (x.dtype == torch.bfloat16
            and band_takes(x.shape[2], x.shape[3], w.shape[1], w.shape[2]))


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
    scratch.argtypes = ([ctypes.c_int, ctypes.c_longlong]
                        + [ctypes.c_int] * 5)
    scratch.restype = ctypes.c_longlong
    fn = lib.slak_dwconv_stats
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return scratch, fn


@functools.lru_cache(maxsize=None)
def _band_entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwconv")
    fn = lib.slak_dwconv_band
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    st = lib.slak_dwconv_band_stats
    st.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    st.restype = ctypes.c_int
    return fn, st


@functools.lru_cache(maxsize=None)
def _band_geom_entry():
    from slak_tpu_torch.ops._build import load
    fn = load("dwconv").slak_dwconv_band_geom
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def band_kernel_geometry(N: int, C: int, H: int, W: int, kh: int,
                         kw: int) -> dict:
    """The geometry the band route's host code computes (built on first
    use), the keys of :func:`band_geometry` it reports: the whole-image
    kernel's slice, MT, NTI, NB, CPB, bpc and smem, or the slice kernel's
    slice, MT, NTI, NS, NMB, MBR, NG, DL, CPB, bpc and smem."""
    v = (ctypes.c_longlong * 11)()
    if _band_geom_entry()(N, C, H, W, kh, kw, v) != 0:
        raise ValueError(f"the band route takes no {(N, C, H, W)} with "
                         f"taps {(kh, kw)}")
    if v[0]:
        keys = ("slice", "MT", "NTI", "NS", "NMB", "MBR", "NG", "DL", "CPB",
                "bpc", "smem")
        return {k: (bool(n) if k == "slice" else int(n))
                for k, n in zip(keys, v)}
    return dict(slice=False, MT=v[1], NTI=v[2], NB=v[3], CPB=v[8], bpc=v[9],
                smem=v[10])


@functools.lru_cache(maxsize=None)
def _band_f32_entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwconv_f32")
    fn = lib.slak_dwconv_band_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    geom = lib.slak_dwconv_band_f32_geom
    geom.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    geom.restype = ctypes.c_int
    return fn, geom


@functools.lru_cache(maxsize=None)
def _band_f32_stats_entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwconv_f32")
    scratch = lib.slak_dwconv_band_f32_stats_scratch
    scratch.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    fn = lib.slak_dwconv_band_f32_stats
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return scratch, fn


def band_f32_kernel_geometry(N: int, C: int, H: int, W: int, kh: int,
                             kw: int) -> dict:
    """The geometry the fp32 band kernel's host code computes (built on
    first use), the keys of :func:`band_f32_geometry` it reports."""
    v = (ctypes.c_longlong * 10)()
    if _band_f32_entries()[1](N, C, H, W, kh, kw, v) != 0:
        raise ValueError(f"the fp32 band kernel takes no {(N, C, H, W)} "
                         f"with taps {(kh, kw)}")
    keys = ("blocks", "warps", "ND", "smem", "stack", "NB", "fblocks",
            "lblocks", "s", "e_lo")
    return {k: (bool(n) if k == "stack" else int(n)) for k, n in zip(keys, v)}


def _check_cuda(name, x, w, out=None):
    _check(x, w, out)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if w.device != x.device:
        raise ValueError("taps and input on different devices")
    if not (x.is_contiguous() and w.is_contiguous()
            and (out is None or out.is_contiguous())):
        raise ValueError(f"{name} needs contiguous tensors")


def _on_cuda(name, x):
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu, not {x.device}")


def _is_band(route: str, x: torch.Tensor) -> bool:
    if route not in ("band", "tiled"):
        raise ValueError(f"route is 'band' or 'tiled', not {route!r}")
    if route == "band" and x.dtype != torch.bfloat16:
        raise TypeError(f"the band kernel takes bfloat16, not {x.dtype}")
    return route == "band"


def launch_stats(route: str, x: torch.Tensor, w: torch.Tensor):
    """One K4 launch on ``route`` ("toeplitz2d", "band", "band_f32" or
    "tiled"), counted: (conv(x, w), s1, s2). :func:`dwconv_stats` picks
    the route; probes call this to hold one route against another at the
    same shapes."""
    global stats_launch_count, band_stats_launch_count
    global toeplitz_stats_launch_count, tf32_stats_launch_count
    if route == "band_f32":
        if x.dtype != torch.float32:
            raise TypeError(f"the fp32 band kernel takes float32, not "
                            f"{x.dtype}")
        _on_cuda("dwconv_stats", x)
        _check_cuda("dwconv_stats", x, w)
        N, C, H, W = x.shape
        kh, kw = w.shape[1], w.shape[2]
        scratch_fn, fn = _band_f32_stats_entries()
        n_part = scratch_fn(N, C, H, W, kh, kw)
        if n_part < 0:
            raise RuntimeError(f"dwconv_stats: the band_f32 kernel takes no "
                               f"{tuple(x.shape)} with taps {(kh, kw)}")
        out = torch.empty_like(x)
        buf = torch.empty(n_part + 2 * C, dtype=torch.float32,
                          device=x.device)             # partials, then sums
        part, sums = buf[:n_part], buf[n_part:].view(2, C)
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
                 sums[0].data_ptr(), sums[1].data_ptr(), N, C, H, W, kh, kw,
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"dwconv_stats band_f32 kernel launch failed: "
                               f"cudaError {err}")
        stats_launch_count += 1
        tf32_stats_launch_count += 1
        return out, sums[0], sums[1]
    if route == "toeplitz2d":
        from slak_tpu_torch.ops import dwconv2d
        _on_cuda("dwconv_stats", x)
        _check_cuda("dwconv_stats", x, w)
        res = dwconv2d.run_stats(x, w)
        stats_launch_count += 1
        toeplitz_stats_launch_count += 1
        return res
    band = _is_band(route, x)
    _on_cuda("dwconv_stats", x)
    _check_cuda("dwconv_stats", x, w)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    scratch_fn, tiled_fn = _stats_entries()
    n_part = scratch_fn(int(band), N, C, H, W, kh, kw)
    if n_part < 0:
        raise RuntimeError(f"dwconv_stats: the {route} kernel takes no "
                           f"{tuple(x.shape)} with taps {(kh, kw)}")
    out = torch.empty_like(x)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device)
    sums = torch.empty(2, C, dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = (_band_entries()[1](*ptrs, N, C, H, W, kh, kw, stream) if band
           else tiled_fn(_DTYPES[x.dtype], *ptrs, N, C, H, W, kh, kw,
                         stream))
    if err != 0:
        raise RuntimeError(f"dwconv_stats {route} kernel launch failed: "
                           f"cudaError {err}")
    stats_launch_count += 1
    band_stats_launch_count += band
    return out, sums[0], sums[1]


def dwconv_stats(x: torch.Tensor, w: torch.Tensor):
    """(conv(x, w), s1, s2): the conv and the fp32 per-channel sums of its
    stored output and of the output's square over (N, H, W)."""
    if x.device.type == "cpu":
        return dwconv_stats_plain(x, w)
    _on_cuda("dwconv_stats", x)
    return launch_stats(_stats_route_of(x, w), x, w)


def _stats_route_of(x: torch.Tensor, w: torch.Tensor) -> str:
    return ("toeplitz2d" if toeplitz2d_route(x, w) else
            "band" if band_route(x, w) else
            "band_f32" if band_f32_route(x, w) else "tiled")


def _route_of(x: torch.Tensor, w: torch.Tensor) -> str:
    return ("toeplitz2d" if toeplitz2d_route(x, w) else
            "band" if band_route(x, w) else
            "band_f32" if band_f32_route(x, w) else "tiled")


def launch(route: str, x: torch.Tensor, w: torch.Tensor,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One K1 launch on ``route`` ("toeplitz2d", "band", "band_f32" or
    "tiled"), counted: conv(x, w) (+ out, in place, when given).
    :func:`dwconv` picks the route; probes call this to hold one route
    against another at the same shapes."""
    global launch_count, band_launch_count, tf32_launch_count
    global toeplitz_launch_count
    if route not in ("toeplitz2d", "band", "band_f32", "tiled"):
        raise ValueError(f"route is 'toeplitz2d', 'band', 'band_f32' or "
                         f"'tiled', not {route!r}")
    if route == "toeplitz2d":
        from slak_tpu_torch.ops import dwconv2d
        _on_cuda("dwconv", x)
        _check_cuda("dwconv", x, w, out)
        out = dwconv2d.run(x, w, out)
        launch_count += 1
        toeplitz_launch_count += 1
        return out
    f32 = route == "band_f32"
    if f32 and x.dtype != torch.float32:
        raise TypeError(f"the fp32 band kernel takes float32, not {x.dtype}")
    band = not f32 and _is_band(route, x)
    _on_cuda("dwconv", x)
    _check_cuda("dwconv", x, w, out)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    accumulate = out is not None
    if out is None:
        out = torch.empty_like(x)
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr())
    tail = (N, C, H, W, kh, kw, int(accumulate),
            torch.cuda.current_stream(x.device).cuda_stream)
    err = (_band_entries()[0](*ptrs, *tail) if band
           else _band_f32_entries()[0](*ptrs, *tail) if f32
           else _entry()(_DTYPES[x.dtype], *ptrs, *tail))
    if err != 0:
        raise RuntimeError(f"dwconv {route} kernel launch failed: cudaError "
                           f"{err}")
    launch_count += 1
    band_launch_count += band
    tf32_launch_count += f32
    return out


def dwconv(x: torch.Tensor, w: torch.Tensor,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv(x, w) (+ out, in place, when given). x: (N, C, H, W) float32 or
    bfloat16, contiguous; w: (C, kh, kw) float32."""
    if x.device.type == "cpu":
        return dwconv_plain(x, w, out)
    _on_cuda("dwconv", x)
    return launch(_route_of(x, w), x, w, out)


def _check_probe(x, w, ntaps):
    _check(x, w, None)
    kh, kw = w.shape[1:]
    if kw != 5 or kh == 5:
        raise ValueError(f"dwconv_probe takes (K, 5) taps, got {(kh, kw)}")
    if not 0 <= ntaps <= kw:
        raise ValueError(f"ntaps must be in 0..{kw}, got {ntaps}")


def dwconv_probe_plain(x: torch.Tensor, w: torch.Tensor,
                       ntaps: int) -> torch.Tensor:
    """Plain version of K13: the conv with the tap columns >= ntaps zeroed;
    ntaps = 0: x shifted right by kw // 2 along W, zeros on the left."""
    _check_probe(x, w, ntaps)
    if ntaps == 0:
        ps = w.shape[2] // 2
        return F.pad(x, (ps, 0))[..., :x.shape[3]].contiguous()
    wt = w.clone()
    wt[:, :, ntaps:] = 0
    return dwconv_plain(x, wt)


def probe_route(x: torch.Tensor, w: torch.Tensor, ntaps: int) -> str:
    """The kernel :func:`dwconv_probe` launches for these operands: "band"
    (bf16: the band kernel) or "tiled" (fp32); raises ValueError for taps
    other than (K, 5) and for bf16 maps outside :func:`band_route`."""
    _check_probe(x, w, ntaps)
    if x.dtype != torch.bfloat16:
        return "tiled"
    if not (band_route(x, w) and max(x.shape[2:]) <= BAND_WHOLE_MAX):
        raise ValueError(f"dwconv_probe: bf16 runs on the band kernel, maps "
                         f"up to {BAND_WHOLE_MAX} a side, not "
                         f"{tuple(x.shape[2:])}")
    return "band"


def dwconv_probe_band_mirror(x: torch.Tensor, w: torch.Tensor,
                             ntaps: int) -> torch.Tensor:
    """K13's band route in plain PyTorch: :func:`dwconv_band_mirror` on the
    taps' first ``ntaps`` columns (the later ones zero); with ``ntaps = 0``
    the staged operand's j = 0 rows moved into the output tiles as they lie
    (the kernel's movmatrix transposes, here the identity band tile of tap
    0), rounded to x.dtype."""
    _check_probe(x, w, ntaps)
    if ntaps:
        wt = w.clone()
        wt[:, :, ntaps:] = 0
        return dwconv_band_mirror(x, wt)
    N, C, H, W = x.shape
    g = band_geometry(N, C, H, W, w.shape[1], w.shape[2])
    D = torch.zeros(C, 5, 2 * g["MT"] - 1, 16, 16, device=x.device)
    D[:, 0, g["MT"] - 1] = torch.eye(16, device=x.device)
    y = band_acc(x.transpose(2, 3), D, g)
    return y.reshape(x.shape).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _probe_entry():
    from slak_tpu_torch.ops._build import load
    fn = load("dwconv").slak_dwconv_probe
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dwconv_probe(x: torch.Tensor, w: torch.Tensor,
                 ntaps: int) -> torch.Tensor:
    """K13: K1 on (K, 5) taps with only the first ``ntaps`` tap columns
    (0 = the padded-input copy). x: (N, C, H, W) float32 or bfloat16 (bf16
    maps up to BAND_WHOLE_MAX a side)."""
    if x.device.type == "cpu":
        return dwconv_probe_plain(x, w, ntaps)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv_probe runs on cuda or cpu, not "
                           f"{x.device}")
    _check_cuda("dwconv_probe", x, w)
    route = probe_route(x, w, ntaps)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    out = torch.empty_like(x)
    err = _probe_entry()(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                         out.data_ptr(), N, C, H, W, kh, kw, ntaps,
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwconv_probe {route} kernel launch failed: "
                           f"cudaError {err}")
    global probe_launch_count, probe_band_launch_count
    probe_launch_count += 1
    probe_band_launch_count += route == "band"
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
