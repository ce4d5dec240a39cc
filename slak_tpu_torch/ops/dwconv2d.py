"""K6: the depthwise conv on small maps (H * W <= P_MAX) as one dense
product a channel, bf16, NCHW.

Kernel: ``csrc/dwconv2d.cu`` (replaces ``slak_tpu/ops/pallas_banded.py``
``dwconv_banded2d_cmajor``, the doubly blocked Toeplitz product of stage
4's 7x7 maps, and with the BN-sum epilogue the 2-D branch of
``dwconv_banded_stats_cmajor_vjp``). It computes K1's function
(``ops/dwconv.py``): :func:`slak_tpu_torch.ops.dwconv.dwconv` and
:func:`~slak_tpu_torch.ops.dwconv.dwconv_stats` launch it for bf16 CUDA
tensors where :func:`~slak_tpu_torch.ops.dwconv.toeplitz2d_route` says so
(route ``"toeplitz2d"``), and the dgrad is the same launch on the flipped
taps. The plain versions are ``ops/dwconv.py``'s :func:`dwconv_plain` and
:func:`dwconv_stats_plain`.

For each channel c, with P = H * W pixels and A2_c = :func:`toeplitz2d`,
the kernel forms, over tiles of 64 images, ``Y^T (64 x P) = X^T (64 x P)
A2_c^T`` on the tensor cores: the images on the 64 rows (four m16 tiles,
a warp each; a block's 8 warps take the two channels of a run), the output
pixels on N (P padded to 8), the input pixels on k (P padded to 16). :func:`dwconv2d_geometry` repeats the launch geometry
(``geom2d`` in the source), :func:`dwconv2d_mirror` the decomposition (the
padded A2 in bf16, the image tiles with their masked rows, fp32 sums, one
rounding after the add into ``out``) and :func:`dwconv2d_stats_sums` the
order in which the stats variant sums the stored y: each thread its
values in its store order, a butterfly over the warp's lanes, the 4
m-tiles' warps in order (a partial per image tile and channel), then the second
pass over the tiles (``ops/dwconv.py``'s :func:`_block_sum` order).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from slak_tpu_torch.ops.dwconv import P_MAX, _block_sum, _check

MI = 64                     # images a tile: the tensor cores' 64 rows
CB = 2                      # channels a run (a work item's)
LEAD_MAX = 14               # a run's offset in its first 16-byte chunk
ROWS, A_PITCH = 64, 72      # A2 in shared memory: 8 n-tiles, 64 + 8 bf16
M_TILES = 4                 # m16 tiles of a channel's 64 images, a warp each
RED_THREADS = 256           # the second pass's block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def toeplitz2d(w: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The doubly blocked Toeplitz matrix of each channel's taps, (C, P, P)
    float32, P = H * W: ``A2[c, h W + w_, h2 W + w2] = w[c, h2 - h + kh//2,
    w2 - w_ + kw//2]``, zero off the taps (``build_banded2d`` for taps in
    the port's (C, kh, kw) layout). y_c[p] = sum_q A2_c[p][q] x_c[q]."""
    C, kh, kw = w.shape
    dev = w.device
    kk = (torch.arange(H, device=dev)[None, :]
          - torch.arange(H, device=dev)[:, None] + kh // 2)     # (h, h2)
    jj = (torch.arange(W, device=dev)[None, :]
          - torch.arange(W, device=dev)[:, None] + kw // 2)     # (w_, w2)
    ok = (((kk >= 0) & (kk < kh))[:, :, None, None]
          & ((jj >= 0) & (jj < kw))[None, None])               # (h,h2,w_,w2)
    a4 = w.float()[:, kk.clamp(0, kh - 1)[:, :, None, None],
                   jj.clamp(0, kw - 1)[None, None]] * ok       # (C,h,h2,w_,w2)
    return a4.permute(0, 1, 3, 2, 4).reshape(C, H * W, H * W)


def dwconv2d_geometry(N: int, C: int, H: int, W: int, kh: int, kw: int,
                      accumulate: bool = False) -> dict:
    """The kernel's launch geometry (``geom2d`` in csrc/dwconv2d.cu): P
    pixels, NT n-tiles of 8, KS k-steps of 16 (QP = 16 KS), CB channels a
    run, R runs, T image tiles of MI, items = R T (an item: a run over a
    tile), NCH 16-byte chunks a staged run at most and the staged row pitch
    RP, the taps' window that reaches the map (first row tr0, TR rows,
    first column tc0, TC columns, KW taps, KWP slots a channel with the
    zero slot), the staged output buffers and the shared bytes."""
    P = H * W
    if not (N >= 1 and C >= 1 and H >= 1 and W >= 1 and P <= P_MAX
            and kh % 2 == 1 and kw % 2 == 1):
        raise ValueError(f"the Toeplitz kernel takes H * W <= {P_MAX} and "
                         f"odd taps, not {(N, C, H, W)} with {(kh, kw)}")
    cb = min(CB, C)
    nch = _cdiv(LEAD_MAX + cb * P * 2, 16)
    rp = _cdiv(16 * nch + 8, 16) * 16
    rp += 16 if rp % 32 == 0 else 0
    ph, pw = kh // 2, kw // 2
    tr0, tc0 = max(0, ph - (H - 1)), max(0, pw - (W - 1))
    TR, TC = min(kh, ph + H) - tr0, min(kw, pw + W) - tc0
    KW = TR * TC
    kwp = _cdiv(KW + 1, 4) * 4
    R, T = _cdiv(C, cb), _cdiv(N, MI)
    o_bufs = 2 if accumulate else 1
    smem = ((2 + o_bufs) * MI * rp + cb * ROWS * A_PITCH * 2
            + 2 * cb * kwp * 4 + cb * M_TILES * 2 * 4)
    return dict(P=P, NT=_cdiv(P, 8), KS=_cdiv(P, 16), QP=16 * _cdiv(P, 16),
                CB=cb, R=R, T=T, items=R * T, NCH=nch, RP=rp, tr0=tr0, TR=TR,
                tc0=tc0, TC=TC, KW=KW, KWP=kwp, smem=smem, o_bufs=o_bufs)


def dwconv2d_items(g: dict, N: int, C: int):
    """The work items in the kernel's order: (t, c0, cb, n0, ni) -- the
    image tile, the run's first channel and channels, its first image and
    images. Item i is run i // T, tile i % T."""
    for i in range(g["items"]):
        r, t = divmod(i, g["T"])
        c0 = r * g["CB"]
        yield t, c0, min(g["CB"], C - c0), t * MI, min(MI, N - t * MI)


def _padded_a2(w: torch.Tensor, g: dict, H: int, W: int) -> torch.Tensor:
    """A2 as the kernel builds it: (C, 8 NT, QP), zero past P on both axes,
    in bf16 (exact for taps already rounded to bf16), as float32."""
    P = g["P"]
    a2 = toeplitz2d(w, H, W)
    a2 = F.pad(a2, (0, g["QP"] - P, 0, 8 * g["NT"] - P))
    return a2.to(torch.bfloat16).float()


def _tiles(v: torch.Tensor, g: dict, cols: int) -> torch.Tensor:
    """(N, C, P) -> (T, MI, C, cols): the image tiles, the rows past N and
    the pixels past P zero."""
    N, _, P = v.shape
    v = F.pad(v.float(), (0, cols - P, 0, 0, 0, g["T"] * MI - N))
    return v.reshape(g["T"], MI, *v.shape[1:])


def _check2d(x: torch.Tensor, w: torch.Tensor,
             out: Optional[torch.Tensor]) -> None:
    _check(x, w, out)
    if x.shape[2] * x.shape[3] > P_MAX:
        raise ValueError(f"the Toeplitz kernel takes H * W <= {P_MAX}, not "
                         f"{tuple(x.shape[2:])}")


def dwconv2d_mirror(x: torch.Tensor, w: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch (any dtype, any device):
    the same function as :func:`dwconv_plain` for taps already rounded to
    bf16 on maps with H * W <= P_MAX. Each image tile of MI (the rows past
    N zero) times each channel's padded A2 transposed, fp32 sums, the
    padding dropped, one rounding to x.dtype (after the add into ``out``)."""
    _check2d(x, w, out)
    N, C, H, W = x.shape
    g = dwconv2d_geometry(N, C, H, W, w.shape[1], w.shape[2],
                          out is not None)
    a2 = _padded_a2(w.to(x.device), g, H, W)                 # (C, 8NT, QP)
    xt = _tiles(x.reshape(N, C, H * W), g, g["QP"])         # (T, MI, C, QP)
    yt = torch.einsum("tmcq,cpq->tmcp", xt, a2)
    y = yt.reshape(-1, C, 8 * g["NT"])[:N, :, :g["P"]].reshape(x.shape)
    if out is None:
        return y.to(x.dtype)
    out.copy_(out.float() + y)
    return out


def _store_order(g: dict) -> tuple:
    """(rows, pixels) of a thread's stored values in its order: each (4
    m-tiles, 32 lanes, NT * 4) -- for the warp of m-tile mt, n-tile nt, row
    half h, pixel e: row 16 mt + lane / 4 + 8 h of the tile, pixel 8 nt + 2
    (lane % 4) + e."""
    warp = torch.arange(M_TILES)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    s = torch.arange(g["NT"] * 4)[None, None, :]
    nt, h, e = s // 4, (s // 2) % 2, s % 2
    rows = 16 * warp + lane // 4 + 8 * h
    pix = 8 * nt + 2 * (lane % 4) + e
    return rows.expand(M_TILES, 32, -1), pix.expand(M_TILES, 32, -1)


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """``warp_sum`` over the last axis (32 lanes): the butterfly, every lane
    the same bits; lane 0's."""
    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def dwconv2d_stats_sums(y: torch.Tensor):
    """(s1, s2) of the stored y (N, C, H, W) as the kernel's stats variant
    sums them: for each item, each thread adds its stored values and their
    squares in fp32 in its store order (:func:`_store_order`; the values
    past N and P are +0, which adds nothing), the warp's butterfly, the 4
    m-tiles' warps in order from 0: one partial a (tile, channel); then
    ``dwconv2d_stats_reduce``: thread i of 256 the partials of tiles i, i +
    256, .. in order, and ``_block_sum``."""
    N, C, H, W = y.shape
    g = dwconv2d_geometry(N, C, H, W, 1, 1)
    yt = _tiles(y.reshape(N, C, H * W), g, 8 * g["NT"])    # (T, MI, C, 8NT)
    rows, pix = _store_order(g)
    vals = yt[:, rows.to(y.device), :, pix.to(y.device)]   # (4, 32, S, T, C)
    vals = vals.permute(3, 4, 0, 1, 2)                      # (T, C, 4, 32, S)
    s = torch.zeros(vals.shape[:-1], device=y.device)
    q = torch.zeros_like(s)
    for i in range(vals.shape[-1]):
        v = vals[..., i]
        s = s + v
        q = q + v * v
    out = []
    for part in (s, q):
        lanes = _warp_sum(part)                             # (T, C, 4)
        tot = torch.zeros(lanes.shape[:-1], device=y.device)
        for i in range(M_TILES):
            tot = tot + lanes[..., i]                       # (T, C)
        T = g["T"]
        items = _cdiv(T, RED_THREADS) * RED_THREADS
        tot = F.pad(tot.t(), (0, items - T)).reshape(C, -1, RED_THREADS)
        acc = torch.zeros(C, RED_THREADS, device=y.device)
        for i in range(tot.shape[1]):
            acc = acc + tot[:, i]
        out.append(_block_sum(acc))
    return out[0], out[1]


def dwconv2d_stats_mirror(x: torch.Tensor, w: torch.Tensor):
    """The stats variant in plain PyTorch: (y, s1, s2) with y from
    :func:`dwconv2d_mirror` and the sums of the rounded y in the kernel's
    order (:func:`dwconv2d_stats_sums`)."""
    y = dwconv2d_mirror(x, w)
    return (y, *dwconv2d_stats_sums(y))


# --- the kernel's entries ---------------------------------------------------

_GEOM_KEYS = ("P", "NT", "KS", "QP", "CB", "R", "T", "items", "NCH", "RP",
              "tr0", "TR", "tc0", "TC", "KW", "KWP", "smem", "o_bufs")


@functools.lru_cache(maxsize=None)
def _entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwconv2d")
    fn = lib.slak_dwconv2d
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = lib.slak_dwconv2d_stats_scratch
    scratch.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    st = lib.slak_dwconv2d_stats
    st.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    st.restype = ctypes.c_int
    geom = lib.slak_dwconv2d_geom
    geom.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    geom.restype = ctypes.c_int
    return fn, scratch, st, geom


def kernel_geometry(N: int, C: int, H: int, W: int, kh: int, kw: int,
                    accumulate: bool = False) -> dict:
    """The geometry the kernel's host code computes (built on first use),
    the keys of :func:`dwconv2d_geometry`."""
    v = (ctypes.c_longlong * len(_GEOM_KEYS))()
    if _entries()[3](N, C, H, W, kh, kw, int(accumulate), v) != 0:
        raise ValueError(f"the Toeplitz kernel takes no {(N, C, H, W)} "
                         f"with taps {(kh, kw)}")
    return {k: int(n) for k, n in zip(_GEOM_KEYS, v)}


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_run(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the Toeplitz kernel takes bfloat16, not {x.dtype}")
    if x.shape[2] * x.shape[3] > P_MAX:
        raise ValueError(f"the Toeplitz kernel takes H * W <= {P_MAX}, not "
                         f"{tuple(x.shape[2:])}")


def run(x: torch.Tensor, w: torch.Tensor,
        out: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the kernel, uncounted: conv(x, w) (+ out, in place,
    when given). ``ops/dwconv.py`` ``launch`` checks the operands (CUDA,
    contiguous, matching) and counts; here x must be bf16 with H * W <=
    P_MAX. Raises on what the kernel does not take or a failed launch."""
    _check_run(x)
    N, C, H, W = x.shape
    accumulate = out is not None
    if out is None:
        out = torch.empty_like(x)
    err = _entries()[0](x.data_ptr(), w.data_ptr(), out.data_ptr(), N, C, H,
                        W, w.shape[1], w.shape[2], int(accumulate),
                        _stream(x))
    if err != 0:
        raise RuntimeError(f"dwconv toeplitz2d kernel launch failed: "
                           f"cudaError {err}")
    return out


def run_stats(x: torch.Tensor, w: torch.Tensor):
    """One stats launch (two kernels), uncounted, the operands checked as
    :func:`run`'s: (conv(x, w), s1, s2)."""
    _check_run(x)
    N, C, H, W = x.shape
    kh, kw = w.shape[1], w.shape[2]
    _, scratch, st, _ = _entries()
    n_part = scratch(N, C, H, W, kh, kw)
    if n_part < 0:
        raise RuntimeError(f"dwconv_stats: the Toeplitz kernel takes no "
                           f"{tuple(x.shape)} with taps {(kh, kw)}")
    out = torch.empty_like(x)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device)
    sums = torch.empty(2, C, dtype=torch.float32, device=x.device)
    err = st(x.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(),
             sums[0].data_ptr(), sums[1].data_ptr(), N, C, H, W, kh, kw,
             _stream(x))
    if err != 0:
        raise RuntimeError(f"dwconv_stats toeplitz2d kernel launch failed: "
                           f"cudaError {err}")
    return out, sums[0], sums[1]
