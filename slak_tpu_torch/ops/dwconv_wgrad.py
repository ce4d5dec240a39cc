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

Two kernels serve it on the card, chosen by dtype and shape
(:func:`wgrad_route`): bf16 maps with (K, 5) or (5, K) taps and both axes
at most ``BAND_MAX`` take the band kernel (``slak_dwconv_wgrad_band``,
``wgrad_band_kernel``: per-channel correlation matrices G_j over the long
tap axis on the tensor cores, their diagonals folded into taps; counted in
``band_launch_count`` besides ``launch_count``); everything else (fp32,
larger maps, other taps) takes the tiled kernels on the CUDA cores, which
stage a plane in row tiles where its two fp32 copies exceed their 200 KB
of shared memory (:func:`tile_rows`, :func:`tile_plan`: the host's plan).
:func:`launch` launches one named route (the probes hold the two against
each other). :func:`wgrad_geometry` mirrors the band kernel's launch
geometry and :func:`dwconv_wgrad_band_mirror` its decomposition in plain
PyTorch: the staged k-major planes with their zero rows, G_j per k-group
and chunk, the tiles off the band skipped, the diagonals folded in the
kernel's order and the blocks' partials summed in order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

launch_count = 0               # all launches, either route
band_launch_count = 0          # launches on the band route (also above)

BAND_MAX = 64                  # the band kernel's map axes: 4 m-tiles of 16

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
    """Batch chunks a tiled launch splits the reduction into: enough
    blocks (C * chunks) to fill the card, at most one a sample."""
    per = -(-N // max(1, min(N, -(-_BLOCKS_TARGET // C))))
    return -(-N // per)


def wgrad_route(x: torch.Tensor, kh: int, kw: int) -> bool:
    """True where the CUDA wrapper launches the band kernel: bf16, taps
    (K, 5) or (5, K) with K != 5, both map axes at most BAND_MAX."""
    return (x.dtype == torch.bfloat16 and (kh == 5) != (kw == 5)
            and max(x.shape[2], x.shape[3]) <= BAND_MAX)


_SMEM_MAX = 200 * 1024           # the tiled kernels' shared memory (kSmemMax)


def _tile_smem(H: int, W: int, kh: int, kw: int, rows: int) -> int:
    """The tiled route's shared bytes for tiles of ``rows`` output rows
    (``tile_smem`` in csrc/dwconv_wgrad.cu): (K, 5) / (5, K) taps on
    ``wgrad_tiled_kernel`` (the x rows padded to an odd pitch, the dy rows,
    the per-row-group sums), any other taps on ``wgrad_kernel`` (the x rows,
    the dy rows, a sum per tap and row group)."""
    if (kw == 5) != (kh == 5) and max(kh, kw) <= 256:
        long_h = kw == 5
        K, HA, HB = (kh, H, W) if long_h else (kw, W, H)
        xr = min(HA, rows + K - 1)
        return 4 * (xr * ((HB + 4) | 1) + rows * HB + (256 // K) * K * 5)
    ntaps = kh * kw
    p = 1 if ntaps >= 256 else 256 // ntaps
    return 4 * (min(H, rows + kh - 1) * W + rows * W + p * ntaps)


def _tiled_axis(H: int, W: int, kh: int, kw: int):
    """(extent, taps) along the axis the tiles cut: W for (5, K) taps on
    ``wgrad_tiled_kernel``, else H."""
    return (W, kw) if (kh == 5 and kw != 5 and kw <= 256) else (H, kh)


def tile_rows(H: int, W: int, kh: int, kw: int) -> int:
    """The output rows a staged tile of the tiled route holds (``smem_bytes``
    in csrc/dwconv_wgrad.cu): rows along H (along W for (5, K) taps), the
    whole extent where both fp32 planes fit in 200 KB, else the most that
    fit, found by halving and then counting up; 0 where not one row fits."""
    ha = _tiled_axis(H, W, kh, kw)[0]
    r = ha
    while r > 1 and _tile_smem(H, W, kh, kw, r) > _SMEM_MAX:
        r = (r + 1) // 2
    if _tile_smem(H, W, kh, kw, r) > _SMEM_MAX:
        return 0
    while r < ha and _tile_smem(H, W, kh, kw, r + 1) <= _SMEM_MAX:
        r += 1
    return r


def tile_plan(H: int, W: int, kh: int, kw: int) -> list:
    """The tiles a tiled launch stages for one plane, in order: (first
    output row, end, first input row, end) along the tiled axis, the input
    rows those outputs read that lie on the map; [] where no row fits."""
    rows = tile_rows(H, W, kh, kw)
    if not rows:
        return []
    ha, K = _tiled_axis(H, W, kh, kw)
    return [(r0, min(ha, r0 + rows), max(0, r0 - K // 2),
             min(ha, r0 + rows + K // 2)) for r0 in range(0, ha, rows)]


# --- the band kernel's decomposition in plain PyTorch -----------------------

# per m-tile count MT (wb_mgroups, wb_kgroups, wb_slots, wb_pre,
# wb_min_blocks in csrc/dwconv_wgrad.cu): m-groups, k-groups, unit slots a
# warp, 8 x 8 staging blocks a lane, blocks an SM
_BAND_SETTINGS = {1: (1, 4, 5, 8, 4), 2: (1, 1, 3, 16, 3),
                  3: (1, 1, 4, 16, 2), 4: (2, 1, 5, 16, 1)}
_SMS, _BLOCK_COST, _MAX_BPC = 132, 2, 16     # kSMs, kBlockCost, kMaxBpc


def wgrad_geometry(N: int, C: int, H: int, W: int, kh: int, kw: int
                   ) -> dict:
    """The band kernel's launch geometry (``wband_geom`` in
    csrc/dwconv_wgrad.cu): long_h ((K, 5) taps), the long tap axis L and
    the other axis F, MT m-tiles of 16 and NT n-tiles of 8 along L, RPI
    staged rows an image (F to 8 and 2 zero rows), P the staged row
    pitch, BPI 8 x 8 blocks a plane, NB images a chunk, S k-steps of a
    full chunk, NW warps a block in MG m-groups and KG k-groups of UW
    unit groups, SL unit slots a warp, CPB chunks a block, bpc blocks a
    channel (the fewest waves of 132 SMs' resident blocks, a block
    costing its chunks and 2 more)."""
    long_h = kw == 5
    K, L, F = (kh, H, W) if long_h else (kw, W, H)
    mt, nt = -(-L // 16), -(-L // 8)
    mg, kg, sl, pre, per_sm = _BAND_SETTINGS[mt]
    nw = 8 * mg
    rpi = 8 * -(-F // 8) + 2
    bpi = -(-H // 8) * -(-W // 8)
    nb = min(pre * nw // (2 * bpi), N)
    chunks = -(-N // nb)
    slots = _SMS * per_sm
    cost = {}
    for b in range(1, min(_MAX_BPC, chunks) + 1):
        cpb = -(-chunks // b)
        if -(-chunks // cpb) == b:
            cost.setdefault(-(-C * b // slots) * (cpb + _BLOCK_COST), cpb)
    cpb = cost[min(cost)]
    return dict(long_h=long_h, K=K, L=L, F=F, MT=mt, NT=nt, RPI=rpi,
                P=16 * mt + 8, BPI=bpi, NB=nb, S=-(-(nb * rpi - 2) // 16),
                NW=nw, MG=mg, KG=kg, UW=nw // (kg * mg), SL=sl, CPB=cpb,
                bpc=-(-chunks // cpb))


def band_live(g: dict) -> torch.Tensor:
    """(16 MT, 8 NT) bool: the entries of G_j in tiles the kernel forms,
    those with some (a, r) in their 16 x 8 tile on the band
    |r - a| <= K // 2."""
    mt = torch.arange(g["MT"])[:, None]
    nt = torch.arange(g["NT"])[None, :]
    gap = torch.maximum(torch.maximum(8 * nt - (16 * mt + 15),
                                      16 * mt - (8 * nt + 7)),
                        torch.zeros((), dtype=torch.long))
    return (gap <= g["K"] // 2).repeat_interleave(16, 0).repeat_interleave(
        8, 1)


def dwconv_wgrad_band_mirror(x: torch.Tensor, dy: torch.Tensor, kh: int,
                             kw: int) -> torch.Tensor:
    """The band kernel's decomposition in plain PyTorch (any dtype, any
    device): the same function as :func:`dwconv_wgrad_plain` for taps
    (K, 5) or (5, K), both map axes at most BAND_MAX, fp32 sums. Each
    block stages its chunks' planes k-major (a row per (image, f), L
    contiguous, each image's F rows to 8 then 2 zero rows), adds G_j =
    dy rows 2 + 16 s .. against x rows 16 s + j .. of k-step s into
    k-group s % KG's copy (tiles off the band skipped), then sums the
    k-groups' copies in order and folds tap (i, j)'s diagonal in order of
    a; the blocks' partials are summed in order."""
    _check(x, dy, kh, kw)
    N, C, H, W = x.shape
    if (kh == 5) == (kw == 5) or max(H, W) > BAND_MAX:
        raise ValueError(f"the band kernel takes (K, 5) or (5, K) taps on "
                         f"maps up to {BAND_MAX}, not {(kh, kw)} on "
                         f"{(H, W)}")
    g = wgrad_geometry(N, C, H, W, kh, kw)
    K, L, F, rpi, nb = g["K"], g["L"], g["F"], g["RPI"], g["NB"]
    Lm, Ln, pk = 16 * g["MT"], 8 * g["NT"], K // 2
    dev = x.device
    live = band_live(g).to(dev)
    # (N, C, F, L): the planes with L contiguous
    xs, ds = ((t.float().transpose(2, 3) if g["long_h"] else t.float())
              for t in (x, dy))
    rows_of = 2 + torch.arange(F, device=dev)
    i = torch.arange(K, device=dev)
    dw = torch.zeros(C, 5, K, device=dev)
    for grp in range(g["bpc"]):
        n_begin = grp * g["CPB"] * nb
        n_end = min(N, n_begin + g["CPB"] * nb)
        G = torch.zeros(g["KG"], C, 5, Lm, Ln, device=dev)
        for n in range(n_begin, n_end, nb):
            nimg = min(nb, n_end - n)
            stx = torch.zeros(C, 16 * g["S"] + 4, g["P"], device=dev)
            std = torch.zeros_like(stx)
            for m in range(nimg):
                stx[:, m * rpi + rows_of, :L] = xs[n + m]
                std[:, m * rpi + rows_of, :L] = ds[n + m]
            for s in range(-(-(nimg * rpi - 2) // 16)):
                A = std[:, 2 + 16 * s:18 + 16 * s, :Lm]     # (C, 16, Lm)
                for j in range(5):
                    B = stx[:, 16 * s + j:16 * s + j + 16, :Ln]
                    G[s % g["KG"], :, j] += torch.where(
                        live, torch.einsum("ckm,ckn->cmn", A, B), 0.0)
        # the fold: the k-groups' copies summed in order, then tap (i, j)
        # sums G[j][a][a + i - K/2] over a in order
        Gs = G[0]
        for q in range(1, g["KG"]):
            Gs = Gs + G[q]
        part = torch.zeros(C, 5, K, device=dev)
        for a in range(L):
            r = a + i - pk
            part = part + torch.where((r >= 0) & (r < L),
                                      Gs[:, :, a, r.clamp(0, Ln - 1)], 0.0)
        dw = dw + part
    return dw.transpose(1, 2).contiguous() if g["long_h"] else dw


# --- the CUDA launches ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry():
    from slak_tpu_torch.ops._build import load
    fn = load("dwconv_wgrad").slak_dwconv_wgrad
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _band_entries():
    from slak_tpu_torch.ops._build import load
    lib = load("dwconv_wgrad")
    scratch = lib.slak_dwconv_wgrad_band_scratch
    scratch.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    fn = lib.slak_dwconv_wgrad_band
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return scratch, fn


@functools.lru_cache(maxsize=None)
def _tile_rows_entry():
    from slak_tpu_torch.ops._build import load
    fn = load("dwconv_wgrad").slak_dwconv_wgrad_tile_rows
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_tile_rows(H: int, W: int, kh: int, kw: int):
    """(rows a tile, shared bytes) as the tiled route's host code plans
    them (built on first use); :func:`tile_rows` is its mirror."""
    smem = ctypes.c_longlong()
    rows = _tile_rows_entry()(H, W, kh, kw, ctypes.addressof(smem))
    return rows, smem.value


def _on_cuda(x: torch.Tensor):
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv_wgrad runs on cuda or cpu, not "
                           f"{x.device}")


def launch(route: str, x: torch.Tensor, dy: torch.Tensor, kh: int,
           kw: int) -> torch.Tensor:
    """One launch on ``route`` ("band" or "tiled"), counted: the (C, kh,
    kw) float32 tap gradient. :func:`dwconv_wgrad` picks the route; probes
    call this to hold one route against another at the same shapes."""
    if route not in ("band", "tiled"):
        raise ValueError(f"route is 'band' or 'tiled', not {route!r}")
    band = route == "band"
    if band and x.dtype != torch.bfloat16:
        raise TypeError(f"the band kernel takes bfloat16, not {x.dtype}")
    _check(x, dy, kh, kw)
    H, W = x.shape[2:]
    if not band and not tile_rows(H, W, kh, kw):
        raise ValueError(f"dwconv_wgrad: not one row of a {(H, W)} plane "
                         f"with taps {(kh, kw)} fits the tiled kernel's "
                         f"{_SMEM_MAX} bytes of shared memory")
    _on_cuda(x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwconv_wgrad takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("dwconv_wgrad needs contiguous tensors")
    N, C, H, W = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dw = torch.empty(C, kh, kw, dtype=torch.float32, device=x.device)
    if band:
        scratch, fn = _band_entries()
        n_part = scratch(N, C, H, W, kh, kw)
        if n_part < 0:
            raise RuntimeError(f"dwconv_wgrad: the band kernel takes no "
                               f"{tuple(x.shape)} with taps {(kh, kw)}")
        part = torch.empty(n_part, dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                 dw.data_ptr(), N, C, H, W, kh, kw, stream)
    else:
        chunks = n_chunks(N, C)
        part = torch.empty(chunks, C, kh, kw, dtype=torch.float32,
                           device=x.device)
        err = _entry()(_DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(),
                       part.data_ptr(), dw.data_ptr(), N, C, H, W, kh, kw,
                       chunks, stream)
    if err != 0:
        raise RuntimeError(f"dwconv_wgrad {route} kernel launch failed: "
                           f"cudaError {err}")
    global launch_count, band_launch_count
    launch_count += 1
    band_launch_count += band
    return dw


def dwconv_wgrad(x: torch.Tensor, dy: torch.Tensor, kh: int,
                 kw: int) -> torch.Tensor:
    """The (C, kh, kw) float32 tap gradient of conv(x, w) for the output
    cotangent dy. x, dy: (N, C, H, W) float32 or bfloat16, contiguous."""
    if x.device.type == "cpu":
        return dwconv_wgrad_plain(x, dy, kh, kw)
    _on_cuda(x)
    return launch("band" if wgrad_route(x, kh, kw) else "tiled", x, dy, kh,
                  kw)
