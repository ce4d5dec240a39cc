"""The band kernel's decomposition (``ops/dwconv.py``'s plain mirror of
``dwconv_band_kernel``) against the plain versions and the Pallas banded
kernels on the CPU.

The mirror builds the Toeplitz band tiles, stages each image's plane with
the long tap axis contiguous between zero halo rows, shifts the staged
rows by the tap, sums the band tiles' products over the padded tiles and
adds the K4 sums in the kernel's order. The same seeded numpy inputs,
rounded to bf16 (the band is bf16), go through it, through
``dwconv_plain`` / ``dwconv_stats_plain`` and through
``dwconv_banded_cmajor`` / ``dwconv_banded_stats_cmajor`` (interpret mode,
jitted); the (5, K) orientation runs the Pallas kernel on the transposed
map. All in fp32 with sums in another order: tolerance 1e-5. The CUDA
kernel itself is held against the same plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_banded import (dwconv_banded_cmajor,
                                        dwconv_banded_stats_cmajor)
from slak_tpu_torch.ops import dwconv as K1

TOL = 1e-5

# (N, C, H, W, kh, kw): maps not a multiple of 16 (7, 12, 14, 13), taps
# longer than the map, both orientations, batches 1 and 3, and a map with
# two m-tiles; then maps past 64 on the slice kernel: the long axis at 65
# (the first past 64, two F-slices in (5, K)), a non-square (K, 5) map,
# (5, K) with the long axis 130 (two slices of F = 70), F = 130 above 64
# with L = 48 below it, and an odd W
SHAPES = [(1, 3, 7, 7, 13, 5), (3, 2, 12, 12, 51, 5), (3, 2, 12, 12, 5, 51),
          (1, 2, 14, 14, 5, 47), (3, 2, 14, 13, 47, 5), (1, 2, 28, 28, 49, 5),
          (1, 2, 65, 65, 51, 5), (1, 2, 80, 72, 51, 5),
          (2, 2, 70, 130, 5, 51), (1, 2, 130, 48, 5, 47),
          (1, 2, 97, 131, 49, 5)]


def _inputs(rng, N, C, H, W, kh, kw):
    """x (N, C, H, W) and taps (C, kh, kw), values rounded to bf16, fp32."""
    x = rng.standard_normal((N, C, H, W), dtype=np.float32)
    w = rng.standard_normal((C, kh, kw), dtype=np.float32) * 0.1
    return (torch.from_numpy(x).bfloat16().float(),
            torch.from_numpy(w).bfloat16().float())


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_band_mirror_matches_plain(rng, shape):
    """The mirror against ``dwconv_plain``, alone and adding into an
    output (the pair's second launch), and its stats variant against
    ``dwconv_stats_plain``: y and both sums."""
    x, w = _inputs(rng, *shape)
    _close(K1.dwconv_band_mirror(x, w), K1.dwconv_plain(x, w))
    out = torch.from_numpy(rng.standard_normal(x.shape, dtype=np.float32))
    _close(K1.dwconv_band_mirror(x, w, out.clone()),
           K1.dwconv_plain(x, w, out.clone()))
    for got, want in zip(K1.dwconv_band_stats_mirror(x, w),
                         K1.dwconv_stats_plain(x, w)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL * want.abs().max().item())


def _pallas(x, w, stats):
    """dwconv_banded_cmajor (or its stats variant) in interpret mode on
    NCHW x and (C, kh, kw) taps, (5, K) taps on the transposed map."""
    long_h = w.shape[2] == 5
    xx, ww = (x, w) if long_h else (x.transpose(2, 3), w.transpose(1, 2))
    s = ww.shape[2]
    xc = jnp.pad(jnp.asarray(xx.permute(1, 2, 3, 0).numpy()),
                 ((0, 0), (0, 0), (s // 2, s // 2), (0, 0)))
    wk = jnp.asarray(ww.permute(1, 2, 0).numpy())          # (kh, kw, C)
    fn = dwconv_banded_stats_cmajor if stats else dwconv_banded_cmajor
    # jitted: one XLA program, not the interpreter's op-by-op dispatch;
    # one channel a grid step (the default block pads C to 32 channels)
    res = jax.jit(lambda a, b: fn(a, b, cb=1, interpret=True))(xc, wk)
    y = torch.from_numpy(np.array(res[0] if stats else res)).permute(
        3, 0, 1, 2)                                         # -> NCHW
    y = y if long_h else y.transpose(2, 3)
    return (y, *(torch.from_numpy(np.array(r)) for r in res[1:])) \
        if stats else y


@pytest.mark.parametrize("taps,stats", [((51, 5), True), ((5, 51), False)])
def test_band_mirror_matches_pallas_banded(rng, taps, stats):
    """The mirror against the Pallas banded kernels (interpret): taps
    longer than a 12 x 12 map, batch 3; (K, 5) through the stats kernel
    (y and both sums), (5, K) through the plain one on the transposed
    map."""
    x, w = _inputs(rng, 3, 2, 12, 12, *taps)
    if not stats:
        _close(K1.dwconv_band_mirror(x, w), _pallas(x, w, False))
        return
    for got, want in zip(K1.dwconv_band_stats_mirror(x, w),
                         _pallas(x, w, True)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL * want.abs().max().item())


@pytest.mark.parametrize("shape,taps,stats", [
    ((1, 2, 130, 96), (51, 5), True), ((2, 2, 72, 130), (5, 49), False)])
def test_band_slice_mirror_matches_pallas_banded(rng, shape, taps, stats):
    """The mirror on the slice kernel's geometry (maps past 64: F-slices
    with their halo rows, m-bands, the live diagonals) against the Pallas
    banded kernels (interpret): (K, 5) through the stats kernel (y and
    both sums), (5, K) through the plain one on the transposed map."""
    x, w = _inputs(rng, *shape, *taps)
    assert K1.band_geometry(*shape, *taps)["slice"]
    if not stats:
        _close(K1.dwconv_band_mirror(x, w), _pallas(x, w, False))
        return
    for got, want in zip(K1.dwconv_band_stats_mirror(x, w),
                         _pallas(x, w, True)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL * want.abs().max().item())


def _stored_once(g, N, H, W):
    """True when the band route's store order stores each output of the
    (N, H, W) batch exactly once."""
    count = torch.zeros(N * H * W, dtype=torch.int32)
    for order in K1._band_store_blocks(g, N, H, W):
        idx = order[order >= 0]
        count.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return bool((count == 1).all())


@pytest.mark.parametrize("N", [1, 3, 8, 64, 128, 256])
def test_band_geometry_stores_every_output_once(N):
    """At the flagship's four stage shapes (both orientations) and the
    paths' batches: each output is stored by exactly one thread of one
    block, a chunk's 8 x 8 blocks fit the staging registers of each lane
    (8 at MT = 1, else 16), and the blocks cover the batch."""
    for C, H, K in ((124, 56, 51), (249, 28, 49), (499, 14, 47),
                    (998, 7, 13)):
        for kh, kw in ((K, 5), (5, K)):
            g = K1.band_geometry(N, C, H, H, kh, kw)
            assert g["NB"] * g["BPI"] <= (8 if g["MT"] == 1 else 16) * 8
            assert g["bpc"] * g["CPB"] * g["NB"] >= N
            assert (g["bpc"] - 1) * g["CPB"] * g["NB"] < N
            order = K1._band_store_order(g, N, H, H)
            got = order[order >= 0]
            assert got.numel() == N * H * H
            assert torch.equal(got.sort().values, torch.arange(N * H * H))
    if N not in (1, 8, 128):
        return
    # the slice kernel: the seg path's stage 1 (128^2 at 512^2) and maps
    # of 200^2 and 256^2 (inputs of 800^2 and 1024^2); a chunk's 8 x 8
    # blocks fit the staging registers (16 a lane), every chunk (image,
    # slice) lies in one block, the shared memory fits
    for C, H, K in ((124, 128, 51), (124, 200, 51), (124, 256, 51)):
        for kh, kw in ((K, 5), (5, K)):
            g = K1.band_geometry(N, C, H, H, kh, kw)
            assert g["slice"] and g["NTI"] * g["LB"] <= 16 * 8
            assert g["NS"] * g["FS"] >= H > (g["NS"] - 1) * g["FS"]
            assert g["bpc"] * g["CPB"] >= N * g["NS"]
            assert (g["bpc"] - 1) * g["CPB"] < N * g["NS"]
            assert g["NMB"] * g["MBR"] >= g["MT"] and g["MBR"] <= 4
            assert g["DL"] == 2 and g["smem"] <= 200 * 1024
            assert _stored_once(g, N, H, H)


def test_band_route():
    """bf16 (K, 5) / (5, K) taps on maps up to 64 take the band kernel,
    and above 64 (the slice kernel) with K <= 65 and the long axis up to
    512; fp32, square taps, longer taps and longer axes do not."""
    def route(dtype, H, W, kh, kw):
        return K1.band_route(torch.empty(1, 1, H, W, dtype=dtype),
                             torch.empty(1, kh, kw))
    bf, f32 = torch.bfloat16, torch.float32
    assert route(bf, 56, 56, 51, 5) and route(bf, 56, 56, 5, 51)
    assert route(bf, 7, 7, 13, 5) and route(bf, 64, 64, 5, 63)
    assert not route(f32, 56, 56, 51, 5)
    assert not route(bf, 56, 56, 5, 5) and not route(bf, 56, 56, 7, 7)
    assert route(bf, 65, 56, 51, 5) and route(bf, 256, 256, 51, 5)
    assert route(bf, 128, 128, 5, 51) and route(bf, 512, 40, 65, 5)
    assert route(bf, 3000, 40, 5, 51)          # F sliced, any size
    assert not route(bf, 128, 128, 67, 5) and not route(bf, 513, 40, 13, 5)
    assert not route(f32, 128, 128, 51, 5) and not route(bf, 80, 80, 7, 7)
    assert not K1.band_geometry(1, 1, 64, 64, 51, 5)["slice"]
    assert K1.band_geometry(1, 1, 65, 64, 5, 51)["slice"]


def test_route_launch_checks():
    """The named-route launches run only on the card: an unknown route, the
    band route in fp32 and a CPU tensor raise before any kernel loads."""
    x = torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16)
    w = torch.zeros(2, 9, 5)
    with pytest.raises(ValueError):
        K1.launch("banded", x, w)
    with pytest.raises(TypeError):
        K1.launch_stats("band", x.float(), w)
    for fn in (K1.launch, K1.launch_stats):
        with pytest.raises(RuntimeError, match="runs on cuda"):
            fn("tiled", x, w)
