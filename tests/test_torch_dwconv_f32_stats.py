"""fp32 K4 on the fp32 band kernel (``ops/dwconv.py``'s plain mirror of
``dwconv_band_f32_kernel``'s stats variant in ``csrc/dwconv_f32.cu``)
against the plain version and the Pallas banded stats kernel on the CPU.

The mirror's y is the fp32 band kernel's decomposition (TF32 planes, live
diagonals, three products a tap); its sums add the stored y and y^2 in the
kernel's order: each thread its stores in order, a butterfly over each
warp's lanes, the warps in order, one partial a block, then the reduce
kernel's order over a channel's partials. The same seeded numpy inputs in
fp32 go through it, through ``dwconv_stats_plain`` and through
``dwconv_banded_stats_cmajor`` (fp32, interpret mode, jitted;
Precision.HIGHEST); the (5, K) orientation runs the Pallas kernel on the
transposed map. 3xTF32 is as accurate as fp32 FFMA, with sums in another
order: tolerance 1e-5 of each result's scale, the card's
``TOL_KERNEL["float32"]`` / ``TOL_SUMS["float32"]``. The CUDA kernel itself
is held against the same plain version, and its sums against the mirror's
bits from its own y, on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_banded import dwconv_banded_stats_cmajor
from slak_tpu_torch.ops import dwconv as K1

TOL = 1e-5


def _inputs(rng, N, C, H, W, kh, kw):
    """x (N, C, H, W) and taps (C, kh, kw), fp32."""
    x = rng.standard_normal((N, C, H, W), dtype=np.float32)
    w = rng.standard_normal((C, kh, kw), dtype=np.float32) * 0.1
    return torch.from_numpy(x), torch.from_numpy(w)


def _close_all(got, want):
    """(y, s1, s2) each within TOL of its own max |want|."""
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=TOL * b.abs().max().item())


# (N, C, H, W, kh, kw): stacked images with taps longer than the map
# ((K, 5) in the Pallas test below); F slices of one image (80 x 72); a
# stacked non-square map with an odd W; stage 4's 7x7 at 8 images
@pytest.mark.parametrize("shape", [
    (3, 2, 12, 12, 5, 51), (1, 2, 80, 72, 51, 5), (2, 3, 30, 45, 5, 47),
    (8, 2, 7, 7, 13, 5)])
def test_f32_stats_mirror_matches_plain(rng, shape):
    """The mirror's (y, s1, s2) against ``dwconv_stats_plain``; its sums
    are the kernel-ordered sums of its own y."""
    x, w = _inputs(rng, *shape)
    got = K1.dwconv_band_f32_stats_mirror(x, w)
    _close_all(got, K1.dwconv_stats_plain(x, w))
    s1, s2 = K1.band_f32_stats_sums(got[0], *shape[4:])
    assert torch.equal(s1, got[1]) and torch.equal(s2, got[2])


def _pallas_stats(x, w):
    """dwconv_banded_stats_cmajor in fp32 (interpret mode) on NCHW x and
    (C, kh, kw) taps, (5, K) taps on the transposed map: (y, s1, s2)."""
    long_h = w.shape[2] == 5
    xx, ww = (x, w) if long_h else (x.transpose(2, 3), w.transpose(1, 2))
    s = ww.shape[2]
    xc = jnp.pad(jnp.asarray(xx.permute(1, 2, 3, 0).numpy()),
                 ((0, 0), (0, 0), (s // 2, s // 2), (0, 0)))
    wk = jnp.asarray(ww.permute(1, 2, 0).numpy())          # (kh, kw, C)
    # jitted: one XLA program; one channel a grid step
    res = jax.jit(lambda a, b: dwconv_banded_stats_cmajor(
        a, b, cb=1, interpret=True))(xc, wk)
    y = torch.from_numpy(np.array(res[0])).permute(3, 0, 1, 2)  # -> NCHW
    y = y if long_h else y.transpose(2, 3)
    return (y, *(torch.from_numpy(np.array(r)) for r in res[1:]))


@pytest.mark.parametrize("shape", [(3, 2, 12, 12, 51, 5),
                                   (1, 2, 72, 40, 5, 49)])
def test_f32_stats_mirror_matches_pallas_stats(rng, shape):
    """The mirror against the Pallas banded stats kernel in fp32
    (interpret): stacked images with taps longer than the map in (K, 5),
    F slices of a map above 64 along L in (5, K) on the transposed map."""
    x, w = _inputs(rng, *shape)
    _close_all(K1.dwconv_band_f32_stats_mirror(x, w), _pallas_stats(x, w))


def test_f32_store_order_sums_each_output_once():
    """Stacked and unstacked block geometries, at det's four 800^2 stage
    shapes (batch 2) and the flagship's 224^2 ones (batch 128), both
    orientations, and maps whose last block has idle warps: the stores a
    channel's blocks sum cover every output exactly once, so no row
    between stacked images, past the last image or past the map enters
    the sums; the threads are the launch's."""
    cases = [(2, C, H, H, K) for C, H, K in ((1, 200, 51), (1, 100, 49),
                                           (1, 50, 47), (1, 25, 13))]
    cases += [(128, 1, H, H, K) for H, K in ((56, 51), (28, 49), (14, 47),
                                             (7, 13))]
    cases += [(3, 1, 12, 12, 51), (1, 1, 264, 24, 13), (5, 1, 27, 27, 49)]
    seen_stack = set()
    for N, C, H, W, K in cases:
        for kh, kw in ((K, 5), (5, K)):
            g = K1.band_f32_geometry(N, C, H, W, kh, kw)
            seen_stack.add(g["stack"])
            order = K1.band_f32_store_order(g, N, H, W)
            assert order.shape[:2] == (g["blocks"] // C, 32 * g["warps"])
            got = order[order >= 0]
            assert got.numel() == N * H * W
            assert torch.equal(got.sort().values, torch.arange(N * H * W))
    assert seen_stack == {True, False}


def test_f32_stats_routes():
    """``_stats_route_of``: fp32 (K, 5) / (5, K) taps take the fp32 band
    kernel at any map size (det's 800^2 stages, the flagship's 224^2 ones,
    the 7x7 maps K6 takes in bf16); bf16 keeps the band and Toeplitz
    routes; fp32 square taps, and taps past the fp32 kernel's diagonals,
    stay on the tiled kernel. ``launch_stats`` on the named route refuses
    bf16 and, on a CPU tensor, raises before any kernel loads; the CPU
    runs the plain version, uncounted."""
    def route(dtype, H, W, kh, kw):
        x, w = torch.empty(1, 1, H, W, dtype=dtype), torch.empty(1, kh, kw)
        return K1._stats_route_of(x, w)
    bf, f32 = torch.bfloat16, torch.float32
    for H, K in ((200, 51), (100, 49), (50, 47), (25, 13), (56, 51),
                 (7, 13)):
        assert route(f32, H, H, K, 5) == route(f32, H, H, 5, K) == "band_f32"
    assert route(bf, 56, 56, 51, 5) == "band"
    assert route(bf, 7, 7, 13, 5) == "toeplitz2d"
    assert route(f32, 56, 56, 7, 7) == "tiled"
    assert route(f32, 41, 1024, 99, 5) == "tiled"
    x, w = torch.zeros(2, 3, 12, 12), torch.zeros(3, 13, 5)
    with pytest.raises(TypeError):
        K1.launch_stats("band_f32", x.bfloat16(), w)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        K1.launch_stats("band_f32", x, w)
    before = (K1.stats_launch_count, K1.tf32_stats_launch_count)
    assert K1.dwconv_stats(x, w)[0].shape == x.shape
    assert (K1.stats_launch_count, K1.tf32_stats_launch_count) == before
