"""The band weight-gradient kernel's decomposition (``ops/dwconv_wgrad.py``'s
plain mirror of ``wgrad_band_kernel``) against the plain version and the
Pallas weight-gradient kernels on the CPU.

The mirror stages each image's planes k-major between zero rows, forms
the per-channel correlation matrices G_j a k-step at a time (the tiles off
the band skipped), folds their diagonals into taps in the kernel's order
and sums the blocks' partials in order. The same seeded numpy inputs,
rounded to bf16 (the kernel's operands are bf16), go through it, through
``dwconv_wgrad_plain`` and through ``band_extract(wgrad_banded_cmajor(..))``
or, on the 7x7 maps, ``band_extract2d(wgrad_banded2d_cmajor(..))``
(interpret mode, jitted); the (5, K) orientation runs the Pallas kernels
on the transposed map. All in fp32 with sums in another order: tolerance
1e-5 of the result's scale. The CUDA kernel itself is held against the
same plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_banded import (band_extract, band_extract2d,
                                        wgrad_banded2d_cmajor,
                                        wgrad_banded_cmajor)
from slak_tpu_torch.ops import dwconv_wgrad as KW

TOL = 1e-5

# (N, C, H, W, kh, kw): maps 7, 12, 14 x 13 (odd W) and 28 (two m-tiles),
# taps 13, 47, 49, 51 in both orientations (longer than the 7 and 12
# maps: taps that only read padding), batches 1 and 3
SHAPES = [(1, 3, 7, 7, 13, 5), (3, 2, 7, 7, 5, 13),
          (3, 2, 12, 12, 51, 5), (1, 2, 12, 12, 5, 51),
          (3, 2, 14, 13, 47, 5), (1, 2, 14, 13, 5, 47),
          (1, 2, 28, 28, 49, 5), (3, 2, 28, 28, 5, 49)]


def _inputs(rng, N, C, H, W):
    """x and dy (N, C, H, W), values rounded to bf16, as float32."""
    return tuple(torch.from_numpy(rng.standard_normal(
        (N, C, H, W), dtype=np.float32)).bfloat16().float()
        for _ in range(2))


def _close(got, want):
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL * scale)


def _dead(kh, kw, H, W):
    """(kh, kw) bool: the taps that only ever read padding."""
    i = torch.arange(kh)[:, None] - kh // 2
    j = torch.arange(kw)[None, :] - kw // 2
    return (i.abs() >= H) | (j.abs() >= W)


@pytest.mark.parametrize("shape", SHAPES)
def test_band_mirror_matches_plain(rng, shape):
    """The mirror against ``dwconv_wgrad_plain``; the taps that only read
    padding exactly 0."""
    N, C, H, W, kh, kw = shape
    x, dy = _inputs(rng, N, C, H, W)
    got = KW.dwconv_wgrad_band_mirror(x, dy, kh, kw)
    assert got.shape == (C, kh, kw) and got.dtype == torch.float32
    _close(got, KW.dwconv_wgrad_plain(x, dy, kh, kw))
    dead = _dead(kh, kw, H, W)
    if dead.any():
        assert torch.equal(got[:, dead], torch.zeros_like(got[:, dead]))


def _pallas(x, dy, kh, kw):
    """The Pallas weight gradient in interpret mode on NCHW x and dy:
    ``band_extract(wgrad_banded_cmajor(..), K)`` for (K, 5) taps,
    ``band_extract2d(wgrad_banded2d_cmajor(..))`` on the 7x7 maps, (5, K)
    taps through the transposed map. Returns (C, kh, kw)."""
    long_h = kw == 5
    if not long_h:
        x, dy, kh, kw = x.transpose(2, 3), dy.transpose(2, 3), kw, kh
    N, C, H, W = x.shape

    def cmajor(a, pw=0):                       # NCHW -> (C, H, W + 2 pw, N)
        ac = jnp.asarray(a.permute(1, 2, 3, 0).contiguous().numpy())
        return jnp.pad(ac, ((0, 0), (0, 0), (pw, pw), (0, 0)))
    # jitted: one XLA program, not the interpreter's op-by-op dispatch; one
    # channel a grid step
    if H == 7:
        want = jax.jit(lambda a, b: band_extract2d(
            wgrad_banded2d_cmajor(a, b, cb=1, interpret=True), kh, kw, H,
            W))(cmajor(x), cmajor(dy))
    else:
        want = jax.jit(lambda a, b: band_extract(
            wgrad_banded_cmajor(a, b, kw, cb=1, interpret=True), kh))(
                cmajor(x, kw // 2), cmajor(dy))
    dw = torch.from_numpy(np.array(want)).permute(2, 0, 1)   # (C, kh, kw)
    return dw if long_h else dw.transpose(1, 2)


@pytest.mark.parametrize("shape", [(3, 2, 7, 7, 13, 5), (1, 2, 7, 7, 5, 13),
                                   (3, 2, 12, 12, 51, 5),
                                   (3, 2, 14, 13, 5, 47)])
def test_band_mirror_matches_pallas_wgrad(rng, shape):
    """The mirror against the Pallas weight-gradient kernels (interpret):
    K7's 2-D form on the 7x7 maps, K5's banded form with taps longer than
    a 12 x 12 map and on a non-square map."""
    N, C, H, W, kh, kw = shape
    x, dy = _inputs(rng, N, C, H, W)
    _close(KW.dwconv_wgrad_band_mirror(x, dy, kh, kw), _pallas(x, dy, kh, kw))


@pytest.mark.parametrize("N", [1, 3, 8, 128])
def test_wgrad_geometry_covers_batch_and_units(N):
    """At the flagship's four stage shapes (both orientations) and the
    paths' batches: the blocks of a channel cover the batch once, a
    chunk's 8 x 8 blocks (both planes) fit the lanes' staging registers,
    and each k-group's warps hold every (shift, n-tile) unit."""
    for C, H, K in ((124, 56, 51), (249, 28, 49), (499, 14, 47),
                    (998, 7, 13)):
        for kh, kw in ((K, 5), (5, K)):
            g = KW.wgrad_geometry(N, C, H, H, kh, kw)
            assert g["MT"] == -(-H // 16) and g["NT"] == -(-H // 8)
            per_block = g["CPB"] * g["NB"]
            assert g["bpc"] * per_block >= N > (g["bpc"] - 1) * per_block
            pre = 8 if g["MT"] == 1 else 16
            assert 2 * g["NB"] * g["BPI"] <= pre * g["NW"]
            assert g["UW"] * g["SL"] >= 5 * g["NT"]
            assert g["NW"] == g["KG"] * g["MG"] * g["UW"]


def test_band_live_tiles():
    """The tiles the kernel forms: all of G at stages 2-4, where the band
    covers the map, and at stage 1 (L = 56, K = 51) all but the 3 tiles
    whose entries all lie more than 25 off the diagonal."""
    for H, K in ((28, 49), (14, 47), (7, 13)):
        g = KW.wgrad_geometry(8, 4, H, H, K, 5)
        assert bool(KW.band_live(g).all())
    g = KW.wgrad_geometry(8, 4, 56, 56, 51, 5)
    live = KW.band_live(g)
    assert live.shape == (64, 56)
    assert int(live[::16, ::8].logical_not().sum()) == 3
    a = torch.arange(64)[:, None]
    r = torch.arange(56)[None, :]
    assert bool(live[(r - a).abs() <= 25].all())


def test_wgrad_route():
    """bf16 (K, 5) / (5, K) taps on maps up to 64 take the band kernel;
    fp32, square taps and larger maps do not."""
    def route(dtype, H, W, kh, kw):
        return KW.wgrad_route(torch.empty(1, 1, H, W, dtype=dtype), kh, kw)
    bf, f32 = torch.bfloat16, torch.float32
    assert route(bf, 56, 56, 51, 5) and route(bf, 56, 56, 5, 51)
    assert route(bf, 7, 7, 13, 5) and route(bf, 64, 64, 5, 63)
    assert not route(f32, 56, 56, 51, 5) and not route(f32, 7, 7, 5, 13)
    assert not route(bf, 56, 56, 5, 5) and not route(bf, 56, 56, 7, 7)
    assert not route(bf, 65, 56, 51, 5) and not route(bf, 112, 112, 5, 51)


def test_route_launch_checks():
    """The named-route launches run only on the card: an unknown route, the
    band route in fp32 and a CPU tensor raise before any kernel loads;
    ``dwconv_wgrad`` on CPU tensors is the plain version."""
    x = torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        KW.launch("banded", x, x, 9, 5)
    with pytest.raises(TypeError):
        KW.launch("band", x.float(), x.float(), 9, 5)
    for route in ("band", "tiled"):
        with pytest.raises(RuntimeError, match="runs on cuda"):
            KW.launch(route, x, x, 9, 5)
    with pytest.raises(ValueError):
        KW.dwconv_wgrad_band_mirror(x, x, 7, 7)
    xf = torch.randn(2, 2, 8, 8)
    assert torch.equal(KW.dwconv_wgrad(xf, xf, 9, 5),
                       KW.dwconv_wgrad_plain(xf, xf, 9, 5))
