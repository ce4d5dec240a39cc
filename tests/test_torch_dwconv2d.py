"""K6's kernel (``ops/dwconv2d.py``'s plain mirror of ``dwconv2d_kernel``)
against the plain versions and the Pallas 2-D Toeplitz kernel on the CPU.

``toeplitz2d`` is held to ``build_banded2d`` exactly. The mirror repeats
the kernel's decomposition: each channel's A2 padded to whole n-tiles and
k-steps, in bf16; the images in tiles of 64 rows, the rows past the batch
zero; fp32 sums, one rounding. The same seeded numpy inputs (taps rounded
to bf16, as every bf16 caller rounds them) go through it, through
``dwconv_plain`` / ``dwconv_stats_plain`` and through
``dwconv_banded2d_cmajor`` / the 2-D branch of
``dwconv_banded_stats_cmajor_vjp`` (interpret mode, jitted). The fp32
results agree within 1e-5 of their scale (the same products summed in
another order); the bf16 outputs within one bf16 ulp of their scale (a
sum near a rounding boundary may round the other way). The CUDA kernel
itself is held against the plain versions, and its sums to the bits of
``dwconv2d_stats_sums``, on the card by ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_banded import (build_banded2d,
                                        dwconv_banded2d_cmajor,
                                        dwconv_banded_stats_cmajor_vjp)
from slak_tpu_torch.ops import dwconv as K1
from slak_tpu_torch.ops import dwconv2d as K6

TOL = 1e-5


def _taps(rng, C, kh, kw):
    return torch.from_numpy(rng.standard_normal((C, kh, kw),
                                                dtype=np.float32)
                            * 0.1).bfloat16().float()


def _x(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def _close(got, want, tol=TOL):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale


def _close_bf16(got, want):
    """Within one bf16 ulp of the scale of ``want``."""
    scale = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert (got.float() - want.float()).abs().max().item() <= ulp


def _cm(t):
    """(N, C, H, W) -> the JAX kernels' C-major (C, H, W, N)."""
    return jnp.asarray(t.permute(1, 2, 3, 0).numpy())


@pytest.mark.parametrize("H, W, kh, kw", [(7, 7, 13, 5), (7, 7, 5, 13),
                                          (7, 7, 13, 13), (7, 7, 5, 5),
                                          (3, 5, 3, 3)])
def test_toeplitz2d_is_build_banded2d(rng, H, W, kh, kw):
    """The port's A2 is ``build_banded2d``'s, taps (C, kh, kw) against
    (kh, kw, C), exactly."""
    w = _taps(rng, 3, kh, kw)
    want = build_banded2d(jnp.asarray(w.permute(1, 2, 0).numpy()), H, W)
    got = K6.toeplitz2d(w, H, W)
    assert got.shape == (3, H * W, H * W)
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_toeplitz2d_of_flipped_taps_is_the_transpose(rng):
    """A2(flip w) = A2(w)^T: the dgrad is the forward on flipped taps."""
    for H, W, kh, kw in ((7, 7, 13, 5), (7, 7, 5, 13), (3, 5, 3, 3)):
        w = _taps(rng, 2, kh, kw)
        assert torch.equal(K6.toeplitz2d(w.flip(1, 2), H, W),
                           K6.toeplitz2d(w, H, W).transpose(1, 2))


@pytest.mark.parametrize("N", [3, 65])
def test_mirror_matches_pallas_and_plain(rng, N):
    """fp32: the mirror against ``dwconv_banded2d_cmajor`` (interpret) at
    stage 4's taps; 65 images leave the second 64-row tile ragged. bf16:
    against ``dwconv_plain``."""
    C, H, kh, kw = 3, 7, 13, 5
    x, w = _x(rng, N, C, H, H), _taps(rng, C, kh, kw)
    want = jax.jit(lambda a, b: dwconv_banded2d_cmajor(a, b, interpret=True))(
        _cm(x), jnp.asarray(w.permute(1, 2, 0).numpy()))
    want = torch.from_numpy(np.array(want)).permute(3, 0, 1, 2)
    got = K6.dwconv2d_mirror(x, w)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    xb = x.bfloat16()
    got = K6.dwconv2d_mirror(xb, w)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, K1.dwconv_plain(xb, w))


def test_mirror_accumulates_into_out(rng):
    """K1's accumulate contract, as the eval pair's second branch uses it:
    the (5, 13) branch added into the (13, 5) branch's output in place, one
    rounding, against ``dwconv_plain`` with ``out``."""
    x = _x(rng, 5, 4, 7, 7).bfloat16()
    w1, w2 = _taps(rng, 4, 13, 5), _taps(rng, 4, 5, 13)
    want = K1.dwconv_plain(x, w2, out=K1.dwconv_plain(x, w1))
    y = K6.dwconv2d_mirror(x, w1)
    got = K6.dwconv2d_mirror(x, w2, out=y)
    assert got is y
    _close_bf16(got, want)


def test_stats_mirror_matches_pallas_vjp(rng):
    """(y, s1, s2) against the 2-D branch of
    ``dwconv_banded_stats_cmajor_vjp`` (interpret), fp32, ragged over the
    64-row tile; the sums within 1e-5 of max_c sum |y|."""
    N, C, kh, kw = 67, 3, 5, 13
    x, w = _x(rng, N, C, 7, 7), _taps(rng, C, kh, kw)
    y, s1, s2 = jax.jit(lambda a, b: dwconv_banded_stats_cmajor_vjp(
        a, b, True))(_cm(x), jnp.asarray(w.permute(1, 2, 0).numpy()))
    gy, g1, g2 = K6.dwconv2d_stats_mirror(x, w)
    _close(gy, torch.from_numpy(np.array(y)).permute(3, 0, 1, 2))
    scale = gy.abs().sum((0, 2, 3)).max().item()
    for got, want in ((g1, s1), (g2, s2)):
        d = (got - torch.from_numpy(np.array(want))).abs().max().item()
        assert d <= TOL * scale
    # bf16: the sums of the stored y, in the kernel's order
    xb = x.bfloat16()
    yb, b1, b2 = K6.dwconv2d_stats_mirror(xb, w)
    _, p1, p2 = K1.dwconv_stats_plain(xb, w)
    _close_bf16(yb, K1.dwconv_plain(xb, w))
    scale = yb.float().abs().sum((0, 2, 3)).max().item()
    assert max((b1 - p1).abs().max().item(),
               (b2 - p2).abs().max().item()) <= TOL * scale


@pytest.mark.parametrize("N", [1, 3, 8, 64, 65, 128, 256])
def test_geometry_covers_every_plane_once(N):
    """The work items (runs of channels over tiles of 64 images) cover
    every (image, channel) exactly once, at stage 4's C = 998 and at C =
    4; a staged row holds its run at any lead with the pair loads' 8 bytes
    of slack, its pitch puts a fragment's 8 rows on distinct banks; the
    taps' window fits the byte-wide index table; the shared memory fits."""
    for C, H, W, kh, kw in ((998, 7, 7, 13, 5), (998, 7, 7, 5, 13),
                            (4, 8, 8, 13, 13), (4, 1, 1, 3, 3),
                            (4, 7, 7, 51, 51)):
        for acc in (False, True):
            g = K6.dwconv2d_geometry(N, C, H, W, kh, kw, acc)
            seen = torch.zeros(N, C, dtype=torch.int32)
            for t, c0, cb, n0, ni in K6.dwconv2d_items(g, N, C):
                assert 1 <= cb <= g["CB"] and 1 <= ni <= K6.MI
                seen[n0:n0 + ni, c0:c0 + cb] += 1
            assert (seen == 1).all()
            assert g["items"] == g["R"] * g["T"]
            assert 16 * g["NCH"] >= K6.LEAD_MAX + g["CB"] * g["P"] * 2
            assert g["RP"] >= 16 * g["NCH"] + 8 and g["RP"] % 32 == 16
            assert g["KW"] < 256 and g["KWP"] > g["KW"]
            assert g["smem"] <= 200 * 1024


def test_routes():
    """bf16 on maps with H * W <= P_MAX takes K6's kernel in both K1 and
    K4, whatever the odd taps; bf16 14x14 stays on the band kernel, fp32
    7x7 on the fp32 band kernel (K1 and K4)."""
    def routes(dtype, H, W, kh, kw):
        x, w = torch.empty(1, 1, H, W, dtype=dtype), torch.empty(1, kh, kw)
        return (K1.toeplitz2d_route(x, w), K1._route_of(x, w),
                K1._stats_route_of(x, w))
    bf, f32 = torch.bfloat16, torch.float32
    for taps in ((13, 5), (5, 13), (13, 13), (3, 3)):
        assert routes(bf, 7, 7, *taps) == (True, "toeplitz2d", "toeplitz2d")
    assert routes(bf, 8, 8, 13, 5)[1] == "toeplitz2d"
    assert routes(bf, 14, 14, 47, 5) == (False, "band", "band")
    assert routes(bf, 14, 14, 5, 47) == (False, "band", "band")
    assert routes(f32, 7, 7, 13, 5) == (False, "band_f32", "band_f32")
    assert routes(bf, 9, 8, 13, 5)[1] == "band"
    with pytest.raises(ValueError):
        K6.dwconv2d_geometry(1, 1, 9, 8, 13, 5)


def test_launch_checks():
    """The kernel runs only on the card: a CPU tensor on the named route
    raises before any kernel loads, and ``dwconv`` / ``dwconv_stats`` on
    the CPU run the plain versions, uncounted."""
    x = torch.zeros(2, 3, 7, 7, dtype=torch.bfloat16)
    w = torch.zeros(3, 13, 5)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        K1.launch("toeplitz2d", x, w)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        K1.launch_stats("toeplitz2d", x, w)
    before = (K1.launch_count, K1.toeplitz_launch_count,
              K1.stats_launch_count, K1.toeplitz_stats_launch_count)
    assert K1.dwconv(x, w).shape == x.shape
    assert K1.dwconv_stats(x, w)[0].shape == x.shape
    assert (K1.launch_count, K1.toeplitz_launch_count,
            K1.stats_launch_count, K1.toeplitz_stats_launch_count) == before
