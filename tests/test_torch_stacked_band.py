"""K11's bf16 kernel and K13's band route, through their plain mirrors,
against the plain versions and the Pallas kernels on the CPU.

``dwconv_stacked_mirror`` repeats ``stacked_band_kernel``'s decomposition
(the stacked band with its dead-tap rows, one product a chunk over the
staged images with their halo, the chunk's shift as a row offset, the
shift-add in the kernel's tap order); ``dwconv_probe_band_mirror`` repeats
K13's band route (the band mirror on the cut taps; with no tap the staged
operand moved into the output tiles). The same seeded numpy inputs go
through them, through ``dwconv_plain`` / ``dwconv_probe_plain`` and through
``dwconv_banded_stacked_cmajor`` / ``dwconv_banded_cmajor`` (interpret mode,
jitted, one channel a grid step), in fp32 within 1e-5 (the same products
summed in another order); bf16 outputs within one bf16 ulp of their scale.
Shapes the CUDA wrappers do not take must raise before any launch, checked
through the route functions the wrappers call first. The CUDA kernels are
held against the same plain versions on the card by ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_banded import (dwconv_banded_cmajor,
                                        dwconv_banded_stacked_cmajor)
from slak_tpu_torch.ops import dwconv as K1
from slak_tpu_torch.ops import dwconv_stacked as K11

TOL = 1e-5

# (N, C, H, W, kh, kw): g = 1, 2, 4 (two chunks, three dead taps), 5 (batch
# 3), 3 (two chunks, one dead tap); no H a multiple of 16
SHAPES = [(2, 2, 40, 12, 13, 5), (2, 2, 28, 10, 13, 5), (2, 2, 14, 9, 13, 5),
          (3, 2, 7, 7, 13, 5), (2, 2, 20, 9, 9, 5)]
# SLaK-T 51x51 w1.3's stages at 224^2: (C, side, K)
STAGES = ((124, 56, 51), (249, 28, 49), (499, 14, 47), (998, 7, 13))

_banded = jax.jit(lambda a, b: dwconv_banded_cmajor(a, b, cb=1,
                                                    interpret=True))
_stacked = jax.jit(lambda a, b: dwconv_banded_stacked_cmajor(
    a, b, cb=1, interpret=True))


def _inputs(rng, N, C, H, W, kh, kw):
    x = torch.from_numpy(rng.standard_normal((N, C, H, W), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((C, kh, kw), dtype=np.float32)
                         * 0.1)
    return x, w


def _pallas(fn, x, w):
    """``fn`` on the W-padded C-major operand and (kh, kw, C) taps, back to
    NCHW."""
    s = w.shape[2]
    xc = jnp.pad(jnp.asarray(x.permute(1, 2, 3, 0).numpy()),
                 ((0, 0), (0, 0), (s // 2, s // 2), (0, 0)))
    out = fn(xc, jnp.asarray(w.permute(1, 2, 0).numpy()))
    return torch.from_numpy(np.array(out)).permute(3, 0, 1, 2)


def _close_bf16(got, want):
    """Within one bf16 ulp of the scale of ``want``."""
    scale = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert (got.float() - want.float()).abs().max().item() <= ulp


@pytest.mark.parametrize("shape", SHAPES)
def test_stacked_mirror_matches_plain(rng, shape):
    """The mirror's fp32 conv against ``dwconv_plain``, each shape's g as
    ``stack_group`` picks it."""
    x, w = _inputs(rng, *shape)
    g = K11.stacked_band_geometry(*shape)
    assert g["g"] == K11.stack_group(shape[2], shape[5])
    got = K11.dwconv_stacked_mirror(x, w)
    np.testing.assert_allclose(got.numpy(), K1.dwconv_plain(x, w).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[3]])
def test_stacked_mirror_matches_pallas_stacked(rng, shape):
    """The mirror against ``dwconv_banded_stacked_cmajor`` (interpret) on
    the same inputs: g = 4 with two chunks, g = 5 at batch 3 (the TPU stacks
    128 // H taps, the kernel 64 // H: the same conv)."""
    x, w = _inputs(rng, *shape)
    np.testing.assert_allclose(K11.dwconv_stacked_mirror(x, w).numpy(),
                               _pallas(_stacked, x, w).numpy(), rtol=TOL,
                               atol=TOL)


def test_stacked_mirror_bf16(rng):
    """bf16 in, taps rounded to bf16: the mirror's one rounding within one
    ulp of the plain version's."""
    x, w = _inputs(rng, *SHAPES[4])
    xb, wb = x.bfloat16(), w.bfloat16().float()
    got = K11.dwconv_stacked_mirror(xb, wb)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, K1.dwconv_plain(xb, wb))


@pytest.mark.parametrize("ntaps", [0, 1, 5])
def test_probe_band_mirror_matches_banded_variant(rng, ntaps):
    """K13's band mirror with the first ``ntaps`` tap columns against
    ``dwconv_banded_cmajor`` (interpret) with the later ones zeroed, and
    the copy (no tap) exactly against the W-padded input's first W columns;
    both against ``dwconv_probe_plain``. Values rounded to bf16 (the band
    kernel's taps come rounded by every caller; its mirror's band is
    bf16), sums in fp32."""
    x, w = (t.bfloat16().float() for t in _inputs(rng, 2, 3, 9, 11, 13, 5))
    got = K1.dwconv_probe_band_mirror(x, w, ntaps)
    plain = K1.dwconv_probe_plain(x, w, ntaps)
    if ntaps == 0:
        want = torch.nn.functional.pad(x, (2, 2))[..., 0:11]
        assert torch.equal(got, want) and torch.equal(got, plain)
        return
    wz = w.clone()
    wz[:, :, ntaps:] = 0
    want = _pallas(_banded, x, wz)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)


def test_shapes_outside_the_routes_raise():
    """The CUDA wrappers check these first: bf16 K13 outside
    ``band_route`` (a map axis above BAND_MAX) and taps other than (K, 5)
    raise ValueError naming the limit; bf16 K11 outside the stacked band
    kernel's geometry (a side above 64, or W + g - 1 past a warp tile)
    raises too; fp32 takes the other kernels."""
    bf = torch.bfloat16

    def x(*s, dtype=bf):
        return torch.empty(*s, dtype=dtype)
    taps = torch.empty(1, 51, 5)
    assert K1.probe_route(x(1, 1, 64, 64), taps, 1) == "band"
    for shape in ((1, 1, 65, 10), (1, 1, 10, 80)):
        with pytest.raises(ValueError, match="maps up to 64"):
            K1.probe_route(x(*shape), taps, 1)
    for t in ((1, 5, 51), (1, 51, 3)):
        with pytest.raises(ValueError, match=r"\(K, 5\)"):
            K1.probe_route(x(1, 1, 16, 16), torch.empty(*t), 1)
    assert K1.probe_route(x(1, 1, 80, 80, dtype=torch.float32), taps,
                          5) == "tiled"
    assert K11.stacked_route(x(2, 1, 56, 56), taps) == "band"
    for shape in ((1, 1, 65, 10), (1, 1, 10, 65), (1, 1, 14, 40)):
        with pytest.raises(ValueError, match="stacked band kernel"):
            K11.stacked_route(x(*shape), taps)
    assert K11.stacked_route(x(1, 1, 14, 40, dtype=torch.float32),
                             taps) == "simt"


def test_stacked_geometry_at_the_stages():
    """At the four SLaK-T stages, batches 1-128: g = 1, 2, 4, 5; a warp
    tile is the whole image where g > 1; a chunk's 8 x 8 blocks fit the
    staging registers; the shared memory fits 200 KB; the live tiles the
    kernel's products count (the band kernel's 490 a plane and tap column
    set at stage 1)."""
    for N in (1, 3, 8, 64, 128):
        for (C, H, K), gw in zip(STAGES, (1, 2, 4, 5)):
            g = K11.stacked_band_geometry(N, C, H, H, K, 5)
            assert g["g"] == gw and g["nc"] == -(-5 // gw)
            assert g["TPI"] == 1 or gw == 1
            bpi = -(-H // 8) ** 2
            assert g["NB"] * bpi <= (8 if g["MQ"] == 1 else 16) * 8
            assert g["smem"] <= 200 * 1024 and g["bpc"] * g["CPB"] * g[
                "NB"] >= N
    assert [K11.stacked_band_products(H, H, K, 5) for _, H, K in STAGES] \
        == [490, 80, 15, 6]
