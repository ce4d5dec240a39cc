"""The fp32 band kernel's decomposition (``ops/dwconv.py``'s plain mirror of
``dwconv_band_f32_kernel`` in ``csrc/dwconv_f32.cu``) against the plain
version and the Pallas banded kernel on the CPU.

The mirror stages each block's rows (the outputs' rows and 2 more on each
side, zero outside the map and between stacked images) over the k-tiles
its band reaches, splits both operands into TF32 planes, builds for each
tap j the band of live 8 x 8 tiles and sums the three products (small x
big, big x small, big x big) a tap into the output tile, which it scatters
back. The same seeded numpy inputs in fp32 go through it, through
``dwconv_plain`` and through ``dwconv_banded_cmajor`` (fp32, interpret
mode, jitted; Precision.HIGHEST); the (5, K) orientation runs the Pallas
kernel on the transposed map. 3xTF32 is as accurate as fp32 FFMA, with
sums in another order: tolerance 1e-5 of the output's scale, the card's
``TOL_KERNEL["float32"]``. The CUDA kernel itself is held against the same
plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_banded import dwconv_banded_cmajor
from slak_tpu_torch.ops import dwconv as K1

TOL = 1e-5

# (N, C, H, W, kh, kw): maps above 64 with two row tiles, a map whose axes
# are not multiples of 16, taps longer than the map (images stacked), 7 x 7
# with 13 taps, both orientations, batches 1 and 3
SHAPES = [(1, 2, 80, 80, 51, 5), (1, 2, 72, 100, 5, 49),
          (3, 2, 30, 45, 47, 5), (3, 2, 12, 12, 51, 5),
          (3, 2, 12, 12, 5, 51), (1, 3, 7, 7, 13, 5), (3, 3, 7, 7, 5, 13)]
# SLaK-T 51x51 w1.3's stages (C, H, K): the ERF at 1024^2, the eval at 224^2
ERF_STAGES = ((124, 256, 51), (249, 128, 49), (499, 64, 47), (998, 32, 13))
EVAL_STAGES = ((124, 56, 51), (249, 28, 49), (499, 14, 47), (998, 7, 13))


def _inputs(rng, N, C, H, W, kh, kw):
    """x (N, C, H, W) and taps (C, kh, kw), fp32."""
    x = rng.standard_normal((N, C, H, W), dtype=np.float32)
    w = rng.standard_normal((C, kh, kw), dtype=np.float32) * 0.1
    return torch.from_numpy(x), torch.from_numpy(w)


def _close(got, want):
    """max |got - want| within TOL of max |want|."""
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err


@pytest.mark.parametrize("shape", SHAPES)
def test_band_f32_mirror_matches_plain(rng, shape):
    """The mirror against ``dwconv_plain``, alone and adding into an
    output (the pair's second launch)."""
    x, w = _inputs(rng, *shape)
    g = K1.band_f32_geometry(*shape)
    if max(shape[2:4]) > 64:               # the F slices of one image
        assert not g["stack"] and g["fblocks"] >= 2
    _close(K1.dwconv_band_f32_mirror(x, w), K1.dwconv_plain(x, w))
    out = torch.from_numpy(rng.standard_normal(x.shape, dtype=np.float32))
    _close(K1.dwconv_band_f32_mirror(x, w, out.clone()),
           K1.dwconv_plain(x, w, out.clone()))


def _pallas(x, w):
    """dwconv_banded_cmajor in fp32 (interpret mode) on NCHW x and (C, kh,
    kw) taps, (5, K) taps on the transposed map."""
    long_h = w.shape[2] == 5
    xx, ww = (x, w) if long_h else (x.transpose(2, 3), w.transpose(1, 2))
    s = ww.shape[2]
    xc = jnp.pad(jnp.asarray(xx.permute(1, 2, 3, 0).numpy()),
                 ((0, 0), (0, 0), (s // 2, s // 2), (0, 0)))
    wk = jnp.asarray(ww.permute(1, 2, 0).numpy())          # (kh, kw, C)
    # jitted: one XLA program; one channel a grid step
    res = jax.jit(lambda a, b: dwconv_banded_cmajor(a, b, cb=1,
                                                    interpret=True))(xc, wk)
    y = torch.from_numpy(np.array(res)).permute(3, 0, 1, 2)  # -> NCHW
    return y if long_h else y.transpose(2, 3)


@pytest.mark.parametrize("shape", [(1, 2, 80, 80, 51, 5),
                                   (1, 2, 72, 100, 5, 49)])
def test_band_f32_mirror_matches_pallas_banded(rng, shape):
    """The mirror against the Pallas banded kernel in fp32 (interpret), on
    a map above 64 in each orientation."""
    x, w = _inputs(rng, *shape)
    _close(K1.dwconv_band_f32_mirror(x, w), _pallas(x, w))


@pytest.mark.parametrize("stages,batches", [(ERF_STAGES, (1,)),
                                            (EVAL_STAGES, (1, 3, 8, 64))])
def test_band_f32_geometry_stores_every_output_once(stages, batches):
    """At the ERF's four 1024^2 stage shapes and the eval's four 224^2 ones
    (both orientations, the paths' batches): the blocks of a channel store
    each output exactly once, a block has at most 8 warps and fits its
    shared memory, and its staged rows hold its warp tiles' rows and their
    4 halo rows."""
    for C, H, K in stages:
        for N in batches:
            for kh, kw in ((K, 5), (5, K)):
                g = K1.band_f32_geometry(N, C, H, H, kh, kw)
                assert 1 <= g["warps"] <= 8 and g["smem"] <= 200 * 1024
                assert g["SR"] == 32 * g["WF"] + 4 and g["ND"] <= 9
                idx = torch.cat([K1.band_f32_tile_index(g, blk, H, H)
                                 .flatten()
                                 for blk in K1.band_f32_blocks(g, N)])
                got = idx[idx >= 0]
                assert got.numel() == N * H * H
                assert torch.equal(got.sort().values,
                                   torch.arange(N * H * H))
                assert g["blocks"] == C * len(list(K1.band_f32_blocks(g, N)))


def test_band_f32_route():
    """fp32 (K, 5) / (5, K) taps within four live diagonals take the fp32
    band kernel at any map size; bf16 keeps its own route; square taps,
    and taps past the diagonals on a long axis above 40, take the tiled
    kernel."""
    def route(dtype, H, W, kh, kw):
        x, w = torch.empty(1, 1, H, W, dtype=dtype), torch.empty(1, kh, kw)
        return K1.band_f32_route(x, w), K1._route_of(x, w)
    bf, f32 = torch.bfloat16, torch.float32
    for (C, H, K) in ERF_STAGES + EVAL_STAGES:
        assert route(f32, H, H, K, 5) == (True, "band_f32")
        assert route(f32, H, H, 5, K) == (True, "band_f32")
    assert route(f32, 1024, 1024, 65, 5) == (True, "band_f32")
    assert route(f32, 40, 40, 99, 5) == (True, "band_f32")
    assert route(f32, 41, 1024, 99, 5) == (False, "tiled")
    assert route(f32, 56, 56, 5, 5) == (False, "tiled")
    assert route(f32, 56, 56, 7, 7) == (False, "tiled")
    assert route(bf, 56, 56, 51, 5) == (False, "band")
    assert route(bf, 256, 256, 51, 5) == (False, "band")
    assert route(bf, 256, 256, 67, 5) == (False, "tiled")


def test_band_f32_launch_checks():
    """The named-route launch runs only on the card: an unknown route,
    bf16 on the fp32 band route (K1 and the stats variant) and a CPU
    tensor raise before any kernel loads; the mirror refuses what the
    kernel does not take."""
    x = torch.zeros(1, 2, 8, 8)
    w = torch.zeros(2, 9, 5)
    with pytest.raises(ValueError):
        K1.launch("band32", x, w)
    with pytest.raises(TypeError):
        K1.launch("band_f32", x.bfloat16(), w)
    with pytest.raises(TypeError):
        K1.launch_stats("band_f32", x.bfloat16(), w)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        K1.launch("band_f32", x, w)
    with pytest.raises(TypeError):
        K1.dwconv_band_f32_mirror(x.bfloat16(), w)
    with pytest.raises(ValueError):
        K1.dwconv_band_f32_mirror(x, torch.zeros(2, 5, 5))
    before = K1.tf32_launch_count
    K1.dwconv(x, w)                               # the CPU: the plain version
    assert K1.tf32_launch_count == before
