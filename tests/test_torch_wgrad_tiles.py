"""The weight gradient's tiled route on large planes: the plan of row tiles
its host code stages (``ops/dwconv_wgrad.py`` ``tile_rows`` / ``tile_plan``,
the mirror of ``smem_bytes`` in ``csrc/dwconv_wgrad.cu``) for square taps
on ``wgrad_kernel`` and (K, 5) / (5, K) taps on ``wgrad_tiled_kernel``, and
the plain version at square taps on a map above the old whole-plane limit
against ``jax.vjp`` of ``slak_tpu``'s XLA depthwise conv.

The kernels themselves are held against the plain version on the card by
``chip_smoke.py`` (``WGRAD_EDGES_SQUARE``, ``WGRAD_EDGES_TILED``), whose
host plan it also holds against this mirror.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.depthwise import depthwise_conv2d_xla
from slak_tpu_torch.ops import dwconv_wgrad as KW

SMEM = 200 * 1024

# (H, W, kh, kw): square taps above the old limit (51x51 from 156^2, 7x7
# from 160^2), at it, below it, a map that leaves a short last tile, and
# (K, 5) / (5, K) taps on detection's 200^2 stage 1
PLANS = [(200, 200, 51, 51), (200, 200, 7, 7), (300, 264, 13, 13),
         (224, 224, 7, 7), (155, 155, 51, 51), (156, 156, 51, 51),
         (159, 159, 7, 7), (160, 160, 7, 7), (56, 56, 7, 7),
         (1000, 900, 3, 3), (200, 200, 51, 5), (210, 160, 5, 49)]


@pytest.mark.parametrize("shape", PLANS)
def test_tile_plan_covers_rows_once(shape):
    """Every output row along the tiled axis in exactly one tile, in
    order; each tile's input rows those its outputs read that lie on the
    map; each tile within the 200 KB; a plane whose two fp32 copies fit
    is one tile, and larger tiles would not fit."""
    H, W, kh, kw = shape
    plan = KW.tile_plan(H, W, kh, kw)
    rows = KW.tile_rows(H, W, kh, kw)
    long_axis_w = kh == 5 and kw != 5
    ha, K = (W, kw) if long_axis_w else (H, kh)
    assert plan and [t[0] for t in plan] == list(range(0, ha, rows))
    covered = [r for r0, r1, _, _ in plan for r in range(r0, r1)]
    assert covered == list(range(ha))
    for r0, r1, x0, x1 in plan:
        assert (x0, x1) == (max(0, r0 - K // 2), min(ha, r1 + K // 2))
    assert KW._tile_smem(H, W, kh, kw, rows) <= SMEM
    if rows < ha:
        assert KW._tile_smem(H, W, kh, kw, rows + 1) > SMEM
    whole = KW._tile_smem(H, W, kh, kw, ha) <= SMEM
    assert whole == (len(plan) == 1)


def test_tile_plan_limits():
    """The old whole-plane limits (the largest square plane staged whole:
    155^2 at 51x51, 159^2 at 7x7) and a plane no row of which fits."""
    assert KW.tile_rows(155, 155, 51, 51) == 155
    assert KW.tile_rows(156, 156, 51, 51) < 156
    assert KW.tile_rows(159, 159, 7, 7) == 159
    assert KW.tile_rows(160, 160, 7, 7) < 160
    assert KW.tile_rows(10, 60000, 7, 7) == 0
    assert KW.tile_plan(10, 60000, 7, 7) == []


def test_tiled_launch_refuses_only_where_no_row_fits():
    """The wrapper refuses a plane not one row of which fits, naming the
    limit, before any kernel loads; a plane that takes row tiles goes on
    to the device check."""
    x = torch.zeros(1, 1, 10, 60000)
    with pytest.raises(ValueError, match="not one row"):
        KW.launch("tiled", x, x, 7, 7)
    x = torch.zeros(1, 1, 200, 200)
    with pytest.raises(RuntimeError, match="runs on cuda"):
        KW.launch("tiled", x, x, 51, 51)


@pytest.mark.parametrize("K", [51, 7])
def test_wgrad_plain_square_taps_matches_xla_vjp(rng, K):
    """``dwconv_wgrad_plain`` at square taps on a 170^2 map (above the old
    limit) against the tap gradient of ``depthwise_conv2d_xla`` through
    ``jax.vjp``; fp32 sums in another order: 1e-5 of the scale."""
    N, C, H, W = 1, 2, 170, 170
    x = rng.standard_normal((N, C, H, W), dtype=np.float32)
    dy = rng.standard_normal((N, C, H, W), dtype=np.float32)
    w = rng.standard_normal((K, K, C), dtype=np.float32) * 0.05
    got = KW.dwconv_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                K, K)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    _, vjp = jax.vjp(lambda ww: depthwise_conv2d_xla(xh, ww),
                     jnp.asarray(w))
    (dw,) = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
    want = np.asarray(dw).transpose(2, 0, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
