"""K10's band route (``ops/dwpair.py``'s plain mirror of
``dwpair_band_kernel``) against the plain version and the Pallas pair
kernel on the CPU.

The mirror repeats the kernel's decomposition: branch 1 stages xq as it
lies (long axis H contiguous) and its accumulators are y1[h][w]; branch 2
stages x as it lies and its accumulators are y2q[w][h]; each through the
per-channel Toeplitz band tiles, the shifted staged rows and the padded
tiles, rounded once. The same seeded numpy inputs, rounded to bf16 (the
band is bf16), go through it, through ``dwpair_plain(..., "dualboth", xq,
sum_out=False)`` and through ``dwpair_fused_cmajor(tmode="dualboth",
sum_out=False)`` (interpret mode, jitted, one channel a grid step). The
fp32 sums before the rounding agree within 1e-5 of their scale (the same
products summed in another order); the bf16 outputs within one bf16 ulp
of their scale (a sum that lands near a rounding boundary may round the
other way). The CUDA kernel itself is held against ``dwpair_plain`` on
the card by ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_banded import dwpair_fused_cmajor
from slak_tpu_torch.ops import dwconv as K1
from slak_tpu_torch.ops import dwpair as K10

TOL_SUMS = 1e-5

# (N, C, H, K): (47, 5) on 48^2 (MT 3), (13, 5) on 7^2 (MT 1), batch 3
SHAPES = [(3, 2, 48, 47), (3, 2, 7, 13)]
# SLaK-T 51x51 w1.3's dual stages at 224^2: (C, side, K)
STAGES = ((124, 56, 51), (249, 28, 49), (499, 14, 47), (998, 7, 13))


def _inputs(rng, N, C, H, K):
    """x (N, C, H, H), xq, and taps (C, K, 5) / (C, 5, K), values rounded to
    bf16, fp32."""
    x = torch.from_numpy(rng.standard_normal((N, C, H, H), dtype=np.float32))
    w1, w2 = (torch.from_numpy(rng.standard_normal((C, *t), dtype=np.float32)
                               * 0.1) for t in ((K, 5), (5, K)))
    x, w1, w2 = (t.bfloat16().float() for t in (x, w1, w2))
    return x, x.transpose(2, 3).contiguous(), w1, w2


def _close_sums(got, want):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= TOL_SUMS * scale


def _close_bf16(got, want):
    """Within one bf16 ulp of the scale of ``want``."""
    scale = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert (got.float() - want.float()).abs().max().item() <= ulp


@pytest.mark.parametrize("shape", SHAPES)
def test_pair_band_mirror_matches_plain(rng, shape):
    """The mirror against ``dwpair_plain``'s raw dualboth pair: the fp32
    sums (the plain version on fp32 inputs is unrounded) and the bf16
    pair."""
    x, xq, w1, w2 = _inputs(rng, *shape)
    got = K10.dwpair_band_mirror(x, xq, w1, w2, sums=True)
    want = K10.dwpair_plain(x, w1, w2, "dualboth", xq, sum_out=False)
    assert got[0].shape == x.shape and got[1].shape == xq.shape
    for a, b in zip(got, want):
        _close_sums(a, b)
    xb, xqb = x.bfloat16(), xq.bfloat16()
    got = K10.dwpair_band_mirror(xb, xqb, w1, w2)
    want = K10.dwpair_plain(xb, w1, w2, "dualboth", xqb, sum_out=False)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        _close_bf16(a, b)


def test_pair_band_mirror_matches_pallas_pair(rng):
    """The mirror against ``dwpair_fused_cmajor(tmode="dualboth",
    sum_out=False)`` (interpret, jitted, fed the same xq), the layout
    converted from (C, H, W, N): its fp32 pair against the mirror's sums,
    and rounded to bf16 against the mirror's bf16 pair. (13, 5) taps on
    12^2, longer than the map."""
    x, xq, w1, w2 = _inputs(rng, 3, 2, 12, 13)
    cm = (lambda t: jnp.asarray(t.permute(1, 2, 3, 0).numpy()))
    taps = (lambda t: jnp.asarray(t.permute(1, 2, 0).numpy()))
    want = jax.jit(lambda a, b, c, q: dwpair_fused_cmajor(
        a, b, c, cb=1, tmode="dualboth", interpret=True, xq=q,
        sum_out=False))(cm(x), taps(w1), taps(w2), cm(xq))
    want = [torch.from_numpy(np.array(t)).permute(3, 0, 1, 2) for t in want]
    got = K10.dwpair_band_mirror(x, xq, w1, w2, sums=True)
    for a, b in zip(got, want):
        _close_sums(a, b)
    got = K10.dwpair_band_mirror(x.bfloat16(), xq.bfloat16(), w1, w2)
    for a, b in zip(got, want):
        _close_bf16(a, b.bfloat16())


@pytest.mark.parametrize("N", [1, 3, 8, 64, 256])
def test_pair_band_geometry_stores_every_output_once(N):
    """At the dual stages' shapes: the blocks cover each (branch, channel)
    with image runs that split the batch, a block stores only the images
    of its run, and the runs' stores hit every y1 and y2q element exactly
    once; a chunk's 8 x 8 blocks fit the staging registers of each lane
    (8 at MT = 1, else 16)."""
    for C, H, K in STAGES:
        g = K10.pair_band_geometry(N, C, H, H, K)
        assert g["NB"] * g["BPI"] <= (8 if g["MT"] == 1 else 16) * 8
        blocks = K10.pair_band_blocks(g)
        assert blocks.shape == (g["blocks"], 4) == (2 * C * g["bpc"], 4)
        # each (branch, channel) once per run, runs in order from 0 to N
        key = blocks[:, 0] * C + blocks[:, 1]
        runs = blocks[torch.argsort(key * (N + 1) + blocks[:, 2],
                                    stable=True)].reshape(2 * C, g["bpc"], 4)
        assert torch.equal(runs[:, :, 0] * C + runs[:, :, 1],
                           torch.arange(2 * C)[:, None].expand(-1, g["bpc"]))
        assert (runs[:, 0, 2] == 0).all() and (runs[:, -1, 3] == N).all()
        assert torch.equal(runs[:, 1:, 2], runs[:, :-1, 3])
        assert (runs[:, :, 3] > runs[:, :, 2]).all()
        # a run's stores: within its images, every element once
        order = K1._band_store_order(g, N, H, H)        # (bpc, 256, S)
        first, end = runs[0, :, 2], runs[0, :, 3]
        img = torch.where(order >= 0, order // (H * H), -1)
        ok = order < 0
        ok |= (img >= first[:, None, None]) & (img < end[:, None, None])
        assert ok.all()
        got = order[order >= 0]
        assert torch.equal(got.sort().values, torch.arange(N * H * H))


def test_pair_band_route():
    """The band route takes the dual stage's launch: bf16, dualboth, the
    raw pair, (K, 5) / (5, K) taps with K > 5 on square maps up to 64 (all
    four SLaK-T stages); it refuses fp32, the summed modes, K = 5, other
    short sides, maps above 64 and non-square maps (H != W stays on
    dwpair_kernel)."""
    def route(dtype, H, W, K, s=5, tmode="dualboth", sum_out=False):
        return K10.pair_band_route(torch.empty(1, 1, H, W, dtype=dtype),
                                   torch.empty(1, K, s), torch.empty(1, s, K),
                                   tmode, sum_out)
    bf, f32 = torch.bfloat16, torch.float32
    assert all(route(bf, H, H, K) for _, H, K in STAGES)
    assert route(bf, 64, 64, 63) and route(bf, 9, 9, 7)
    assert not route(f32, 56, 56, 51)
    assert not route(bf, 56, 56, 51, sum_out=True)
    assert not any(route(bf, 56, 56, 51, tmode=m, sum_out=False)
                   for m in ("kernel", "input", "dualout"))
    assert not route(bf, 56, 56, 5) and not route(bf, 56, 56, 7, 3)
    assert not route(bf, 65, 65, 51) and not route(bf, 256, 256, 51)
    assert not route(bf, 14, 13, 47) and not route(bf, 13, 14, 47)
    with pytest.raises(ValueError):
        K10.pair_band_geometry(3, 2, 14, 13, 47)


def test_pair_launch_checks():
    """The named-route launches run only on the card: an unknown route and
    a CPU tensor raise before any kernel loads; ``dwpair`` on the CPU runs
    the plain version, the band shapes included."""
    x = torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(2, 9, 5), torch.zeros(2, 5, 9)
    with pytest.raises(ValueError):
        K10.launch("tiled", x, w1, w2, "dualboth", sum_out=False)
    for route in ("band", "simt"):
        with pytest.raises(RuntimeError, match="runs on cuda"):
            K10.launch(route, x, w1, w2, "dualboth", sum_out=False)
    before = (K10.pair_launch_count, K10.pair_band_launch_count)
    y1, y2q = K10.dwpair(x, w1, w2, "dualboth", sum_out=False)
    assert y1.shape == y2q.shape == x.shape
    assert (K10.pair_launch_count, K10.pair_band_launch_count) == before
