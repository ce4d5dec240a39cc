"""The port's train-route ops (slak_tpu_torch) against slak_tpu on the CPU.

Seeded numpy inputs in fp32 go through the JAX function and the port's
counterpart. On CPU tensors the port's wrappers run their plain versions
(the CUDA kernels are held against those versions on the card by
``chip_smoke.py``). Each Pallas kernel runs once in interpret mode: K4
(``dwconv_banded_stats_cmajor``), K5 (``wgrad_banded_cmajor`` +
``band_extract``), K6/K7 (the 2-D Toeplitz pair on 7x7 maps, through the
VJP of ``depthwise_conv2d_banded_stats``) and K8 (``_mlp_bwd_2d``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops import batchnorm as jbn
from slak_tpu.ops.pallas_banded import (band_extract,
                                        depthwise_conv2d_banded_stats,
                                        dwconv_banded_stats_cmajor,
                                        wgrad_banded_cmajor)
from slak_tpu.ops.pallas_mlp import _mlp_bwd_2d
from slak_tpu.sparsity import masking as jm
from slak_tpu.train import losses as jl
from slak_tpu_torch.ops.batchnorm import batch_norm_from_sums, batch_norm_train
from slak_tpu_torch.ops.dwconv import (DwconvBnStats, dwconv_stats,
                                       dwconv_stats_plain)
from slak_tpu_torch.ops.dwconv_wgrad import dwconv_wgrad, dwconv_wgrad_plain
from slak_tpu_torch.ops.mlp import (FusedMlp, fused_mlp_bwd,
                                    fused_mlp_plain, pack_mlp)
from slak_tpu_torch.sparsity import masking as tm
from slak_tpu_torch.train import losses as tl

TOL = 1e-5      # fp32, the same products summed in another order


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _nchw(a_nhwc):
    return _t(np.transpose(a_nhwc, (0, 3, 1, 2)))


def _cmajor(a_nhwc, pw=0):
    """NHWC -> (C, H, W + 2 pw, N), the banded kernels' operand."""
    xc = jnp.transpose(jnp.asarray(a_nhwc), (3, 1, 2, 0))
    return jnp.pad(xc, ((0, 0), (0, 0), (pw, pw), (0, 0)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# --- K4 / K5: the stats forward and the weight gradient ----------------------

def test_dwconv_stats_matches_banded_stats_kernel(rng):
    """(31, 5) taps, 16x16, C=3, N=2: y, sum y and sum y^2 vs the Pallas
    stats kernel (interpret). Tolerance 1e-5 (fp32, sums in another
    order); the sums are compared at 1e-4 of their magnitude."""
    n, h, w, c, K, s = 2, 16, 16, 3, 31, 5
    x = rng.standard_normal((n, h, w, c), dtype=np.float32)
    wk = rng.standard_normal((K, s, c), dtype=np.float32) * 0.1
    # jitted: one XLA program, not the interpreter's op-by-op dispatch
    yc, s1, s2 = jax.jit(
        lambda a, b: dwconv_banded_stats_cmajor(a, b, interpret=True))(
            _cmajor(x, s // 2), jnp.asarray(wk))
    y, t1, t2 = dwconv_stats(_nchw(x), _t(np.transpose(wk, (2, 0, 1))))
    _close(y.numpy(), np.transpose(np.asarray(yc), (3, 0, 1, 2)))
    _close(t1.numpy(), s1, 1e-4)
    _close(t2.numpy(), s2, 1e-4)


def test_dwconv_wgrad_matches_band_extract(rng):
    """(31, 5) taps: dw against ``band_extract(wgrad_banded_cmajor(...),
    K)`` (interpret). Tolerance 1e-4 (sums over N*H*W = 512 products)."""
    n, h, w, c, K, s = 2, 16, 16, 3, 31, 5
    x = rng.standard_normal((n, h, w, c), dtype=np.float32)
    dy = rng.standard_normal((n, h, w, c), dtype=np.float32)
    want = jax.jit(lambda a, b: band_extract(
        wgrad_banded_cmajor(a, b, s, interpret=True), K))(
            _cmajor(x, s // 2), _cmajor(dy))            # (K, s, C)
    got = dwconv_wgrad(_nchw(x), _nchw(dy), K, s)       # (C, K, s)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.transpose(np.asarray(want), (2, 0, 1)), 1e-4)


def test_dwconv_bn_stats_function_matches_jax_vjp(rng):
    """DwconvBnStats forward and backward on the CPU against ``jax.vjp`` of
    ``depthwise_conv2d_banded_stats`` (interpret) with nonzero cotangents
    for y and both sums, on stage 4's shape: (13, 5) taps on 7x7 maps,
    where JAX routes the forward and dgrad through
    ``dwconv_banded2d_cmajor`` (K6) and the weight gradient through
    ``band_extract2d(wgrad_banded2d_cmajor(...))`` (K7). The (K, 5)
    route's kernels are held by the two tests above. Tolerance 1e-4."""
    n, h, w, c, kh, kw = 2, 7, 7, 4, 13, 5
    x = rng.standard_normal((n, h, w, c), dtype=np.float32)
    wk = rng.standard_normal((kh, kw, c), dtype=np.float32) * 0.1
    dy = rng.standard_normal((n, h, w, c), dtype=np.float32)
    ds1 = rng.standard_normal(c, dtype=np.float32)
    ds2 = rng.standard_normal(c, dtype=np.float32) * 0.1

    @jax.jit
    def fwd_bwd(a, b, cot):
        out, vjp = jax.vjp(
            lambda p, q: depthwise_conv2d_banded_stats(p, q, True), a, b)
        return out, vjp(cot)
    (y, s1, s2), (dx, dw) = fwd_bwd(
        jnp.asarray(x), jnp.asarray(wk),
        (jnp.asarray(dy), jnp.asarray(ds1), jnp.asarray(ds2)))

    xt = _nchw(x).requires_grad_()
    wt = _t(np.transpose(wk, (2, 0, 1))[:, None]).requires_grad_()
    ty, t1, t2 = DwconvBnStats.apply(xt, wt)
    _close(ty.detach().numpy(), np.transpose(np.asarray(y), (0, 3, 1, 2)),
           1e-4)
    _close(t1.detach().numpy(), s1, 1e-4)
    _close(t2.detach().numpy(), s2, 1e-4)
    torch.autograd.backward([ty, t1, t2],
                            [_nchw(dy), _t(ds1), _t(ds2)])
    _close(xt.grad.numpy(), np.transpose(np.asarray(dx), (0, 3, 1, 2)), 1e-4)
    _close(wt.grad[:, 0].numpy(), np.transpose(np.asarray(dw), (2, 0, 1)),
           1e-4)


def test_dwconv_stats_plain_is_the_wrapper_on_cpu(rng):
    x = _t(rng.standard_normal((2, 3, 9, 9), dtype=np.float32))
    w = _t(rng.standard_normal((3, 7, 5), dtype=np.float32))
    for a, b in zip(dwconv_stats(x, w), dwconv_stats_plain(x, w)):
        assert torch.equal(a, b)
    dy = _t(rng.standard_normal((2, 3, 9, 9), dtype=np.float32))
    assert torch.equal(dwconv_wgrad(x, dy, 7, 5),
                       dwconv_wgrad_plain(x, dy, 7, 5))


# --- K8: the fused MLP backward ----------------------------------------------

def _mlp_params(rng, c):
    f = 4 * c
    r = rng.standard_normal
    return dict(
        ln_s=1.0 + 0.1 * r(c, dtype=np.float32),
        ln_b=0.1 * r(c, dtype=np.float32),
        w1=r((c, f), dtype=np.float32) * c ** -0.5,
        b1=0.1 * r(f, dtype=np.float32),
        w2=r((f, c), dtype=np.float32) * f ** -0.5,
        b2=0.1 * r(c, dtype=np.float32),
        gamma=0.5 + 0.1 * r(c, dtype=np.float32),
        pre=0.1 * r(c, dtype=np.float32))


def test_mlp_bwd_matches_pallas_bwd_kernel(rng):
    """Plain K8 at an odd C = 13 against ``_mlp_bwd_2d`` (interpret) on
    (T, C) tokens: dy and all seven parameter gradients. Tolerance 1e-4:
    the Pallas kernel's GELU uses the Abramowitz-Stegun erf (|err| <=
    1.5e-7), the port exact erf."""
    c, t = 13, 96
    p = _mlp_params(rng, c)
    y = rng.standard_normal((t, c), dtype=np.float32)
    do = rng.standard_normal((t, c), dtype=np.float32)
    want = _mlp_bwd_2d(jnp.asarray(y), jnp.asarray(do), p["ln_s"], p["ln_b"],
                       p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"],
                       p["pre"], True)
    pk = pack_mlp(_t(p["ln_s"]), _t(p["ln_b"]), _t(p["w1"]), _t(p["b1"]),
                  _t(p["w2"]), _t(p["b2"]), _t(p["gamma"]), _t(p["pre"]))
    got = fused_mlp_bwd(_t(y), _t(do), pk)
    assert len(got) == 8
    _close(got[0].numpy(), want[0], 1e-4)                  # dy
    _close(got[1].numpy(), np.asarray(want[1]).T, 1e-4)    # dW1 (4C, C)
    _close(got[2].numpy(), np.asarray(want[2]).T, 1e-4)    # dW2 (C, 4C)
    for g, w in zip(got[3:], want[3:]):                    # db1 .. dlnb
        _close(g.numpy(), w, 1e-4)


@pytest.mark.parametrize("add_residual", [True, False])
def test_fused_mlp_function_matches_autograd(rng, add_residual):
    """FusedMlp (NCHW, the block's nn.Linear-oriented parameters) against
    torch autograd of the plain forward, every input's gradient. fp32,
    tolerance 1e-5."""
    c = 13
    p = _mlp_params(rng, c)
    y = _t(rng.standard_normal((2, c, 5, 5), dtype=np.float32))
    res = _t(rng.standard_normal((2, c, 5, 5), dtype=np.float32))
    dout = _t(rng.standard_normal((2, c, 5, 5), dtype=np.float32))
    names = ("ln_s", "ln_b", "w1", "b1", "w2", "b2", "gamma")

    def leaves():
        ts = {k: _t(p[k].T if k in ("w1", "w2") else p[k]).requires_grad_()
              for k in names}
        return (y.clone().requires_grad_(), res.clone().requires_grad_(), ts)

    y1, r1, a = leaves()
    out1 = FusedMlp.apply(y1, r1, a["ln_s"], a["ln_b"], a["w1"], a["b1"],
                          a["w2"], a["b2"], a["gamma"], add_residual)
    out1.backward(dout)
    y2, r2, b = leaves()
    pk = pack_mlp(b["ln_s"], b["ln_b"], b["w1"].t(), b["b1"], b["w2"].t(),
                  b["b2"], b["gamma"])
    out2 = fused_mlp_plain(y2, r2, pk, 1, add_residual)
    out2.backward(dout)
    _close(out1.detach().numpy(), out2.detach().numpy())
    _close(y1.grad.numpy(), y2.grad.numpy())
    if add_residual:
        _close(r1.grad.numpy(), r2.grad.numpy())
    else:
        assert r1.grad is None
    for k in names:
        _close(a[k].grad.numpy(), b[k].grad.numpy(), 1e-4)


def test_fused_mlp_function_raises_above_256_channels():
    """K8's wrapper covers C <= 256 on every device and raises above; the
    autograd Function takes any width (its backward picks K9 above 256)."""
    c = 257
    z = torch.zeros(1, c, 1, 1)
    pk = pack_mlp(torch.ones(c), torch.zeros(c), torch.zeros(c, 4 * c),
                  torch.zeros(4 * c), torch.zeros(4 * c, c), torch.zeros(c))
    with pytest.raises(ValueError, match="C = 257"):
        fused_mlp_bwd(z, z, pk, 1)
    out = FusedMlp.apply(z, z, torch.ones(c), torch.zeros(c),
                         torch.zeros(4 * c, c), torch.zeros(4 * c),
                         torch.zeros(c, 4 * c), torch.zeros(c), torch.ones(c))
    assert out.shape == z.shape


# --- BN, losses ----------------------------------------------------------------

def test_train_batch_norm_matches_slak_tpu(rng):
    """Train BN from the batch and from the sums: output and the updated
    running mean and (unbiased) variance. Tolerance 1e-5."""
    x = rng.standard_normal((4, 5, 5, 3), dtype=np.float32) * 2 + 0.5
    sc, bi = 1 + 0.1 * rng.standard_normal(3, dtype=np.float32), \
        0.1 * rng.standard_normal(3, dtype=np.float32)
    rm, rv = 0.1 * rng.standard_normal(3, dtype=np.float32), \
        1 + rng.random(3, dtype=np.float32)
    want = jbn.batch_norm(jnp.asarray(x), sc, bi, rm, rv, train=True)
    s1, s2 = x.sum((0, 1, 2)), (x * x).sum((0, 1, 2))
    want_s = jbn.batch_norm_from_sums(jnp.asarray(x), s1, s2, 100, sc, bi,
                                      rm, rv)
    for fn, ref in ((lambda m, v: batch_norm_train(
            _nchw(x), _t(sc), _t(bi), m, v), want),
                    (lambda m, v: batch_norm_from_sums(
                        _nchw(x), _t(s1), _t(s2), 100, _t(sc), _t(bi), m, v),
                     want_s)):
        m, v = _t(rm.copy()), _t(rv.copy())
        y = fn(m, v)
        _close(y.numpy(), np.transpose(np.asarray(ref[0]), (0, 3, 1, 2)))
        _close(m.numpy(), ref[1])
        _close(v.numpy(), ref[2])


def test_train_losses_match_slak_tpu(rng):
    logits = rng.standard_normal((6, 10), dtype=np.float32) * 3
    labels = rng.integers(0, 10, 6)
    soft = rng.random((6, 10), dtype=np.float32)
    soft /= soft.sum(-1, keepdims=True)
    _close(float(tl.label_smoothing_cross_entropy(_t(logits), _t(labels),
                                                  0.1)),
           float(jl.label_smoothing_cross_entropy(jnp.asarray(logits),
                                                  jnp.asarray(labels), 0.1)))
    _close(float(tl.soft_target_cross_entropy(_t(logits), _t(soft))),
           float(jl.soft_target_cross_entropy(jnp.asarray(logits),
                                              jnp.asarray(soft))))


# --- DST -----------------------------------------------------------------------

def test_prune_and_score_growth_match_slak_tpu(rng):
    """magnitude_prune, set_prune and score_growth on the same arrays give
    the same masks exactly (stable ranks: ties by index order)."""
    shape = (24, 40)
    mask = (rng.random(shape) < 0.6).astype(np.float32)
    w = rng.standard_normal(shape, dtype=np.float32) * mask
    score = rng.standard_normal(shape, dtype=np.float32)
    score[:3] = 0.5                                  # ties
    rate = np.float32(0.3)
    for jf, tf in ((jm.magnitude_prune, tm.magnitude_prune),
                   (jm.set_prune, tm.set_prune)):
        want = np.asarray(jf(jnp.asarray(mask), jnp.asarray(w), rate))
        got = tf(_t(mask), _t(w), torch.tensor(rate)).numpy()
        np.testing.assert_array_equal(got, want)
    pruned = np.asarray(jm.magnitude_prune(jnp.asarray(mask), jnp.asarray(w),
                                           rate))
    regrow = np.float32(mask.sum() - pruned.sum())
    want = np.asarray(jm.score_growth(jnp.asarray(pruned),
                                      jnp.asarray(score), regrow))
    got = tm.score_growth(_t(pruned), _t(score), torch.tensor(regrow))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == mask.sum()


def test_erk_densities_and_cosine_prune_rate_match_slak_tpu():
    shapes = {"a": (51, 5, 124), "b": (124, 496), "c": (496, 124),
              "d": (4, 4, 3, 124), "e": (998, 1000)}
    assert tm.erk_densities(shapes, 0.6) == jm.erk_densities(shapes, 0.6)
    for step in (0, 1, 7, 50, 100, 150):
        _close(float(tm.cosine_prune_rate(step, 0.5, 100)),
               float(jm.cosine_prune_rate(jnp.asarray(step), 0.5, 100)), 1e-7)


def test_random_growth_counts():
    """Random growth regrows a binomial count around ``regrowth`` (the JAX
    draws are other bits; only counts compare)."""
    gen = torch.Generator().manual_seed(0)
    mask = (torch.rand(200, 500, generator=gen) < 0.5).float()
    k = torch.tensor(5000.0)
    grown = tm.random_growth(gen, mask, k)
    n_new = float(grown.sum() - mask.sum())
    zeros = float((mask == 0).sum())
    p = 5000.0 / zeros
    assert abs(n_new - 5000.0) < 5 * (zeros * p * (1 - p)) ** 0.5
    assert torch.all(grown >= mask)
