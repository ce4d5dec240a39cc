"""The port's ops (slak_tpu_torch) against slak_tpu on the CPU.

The same seeded numpy inputs go through the JAX function and the port's
counterpart; on CPU tensors the port's kernel wrappers run their plain
PyTorch versions, which is what these tests hold. Each Pallas kernel runs
once in interpret mode; further cases use the JAX plain references
(``depthwise_conv2d_xla``, ``_reference_mlp``). The CUDA kernels themselves
are held against the same plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.models.layers import gelu as jax_gelu
from slak_tpu.models.layers import layer_norm as jax_layer_norm
from slak_tpu.ops.batchnorm import batch_norm as jax_batch_norm
from slak_tpu.ops.batchnorm import fold_bn as jax_fold_bn
from slak_tpu.ops.depthwise import depthwise_conv2d_xla
from slak_tpu.ops.pallas_banded import dwconv_banded_cmajor, lk_pair_banded
from slak_tpu.ops.pallas_mlp import (_reference_mlp, fused_mlp,
                                     fused_mlp_cmajor)
from slak_tpu_torch.models.layers import (drop_path, gelu, layer_norm,
                                          trunc_normal_)
from slak_tpu_torch.ops.batchnorm import batch_norm, fold_bn
from slak_tpu_torch.ops.depthwise import (depthwise_conv2d, fold_branches,
                                          run_taps)
from slak_tpu_torch.ops.dwconv import dwconv
from slak_tpu_torch.ops.mlp import (fused_mlp as torch_fused_mlp,
                                    pack_mlp, token_strides)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a_nhwc):
    return _t(np.transpose(a_nhwc, (0, 3, 1, 2)))


def _taps(w_hwc):
    """(kh, kw, C) JAX taps -> the port's (C, kh, kw)."""
    return _t(np.transpose(w_hwc, (2, 0, 1)))


# --- K1: the depthwise conv --------------------------------------------------

def test_dwconv_matches_banded_kernel(rng):
    """One branch, (31, 5) taps: the port's conv vs the Pallas banded kernel
    (interpret mode) on its C-major, W-padded operand. fp32 sums in another
    order: tolerance 1e-5."""
    n, h, w, c, K, s = 2, 16, 16, 3, 31, 5
    x = rng.standard_normal((n, h, w, c), dtype=np.float32)
    wk = rng.standard_normal((K, s, c), dtype=np.float32) * 0.1
    xc = jnp.pad(jnp.transpose(jnp.asarray(x), (3, 1, 2, 0)),
                 ((0, 0), (0, 0), (s // 2, s // 2), (0, 0)))
    want = np.transpose(np.asarray(
        dwconv_banded_cmajor(xc, jnp.asarray(wk), interpret=True)),
        (3, 0, 1, 2))                                   # (C,H,W,N) -> NCHW
    got = dwconv(_nchw(x), _taps(wk)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dwconv_pair_matches_lk_pair_banded(rng):
    """The decomposed pair (31,5)+(5,31) with folded scales: two launches
    into one output vs ``lk_pair_banded`` (interpret). Tolerance 1e-5."""
    n, h, w, c, K, s = 2, 16, 16, 3, 31, 5
    x = rng.standard_normal((n, h, w, c), dtype=np.float32)
    w1 = rng.standard_normal((K, s, c), dtype=np.float32) * 0.1
    w2 = rng.standard_normal((s, K, c), dtype=np.float32) * 0.1
    s1 = rng.random(c, dtype=np.float32) + 0.5
    s2 = rng.random(c, dtype=np.float32) + 0.5
    want = np.asarray(lk_pair_banded(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(s1),
        jnp.asarray(s2), interpret=True))
    taps, bias = fold_branches([_taps(w1), _taps(w2)], [_t(s1), _t(s2)],
                               [None, None])
    assert bias is None
    y = run_taps(_nchw(x), taps)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kh,kw,hw", [(13, 5, 7), (5, 13, 7), (7, 7, 9),
                                      (51, 5, 12), (1, 3, 4)])
def test_dwconv_matches_xla_conv(rng, kh, kw, hw):
    """Single branches of every orientation, including taps longer than the
    map (all-padding rows skipped), vs ``depthwise_conv2d_xla``; also the
    accumulate form (second launch adds into the first's output).
    Tolerance 1e-5."""
    n, c = 2, 5
    x = rng.standard_normal((n, hw, hw + 1, c), dtype=np.float32)
    wk = rng.standard_normal((kh, kw, c), dtype=np.float32) * 0.1
    want = np.asarray(depthwise_conv2d_xla(jnp.asarray(x), jnp.asarray(wk)))
    got = dwconv(_nchw(x), _taps(wk))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    torch_ref = depthwise_conv2d(_nchw(x), _taps(wk)[:, None])
    np.testing.assert_allclose(got.numpy(), torch_ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    twice = dwconv(_nchw(x), _taps(wk), out=got.clone())
    np.testing.assert_allclose(twice.numpy(), 2 * got.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_fold_branches_matches_unfolded_sum(rng):
    """The eval fold (small branch center-padded into LoRA1, BN folded,
    bias deferred) equals the sum of the three conv+affine branches run
    separately through ``depthwise_conv2d_xla``. Tolerance 1e-5."""
    n, h, c, K, s = 2, 9, 4, 11, 3
    x = rng.standard_normal((n, h, h, c), dtype=np.float32)
    shapes = [(K, s), (s, K), (s, s)]
    ws = [rng.standard_normal(sh + (c,), dtype=np.float32) * 0.1
          for sh in shapes]
    sc = [rng.random(c, dtype=np.float32) + 0.5 for _ in shapes]
    bs = [rng.standard_normal(c, dtype=np.float32) for _ in shapes]
    want = sum(np.asarray(depthwise_conv2d_xla(jnp.asarray(x),
                                               jnp.asarray(w))) * a + b
               for w, a, b in zip(ws, sc, bs))
    taps, bias = fold_branches([_taps(w) for w in ws], [_t(a) for a in sc],
                               [_t(b) for b in bs])
    assert [tuple(t.shape[1:]) for t in taps] == [(K, s), (s, K)]
    y = run_taps(_nchw(x), taps)
    got = (y + bias[:, None, None]).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --- K2/K3: the fused MLP tail -----------------------------------------------

def _mlp_inputs(rng, c, shape):
    f = 4 * c
    return dict(
        y=rng.standard_normal(shape, dtype=np.float32),
        res=rng.standard_normal(shape, dtype=np.float32),
        ln_scale=1.0 + 0.1 * rng.standard_normal(c, dtype=np.float32),
        ln_bias=0.1 * rng.standard_normal(c, dtype=np.float32),
        w1=rng.standard_normal((c, f), dtype=np.float32) / np.sqrt(c),
        b1=0.1 * rng.standard_normal(f, dtype=np.float32),
        w2=rng.standard_normal((f, c), dtype=np.float32) / np.sqrt(f),
        b2=0.1 * rng.standard_normal(c, dtype=np.float32),
        gamma=0.5 + 0.1 * rng.standard_normal(c, dtype=np.float32),
        pre_bias=0.1 * rng.standard_normal(c, dtype=np.float32))


def _pack(p):
    return pack_mlp(*(_t(p[k]) for k in ("ln_scale", "ln_bias", "w1", "b1",
                                          "w2", "b2", "gamma", "pre_bias")))


def _jax_args(p):
    return [jnp.asarray(p[k]) for k in ("y", "res", "ln_scale", "ln_bias",
                                         "w1", "b1", "w2", "b2", "gamma",
                                         "pre_bias")]


def test_mlp_matches_fused_mlp_nhwc(rng):
    """Tokens-major (NHWC) operand vs the Pallas ``fused_mlp`` (interpret);
    its GELU uses the Abramowitz-Stegun erf (|err| <= 1.5e-7), the port's
    the exact one: tolerance 1e-4."""
    c = 13
    p = _mlp_inputs(rng, c, (2, 4, 3, c))
    want = np.asarray(fused_mlp(*_jax_args(p), True, True))
    got = torch_fused_mlp(_t(p["y"]), _t(p["res"]), _pack(p), channel_dim=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_mlp_matches_fused_mlp_cmajor(rng):
    """Channel-major (C, M) operand vs the Pallas ``fused_mlp_cmajor``
    (interpret). Tolerance 1e-4 (A-S erf, as above)."""
    c = 7
    p = _mlp_inputs(rng, c, (c, 24))
    want = np.asarray(fused_mlp_cmajor(*_jax_args(p), True, True))
    got = torch_fused_mlp(_t(p["y"]), _t(p["res"]), _pack(p), channel_dim=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("layout", ["nhwc", "nchw", "cm"])
def test_mlp_matches_reference_mlp(rng, layout, add_residual):
    """Every stride layout vs ``_reference_mlp`` (exact erf, the same op
    composition), odd C: tolerance 1e-5."""
    c = 13
    p = _mlp_inputs(rng, c, (2, 3, 5, c))
    want = np.asarray(_reference_mlp(*_jax_args(p), add_residual))
    pk = _pack(p)
    if layout == "nhwc":
        got = torch_fused_mlp(_t(p["y"]), _t(p["res"]), pk, 3, add_residual)
        got = got.numpy()
    elif layout == "nchw":
        got = torch_fused_mlp(_nchw(p["y"]), _nchw(p["res"]), pk, 1,
                              add_residual).permute(0, 2, 3, 1).numpy()
    else:
        ycm = _t(p["y"].reshape(-1, c).T)
        rcm = _t(p["res"].reshape(-1, c).T)
        got = torch_fused_mlp(ycm, rcm, pk, 0, add_residual)
        got = got.numpy().T.reshape(p["y"].shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mlp_packing_pads_to_tiles(rng):
    """W1^T/W2^T zero-padded to 16 channels and a hidden width of 64; the
    stride triple addresses NHWC, NCHW and (C, M) without a transpose."""
    c = 13
    pk = _pack(_mlp_inputs(rng, c, (1, 1, 1, c)))
    assert pk.w1.shape == (64, 16) and pk.w2.shape == (16, 64)  # W^T
    for w in (pk.w1, pk.w2.t()):
        assert float(w[4 * c:].abs().sum()) == 0.0
        assert float(w[:, c:].abs().sum()) == 0.0
    assert token_strides((2, 5, 6, c), 3) == (60, 1, c, 1, 1)
    assert token_strides((2, c, 5, 6), 1) == (2, 30, c * 30, 30, 1)
    assert token_strides((c, 40), 0) == (1, 40, c * 40, 40, 1)


# --- the ops without kernels -------------------------------------------------

def test_fold_bn_and_batch_norm_match_slak_tpu(rng):
    c = 6
    x = rng.standard_normal((3, 4, 5, c), dtype=np.float32)
    scale, bias, mean = (rng.standard_normal(c, dtype=np.float32)
                         for _ in range(3))
    var = rng.random(c, dtype=np.float32) + 0.5
    jm, ja = jax_fold_bn(scale, bias, mean, var)
    tm, ta = fold_bn(_t(scale), _t(bias), _t(mean), _t(var))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    want, _, _ = jax_batch_norm(jnp.asarray(x), scale, bias, mean, var,
                                train=False)
    got = batch_norm(_nchw(x), _t(scale), _t(bias), _t(mean), _t(var))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [-1, 1])
def test_layer_norm_matches_slak_tpu(rng, dim):
    """Channels-last and channels-first (NCHW) LN vs the JAX LN over the
    trailing axis. Tolerance 1e-5."""
    c = 10
    x = rng.standard_normal((2, 3, 4, c), dtype=np.float32)
    scale = rng.standard_normal(c, dtype=np.float32)
    bias = rng.standard_normal(c, dtype=np.float32)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), scale, bias))
    if dim == -1:
        got = layer_norm(_t(x), _t(scale), _t(bias)).numpy()
    else:
        got = layer_norm(_nchw(x), _t(scale), _t(bias), dim=1)
        got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gelu_matches_slak_tpu(rng):
    """Exact-erf GELU vs ``slak_tpu.models.layers.gelu``. Tolerance 1e-6."""
    x = rng.standard_normal(257, dtype=np.float32) * 4
    np.testing.assert_allclose(gelu(_t(x)).numpy(),
                               np.asarray(jax_gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_drop_path_and_trunc_normal():
    """drop_path: the identity in eval; in training each sample is kept
    (scaled by 1/keep) or zeroed whole. trunc_normal_: N(0, .02) within
    [-2, 2], the same draw for the same generator seed."""
    x = torch.randn(64, 3, 4, 4)
    assert drop_path(x, 0.5) is x
    y = drop_path(x, 0.5, torch.Generator().manual_seed(0), train=True)
    kept = y.flatten(1).abs().sum(1) > 0
    assert 0 < int(kept.sum()) < 64
    torch.testing.assert_close(y[kept], x[kept] * 2.0)
    assert float(y[~kept].abs().sum()) == 0.0
    a = trunc_normal_(torch.empty(20000), 0.02,
                      torch.Generator().manual_seed(1))
    b = trunc_normal_(torch.empty(20000), 0.02,
                      torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and float(a.abs().max()) <= 2.0
    assert abs(float(a.std()) - 0.02) < 1e-3


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for a CPU tensor; a tensor on
    any other device launches the kernel (CUDA) or raises."""
    x = torch.zeros(1, 2, 3, 3, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        dwconv(x, torch.zeros(2, 3, 3, device="meta"))
    pk = pack_mlp(torch.ones(2), torch.zeros(2), torch.zeros(2, 8),
                  torch.zeros(8), torch.zeros(8, 2), torch.zeros(2))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        torch_fused_mlp(x, x, pk, 1)
