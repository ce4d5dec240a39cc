"""The bf16 fused MLP's wide route (C > 256) against slak_tpu on the CPU.

Above 256 channels ``mlp.cu`` runs the tail as three launches: the
LayerNorm into h, the GELU GEMM into g and the residual GEMM. Their plain
versions (``mlp_ln_plain``, ``mlp_gelu_gemm_plain``,
``mlp_residual_gemm_plain``; ``fused_mlp_plain`` is their composition) are
held here, at C = 300 and a token count that is not a multiple of the
kernels' 128-token tile, to ``_reference_mlp`` (exact erf, the same
rounding points), in float32 and bfloat16, and to the Pallas
``_mlp_cmajor_2d`` (interpret mode, jitted) in float32 -- its bfloat16
products do not run on the CPU (XLA's CPU dot takes no bf16 x bf16 ->
f32). The CUDA kernels themselves are held to the same plain versions on
the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_mlp import _mlp_cmajor_2d, _reference_mlp
from slak_tpu_torch.ops.mlp import (fused_mlp_plain, mlp_gelu_gemm_plain,
                                    mlp_ln_plain, mlp_residual_gemm_plain,
                                    pack_mlp)

C, SHAPE = 300, (1, 5, 41, 300)           # NHWC, T = 205 tokens
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# float32: sums of 300 and 1200 products in another order; bfloat16: h and
# g are rounded to bf16 at the same points, so the outputs differ where an
# fp32 sum in another order flips a rounding -- by about one bf16 ulp of
# the values (|out| < 4 here: 2^-6)
TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}


def _inputs(rng):
    f = 4 * C
    p = dict(
        y=rng.standard_normal(SHAPE, dtype=np.float32),
        res=rng.standard_normal(SHAPE, dtype=np.float32),
        ln_scale=1.0 + 0.1 * rng.standard_normal(C, dtype=np.float32),
        ln_bias=0.1 * rng.standard_normal(C, dtype=np.float32),
        w1=rng.standard_normal((C, f), dtype=np.float32) / np.sqrt(C),
        b1=0.1 * rng.standard_normal(f, dtype=np.float32),
        w2=rng.standard_normal((f, C), dtype=np.float32) / np.sqrt(f),
        b2=0.1 * rng.standard_normal(C, dtype=np.float32),
        gamma=0.5 + 0.1 * rng.standard_normal(C, dtype=np.float32),
        pre_bias=0.1 * rng.standard_normal(C, dtype=np.float32))
    return p


def _pack(p, tdt):
    return pack_mlp(*(torch.from_numpy(p[k]) for k in (
        "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "gamma",
        "pre_bias")), dtype=tdt)


def _jax(p, jdt):
    """The JAX composition's intermediates h and g (float32 arrays)."""
    y = jnp.asarray(p["y"]).astype(jdt).reshape(-1, C)
    yf = y.astype(jnp.float32) + p["pre_bias"]
    mu = jnp.mean(yf, -1, keepdims=True)
    var = jnp.mean(jnp.square(yf - mu), -1, keepdims=True)
    h = ((yf - mu) * jax.lax.rsqrt(var + 1e-6) * p["ln_scale"]
         + p["ln_bias"]).astype(jdt)
    a = jnp.dot(h, jnp.asarray(p["w1"]).astype(jdt),
                preferred_element_type=jnp.float32) + p["b1"]
    g = jax.nn.gelu(a, approximate=False).astype(jdt)
    return np.array(h.astype(jnp.float32)), np.array(g.astype(jnp.float32))


def _close(got, want, dn):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL[dn],
                               atol=TOL[dn])


@pytest.mark.parametrize("dn", DTYPES)
def test_mlp_split_launches_match_jax_intermediates(rng, dn):
    """Each launch's plain version: h (the LayerNorm launch) and g (the
    GELU GEMM) against the JAX composition's h and g, fed the same
    inputs; the residual GEMM from JAX's g against ``_reference_mlp``."""
    jdt, tdt = DTYPES[dn]
    p = _inputs(rng)
    pk = _pack(p, tdt)
    y = torch.from_numpy(p["y"]).to(tdt)
    res = torch.from_numpy(p["res"]).to(tdt)
    h_want, g_want = _jax(p, jdt)
    _close(mlp_ln_plain(y, pk, 3), h_want, dn)
    _close(mlp_gelu_gemm_plain(torch.from_numpy(h_want).to(tdt), pk),
           g_want, dn)
    want = _reference_mlp(*[jnp.asarray(p[k]).astype(jdt) if k in (
        "y", "res") else jnp.asarray(p[k]) for k in (
        "y", "res", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "gamma",
        "pre_bias")], True)
    got = mlp_residual_gemm_plain(torch.from_numpy(g_want).to(tdt), res, pk,
                                  y.shape, 3)
    _close(got, np.asarray(want.astype(jnp.float32)), dn)


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("dn", DTYPES)
def test_mlp_split_matches_reference_mlp(rng, dn, add_residual):
    """The composition (NHWC) against ``_reference_mlp``."""
    jdt, tdt = DTYPES[dn]
    p = _inputs(rng)
    args = [jnp.asarray(p[k]).astype(jdt) if k in ("y", "res")
            else jnp.asarray(p[k]) for k in (
                "y", "res", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2",
                "gamma", "pre_bias")]
    want = np.asarray(_reference_mlp(*args, add_residual).astype(
        jnp.float32))
    got = fused_mlp_plain(torch.from_numpy(p["y"]).to(tdt),
                          torch.from_numpy(p["res"]).to(tdt), _pack(p, tdt),
                          3, add_residual)
    _close(got, want, dn)


def test_mlp_split_matches_pallas_cmajor(rng):
    """The composition on the (C, M) operand against the Pallas
    ``_mlp_cmajor_2d`` (interpret mode, float32; its GELU uses the
    Abramowitz-Stegun erf, |err| <= 1.5e-7, so it holds to 1e-4 as in
    ``test_torch_ops.py``)."""
    jdt, tdt = DTYPES["float32"]
    p = _inputs(rng)
    ycm = np.ascontiguousarray(p["y"].reshape(-1, C).T)
    rcm = np.ascontiguousarray(p["res"].reshape(-1, C).T)
    fn = jax.jit(lambda a, b, *w: _mlp_cmajor_2d(a, b, *w, True, True))
    want = np.asarray(fn(jnp.asarray(ycm).astype(jdt),
                         jnp.asarray(rcm).astype(jdt),
                         *[jnp.asarray(p[k]) for k in (
                             "ln_scale", "ln_bias", "w1", "b1", "w2", "b2",
                             "gamma", "pre_bias")]).astype(jnp.float32))
    got = fused_mlp_plain(torch.from_numpy(ycm).to(tdt),
                          torch.from_numpy(rcm).to(tdt), _pack(p, tdt), 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
