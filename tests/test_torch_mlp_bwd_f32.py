"""The fused MLP backward's dy-only mode and its float32 precision, on the
CPU.

The ERF takes the input gradient of the eval forward with every parameter
frozen, so ``FusedMlp`` asks K8/K9 for dy alone (``dy_only``): the kernels
then skip the token reductions, dgamma and the sums that only the
parameter gradients read. dy must have the same bits in both modes: here
the plain versions (``fused_mlp_bwd_plain`` at C = 13, K8's width, and
``fused_mlp_bwd_wide_plain`` at C = 300, K9's) are held to that, and to
``jax.vjp`` of slak_tpu's ``fused_mlp`` with respect to y alone (its custom
VJP runs ``_mlp_bwd_2d`` / ``_mlp_bwd_chunked_2d`` in interpret mode);
``FusedMlp`` with frozen parameters is held to take the mode.

On the card the float32 products run as 3xTF32 (each operand split into a
big and a small TF32 part, three TF32 products). A numpy emulation of that
split at a stage-4 product shape pins why ``chip_smoke.py`` holds the fp32
backward to 2e-5: the split is as close to float64 as float32 is, one TF32
pass is not. The token reductions (the weight gradients) follow their own
order on the card, 32-token k blocks into fresh partials and the token
splits summed in turn: ``mlp_bwd_wgrad_tf32_mirror`` repeats it, and is
held to ``mlp_bwd_wgrad_plain`` and to ``jax.vjp`` of ``fused_mlp`` with
respect to the weights.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops import pallas_mlp as PM
from slak_tpu_torch.ops import mlp as K2

# float32, dy against the JAX VJP: the same products in another order and
# the Pallas kernels' Abramowitz-Stegun erf (|err| <= 1.5e-7)
TOL = 2e-5
KEYS = ("ln_s", "ln_b", "w1", "b1", "w2", "b2", "gamma", "pre")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _params(rng, c):
    f = 4 * c
    r = rng.standard_normal
    return dict(ln_s=1 + 0.1 * r(c, dtype=np.float32),
                ln_b=0.1 * r(c, dtype=np.float32),
                w1=r((c, f), dtype=np.float32) * c ** -0.5,
                b1=0.1 * r(f, dtype=np.float32),
                w2=r((f, c), dtype=np.float32) * f ** -0.5,
                b2=0.1 * r(c, dtype=np.float32),
                gamma=0.5 + 0.1 * r(c, dtype=np.float32),
                pre=0.1 * r(c, dtype=np.float32))


def _case(c, seed):
    """(params, y, dout) NHWC (2, 3, 4, C) float32."""
    rng = np.random.default_rng(seed)
    p = _params(rng, c)
    y = rng.standard_normal((2, 3, 4, c), dtype=np.float32)
    dout = (0.3 * rng.standard_normal((2, 3, 4, c))).astype(np.float32)
    return p, y, dout


def _plain(c):
    return K2.fused_mlp_bwd_plain if c <= K2.BWD_C_MAX else \
        K2.fused_mlp_bwd_wide_plain


@pytest.mark.parametrize("c", [13, 300])
@pytest.mark.parametrize("channel_dim", [-1, 1])
def test_dy_only_gives_the_full_modes_dy_bits(c, channel_dim):
    """dy-only against the full mode of K8's (C = 13) and K9's (C = 300)
    plain versions, NHWC and NCHW: dy bit for bit, no parameter
    gradient."""
    p, y, dout = _case(c, c)
    pk = K2.pack_mlp(*(_t(p[k]) for k in KEYS))
    yy, dd = _t(y), _t(dout)
    if channel_dim == 1:
        yy, dd = (t.permute(0, 3, 1, 2).contiguous() for t in (yy, dd))
    full = _plain(c)(yy, dd, pk, channel_dim)
    only = _plain(c)(yy, dd, pk, channel_dim, dy_only=True)
    assert len(only) == len(full) == 8
    assert all(g is None for g in only[1:])
    assert all(g is not None for g in full[1:])
    assert only[0].dtype == full[0].dtype and torch.equal(only[0], full[0])


@pytest.mark.parametrize("c", [13, 300])
def test_dy_only_matches_jax_vjp_of_y(c):
    """dy-only against ``jax.vjp`` of slak_tpu's ``fused_mlp`` (interpret
    mode, jitted) with respect to y alone, the other inputs closed over:
    float32, within 2e-5 of max |dy|."""
    p, y, dout = _case(c, c + 1)
    res = np.zeros_like(y)
    w = [jnp.asarray(p[k]) for k in KEYS]

    def vjp_y(yy, cot):
        _, pull = jax.vjp(
            lambda v: PM.fused_mlp(v, jnp.asarray(res), *w, True, True), yy)
        return pull(cot)[0]
    want = jax.jit(vjp_y)(jnp.asarray(y), jnp.asarray(dout))
    pk = K2.pack_mlp(*(_t(p[k]) for k in KEYS))
    got = _plain(c)(_t(y), _t(dout), pk, -1, dy_only=True)[0]
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL, _rel(got.numpy(), want)


def test_frozen_parameters_take_the_dy_only_mode(monkeypatch):
    """``FusedMlp`` with no parameter needing a gradient asks the backward
    for dy alone and returns None for every parameter; with one parameter
    needing one it asks for the full mode. dy agrees with the full mode's
    bits either way."""
    c = 13
    p, y, dout = _case(c, 3)
    calls = []
    plain = K2.fused_mlp_bwd_plain

    def spy(*args, dy_only=False):
        calls.append(dy_only)
        return plain(*args, dy_only=dy_only)
    monkeypatch.setattr(K2, "fused_mlp_bwd_plain", spy)
    leaves = [_t(p[k]) for k in KEYS]
    y_nchw = _t(y).permute(0, 3, 1, 2).contiguous()
    d_nchw = _t(dout).permute(0, 3, 1, 2).contiguous()
    pk = K2.pack_mlp(*leaves)
    ctx = types.SimpleNamespace(saved_tensors=(y_nchw,), pk=pk,
                                add_residual=True, plain=True)
    grads = {}
    for frozen in (True, False):
        ctx.needs_input_grad = (True, True) + (not frozen,) + (False,) * 9
        grads[frozen] = K2.FusedMlp.backward(ctx, d_nchw)
        assert len(grads[frozen]) == 12
    assert calls == [True, False]
    frozen, full = grads[True], grads[False]
    assert all(g is None for g in frozen[2:9] + frozen[11:])
    assert full[2] is not None
    assert torch.equal(frozen[0], full[0])
    assert torch.equal(frozen[1], d_nchw)
    # through autograd: frozen leaves, the input's gradient only
    w1, b1, w2 = leaves[2], leaves[3], leaves[4]
    yg = y_nchw.clone().requires_grad_()
    out = K2.FusedMlp.apply(yg, torch.zeros_like(yg), leaves[0], leaves[1],
                            w1.t(), b1, w2.t(), leaves[5], leaves[6], True,
                            True, leaves[7])
    out.backward(d_nchw)
    assert calls[-1] is True
    assert torch.equal(yg.grad, frozen[0])


def _tf32(x):
    """x rounded to TF32, ties away from zero (cvt.rna.tf32.f32), the low
    13 bits cleared."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_split_is_as_close_as_float32():
    """The kernels' split at stage 4's a = h W1^T (1024 tokens, K = Cp =
    1008, N = Fp = 4032, SLaK-T w1.3): big = TF32(x), small = TF32(x -
    big), three float32 products big B + small x big + big x small against
    float64, within 2e-5 of max |a| (and no further than 3x plain
    float32's error); one TF32 pass is more than 2e-5 off."""
    rng = np.random.default_rng(8)
    m, k, n = 1024, 1008, 4032
    h = rng.standard_normal((m, k), dtype=np.float32)
    w = (rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5)
    want = h.astype(np.float64) @ w.astype(np.float64)

    def split(x):
        big = _tf32(x)
        small = _tf32(x - big)
        assert not (big.view(np.uint32) & 0x1FFF).any()
        assert not (small.view(np.uint32) & 0x1FFF).any()
        return big, small
    (hb, hs), (wb, ws) = split(h), split(w)
    three = hs @ wb + hb @ ws + hb @ wb
    fp32 = _rel(h @ w, want)
    err3 = _rel(three, want)
    one = _rel(hb @ wb, want)
    assert err3 <= TOL and err3 <= 3 * fp32, (err3, fp32)
    assert one > TOL, one


@pytest.mark.parametrize("c", [13, 300])
@pytest.mark.parametrize("against", ["plain", "jax"])
def test_tf32_token_reductions_mirror(c, against):
    """The float32 token reductions as the card orders them
    (``mlp_bwd_wgrad_tf32_mirror``: both operands split into TF32 parts,
    three products a 32-token k block into a fresh partial, token splits
    of 3 and 2 summed in order) on 150 tokens (padded to 256, the last
    split ragged), fed the plain launches' h, do, g and da: dW1, dW2 and
    dgamma within 2e-5 of scale of ``mlp_bwd_wgrad_plain`` (C = 13, K8's
    width; 300, K9's) or of ``jax.vjp`` of slak_tpu's ``fused_mlp``
    (interpret mode, jitted) with respect to W1, W2 and gamma."""
    rng = np.random.default_rng(c + 20)
    p = _params(rng, c)
    y = rng.standard_normal((2, 5, 15, c), dtype=np.float32)
    dout = (0.3 * rng.standard_normal(y.shape)).astype(np.float32)
    pk = K2.pack_mlp(*(_t(p[k]) for k in KEYS))
    yy, dd = _t(y), _t(dout)
    h, do, _, _, _, sum_dout = K2.mlp_bwd_prep_plain(yy, dd, pk)
    g, da, _ = K2.mlp_bwd_act_plain(h, do, pk)
    got = K2.mlp_bwd_wgrad_tf32_mirror(h, do, dd, g, da, sum_dout, pk,
                                        splits=(3, 2))
    if against == "plain":
        want = [w.numpy() for w in K2.mlp_bwd_wgrad_plain(
            h, do, dd, g, da, sum_dout, pk)]
    else:
        w = [jnp.asarray(p[k]) for k in KEYS]
        res = jnp.zeros(y.shape, jnp.float32)

        def vjp_w(w1, w2, gamma, cot):
            _, pull = jax.vjp(
                lambda a, b, gm: PM.fused_mlp(
                    jnp.asarray(y), res, w[0], w[1], a, w[3], b, w[5], gm,
                    w[7], True, True), w1, w2, gamma)
            return pull(cot)
        dw1, dw2, dgamma = jax.jit(vjp_w)(w[2], w[4], w[6],
                                          jnp.asarray(dout))
        # JAX's W1 (C, 4C) and W2 (4C, C): the port's nn.Linear transposes
        want = [np.asarray(dw1).T, np.asarray(dw2).T, np.asarray(dgamma)]
    for name, a, b in zip(("dW1", "dW2", "dgamma"), got, want):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert _rel(a.numpy(), b) <= TOL, (name, _rel(a.numpy(), b))
