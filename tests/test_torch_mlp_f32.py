"""The fused MLP's float32 route (K2/K3 and K12 on the ERF path) against
slak_tpu on the CPU.

On the card the float32 tail runs its two products as 3xTF32 on the tensor
cores: the LayerNorm launch writes h as its big and small TF32 planes, the
first product's epilogue writes g = GELU(h W1 + b1) as g's planes, and the
second product feeds the residual epilogue. Those launches' plain versions
(``mlp_ln_f32_plain``, ``mlp_gelu_f32_plain``, ``mlp_out_f32_plain``;
``fused_mlp_f32_launches_plain`` is their composition) emulate the split
and the three TF32 products in float32, and are held here within 2e-5 of
scale (``test_torch_mlp_split.py``'s float32 tolerance) to the JAX
composition's intermediates, to ``_reference_mlp`` and to the Pallas
``_mlp_cmajor_2d`` and ``fused_mlp_cmajor_dual_raw`` (interpret mode,
jitted), at C = 13 and 300 with a token count that is not a multiple of
the kernels' 128-token tile, NHWC and NCHW. A numpy emulation of the
split at the forward's widest product (stage 4's g W2, K = 4032) shows it
as close as float32 where one TF32 pass is not. Last, the ERF CLI turns
TF32 off for its stock convolutions and products. The CUDA kernels are held
to the same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.ops.pallas_mlp import (_mlp_cmajor_2d, _reference_mlp,
                                     fused_mlp_cmajor_dual_raw)
from slak_tpu_torch.analysis import visualize_erf as V
from slak_tpu_torch.ops import mlp as K2

# float32: sums of C and 4C products in another order, the 3xTF32 split
# (as close as float32), and the Pallas GELU's A-S erf (|err| <= 1.5e-7)
TOL = 2e-5
KEYS = ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "gamma", "pre_bias")
SHAPES = {13: (2, 5, 21, 13), 300: (1, 5, 41, 300)}   # NHWC: 210, 205 tokens


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(c, seed, shape=None):
    """Seeded float32 activations y and res (NHWC, ``SHAPES[c]`` unless
    given) and the tail's parameters at width c."""
    rng = np.random.default_rng(seed)
    f = 4 * c
    r = rng.standard_normal
    shape = SHAPES[c] if shape is None else shape
    return dict(
        y=r(shape, dtype=np.float32), res=r(shape, dtype=np.float32),
        ln_scale=1.0 + 0.1 * r(c, dtype=np.float32),
        ln_bias=0.1 * r(c, dtype=np.float32),
        w1=r((c, f), dtype=np.float32) / np.sqrt(c),
        b1=0.1 * r(f, dtype=np.float32),
        w2=r((f, c), dtype=np.float32) / np.sqrt(f),
        b2=0.1 * r(c, dtype=np.float32),
        gamma=0.5 + 0.1 * r(c, dtype=np.float32),
        pre_bias=0.1 * r(c, dtype=np.float32))


def _pack(p):
    return K2.pack_mlp(*(_t(p[k]) for k in KEYS))


def _reference(p, add_residual=True):
    """``_reference_mlp`` on the NHWC inputs (float32, exact erf)."""
    return np.asarray(_reference_mlp(
        jnp.asarray(p["y"]), jnp.asarray(p["res"]),
        *(jnp.asarray(p[k]) for k in KEYS), add_residual))


def _jax_h_g(p):
    """The JAX composition's h and g, (T, C) and (T, 4C)."""
    c = p["y"].shape[-1]
    yf = jnp.asarray(p["y"]).reshape(-1, c) + p["pre_bias"]
    mu = jnp.mean(yf, -1, keepdims=True)
    var = jnp.mean(jnp.square(yf - mu), -1, keepdims=True)
    h = (yf - mu) * jax.lax.rsqrt(var + 1e-6) * p["ln_scale"] + p["ln_bias"]
    a = jnp.dot(h, p["w1"], precision=jax.lax.Precision.HIGHEST) + p["b1"]
    return np.asarray(h), np.asarray(jax.nn.gelu(a, approximate=False))


def _planes_value(planes, rows, cols):
    """big + small of a (2 R, K) pair of planes, cut to (rows, cols)."""
    big, small = planes.chunk(2)
    return (big.double() + small.double())[:rows, :cols].numpy()


def test_tf32_split_plain_is_the_kernels_split():
    """``tf32_split_plain``: big is x rounded to nearest TF32, ties away
    from zero, the low 13 bits clear in both planes, and big + small within
    2^-21 of |x| (the dropped bits of small)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((70, 33)).astype(np.float32) * \
        np.float32(2.0) ** rng.integers(-20, 20, (70, 33)).astype(np.float32)
    x[0, :4] = [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 0.0]
    planes = K2.tf32_split_plain(_t(x))
    assert planes.shape == (140, 33) and planes.dtype == torch.float32
    bits = planes.numpy().view(np.uint32)
    assert not (bits & 0x1FFF).any()
    big = planes[:70].numpy()
    # ties round away from zero; 1 + 3 * 2^-11 is a tie up to 1 + 2^-9
    np.testing.assert_array_equal(big[0, :4], [1 + 2 ** -10, -(1 + 2 ** -10),
                                               1 + 2 ** -9, 0.0])
    assert (np.abs(big - x) <= np.abs(x) * 2.0 ** -11).all()
    err = np.abs(_planes_value(planes, 70, 33) - x.astype(np.float64))
    assert (err <= np.abs(x) * 2.0 ** -21).all()


@pytest.mark.parametrize("c", [13, 300])
def test_f32_launches_match_jax_intermediates(c):
    """Each launch's plain version against the JAX composition, fed the
    same inputs: h's planes (the LayerNorm launch, zero on the padded
    tokens and channels) against h; g's planes (the GELU product) from
    JAX's h against g; the residual product from JAX's g against
    ``_reference_mlp``."""
    p = _inputs(c, c)
    pk = _pack(p)
    t = p["y"].size // c
    tp, (fp, cp) = -(-t // 128) * 128, pk.w1.shape
    h_want, g_want = _jax_h_g(p)

    hp = K2.mlp_ln_f32_plain(_t(p["y"]), pk, -1)
    assert hp.shape == (2 * tp, cp)
    assert not hp[:tp][t:].any() and not hp[:tp][:, c:].any()
    assert _rel(_planes_value(hp, t, c), h_want) <= TOL

    hw = torch.zeros(tp, cp)
    hw[:t, :c] = _t(h_want)
    gp = K2.mlp_gelu_f32_plain(K2.tf32_split_plain(hw), pk)
    assert gp.shape == (2 * tp, fp)
    assert _rel(_planes_value(gp, t, 4 * c), g_want) <= TOL

    gw = torch.zeros(tp, fp)
    gw[:t, :4 * c] = _t(g_want)
    out = K2.mlp_out_f32_plain(K2.tf32_split_plain(gw), _t(p["res"]), pk,
                               p["y"].shape, -1)
    assert out.shape == p["y"].shape and out.dtype == torch.float32
    assert _rel(out.numpy(), _reference(p)) <= TOL


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("c", [13, 300])
def test_f32_launches_match_reference_mlp(c, layout, add_residual):
    """The composition of the launches' plain versions against
    ``_reference_mlp``, NHWC and NCHW (through the strides, channels on
    axis 1), with and without the residual; and against the wrapper's CPU
    route (``fused_mlp_plain``)."""
    p = _inputs(c, 10 + c)
    pk = _pack(p)
    y, res, cd = _t(p["y"]), _t(p["res"]), -1
    if layout == "NCHW":
        y, res, cd = (y.permute(0, 3, 1, 2).contiguous(),
                      res.permute(0, 3, 1, 2).contiguous(), 1)
    got = K2.fused_mlp_f32_launches_plain(y, res if add_residual else None,
                                          pk, cd, add_residual)
    assert got.shape == y.shape
    want = _reference(p, add_residual)
    got_nhwc = got.movedim(cd, -1).numpy()
    assert _rel(got_nhwc, want) <= TOL, _rel(got_nhwc, want)
    plain = K2.fused_mlp(y, res, pk, cd, add_residual).movedim(cd, -1)
    assert _rel(got_nhwc, plain.numpy()) <= TOL


@pytest.mark.parametrize("c", [13, 300])
def test_f32_launches_match_pallas_cmajor(c):
    """The composition on the (C, M) operand (channel_dim 0) against the
    Pallas ``_mlp_cmajor_2d``, interpret mode, jitted."""
    p = _inputs(c, 20 + c)
    ycm = np.ascontiguousarray(p["y"].reshape(-1, c).T)
    rcm = np.ascontiguousarray(p["res"].reshape(-1, c).T)
    fn = jax.jit(lambda a, b, *w: _mlp_cmajor_2d(a, b, *w, True, True))
    want = np.asarray(fn(jnp.asarray(ycm), jnp.asarray(rcm),
                         *(jnp.asarray(p[k]) for k in KEYS)))
    got = K2.fused_mlp_f32_launches_plain(_t(ycm), _t(rcm), _pack(p), 0)
    assert _rel(got.numpy(), want) <= TOL, _rel(got.numpy(), want)


@pytest.mark.parametrize("emit_q", [True, False])
def test_f32_dual_launches_match_pallas_dual(emit_q):
    """K12's float32 route: the launches' plain versions on y1 + y2^T (the
    LayerNorm launch's sum; y2 in the q orientation) with the residual,
    and oq the same values in the q orientation, against
    ``fused_mlp_cmajor_dual_raw`` (interpret mode, jitted)."""
    n, c, h, w = 2, 24, 7, 9                  # 126 tokens
    p = _inputs(c, 5, (n, c, h, w))
    y1, res = p["y"], p["res"]
    y2 = np.random.default_rng(6).standard_normal((n, c, w, h),
                                                  dtype=np.float32)
    cm = (lambda a: jnp.asarray(np.transpose(a, (1, 2, 3, 0))))
    oh, oq = jax.jit(lambda *a: fused_mlp_cmajor_dual_raw(
        *a, emit_q=emit_q, interpret=True))(
        cm(y1), cm(y2), cm(res), *(jnp.asarray(p[k]) for k in KEYS))
    pk = _pack(p)
    got = K2.fused_mlp_f32_launches_plain(_t(y1) + _t(y2).transpose(2, 3),
                                          _t(res), pk, 1)
    want_h = np.transpose(np.asarray(oh), (3, 0, 1, 2))
    assert _rel(got.numpy(), want_h) <= TOL, _rel(got.numpy(), want_h)
    if emit_q:
        want_q = np.transpose(np.asarray(oq), (3, 0, 1, 2))
        got_q = got.transpose(2, 3).contiguous()
        assert _rel(got_q.numpy(), want_q) <= TOL
    else:
        assert oq is None


def _tf32(x):
    """x rounded to TF32, ties away from zero (cvt.rna.tf32.f32), the low
    13 bits cleared."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_split_at_the_forwards_widest_product():
    """The kernel's split at stage 4's o = g W2^T (1024 tokens, K = Fp =
    4032, N = Cp = 1008, SLaK-T w1.3 at the ERF's 1024^2), g a GELU's
    output: big = TF32(x), small = TF32(x - big), the three float32
    products against float64, within 2e-5 of max |o| (and no further than
    3x plain float32's error); one TF32 pass is more than 2e-5 off."""
    rng = np.random.default_rng(11)
    m, k, n = 1024, 4032, 1008
    g = torch.nn.functional.gelu(torch.from_numpy(
        rng.standard_normal((m, k), dtype=np.float32))).numpy()
    w = rng.standard_normal((k, n), dtype=np.float32) * k ** -0.5
    want = g.astype(np.float64) @ w.astype(np.float64)

    def split(x):
        big = _tf32(x)
        return big, _tf32(x - big)
    (gb, gs), (wb, ws) = split(g), split(w)
    three = gs @ wb + gb @ ws + gb @ wb
    fp32 = _rel(g @ w, want)
    err3 = _rel(three, want)
    one = _rel(gb @ wb, want)
    assert err3 <= TOL and err3 <= 3 * fp32, (err3, fp32)
    assert one > TOL, one


def test_erf_cli_turns_tf32_off(tmp_path, monkeypatch):
    """``visualize_erf.main`` sets cuDNN's and matmul's TF32 flags off (its
    fp32 stock convolutions and products then match the JAX package's
    full fp32), here with ``--device cpu`` on a small model."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    out = V.main(["--model", "SLaK_debug", "--kernel_size", "13", "11", "9",
                  "7", "5", "--input_size", "32", "--num_images", "1",
                  "--device", "cpu", "--save", str(tmp_path / "erf.npy")])
    assert out["used"] == 1
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
