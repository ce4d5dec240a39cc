"""The port's dual eval route and probe kernels (K10-K13) against slak_tpu
on the CPU.

The same seeded numpy inputs (fp32, tiny shapes) go through the JAX
function and the port's counterpart; on CPU tensors the port's wrappers run
their plain PyTorch versions. Each Pallas kernel runs jitted in interpret
mode. K10: ``dwpair`` against ``dwpair_fused_cmajor`` in its four modes and
the raw pair; K12: ``fused_mlp_dual`` against ``fused_mlp_cmajor_dual_raw``;
K11: ``dwconv_stacked`` against ``dwconv_banded_stacked_cmajor``; K13:
``dwconv_probe`` against ``dwconv_banded_cmajor`` with the later tap columns
zeroed (``tools/probe_overhead.py``'s ``run_variant`` has no interpret
flag) and, with no tap, against the padded input's numpy slice. Then the
dual model (``eval_layout="dual"``) against JAX ``apply`` on its plain
route, and the routes the blocks take. The CUDA kernels are held against
the same plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.models import slak as M
from slak_tpu.ops.pallas_banded import (dwconv_banded_cmajor,
                                        dwconv_banded_stacked_cmajor,
                                        dwpair_fused_cmajor)
from slak_tpu.ops.pallas_mlp import fused_mlp_cmajor_dual_raw
from slak_tpu.utils.convert import convert_state_dict
from slak_tpu_torch.models import create_model
from slak_tpu_torch.models import slak as TS
from slak_tpu_torch.ops import depthwise, dwpair as K10, mlp as K2
from slak_tpu_torch.ops.dwconv import dwconv_probe
from slak_tpu_torch.ops.dwconv_stacked import dwconv_stacked
from slak_tpu_torch.utils.convert import from_jax_params

TOL_CONV = 1e-5     # fp32, the same products summed in another order
TOL_MLP = 1e-4      # and the Pallas GELU's A-S erf (|err| <= 1.5e-7)
TOL_MODEL = 2e-4    # fp32 logits through a model, as test_torch_model.py
TINY = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32),
            kernel_size=(31, 31, 31, 7, 5), num_classes=10)


# one jitted interpret-mode K1 for the K13 cases, a channel a grid step
# (the default packs 32 channels a step, zero-padded: a longer trace)
_banded = jax.jit(lambda a, b: dwconv_banded_cmajor(a, b, cb=1,
                                                    interpret=True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cmajor_to_nchw(a):
    """(C, H, W, N) -> (N, C, H, W)."""
    return np.transpose(np.asarray(a), (3, 0, 1, 2))


def _pair_inputs(rng):
    """x (N, C, H, W) with H != W, LoRA1 (K, s) and LoRA2 (s, K) taps in the
    JAX layout (kh, kw, C)."""
    n, c, h, w, K, s = 2, 3, 10, 8, 9, 5
    x = rng.standard_normal((n, c, h, w), dtype=np.float32)
    w1 = rng.standard_normal((K, s, c), dtype=np.float32) * 0.1
    w2 = rng.standard_normal((s, K, c), dtype=np.float32) * 0.1
    return x, w1, w2


def _taps(w_hwc):
    """(kh, kw, C) JAX taps -> the port's (C, kh, kw)."""
    return _t(np.transpose(w_hwc, (2, 0, 1)))


# --- K10: the one-pass pair ---------------------------------------------------

@pytest.mark.parametrize("tmode,sum_out", [
    ("kernel", True), ("input", True), ("dualout", True), ("dualboth", True),
    ("dualout", False), ("dualboth", False)])
def test_dwpair_matches_pallas_pair(rng, tmode, sum_out):
    """Each mode of ``dwpair`` (summed, or the raw pair y1 and y2 in the q
    orientation) vs ``dwpair_fused_cmajor`` (interpret), the dual-in modes
    fed the same xq. Tolerance 1e-5."""
    x, w1, w2 = _pair_inputs(rng)
    xc = jnp.asarray(np.transpose(x, (1, 2, 3, 0)))          # (C, H, W, N)
    xqc = jnp.transpose(xc, (0, 2, 1, 3))                    # (C, W, H, N)
    dual_in = K10.MODES[tmode][0]
    want = jax.jit(lambda a, b, c, q: dwpair_fused_cmajor(
        a, b, c, tmode=tmode, interpret=True, xq=q if dual_in else None,
        sum_out=sum_out))(xc, jnp.asarray(w1), jnp.asarray(w2), xqc)
    xt = _t(x)
    got = K10.dwpair(xt, _taps(w1), _taps(w2), tmode,
                     xq=xt.transpose(2, 3).contiguous() if dual_in else None,
                     sum_out=sum_out)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and got[1].shape == (2, 3, 8, 10)
        pairs = zip(got, want)
    else:
        assert torch.is_tensor(got)
        pairs = [(got, want)]
    for g, wnt in pairs:
        np.testing.assert_allclose(g.numpy(), _cmajor_to_nchw(wnt),
                                   rtol=TOL_CONV, atol=TOL_CONV)


# --- K12: the dual tail --------------------------------------------------------

@pytest.mark.parametrize("emit_q", [True, False])
def test_fused_mlp_dual_matches_pallas(rng, emit_q):
    """``fused_mlp_dual`` on (y1 NCHW, y2 in the q orientation) vs
    ``fused_mlp_cmajor_dual_raw`` (interpret): oh, and oq with ``emit_q``.
    Tolerance 1e-4 (the Pallas kernel's A-S erf)."""
    n, c, h, w = 2, 8, 6, 5
    f = 4 * c
    y1 = rng.standard_normal((n, c, h, w), dtype=np.float32)
    y2 = rng.standard_normal((n, c, w, h), dtype=np.float32)
    res = rng.standard_normal((n, c, h, w), dtype=np.float32)
    vec = [1.0 + 0.1 * rng.standard_normal(c, dtype=np.float32),
           0.1 * rng.standard_normal(c, dtype=np.float32)]
    w1 = rng.standard_normal((c, f), dtype=np.float32) / np.sqrt(c)
    b1 = 0.1 * rng.standard_normal(f, dtype=np.float32)
    w2 = rng.standard_normal((f, c), dtype=np.float32) / np.sqrt(f)
    b2, gamma, pre = (0.1 * rng.standard_normal(c, dtype=np.float32)
                      for _ in range(3))
    cm = (lambda a: jnp.asarray(np.transpose(a, (1, 2, 3, 0))))
    oh, oq = jax.jit(lambda *a: fused_mlp_cmajor_dual_raw(
        *a, emit_q=emit_q, interpret=True))(
        cm(y1), cm(y2), cm(res), *map(jnp.asarray, (*vec, w1, b1, w2, b2,
                                                    gamma, pre)))
    pk = K2.pack_mlp(*map(_t, (*vec, w1, b1, w2, b2, gamma, pre)))
    got_h, got_q = K2.fused_mlp_dual(_t(y1), _t(y2), _t(res), pk, emit_q)
    np.testing.assert_allclose(got_h.numpy(), _cmajor_to_nchw(oh),
                               rtol=TOL_MLP, atol=TOL_MLP)
    if emit_q:
        np.testing.assert_allclose(got_q.numpy(), _cmajor_to_nchw(oq),
                                   rtol=TOL_MLP, atol=TOL_MLP)
    else:
        assert got_q is None and oq is None


# --- K11 and K13: the probes' kernels ------------------------------------------

@pytest.mark.parametrize("h", [12, 40])
def test_dwconv_stacked_matches_pallas_stacked(rng, h):
    """``dwconv_stacked`` vs ``dwconv_banded_stacked_cmajor`` (interpret) on
    its W-padded C-major operand: g = 5 taps a chunk at H = 12, and 3 (two
    chunks, the second padded) at H = 40. Tolerance 1e-5."""
    n, c, w, K, s = 2, 3, 10, 13, 5
    x = rng.standard_normal((n, c, h, w), dtype=np.float32)
    wk = rng.standard_normal((K, s, c), dtype=np.float32) * 0.1
    xc = jnp.pad(jnp.asarray(np.transpose(x, (1, 2, 3, 0))),
                 ((0, 0), (0, 0), (s // 2, s // 2), (0, 0)))
    want = jax.jit(lambda a, b: dwconv_banded_stacked_cmajor(
        a, b, cb=1, interpret=True))(xc, jnp.asarray(wk))
    got = dwconv_stacked(_t(x), _taps(wk))
    np.testing.assert_allclose(got.numpy(), _cmajor_to_nchw(want),
                               rtol=TOL_CONV, atol=TOL_CONV)


@pytest.mark.parametrize("ntaps", [0, 1, 5])
def test_dwconv_probe_matches_banded_variant(rng, ntaps):
    """K13 with the first ``ntaps`` of 5 tap columns vs ``dwconv_banded_
    cmajor`` (interpret) with the later columns zeroed; with no tap, the
    copy of the W-padded input's first W columns (x shifted right by 2).
    Tolerance 1e-5."""
    n, c, h, w, K, s = 2, 3, 9, 11, 13, 5
    x = rng.standard_normal((n, c, h, w), dtype=np.float32)
    wk = rng.standard_normal((K, s, c), dtype=np.float32) * 0.1
    got = dwconv_probe(_t(x), _taps(wk), ntaps).numpy()
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (s // 2, s // 2)))
    if ntaps == 0:
        want = xp[..., 0:w]
    else:
        wz = wk.copy()
        wz[:, ntaps:] = 0.0
        xc = jnp.asarray(np.transpose(xp, (1, 2, 3, 0)))
        want = _cmajor_to_nchw(_banded(xc, jnp.asarray(wz)))
    np.testing.assert_allclose(got, want, rtol=TOL_CONV, atol=TOL_CONV)


# --- the dual model -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(cfg, params, state, images): jittered JAX trees of a TINY model
    (as tests/test_torch_model.py builds them)."""
    rng = np.random.default_rng(0)
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", **TINY)
    init = create_model("SLaK_debug", device="cpu", seed=2,
                        kernel_size=TINY["kernel_size"], num_classes=10)
    params, state = convert_state_dict(init.state_dict())

    def jitter(tree):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return jax.tree_util.tree_unflatten(treedef, [
            np.asarray(leaf) + 0.05 * np.abs(
                rng.standard_normal(leaf.shape).astype(np.float32))
            for leaf in leaves])

    params, state = jitter(params), jitter(state)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    return cfg, params, state, x


def _port(params, state, eval_layout="dual"):
    model = TS.SLaK(TS.SLaKConfig(eval_layout=eval_layout, **TINY)).eval()
    model.load_state_dict(from_jax_params(params, state))
    return model


def test_dual_model_matches_slak_tpu(tiny):
    """``eval_layout="dual"`` logits vs JAX ``apply`` on its plain route
    (tests/test_model.py holds JAX's own dual route to that route) with the
    same weights. Tolerance 2e-4."""
    cfg, params, state, x = tiny
    want = jax.jit(lambda p, s, a: M.apply(p, s, a, cfg=cfg, train=False)[0])(
        params, state, jnp.asarray(x))
    got = TS.apply(_port(params, state), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL_MODEL, atol=TOL_MODEL)


def _count(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(name)
        return fn(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_dual_blocks_run_k10_and_k12(tiny, monkeypatch):
    """On the CPU the dual stages call the K10 and K12 plain versions once a
    block and neither K1 (``conv_taps``) nor K2 (``fused_mlp``); the default
    layout, a graph being recorded and a merged model keep the K1 + K2
    route."""
    _, params, state, x = tiny
    pair = _count(monkeypatch, K10, "dwpair_plain")
    tail = _count(monkeypatch, K2, "fused_mlp_dual_plain")
    k1 = _count(monkeypatch, depthwise, "conv_taps")
    k2 = _count(monkeypatch, TS, "fused_mlp")
    n_blocks = sum(TINY["depths"])
    model = _port(params, state)
    xt = _t(np.transpose(x, (0, 3, 1, 2)))
    with torch.no_grad():
        model(xt)
    assert (len(pair), len(tail), len(k1), len(k2)) == (n_blocks, n_blocks,
                                                        0, 0)
    del pair[:], tail[:]
    model.cfg = dataclasses.replace(model.cfg, eval_layout="auto")
    with torch.no_grad():
        model(xt)
    assert (len(pair), len(tail), len(k1), len(k2)) == (0, 0, n_blocks,
                                                        n_blocks)
    model.cfg = dataclasses.replace(model.cfg, eval_layout="dual")
    feats = model.forward_features(xt.clone().requires_grad_())
    assert feats.requires_grad and (len(pair), len(tail)) == (0, 0)
    del k1[:], k2[:]
    with torch.no_grad():
        TS.merge_model(model)(xt)
    assert (len(pair), len(tail), len(k1)) == (0, 0, n_blocks)


@pytest.mark.parametrize("layout", ["auto", "cmajor", "nhwc"])
def test_eval_layouts_of_one_nchw_route(tiny, layout):
    """``auto``, ``cmajor`` and ``nhwc`` are the port's one NCHW route: the
    same logits as ``dual`` within 2e-4; an unknown layout is rejected."""
    _, params, state, x = tiny
    xt = _t(x)
    np.testing.assert_allclose(
        TS.apply(_port(params, state, layout), xt).numpy(),
        TS.apply(_port(params, state), xt).numpy(),
        rtol=TOL_MODEL, atol=TOL_MODEL)
    with pytest.raises(ValueError, match="eval_layout"):
        TS.SLaKConfig(eval_layout=layout + "x")


@pytest.mark.parametrize("impl", ["fused-kernel", "fused-input",
                                  "fused-dualout", "fused-dualboth"])
def test_pair_impl_fused_modes_match_split(rng, monkeypatch, impl):
    """``PAIR_IMPL`` sends a no-graph pair through K10 (summed) in its mode:
    the same sum as the split route's two K1 launches within 1e-5, one
    ``dwpair`` call and no ``conv_taps``; an unknown value raises."""
    x, w1, w2 = _pair_inputs(rng)
    xt, taps = _t(x), [_taps(w1), _taps(w2)]
    want = depthwise.run_taps(xt, taps)
    pair = _count(monkeypatch, depthwise, "dwpair")
    k1 = _count(monkeypatch, depthwise, "conv_taps")
    monkeypatch.setattr(depthwise, "PAIR_IMPL", impl)
    got = depthwise.run_taps(xt, taps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL_CONV,
                               atol=TOL_CONV)
    assert (len(pair), len(k1)) == (1, 0)
    monkeypatch.setattr(depthwise, "PAIR_IMPL", impl.replace("-", "_"))
    with pytest.raises(ValueError, match="PAIR_IMPL"):
        depthwise.run_taps(xt, taps)
