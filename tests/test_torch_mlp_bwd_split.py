"""The fused MLP backward's launches (K8, K9) and the wide train route
against slak_tpu on the CPU.

``mlp_bwd.cu`` runs the tail's backward as a sequence of launches: the
LayerNorm prep, the GELU product (a = h W1^T, dg = do W2, g and da), dh =
da W1, the LayerNorm backward and the token-reduction products with
dgamma. Each has a plain version in ``ops/mlp.py``; their composition
(``fused_mlp_bwd_launches_plain``) is held here to K8's and K9's plain
versions (``fused_mlp_bwd_plain``, ``fused_mlp_bwd_wide_plain``) and to
the Pallas kernels ``_mlp_bwd_2d`` (C = 13) and ``_mlp_bwd_chunked_2d``
(C = 260, just above K8's 256) in interpret mode, all eight outputs.
Then one train-mode block at C = 272 through the port's route for the
wide tails, both values of ``TRAIN_WIDE_MLP_BWD``, against slak_tpu's
``_block_forward(train=True)``: the output and the gradients of the input
and of every block parameter. float32 throughout; the CUDA kernels are
held to the same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.models import slak as M
from slak_tpu.ops.pallas_mlp import _mlp_bwd_2d, _mlp_bwd_chunked_2d
from slak_tpu.utils.convert import convert_state_dict
from slak_tpu_torch.models import slak as S
from slak_tpu_torch.ops.mlp import (fused_mlp_bwd_launches_plain,
                                    fused_mlp_bwd_plain,
                                    fused_mlp_bwd_wide_plain, pack_mlp)
from slak_tpu_torch.utils.convert import from_jax_params

NAMES = ("dy", "dW1", "dW2", "db1", "db2", "dgamma", "dln_scale",
         "dln_bias")
# float32: the same products summed in another order (and K9's plain
# version sums dh over its 4C chunks); against the Pallas kernels also
# their GELU's Abramowitz-Stegun erf (|err| <= 1.5e-7)
TOL = 1e-4
# one block at a width above 256: stage 4 of this config
WIDE = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 272),
            kernel_size=(13, 11, 9, 7, 5), num_classes=10)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
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


def _pack(p):
    return pack_mlp(*(_t(p[k]) for k in ("ln_s", "ln_b", "w1", "b1", "w2",
                                         "b2", "gamma", "pre")))


@pytest.mark.parametrize("c, t", [(13, 96), (260, 40)])
def test_bwd_launches_compose_to_plain_kernels(c, t):
    """The launches' plain versions, composed, against K8's plain version
    (C = 13) or K9's (C = 260), tokens-major and NCHW: all eight outputs,
    dy in y's dtype (K8) or float32 (K9)."""
    rng = np.random.default_rng(c)
    pk = _pack(_params(rng, c))
    y = _t(rng.standard_normal((t, c)))
    dout = _t(0.3 * rng.standard_normal((t, c)))
    plain = fused_mlp_bwd_plain if c <= 256 else fused_mlp_bwd_wide_plain
    for yy, dd, cd in ((y, dout, -1),
                       (y.reshape(2, -1, 4, c).permute(0, 3, 1, 2)
                        .contiguous(),
                        dout.reshape(2, -1, 4, c).permute(0, 3, 1, 2)
                        .contiguous(), 1)):
        got = fused_mlp_bwd_launches_plain(yy, dd, pk, cd,
                                           torch.float32)
        want = plain(yy, dd, pk, cd)
        for name, g, w in zip(NAMES, got, want):
            assert g.shape == w.shape, name
            assert _rel(g.numpy(), w.numpy()) <= TOL, (name, cd)


@pytest.mark.parametrize("c, t", [(13, 96), (260, 40)])
def test_bwd_launches_match_pallas_kernels(c, t):
    """The composition against ``_mlp_bwd_2d`` (C = 13, K8's kernel) and
    ``_mlp_bwd_chunked_2d`` (C = 260, K9's; Fc = 512, two chunks) in
    interpret mode, jitted, on (T, C) tokens: all eight outputs."""
    rng = np.random.default_rng(c + 1)
    p = _params(rng, c)
    y = rng.standard_normal((t, c)).astype(np.float32)
    dout = (0.3 * rng.standard_normal((t, c))).astype(np.float32)
    kernel = _mlp_bwd_2d if c <= 256 else _mlp_bwd_chunked_2d
    want = jax.jit(kernel, static_argnums=(10,))(
        jnp.asarray(y), jnp.asarray(dout), p["ln_s"], p["ln_b"], p["w1"],
        p["b1"], p["w2"], p["b2"], p["gamma"], p["pre"], True)
    got = fused_mlp_bwd_launches_plain(_t(y), _t(dout), _pack(p))
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float32)
        if name in ("dW1", "dW2"):                # nn.Linear orientation
            w = w.T
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= TOL, (name, _rel(g.numpy(), w))


@pytest.fixture(scope="module")
def wide_block():
    """(JAX config, params, state, input NHWC, cotangent NHWC) of a small
    SLaK whose stage 4 is 272 wide; every leaf jittered so that gamma, BN
    and the biases all matter."""
    rng = np.random.default_rng(7)
    init = S.SLaK(S.SLaKConfig(**WIDE)).reset_parameters(
        torch.Generator().manual_seed(2))
    params, state = convert_state_dict(init.state_dict())

    def jitter(tree):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return jax.tree_util.tree_unflatten(treedef, [
            np.asarray(leaf) + 0.05 * np.abs(
                rng.standard_normal(leaf.shape).astype(np.float32))
            for leaf in leaves])
    params, state = jitter(params), jitter(state)
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", **WIDE)
    x = rng.standard_normal((2, 5, 5, WIDE["dims"][3])).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return cfg, params, state, x, cot


@pytest.mark.parametrize("routed", [True, False])
def test_wide_train_block_route_matches_jax(wide_block, monkeypatch,
                                            routed):
    """A train-mode block at C = 272 through the route ``TRAIN_WIDE_MLP_BWD``
    picks (True: ``FusedMlp``, K2 forward and K9 backward; False: the
    unfused composition under autograd) against slak_tpu's
    ``_block_forward(train=True)`` (its XLA composition): the output and
    the gradients of the input and of every block parameter."""
    cfg, params, state, x, cot = wide_block
    bp, bs = params["stages"][3][0], state["stages"][3][0]

    def loss(p, xx):
        out, _ = M._block_forward(xx, p, bs, train=True, dp_rate=0.0,
                                  rng=None, cfg=cfg)
        return jnp.sum(out * cot), out
    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(bp, jnp.asarray(x))

    monkeypatch.setattr(S, "TRAIN_WIDE_MLP_BWD", routed)
    model = S.SLaK(S.SLaKConfig(**WIDE))
    model.load_state_dict(from_jax_params(params, state))
    block = model.stages[3][0].train()
    tx = _t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = block(tx)
    assert (out.grad_fn.name() == "FusedMlpBackward") == routed
    (out * _t(cot).permute(0, 3, 1, 2)).sum().backward()
    assert _rel(out.detach().permute(0, 2, 3, 1).numpy(), want) <= TOL
    assert _rel(tx.grad.permute(0, 2, 3, 1).numpy(), gx) <= TOL
    full = jax.tree_util.tree_map(np.zeros_like, params)
    full["stages"][3][0] = gp
    grads = from_jax_params(full, state)
    named = dict(block.named_parameters())
    assert named
    for n, prm in named.items():
        w = grads["stages.3.0." + n].numpy()
        assert _rel(prm.grad.numpy(), w) <= TOL, n
