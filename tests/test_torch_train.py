"""The port's sparse train step against ``slak_tpu``'s on the CPU.

A tiny SLaK (depths (1,1,2,1), dims (8,16,24,32), 10 classes, no
drop-path) with jittered params and BN state, masked at 60% density: two
steps of ``slak_tpu.train.engine.make_train_step`` on its plain route
(``conv_impl="xla", mlp_impl="xla"``, one ``jax.jit``) against two steps
of the port's ``make_train_step`` on ``device="cpu"`` from the same
weights (``from_jax_params``), masks (``masks_from_jax``) and batch:
AdamW with weight decay, label smoothing, EMA, and a DST refresh
(magnitude prune, momentum growth) after the second step. The stages 1-2
blocks run the port's fused-tail Function (K8's plain version) and every
large branch the stats-fused conv Function; stages 3-4 the plain MLP.

Two choices keep the comparison exact rather than tie-bound. The maps
(128^2 input: 32/16/8/4) and kernels (31, 31, 15, 7; small 5) are sized so
that every tap sees the map: a tap that reads only padding has an exactly
zero gradient and momentum, and growth then picks among equal scores by
index order, which differs between the JAX and torch layouts (FIDELITY
#4; tests/test_train.py notes the same drift at 32^2) -- and a just-pruned
weight regrown from such a tie keeps its value, so the weights would
differ too. And the refresh comes after the second step: after one Adam
step every momentum m/(sqrt(v)+eps) is (1-b1)/sqrt(1-b2) = 3.1623 to
within fp32 rounding, a plateau of ties again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.models import slak as M
from slak_tpu.sparsity import masking as jm
from slak_tpu.train import engine as je
from slak_tpu.train.ema import ema_init as jax_ema_init
from slak_tpu.train.optim import adamw_init
from slak_tpu.utils.convert import convert_state_dict
from slak_tpu_torch.models import create_model
from slak_tpu_torch.models.slak import SLaK, SLaKConfig
from slak_tpu_torch.sparsity.masking import MaskConfig
from slak_tpu_torch.train import engine as te
from slak_tpu_torch.utils.convert import from_jax_params, masks_from_jax

TINY = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32),
            kernel_size=(31, 31, 15, 7, 5), num_classes=10)
HW = 128
LR = np.array([2e-3, 1.5e-3, 1e-3], dtype=np.float32)
MASK_KW = dict(sparsity=0.4, sparse_init="snip", prune_mode="magnitude",
               growth_mode="momentum", prune_rate=0.5, update_frequency=2)
TRAIN_KW = dict(weight_decay=0.05, smoothing=0.1, ema_decay=0.9,
                prune_t_max=10)
N_STEPS = 2
RTOL = 1e-4     # fp32: the same math, sums in another order
# AdamW divides each gradient element by its own magnitude, so an element
# that is rounding noise in both packages moves its weight by up to lr in
# either; weights may differ by that much more: 1% of the first lr
ATOL_PARAM = 0.01 * float(LR[0])


@pytest.fixture(scope="module")
def runs():
    """Both packages' states after each of N_STEPS steps."""
    rng = np.random.default_rng(0)
    init = create_model("SLaK_debug", device="cpu", seed=3,
                        kernel_size=TINY["kernel_size"], num_classes=10)
    params, state = convert_state_dict(init.state_dict())

    def jitter(tree):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return jax.tree_util.tree_unflatten(treedef, [
            np.asarray(leaf) + 0.05 * np.abs(
                rng.standard_normal(leaf.shape).astype(np.float32))
            for leaf in leaves])

    params, state = jitter(params), jitter(state)
    masks = {n: (rng.random(w.shape) < 0.6).astype(np.float32)
             for n, w in jm.select_maskable(params).items()}
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.apply_mask_to_tree(params, masks))
    x = rng.standard_normal((4, HW, HW, 3)).astype(np.float32)
    y = np.array([1, 4, 7, 9], dtype=np.int32)

    # slak_tpu
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", **TINY)
    tcfg = je.TrainConfig(pack_params=False, **TRAIN_KW)
    mcfg = jm.MaskConfig(**MASK_KW)
    jstate = je.TrainState(
        params=params, model_state=state, opt_state=adamw_init(params),
        step=jnp.zeros((), jnp.int32),
        mask_state=jm.MaskState(
            masks={n: jnp.asarray(m) for n, m in masks.items()},
            fired={n: jnp.asarray(m) for n, m in masks.items()},
            steps=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0)),
        ema_params=jax_ema_init(params), ema_model_state=jax_ema_init(state))
    jstep = jax.jit(je.make_train_step(M.SLaK(cfg), tcfg, mcfg,
                                       jnp.asarray(LR), None))
    jax_out = []
    for _ in range(N_STEPS):
        jstate, met = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)),
                            jax.random.PRNGKey(1))
        jax_out.append((jax.tree_util.tree_map(np.asarray, jstate),
                        {k: float(v) for k, v in met.items()}))

    # the port
    model = SLaK(SLaKConfig(**TINY))
    model.load_state_dict(from_jax_params(params, state))
    mc = MaskConfig(**MASK_KW)
    tc = te.TrainConfig(**TRAIN_KW)
    st = te.create_train_state(model, tc, mc, masks=masks_from_jax(masks))
    step = te.make_train_step(model, tc, mc, LR)
    port_out = []
    for _ in range(N_STEPS):
        st, met = step(st, (torch.from_numpy(x), torch.from_numpy(y).long()))
        port_out.append((
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            {k: v.clone() for k, v in st.mask_state.masks.items()},
            {k: v.clone() for k, v in st.ema.items()},
            {k: float(v) for k, v in met.items()}))
    return jax_out, port_out, masks_from_jax(masks)


def _close(got, want, name, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    tol = RTOL * max(float(np.abs(want).max()), 1e-3) + atol
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max err {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("k", range(N_STEPS))
def test_train_step_metrics_match_slak_tpu(runs, k):
    (_, want), (_, _, _, got) = runs[0][k], runs[1][k]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    for key in ("lr", "weight_decay"):
        assert got[key] == pytest.approx(want[key], rel=1e-7)


@pytest.mark.parametrize("k", range(N_STEPS))
def test_train_step_params_and_bn_state_match_slak_tpu(runs, k):
    """Every parameter and BN running stat after the step, each to 1e-4 of
    its largest magnitude (+ ATOL_PARAM for the weights)."""
    (js, _), (sd, _, _, _) = runs[0][k], runs[1][k]
    want = from_jax_params(js.params, js.model_state)
    assert set(want) == set(sd)
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        _close(sd[name].numpy(), w.numpy(), name,
               0.0 if "running" in name else ATOL_PARAM)


@pytest.mark.parametrize("k", range(N_STEPS))
def test_train_step_masks_match_slak_tpu(runs, k):
    """Every mask (dense, conv and depthwise) equals JAX's exactly, and
    masked weights are exactly 0; the refresh after the last step changed
    every mask's positions, not its count."""
    (js, _), (sd, masks, _, _) = runs[0][k], runs[1][k]
    want = masks_from_jax(js.mask_state.masks)
    assert set(want) == set(masks)
    if k == N_STEPS - 1:
        for name, m0 in runs[2].items():
            assert not torch.equal(masks[name], m0), name
            assert float(masks[name].sum()) == float(m0.sum()), name
    for name, m in masks.items():
        np.testing.assert_array_equal(m.numpy(), want[name].numpy(),
                                      err_msg=name)
        assert float((sd[name] * (1 - m)).abs().max()) == 0.0, name


@pytest.mark.parametrize("k", range(N_STEPS))
def test_train_step_ema_matches_slak_tpu(runs, k):
    (js, _), (_, _, ema, _) = runs[0][k], runs[1][k]
    want = from_jax_params(js.ema_params, js.ema_model_state)
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        _close(ema[name].numpy(), w.numpy(), "ema " + name,
               0.0 if "running" in name else ATOL_PARAM)
