"""ConvNeXt (``decom=False``, ``branch_bn=False``) in the port against
``slak_tpu`` on the CPU.

The registry's ``convnext_*`` models take one (K, K) ``lkb_origin``
branch without BN and no small branch (``_convnext_kw``: kernels
(7, 7, 7, 7, 100)); every other model-level test builds the decomposed
pair. A tiny one (depths (1,1,2,1), dims (8,16,24,32), 10 classes) with
jittered weights: the eval forward (K1 on 7x7 taps, whose plain version
runs here) within the logits' 2e-4, and one AdamW train step (the branch
through ``F.conv2d``) within 1e-4 against ``slak_tpu``'s on its plain
route (``conv_impl="xla", mlp_impl="xla"``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.models import slak as M
from slak_tpu.train import engine as je
from slak_tpu.train.optim import adamw_init
from slak_tpu.utils.convert import convert_state_dict
from slak_tpu_torch.models import apply
from slak_tpu_torch.models.slak import SLaK, SLaKConfig, config_for
from slak_tpu_torch.train import engine as te
from slak_tpu_torch.utils.convert import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32), num_classes=10,
            kernel_size=(7, 7, 7, 7, 100), decom=False, branch_bn=False)
HW = 64
TOL_LOGITS = 2e-4
RTOL = 1e-4
LR = np.array([2e-3, 1e-3], dtype=np.float32)
ATOL_PARAM = 0.01 * float(LR[0])     # as tests/test_torch_train.py


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    model = SLaK(SLaKConfig(**TINY)).reset_parameters(
        torch.Generator().manual_seed(4))
    params, state = convert_state_dict(model.state_dict())
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * np.abs(
            rng.standard_normal(np.shape(v)).astype(np.float32)), params)
    x = rng.standard_normal((4, HW, HW, 3)).astype(np.float32)
    y = np.array([0, 3, 6, 9], dtype=np.int32)
    return params, state, x, y


def test_registry_convnext_takes_the_origin_branch():
    cfg = config_for("convnext_tiny")
    assert (cfg.decom, cfg.branch_bn, cfg.kernel_size) == (
        False, False, (7, 7, 7, 7, 100))
    lk = SLaK(SLaKConfig(**TINY)).stages[0][0].large_kernel
    assert [n for n, _ in lk.named_children()] == ["lkb_origin"]
    assert not hasattr(lk.lkb_origin, "bn")


def test_convnext_eval_forward_matches_slak_tpu(weights):
    params, state, x, _ = weights
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", **TINY)
    want = jax.jit(lambda p, s, x: M.apply(p, s, x, cfg=cfg, train=False)[0])(
        params, state, jnp.asarray(x))
    model = SLaK(SLaKConfig(**TINY)).eval()
    model.load_state_dict(from_jax_params(params, state))
    got = apply(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL_LOGITS, atol=TOL_LOGITS)


def test_convnext_train_step_matches_slak_tpu(weights):
    params, state, x, y = weights
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", **TINY)
    train_kw = dict(weight_decay=0.05, smoothing=0.1)
    jstate = je.TrainState(params=params, model_state=state,
                           opt_state=adamw_init(params),
                           step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(je.make_train_step(
        M.SLaK(cfg), je.TrainConfig(pack_params=False, **train_kw), None,
        jnp.asarray(LR), None))
    jstate, jmet = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)),
                         jax.random.PRNGKey(0))

    model = SLaK(SLaKConfig(**TINY))
    model.load_state_dict(from_jax_params(params, state))
    tc = te.TrainConfig(**train_kw)
    st = te.create_train_state(model, tc)
    st, met = te.make_train_step(model, tc, None, LR)(
        st, (torch.from_numpy(x), torch.from_numpy(y).long()))

    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=RTOL)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                           state)
    got = model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        w = w.numpy()
        err = float(np.abs(got[name].numpy() - w).max())
        tol = RTOL * max(float(np.abs(w).max()), 1e-3) + ATOL_PARAM
        assert err <= tol, f"{name}: max err {err:.3g} > {tol:.3g}"
