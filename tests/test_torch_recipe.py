"""Remat, Adan and ``sparsity_report`` of the port against ``slak_tpu``.

A tiny SLaK (depths (1,1,1,1), dims (8,16,24,32), kernels (13,11,9,7,5),
10 classes) at 32^2 with jittered weights and BN state, masked at 60%:

  * the port's step with ``remat`` against its step without (drop path
    0.1, a DST refresh with random growth after the step, the same
    generators): the same loss, gradients, BN stats and masks within 1e-6
    of scale -- remat recomputes, it does not change the arithmetic;
  * two steps of the port's ``make_train_step`` with ``opt="adan"`` and
    ``remat=True`` against ``slak_tpu``'s (``remat=True``, plain route,
    no drop path, static masks): loss, every parameter and BN stat, and
    Adan's m, v, n and previous gradient through ``adan_state_to_jax``
    within 1e-4; the momentum that DST's growth reads from the Adan state
    is ``slak_tpu``'s ``adam_momentum`` of it; ``adan_state_from_jax`` puts
    ``slak_tpu``'s state into a fresh port optimizer and back unchanged;
  * ``sparsity_report`` on masks and ITOP's ``fired`` equal to
    ``slak_tpu``'s, exactly.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.models import slak as M
from slak_tpu.sparsity import masking as jm
from slak_tpu.train import engine as je
from slak_tpu.train.optim import adam_momentum as jax_adam_momentum
from slak_tpu.train.optim import adan_init
from slak_tpu.utils.convert import convert_state_dict
from slak_tpu_torch.models.slak import SLaK, SLaKConfig
from slak_tpu_torch.sparsity.masking import (MaskConfig, MaskState,
                                             sparsity_report)
from slak_tpu_torch.train import engine as te
from slak_tpu_torch.train.optim import adam_momentum
from slak_tpu_torch.utils.convert import (adan_state_from_jax,
                                          adan_state_to_jax, from_jax_params,
                                          masks_from_jax, port_name)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32),
            kernel_size=(13, 11, 9, 7, 5), num_classes=10)
HW = 32
LR = np.array([2e-3, 1.5e-3, 1e-3], dtype=np.float32)
TRAIN_KW = dict(weight_decay=0.05, smoothing=0.1, opt="adan", prune_t_max=10)
N_STEPS = 2
RTOL = 1e-4
ATOL_PARAM = 0.01 * float(LR[0])     # as tests/test_torch_train.py
TIGHT = 1e-6


ADAN_MASK_KW = dict(sparsity=0.4, sparse_init="snip", fix=True)


def _jax_adan(params, state, masks, x, y):
    """slak_tpu's remat Adan step compiled for these inputs: (compiled
    step, start state, batch)."""
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", remat=True, **TINY)
    jstate = je.TrainState(
        params=params, model_state=state,
        opt_state=jax.jit(adan_init)(params),    # one compile, not one a leaf
        step=jnp.zeros((), jnp.int32),
        mask_state=jm.MaskState(
            masks={n: jnp.asarray(m) for n, m in masks.items()},
            fired={n: jnp.asarray(m) for n, m in masks.items()},
            steps=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0)))
    jstep = jax.jit(je.make_train_step(
        M.SLaK(cfg), je.TrainConfig(pack_params=False, **TRAIN_KW),
        jm.MaskConfig(**ADAN_MASK_KW), jnp.asarray(LR), None))
    batch = (jnp.asarray(x), jnp.asarray(y))
    return (jstep.lower(jstate, batch, jax.random.PRNGKey(1)).compile(),
            jstate, batch)


@pytest.fixture(scope="module")
def init():
    """(params, state, masks, images, labels): jittered ``slak_tpu``
    trees from a port model, masks at 60% density, applied. slak_tpu's
    Adan step (``adan_runs``) starts compiling in the background here,
    beside the port-only tests that come first."""
    rng = np.random.default_rng(0)
    model = SLaK(SLaKConfig(**TINY)).reset_parameters(
        torch.Generator().manual_seed(3))
    params, state = convert_state_dict(model.state_dict())

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
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        _JAX_ADAN.append(pool.submit(_jax_adan, params, state, masks, x, y))
        yield params, state, masks, x, y
        _JAX_ADAN.clear()


_JAX_ADAN = []      # the future of _jax_adan, while init is alive


def _port_state(params, state, masks, remat, mask_kw, drop_path=0.0,
                **train_kw):
    model = SLaK(SLaKConfig(remat=remat, drop_path_rate=drop_path, **TINY))
    model.load_state_dict(from_jax_params(params, state))
    mc = MaskConfig(**mask_kw)
    tc = te.TrainConfig(**dict(TRAIN_KW, **train_kw))
    st = te.create_train_state(model, tc, mc, masks=masks_from_jax(masks))
    return model, st, te.make_train_step(model, tc, mc, LR)


def _close(got, want, name, rtol=RTOL, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    tol = rtol * max(float(np.abs(want).max()), 1e-3) + atol
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max err {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("opt", ["adamw", "adan"])
def test_remat_step_matches_the_step_without(init, opt):
    """One step with remat and one without, drop path 0.1 from one
    generator seed, a random-growth refresh after the step."""
    params, state, masks, x, y = init
    mask_kw = dict(sparsity=0.4, sparse_init="snip", prune_mode="magnitude",
                   growth_mode="random", prune_rate=0.5, update_frequency=1)
    out = []
    for remat in (False, True):
        model, st, step = _port_state(params, state, masks, remat, mask_kw,
                                      drop_path=0.1, opt=opt)
        st, met = step(st, (torch.from_numpy(x), torch.from_numpy(y).long()),
                       torch.Generator().manual_seed(5))
        out.append((float(met["loss"]),
                    {n: p.grad.clone() for n, p in model.named_parameters()},
                    {n: b.clone() for n, b in model.named_buffers()
                     if "running" in n},
                    {n: m.clone() for n, m in st.mask_state.masks.items()}))
    (l0, g0, b0, m0), (l1, g1, b1, m1) = out
    assert l1 == pytest.approx(l0, rel=TIGHT)
    for n in g0:
        _close(g1[n], g0[n], "grad " + n, TIGHT)
    for n in b0:
        _close(b1[n], b0[n], n, TIGHT)
    assert set(m0) == set(m1)
    for n in m0:
        assert torch.equal(m1[n], m0[n]), n
    assert any(not torch.equal(m0[n], masks_from_jax(masks)[n]) for n in m0)


@pytest.fixture(scope="module")
def adan_runs(init):
    """Both packages' states after each of N_STEPS remat Adan steps."""
    params, state, masks, x, y = init
    model, st, step = _port_state(params, state, masks, True, ADAN_MASK_KW)
    jstep, jstate, batch = _JAX_ADAN[0].result()
    named = dict(model.named_parameters())
    runs = []
    for _ in range(N_STEPS):
        jstate, jmet = jstep(jstate, batch, jax.random.PRNGKey(1))
        st, met = step(st, (torch.from_numpy(x), torch.from_numpy(y).long()))
        runs.append((jax.tree_util.tree_map(np.asarray, jstate),
                     float(jmet["loss"]), float(met["loss"]),
                     {k: v.clone() for k, v in model.state_dict().items()},
                     adan_state_to_jax(st.optimizer, named),
                     {n: v.clone()
                      for n, v in adam_momentum(st.optimizer, named).items()}))
    return runs, named


@pytest.mark.parametrize("k", range(N_STEPS))
def test_remat_adan_step_matches_slak_tpu(adan_runs, k):
    js, jloss, loss, sd, _, _ = adan_runs[0][k]
    assert loss == pytest.approx(jloss, rel=RTOL)
    want = from_jax_params(js.params, js.model_state)
    assert set(want) == set(sd)
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            _close(sd[name].numpy(), w.numpy(), name, atol=0.0
                   if "running" in name else ATOL_PARAM)


@pytest.mark.parametrize("k", range(N_STEPS))
def test_adan_state_and_momentum_match_slak_tpu(adan_runs, k):
    """m, v, n, the previous gradient and the count (port -> slak_tpu),
    and the DST momentum the port reads from its Adan state: slak_tpu's
    ``adam_momentum`` of the same state, for every parameter."""
    js, _, _, _, got, mom = adan_runs[0][k]
    assert int(got["count"]) == int(js.opt_state["count"]) == k + 1
    for key in ("m", "v", "n", "pre_grad"):
        flat_w = jax.tree_util.tree_leaves_with_path(js.opt_state[key])
        flat_g = jax.tree_util.tree_leaves(got[key])
        assert len(flat_w) == len(flat_g)
        for (path, w), g in zip(flat_w, flat_g):
            _close(g, w, f"{key} {jax.tree_util.keystr(path)}")
    # slak_tpu's reader on the same (converted) state gives the port's
    jmom = jax.jit(jax_adam_momentum)({"m": got["m"], "n": got["n"]})
    want = from_jax_params(jmom)
    assert set(mom) == set(want)
    for name, v in mom.items():
        _close(v.numpy(), want[name].numpy(), "momentum " + name, TIGHT)


def test_adan_state_from_slak_tpu_round_trips(adan_runs):
    """slak_tpu's Adan state after the last step -> a fresh port Adan ->
    back: every leaf the same bits, the count the same."""
    runs, named = adan_runs
    js = runs[-1][0]
    opt = te.create_train_state(
        SLaK(SLaKConfig(**TINY)), te.TrainConfig(opt="adan")).optimizer
    fresh = {n: p for g in opt.param_groups
             for n, p in zip(g["names"], g["params"])}
    assert set(fresh) == set(named)
    adan_state_from_jax(js.opt_state, fresh, opt)
    back = adan_state_to_jax(opt, fresh)
    assert int(back["count"]) == int(js.opt_state["count"])
    for key in ("m", "v", "n", "pre_grad"):
        for w, g in zip(jax.tree_util.tree_leaves(js.opt_state[key]),
                        jax.tree_util.tree_leaves(back[key])):
            np.testing.assert_array_equal(g, w)


def test_sparsity_report_matches_slak_tpu(init):
    """Per-layer density, overall density and fired ratio on masks and a
    ``fired`` union that differ, exactly."""
    _, _, masks, _, _ = init
    rng = np.random.default_rng(1)
    fired = {n: np.maximum(m, (rng.random(m.shape) < 0.3).astype(np.float32))
             for n, m in masks.items()}
    want = jm.sparsity_report(jm.MaskState(
        masks={n: jnp.asarray(m) for n, m in masks.items()},
        fired={n: jnp.asarray(f) for n, f in fired.items()},
        steps=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0)))
    got = sparsity_report(MaskState(
        masks=masks_from_jax(masks), fired=masks_from_jax(fired), steps=0,
        generator=torch.Generator()))
    assert got["density"] == want["density"]
    assert got["fired_ratio"] == want["fired_ratio"]
    assert got["layers"] == {port_name(n): d
                             for n, d in want["layers"].items()}
