"""Knowledge distillation in the port (``slak_tpu_torch/kd/``) against
``slak_tpu.kd`` on the CPU.

  * every loss (NKD at two temperatures, KD soft and hard, SmoothL1, MSE,
    FD at 7 -> 14 and 14 -> 7, MGD fed the JAX function's own mask) against
    the JAX function: values within rel 1e-5, gradients (``jax.grad``
    against autograd) within 1e-5 of their scale; soft targets with exact
    ties (mixup at lambda 0.5) take the first index, as ``jnp.argmax``;
  * ``init_kd_params`` (the heads' shapes and init scale) and
    ``kd_params_from_jax``;
  * two KD steps each for NKD, FD+NKD, MGD and KD hard against
    ``slak_tpu.kd.make_kd_train_step`` on the teacher and student of
    ``tests/test_kd.py`` (``conv_impl="xla"``, drop path 0, EMA on, the
    JAX state packed as ``create_train_state`` packs it): the
    loss within rel 1e-4, the student's weights, EMA and the KD heads as
    ``tests/test_torch_convnext.py`` holds weights (1e-4 of scale + 1% of
    the lr);
  * one sparse KD step: the DST refresh moves the masks, every layer's
    live count within random growth's binomial bound (as ``chip_smoke.py``
    holds it), the pruned weights 0;
  * an MGD step with drop path 0.3 on 2 spawned gloo ranks (the global
    batch's draws) against the one-process step on the whole batch: loss,
    weights and heads within 1e-4, every tensor equal on both ranks;
  * the KD CLI through ``launch --kd`` on the CPU (2 steps at 32^2, eval,
    a checkpoint written).

The JAX references are jitted once: every loss case in one function, the
four distill types' steps in another (the teacher's output, the same for
both steps' images, computed once). The module fixture traces them and
compiles them in threads, beside the 2-rank spawn, while the port-only
tests run. JAX is imported inside the fixtures, so that the spawned
ranks, which import this module, do not load it.
"""

import copy
import os

import numpy as np
import pytest
import torch

from slak_tpu_torch.kd import engine as KE
from slak_tpu_torch.kd import losses as KL
from slak_tpu_torch.models.slak import SLaK, SLaKConfig
from slak_tpu_torch.sparsity.masking import MaskConfig
from slak_tpu_torch.train import engine as te
from slak_tpu_torch.train.launch import run_ranks
from slak_tpu_torch.utils.convert import from_jax_params
from slak_tpu_torch.utils.convert_teachers import kd_params_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TEACHER = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 40),
               kernel_size=(13, 11, 9, 7, 5), num_classes=10)
STUDENT = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32),
               kernel_size=(7, 7, 7, 7, 100), decom=False, branch_bn=False,
               num_classes=10)
HW = 32
LR = np.array([1e-3, 1e-3, 1e-3], dtype=np.float32)
RTOL = 1e-4
ATOL_PARAM = 0.01 * float(LR[0])     # as tests/test_torch_convnext.py
EMA = 0.99
STEP_TYPES = ("NKD", "FD+NKD", "MGD", "KD hard")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(True)


def _close(got, want, tol, what, atol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    bound = tol * max(float(np.abs(want).max()), 1e-3) + atol
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


def _flatten(tree, prefix=()):
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_name(path):
    """A JAX KD-head path -> the port's parameter name."""
    return ".".join(path[:-1]) + (".weight" if path[-1] == "w" else ".bias")


def _models(drop_path=0.0, seed=0):
    """The port's tiny teacher (BN running stats drawn) and student, and
    the student's weights jittered, from seeds."""
    teacher = SLaK(SLaKConfig(**TEACHER)).reset_parameters(
        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for n, b in teacher.named_buffers():
            if n.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif n.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    student = SLaK(SLaKConfig(drop_path_rate=drop_path, **STUDENT))
    student.reset_parameters(torch.Generator().manual_seed(seed + 2))
    with torch.no_grad():
        for p in student.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g).abs())
    return teacher, student


def _images(n=4):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n, HW, HW, 3)).astype(np.float32),
            rng.integers(0, 10, n))


def _kd_cfgs(dt):
    """(the port's KDConfig, the JAX one) of a STEP_TYPES entry."""
    from slak_tpu.kd import engine as JE
    hard = dt == "KD hard"
    dt = "KD" if hard else dt
    return KE.KDConfig(dt, hard=hard), JE.KDConfig(distill_type=dt, hard=hard)


def _jax_losses():
    """Every loss case's (value, gradients) from slak_tpu.kd.losses, the
    JAX MGD parameters, its masks and the JAX init_kd_params trees, all
    from one jitted function: ``([its lowering], finish)``, ``finish(
    compiled)`` the trees."""
    import jax
    import jax.numpy as jnp
    from slak_tpu.kd import engine as JE
    from slak_tpu.kd import losses as JL
    ls, lt, y, soft = _logits_data()
    key = jax.random.PRNGKey(1)

    def everything():
        out = {}
        for name in LOGIT_LOSSES:
            for tag, tg in (("int", y), ("soft", soft)):
                out[f"{name}/{tag}"] = jax.value_and_grad(
                    lambda a, b: _logit_loss(JL, name, a, b,
                                             jnp.asarray(tg)),
                    argnums=(0, 1))(jnp.asarray(ls), jnp.asarray(lt))
        out["labels"] = JL._label_of(jnp.asarray(soft))
        for sizes in FD_SIZES:
            fs, ft = _fd_data(sizes)
            for kind in FD_KINDS:
                out[f"fd/{sizes}/{kind}"] = jax.value_and_grad(
                    lambda a: JL.fd_loss(a, jnp.asarray(ft), kind))(
                    jnp.asarray(fs))
        for ch in MGD_CHANNELS:
            fs, ft = _mgd_data(ch)
            jp = JL.mgd_init(jax.random.PRNGKey(0), *ch)
            out[f"mgd/{ch}"] = (jp, jax.value_and_grad(
                lambda p, a: JL.mgd_loss(key, p, a, jnp.asarray(ft)),
                argnums=(0, 1))(jp, jnp.asarray(fs)),
                jax.random.uniform(key, (2, 1, 1, ch[1])))
        for dt in ("FD", "FD+NKD", "MGD", "NKD"):
            out[f"init/{dt}"] = JE.init_kd_params(
                jax.random.PRNGKey(2), JE.KDConfig(distill_type=dt), 32, 40)
        return out

    return [jax.jit(everything).lower()], lambda compiled: \
        jax.tree_util.tree_map(np.asarray, compiled())


def _jax_steps():
    """Two JAX KD steps for each of STEP_TYPES from the port's weights:
    ``([the lowerings of start and step_all], finish)``, ``finish(start,
    step_all)`` (compiled) giving (teacher, student, student BN state,
    {type: (kd params, [losses], student params, EMA params, kd params
    after)}). ``start`` computes the teacher's logits and feature (the
    same for both steps' images) and every type's initial carry;
    ``step_all`` steps every type, the teacher's output its argument."""
    import jax
    import jax.numpy as jnp
    from slak_tpu.kd import engine as JE
    from slak_tpu.models import slak as JM
    from slak_tpu.train import engine as je
    from slak_tpu.train import packing
    from slak_tpu.train.ema import ema_init
    from slak_tpu.train.optim import adamw_init
    from slak_tpu.utils.convert import convert_state_dict
    teacher, student = _models()
    tp, ts = convert_state_dict(teacher.state_dict())
    sp, ss = convert_state_dict(student.state_dict())
    jt = JM.SLaK(JM.SLaKConfig(conv_impl="xla", mlp_impl="xla", **TEACHER))
    js = JM.SLaK(JM.SLaKConfig(conv_impl="xla", mlp_impl="xla", **STUDENT))
    x, y = (jnp.asarray(a) for a in _images())
    jcfgs = [_kd_cfgs(dt)[1] for dt in STEP_TYPES]
    tc = je.TrainConfig(ema_decay=EMA)
    plan, ms_plan = packing.make_plan(sp), packing.make_plan(ss)

    def start(tp, ts, sp, ss):
        # create_train_state's packed state, from the port's weights
        p = packing.pack(sp, plan)
        carry = []
        for jcfg in jcfgs:
            kd0 = JE.init_kd_params(jax.random.PRNGKey(2), jcfg, 32, 40)
            carry.append((je.TrainState(
                params=p, model_state=ss, opt_state=adamw_init(p),
                step=jnp.zeros((), jnp.int32), ema_params=ema_init(p),
                ema_model_state=ema_init(packing.pack(ss, ms_plan)),
                plan=plan, ms_plan=ms_plan), kd0, JE.kd_opt_init(kd0)))
        return JE.make_teacher_apply(jt, tp, ts)(x), carry

    def step_all(carry, key, lt, ft):
        """Every type's step: (state, kd params, kd opt, loss, (weights,
        EMA weights) unpacked)."""
        outs = []
        for jcfg, (st, kd, opt) in zip(jcfgs, carry):
            st, kd, opt, m = JE.make_kd_train_step(
                js, lambda images: (lt, ft), jcfg, tc, None,
                jnp.asarray(LR), None)(st, kd, opt, (x, y), key)
            outs.append((st, kd, opt, m["loss"],
                         (st.tree_params(), st.tree_ema()[0])))
        return outs

    start_lo = jax.jit(start).lower(tp, ts, sp, ss)
    (lt, ft), carry = start_lo.out_info
    steps_lo = jax.jit(step_all).lower(carry, jax.random.PRNGKey(0), lt, ft)

    def finish(start_c, steps_c):
        (lt, ft), carry = start_c(tp, ts, sp, ss)
        kd0s = [c[1] for c in carry]
        losses = [[] for _ in STEP_TYPES]
        for i in range(2):
            outs = steps_c(carry, jax.random.PRNGKey(i), lt, ft)
            carry = [o[:3] for o in outs]
            for k, o in enumerate(outs):
                losses[k].append(float(o[3]))
        out = {}
        for k, dt in enumerate(STEP_TYPES):
            _, kd, _, _, (p, ema) = outs[k]
            out[dt] = jax.tree_util.tree_map(np.asarray, (
                kd0s[k], losses[k], p, ema, kd))
        return teacher, student, ss, out

    return [start_lo, steps_lo], finish


@pytest.fixture(autouse=True, scope="module")
def background():
    """Work that later tests read, started at the file's first test: the
    2-rank spawn (its ranks are processes) and the JAX references'
    compiles (XLA compiles with the GIL released) run in threads while
    the JAX references are traced here and the port-only tests run."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        refs = {"ranks": ex.submit(run_ranks, _dp_rank, 2, (), "gloo",
                                   "cpu", 120, 60)}
        for key, job in (("steps", _jax_steps), ("losses", _jax_losses)):
            lowered, finish = job()
            refs[key] = (finish, [ex.submit(lo.compile) for lo in lowered])
        yield refs


def _finish(ref):
    finish, compiled = ref
    return finish(*(c.result() for c in compiled))


@pytest.fixture(scope="module")
def jax_losses(background):
    return _finish(background["losses"])


@pytest.fixture(scope="module")
def jax_steps(background):
    return _finish(background["steps"])


# --- port-only tests (they run while the JAX references compile) -------------


def test_teacher_is_frozen_and_records_no_graph():
    apply = KE.make_teacher_apply(_models()[0])
    x, _ = _images(2)
    logits, feat = apply(torch.from_numpy(x))
    assert not logits.requires_grad and not feat.requires_grad
    assert feat.shape == (2, 1, 1, 40) and logits.dtype == torch.float32


def test_sparse_kd_step_refreshes_masks():
    teacher, student = _models()
    mc = MaskConfig(sparsity=0.4, sparse_init="uniform", growth_mode="random",
                    prune_rate=0.5, update_frequency=1)
    tc = te.TrainConfig(prune_t_max=10)
    state = te.create_train_state(student, tc, mc, seed=0)
    before = {n: m.clone() for n, m in state.mask_state.masks.items()}
    cfg = KE.KDConfig("NKD")
    kd = KE.init_kd_params(None, cfg, 32, 40)
    step = KE.make_kd_train_step(student, KE.make_teacher_apply(teacher),
                                 cfg, tc, mc, LR)
    x, y = _images()
    gen = torch.Generator().manual_seed(1)
    state.mask_state.generator = gen
    state, _, _, m = step(state, kd, None, (torch.from_numpy(x),
                                            torch.from_numpy(y)), gen)
    assert np.isfinite(float(m["loss"]))
    masks = state.mask_state.masks
    named = dict(student.named_parameters())
    assert any(not torch.equal(before[n], masks[n]) for n in masks)
    for n, mk in masks.items():
        # random growth regrows Binomial(zeros, regrowth / zeros)
        nb, na = float(before[n].sum()), float(mk.sum())
        assert abs(na - nb) <= 6 * max(nb, 1) ** 0.5 + 1, (n, nb, na)
        assert float((named[n].detach() * (1 - mk)).abs().max()) == 0.0


# --- data parallel and the CLI ------------------------------------------------


def _dp_steps(group=None, rank=0, world=1):
    """One MGD step with drop path 0.3 (the drop-path and mask draws the
    global batch's) on this rank's shard of a batch of 8: (loss, student
    weights, kd weights)."""
    x, y = _images(8)
    x = torch.from_numpy(x)
    y = torch.from_numpy(y)
    n = 8 // world
    x, y = x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]
    teacher, student = _models(drop_path=0.3)
    cfg = KE.KDConfig("MGD")
    kd = KE.init_kd_params(torch.Generator().manual_seed(5), cfg, 32, 40)
    tc = te.TrainConfig(ema_decay=EMA)
    state = te.create_train_state(student, tc)
    step = KE.make_kd_train_step(student, KE.make_teacher_apply(teacher),
                                 cfg, tc, None, LR, group=group)
    gen = torch.Generator().manual_seed(9)
    state, kd, _, m = step(state, kd, KE.kd_opt_init(kd), (x, y), gen)
    return (float(m["loss"]),
            {k: v.clone() for k, v in student.state_dict().items()},
            {k: v.clone() for k, v in kd.state_dict().items()})


def _dp_rank():
    from slak_tpu_torch.parallel import mesh
    group = mesh.axis_group()
    out = _dp_steps(group, mesh.rank(), mesh.world())
    for t in list(out[1].values()) + list(out[2].values()):
        t0 = t.clone()
        torch.distributed.broadcast(t0, 0)
        assert torch.equal(t0, t)
    return out


def test_two_rank_kd_step_matches_one_process(background):
    (l2, sd2, kd2), _ = background["ranks"].result()
    l1, sd1, kd1 = _dp_steps()
    assert l2 == pytest.approx(l1, rel=RTOL)
    for got, want in ((sd2, sd1), (kd2, kd1)):
        for name, w in want.items():
            if not name.endswith("num_batches_tracked"):
                _close(got[name], w.numpy(), RTOL, name, 1e-7)


def test_kd_cli_through_launch_on_the_cpu(tmp_path):
    from slak_tpu_torch.train import launch
    out = str(tmp_path / "kd")
    run = launch.main(["--kd", "--", "--device", "cpu", "--model",
                       "SLaK_debug", "--teacher_kernel_size", "13", "11",
                       "9", "7", "5", "--teacher_width_factor", "1.0",
                       "--model_s", "SLaK_debug", "--nb_classes", "10",
                       "--data_set", "synthetic", "--synthetic_len", "8",
                       "--input_size", "32", "--batch_size", "4",
                       "--epochs", "1", "--num_workers", "1",
                       "--warmup_epochs", "0", "--model_ema", "true",
                       "--use_bf16", "false", "--distill_type", "FD+NKD",
                       "--output_dir", out])
    assert len(run["step_losses"]) == 2
    assert all(np.isfinite(run["step_losses"]))
    assert run["epochs"][0]["test_images"] == 8
    assert os.listdir(out) and "checkpoint-0" in os.listdir(out)
    ck = torch.load(os.path.join(out, "checkpoint-0"), weights_only=False)
    assert ck["step"] == 2


# --- losses ------------------------------------------------------------------


def _logits_data():
    rng = np.random.default_rng(0)
    ls = rng.standard_normal((8, 20)).astype(np.float32) * 3
    lt = rng.standard_normal((8, 20)).astype(np.float32) * 3
    y = rng.integers(0, 20, 8)
    # mixup at lambda 0.5: two classes tie in every row but the last
    soft = np.zeros((8, 20), np.float32)
    soft[np.arange(8), y] += 0.5
    soft[np.arange(8), (y + 3) % 20] += 0.5
    soft[7] = 0.0
    soft[7, y[7]] = 1.0
    return ls, lt, y, soft


LOGIT_LOSSES = {
    "nkd": (dict(), "nkd_loss"),
    "nkd_t4": (dict(temp=4.0, alpha=0.5), "nkd_loss"),
    "kd": (dict(temp=2.0, hard=False, alpha=0.1), "kd_loss"),
    "kd_hard": (dict(temp=2.0, hard=True), "kd_loss"),
}
FD_SIZES = ((7, 7), (7, 14), (14, 7), (10, 7))
FD_KINDS = ("smoothL1", "MSE")
MGD_CHANNELS = ((16, 24), (24, 24))


def _logit_loss(mod, name, s, t, y):
    kw, fn = LOGIT_LOSSES[name]
    if fn == "nkd_loss":
        return mod.nkd_loss(s, t, y, **kw)
    return mod.kd_loss(s, y, t, **kw)


def _fd_data(sizes):
    hs, ht = sizes
    rng = np.random.default_rng(1)
    return (rng.standard_normal((2, hs, hs, 6)).astype(np.float32) * 3,
            rng.standard_normal((2, ht, ht, 6)).astype(np.float32) * 3)


def _mgd_data(channels):
    cs, ct = channels
    rng = np.random.default_rng(2)
    return (rng.standard_normal((2, 8, 8, cs)).astype(np.float32),
            rng.standard_normal((2, 4, 4, ct)).astype(np.float32))


def test_losses_match_slak_tpu(jax_losses):
    """NKD (T = 1 and 4), KD soft and hard, each with int and tied soft
    targets; FD in both kinds at 7 -> 7, 7 -> 14, 14 -> 7 and 10 -> 7."""
    ls, lt, y, soft = _logits_data()
    for name in LOGIT_LOSSES:
        for tag, tg in (("int", y), ("soft", soft)):
            want, (gs, gt) = jax_losses[f"{name}/{tag}"]
            s, t = _t(ls), _t(lt)
            got = _logit_loss(KL, name, s, t, torch.from_numpy(tg))
            got.backward()
            assert float(got.detach()) == pytest.approx(
                float(want), rel=1e-5), (name, tag)
            _close(s.grad, gs, 1e-5, f"{name} {tag} d/dlogit_s")
            # the hard variant's argmax passes no gradient (zeros under
            # jax.grad)
            _close(t.grad if t.grad is not None else torch.zeros_like(t),
                   gt, 1e-5, f"{name} {tag} d/dlogit_t")
    # mixup's exact ties take the first index, as jnp.argmax
    labels = KL._label_of(torch.from_numpy(soft)).numpy()
    np.testing.assert_array_equal(labels, jax_losses["labels"])
    np.testing.assert_array_equal(labels[:7],
                                  np.minimum(y, (y + 3) % 20)[:7])
    for sizes in FD_SIZES:
        fs, ft = _fd_data(sizes)
        for kind in FD_KINDS:
            want, g = jax_losses[f"fd/{sizes}/{kind}"]
            s = _t(fs)
            got = KL.fd_loss(s, torch.from_numpy(ft), kind)
            got.backward()
            assert float(got.detach()) == pytest.approx(
                float(want), rel=1e-5), (sizes, kind)
            _close(s.grad, g, 1e-5, f"fd {sizes} {kind} d/dfeat_s")


def test_mgd_loss_with_the_jax_mask(jax_losses):
    """MGD with and without the align conv, fed the JAX function's own
    mask; the port's mask draw: its rate, and a shard's rows of the global
    batch's draw."""
    for cs, ct in MGD_CHANNELS:
        fs, ft = _mgd_data((cs, ct))
        jp, (want, g), u = jax_losses[f"mgd/{(cs, ct)}"]
        mask = np.where(u < 0.5, 0.0, 1.0).reshape(2, ct).astype(np.float32)
        params = kd_params_from_jax(
            KE.init_kd_params(None, KE.KDConfig("MGD"), cs, ct),
            {"mgd": jp})["mgd"]
        assert ("align" in params) == (cs != ct)
        s = _t(fs)
        got = KL.mgd_loss_masked(params, s, torch.from_numpy(ft),
                                 torch.from_numpy(mask))
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        _close(s.grad, g[1], 1e-5, "d/dfeat_s")
        for name in jp:
            _close(params[name].weight.grad.permute(2, 3, 1, 0),
                   g[0][name]["w"], 1e-5, f"d/d{name}")
            _close(params[name].bias.grad, g[0][name]["b"], 1e-5,
                   f"d/d{name} bias")
    m = KL.mgd_mask(torch.Generator().manual_seed(0), 64, 128, 0.5)
    assert set(np.unique(m.numpy())) == {0.0, 1.0}
    assert abs(float(m.mean()) - 0.5) < 0.02
    from slak_tpu_torch.models.layers import global_batch_shard
    whole = KL.mgd_mask(torch.Generator().manual_seed(3), 8, 5, 0.5)
    with global_batch_shard(1, 2):
        half = KL.mgd_mask(torch.Generator().manual_seed(3), 4, 5, 0.5)
    assert torch.equal(half, whole[4:])


def test_init_kd_params_like_slak_tpu(jax_losses):
    for dt in ("FD", "FD+NKD", "MGD", "NKD"):
        cfg = KE.KDConfig(dt)
        jp = jax_losses[f"init/{dt}"]
        port = KE.init_kd_params(torch.Generator().manual_seed(2), cfg, 32,
                                 40)
        flat = _flatten(jp)
        assert sorted(n for n, _ in port.named_parameters()) == sorted(
            _port_name(k) for k in flat)
        back = kd_params_from_jax(port, jp).state_dict()
        for k, v in flat.items():
            t = back[_port_name(k)]
            if t.ndim == 4:
                t = t.permute(2, 3, 1, 0)
            np.testing.assert_array_equal(t.numpy(), v)
    w = KE.init_kd_params(torch.Generator().manual_seed(0),
                          KE.KDConfig("FD"), 256, 512)["fd_proj"].weight
    assert float(w.detach().std()) == pytest.approx((2.0 / 256) ** 0.5,
                                                    rel=0.05)
    assert not KE.init_kd_params(None, KE.KDConfig("FD"), 32, 32)


# --- the step against slak_tpu ------------------------------------------------


def test_two_kd_steps_match_slak_tpu(jax_steps, monkeypatch):
    """Two steps each of NKD, FD+NKD, MGD and KD hard from the same
    weights against the JAX step's: loss, student weights, EMA, heads."""
    teacher, student0, ss, out = jax_steps
    x, y = (torch.from_numpy(a) for a in _images())
    for dt in STEP_TYPES:
        kd0, want_losses, want_p, want_ema, want_kd = out[dt]
        cfg, _ = _kd_cfgs(dt)
        student = copy.deepcopy(student0)
        kd = kd_params_from_jax(KE.init_kd_params(None, cfg, 32, 40), kd0)
        tc = te.TrainConfig(ema_decay=EMA)
        state = te.create_train_state(student, tc)
        step = KE.make_kd_train_step(student, KE.make_teacher_apply(
            copy.deepcopy(teacher)), cfg, tc, None, LR)
        opt = KE.kd_opt_init(kd)
        with monkeypatch.context() as mp:
            if dt == "MGD":
                mp.setattr(KL, "mgd_mask", _jax_mgd_mask())
            for i in range(2):
                state, kd, opt, m = step(state, kd, opt, (x, y))
                assert float(m["loss"]) == pytest.approx(
                    want_losses[i], rel=RTOL), (dt, i)
        got = student.state_dict()
        for name, w in from_jax_params(want_p, ss).items():
            _close(got[name], w.numpy(), RTOL, f"{dt} {name}", ATOL_PARAM)
        for name, w in from_jax_params(want_ema).items():
            _close(state.ema[name], w.numpy(), RTOL, f"{dt} EMA {name}",
                   ATOL_PARAM)
        back = kd_params_from_jax(KE.init_kd_params(None, cfg, 32, 40),
                                  want_kd)
        for name, w in back.state_dict().items():
            _close(kd.state_dict()[name], w.numpy(), RTOL, f"{dt} {name}",
                   ATOL_PARAM)


def _jax_mgd_mask():
    """The JAX step's MGD draw, uniform(PRNGKey(step), (n, 1, 1, C)) <
    lambda, in place of the port's ``mgd_mask``."""
    import jax
    calls = []

    def mask(generator, n, c, lam, device=None):
        u = jax.random.uniform(jax.random.PRNGKey(len(calls)), (n, 1, 1, c))
        calls.append(None)
        return torch.from_numpy(np.where(np.asarray(u) < lam, 0.0, 1.0)
                                .reshape(n, c).astype(np.float32))
    return mask
