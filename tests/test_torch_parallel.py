"""Data parallel with SyncBN and the launcher of the port
(``slak_tpu_torch.parallel``, ``train/launch.py``) on the CPU.

One group of 2 spawned gloo ranks (``run_ranks``, the module fixture
``ranks``) runs, each on its half of a global batch drawn from a seed:

  * SyncBN: ``batch_norm_train`` and ``batch_norm_from_sums`` forward and
    backward, against the one-process call on the concatenated batch and
    against ``slak_tpu.ops.batchnorm`` with ``axis_name`` under
    ``shard_map`` on 2 CPU devices: outputs, input and sum gradients,
    affine gradients (summed over the ranks) and running stats within
    1e-5;
  * SNIP over the group: the same saliency sparsities and masks on both
    ranks, and the one-process sparsities on the global batch;
  * two sparse steps of ``make_syncbn_train_step`` (a DST refresh after
    the second) on the tiny SLaK of ``test_torch_train.py`` (its sizes keep
    growth free of score ties), 2 ranks x 4 images: loss, every gradient,
    the BN stats within 1e-4 and the masks exactly against one process x
    8 images; loss, grad norm, weights, BN stats and masks against
    ``slak_tpu.parallel.syncbn.make_syncbn_train_step`` on a 2-device
    mesh; every tensor equal on both ranks;
  * the same with drop path 0.3 and random growth from the step's
    generator (the global batch's draws) against one process;
  * a checkpoint saved by both ranks: rank 0 writes, rank 1 returns after
    the file is whole.

The train CLI through ``launch --nproc 2`` (gloo, CPU, the recipe's mixup,
CutMix and erasing, ERK masks, a DST refresh, eval on 9 val images): its
per-step losses, final weights and eval within 1e-4 of the one-process CLI
fed the concatenation of the ranks' batches; rank 0's one checkpoint;
``launch --kd`` parses the distillation CLI's flags. Every rendezvous goes through a file, every
collective and join is bounded by 60 s.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from slak_tpu_torch.models.slak import SLaK, SLaKConfig
from slak_tpu_torch.ops.batchnorm import batch_norm_from_sums, batch_norm_train
from slak_tpu_torch.parallel import mesh
from slak_tpu_torch.parallel.syncbn import make_syncbn_train_step
from slak_tpu_torch.sparsity.masking import MaskConfig, snip_sparsities
from slak_tpu_torch.train import checkpoint as ckpt
from slak_tpu_torch.train import engine as te
from slak_tpu_torch.train.launch import run_ranks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIMEOUT = 60
BN_X = (8, 6, 5, 5)
TINY = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32),
            kernel_size=(31, 31, 15, 7, 5), num_classes=10)
HW = 128
LR = np.array([2e-3, 1.5e-3, 1e-3], dtype=np.float32)
MASK_KW = dict(sparsity=0.4, sparse_init="snip", prune_mode="magnitude",
               growth_mode="momentum", prune_rate=0.5, update_frequency=2)
TRAIN_KW = dict(weight_decay=0.05, smoothing=0.1, ema_decay=0.9,
                prune_t_max=10)
N_STEPS = 2
ATOL_PARAM = 0.01 * float(LR[0])      # as test_torch_train.py


def _close(got, want, tol, what, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = tol * max(float(np.abs(want).max()), 1e-3) + atol
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


def _np(t):
    return t.detach().clone().numpy()


# --- what each rank runs (the parent runs the same with group=None) -------

def _bn_run(x, g, a, group):
    """SyncBN's two entry points on x (this rank's rows), loss sum(y * g):
    [y, dx, dscale, dbias, running mean, running var] and, from the sums,
    [y, dx, ds1, ds2, dscale, dbias, running mean, running var]."""
    out = {}
    for kind in ("train", "sums"):
        xr = x.clone().requires_grad_()
        scale = torch.from_numpy(a["scale"]).clone().requires_grad_()
        bias = torch.from_numpy(a["bias"]).clone().requires_grad_()
        rm, rv = torch.from_numpy(a["rm"]).clone(), \
            torch.from_numpy(a["rv"]).clone()
        if kind == "train":
            y = batch_norm_train(xr, scale, bias, rm, rv, group=group)
            sums = []
        else:
            sums = [x.sum((0, 2, 3)).requires_grad_(),
                    x.square().sum((0, 2, 3)).requires_grad_()]
            y = batch_norm_from_sums(xr, *sums, x.shape[0] * 25, scale, bias,
                                     rm, rv, group=group)
        (y * g).sum().backward()
        out[kind] = [_np(y), _np(xr.grad)] + [_np(s.grad) for s in sums] \
            + [_np(scale.grad), _np(bias.grad), _np(rm), _np(rv)]
    return out


def _snip_model():
    return SLaK(SLaKConfig(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32),
                           kernel_size=(13, 11, 9, 7, 5), num_classes=10)
                ).reset_parameters(torch.Generator().manual_seed(4))


def _snip_run(a, group):
    """SNIP's sparsities and masks at 40% on this rank's share of a."""
    from slak_tpu_torch.train import losses as L
    model = _snip_model()
    x = mesh.shard_batch(torch.from_numpy(a["x"])) if group is not None \
        else torch.from_numpy(a["x"])
    y = mesh.shard_batch(torch.from_numpy(a["y"])) if group is not None \
        else torch.from_numpy(a["y"])

    def loss():
        model.eval()
        return L.cross_entropy(model._logits(x.permute(0, 3, 1, 2),
                                             False, None), y)
    maskable = {n: p for n, p in model.named_parameters() if p.ndim >= 2}
    sp = snip_sparsities(loss, maskable, 0.6, group)
    st = te.create_train_state(model, te.TrainConfig(),
                               MaskConfig(sparsity=0.4), loss, seed=3,
                               group=group)
    return sp, {n: _np(m) for n, m in st.mask_state.masks.items()}


def _step_run(a, group, draws=False):
    """N_STEPS sparse steps from a's weights and masks on this rank's
    share of a's batch; per step the metrics, every gradient, the state
    dict, the masks (and the EMA)."""
    kw = dict(TINY, drop_path_rate=0.3 if draws else 0.0)
    if group is not None:
        kw["bn_axis_name"] = mesh.DATA_AXIS
    model = SLaK(SLaKConfig(**kw))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in a["sd"].items()})
    mc = MaskConfig(**dict(MASK_KW, growth_mode="random") if draws
                    else MASK_KW)
    tc = te.TrainConfig(**TRAIN_KW)
    st = te.create_train_state(model, tc, mc, masks={
        n: torch.from_numpy(m) for n, m in a["masks"].items()})
    step = make_syncbn_train_step(model, tc, mc, LR) if group is not None \
        else te.make_train_step(model, tc, mc, LR)
    batch = (torch.from_numpy(a["x"]), torch.from_numpy(a["y"]).long())
    if group is not None:
        batch = mesh.shard_batch(batch)
    out = []
    for k in range(N_STEPS):
        gen = torch.Generator().manual_seed(50 + k) if draws else None
        if draws:
            st.mask_state.generator = gen
        st, met = step(st, batch, gen)
        out.append({
            "metrics": {m: float(v) for m, v in met.items()},
            "grads": {n: _np(p.grad) for n, p in model.named_parameters()},
            "sd": {n: _np(v) for n, v in model.state_dict().items()},
            "masks": {n: _np(m) for n, m in st.mask_state.masks.items()},
            "ema": {n: _np(v) for n, v in st.ema.items()}})
    return out


def _ckpt_run(out_dir):
    from slak_tpu_torch.models import create_model
    model = create_model("SLaK_debug", device="cpu",
                         kernel_size=(13, 11, 9, 7, 5), num_classes=10)
    state = te.create_train_state(model, te.TrainConfig())
    state.step = 100 + mesh.rank()
    path = ckpt.save_checkpoint(out_dir, state, 0)
    # no barrier here: save_checkpoint returned only once the file is whole
    saved = torch.load(os.path.join(out_dir, "checkpoint-0"),
                       weights_only=False)
    return path, saved["step"], sorted(os.listdir(out_dir))


def _ranks_worker(a):
    group = mesh.axis_group()
    x = torch.from_numpy(a["bn"]["x"])
    g = torch.from_numpy(a["bn"]["g"])
    return {"bn": _bn_run(mesh.shard_batch(x), mesh.shard_batch(g), a["bn"],
                          group),
            "snip": _snip_run(a["snip"], group),
            "dp": _step_run(a["dp"], group),
            "draws": _step_run(a["dp"], group, draws=True),
            "ckpt": _ckpt_run(a["ckpt"])}


# --- fixtures -----------------------------------------------------------------

def _inputs(tmp_dir):
    import jax
    from slak_tpu.sparsity import masking as jm
    from slak_tpu.utils.convert import convert_state_dict
    from slak_tpu_torch.models import create_model
    from slak_tpu_torch.utils.convert import from_jax_params, masks_from_jax
    rng = np.random.default_rng(0)
    c = BN_X[1]
    bn = {"x": (rng.standard_normal(BN_X) * 2 + 0.5).astype(np.float32),
          "g": rng.standard_normal(BN_X).astype(np.float32),
          "scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
          "rm": (0.1 * rng.standard_normal(c)).astype(np.float32),
          "rv": (1 + 0.1 * rng.random(c)).astype(np.float32)}
    snip = {"x": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
            "y": rng.integers(0, 10, 8)}
    # the tiny SLaK's jittered weights and 60%-dense masks, as
    # test_torch_train.py makes them (in JAX's tree, then the port's names)
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
    dp = {"sd": {k: v.numpy() for k, v in
                 from_jax_params(params, state).items()},
          "masks": {k: v.numpy() for k, v in masks_from_jax(masks).items()},
          "x": rng.standard_normal((8, HW, HW, 3)).astype(np.float32),
          "y": np.array([1, 4, 7, 9, 0, 2, 5, 8], dtype=np.int64)}
    return {"bn": bn, "snip": snip, "dp": dp, "ckpt": str(tmp_dir)}, \
        (params, state, masks)


def _jax_bn(a):
    """slak_tpu's SyncBN under shard_map on 2 CPU devices: per entry point
    the lists of _bn_run, the affine gradients per device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from slak_tpu.ops import batchnorm as jbn
    from slak_tpu.parallel import make_mesh
    mesh2 = make_mesh(2)
    rm, rv = jnp.asarray(a["rm"]), jnp.asarray(a["rv"])
    x, g = jnp.asarray(a["x"]), jnp.asarray(a["g"])
    two = lambda v: jnp.stack([jnp.asarray(v)] * 2)     # noqa: E731
    sh = lambda f, n: jax.shard_map(                   # noqa: E731
        f, mesh=mesh2, in_specs=(P("data"),) * n,
        out_specs=(P("data"),) * 3, check_vma=False)

    def f_train(xs, sc, bi):
        y, m, v = jbn.batch_norm(xs, sc[0], bi[0], rm, rv, train=True,
                                 axis_name="data", caxis=1)
        return y, m[None], v[None]

    def f_sums(xs, s1, s2, sc, bi):
        y, m, v = jbn.batch_norm_from_sums(
            xs, s1[0], s2[0], xs.shape[0] * 25, sc[0], bi[0], rm, rv,
            axis_name="data", caxis=1)
        return y, m[None], v[None]

    out = {}
    s1 = jnp.stack([x[:4].sum((0, 2, 3)), x[4:].sum((0, 2, 3))])
    s2 = jnp.stack([jnp.square(x[:4]).sum((0, 2, 3)),
                    jnp.square(x[4:]).sum((0, 2, 3))])
    for kind, fn, args in (("train", sh(f_train, 3), (x, two(a["scale"]),
                                                       two(a["bias"]))),
                           ("sums", sh(f_sums, 5), (x, s1, s2,
                                                    two(a["scale"]),
                                                    two(a["bias"])))):
        def loss(*args):
            y, m, v = fn(*args)
            return jnp.sum(y * g), (y, m, v)
        (_, (y, m, v)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
        out[kind] = [np.asarray(y)] + [np.asarray(d) for d in grads] + [
            np.asarray(m[0]), np.asarray(v[0])]
    return out


def _jax_steps(params, state, masks, x, y):
    """slak_tpu's make_syncbn_train_step on a 2-device mesh, N_STEPS steps:
    per step (state, metrics) as numpy."""
    import jax
    import jax.numpy as jnp
    from slak_tpu.models import slak as M
    from slak_tpu.parallel import make_mesh, replicate, shard_batch
    from slak_tpu.parallel.syncbn import make_syncbn_train_step as jstep_fn
    from slak_tpu.sparsity import masking as jm
    from slak_tpu.train import engine as je
    from slak_tpu.train.ema import ema_init
    from slak_tpu.train.optim import adamw_init
    mesh2 = make_mesh(2)
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", bn_axis_name="data",
                       **TINY)
    tcfg = je.TrainConfig(pack_params=False, **TRAIN_KW)
    jstate = je.TrainState(
        params=params, model_state=state, opt_state=adamw_init(params),
        step=jnp.zeros((), jnp.int32),
        mask_state=jm.MaskState(
            masks={n: jnp.asarray(m) for n, m in masks.items()},
            fired={n: jnp.asarray(m) for n, m in masks.items()},
            steps=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0)),
        ema_params=ema_init(params), ema_model_state=ema_init(state))
    step = jstep_fn(M.SLaK(cfg), tcfg, jm.MaskConfig(**MASK_KW),
                    jnp.asarray(LR), None, mesh2)
    jstate = replicate(jstate, mesh2)
    batch = shard_batch((jnp.asarray(x), jnp.asarray(y, jnp.int32)), mesh2)
    out = []
    for _ in range(N_STEPS):
        jstate, met = step(jstate, batch, jax.random.PRNGKey(1))
        out.append((jax.tree_util.tree_map(np.asarray, jstate),
                    {k: float(v) for k, v in met.items()}))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, the ranks' results, the one-process results, slak_tpu's,
    the CLI runs): the rank group and the launched CLI run while this
    process runs slak_tpu's side and the one-process runs."""
    from slak_tpu_torch.train import launch
    a, (params, state, masks) = _inputs(tmp_path_factory.mktemp("ckpt"))
    d2 = str(tmp_path_factory.mktemp("cli2"))
    d1 = str(tmp_path_factory.mktemp("cli1"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fut = pool.submit(run_ranks, _ranks_worker, 2, (a,), "gloo", "cpu",
                          TIMEOUT, TIMEOUT)
        fut_cli = pool.submit(
            launch.main, ["--nproc", "2", "--timeout", str(TIMEOUT), "--"]
            + CLI + ["--batch_size", str(RANK_BATCH), "--dist_backend",
                     "gloo", "--output_dir", d2])
        ref = {"bn": _jax_bn(a["bn"]),
               "dp": _jax_steps(params, state, masks, a["dp"]["x"],
                                a["dp"]["y"])}
        one = {"bn": _bn_run(torch.from_numpy(a["bn"]["x"]),
                             torch.from_numpy(a["bn"]["g"]), a["bn"], None),
               "snip": _snip_run(a["snip"], None),
               "dp": _step_run(a["dp"], None),
               "draws": _step_run(a["dp"], None, draws=True)}
        one_cli = _cli_one_process(d1)
        got = fut.result()
        cli = (fut_cli.result(), one_cli, d2, d1)
    return a, got, one, ref, cli


# --- SyncBN -----------------------------------------------------------------

BN_NAMES = {"train": ("y", "dx", "dscale", "dbias", "mean", "var"),
            "sums": ("y", "dx", "ds1", "ds2", "dscale", "dbias", "mean",
                     "var")}


def _bn_ranks(got, kind):
    """The ranks' SyncBN results as one process would hold them: y and dx
    concatenated, the affine gradients summed, the rest (equal on both
    ranks) rank 0's."""
    r0, r1 = got[0]["bn"][kind], got[1]["bn"][kind]
    out = {}
    for i, name in enumerate(BN_NAMES[kind]):
        if name in ("y", "dx"):
            out[name] = np.concatenate([r0[i], r1[i]])
        elif name in ("dscale", "dbias"):
            out[name] = r0[i] + r1[i]
        else:
            np.testing.assert_array_equal(r0[i], r1[i], err_msg=name)
            out[name] = r0[i]
    return out


@pytest.mark.parametrize("kind", ["train", "sums"])
def test_syncbn_matches_one_process(ranks, kind):
    _, got, one, _, _ = ranks
    ours = _bn_ranks(got, kind)
    for name, want in zip(BN_NAMES[kind], one["bn"][kind]):
        _close(ours[name], want, 1e-5, f"{kind} {name}")


@pytest.mark.parametrize("kind", ["train", "sums"])
def test_syncbn_matches_slak_tpu_shard_map(ranks, kind):
    """slak_tpu's per-device affine and sum gradients: the affines summed
    over the devices, the sums' per device (each rank's own)."""
    _, got, _, ref, _ = ranks
    ours = _bn_ranks(got, kind)
    want = dict(zip(("y", "dx") + (("ds1", "ds2") if kind == "sums" else ())
                    + ("dscale", "dbias", "mean", "var"), ref["bn"][kind]))
    for name in BN_NAMES[kind]:
        w = want[name]
        if name in ("dscale", "dbias"):
            w = w.sum(0)
        if name in ("ds1", "ds2"):
            for r in (0, 1):
                i = BN_NAMES[kind].index(name)
                _close(got[r]["bn"][kind][i], w[r], 1e-5, f"{name} rank {r}")
            continue
        _close(ours[name], w, 1e-5, f"{kind} {name}")


# --- SNIP, the data-parallel step, the checkpoint ---------------------------

def test_snip_over_the_group(ranks):
    """Both ranks score the same sparsities and draw the same masks; the
    sparsities are the one-process ones on the global batch to within one
    weight of a layer."""
    _, got, one, _, _ = ranks
    (sp0, m0), (sp1, m1) = got[0]["snip"], got[1]["snip"]
    assert sp0 == sp1
    for n in m0:
        np.testing.assert_array_equal(m0[n], m1[n], err_msg=n)
    sizes = {n: m.size for n, m in m0.items()}
    for n, s in one["snip"][0].items():
        assert abs(sp0[n] - s) <= 1.0 / sizes.get(n, 1) + 1e-12, n


def _same_on_both_ranks(got, key):
    for k in range(N_STEPS):
        a, b = got[0][key][k], got[1][key][k]
        assert a["metrics"] == b["metrics"]
        for part in ("grads", "sd", "masks", "ema"):
            for n in a[part]:
                np.testing.assert_array_equal(a[part][n], b[part][n],
                                              err_msg=f"{part} {n}")


@pytest.mark.parametrize("key", ["dp", "draws"])
def test_dp_step_equal_on_both_ranks(ranks, key):
    _same_on_both_ranks(ranks[1], key)


@pytest.mark.parametrize("key", ["dp", "draws"])
@pytest.mark.parametrize("k", range(N_STEPS))
def test_dp_step_matches_one_process(ranks, key, k):
    """Loss, every gradient and BN stat within 1e-4 (weights + one Adam
    step's noise, ATOL_PARAM), every mask exactly; ``draws``: drop path
    and random growth from the step's generator, drawn for the global
    batch."""
    _, got, one, _, _ = ranks
    g, w = got[0][key][k], one[key][k]
    assert g["metrics"]["loss"] == pytest.approx(w["metrics"]["loss"],
                                                 rel=1e-4)
    for n, v in w["grads"].items():
        _close(g["grads"][n], v, 1e-4, "grad " + n)
    for n, v in w["sd"].items():
        if not n.endswith("num_batches_tracked"):
            _close(g["sd"][n], v, 1e-4, n,
                   0.0 if "running" in n else ATOL_PARAM)
    for n, m in w["masks"].items():
        np.testing.assert_array_equal(g["masks"][n], m, err_msg=n)
    if k == N_STEPS - 1:        # the refresh moved every mask
        for n, m in ranks[0]["dp"]["masks"].items():
            assert not np.array_equal(g["masks"][n], m), n


@pytest.mark.parametrize("k", range(N_STEPS))
def test_dp_step_matches_slak_tpu_syncbn_step(ranks, k):
    from slak_tpu_torch.utils.convert import from_jax_params, masks_from_jax
    _, got, _, ref, _ = ranks
    g = got[0]["dp"][k]
    js, met = ref["dp"][k]
    for key in ("loss", "grad_norm"):
        assert g["metrics"][key] == pytest.approx(met[key], rel=1e-4), key
    want = from_jax_params(js.params, js.model_state)
    for n, v in want.items():
        if not n.endswith("num_batches_tracked"):
            _close(g["sd"][n], v.numpy(), 1e-4, n,
                   0.0 if "running" in n else ATOL_PARAM)
    for n, m in masks_from_jax(js.mask_state.masks).items():
        np.testing.assert_array_equal(g["masks"][n], m.numpy(), err_msg=n)


def test_only_rank_0_writes_the_checkpoint(ranks):
    _, got, _, _, _ = ranks
    (p0, step0, ls0), (p1, step1, ls1) = got[0]["ckpt"], got[1]["ckpt"]
    assert p0.endswith("checkpoint-0") and p1 is None
    assert step0 == step1 == 100
    assert ls0 == ls1 == ["checkpoint-0"]


# --- the launcher and the train CLI -----------------------------------------

CLI = ["--device", "cpu", "--model", "SLaK_debug", "--kernel_size", "13",
       "11", "9", "7", "5", "--Decom", "true", "--data_set", "synthetic",
       "--input_size", "32", "--use_bf16", "false", "--num_workers", "2",
       "--print_freq", "100", "--epochs", "1", "--synthetic_len", "36",
       "--warmup_epochs", "0", "--lr", "1e-5", "--min_lr", "1e-6",
       "--sparse", "--sparse_init", "ERK", "-u", "2", "--drop_path", "0.2",
       "--nb_classes", "10", "--seed", "3"]
RANK_BATCH = 8


class _RankBatches:
    """The train loader of a one-process run that sees what 2 ranks see:
    each batch the concatenation of the ranks' batches (ranks' loaders at
    half the batch, as the CLI builds them on each rank)."""

    def __init__(self, ds, batch_size, rank=0, world_size=1, **kw):
        from slak_tpu_torch.data.loader import BatchLoader
        assert (rank, world_size) == (0, 1)
        self.parts = [BatchLoader(ds, batch_size // 2, rank=r, world_size=2,
                                  **kw) for r in (0, 1)]
        self.num_workers = self.parts[0].num_workers

    def set_epoch(self, epoch):
        for p in self.parts:
            p.set_epoch(epoch)

    def __len__(self):
        return len(self.parts[0])

    def __iter__(self):
        for a, b in zip(*self.parts):
            yield tuple(torch.cat([u, v]) for u, v in zip(a, b))


def _cli_one_process(out_dir):
    """The one-process CLI at the global batch, its train batches the
    ranks' concatenated."""
    from slak_tpu_torch import data
    from slak_tpu_torch.train.main import main, parse_args
    base = data.BatchLoader

    def loader(ds, batch_size, shuffle=True, **kw):
        if shuffle:
            return _RankBatches(ds, batch_size, shuffle=True, **kw)
        return base(ds, batch_size, shuffle=shuffle, **kw)
    data.BatchLoader = loader
    try:
        return main(parse_args(CLI + ["--batch_size", str(2 * RANK_BATCH),
                                      "--output_dir", out_dir]))
    finally:
        data.BatchLoader = base


def test_launched_cli_matches_one_process(ranks):
    two, one, d2, d1 = ranks[4]
    assert two["world"] == 2 and two["rank"] == 0
    assert len(two["step_losses"]) == len(one["step_losses"]) == 2
    np.testing.assert_allclose(two["step_losses"], one["step_losses"],
                               rtol=1e-4)
    a = torch.load(os.path.join(d2, "checkpoint-0"), weights_only=False)
    b = torch.load(os.path.join(d1, "checkpoint-0"), weights_only=False)
    assert a["step"] == b["step"] == 2
    for n, v in b["model"].items():
        if not n.endswith("num_batches_tracked"):
            _close(a["model"][n].numpy(), v.numpy(), 1e-4, n)
    for n, m in b["mask_state"]["masks"].items():
        assert torch.equal(a["mask_state"]["masks"][n], m), n
    e2, e1 = two["epochs"][0], one["epochs"][0]
    assert e2["test_images"] == e1["test_images"] == 9
    for key in ("test_loss", "test_acc1", "test_acc5"):
        assert e2[key] == pytest.approx(e1[key], rel=1e-4, abs=1e-6), key


def test_launched_cli_rank_0_writes_one_checkpoint(ranks):
    two, _, d2, _ = ranks[4]
    numbered = [f for f in os.listdir(d2) if f.startswith("checkpoint-")
                and f[len("checkpoint-"):].isdigit()]
    assert numbered == ["checkpoint-0"]
    assert two["checkpoints"][0] == os.path.join(d2, "checkpoint-0")


def test_launch_kd_raises():
    """``--kd`` hands the flags after ``--`` to the distillation CLI's
    parser (its runs: tests/test_torch_kd.py): a bad ``--distill_type``
    raises that parser's error; without ``--kd`` the train CLI's parser
    rejects the flag."""
    from slak_tpu_torch.train import launch
    with pytest.raises(SystemExit):
        launch.main(["--kd", "--"] + CLI + ["--distill_type", "bogus"])
    with pytest.raises(SystemExit):
        launch.main(["--"] + CLI + ["--distill_type", "NKD"])
