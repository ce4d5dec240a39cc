"""The port's differentiated eval path (ERF analysis) against slak_tpu on
the CPU.

K9's plain version against the Pallas kernel in interpret mode; the
autograd Function of the fused tail against ``jax.grad`` of the Pallas
``fused_mlp`` (whose VJP runs K9 above C = 256); eval-mode gradients of a
small model with one stage wider than 256 against ``jax.grad`` of
``forward_features(train=False, return_stages=True)`` on the same weights
(every parameter must get its gradient through the eval fold); the ERF
functions, the FLOPs counter, the ERF CLI, checkpoint unwrapping, the eval
transform and the image-folder dataset, and the deploy tool. Inputs come
from numpy seeds; each tolerance is stated with its reason.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.analysis import erf as jerf
from slak_tpu.analysis.flops import count_model_flops as jax_flops
from slak_tpu.data.datasets import ImageFolderDataset as JaxFolder
from slak_tpu.data.transforms import EvalTransform as JaxEval
from slak_tpu.models import slak as M
from slak_tpu.ops import pallas_mlp as PM
from slak_tpu.utils import load_torch_checkpoint as jax_load_ckpt
from slak_tpu.utils.convert import convert_state_dict
from slak_tpu_torch.analysis import erf as terf
from slak_tpu_torch.analysis import visualize_erf as V
from slak_tpu_torch.analysis.flops import count_model_flops
from slak_tpu_torch.data import EvalTransform, ImageFolderDataset
from slak_tpu_torch.models import create_model, merge_model
from slak_tpu_torch.models.slak import SLaK, SLaKConfig
from slak_tpu_torch.ops.mlp import (FusedMlp, fused_mlp_bwd_wide,
                                    fused_mlp_bwd_wide_plain, pack_mlp,
                                    pick_fc)
from slak_tpu_torch.utils import deploy
from slak_tpu_torch.utils.convert import (from_jax_params,
                                          load_torch_checkpoint)

# one stage wider than 256 so the eval backward runs K9 there
WIDE = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 272),
            kernel_size=(13, 11, 9, 7, 5), num_classes=10)
SIZE = 64
# fp32, the same math with sums in another order (and, against the Pallas
# kernels, the Abramowitz-Stegun erf of their GELU, |err| <= 1.5e-7)
TOL = 2e-4
NAMES = ("dy", "dW1", "dW2", "db1", "db2", "dgamma", "dln_scale",
         "dln_bias")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mlp_params(rng, c):
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


# --- K9 -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_plain_matches_pallas_chunked_kernel(dtype):
    """Plain K9 at C = 300, T = 18 against ``_mlp_bwd_chunked_2d``
    (interpret): fp32 has Fc = 512, NF = 3 (C4 1200 padded to 1536), bf16
    Fc = 640, NF = 2. All eight outputs. fp32 within 2e-4 (summation order,
    A-S erf); bf16 within 2e-3: the erf difference can flip the rounding of
    a few g or da elements by one bf16 ulp (2^-8), which moves the weight
    gradients by about 5e-4 of their scale."""
    rng = np.random.default_rng(3)
    c, t = 300, 18
    p = _mlp_params(rng, c)
    y = rng.standard_normal((t, c), dtype=np.float32)
    do = 0.3 * rng.standard_normal((t, c), dtype=np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    assert pick_fc(4 * c, 4 if dtype == "float32" else 2) == \
        (512 if dtype == "float32" else 640)
    # jitted: one XLA program, not the interpreter's op-by-op dispatch
    want = jax.jit(PM._mlp_bwd_chunked_2d, static_argnums=(10,))(
        jnp.asarray(y).astype(jdt), jnp.asarray(do).astype(jdt), p["ln_s"],
        p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"], p["pre"],
        True)
    pk = pack_mlp(*(_t(p[k]) for k in ("ln_s", "ln_b", "w1", "b1", "w2",
                                       "b2", "gamma", "pre")), dtype=tdt)
    got = fused_mlp_bwd_wide(_t(y).to(tdt), _t(do).to(tdt), pk)
    assert got[0].dtype == torch.float32          # dy is fp32, as in JAX
    tol = TOL if dtype == "float32" else 2e-3
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float32)
        if name in ("dW1", "dW2"):                # nn.Linear orientation
            w = w.T
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= tol, (name, _rel(g.numpy(), w))


def test_fused_mlp_function_matches_jax_grad_wide():
    """``FusedMlp`` (NCHW, with ``pre_bias``) at C = 300 against
    ``jax.grad`` of ``pallas_mlp.fused_mlp(..., interpret=True)`` (NHWC),
    whose custom VJP runs ``_mlp_bwd_chunked_2d``: all ten gradients,
    d pre_bias included. fp32, tolerance 2e-4 (A-S erf, summation
    order)."""
    rng = np.random.default_rng(4)
    c = 300
    p = _mlp_params(rng, c)
    y = rng.standard_normal((1, 3, 6, c), dtype=np.float32)
    res = rng.standard_normal((1, 3, 6, c), dtype=np.float32)
    proj = rng.standard_normal((1, 3, 6, c), dtype=np.float32)
    keys = ("ln_s", "ln_b", "w1", "b1", "w2", "b2", "gamma", "pre")

    def loss(y, res, *w):
        out = PM.fused_mlp(y, res, *w, True, True)
        return jnp.sum(out * proj)
    want = jax.jit(jax.grad(loss, argnums=tuple(range(10))))(
        jnp.asarray(y), jnp.asarray(res), *(jnp.asarray(p[k]) for k in keys))

    def nchw(a):
        return _t(a).permute(0, 3, 1, 2).contiguous().requires_grad_()
    ty, tres = nchw(y), nchw(res)
    leaves = {k: _t(p[k].T if k in ("w1", "w2") else p[k]).requires_grad_()
              for k in keys}
    out = FusedMlp.apply(ty, tres, leaves["ln_s"], leaves["ln_b"],
                         leaves["w1"], leaves["b1"], leaves["w2"],
                         leaves["b2"], leaves["gamma"], True, False,
                         leaves["pre"])
    (out * _t(proj).permute(0, 3, 1, 2)).sum().backward()
    got = [ty.grad.permute(0, 2, 3, 1), tres.grad.permute(0, 2, 3, 1)] + [
        leaves[k].grad.T if k in ("w1", "w2") else leaves[k].grad
        for k in keys]
    for name, g, w in zip(("dy", "dres") + keys, got, want):
        assert _rel(g.numpy(), w) <= TOL, (name, _rel(g.numpy(), w))


# --- eval-mode differentiation of a model -------------------------------------

@pytest.fixture(scope="module")
def wide_model():
    """(cfg, params, state, image, jitted JAX stage function): the JAX trees
    from a port model through slak_tpu's converter, every leaf jittered so
    that gamma, BN and biases all matter."""
    rng = np.random.default_rng(5)
    init = SLaK(SLaKConfig(**WIDE)).reset_parameters(
        torch.Generator().manual_seed(1))
    params, state = convert_state_dict(init.state_dict())

    def jitter(tree):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return jax.tree_util.tree_unflatten(treedef, [
            np.asarray(leaf) + 0.05 * np.abs(
                rng.standard_normal(leaf.shape).astype(np.float32))
            for leaf in leaves])
    params, state = jitter(params), jitter(state)
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", **WIDE)
    stages = jax.jit(lambda prm, x: M.forward_features(
        prm, state, x, cfg=cfg, train=False, return_stages=True)[0])
    x = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    return cfg, params, state, x, stages


def _port(params, state):
    model = SLaK(SLaKConfig(**WIDE)).eval()
    model.load_state_dict(from_jax_params(params, state))
    return model


def test_eval_differentiation_matches_jax_grad(wide_model):
    """Eval-mode backward through all four stage outputs (random
    projections): the input gradient and every parameter's gradient
    against ``jax.grad`` of the JAX eval forward on the same weights. Every
    parameter but the unused head and final norm gets a gradient through
    the BN/branch fold (the fault in which only the input got one); JAX
    gives those exact zeros. fp32, 2e-4 of each gradient's scale."""
    _, params, state, x, stages = wide_model
    rng = np.random.default_rng(6)
    projs = [rng.standard_normal(s.shape).astype(np.float32)
             for s in stages(params, jnp.asarray(x))]

    def loss(prm, xx):
        return sum(jnp.sum(s * pr) for s, pr in zip(stages(prm, xx), projs))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    model = _port(params, state)
    tx = _t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    outs = model.forward_features(tx, return_stages=True)
    assert outs[3].grad_fn.name() == "FusedMlpBackward"
    sum((o * _t(pr).permute(0, 3, 1, 2)).sum()
        for o, pr in zip(outs, projs)).backward()
    assert _rel(tx.grad.permute(0, 2, 3, 1).numpy(), gx) <= TOL
    want = from_jax_params(gp, state)
    named = dict(model.named_parameters())
    missing = sorted(n for n, p in named.items() if p.grad is None)
    assert missing == ["head.bias", "head.weight", "norm.bias",
                       "norm.weight"], missing
    for n in missing:
        assert not want[n].abs().max() > 0, n
    for n, p in named.items():
        if p.grad is not None:
            assert _rel(p.grad.numpy(), want[n].numpy()) <= TOL, n


def test_eval_graph_route_keeps_the_cache_graph_free(wide_model):
    """With a graph the eval block runs the autograd Functions (the route
    that launches K1 and K2 forward, K1/K8/K9 backward on the card) and
    folds uncached; without one it takes the cached fold, which holds no
    graph tensor; both give the same stage outputs."""
    _, params, state, x, _ = wide_model
    model = _port(params, state)
    tx = _t(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        cached = model.forward_features(tx, return_stages=True)
    blk = model.stages[3][0]
    assert blk._cache
    for _, (taps, pk) in blk._cache.values():
        for t in list(taps) + [pk.w1, pk.w2, pk.b1, pk.vec]:
            assert t.grad_fn is None and not t.requires_grad
    model.requires_grad_(False)
    xg = tx.clone().requires_grad_()
    graph = model.forward_features(xg, return_stages=True)
    assert graph[0].grad_fn.name() == "FusedMlpBackward"
    conv = graph[0].grad_fn.next_functions[0][0]
    assert conv.name() == "DwconvTapsBackward"
    for a, b in zip(graph, cached):
        assert _rel(a.detach().numpy(), b.numpy()) <= 1e-6


def test_erf_input_grad_and_analysis_match_jax(wide_model):
    """``get_input_grad`` on the port's ERF feature function (stage 4,
    NHWC) against slak_tpu's on the same weights and image; then
    ``analyze_erf`` / ``get_rectangle`` on the map. fp32, 2e-4."""
    _, params, state, x, stages = wide_model
    want = jerf.get_input_grad(lambda xx: stages(params, xx)[-1],
                               jnp.asarray(x))
    model = _port(params, state).requires_grad_(False)

    def feature_fn(xx):
        return model.forward_features(xx.permute(0, 3, 1, 2).contiguous(),
                                      return_stages=True)[-1].permute(
                                          0, 2, 3, 1)
    got = terf.get_input_grad(feature_fn, x)
    assert got.shape == (SIZE, SIZE) and np.abs(want).max() > 0
    assert _rel(got, want) <= TOL
    avg = terf.erf_contribution(feature_fn, [x, x])
    assert _rel(avg, got) <= 1e-6
    a, b = terf.analyze_erf(got + 1e-9), jerf.analyze_erf(want + 1e-9)
    assert _rel(a["normalized"], b["normalized"]) <= TOL
    assert a["ratios"] == b["ratios"]
    assert terf.get_rectangle(a["normalized"], 0.5) == \
        jerf.get_rectangle(b["normalized"], 0.5)


# --- FLOPs, CLI, checkpoints, data, deploy ------------------------------------

def test_count_model_flops_matches_jax():
    """Per-component MACs, totals and parameter counts with half of one
    pwconv zeroed (the nonzero scaling), against slak_tpu's counter on the
    converted weights: counts exact, MACs within 1e-6 (both take float32
    means of the nonzero masks, summed in another order); without
    multiply-adds every count doubles."""
    model = create_model("SLaK_debug", device="cpu",
                         kernel_size=(13, 11, 9, 7, 5))
    with torch.no_grad():
        w = model.stages[2][1].pwconv1.weight
        w[: w.shape[0] // 2] = 0.0
    params, _ = convert_state_dict(model.state_dict())
    want = jax_flops(params, M.SLaKConfig(
        depths=(1, 1, 2, 1), dims=(8, 16, 24, 32),
        kernel_size=(13, 11, 9, 7, 5)), 96, True)
    got = count_model_flops(model, 96, True)
    assert got["params"] == want["params"]
    assert got["nonzero_params"] == want["nonzero_params"] < got["params"]
    assert got["total"] == pytest.approx(want["total"], rel=1e-6)
    assert set(got["per_layer"]) == set(want["per_layer"])
    for k, v in want["per_layer"].items():
        assert got["per_layer"][k] == pytest.approx(v, rel=1e-6), k
    dense = count_model_flops(model, 96, False)
    assert dense["total"] == 2 * got["total"]
    assert dense["per_layer"] == {k: 2 * v for k, v in
                                  got["per_layer"].items()}


@pytest.mark.parametrize("weights", [False, True])
def test_erf_cli_on_cpu(tmp_path, weights):
    """``visualize_erf.main --device cpu`` on a small model: without
    ``--weights`` the port's seeded init, with ``--weights`` a .pth written
    here; the saved map equals ``erf_contribution`` of the same model on
    the JAX CLI's numpy images, and the heatmap is written."""
    ks = (13, 11, 9, 7, 5)
    model = create_model("SLaK_debug", device="cpu", seed=3 if weights
                         else 0, kernel_size=ks)
    argv = ["--model", "SLaK_debug", "--kernel_size", *map(str, ks),
            "--input_size", str(SIZE), "--num_images", "2", "--device",
            "cpu", "--save", str(tmp_path / "erf.npy"), "--heatmap",
            str(tmp_path / "erf.png")]
    if weights:
        torch.save({"model": model.state_dict()}, tmp_path / "w.pth")
        argv += ["--weights", str(tmp_path / "w.pth")]
    out = V.main(argv)
    data = np.load(tmp_path / "erf.npy")
    np.testing.assert_array_equal(data, out["data"])
    assert (tmp_path / "erf.png").stat().st_size > 0
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(2)]
    model.requires_grad_(False)
    want = terf.erf_contribution(
        lambda x: model.forward_features(
            x.permute(0, 3, 1, 2).contiguous(), return_stages=True
        )[-1].permute(0, 2, 3, 1), images)
    assert _rel(data, want) <= 1e-6 and len(out["seconds"]) == 2
    assert out["used"] == 2


def test_checkpoint_unwrapping_matches_slak_tpu(tmp_path):
    """``load_torch_checkpoint``: the ``model|module`` keys, ``model_ema``
    with ``prefer_ema``, ``state_dict``, a bare dict and prefix stripping;
    each result converts (slak_tpu's ``convert_state_dict``) to the trees
    slak_tpu's loader gives for the same file."""
    a = create_model("SLaK_debug", device="cpu", seed=1,
                     kernel_size=(7, 7, 7, 7, 5)).state_dict()
    b = create_model("SLaK_debug", device="cpu", seed=2,
                     kernel_size=(7, 7, 7, 7, 5)).state_dict()
    cases = [({"model": a, "epoch": 3}, {}, a),
             ({"module": a}, {}, a),
             ({"model": a, "model_ema": b}, {"prefer_ema": True}, b),
             ({"state_dict": {"backbone." + k: v for k, v in a.items()}},
              {"model_prefix": "backbone."}, a),
             (a, {}, a)]
    for i, (ckpt, kw, want) in enumerate(cases):
        path = str(tmp_path / f"c{i}.pth")
        torch.save(ckpt, path)
        got = load_torch_checkpoint(path, **kw)
        assert set(got) == set(want), i
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        jp, js = jax_load_ckpt(path, **kw)
        tp, ts = convert_state_dict(got)
        for u, v in ((jp, tp), (js, ts)):
            lu, tu = jax.tree_util.tree_flatten(u)
            lv, tv = jax.tree_util.tree_flatten(v)
            assert tu == tv
            for p, q in zip(lu, lv):
                np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


def test_eval_transform_and_image_folder_match_slak_tpu(tmp_path):
    """``ImageFolderDataset`` + ``EvalTransform`` against slak_tpu's on
    seeded PNGs in two classes: the same samples, labels and arrays, at
    224 (resize and center crop) and at 400 (the >= 384 warp-resize, the
    ERF protocol's path), with both mean/std choices; exact."""
    from PIL import Image
    rng = np.random.default_rng(7)
    for cls, n in (("b_cls", 2), ("a_cls", 1)):
        os.makedirs(tmp_path / "val" / cls)
        for j in range(n):
            arr = rng.integers(0, 256, (90 + 7 * j, 120, 3), dtype=np.uint8)
            Image.fromarray(arr).save(tmp_path / "val" / cls / f"{j}.png")
    (tmp_path / "val" / "a_cls" / "notes.txt").write_text("skip")
    for size, imnet in ((224, True), (400, False)):
        got = ImageFolderDataset(str(tmp_path / "val"),
                                 EvalTransform(size, None, imnet))
        want = JaxFolder(str(tmp_path / "val"), JaxEval(size, None, imnet))
        assert got.samples == want.samples and len(got) == 3
        assert got.class_to_idx == want.class_to_idx
        for i in range(len(got)):
            (ga, gl), (wa, wl) = got[i], want[i]
            assert gl == wl and ga.shape == (size, size, 3)
            assert ga.dtype == np.float32
            np.testing.assert_array_equal(ga, wa)


def test_deploy_merges_within_2e3(tmp_path):
    """``utils.deploy.main``: the checkpoint loaded, every block merged into
    one K x K conv, the merged state dict saved; merged logits within 2e-3
    of the unmerged model's (the reference's merge tolerance)."""
    ks = (13, 11, 9, 7, 5)
    model = create_model("SLaK_debug", device="cpu", seed=4, kernel_size=ks,
                         num_classes=10)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for n, buf in model.named_buffers():
            if n.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif n.endswith("running_var"):
                buf.copy_(1 + torch.rand(buf.shape, generator=g))
        for n, p in model.named_parameters():
            if n.endswith("gamma"):
                p.fill_(0.5)
    torch.save({"model": model.state_dict()}, tmp_path / "ckpt.pth")
    merged = deploy.main(["--ckpt", str(tmp_path / "ckpt.pth"), "--out",
                          str(tmp_path / "merged.pth"), "--model",
                          "SLaK_debug", "--kernel_size", *map(str, ks),
                          "--nb_classes", "10", "--device", "cpu"])
    sd = torch.load(tmp_path / "merged.pth")
    assert "stages.0.0.large_kernel.lkb_reparam.weight" in sd
    assert not any("LoRA1" in k for k in sd)
    reloaded = merge_model(model)
    reloaded.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 3, SIZE, SIZE)).astype(np.float32))
    want = model(x)
    for m in (merged, reloaded):
        assert (m(x) - want).abs().max().item() < 2e-3
