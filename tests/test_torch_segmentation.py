"""The port's multi-scale backbone (``slak_tpu_torch/models/backbone.py``)
and UperNet head (``slak_tpu_torch/downstream/segmentation.py``) against
``slak_tpu`` on the CPU, at the ``--smoke`` sizes (depths 1/1/2/1, dims
8/16/24/32, kernels 13/11/9/7/5; the head 16 channels, aux 8), the JAX side
with ``conv_impl="xla"``:

  * the backbone's four normed stage outputs in eval mode, within 2e-4 of
    their scale;
  * ``derive_masks`` from weights with zeros equals the JAX one, and the
    sparse forward masks weights that are nonzero again, as the JAX one;
  * ``upernet_forward`` on features whose stage 4 is 16^2 (PSP scales 3
    and 6 through ``_adaptive_pool``, the antialiased resize), within 2e-4;
  * ``seg_loss`` with ignore pixels within 1e-5, and finite on all-ignore
    labels;
  * one seg train step (drop path 0.1, the head's dropout, AdamW over the
    norm / bias no-decay groups at a poly-schedule LR) against the step
    ``slak_tpu.downstream.seg_main`` builds, JAX's drop-path and dropout
    draws fed in: the loss within 1e-4, every gradient within 1e-4 of its
    scale, the BN running stats and the updated weights as
    ``tests/test_torch_kd.py`` holds them;
  * ``confusion_matrix`` equal to the JAX one and ``seg_scores`` on it;
  * ``--data_set ade_folder``: the reader's crops and labels those of
    ``slak_tpu``'s from the same draws, and the CLI's ``--eval`` on it.

Every JAX number comes from one jitted function, compiled once in a module
fixture; the JAX parameters are drawn with numpy on ``jax.eval_shape``'s
tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.downstream import metrics as JMET
from slak_tpu.downstream import segmentation as JS
from slak_tpu.downstream.configs import poly_schedule as jax_poly
from slak_tpu.models import backbone as JB
from slak_tpu.models.slak import SLaKConfig as JaxSLaKConfig
from slak_tpu.train import optim as JO
from slak_tpu_torch.downstream import metrics as MET
from slak_tpu_torch.downstream import segmentation as S
from slak_tpu_torch.downstream.configs import SEG_CONFIGS, poly_schedule
from slak_tpu_torch.downstream.seg_main import (make_seg_optimizer,
                                                make_seg_train_step)
from slak_tpu_torch.models import backbone as B
from slak_tpu_torch.models import layers as LY
from slak_tpu_torch.models.slak import SLaKConfig
from slak_tpu_torch.utils.convert import (backbone_from_jax, masks_from_jax,
                                         upernet_from_jax)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMOKE = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32),
             kernel_size=(13, 11, 9, 7, 5), decom=True, branch_bn=True,
             layer_scale_init_value=1.0)
HEAD = dict(in_channels=(8, 16, 24, 32), channels=16, aux_channels=8,
            num_classes=7)
N, CROP, DP = 2, 64, 0.1
LR = 2e-4
RTOL = 1e-4
ATOL_PARAM = 0.01 * LR               # as tests/test_torch_kd.py


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _close(got, want, tol, what, atol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-3) + atol
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


def _draw(shapes, rng):
    """A JAX params / state tree drawn with numpy: unit-centred scales and
    variances, small means and biases, weights at 1/sqrt(fan-in)."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if "'scale'" in name or "'gamma'" in name:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "'var'" in name:
            v = 1.0 + 0.2 * rng.random(shape)
        elif len(shape) <= 1:
            v = 0.05 * rng.standard_normal(shape)
        else:
            fan = int(np.prod(shape[:-1])) if len(shape) != 3 else \
                shape[0] * shape[1]
            v = rng.standard_normal(shape) / np.sqrt(fan)
        return jnp.asarray(v, jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_keeps(step_key, n_blocks):
    """slak_tpu's drop-path draws (forward_features' per-block splits of
    fold_in(key, 0)) for the blocks with a rate, and the head's dropout
    draw (fold_in(key, 1))."""
    rng = jax.random.fold_in(step_key, 0)
    keeps = []
    for j in range(n_blocks):
        rng, br = jax.random.split(rng)
        rate = DP * j / (n_blocks - 1)
        if rate > 0:
            keeps.append(np.asarray(jax.random.bernoulli(
                br, 1.0 - rate, (N, 1, 1, 1))).reshape(-1))
    drop = np.asarray(jax.random.bernoulli(
        jax.random.fold_in(step_key, 1), 0.9, (N, 1, 1, 1))).reshape(-1)
    return keeps, drop


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    bcfg_j = JB.BackboneConfig(model=JaxSLaKConfig(
        conv_impl="xla", drop_path_rate=DP, num_classes=10, **SMOKE))
    hcfg_j = JS.UperNetConfig(**HEAD)
    key = jax.random.PRNGKey(0)
    bshapes = jax.eval_shape(lambda k: JB.init_backbone(k, bcfg_j), key)
    hshapes = jax.eval_shape(lambda k: JS.init_upernet(k, hcfg_j), key)
    bparams, bstate = _draw(bshapes[0], rng), _draw(bshapes[1], rng)
    hparams = _draw(hshapes, rng)
    # weights with zeros, for the sparse forward, and the same weights
    # nonzero again (numpy: per-leaf eager JAX ops compile a shape each)
    sparse_p = jax.tree_util.tree_map(
        lambda w: np.asarray(w) * (rng.random(w.shape) > 0.4)
        if w.ndim >= 2 else np.asarray(w), bparams)
    dense_again = jax.tree_util.tree_map(
        lambda a, b: np.where(a == 0, np.asarray(b), a), sparse_p, bparams)
    x = rng.standard_normal((N, CROP, CROP, 3)).astype(np.float32)
    labels = rng.integers(0, 7, (N, CROP, CROP))
    labels = np.where(rng.random(labels.shape) < 0.1, 255, labels)
    feats16 = [rng.standard_normal((N, 128 >> i, 128 >> i, c)).astype(
        np.float32) for i, c in enumerate(HEAD["in_channels"])]
    step_key = jax.random.PRNGKey(3)
    params = {"backbone": bparams, "head": hparams}
    wd_mask, lr_scale = JO.param_groups(params, layer_decay=None)
    sparse_cfg = JB.BackboneConfig(model=bcfg_j.model, sparse=True)

    @jax.jit
    def oracle(params, bstate, x, labels, feats16, sparse_p, dense_again):
        masks = JB.derive_masks(sparse_p)
        ev, _ = JB.backbone_forward(params["backbone"], bstate, x, bcfg_j)
        sp, _ = JB.backbone_forward(dense_again, bstate, x, sparse_cfg,
                                    masks=masks)
        up = JS.upernet_forward(params["head"], feats16, hcfg_j)
        ign = JS.seg_loss(*up, jnp.full((N, 128, 128), 255), hcfg_j)

        def loss_fn(p):
            feats, new_bstate = JB.backbone_forward(
                p["backbone"], bstate, x, bcfg_j, train=True,
                rng=jax.random.fold_in(step_key, 0))
            lg, aux = JS.upernet_forward(p["head"], feats, hcfg_j,
                                         train=True,
                                         rng=jax.random.fold_in(step_key, 1))
            return JS.seg_loss(lg, aux, labels, hcfg_j), (new_bstate, lg,
                                                          aux)
        (loss, (new_bstate, lg, aux)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        new_params, _, _ = JO.adamw_update(
            grads, JO.adamw_init(params), params,
            float(jax_poly(LR, 100, 0, 1e-6)[0]), 0.05, wd_mask, lr_scale)
        eval_loss = JS.seg_loss(lg, aux, labels, hcfg_j)
        return dict(ev=ev, sp=sp, masks=masks, up=up, all_ignore=ign,
                    loss=loss, eval_loss=eval_loss, lg=lg, aux=aux,
                    grads=grads, bstate=new_bstate, params=new_params)

    out = oracle(params, bstate, jnp.asarray(x), jnp.asarray(labels),
                 [jnp.asarray(f) for f in feats16], sparse_p, dense_again)
    keeps, drop = _jax_keeps(step_key, sum(SMOKE["depths"]))
    return dict(bparams=bparams, bstate=bstate, hparams=hparams,
                sparse_p=sparse_p, dense_again=dense_again,
                x=x, labels=labels, feats16=feats16, keeps=keeps, drop=drop,
                out=jax.tree_util.tree_map(np.asarray, out))


def _backbone(c, params=None, sparse=False, drop_path=0.0):
    bcfg = B.BackboneConfig(model=SLaKConfig(drop_path_rate=drop_path,
                                             num_classes=10, **SMOKE),
                            sparse=sparse)
    m = B.Backbone(bcfg)
    m.load_state_dict(backbone_from_jax(
        c["bparams"] if params is None else params, c["bstate"]))
    return m


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def test_backbone_normed_stage_outputs(case):
    m = _backbone(case).eval()
    with torch.no_grad():
        feats = m(_nchw(case["x"]))
    assert len(feats) == 4
    for i, (f, w) in enumerate(zip(feats, case["out"]["ev"])):
        _close(f.permute(0, 2, 3, 1), w, 2e-4, f"stage {i + 1}")


def test_derive_masks_and_sparse_forward(case):
    zeros = _backbone(case, case["sparse_p"])
    masks = B.derive_masks(zeros)
    want = masks_from_jax(case["out"]["masks"])
    assert set(masks) == set(want)
    for n, m in masks.items():
        np.testing.assert_array_equal(m.numpy(), want[n].numpy())
    m = _backbone(case, case["dense_again"], sparse=True).eval()
    with torch.no_grad():
        got = m(_nchw(case["x"]), masks=masks)
        dense = m(_nchw(case["x"]))
        zeroed = zeros.eval()(_nchw(case["x"]))
    for i, (f, w, z) in enumerate(zip(got, case["out"]["sp"], zeroed)):
        _close(f.permute(0, 2, 3, 1), w, 2e-4, f"sparse stage {i + 1}")
        _close(f, z.numpy(), 1e-6, f"masked stage {i + 1}")
    assert any(float((a - b).abs().max()) > 1e-3 for a, b in zip(got, dense))


def test_upernet_forward_adaptive_pool(case):
    head = S.UperNet(S.UperNetConfig(**HEAD))
    head.load_state_dict(upernet_from_jax(case["hparams"]))
    with torch.no_grad():
        lg, aux = S.upernet_forward(head, [_nchw(f) for f in case["feats16"]])
    _close(lg.permute(0, 2, 3, 1), case["out"]["up"][0], 2e-4, "logits")
    _close(aux.permute(0, 2, 3, 1), case["out"]["up"][1], 2e-4, "aux")
    ign = S.seg_loss(lg, aux, torch.full((N, 128, 128), 255), head.cfg)
    assert float(ign) == float(case["out"]["all_ignore"]) == 0.0


def test_seg_loss_with_ignore_pixels(case):
    cfg = S.UperNetConfig(**HEAD)
    lg = _nchw(case["out"]["lg"])
    aux = _nchw(case["out"]["aux"])
    got = S.seg_loss(lg, aux, torch.from_numpy(case["labels"]), cfg)
    want = float(case["out"]["eval_loss"])
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_seg_train_step_against_jax(case, monkeypatch):
    import dataclasses
    recipe = SEG_CONFIGS["upernet_slak_tiny_512_80k_ade20k"]
    recipe = dataclasses.replace(recipe, head=S.UperNetConfig(**HEAD))
    model = torch.nn.ModuleDict({
        "backbone": _backbone(case, drop_path=DP),
        "head": S.UperNet(recipe.head)})
    model["head"].load_state_dict(upernet_from_jax(case["hparams"]))
    opt = make_seg_optimizer(model, recipe)
    lr_arr = poly_schedule(LR, 100, 0, 1e-6)
    np.testing.assert_array_equal(lr_arr, jax_poly(LR, 100, 0, 1e-6))
    keeps = [torch.tensor(k) for k in case["keeps"]]
    monkeypatch.setattr(LY, "drop_path_keep",
                        lambda n, rate, generator=None, device=None:
                        keeps.pop(0))
    step = make_seg_train_step(model, opt, recipe, lr_arr, torch.float32)
    loss, gnorm, lr = step(0, _t(case["x"]).permute(0, 3, 1, 2),
                           torch.from_numpy(case["labels"]),
                           dropout_keep=torch.tensor(case["drop"]))
    assert not keeps and lr == float(lr_arr[0])
    out = case["out"]
    assert abs(float(loss) - float(out["loss"])) <= RTOL * float(out["loss"])
    grads = dict(backbone_from_jax(out["grads"]["backbone"]))
    grads.update({f"head.{k}": v for k, v in
                  upernet_from_jax(out["grads"]["head"]).items()})
    new = dict(backbone_from_jax(out["params"]["backbone"], out["bstate"]))
    new.update({f"head.{k}": v for k, v in
                upernet_from_jax(out["params"]["head"]).items()})
    for name, p in model.named_parameters():
        key = name[len("backbone."):] if name.startswith("backbone.") \
            else name
        _close(p.grad, grads[key].numpy(), RTOL, f"grad {name}")
        _close(p, new[key].numpy(), RTOL, f"weight {name}", ATOL_PARAM)
    for name, b in model["backbone"].named_buffers():
        if "running" in name:
            _close(b, new[name].numpy(), 1e-5, name)


def test_confusion_matrix_and_scores():
    rng = np.random.default_rng(5)
    pred = rng.integers(0, 6, (2, 40, 40))
    lab = np.where(rng.random((2, 40, 40)) < 0.1, 255,
                   np.where(rng.random((2, 40, 40)) < 0.5, pred,
                            rng.integers(0, 6, (2, 40, 40))))
    got = MET.confusion_matrix(torch.from_numpy(pred),
                               torch.from_numpy(lab), 6)
    want = np.asarray(JMET.confusion_matrix(jnp.asarray(pred),
                                            jnp.asarray(lab), 6))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((lab != 255).sum())
    s, sj = MET.seg_scores(got.numpy()), JMET.seg_scores(want)
    for k in ("mIoU", "mAcc", "aAcc"):
        assert s[k] == sj[k]
    np.testing.assert_array_equal(s["per_class_iou"], sj["per_class_iou"])


def test_ade_folder_against_jax(tmp_path):
    """``--data_set ade_folder``: the port's reader gives ``slak_tpu``'s
    crops and labels (0 -> ignore, the rest shifted by 1) from the same
    draws, and the seg CLI's ``--eval`` counts every non-ignored pixel of
    the centre crops."""
    import argparse

    from PIL import Image

    from slak_tpu.downstream import seg_main as JSM
    from slak_tpu_torch.downstream import seg_main as SM
    rng = np.random.default_rng(6)
    (tmp_path / "images").mkdir()
    (tmp_path / "annotations").mkdir()
    for i, (h, w) in enumerate(((70, 90), (64, 64), (50, 80))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(tmp_path / "images" / f"im{i}.png")
        Image.fromarray(rng.integers(0, 8, (h, w), dtype=np.uint8)
                        ).save(tmp_path / "annotations" / f"im{i}.png")
    crop = 64
    got = SM._AdeFolder(str(tmp_path), crop).batch(
        np.random.default_rng(1), 4)
    want = JSM._AdeFolder(str(tmp_path), crop).batch(
        np.random.default_rng(1), 4)
    np.testing.assert_array_equal(got[0].permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert set(np.unique(got[1].numpy())) <= set(range(7)) | {255}
    pixels = sum(int((y != 255).sum())
                 for _, y in SM._AdeFolder(str(tmp_path), crop).eval_iter())
    args = argparse.ArgumentParser(parents=[SM.get_seg_args_parser()])
    stats = SM.main(args.parse_args([
        "--smoke", "--device", "cpu", "--data_set", "ade_folder",
        "--data_path", str(tmp_path), "--crop_size", str(crop), "--eval"]))
    assert stats["pixels"] == pixels and 0.0 <= stats["mIoU"] <= 1.0
