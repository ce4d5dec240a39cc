"""The port's downstream CLIs (``slak_tpu_torch/downstream/seg_main.py``,
``det_main.py``), their schedules and parameter groups, the COCO metric
and the backbone checkpoint readers, on the CPU:

  * seg ``--smoke``: 2 iterations, then resumed to 3 in the same
    directory, equal bit for bit (weights, BN stats, AdamW state) to 3
    uninterrupted iterations; then ``--eval`` over 2 batches: mIoU, mAcc,
    aAcc in [0, 1] and the confusion matrix's count that of the
    non-ignored pixels;
  * det ``--smoke``: 2 steps with a checkpoint, then ``--eval``: box and
    mask AP in [0, 1];
  * ``poly_schedule`` and ``step_lr_array`` equal to ``slak_tpu``'s;
  * the det parameter groups: each backbone parameter's lr scale and
    weight-decay flag those of ``slak_tpu``'s ``param_groups(...,
    layer_decay=0.7)``; the head's undecayed;
  * ``coco_ap`` (bbox and segm, crowd GTs, given areas) equal to
    ``slak_tpu``'s on the same detections;
  * the backbone readers: a ``.npz`` written as ``slak_tpu``'s CLIs read
    it, a reference ``.pth`` with ``module.backbone.`` names and a
    classifier-style state dict;
  * hand-computed ``box_iou``, ``mask_iou`` and ``paste_mask`` cases (the
    JAX package shares these functions, so parity does not check them):
    crowd IoU over the detection's area, a box off the grid, a mask
    pasted into a one-pixel box.
"""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from slak_tpu.downstream import metrics as JMET
from slak_tpu.downstream.configs import poly_schedule as jax_poly
from slak_tpu.downstream.det_main import step_lr_array as jax_step_lr
from slak_tpu.models import backbone as JB
from slak_tpu.models.slak import SLaKConfig as JaxSLaKConfig
from slak_tpu.train import optim as JO
from slak_tpu_torch.downstream import metrics as MET
from slak_tpu_torch.downstream.configs import DET_CONFIGS, poly_schedule
from slak_tpu_torch.downstream.det_main import (_head_cfg, build_det,
                                                det_param_groups,
                                                get_det_args_parser)
from slak_tpu_torch.downstream.det_main import main as det_main
from slak_tpu_torch.downstream.det_main import step_lr_array
from slak_tpu_torch.downstream.seg_main import get_seg_args_parser
from slak_tpu_torch.downstream.seg_main import main as seg_main
from slak_tpu_torch.models import backbone as B
from slak_tpu_torch.models.slak import SLaKConfig
from slak_tpu_torch.utils.convert import (backbone_from_jax,
                                          load_backbone_checkpoint)


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
             kernel_size=(13, 11, 9, 7, 5), decom=True, branch_bn=True)


def _args(parser, argv):
    return argparse.ArgumentParser(parents=[parser()]).parse_args(argv)


def _tensors(ck):
    out = {f"model.{k}.{n}": t for k, sd in ck["model"].items()
           for n, t in sd.items()}
    for i, st in ck["optimizer"]["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()
                    if torch.is_tensor(v)})
    return out


def test_seg_cli_resume_bit_exact_then_eval(tmp_path):
    base = ["--smoke", "--device", "cpu", "--crop_size", "64",
            "--batch_size", "2", "--log_every", "1", "--save_every", "100"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    seg_main(_args(get_seg_args_parser, base + ["--max_iters", "3",
                                                "--output_dir", a]))
    seg_main(_args(get_seg_args_parser, base + ["--max_iters", "2",
                                                "--output_dir", b]))
    assert os.path.exists(os.path.join(b, "checkpoint-2"))
    stats = seg_main(_args(get_seg_args_parser, base + ["--max_iters", "3",
                                                        "--output_dir", b]))
    assert np.isfinite(stats["final_loss"])
    ta, tb = (_tensors(torch.load(os.path.join(d, "checkpoint-3"),
                                  weights_only=False)) for d in (a, b))
    assert ta.keys() == tb.keys()
    bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not bad, bad[:5]
    stats = seg_main(_args(get_seg_args_parser, base + [
        "--eval", "--eval_batches", "2", "--output_dir", b]))
    for k in ("mIoU", "mAcc", "aAcc"):
        assert 0.0 <= stats[k] <= 1.0
    rng = np.random.default_rng(0)
    pixels = 0
    for _ in range(2):
        rng.standard_normal((2, 64, 64, 3))
        rng.integers(0, 150, (2, 64, 64))
        pixels += int((rng.random((2, 64, 64)) >= 0.05).sum())
    assert stats["pixels"] == pixels


def test_det_cli_train_then_eval(tmp_path):
    out = str(tmp_path / "det")
    base = ["--smoke", "--device", "cpu", "--img_size", "64",
            "--batch_size", "1", "--num_gts", "3", "--output_dir", out]
    stats = det_main(_args(get_det_args_parser, base + [
        "--steps", "2", "--log_every", "1", "--save_every", "2"]))
    assert np.isfinite(stats["final_loss"]) and stats["final_loss"] > 0
    assert os.path.exists(os.path.join(out, "checkpoint-2"))
    stats = det_main(_args(get_det_args_parser, base + [
        "--eval", "--eval_batches", "2", "--max_dets", "8"]))
    for k in ("bbox_AP", "bbox_AP50", "bbox_AP75", "segm_AP", "segm_AP50"):
        assert 0.0 <= stats[k] <= 1.0


def test_schedules_equal_jax():
    for args in ((2e-4, 1000, 100, 1e-6), (6e-5, 500, 0, 1e-3, 0.9, 1e-6)):
        np.testing.assert_array_equal(poly_schedule(*args),
                                      jax_poly(*args))
    for args in ((1e-4, 36 * 10, 36, 10), (1e-4, 400, 36, 10, 5, 1e-2)):
        np.testing.assert_array_equal(step_lr_array(*args),
                                      jax_step_lr(*args))


def test_det_param_groups_equal_jax():
    recipe = DET_CONFIGS["cascade_mask_rcnn_slak_tiny_3x_coco"]
    model = build_det(recipe, _head_cfg(recipe, True), "cpu", 0, smoke=True)
    groups = det_param_groups(model, recipe.layer_decay)
    bnames = dict(model["backbone"].named_parameters())
    got = {}
    for g in groups:
        for n, p in zip(g["names"], g["params"]):
            owner = "backbone" if bnames.get(n) is p else "head"
            got[(owner, n)] = (g["wd_on"], g["lr_scale"])
    assert len(got) == len(list(model.parameters()))
    bcfg = JB.BackboneConfig(model=JaxSLaKConfig(conv_impl="xla", **SMOKE))
    shapes = jax.eval_shape(lambda k: JB.init_backbone(k, bcfg),
                            jax.random.PRNGKey(0))[0]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    wd, sc = JO.param_groups(zeros, layer_decay=recipe.layer_decay)
    full = [backbone_from_jax(jax.tree_util.tree_map(
        lambda z, v: np.full(z.shape, v, np.float32), zeros, t))
        for t in (wd, sc)]
    for n in bnames:
        want = tuple(float(f[n].flatten()[0]) for f in full)
        assert got[("backbone", n)] == pytest.approx(want, rel=1e-6), n
    assert {v[1] for k, v in got.items() if k[0] == "head"} == {1.0}


def test_coco_ap_equal_jax():
    rng = np.random.default_rng(3)
    dets, gts = [], []
    for _ in range(4):
        g = 6
        xy = rng.uniform(0, 48, (g, 2))
        gb = np.concatenate([xy, xy + rng.uniform(4, 30, (g, 2))], 1)
        gt = {"boxes": gb, "labels": rng.integers(0, 3, g),
              "valid": (np.arange(g) < 5).astype(np.float32),
              "iscrowd": (rng.random(g) < 0.2).astype(np.float32),
              "masks": (rng.random((g, 32, 32)) > 0.6).astype(np.float32)}
        d = 10
        db = np.concatenate([gb[rng.integers(0, g, d)]
                             + rng.normal(0, 3, (d, 4))], 0)
        det = {"boxes": db, "scores": np.where(rng.random(d) < 0.2, 0.0,
                                               rng.random(d)),
               "labels": rng.integers(0, 3, d),
               "masks": rng.random((d, 28, 28))}
        dets.append(det)
        gts.append(gt)
    for kind in ("bbox", "segm"):
        got = MET.coco_ap(dets, gts, 3, kind, img_hw=(64, 64))
        want = JMET.coco_ap(dets, gts, 3, kind, img_hw=(64, 64))
        assert got == want, kind
    assert 0.0 < got["AP50"] <= 1.0 or 0.0 < MET.coco_ap(
        dets, gts, 3, "bbox")["AP50"] <= 1.0


def test_backbone_readers(tmp_path):
    rng = np.random.default_rng(4)
    bcfg = JB.BackboneConfig(model=JaxSLaKConfig(conv_impl="xla", **SMOKE))
    shapes = jax.eval_shape(lambda k: JB.init_backbone(k, bcfg),
                            jax.random.PRNGKey(0))[0]
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    # slak_tpu's CLIs read p{i} in tree-flatten order
    path = str(tmp_path / "backbone.npz")
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in
                      enumerate(jax.tree_util.tree_leaves(params))})
    want = backbone_from_jax(params)

    def fresh():
        return B.Backbone(B.BackboneConfig(model=SLaKConfig(**SMOKE)))

    def check(model):
        sd = model.state_dict()
        for n, v in want.items():
            assert torch.equal(sd[n], v), n

    check(load_backbone_checkpoint(path, fresh()))
    pth = str(tmp_path / "seg.pth")
    torch.save({"state_dict": {"module.backbone." + k: v for k, v in
                               want.items()} | {
        "module.decode_head.conv_seg.weight": torch.zeros(3)}}, pth)
    check(load_backbone_checkpoint(pth, fresh()))
    pth = str(tmp_path / "cls.pth")
    torch.save({"model": {k: v for k, v in want.items()
                          if not k.startswith("norm0")}}, pth)
    got = load_backbone_checkpoint(pth, fresh())
    assert torch.equal(got.norm0.weight, torch.ones(8))
    with pytest.raises(ValueError):
        np.savez(path, p0=np.zeros(3))
        load_backbone_checkpoint(path, fresh())


@pytest.mark.parametrize("what", ["iou", "paste"])
def test_metrics_hand_computed(what):
    if what == "iou":
        det = np.asarray([[0.0, 0, 10, 10], [6, 6, 8, 8]])
        gt = np.asarray([[5.0, 5, 20, 20]])
        np.testing.assert_allclose(MET.box_iou(det, gt), [[25 / 300],
                                                           [4 / 225]])
        # crowd: intersection over the detection's area
        np.testing.assert_allclose(MET.box_iou(det, gt, crowd=[1]),
                                   [[0.25], [1.0]])
        pred = np.zeros((1, 6, 6), bool)
        pred[0, :2, :2] = True
        g = np.zeros((1, 6, 6), bool)
        g[0, :4, 0] = True
        np.testing.assert_allclose(MET.mask_iou(pred, g), [[2 / 6]])
        np.testing.assert_allclose(MET.mask_iou(pred, g, crowd=[1]),
                                   [[0.5]])
        return
    # a box off the grid: the mask fills the box's part on the grid
    m = np.zeros((2, 2))
    m[0, 0] = 1.0
    got = MET.paste_mask(m, np.asarray([-4.0, -4, 6, 6]), (8, 8), (16, 16))
    want = np.zeros((8, 8), bool)
    want[0, :2] = want[1, 0] = True
    np.testing.assert_array_equal(got, want)
    # one pixel: the box covers grid cell (row 4, column 3) alone, which
    # takes the mean of the mask's four centre pixels
    m = np.zeros((28, 28))
    m[13, 13:15] = 1.0
    m[14, 13] = 0.4
    for centre, on in ((m, True), (m * 0.5, False)):
        got = MET.paste_mask(centre, np.asarray([3.2, 4.1, 3.7, 4.9]),
                             (8, 8), (8, 8))
        assert got.sum() == on and got[4, 3] == on
    assert not MET.paste_mask(m, np.asarray([3.0, 4, 3, 4]), (8, 8),
                              (8, 8)).any()
