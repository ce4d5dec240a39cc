"""COCO Cascade Mask R-CNN training CLI of the port:
``python -m slak_tpu_torch.downstream.det_main``, the counterpart of
``python -m slak_tpu.downstream.det_main`` (the reference's
``cascade_mask_rcnn_slak_tiny_mstrain_480-800_adamw_3x_coco_in1k.py`` under
mmdet's ``tools/train.py``; its optimizer block, AdamW lr 1e-4, wd 0.05,
layer-wise decay 0.7, is ``:135-141``).

    python -m slak_tpu_torch.downstream.det_main --steps 1000 \\
        --output_dir runs/det
    python -m slak_tpu_torch.downstream.det_main --smoke --device cpu \\
        --img_size 64 --batch_size 1 --num_gts 3 --steps 2

Recipe -> SLaK backbone (multi-scale features, fp32) -> FPN + RPN +
3-stage cascade + mask head (:mod:`~slak_tpu_torch.downstream.detection`)
-> AdamW with layer-decay groups on the backbone (``param_groups(...,
layer_decay=0.7)``: the classifier's 12-bucket layer ids, as ``slak_tpu``'s
CLI builds them) and undecayed head groups -> the 3x step LR (x0.1 at
epochs 27 and 33, linear warmup) -> train step (:func:`make_det_train_step`)
-> ``checkpoint-{it}`` and resume. ``--eval`` runs ``cascade_predict`` and
COCO box and mask AP. Every flag of ``slak_tpu``'s parser parses here with
its default; ``--device`` is the port's own.

``--data_set synthetic`` draws COCO-shaped batches with numpy (images,
padded boxes / labels / valid flags, masks at half resolution), iteration
``it``'s from a generator seeded (seed, it); the drop-path draws and the
samplers' uniforms of a step come from a torch generator seeded the same
way, so a resumed run sees what an uninterrupted one would have. TF32 is
off.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from slak_tpu_torch.downstream.seg_main import (_log, _zero_unused_grads,
                                                iter_rng, resume, save_state)


def get_det_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("SLaK COCO detection", add_help=False)
    p.add_argument("--recipe", default="cascade_mask_rcnn_slak_tiny_3x_coco")
    p.add_argument("--data_set", default="synthetic", choices=["synthetic"])
    p.add_argument("--steps", type=int, default=None,
                   help="total optimizer steps (default: epochs * "
                        "steps_per_epoch)")
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--img_size", type=int, default=800)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_gts", type=int, default=8,
                   help="padded ground-truth slots per image")
    p.add_argument("--smoke", action="store_true",
                   help="shrink backbone+heads to CI scale (same optimizer/"
                        "schedule/loss wiring)")
    p.add_argument("--backbone_ckpt", default="")
    p.add_argument("--output_dir", default="")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", action="store_true",
                   help="per-block activation remat in the backbone "
                        "(torch.utils.checkpoint)")
    p.add_argument("--eval", action="store_true",
                   help="evaluate COCO-style box+mask AP instead of "
                        "training; restores the latest checkpoint from "
                        "--output_dir if present")
    p.add_argument("--eval_batches", type=int, default=8)
    p.add_argument("--max_dets", type=int, default=100)
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    return p


def _head_cfg(recipe, smoke: bool):
    from slak_tpu_torch.downstream.detection import DetHeadConfig
    if smoke:
        return DetHeadConfig(
            in_channels=(8, 16, 24, 32), fpn_channels=16, num_classes=5,
            fc_out=32, rpn_sample=16, rcnn_sample=32, num_proposals=16,
            mask_convs=2, num_shared_convs=2)
    dims = recipe.backbone.model.widened_dims
    return DetHeadConfig(in_channels=dims, num_classes=recipe.num_classes)


def _smoke_backbone():
    from slak_tpu_torch.models.backbone import BackboneConfig
    from slak_tpu_torch.models.slak import SLaKConfig
    return BackboneConfig(
        model=SLaKConfig(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32),
                         kernel_size=(13, 11, 9, 7, 5), decom=True,
                         branch_bn=True, drop_path_rate=0.0),
        out_indices=(0, 1, 2, 3), sparse=False)


def _synthetic_det_batch(rng: np.random.Generator, n: int, size: int,
                         g: int, num_classes: int):
    """(NCHW images, boxes (n, g, 4), labels (n, g) int64, valid (n, g),
    masks (n, g, size // 2, size // 2)), drawn as ``slak_tpu``'s."""
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    xy = rng.uniform(0, size * 0.75, (n, g, 2))
    wh = rng.uniform(size * 0.1, size * 0.25, (n, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, size - 1)], -1)
    labels = rng.integers(0, num_classes, (n, g)).astype(np.int64)
    nv = rng.integers(1, g + 1, n)
    valid = (np.arange(g)[None] < nv[:, None]).astype(np.float32)
    masks = (rng.random((n, g, size // 2, size // 2)) > 0.5
             ).astype(np.float32)
    return (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(labels), torch.from_numpy(valid),
            torch.from_numpy(masks))


def step_lr_array(base_lr: float, total_steps: int, epochs: int,
                  steps_per_epoch: int, warmup_iters: int = 500,
                  warmup_ratio: float = 1e-3) -> np.ndarray:
    """mmdet 3x schedule: linear warmup, then x0.1 at epochs 27 and 33."""
    it = np.arange(total_steps, dtype=np.float32)
    lr = np.full(total_steps, base_lr, np.float32)
    for e in (27, 33):
        lr = np.where(it >= e * steps_per_epoch, lr * 0.1, lr)
    warm = base_lr * (warmup_ratio + (1 - warmup_ratio)
                      * np.minimum(it / max(warmup_iters, 1), 1.0))
    return np.where(it < warmup_iters, warm, lr).astype(np.float32)


def build_det(recipe, hcfg, device, seed: int, smoke: bool = False,
              remat: bool = False, backbone_ckpt: str = ""
              ) -> torch.nn.ModuleDict:
    """{"backbone": Backbone, "head": CascadeHead} from ``seed``, on
    ``device``, in train mode."""
    from slak_tpu_torch.downstream.detection import init_cascade
    from slak_tpu_torch.models.backbone import init_backbone
    from slak_tpu_torch.utils.convert import load_backbone_checkpoint
    bcfg = _smoke_backbone() if smoke else recipe.backbone
    if remat:
        bcfg = dataclasses.replace(
            bcfg, model=dataclasses.replace(bcfg.model, remat=True))
    backbone = init_backbone(bcfg, torch.Generator().manual_seed(seed))
    head = init_cascade(hcfg, torch.Generator().manual_seed(seed + 1))
    model = torch.nn.ModuleDict({"backbone": backbone, "head": head})
    model.to(device).train()
    if backbone_ckpt:
        load_backbone_checkpoint(backbone_ckpt, model["backbone"])
    return model


def det_param_groups(model: torch.nn.ModuleDict, layer_decay: float):
    """The backbone's groups with layer decay (names relative to the
    backbone, the classifier's 12-bucket ids), then the head's groups
    undecayed (mmdet's LearningRateDecayOptimizerConstructor puts
    non-backbone parameters in the last, undecayed bucket)."""
    from slak_tpu_torch.train.optim import param_groups
    return (param_groups(model["backbone"].named_parameters(), layer_decay)
            + param_groups(model["head"].named_parameters(), None))


def make_det_optimizer(model: torch.nn.ModuleDict, recipe):
    """AdamW over :func:`det_param_groups` at the recipe's layer decay."""
    from slak_tpu_torch.train.optim import make_adamw
    return make_adamw(det_param_groups(model, recipe.layer_decay))


def make_det_train_step(model: torch.nn.ModuleDict, opt, recipe, hcfg,
                        lr_arr: np.ndarray, img_hw, plain: bool = False):
    """Returns ``step(it, batch, generator=None) -> (total, losses,
    grad_norm, lr)``: the fp32 backbone in train mode and ``cascade_loss``
    (the drop-path draws and the samplers' uniforms from ``generator``),
    the backward, the global gradient norm and the AdamW step at
    ``lr_arr[it]``. ``plain`` runs the kernels' plain versions."""
    from slak_tpu_torch.downstream.detection import cascade_loss
    from slak_tpu_torch.train.optim import global_grad_norm, set_lr_wd
    dev = next(model.parameters()).device
    params = list(model.parameters())

    def step(it, batch, generator=None):
        model.train()
        x, gb, gl, gv, gm = (t.to(dev) for t in batch)
        lr = float(lr_arr[min(it, len(lr_arr) - 1)])
        set_lr_wd(opt, lr, recipe.weight_decay)
        opt.zero_grad(set_to_none=True)
        feats = model["backbone"](x, plain, generator)
        tot, losses, _ = cascade_loss(
            model["head"], feats, gb, gl, gv, gm, img_hw, hcfg, train=True,
            generator=generator)
        tot.backward()
        _zero_unused_grads(params)
        gnorm = global_grad_norm([p.grad for p in params])
        opt.step()
        return (tot.detach(), {k: v.detach() for k, v in losses.items()},
                gnorm, lr)

    return step


def make_det_predict(model: torch.nn.ModuleDict, hcfg, img_hw,
                     max_dets: int = 100):
    """Returns ``predict(x) -> (boxes, scores, labels, masks)``: the eval
    forward and ``cascade_predict``."""
    from slak_tpu_torch.downstream.detection import cascade_predict
    dev = next(model.parameters()).device

    @torch.no_grad()
    def predict(x):
        model.eval()
        feats = model["backbone"](x.to(dev))
        return cascade_predict(model["head"], feats, img_hw, hcfg,
                               max_dets=max_dets)

    return predict


def main(args, step_hook: Optional[Callable] = None) -> Dict[str, Any]:
    """Train (or with ``--eval`` evaluate); returns the final stats.
    ``step_hook(model, opt, it)``, when given, is called before each
    training step (a resumed run's first call sees the restored state)."""
    from slak_tpu_torch import resolve_device
    from slak_tpu_torch.downstream.configs import DET_CONFIGS
    from slak_tpu_torch.train.main import step_seed
    from slak_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recipe = DET_CONFIGS[args.recipe]
    hcfg = _head_cfg(recipe, args.smoke)
    size = args.img_size
    total = args.steps or recipe.epochs * args.steps_per_epoch

    model = build_det(recipe, hcfg, device, args.seed, args.smoke,
                      args.remat, args.backbone_ckpt)
    opt = make_det_optimizer(model, recipe)
    lr_arr = step_lr_array(recipe.lr, total, recipe.epochs,
                           args.steps_per_epoch)
    start_it = resume(args.output_dir, model, opt)

    if args.eval:
        from slak_tpu_torch.downstream.metrics import coco_ap
        predict = make_det_predict(model, hcfg, (size, size), args.max_dets)
        rng = np.random.default_rng(args.seed)
        dets, gts = [], []
        for _ in range(args.eval_batches):
            x, gb, gl, gv, gm = _synthetic_det_batch(
                rng, args.batch_size, size, args.num_gts, hcfg.num_classes)
            boxes, scores, labels, masks = (t.cpu().numpy()
                                            for t in predict(x))
            for i in range(x.shape[0]):
                dets.append({"boxes": boxes[i], "scores": scores[i],
                             "labels": labels[i], "masks": masks[i]})
                gts.append({"boxes": gb[i].numpy(), "labels": gl[i].numpy(),
                            "valid": gv[i].numpy(), "masks": gm[i].numpy()})
        box = coco_ap(dets, gts, hcfg.num_classes, "bbox")
        segm = coco_ap(dets, gts, hcfg.num_classes, "segm",
                       img_hw=(size, size))
        stats = {"bbox_AP": box["AP"], "bbox_AP50": box["AP50"],
                 "bbox_AP75": box["AP75"], "segm_AP": segm["AP"],
                 "segm_AP50": segm["AP50"]}
        print("eval: " + "  ".join(f"{k} {v * 100:.2f}"
                                   for k, v in stats.items()), flush=True)
        _log(args.output_dir, stats)
        return stats

    step = make_det_train_step(model, opt, recipe, hcfg, lr_arr,
                               (size, size))
    gen = torch.Generator(device=device)
    logger = MetricLogger(delimiter="  ")
    t0 = time.time()
    tot = torch.zeros(())
    for it in range(start_it, total):
        batch = _synthetic_det_batch(iter_rng(args.seed, it),
                                     args.batch_size, size, args.num_gts,
                                     hcfg.num_classes)
        gen.manual_seed(step_seed(args.seed, it))
        if step_hook is not None:
            step_hook(model, opt, it)
        tot, losses, gnorm, lr = step(it, batch, gen)
        if it % args.log_every == 0 or it == total - 1:
            logger.update(loss=tot, rpn_cls=losses["rpn_cls"],
                          s0_cls=losses["s0_cls"], grad_norm=gnorm, lr=lr)
            print(f"iter {it}/{total}: {logger}", flush=True)
        if args.output_dir and ((it + 1) % args.save_every == 0
                                or it == total - 1):
            save_state(os.path.join(args.output_dir, f"checkpoint-{it + 1}"),
                       model, opt, it + 1)
    stats = {"final_loss": float(tot), "iters": total,
             "time_sec": round(time.time() - t0, 1)}
    _log(args.output_dir, stats)
    return stats


def cli(argv=None):
    parser = argparse.ArgumentParser(parents=[get_det_args_parser()])
    return main(parser.parse_args(argv))


if __name__ == "__main__":
    cli()
