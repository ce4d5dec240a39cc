"""ADE20K semantic-segmentation training CLI of the port:
``python -m slak_tpu_torch.downstream.seg_main``, the counterpart of
``python -m slak_tpu.downstream.seg_main`` (the reference's UperNet configs
under mmseg's ``tools/train.py``).

    python -m slak_tpu_torch.downstream.seg_main \\
        --recipe upernet_slak_tiny_512_80k_ade20k --batch_size 8 \\
        --use_bf16 true --output_dir runs/seg
    python -m slak_tpu_torch.downstream.seg_main --smoke --device cpu \\
        --crop_size 64 --batch_size 2 --max_iters 2 --output_dir /tmp/seg

Recipe -> SLaK backbone with per-stage norms + UperNet / FCN-aux heads ->
AdamW with no weight decay on norms and biases -> poly LR with linear
warmup -> train step (:func:`make_seg_train_step`: the backbone's kernels
on the card, their plain versions on the CPU) -> ``checkpoint-{it}`` and
resume. ``--eval`` accumulates the confusion matrix on the device and
prints mIoU / mAcc / aAcc. Every flag of ``slak_tpu``'s parser parses here
with its default; ``--device`` (default: the CUDA card) is the port's own.

``--data_set synthetic`` draws ADE-shaped crops (images, labels with 5%
ignore pixels); ``ade_folder`` reads ``{root}/images`` and
``{root}/annotations`` (PIL). The training batch of iteration ``it`` and
its drop-path and dropout draws come from generators seeded from
(seed, it), so a resumed run sees what an uninterrupted one would have
(``slak_tpu``'s restarts its numpy stream at the resume). TF32 is off.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from slak_tpu_torch.utils import str2bool

FORMAT = "slak_tpu_torch.downstream/1"


def get_seg_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("SLaK ADE20K segmentation", add_help=False)
    p.add_argument("--recipe", default="upernet_slak_tiny_512_80k_ade20k")
    p.add_argument("--data_set", default="synthetic",
                   choices=["synthetic", "ade_folder"])
    p.add_argument("--data_path", default="")
    p.add_argument("--max_iters", type=int, default=None,
                   help="override the recipe's schedule length")
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--smoke", action="store_true",
                   help="shrink backbone+head to CI scale (keeps the "
                        "optimizer/schedule/loss wiring identical)")
    p.add_argument("--backbone_ckpt", default="",
                   help="pretrained backbone weights: a .npz written the "
                        "slak_tpu way, a checkpoint of this package or a "
                        "reference .pth")
    p.add_argument("--output_dir", default="")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_every", type=int, default=4000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_bf16", default=False, type=str2bool)
    p.add_argument("--remat", action="store_true",
                   help="per-block activation remat in the backbone "
                        "(torch.utils.checkpoint)")
    p.add_argument("--eval", action="store_true",
                   help="evaluate mIoU/mAcc/aAcc instead of training; "
                        "restores the latest checkpoint from --output_dir "
                        "if present")
    p.add_argument("--eval_batches", type=int, default=8,
                   help="synthetic eval batches (ade_folder evaluates "
                        "every image once, center-cropped)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    return p


def _shrink_recipe(recipe):
    """CI-scale twin: tiny dims, small kernels, narrow head; the same
    optimizer / schedule / loss code paths."""
    from slak_tpu_torch.downstream.segmentation import UperNetConfig
    from slak_tpu_torch.models.backbone import BackboneConfig
    from slak_tpu_torch.models.slak import SLaKConfig
    b = BackboneConfig(
        model=SLaKConfig(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32),
                         kernel_size=(13, 11, 9, 7, 5), decom=True,
                         branch_bn=True, drop_path_rate=0.0,
                         layer_scale_init_value=1.0),
        out_indices=(0, 1, 2, 3), sparse=False)
    h = UperNetConfig(in_channels=(8, 16, 24, 32), channels=16,
                      aux_channels=8, num_classes=recipe.num_classes)
    return dataclasses.replace(recipe, backbone=b, head=h)


def _synthetic_seg_batch(rng: np.random.Generator, n: int, crop: int,
                         num_classes: int):
    """(NCHW float32 images, (N, H, W) int64 labels), 5% ignore pixels."""
    x = rng.standard_normal((n, crop, crop, 3)).astype(np.float32)
    y = rng.integers(0, num_classes, (n, crop, crop)).astype(np.int64)
    ign = rng.random((n, crop, crop)) < 0.05
    y = np.where(ign, 255, y)
    return (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(y))


class _AdeFolder:
    """ADE20K layout: ``{root}/images/*`` + ``{root}/annotations/*.png``
    with matching stems. Random crops; labels shifted by -1 with 0 -> 255
    (mmseg's reduce_zero_label)."""

    def __init__(self, root: str, crop: int):
        import glob
        self.crop = crop
        self.imgs = sorted(glob.glob(os.path.join(root, "images", "*")))
        assert self.imgs, f"no images under {root}/images"
        self.anns = [os.path.join(root, "annotations",
                                  os.path.splitext(os.path.basename(p))[0]
                                  + ".png") for p in self.imgs]

    def _load(self, i: int):
        from PIL import Image
        img = np.asarray(Image.open(self.imgs[i]).convert("RGB"))
        ann = np.asarray(Image.open(self.anns[i]))
        h, w = img.shape[:2]
        c = self.crop
        if h < c or w < c:
            ph, pw = max(0, c - h), max(0, c - w)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            ann = np.pad(ann, ((0, ph), (0, pw)), constant_values=0)
        return img, ann

    @staticmethod
    def _normalize(img, ann, y0: int, x0: int, c: int):
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        x = (img[y0:y0 + c, x0:x0 + c] / 255.0 - mean) / std
        lab = ann[y0:y0 + c, x0:x0 + c].astype(np.int64) - 1
        return x.astype(np.float32), np.where(lab < 0, 255, lab)

    @staticmethod
    def _tensors(xs, ys):
        return (torch.from_numpy(np.stack(xs)).permute(0, 3, 1, 2)
                .contiguous(), torch.from_numpy(np.stack(ys)))

    def batch(self, rng: np.random.Generator, n: int):
        xs, ys = [], []
        c = self.crop
        for i in rng.integers(0, len(self.imgs), n):
            img, ann = self._load(int(i))
            h, w = img.shape[:2]
            y0 = int(rng.integers(0, h - c + 1))
            x0 = int(rng.integers(0, w - c + 1))
            x, y = self._normalize(img, ann, y0, x0, c)
            xs.append(x)
            ys.append(y)
        return self._tensors(xs, ys)

    def eval_iter(self):
        """Every image once, center-cropped (batch 1)."""
        c = self.crop
        for i in range(len(self.imgs)):
            img, ann = self._load(i)
            h, w = img.shape[:2]
            x, y = self._normalize(img, ann, (h - c) // 2, (w - c) // 2, c)
            yield self._tensors([x], [y])


def iter_rng(seed: int, it: int) -> np.random.Generator:
    """The numpy generator of training iteration ``it``'s batch."""
    return np.random.default_rng([seed, it])


def save_state(path: str, model: torch.nn.Module, opt, it: int):
    """One file: the model's ``backbone`` / ``head`` state dicts, the
    optimizer's state and the iteration (through a temporary file)."""
    tmp = path + ".tmp"
    torch.save({"format": FORMAT,
                "model": {k: m.state_dict() for k, m in model.items()},
                "optimizer": opt.state_dict(), "iter": it}, tmp)
    os.replace(tmp, path)


def restore_state(path: str, model: torch.nn.Module, opt=None) -> int:
    """Load ``path`` into the model (and the optimizer) in place: the
    tensors land on their parameters' device, AdamW's step counts stay on
    the CPU as a fresh optimizer keeps them. Returns the iteration."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    if not (isinstance(ck, dict) and ck.get("format") == FORMAT):
        raise ValueError(f"{path}: not a downstream checkpoint")
    for k, m in model.items():
        m.load_state_dict(ck["model"][k])
    if opt is not None:
        opt.load_state_dict(ck["optimizer"])
    return int(ck["iter"])


def resume(output_dir: str, model, opt=None) -> int:
    """Restore the latest ``checkpoint-N`` of ``output_dir`` if there is
    one: N, else 0."""
    from slak_tpu_torch.train.checkpoint import latest_checkpoint
    if not output_dir:
        return 0
    os.makedirs(output_dir, exist_ok=True)
    ck = latest_checkpoint(output_dir)
    return 0 if ck is None else restore_state(ck, model, opt)


def build_seg(recipe, device, seed: int, remat: bool = False,
              backbone_ckpt: str = "") -> torch.nn.ModuleDict:
    """{"backbone": Backbone, "head": UperNet} from ``seed`` (two
    generators, the backbone's and the head's), on ``device``, in train
    mode."""
    from slak_tpu_torch.downstream.segmentation import init_upernet
    from slak_tpu_torch.models.backbone import init_backbone
    from slak_tpu_torch.utils.convert import load_backbone_checkpoint
    bcfg = recipe.backbone
    if remat:
        bcfg = dataclasses.replace(
            bcfg, model=dataclasses.replace(bcfg.model, remat=True))
    g = torch.Generator().manual_seed(seed)
    backbone = init_backbone(bcfg, g)
    head = init_upernet(recipe.head, torch.Generator().manual_seed(seed + 1))
    model = torch.nn.ModuleDict({"backbone": backbone, "head": head})
    model.to(device).train()
    if backbone_ckpt:
        load_backbone_checkpoint(backbone_ckpt, model["backbone"])
    return model


def make_seg_optimizer(model: torch.nn.ModuleDict, recipe):
    """AdamW over the mmseg groups: no weight decay on 1-D parameters
    and biases (``param_groups(..., layer_decay=None)``)."""
    from slak_tpu_torch.train.optim import make_adamw, param_groups
    return make_adamw(param_groups(model.named_parameters(), None),
                      recipe.betas)


def _zero_unused_grads(params):
    """A zero gradient for each parameter the loss did not reach (the
    backbone's classifier and final norm): AdamW then decays it and moves
    it by nothing, as the JAX step's zero gradient does."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_seg_train_step(model: torch.nn.ModuleDict, opt, recipe,
                        lr_arr: np.ndarray, dtype: torch.dtype,
                        plain: bool = False):
    """Returns ``step(it, x, y, generator=None, dropout_keep=None) ->
    (loss, grad_norm, lr)``: the backbone in train mode on NCHW images in
    ``dtype``, the heads (drop-path draws and then the head's dropout from
    ``generator``, or the dropout's ``dropout_keep``), the loss, its
    backward, the global gradient norm and the AdamW step at
    ``lr_arr[it]``. ``plain`` runs the kernels' plain versions."""
    from slak_tpu_torch.downstream.segmentation import (seg_loss,
                                                        upernet_forward)
    from slak_tpu_torch.train.optim import global_grad_norm, set_lr_wd
    hcfg = recipe.head
    dev = next(model.parameters()).device
    params = list(model.parameters())

    def step(it, x, y, generator=None, dropout_keep=None):
        model.train()
        lr = float(lr_arr[min(it, len(lr_arr) - 1)])
        set_lr_wd(opt, lr, recipe.weight_decay)
        opt.zero_grad(set_to_none=True)
        feats = model["backbone"](x.to(device=dev, dtype=dtype), plain,
                                  generator)
        lg, aux = upernet_forward(model["head"], feats, train=True,
                                  generator=generator,
                                  dropout_keep=dropout_keep)
        loss = seg_loss(lg, aux, y.to(dev), hcfg)
        loss.backward()
        _zero_unused_grads(params)
        gnorm = global_grad_norm([p.grad for p in params])
        opt.step()
        return loss.detach(), gnorm, lr

    return step


def make_seg_eval_step(model: torch.nn.ModuleDict, recipe,
                       dtype: torch.dtype):
    """Returns ``eval_step(cm, x, y) -> cm``: the eval forward, the logits
    resized to the labels and their argmax added into the confusion
    matrix ``cm`` on the device."""
    from slak_tpu_torch.downstream.metrics import confusion_matrix
    from slak_tpu_torch.downstream.segmentation import (_resize,
                                                        upernet_forward)
    hcfg = recipe.head
    dev = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(cm, x, y):
        model.eval()
        feats = model["backbone"](x.to(device=dev, dtype=dtype))
        lg, _ = upernet_forward(model["head"], feats, train=False)
        y = y.to(dev)
        lg = _resize(lg, y.shape[1], y.shape[2]).float()
        return cm + confusion_matrix(lg.argmax(1), y, hcfg.num_classes)

    return eval_step


def main(args, step_hook: Optional[Callable] = None) -> Dict[str, Any]:
    """Train (or with ``--eval`` evaluate); returns the final stats.
    ``step_hook(model, opt, it)``, when given, is called before each
    training step (a resumed run's first call sees the restored state)."""
    from slak_tpu_torch import resolve_device
    from slak_tpu_torch.downstream.configs import SEG_CONFIGS, poly_schedule
    from slak_tpu_torch.train.main import step_seed
    from slak_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recipe = SEG_CONFIGS[args.recipe]
    if args.smoke:
        recipe = _shrink_recipe(recipe)
    hcfg = recipe.head
    crop = args.crop_size or recipe.crop_size
    batch = args.batch_size or recipe.batch_size
    max_iters = args.max_iters or recipe.max_iters
    dtype = torch.bfloat16 if args.use_bf16 else torch.float32

    model = build_seg(recipe, device, args.seed, args.remat,
                      args.backbone_ckpt)
    opt = make_seg_optimizer(model, recipe)
    lr_arr = poly_schedule(recipe.lr, max_iters, recipe.warmup_iters,
                           recipe.warmup_ratio, recipe.poly_power,
                           recipe.min_lr)
    start_it = resume(args.output_dir, model, opt)
    folder = (_AdeFolder(args.data_path, crop)
              if args.data_set == "ade_folder" else None)

    if args.eval:
        eval_step = make_seg_eval_step(model, recipe, dtype)
        cm = torch.zeros((hcfg.num_classes, hcfg.num_classes),
                         dtype=torch.int64, device=device)
        if folder is not None:
            for x, y in folder.eval_iter():
                cm = eval_step(cm, x, y)
        else:
            rng = np.random.default_rng(args.seed)
            for _ in range(args.eval_batches):
                cm = eval_step(cm, *_synthetic_seg_batch(
                    rng, batch, crop, hcfg.num_classes))
        from slak_tpu_torch.downstream.metrics import seg_scores
        cm = cm.cpu().numpy()
        s = seg_scores(cm)
        stats = {"mIoU": s["mIoU"], "mAcc": s["mAcc"], "aAcc": s["aAcc"],
                 "pixels": int(cm.sum())}
        print("eval: " + "  ".join(f"{k} {stats[k] * 100:.2f}"
                                   for k in ("mIoU", "mAcc", "aAcc")),
              flush=True)
        _log(args.output_dir, stats)
        return stats

    step = make_seg_train_step(model, opt, recipe, lr_arr, dtype)
    gen = torch.Generator(device=device)
    logger = MetricLogger(delimiter="  ")
    t0 = time.time()
    loss = torch.zeros(())
    for it in range(start_it, max_iters):
        rng = iter_rng(args.seed, it)
        x, y = (folder.batch(rng, batch) if folder is not None else
                _synthetic_seg_batch(rng, batch, crop, hcfg.num_classes))
        gen.manual_seed(step_seed(args.seed, it))
        if step_hook is not None:
            step_hook(model, opt, it)
        loss, gnorm, lr = step(it, x, y, gen)
        if it % args.log_every == 0 or it == max_iters - 1:
            logger.update(loss=loss, grad_norm=gnorm, lr=lr)
            print(f"iter {it}/{max_iters}: {logger}", flush=True)
        if args.output_dir and ((it + 1) % args.save_every == 0
                                or it == max_iters - 1):
            save_state(os.path.join(args.output_dir, f"checkpoint-{it + 1}"),
                       model, opt, it + 1)
    stats = {"final_loss": float(loss), "iters": max_iters,
             "time_sec": round(time.time() - t0, 1)}
    _log(args.output_dir, stats)
    return stats


def _log(output_dir: str, stats: Dict[str, Any]):
    if output_dir:
        with open(os.path.join(output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(stats) + "\n")


def cli(argv=None):
    parser = argparse.ArgumentParser(parents=[get_seg_args_parser()])
    return main(parser.parse_args(argv))


if __name__ == "__main__":
    cli()
