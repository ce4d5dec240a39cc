"""Training CLI of the port: ``python -m slak_tpu_torch.train.main``, the
counterpart of ``python -m slak_tpu.train.main`` (the reference's
``main.py``) on one device.

    python -m slak_tpu_torch.train.main --model SLaK_tiny --Decom true \\
        --kernel_size 51 49 47 13 5 --width_factor 1.3 -u 2000 \\
        --sparse --prune_rate 0.5 --sparsity 0.4 \\
        --batch_size 64 --lr 4e-3 --epochs 300 \\
        --data_path /path/to/imagenet --data_set IMNET

Every flag of ``slak_tpu``'s parses here with its default and meaning;
``--device`` (default: the CUDA card, through ``resolve_device``; the
tests pass ``cpu``) and ``--dist_backend`` are the port's own.

Data parallel with SyncBN (``parallel/``), one process a rank:
``--n_devices N`` starts N local ranks (``train/launch.py``), ``--multi_host``
(or a ``torchrun`` environment) makes this process one rank of an env://
rendezvous; ``--dist_backend`` is ``nccl`` (one card a rank) or ``gloo``
(CPU ranks, or ranks sharing a card), never chosen silently.
``--batch_size`` stays per rank, as in ``slak_tpu``: a step's global batch is
``batch_size x update_freq x ranks``, rank r's share the r-th of each
global batch's shards (``ShardedBatchSampler``'s order). Mixup / CutMix,
random erasing and drop path draw for the whole global batch (the images
and labels gathered from every rank) and each rank keeps its rows; the
branch BNs average their statistics over the ranks and the step averages
the gradients, so a step computes the one-process step on the
concatenated batch. The val images are split over the ranks, each visited
once, and the sums of loss, hits and images all-reduced. Only rank 0
prints, logs and writes checkpoints. ``--tp_eval`` with ``--eval`` runs the
eval channel-parallel over the ranks (``parallel/tp.py``), every rank on
every val image.

One epoch: the loader's batches (host transforms in its workers) are
copied to the device ahead of use; mixup / CutMix and random erasing run
there; the train step is ``engine.make_train_step`` and evaluation
``engine.make_eval_step`` (the kernels on the card, their plain versions
on the CPU). The per-step randomness (mixup, erasing, drop path, DST
growth) comes from one generator seeded from (seed, global step), so a
resumed run draws what an uninterrupted one would have drawn. A
checkpoint holds the rest of the state (``train/checkpoint.py``). TF32 is
off for matmuls and cuDNN: the JAX package's fp32 is exact fp32.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import os
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from slak_tpu_torch.utils import str2bool


def get_args_parser():
    p = argparse.ArgumentParser("SLaK training and evaluation (PyTorch)",
                                add_help=False)
    # engine
    p.add_argument("--batch_size", default=64, type=int,
                   help="per-device batch size")
    p.add_argument("--epochs", default=300, type=int)
    p.add_argument("--update_freq", default=1, type=int,
                   help="gradient accumulation steps")
    p.add_argument("--use_bf16", type=str2bool, default=True)

    # model
    p.add_argument("--model", default="SLaK_tiny", type=str)
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--input_size", default=224, type=int)
    p.add_argument("--layer_scale_init_value", default=1e-6, type=float)
    p.add_argument("--kernel_size", default=[51, 49, 47, 13, 5], type=int,
                   nargs="*", help="4 stage kernels + small kernel")
    p.add_argument("--width_factor", type=float, default=1.0)
    p.add_argument("--Decom", type=str2bool, default=False)
    p.add_argument("--bn", type=str2bool, default=True,
                   help="BN after each large-kernel branch")
    p.add_argument("--head_init_scale", default=1.0, type=float)

    # sparsity (main.py:207-221)
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--sparsity", type=float, default=0.4)
    p.add_argument("--sparse_init", type=str, default="snip",
                   choices=["uniform", "ERK", "snip", "resume"])
    p.add_argument("--prune", type=str, default="magnitude")
    p.add_argument("--growth", type=str, default="random")
    p.add_argument("--redistribution", type=str, default="none")
    p.add_argument("--prune_rate", type=float, default=0.3)
    p.add_argument("-u", "--update_frequency", type=int, default=100,
                   metavar="N", help="prune/grow every N steps")
    p.add_argument("--fix", action="store_true",
                   help="static sparsity (no DST updates)")
    p.add_argument("--only_L", action="store_true",
                   help="sparsify only the LoRA branches")

    # EMA
    p.add_argument("--model_ema", type=str2bool, default=False)
    p.add_argument("--model_ema_decay", type=float, default=0.9999)
    p.add_argument("--model_ema_eval", type=str2bool, default=False)

    # optimizer
    p.add_argument("--opt", default="adamw", type=str,
                   choices=["adamw", "adan"],
                   help="optimizer (reference main.py:78; 'adan' is the "
                        "fork-registered Adaptive Nesterov optimizer)")
    p.add_argument("--opt_eps", default=1e-8, type=float)
    p.add_argument("--opt_betas", default=None, type=float, nargs="+",
                   help="override optimizer betas (2 for adamw, 3 for adan)")
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--weight_decay_end", type=float, default=None)
    p.add_argument("--lr", type=float, default=4e-3)
    p.add_argument("--layer_decay", type=float, default=1.0)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--warmup_epochs", type=int, default=20)
    p.add_argument("--warmup_steps", type=int, default=-1)

    # augmentation (main.py:117-160)
    p.add_argument("--color_jitter", type=float, default=0.4)
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--train_interpolation", type=str, default="bicubic",
                   choices=["bicubic", "bilinear", "random"])
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--remode", type=str, default="pixel",
                   choices=["pixel", "rand", "const"])
    p.add_argument("--recount", type=int, default=1)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--cutmix_minmax", type=float, nargs="+", default=None,
                   help="cutmix min/max box-side fractions; overrides the "
                        "lam-derived box when set")
    p.add_argument("--mixup_prob", type=float, default=1.0)
    p.add_argument("--mixup_switch_prob", type=float, default=0.5)
    p.add_argument("--mixup_mode", type=str, default="batch",
                   choices=["batch", "pair", "elem"])
    p.add_argument("--crop_pct", type=float, default=0.875)

    # dataset
    p.add_argument("--data_path", default=None, type=str)
    p.add_argument("--eval_data_path", default=None, type=str)
    p.add_argument("--imagenet_default_mean_and_std", type=str2bool,
                   default=True,
                   help="False -> inception (0.5, 0.5, 0.5) normalization")
    p.add_argument("--nb_classes", default=1000, type=int)
    p.add_argument("--data_set", default="IMNET", type=str,
                   choices=["CIFAR", "IMNET", "image_folder", "synthetic"])
    p.add_argument("--num_workers", default=16, type=int)
    p.add_argument("--loader_mode", default="thread",
                   choices=["thread", "process"],
                   help="host input pipeline workers: threads in this "
                        "process, or a torch DataLoader's spawned worker "
                        "processes")
    p.add_argument("--synthetic_len", default=1024, type=int,
                   help="synthetic dataset length (smoke/bench runs)")

    # checkpointing / misc
    p.add_argument("--output_dir", default="")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--resume", default="",
                   help="a checkpoint of this CLI, or a reference .pth")
    p.add_argument("--auto_resume", type=str2bool, default=True)
    p.add_argument("--save_ckpt", type=str2bool, default=True)
    p.add_argument("--save_ckpt_freq", default=1, type=int)
    p.add_argument("--save_ckpt_num", default=3, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--start_epoch", default=None, type=int,
                   help="override the resume-derived starting epoch")
    p.add_argument("--eval", type=str2bool, default=False)
    p.add_argument("--disable_eval", type=str2bool, default=False,
                   help="skip the per-epoch validation pass")
    p.add_argument("--verbose", action="store_true",
                   help="per-layer sparsity densities each epoch")
    p.add_argument("--tp_eval", type=str2bool, default=False,
                   help="channel/tensor-parallel eval over the ranks "
                        "(with --eval)")
    p.add_argument("--finetune", default="", help="torch ckpt to load")
    p.add_argument("--model_key", default="model|module", type=str,
                   help="'|'-separated state-dict keys tried when "
                        "unwrapping --finetune checkpoints")
    p.add_argument("--model_prefix", default="", type=str,
                   help="prefix stripped from --finetune state-dict keys")
    p.add_argument("--enable_wandb", type=str2bool, default=False)
    p.add_argument("--project", default="SLaK", type=str,
                   help="wandb project name")
    p.add_argument("--wandb_ckpt", type=str2bool, default=False,
                   help="upload checkpoints as wandb artifacts at the end")
    p.add_argument("--n_devices", default=None, type=int,
                   help="ranks of the data-parallel run (one process and "
                        "device a rank; more than one starts them through "
                        "train/launch.py)")
    p.add_argument("--multi_host", type=str2bool, default=False,
                   help="this process is one rank of an env:// rendezvous "
                        "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                        "MASTER_PORT)")
    p.add_argument("--print_freq", default=200, type=int)
    p.add_argument("--remat", type=str2bool, default=False,
                   help="per-block activation rematerialization "
                        "(torch.utils.checkpoint) in the train forward: "
                        "one more block forward in the backward for "
                        "the activations' memory; no reference analog")
    p.add_argument("--profile_dir", default="", type=str,
                   help="trace steps 10..20 of the first epoch with "
                        "torch.profiler into this directory (a Chrome "
                        "trace)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    p.add_argument("--dist_backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="process-group backend of a run over several ranks "
                        "(reference utils.py:252-332): nccl, one card a "
                        "rank; gloo for CPU ranks or ranks sharing a card")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("SLaK (PyTorch)",
                                     parents=[get_args_parser()])
    return parser.parse_args(argv)


def check_parallel_args(args):
    """Raise, before any rank starts, for flags of runs over several ranks
    that cannot run as given."""
    if args.tp_eval and not args.eval:
        raise ValueError("--tp_eval is the channel-parallel eval: it runs "
                         "with --eval true")
    n = args.n_devices or 1
    if n > 1 and args.dist_backend == "nccl":
        dev = torch.device(args.device or "cuda")
        if dev.type != "cuda":
            raise ValueError(f"--dist_backend nccl needs CUDA devices, not "
                             f"{dev}; pass --dist_backend gloo")
        if torch.cuda.device_count() < n:
            raise ValueError(
                f"--dist_backend nccl takes one card a rank: {n} ranks, "
                f"{torch.cuda.device_count()} card(s); pass --dist_backend "
                f"gloo to share a card")


def spawn_ranks(args, timeout_s: Optional[float] = None,
                rank_fn: Optional[Callable] = None) -> list:
    """Run the CLI (``rank_fn``, by default ``launch.train_rank``) on
    ``args.n_devices`` spawned local ranks (``train/launch.py``); their
    results in rank order. ``timeout_s`` bounds the run and each
    collective."""
    from slak_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S
    from slak_tpu_torch.train.launch import run_ranks, train_rank
    return run_ranks(rank_fn or train_rank, args.n_devices, (args,),
                     args.dist_backend, args.device, timeout_s,
                     timeout_s if timeout_s is not None else
                     DEFAULT_TIMEOUT_S)


def step_seed(seed: int, step: int) -> int:
    """The seed of global step ``step``'s generator."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> 1)


def build_model(args, device, dtype, bn_axis_name=None):
    from slak_tpu_torch.models import create_model
    return create_model(
        args.model, device=device, dtype=dtype, seed=args.seed,
        kernel_size=tuple(args.kernel_size), width_factor=args.width_factor,
        decom=args.Decom, branch_bn=args.bn, num_classes=args.nb_classes,
        drop_path_rate=args.drop_path,
        layer_scale_init_value=args.layer_scale_init_value,
        head_init_scale=args.head_init_scale, remat=args.remat,
        bn_axis_name=bn_axis_name)


def evaluate(eval_step, loader, device, group=None) -> dict:
    """Loss, top-1 and top-5 over ``loader``, weighted by batch size, and
    the image count ``n``; the sums stay on the device until the end, and
    are summed over ``group`` (each rank's share of the val images) when
    one is given."""
    from slak_tpu_torch.data.loader import device_prefetch
    from slak_tpu_torch.parallel.mesh import all_reduce_
    tot = torch.zeros(4, dtype=torch.float64, device=device)
    for batch in device_prefetch(iter(loader), device):
        m = eval_step(batch)
        n = m["n"].to(device)
        tot += torch.stack([m["loss"] * n, m["acc1"] * n, m["acc5"] * n,
                            n]).double()
    if group is not None:
        all_reduce_([tot], "sum", group)
    loss, acc1, acc5, n = tot.tolist()
    d = max(n, 1.0)
    return {"loss": loss / d, "acc1": acc1 / d, "acc5": acc5 / d, "n": n}


def make_tp_eval_step(model, compute_dtype):
    """``engine.make_eval_step``'s metrics from the channel-parallel
    forward over the world group (``parallel/tp.py``)."""
    from slak_tpu_torch.parallel.tp import make_tp_apply
    from slak_tpu_torch.train import losses as L
    tp = make_tp_apply(model)
    device = next(model.parameters()).device

    def eval_step(batch):
        images, labels = batch
        labels = labels.to(device)
        logits = tp(images.to(device=device, dtype=compute_dtype))
        return {"logits": logits,
                "loss": L.cross_entropy(logits, labels),
                "acc1": L.accuracy_topk(logits, labels, 1),
                "acc5": L.accuracy_topk(logits, labels, 5),
                "n": torch.tensor(float(labels.shape[0]))}

    return eval_step


def augment(gen, x, y, mixup_cfg, re_cfg, group=None):
    """Mixup / CutMix, then random erasing, drawn from ``gen``: (images,
    targets). Under data parallel (``group``) the draws are the global
    batch's (the ranks' batches gathered) and this rank keeps its rows."""
    from slak_tpu_torch.data import mixup_cutmix, random_erasing
    from slak_tpu_torch.parallel import mesh
    mix = mixup_cfg.enabled or re_cfg.prob > 0
    if mix and group is not None:
        x = mesh.all_gather_cat(x, 0, group)
        y = mesh.all_gather_cat(y, 0, group)
    if mixup_cfg.enabled:
        x, t = mixup_cutmix(gen, x, y, mixup_cfg)
    else:
        t = y
    if re_cfg.prob > 0:
        x = random_erasing(gen, x, re_cfg)
    if mix and group is not None:
        x, t = mesh.shard_batch((x, t), mesh.rank(group), mesh.world(group))
    return x, t


def ema_model(model, ema):
    """A copy of ``model`` holding the EMA's parameters and BN stats."""
    out = copy.deepcopy(model)
    out.load_state_dict({k: v.to(t.dtype) for k, v, t in (
        (k, ema[k], t) for k, t in out.state_dict().items() if k in ema)},
        strict=False)
    return out


def main(args, step_hook: Optional[Callable] = None):
    """Run the CLI. ``step_hook(state, epoch, i)``, when given, is called
    before each train step (a test or smoke script reading the state a
    step starts from). Returns ``{"max_accuracy", "epochs": [per-epoch
    stats], "step_losses": [the last epoch's per-step losses],
    "checkpoints": [the paths this rank wrote], "rank", "world",
    "host_path", "loader"}`` (with ``--eval``, the eval stats); with
    ``--n_devices`` > 1 started here, rank 0's."""
    from slak_tpu_torch import resolve_device
    from slak_tpu_torch.data import (BatchLoader, EvalTransform,
                                     MixupConfig, RandomErasingConfig,
                                     TrainTransform, build_dataset)
    from slak_tpu_torch.data.loader import device_prefetch
    from slak_tpu_torch.parallel import mesh
    from slak_tpu_torch.sparsity.masking import MaskConfig, sparsity_report
    from slak_tpu_torch.train import checkpoint as ckpt
    from slak_tpu_torch.train import losses as L
    from slak_tpu_torch.train.engine import (TrainConfig, create_train_state,
                                             make_eval_step, make_train_step)
    from slak_tpu_torch.train.optim import cosine_schedule_array
    from slak_tpu_torch.utils.convert import load_torch_checkpoint
    from slak_tpu_torch.utils.logging import (EpochLogWriter, MetricLogger,
                                              SmoothedValue,
                                              setup_for_distributed)

    check_parallel_args(args)
    if not mesh.initialized():
        if args.multi_host or mesh.env_rank_world() is not None:
            mesh.init_distributed(args.dist_backend, device=args.device)
        elif (args.n_devices or 1) > 1:
            return spawn_ranks(args)[0]
    world, rank = mesh.world(), mesh.rank()
    if args.n_devices is not None and args.n_devices != world:
        raise ValueError(f"--n_devices {args.n_devices} in a group of "
                         f"{world} ranks")
    if args.tp_eval and not mesh.initialized():
        raise ValueError("--tp_eval runs over the ranks of a process group: "
                         "pass --n_devices N or start the ranks with "
                         "train/launch.py")
    group = mesh.axis_group() if mesh.initialized() else None
    device = resolve_device(args.device)
    if group is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if world > 1:
        setup_for_distributed(rank == 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(args)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + (f"; rank {rank} of {world} ({args.dist_backend})"
             if group is not None else ""))
    global_batch = args.batch_size * args.update_freq * world
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)
    cdt = torch.bfloat16 if args.use_bf16 else torch.float32
    model = build_model(args, device, cdt,
                        mesh.DATA_AXIS if group is not None else None)

    # data ---------------------------------------------------------------
    train_tf = TrainTransform(size=args.input_size, auto_augment=args.aa,
                              color_jitter_amount=args.color_jitter,
                              interpolation=args.train_interpolation,
                              imagenet_mean_and_std=
                              args.imagenet_default_mean_and_std)
    eval_tf = EvalTransform(size=args.input_size, crop_pct=args.crop_pct,
                            imagenet_mean_and_std=
                            args.imagenet_default_mean_and_std)
    ds_train, nb_classes = build_dataset(
        True, args.data_set, args.data_path, train_tf, args.eval_data_path,
        args.nb_classes, synthetic_len=args.synthetic_len,
        synthetic_size=args.input_size)
    ds_val, _ = build_dataset(
        False, args.data_set, args.data_path, eval_tf, args.eval_data_path,
        args.nb_classes, synthetic_len=max(args.synthetic_len // 4, 8),
        synthetic_size=args.input_size)
    pin = device.type == "cuda"
    # a rank's share of each global batch; the val images split over the
    # ranks without wrap-around padding (each visited once), or all of them
    # on every rank for the channel-parallel eval
    dl_train = BatchLoader(ds_train, args.batch_size * args.update_freq,
                           shuffle=True, num_workers=args.num_workers,
                           seed=args.seed, rank=rank, world_size=world,
                           mode=args.loader_mode, pin_memory=pin)
    val_split = group is not None and not args.tp_eval
    dl_val = BatchLoader(ds_val, args.batch_size, shuffle=False,
                         drop_last=False, num_workers=args.num_workers,
                         rank=rank if val_split else 0,
                         world_size=world if val_split else 1,
                         mode=args.loader_mode, pin_memory=pin, pad=False)
    val_group = group if val_split else None
    niter_per_ep = len(dl_train)
    total_steps = args.epochs * niter_per_ep
    host_path = train_tf.host_path()
    loader_desc = (f"{args.loader_mode}, "
                   f"{min(dl_train.num_workers, niter_per_ep)} workers")
    print(f"{len(ds_train)} train / {len(ds_val)} val images, "
          f"{niter_per_ep} steps/epoch, global batch {global_batch}; host "
          f"transform path {host_path}; loader {loader_desc}")
    if niter_per_ep == 0:
        raise ValueError(
            f"dataset ({len(ds_train)} images) is smaller than one global "
            f"batch ({global_batch} = batch_size x update_freq x ranks); "
            f"reduce --batch_size / --update_freq")

    # configs --------------------------------------------------------------
    mask_cfg = None
    if args.sparse:
        mask_cfg = MaskConfig(
            sparsity=args.sparsity, sparse_init=args.sparse_init,
            prune_mode=args.prune, growth_mode=args.growth,
            redistribution_mode=args.redistribution,
            prune_rate=args.prune_rate,
            update_frequency=args.update_frequency, fix=args.fix,
            only_L=args.only_L)
    train_cfg = TrainConfig(
        weight_decay=args.weight_decay, smoothing=args.smoothing,
        update_freq=args.update_freq, clip_grad=args.clip_grad,
        opt=args.opt, opt_eps=args.opt_eps,
        opt_betas=tuple(args.opt_betas) if args.opt_betas else None,
        ema_decay=args.model_ema_decay if args.model_ema else None,
        layer_decay=args.layer_decay if args.layer_decay < 1.0 else None,
        compute_dtype=cdt, prune_t_max=total_steps)

    # state ----------------------------------------------------------------
    snip_loss_fn = None
    if args.sparse and args.sparse_init == "snip":
        # SNIP scores the first batch through the eval forward of the
        # fresh weights, in the loader's float32 (slak_tpu main.py:318-327)
        x0, y0 = next(iter(dl_train))
        x0 = x0.to(device).permute(0, 3, 1, 2).contiguous()
        y0 = y0.to(device)

        def snip_loss_fn():
            model.eval()
            try:
                logits = model._logits(x0, False, None)
            finally:
                model.train()
            return L.cross_entropy(logits, y0)

    state = create_train_state(model, train_cfg, mask_cfg, snip_loss_fn,
                               seed=args.seed, group=group)
    snip_loss_fn = None

    if args.finetune:
        model.load_state_dict(load_torch_checkpoint(
            args.finetune, model_key=args.model_key,
            model_prefix=args.model_prefix))
        print(f"loaded torch checkpoint {args.finetune}")

    start_epoch = 0
    if args.output_dir and args.auto_resume and not args.resume:
        state, start_epoch = ckpt.auto_load(args.output_dir, state)
        if start_epoch:
            print(f"auto-resumed from epoch {start_epoch - 1}")
    elif args.resume:
        epoch = ckpt.load_into(args.resume, state, args.model_key,
                               args.model_prefix)
        start_epoch = 0 if epoch is None else epoch + 1
        print(f"resumed from {args.resume}")
    if args.start_epoch is not None:
        start_epoch = args.start_epoch
    # every rank built or read the same weights; rank 0's are the run's
    mesh.replicate(model)

    lr_sched = cosine_schedule_array(
        args.lr, args.min_lr, args.epochs, niter_per_ep,
        warmup_epochs=args.warmup_epochs, warmup_steps=args.warmup_steps)
    wd_end = args.weight_decay_end if args.weight_decay_end is not None \
        else args.weight_decay
    wd_sched = cosine_schedule_array(args.weight_decay, wd_end, args.epochs,
                                     niter_per_ep)
    train_step = make_train_step(model, train_cfg, mask_cfg, lr_sched,
                                 wd_sched, group=group)
    eval_step = make_eval_step(model, cdt)
    run = {"host_path": host_path, "loader": loader_desc, "rank": rank,
           "world": world, "checkpoints": []}

    if args.eval:
        if args.tp_eval:
            eval_step = make_tp_eval_step(model, cdt)
        stats = evaluate(eval_step, dl_val, device, val_group)
        print(f"Accuracy of the network: top-1 {stats['acc1']*100:.2f}%, "
              f"top-5 {stats['acc5']*100:.2f}%")
        return dict(stats, **run)

    mixup_cfg = MixupConfig(
        mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
        cutmix_minmax=(tuple(args.cutmix_minmax)
                       if args.cutmix_minmax else None),
        prob=args.mixup_prob, switch_prob=args.mixup_switch_prob,
        mode=args.mixup_mode, label_smoothing=args.smoothing,
        num_classes=nb_classes)
    re_cfg = RandomErasingConfig(prob=args.reprob, count=args.recount,
                                 mode=args.remode)
    gen = torch.Generator(device=device)

    # train loop -------------------------------------------------------------
    log_writer = None
    if args.log_dir and rank == 0:
        from slak_tpu_torch.utils.logging import TensorboardLogger
        log_writer = TensorboardLogger(args.log_dir)
    wandb_logger = None
    if args.enable_wandb and rank == 0:
        from slak_tpu_torch.utils.logging import WandbLogger
        wandb_logger = WandbLogger(args, args.project)
        wandb_logger.set_steps()
    epoch_log = EpochLogWriter(args.output_dir if rank == 0 else None)
    save_dir = args.output_dir if args.output_dir and args.save_ckpt \
        else None
    max_acc = max_acc_ema = 0.0
    run["epochs"] = []
    print(f"Start training for {args.epochs} epochs")
    t_start = time.time()
    for epoch in range(start_epoch, args.epochs):
        dl_train.set_epoch(epoch)
        logger = MetricLogger()
        logger.add_meter("lr", SmoothedValue(1, "{value:.6f}"))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_ep = time.time()
        n_img = 0
        prof = None
        step_losses = []
        for i, (x, y) in enumerate(logger.log_every(
                device_prefetch(iter(dl_train), device), args.print_freq,
                f"Epoch: [{epoch}]")):
            if args.profile_dir and epoch == start_epoch:
                if i == 10:
                    prof = _start_profile(device)
                elif i == 20 and prof is not None:
                    _stop_profile(prof, args.profile_dir, device)
                    prof = None
            gen.manual_seed(step_seed(args.seed, epoch * niter_per_ep + i))
            n_img += x.shape[0] * world
            x, t = augment(gen, x, y, mixup_cfg, re_cfg, group)
            if state.mask_state is not None:
                state.mask_state.generator = gen
            if step_hook is not None:
                step_hook(state, epoch, i)
            state, metrics = train_step(state, (x, t), gen)
            step_losses.append(metrics["loss"])
            logger.update(loss=metrics["loss"], lr=metrics["lr"],
                          grad_norm=metrics["grad_norm"])
            if log_writer and i % args.print_freq == 0:
                log_writer.update(head="train", step=state.step,
                                  loss=float(metrics["loss"]),
                                  lr=float(metrics["lr"]))
        if prof is not None:                 # epoch shorter than the window
            _stop_profile(prof, args.profile_dir, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sec = time.time() - t_ep
        ips = n_img / sec
        step_ms = 1e3 * sec / max(niter_per_ep, 1)
        run["step_losses"] = torch.stack(step_losses).tolist() \
            if step_losses else []
        print(f"epoch {epoch}: {ips:.1f} images/sec, {step_ms:.1f} ms/step "
              f"with the loader feeding"
              + (f" ({world} ranks, {args.dist_backend})" if group is not None
                 else ""))

        if state.mask_state is not None:
            rep = sparsity_report(state.mask_state)
            print(f"sparsity: density={rep['density']:.4f} "
                  f"fired={rep['fired_ratio']:.4f}")
            if args.verbose:
                for name, dens in rep["layers"].items():
                    print(f"  {name}: density {dens:.4f}")

        if save_dir and ((epoch + 1) % args.save_ckpt_freq == 0
                         or epoch + 1 == args.epochs):
            run["checkpoints"].append(ckpt.save_checkpoint(
                save_dir, state, epoch, save_ckpt_freq=args.save_ckpt_freq,
                save_ckpt_num=args.save_ckpt_num))

        stats = {"epoch": epoch,
                 "train_loss": logger.meters["loss"].global_avg,
                 "images_per_sec": ips, "step_ms": step_ms}
        if not args.disable_eval:
            test_stats = evaluate(eval_step, dl_val, device, val_group)
            print(f"Accuracy on {len(ds_val)} val images: "
                  f"{test_stats['acc1']*100:.2f}%")
            if test_stats["acc1"] > max_acc:
                max_acc = test_stats["acc1"]
                if save_dir:
                    run["checkpoints"].append(ckpt.save_checkpoint(
                        save_dir, state, epoch, tag="best"))
            print(f"Max accuracy: {max_acc*100:.2f}%")
            stats.update(test_acc1=test_stats["acc1"],
                         test_acc5=test_stats["acc5"],
                         test_loss=test_stats["loss"],
                         test_images=test_stats["n"])

        if args.model_ema and args.model_ema_eval and not args.disable_eval:
            em = ema_model(model, state.ema)
            ema_stats = evaluate(make_eval_step(em, cdt), dl_val, device,
                                 val_group)
            del em
            print(f"EMA accuracy: {ema_stats['acc1']*100:.2f}%")
            if ema_stats["acc1"] > max_acc_ema:
                max_acc_ema = ema_stats["acc1"]
                if save_dir:
                    run["checkpoints"].append(ckpt.save_checkpoint(
                        save_dir, state, epoch, tag="best-ema"))
            stats["test_acc1_ema"] = ema_stats["acc1"]

        epoch_log.write(stats)
        run["epochs"].append(stats)
        if log_writer is not None:
            log_writer.flush()
        if wandb_logger is not None:
            wandb_logger.log_epoch_metrics(stats)

    if (wandb_logger is not None and args.wandb_ckpt and args.save_ckpt
            and args.output_dir):
        wandb_logger.log_checkpoints(args.output_dir)
    run["checkpoints"] = [c for c in run["checkpoints"] if c is not None]
    total = time.time() - t_start
    print(f"Training time {datetime.timedelta(seconds=int(total))}")
    return dict(run, max_accuracy=max_acc)


def _start_profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, profile_dir, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def cli():
    main(parse_args())


if __name__ == "__main__":
    cli()
