"""Distillation CLI of the port: ``python -m slak_tpu_torch.kd.main``, the
counterpart of ``python -m slak_tpu.kd.main`` (the reference's
``main_KD.py``: flags main_KD.py:137-322, the run :338-761).

    python -m slak_tpu_torch.kd.main --model SLaK_tiny \\
        --teacher_kernel_size 51 49 47 13 5 --teacher_width_factor 1.3 \\
        --teacher_ckpt slak_t.pth --model_s convnext_tiny \\
        --distill_type NKD --batch_size 128 --data_path /path/to/imagenet

``--model`` is the teacher: a SLaK / ConvNeXt of the registry (its eval
route, the kernels on the card; ``--teacher_ckpt`` a reference ``.pth``
through ``utils/convert.py``) or a zoo teacher, ``vit_*`` / ``deit_*``,
``swin_*``, ``cswin_*``, ``resnet*``, ``mobilenet*`` / ``efficientnet*``
(``--teacher_ckpt`` a timm ``.pth`` through
``utils/convert_teachers.py``); without a checkpoint its weights are
random from seed 0, as the JAX CLI's ``PRNGKey(0)``. ``--model_s`` is the
student. Every flag of ``slak_tpu``'s parses here with its default; the
train CLI's ``--device``, ``--dist_backend`` and parallel flags
(``--n_devices``, ``--multi_host``) work as they do there
(``train/main.py``; ``train/launch.py --kd`` starts the ranks).

One epoch: the recipe's host transforms in the loader's workers, mixup /
CutMix and random erasing on the device (the global batch's draws under
data parallel), ``kd/engine.py``'s step (AdamW, as the JAX step), the
per-step randomness from a generator seeded from (seed, global step);
then the student's eval and a checkpoint of its state
(``train/checkpoint.py``). As in ``slak_tpu``'s KD CLI, no SNIP loss is
given, so ``--sparse`` needs a ``--sparse_init`` other than ``snip``. TF32
is off for matmuls and cuDNN.
"""

from __future__ import annotations

import argparse
import random
import time
import numpy as np
import torch

from slak_tpu_torch.kd.engine import DISTILL_TYPES
from slak_tpu_torch.train.main import get_args_parser
from slak_tpu_torch.utils import str2bool


def get_kd_args_parser():
    p = argparse.ArgumentParser("SLaK knowledge distillation (PyTorch)",
                                add_help=False, parents=[get_args_parser()],
                                conflict_handler="resolve")
    # teacher (reference: --model is the teacher, --model_s the student)
    p.add_argument("--model", default="SLaK_tiny", type=str,
                   help="teacher model name")
    p.add_argument("--model_s", default="convnext_tiny", type=str,
                   help="student model name")
    p.add_argument("--teacher_ckpt", default="", type=str,
                   help="torch .pth with the teacher's weights")
    p.add_argument("--teacher_kernel_size", default=[51, 49, 47, 13, 5],
                   type=int, nargs="*")
    p.add_argument("--teacher_width_factor", type=float, default=1.3)
    p.add_argument("--teacher_Decom", type=str2bool, default=True)
    # distillation (main_KD.py:150-190)
    p.add_argument("--distill_type", default="NKD", type=str,
                   choices=DISTILL_TYPES)
    p.add_argument("--T", type=float, default=1.0, help="KD temperature")
    p.add_argument("--hard", type=str2bool, default=False)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--FDLoss_type", default="smoothL1",
                   choices=["smoothL1", "MSE"])
    p.add_argument("--lr_fd", type=float, default=1.0)
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return argparse.ArgumentParser(
        "SLaK KD (PyTorch)", parents=[get_kd_args_parser()]).parse_args(argv)


def build_teacher(args, device, dtype):
    """(``teacher_apply``, teacher channels) of ``args.model``
    (``slak_tpu/kd/main.py:71-145``)."""
    from slak_tpu_torch.kd.engine import make_teacher_apply
    from slak_tpu_torch.models import create_model, zoo
    fam = zoo.family_of(args.model)
    if fam is not None:
        if args.teacher_ckpt:
            from slak_tpu_torch.utils.convert_teachers import \
                load_teacher_checkpoint
            kw = {"num_classes": args.nb_classes}
            if fam in ("vit", "swin", "cswin"):
                kw["img_size"] = args.input_size
            teacher = load_teacher_checkpoint(args.teacher_ckpt, args.model,
                                              device, **kw)
            print(f"loaded teacher from {args.teacher_ckpt}")
        else:
            teacher = zoo.create_teacher(args.model, args.nb_classes,
                                         args.input_size, device, seed=0)
        return teacher.teacher_apply(), teacher.feature_channels
    teacher = create_model(
        args.model, device=device, dtype=dtype, seed=0,
        kernel_size=tuple(args.teacher_kernel_size),
        width_factor=args.teacher_width_factor, decom=args.teacher_Decom,
        branch_bn=args.bn, num_classes=args.nb_classes)
    if args.teacher_ckpt:
        from slak_tpu_torch.utils.convert import load_torch_checkpoint
        teacher.load_state_dict(load_torch_checkpoint(args.teacher_ckpt))
        print(f"loaded teacher from {args.teacher_ckpt}")
    return make_teacher_apply(teacher), teacher.cfg.widened_dims[-1]


def main(args):
    """Run the CLI. Returns ``{"max_accuracy", "epochs":
    [per-epoch stats], "step_losses": [the last epoch's], "checkpoints",
    "rank", "world"}``; with ``--n_devices`` > 1 started here, rank 0's."""
    from slak_tpu_torch import resolve_device
    from slak_tpu_torch.data import (BatchLoader, EvalTransform, MixupConfig,
                                     RandomErasingConfig, TrainTransform,
                                     build_dataset)
    from slak_tpu_torch.data.loader import device_prefetch
    from slak_tpu_torch.kd.engine import (KDConfig, init_kd_params,
                                          kd_opt_init, make_kd_train_step)
    from slak_tpu_torch.models import create_model
    from slak_tpu_torch.parallel import mesh
    from slak_tpu_torch.sparsity.masking import MaskConfig
    from slak_tpu_torch.train import checkpoint as ckpt
    from slak_tpu_torch.train.engine import (TrainConfig, create_train_state,
                                             make_eval_step)
    from slak_tpu_torch.train.launch import kd_rank
    from slak_tpu_torch.train.main import (augment, check_parallel_args,
                                           evaluate, spawn_ranks, step_seed)
    from slak_tpu_torch.train.optim import cosine_schedule_array
    from slak_tpu_torch.utils.logging import (EpochLogWriter, MetricLogger,
                                              setup_for_distributed)

    check_parallel_args(args)
    if not mesh.initialized():
        if args.multi_host or mesh.env_rank_world() is not None:
            mesh.init_distributed(args.dist_backend, device=args.device)
        elif (args.n_devices or 1) > 1:
            return spawn_ranks(args, rank_fn=kd_rank)[0]
    world, rank = mesh.world(), mesh.rank()
    if args.n_devices is not None and args.n_devices != world:
        raise ValueError(f"--n_devices {args.n_devices} in a group of "
                         f"{world} ranks")
    group = mesh.axis_group() if mesh.initialized() else None
    device = resolve_device(args.device)
    if group is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if world > 1:
        setup_for_distributed(rank == 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(args)
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)
    cdt = torch.bfloat16 if args.use_bf16 else torch.float32

    teacher_apply, teacher_channels = build_teacher(args, device, cdt)
    # ConvNeXt student = kernel_size [7, 7, 7, 7, 100] (README.md:137)
    student = create_model(args.model_s, device=device, dtype=cdt,
                           seed=args.seed, num_classes=args.nb_classes,
                           drop_path_rate=args.drop_path, remat=args.remat,
                           bn_axis_name=mesh.DATA_AXIS if group is not None
                           else None)
    student_channels = student.cfg.widened_dims[-1]
    print(f"teacher {args.model} ({teacher_channels} feature channels) -> "
          f"student {args.model_s} ({student_channels}), distill "
          f"{args.distill_type}, device {device}"
          + (f", rank {rank} of {world} ({args.dist_backend})"
             if group is not None else ""))

    # data ---------------------------------------------------------------
    train_tf = TrainTransform(size=args.input_size, auto_augment=args.aa)
    eval_tf = EvalTransform(size=args.input_size, crop_pct=args.crop_pct)
    ds_train, nb_classes = build_dataset(
        True, args.data_set, args.data_path, train_tf, args.eval_data_path,
        args.nb_classes, synthetic_len=args.synthetic_len,
        synthetic_size=args.input_size)
    ds_val, _ = build_dataset(
        False, args.data_set, args.data_path, eval_tf, args.eval_data_path,
        args.nb_classes, synthetic_len=max(args.synthetic_len // 4, 8),
        synthetic_size=args.input_size)
    pin = device.type == "cuda"
    dl_train = BatchLoader(ds_train, args.batch_size, shuffle=True,
                           num_workers=args.num_workers, seed=args.seed,
                           rank=rank, world_size=world,
                           mode=args.loader_mode, pin_memory=pin)
    dl_val = BatchLoader(ds_val, args.batch_size, shuffle=False,
                         drop_last=False, num_workers=args.num_workers,
                         rank=rank, world_size=world, mode=args.loader_mode,
                         pin_memory=pin, pad=False)
    niter_per_ep = len(dl_train)
    if niter_per_ep == 0:
        raise ValueError(f"dataset ({len(ds_train)} images) is smaller than "
                         f"one global batch ({args.batch_size * world})")
    total_steps = args.epochs * niter_per_ep

    # configs --------------------------------------------------------------
    mask_cfg = None
    if args.sparse:
        mask_cfg = MaskConfig(
            sparsity=args.sparsity, sparse_init=args.sparse_init,
            prune_mode=args.prune, growth_mode=args.growth,
            prune_rate=args.prune_rate,
            update_frequency=args.update_frequency, fix=args.fix,
            only_L=args.only_L)
    train_cfg = TrainConfig(
        weight_decay=args.weight_decay, smoothing=args.smoothing,
        update_freq=args.update_freq, clip_grad=args.clip_grad,
        ema_decay=args.model_ema_decay if args.model_ema else None,
        layer_decay=args.layer_decay if args.layer_decay < 1.0 else None,
        compute_dtype=cdt, prune_t_max=total_steps)
    kd_cfg = KDConfig(distill_type=args.distill_type, temp=args.T,
                      hard=args.hard, alpha=args.alpha,
                      fd_loss_type=args.FDLoss_type, lr_fd=args.lr_fd)

    state = create_train_state(student, train_cfg, mask_cfg, seed=args.seed,
                               group=group)
    kd_params = init_kd_params(torch.Generator().manual_seed(args.seed + 1),
                               kd_cfg, student_channels, teacher_channels,
                               device)
    kd_opt = kd_opt_init(kd_params)
    # every rank built the same weights; rank 0's are the run's
    mesh.replicate(student)
    mesh.replicate(kd_params)

    lr_sched = cosine_schedule_array(
        args.lr, args.min_lr, args.epochs, niter_per_ep,
        warmup_epochs=args.warmup_epochs, warmup_steps=args.warmup_steps)
    step = make_kd_train_step(student, teacher_apply, kd_cfg, train_cfg,
                              mask_cfg, lr_sched, None, group=group)
    eval_step = make_eval_step(student, cdt)
    mixup_cfg = MixupConfig(
        mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
        switch_prob=args.mixup_switch_prob, mode=args.mixup_mode,
        label_smoothing=args.smoothing, num_classes=nb_classes)
    re_cfg = RandomErasingConfig(prob=args.reprob)
    gen = torch.Generator(device=device)

    epoch_log = EpochLogWriter(args.output_dir if rank == 0 else None)
    save_dir = args.output_dir if args.output_dir and args.save_ckpt \
        else None
    run = {"rank": rank, "world": world, "checkpoints": [], "epochs": []}
    max_acc = 0.0
    for epoch in range(args.epochs):
        dl_train.set_epoch(epoch)
        logger = MetricLogger()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_ep, n_img = time.time(), 0
        step_losses = []
        for i, (x, y) in enumerate(logger.log_every(
                device_prefetch(iter(dl_train), device), args.print_freq,
                f"Epoch: [{epoch}]")):
            gen.manual_seed(step_seed(args.seed, epoch * niter_per_ep + i))
            n_img += x.shape[0] * world
            x, t = augment(gen, x, y, mixup_cfg, re_cfg, group)
            if state.mask_state is not None:
                state.mask_state.generator = gen
            state, kd_params, kd_opt, m = step(state, kd_params, kd_opt,
                                               (x, t), gen)
            step_losses.append(m["loss"])
            logger.update(loss=m["loss"], lr=m["lr"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ips = n_img / (time.time() - t_ep)
        run["step_losses"] = torch.stack(step_losses).tolist()
        test_stats = evaluate(eval_step, dl_val, device, group)
        max_acc = max(max_acc, test_stats["acc1"])
        print(f"epoch {epoch}: loss={logger.meters['loss'].global_avg:.4f} "
              f"acc1={test_stats['acc1'] * 100:.2f}% ({ips:.1f} img/s with "
              f"the loader feeding)")
        if save_dir and ((epoch + 1) % args.save_ckpt_freq == 0
                         or epoch + 1 == args.epochs):
            run["checkpoints"].append(ckpt.save_checkpoint(
                save_dir, state, epoch, save_ckpt_freq=args.save_ckpt_freq,
                save_ckpt_num=args.save_ckpt_num))
        stats = {"epoch": epoch, "distill_type": args.distill_type,
                 "train_loss": logger.meters["loss"].global_avg,
                 "test_acc1": test_stats["acc1"],
                 "test_images": test_stats["n"], "images_per_sec": ips}
        epoch_log.write(stats)
        run["epochs"].append(stats)
    print(f"Max accuracy: {max_acc * 100:.2f}%")
    run["checkpoints"] = [c for c in run["checkpoints"] if c is not None]
    return dict(run, max_accuracy=max_acc)


def cli():
    main(parse_args())


if __name__ == "__main__":
    cli()
