"""Train and eval steps: port of ``slak_tpu/train/engine.py`` (the
reference's engine.py:17-178 plus ``mask.step()``, sparse_core.py:300-313).

One call of the step from :func:`make_train_step`:
  1. writes this iteration's lr and weight decay (from the schedule
     arrays) into the optimizer's groups;
  2. runs forward + backward over ``update_freq`` micro-batches, the
     gradients summed and divided by ``update_freq`` (BN running stats
     carry from one micro-batch to the next); under data parallel (a
     process ``group``, the counterpart of ``pmean_axis``) the batch is
     this rank's shard of the global batch, drop-path draws are the global
     batch's, and the gradients and the loss are then averaged over the
     group in a few flat buffers;
  3. takes the global gradient norm, clips (when ``clip_grad``), and runs
     the AdamW or Adan step;
  4. masks the weights, and every ``update_frequency`` optimizer steps
     prunes and regrows them at the cosine-decayed prune rate (momentum
     growth reads the updated Adam moments, gradient growth the unclipped
     gradients);
  5. updates the sparse-aware EMA of parameters and BN running stats.
``train_cfg.pack_params`` has no counterpart: ``train/packing.py`` exists
to cut XLA's per-leaf op storm, which eager PyTorch does not have.

The model, optimizer, masks and EMA live in a :class:`TrainState` that the
step updates in place and returns; metrics are device tensors (``loss``,
``lr``, ``grad_norm``, ``weight_decay``), read without a host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from slak_tpu_torch.models.layers import global_batch_shard
from slak_tpu_torch.models.slak import SLaK, apply
from slak_tpu_torch.parallel.mesh import all_reduce_
from slak_tpu_torch.sparsity.masking import (MaskConfig, MaskState,
                                             apply_mask, cosine_prune_rate,
                                             init_masks, truncate_weights)
from slak_tpu_torch.train import losses as L
from slak_tpu_torch.train.ema import ema_init, ema_update
from slak_tpu_torch.train.optim import (ADAN_BETAS, adam_momentum,
                                        clip_grads, global_grad_norm,
                                        make_adamw, make_adan, param_groups,
                                        set_lr_wd)

OPTIMIZERS = ("adamw", "adan")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Recipe constants (reference README.md:102-135, main.py:94-221)."""
    weight_decay: float = 0.05
    smoothing: float = 0.1
    update_freq: int = 1
    clip_grad: Optional[float] = None
    ema_decay: Optional[float] = None      # 0.9999 when EMA is on
    layer_decay: Optional[float] = None
    compute_dtype: Any = torch.float32     # torch.bfloat16 on the card
    opt: str = "adamw"
    opt_eps: float = 1e-8
    opt_betas: Optional[tuple] = None
    prune_t_max: int = 0                   # DST cosine horizon (steps)


@dataclasses.dataclass
class TrainState:
    model: SLaK
    optimizer: torch.optim.Optimizer
    step: int = 0
    mask_state: Optional[MaskState] = None
    ema: Optional[Dict[str, torch.Tensor]] = None

    def named_params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def create_train_state(model: SLaK, train_cfg: TrainConfig,
                       mask_cfg: Optional[MaskConfig] = None,
                       snip_loss_fn: Optional[Callable[[], torch.Tensor]]
                       = None, masks: Optional[Dict[str, torch.Tensor]]
                       = None, seed: int = 0, group=None) -> TrainState:
    """Put ``model`` in train mode; build its masks (``masks`` given, or by
    ``mask_cfg.sparse_init``; ``snip`` needs ``snip_loss_fn``, the loss of
    one batch with the current weights, its gradients averaged over
    ``group`` when one is given), mask the weights, then the optimizer
    (``train_cfg.opt``: AdamW or Adan) and the EMA. The masks' random
    draws come from a generator on the model's device seeded with
    ``seed`` (the same on every rank)."""
    if train_cfg.opt not in OPTIMIZERS:
        raise ValueError(f"optimizer {train_cfg.opt!r}: one of "
                         f"{'/'.join(OPTIMIZERS)}")
    model.train()
    named = dict(model.named_parameters())
    dev = next(model.parameters()).device
    mask_state = None
    if mask_cfg is not None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        mask_state = init_masks(named, mask_cfg, gen, snip_loss_fn, masks,
                                group)
        apply_mask(named, mask_state.masks)
    groups = param_groups(named.items(), train_cfg.layer_decay)
    if train_cfg.opt == "adan":
        opt = make_adan(groups, train_cfg.opt_betas or ADAN_BETAS,
                        train_cfg.opt_eps)
    else:
        opt = make_adamw(groups, train_cfg.opt_betas or (0.9, 0.999),
                         train_cfg.opt_eps)
    ema = ema_init(model) if train_cfg.ema_decay else None
    return TrainState(model=model, optimizer=opt, mask_state=mask_state,
                      ema=ema)


def _loss(logits, targets, smoothing):
    if targets.ndim == 2:
        return L.soft_target_cross_entropy(logits, targets)
    if smoothing > 0:
        return L.label_smoothing_cross_entropy(logits, targets, smoothing)
    return L.cross_entropy(logits, targets)


def make_train_step(model: SLaK, train_cfg: TrainConfig,
                    mask_cfg: Optional[MaskConfig],
                    lr_schedule: np.ndarray,
                    wd_schedule: Optional[np.ndarray] = None,
                    plain: bool = False, group=None):
    """Returns ``train_step(state, (images, targets), generator=None) ->
    (state, metrics)``: images NHWC, ``update_freq * B`` of them; targets
    int labels or soft (N, classes) ones. ``generator`` draws the
    drop-path masks. ``plain`` runs the kernels' plain versions on any
    device. ``group``: a process group over which the batch is sharded
    (data parallel; the counterpart of the JAX step's ``pmean_axis``):
    each rank passes its shard, in rank order, and the same generator
    state."""
    dtype = train_cfg.compute_dtype
    uf = train_cfg.update_freq
    growth_reads_grads = mask_cfg is not None and mask_cfg.growth_mode in (
        "gradient", "mix")

    def train_step(state: TrainState, batch: Tuple[torch.Tensor, ...],
                   generator: Optional[torch.Generator] = None):
        images, targets = batch
        state.model.train()
        dev = next(state.model.parameters()).device
        images = images.to(device=dev, dtype=dtype)
        targets = targets.to(dev)
        it = state.step
        lr = float(lr_schedule[min(it, len(lr_schedule) - 1)])
        wd = train_cfg.weight_decay if wd_schedule is None else \
            float(wd_schedule[min(it, len(wd_schedule) - 1)])
        opt = state.optimizer
        set_lr_wd(opt, lr, wd)
        opt.zero_grad(set_to_none=True)

        mb = images.shape[0] // uf
        loss_sum = torch.zeros((), device=dev)
        shard = (0, 1) if group is None else (dist.get_rank(group),
                                              dist.get_world_size(group))
        with global_batch_shard(*shard):
            for k in range(uf):
                sl = slice(k * mb, (k + 1) * mb)
                logits = apply(state.model, images[sl], plain, generator)
                loss = _loss(logits, targets[sl], train_cfg.smoothing)
                (loss / uf if uf > 1 else loss).backward()
                loss_sum += loss.detach()

        named = state.named_params()
        if group is not None:
            # the DDP gradient all-reduce (pmean_axis): every gradient a
            # rank has (the same set on every rank) and the loss
            all_reduce_([p.grad for p in named.values()
                         if p.grad is not None] + [loss_sum], "mean", group)
        gnorm, raw_grads = optimizer_step(opt, named, train_cfg.clip_grad,
                                          growth_reads_grads)
        masks_and_ema(state, named, mask_cfg, train_cfg, raw_grads)
        metrics = {"loss": loss_sum / uf,
                   "lr": torch.tensor(lr), "grad_norm": gnorm,
                   "weight_decay": torch.tensor(wd)}
        return state, metrics

    return train_step


def optimizer_step(opt: torch.optim.Optimizer,
                   named: Dict[str, torch.Tensor], clip: Optional[float],
                   keep_grads: bool = False):
    """The global gradient norm of ``named``'s gradients, the clip (when
    ``clip``) and ``opt``'s step: (norm, the unclipped gradients by name
    when ``keep_grads``, else None)."""
    grads = [p.grad for p in named.values()]
    gnorm = global_grad_norm(grads)
    raw = ({n: p.grad.clone() for n, p in named.items()}
           if keep_grads else None)
    if clip is not None:
        clip_grads(grads, gnorm, clip)
    opt.step()
    return gnorm, raw


def masks_and_ema(state: TrainState, named: Dict[str, torch.Tensor],
                  mask_cfg: Optional[MaskConfig], train_cfg: TrainConfig,
                  raw_grads: Optional[Dict[str, torch.Tensor]] = None):
    """After the optimizer step: mask the weights and, every
    ``update_frequency`` steps, prune and regrow them (growth reads the
    optimizer's Adam moments or ``raw_grads``); update the EMA; count the
    step."""
    it = state.step
    ms = state.mask_state
    if ms is not None:
        apply_mask(named, ms.masks)
        new_step = it + 1
        if (mask_cfg.update_frequency and not mask_cfg.fix
                and new_step % mask_cfg.update_frequency == 0):
            rate = cosine_prune_rate(new_step, mask_cfg.prune_rate,
                                     max(train_cfg.prune_t_max, 1),
                                     mask_cfg.eta_min)
            ms = truncate_weights(ms, named, mask_cfg, rate,
                                  grads=raw_grads,
                                  momentum=adam_momentum(state.optimizer,
                                                         named))
        ms.steps = new_step
        state.mask_state = ms
    if state.ema is not None:
        ema_update(state.ema, state.model, train_cfg.ema_decay,
                   ms.masks if ms is not None else None)
    state.step = it + 1


def make_eval_step(model: SLaK, compute_dtype: Optional[torch.dtype] = None
                   ) -> Callable[[Tuple[torch.Tensor, torch.Tensor]],
                                 Dict[str, torch.Tensor]]:
    """Returns ``eval_step((images, labels))`` on NHWC images, run on the
    model's device in ``compute_dtype`` (default: the model's), in eval
    mode (reference engine.py:142-178): logits, CE loss, top-1/5."""
    dtype = compute_dtype or getattr(model, "compute_dtype", torch.float32)
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(batch):
        images, labels = batch
        images = images.to(device=device, dtype=dtype)
        labels = labels.to(device)
        model.eval()
        logits = apply(model, images)
        return {
            "logits": logits,
            "loss": L.cross_entropy(logits, labels),
            "acc1": L.accuracy_topk(logits, labels, 1),
            "acc5": L.accuracy_topk(logits, labels, 5),
            "n": torch.tensor(float(labels.shape[0])),
        }

    return eval_step
