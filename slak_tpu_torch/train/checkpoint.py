"""Checkpoint and resume: port of ``slak_tpu/train/checkpoint.py`` (the
reference's ``utils.save_model`` / ``auto_load_model``, ``utils.py:
447-544``) with ``torch.save``.

One file a checkpoint, under ``slak_tpu``'s names: ``checkpoint-{epoch}``,
``checkpoint-best``, ``checkpoint-best-ema``. It holds the model's state
dict (the reference's names), the optimizer's state (AdamW or Adan), the
DST masks with ITOP's ``fired`` and the mask step, the EMA, the global
step and the epoch. The retention window keeps the last ``save_ckpt_num``
of the checkpoints saved every ``save_ckpt_freq`` epochs; ``auto_load``
resumes from the latest ``checkpoint-N``. :func:`load_into` also takes a
reference ``.pth`` (its model weights only, through
``utils.convert.load_torch_checkpoint``).

Under data parallel every rank holds the same state: only rank 0 writes,
and the other ranks wait at a barrier until the file is whole; every rank
reads on resume.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from slak_tpu_torch.parallel.mesh import barrier, rank
from slak_tpu_torch.sparsity.masking import MaskState
from slak_tpu_torch.train.engine import TrainState

FORMAT = "slak_tpu_torch.train.checkpoint/1"


def state_dict(state: TrainState, epoch: int) -> dict:
    ms = state.mask_state
    return {
        "format": FORMAT,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "mask_state": None if ms is None else {
            "masks": ms.masks, "fired": ms.fired, "steps": ms.steps},
        "ema": state.ema,
        "step": state.step,
        "epoch": epoch,
    }


def save_checkpoint(output_dir: str, state: TrainState, epoch: int,
                    tag: Optional[str] = None, save_ckpt_freq: int = 1,
                    save_ckpt_num: int = 3) -> Optional[str]:
    """Save ``checkpoint-{epoch|tag}`` (through a temporary file, so a
    checkpoint on disk is always whole) and apply the retention window.
    Under data parallel rank 0 writes and every rank returns after it has;
    returns the path written, None on the other ranks."""
    path = None
    if rank() == 0:
        path = os.path.join(output_dir,
                            f"checkpoint-{tag if tag is not None else epoch}")
        tmp = path + ".tmp"
        torch.save(state_dict(state, epoch), tmp)
        os.replace(tmp, path)
        if tag is None and epoch >= save_ckpt_freq * save_ckpt_num:
            old = os.path.join(output_dir, "checkpoint-%d"
                               % (epoch - save_ckpt_freq * save_ckpt_num))
            if os.path.exists(old):
                os.remove(old)
    barrier()
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The numeric checkpoint of the highest epoch (utils.py:512-521)."""
    if not os.path.isdir(output_dir):
        return None
    best_epoch, best = -1, None
    for entry in os.listdir(output_dir):
        m = re.match(r"checkpoint-(\d+)$", entry)
        if m and int(m.group(1)) > best_epoch:
            best_epoch, best = int(m.group(1)), os.path.join(output_dir,
                                                              entry)
    return best


def load_into(path: str, state: TrainState, model_key: str = "model|module",
              model_prefix: str = "") -> Optional[int]:
    """Restore ``state`` in place from ``path``: a checkpoint of this
    module (everything; returns its epoch) or a reference ``.pth`` (the
    model weights; returns its ``epoch`` entry, or None)."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=False)
    if not (isinstance(ckpt, dict) and ckpt.get("format") == FORMAT):
        from slak_tpu_torch.utils.convert import load_torch_checkpoint
        sd = load_torch_checkpoint(path, model_key=model_key,
                                   model_prefix=model_prefix)
        state.model.load_state_dict(sd)
        epoch = ckpt.get("epoch") if isinstance(ckpt, dict) else None
        return None if epoch is None else int(epoch)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    ms = ckpt["mask_state"]
    if (ms is None) != (state.mask_state is None):
        raise ValueError(f"{path}: the checkpoint's run "
                         f"{'had no' if ms is None else 'had'} masks, this "
                         f"one {'has' if ms is None else 'has none'}")
    if ms is not None:
        state.mask_state = MaskState(masks=ms["masks"], fired=ms["fired"],
                                     steps=int(ms["steps"]),
                                     generator=state.mask_state.generator)
    if (ckpt["ema"] is None) != (state.ema is None):
        raise ValueError(f"{path}: the checkpoint's run and this one differ "
                         f"in --model_ema")
    state.ema = ckpt["ema"]
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])


def auto_load(output_dir: str, state: TrainState) -> Tuple[TrainState, int]:
    """Resume from the latest ``checkpoint-N`` if there is one: (state,
    N + 1), else (state, 0)."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return state, 0
    return state, load_into(path, state) + 1
