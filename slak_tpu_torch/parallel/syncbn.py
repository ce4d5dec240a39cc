"""SyncBN data-parallel training: port of ``slak_tpu/parallel/syncbn.py``.

The reference wraps every large-kernel branch BN in ``nn.SyncBatchNorm``
(``models/SLaK.py:19-28``) and trains under DDP (``main.py:374-376``), so
batch statistics and gradients are the global batch's. The port's step
(``train/engine.py`` ``make_train_step`` with a process group) runs on each
rank's shard of the global batch: the model's branch BNs average their
statistics over the group (``SLaKConfig.bn_axis_name``; the all-reduce is
differentiable, ``ops/batchnorm.py``), drop-path draws are the global
batch's, and the gradients and the loss are averaged over the group before
the clip, the optimizer and DST. One step on N ranks therefore computes the
one-process step on the concatenated batch, up to the order of the sums.
"""

from __future__ import annotations

from slak_tpu_torch.parallel.mesh import DATA_AXIS, axis_group


def make_syncbn_train_step(model, train_cfg, mask_cfg, lr_schedule,
                           wd_schedule=None, axis_name: str = DATA_AXIS,
                           plain: bool = False):
    """``make_train_step`` over the process group of ``axis_name``. The
    model's config must carry ``bn_axis_name=axis_name`` so that its
    train-mode BN averages its batch statistics over the group."""
    from slak_tpu_torch.train.engine import make_train_step

    assert model.cfg.bn_axis_name == axis_name, (
        "model must be built with bn_axis_name set for SyncBN")
    return make_train_step(model, train_cfg, mask_cfg, lr_schedule,
                           wd_schedule, plain=plain,
                           group=axis_group(axis_name))
