"""Knowledge distillation (port of ``slak_tpu.kd``): the losses, the engine
and the CLI (``python -m slak_tpu_torch.kd.main``)."""

from slak_tpu_torch.kd.losses import (
    nkd_loss, kd_loss, fd_loss, smooth_l1, mse,
    MGDConfig, mgd_init, mgd_loss, mgd_loss_masked,
)
from slak_tpu_torch.kd.engine import (
    KDConfig, init_kd_params, make_kd_train_step, make_teacher_apply,
    kd_opt_init,
)

__all__ = [
    "nkd_loss", "kd_loss", "fd_loss", "smooth_l1", "mse",
    "MGDConfig", "mgd_init", "mgd_loss", "mgd_loss_masked",
    "KDConfig", "init_kd_params", "make_kd_train_step", "make_teacher_apply",
    "kd_opt_init",
]
