"""Deployment tool: port of ``slak_tpu/utils/deploy.py``. Reparameterize a
trained SLaK checkpoint (fold the BNs, merge every branch into one K x K
conv, ``models/SLaK.py:102-122``, extended to the decomposed rectangular
branches) and save the merged, inference-ready state dict with
``torch.save`` (the JAX tool writes an Orbax checkpoint; the port has no
Orbax, so ``--ckpt`` is a torch ``.pth``).

Usage:
  python -m slak_tpu_torch.utils.deploy --ckpt ckpt.pth --out merged.pth \\
      --model SLaK_tiny --kernel_size 51 49 47 13 5 --width_factor 1.3 \\
      --Decom true [--device cpu]

The model is built, loaded and merged on CUDA unless ``--device cpu`` is
given; the merged state dict is moved to the CPU before it is saved.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    """Run the CLI; returns the merged model (on its device)."""
    from slak_tpu_torch import resolve_device
    from slak_tpu_torch.models import create_model, merge_model
    from slak_tpu_torch.utils import str2bool
    from slak_tpu_torch.utils.convert import load_torch_checkpoint

    p = argparse.ArgumentParser("SLaK reparam/deploy (PyTorch port)")
    p.add_argument("--ckpt", required=True, help="torch .pth")
    p.add_argument("--out", required=True, help="merged state dict (.pth)")
    p.add_argument("--model", default="SLaK_tiny")
    p.add_argument("--kernel_size", default=[51, 49, 47, 13, 5], type=int,
                   nargs="*")
    p.add_argument("--width_factor", type=float, default=1.0)
    p.add_argument("--Decom", type=str2bool, default=True)
    p.add_argument("--bn", type=str2bool, default=True)
    p.add_argument("--nb_classes", type=int, default=1000)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    model = create_model(args.model, device=resolve_device(args.device),
                         kernel_size=tuple(args.kernel_size),
                         width_factor=args.width_factor, decom=args.Decom,
                         branch_bn=args.bn, num_classes=args.nb_classes)
    model.load_state_dict(load_torch_checkpoint(args.ckpt))
    merged = merge_model(model)
    # a plain dict of CPU tensors, which torch.load's weights_only mode
    # reads back on any machine
    torch.save({k: v.cpu() for k, v in merged.state_dict().items()},
               args.out)
    print(f"merged model saved to {args.out}")
    return merged


if __name__ == "__main__":
    main()
