"""ERF visualization CLI: port of ``slak_tpu/analysis/visualize_erf.py``
(the reference's ``erf/visualize_erf.py``, the contribution matrix over
val images at 1024^2, and ``erf/analyze_erf.py``, the heatmap and the
high-contribution area ratios).

Usage:
  python -m slak_tpu_torch.analysis.visualize_erf --model SLaK_tiny \\
      --kernel_size 51 49 47 13 5 --width_factor 1.3 --Decom true \\
      --weights ckpt.pth --data_path /imagenet --num_images 50 \\
      --save erf.npy --heatmap erf.png [--device cpu] [--plain]

The model runs in eval mode, float32, batch 1, with its parameters frozen:
only the input's gradient is taken, through the port's differentiable eval
route (K1, K2/K3 forward; K1 on flipped taps, K8 and K9 backward). It runs
on CUDA unless ``--device cpu`` is given; ``--plain`` runs the plain
PyTorch versions of the kernels. Without ``--weights`` the weights are the
port's random init from seed 0; without ``--data_path`` the images are
up to 4 normal-noise images from numpy seed 0 (the JAX CLI's).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from slak_tpu_torch.utils import str2bool


def heatmap(data: np.ndarray, save_path: str) -> None:
    """analyze_erf.py:33-51 equivalent (matplotlib only, imported here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.imshow(data, cmap="RdYlGn", vmin=0, vmax=1)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def compare_panels(sources, titles, save_path):
    """Multi-panel ERF comparison figure (the reference's
    ``erf/erf_slak51_convnext7_convnext31.py``); ``sources``: paths to .npy
    contribution matrices written by :func:`main`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slak_tpu_torch.analysis.erf import analyze_erf

    n = len(sources)
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 6))
    if n == 1:
        axes = [axes]
    for ax, src, title in zip(axes, sources, titles):
        data = analyze_erf(np.load(src) + 1e-9)["normalized"]
        im = ax.imshow(data, cmap="RdYlGn", vmin=0, vmax=1)
        ax.set_title(title, fontsize=16)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.colorbar(im, ax=axes, fraction=0.02, pad=0.02)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    print(f"comparison figure saved to {save_path}")


def main(argv=None) -> dict:
    """Run the CLI; returns {"data": the (H, W) contribution map, "ratios":
    analyze_erf's ratios, "seconds": each image's host seconds (input
    gradient and map, ending in a device sync), "used": how many images'
    maps were finite and went into the average}."""
    from slak_tpu_torch import resolve_device
    from slak_tpu_torch.analysis.erf import analyze_erf, erf_contribution
    from slak_tpu_torch.models import create_model
    from slak_tpu_torch.utils.convert import load_torch_checkpoint

    p = argparse.ArgumentParser("SLaK ERF visualization (PyTorch port)")
    p.add_argument("--model", default="SLaK_tiny")
    p.add_argument("--kernel_size", default=[51, 49, 47, 13, 5], type=int,
                   nargs="*")
    p.add_argument("--width_factor", type=float, default=1.0)
    p.add_argument("--Decom", type=str2bool, default=True)
    p.add_argument("--weights", default=None,
                   help="torch .pth (random init if omitted)")
    p.add_argument("--data_path", default=None)
    p.add_argument("--num_images", type=int, default=50)
    p.add_argument("--input_size", type=int, default=1024)
    p.add_argument("--save", default="erf.npy")
    p.add_argument("--heatmap", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--plain", action="store_true",
                   help="the plain PyTorch versions of the kernels")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    model = create_model(args.model, device="cpu",
                         kernel_size=tuple(args.kernel_size),
                         width_factor=args.width_factor, decom=args.Decom)
    if args.weights:
        missing, unexpected = model.load_state_dict(
            load_torch_checkpoint(args.weights), strict=False)
        if missing:
            raise KeyError(f"{args.weights} lacks {missing[:5]} "
                           f"({len(missing)} missing)")
        if unexpected:
            print(f"ignored {len(unexpected)} unexpected keys, e.g. "
                  f"{unexpected[:3]}")
    model = model.to(device).eval().requires_grad_(False)

    def feature_fn(x):
        stages = model.forward_features(x.permute(0, 3, 1, 2).contiguous(),
                                        plain=args.plain, return_stages=True)
        return stages[-1].permute(0, 2, 3, 1)

    # 1024x1024 warp-resized val images, batch 1 (visualize_erf.py:60-74)
    if args.data_path:
        from slak_tpu_torch.data.datasets import ImageFolderDataset
        from slak_tpu_torch.data.transforms import EvalTransform
        ds = ImageFolderDataset(os.path.join(args.data_path, "val"),
                                EvalTransform(size=args.input_size))
        images = [torch.from_numpy(ds[i][0])[None]
                  for i in range(min(args.num_images, len(ds)))]
    else:
        rng = np.random.default_rng(0)
        images = [torch.from_numpy(rng.standard_normal(
            (1, args.input_size, args.input_size, 3)).astype(np.float32))
            for _ in range(min(args.num_images, 4))]
    images = [im.to(device) for im in images]
    stamps = []

    def timed():
        for im in images:
            stamps.append(time.perf_counter())
            yield im
    data, used = erf_contribution(feature_fn, timed(), return_count=True)
    stamps.append(time.perf_counter())
    seconds = list(np.diff(stamps))
    np.save(args.save, data)
    print(f"contribution matrix saved to {args.save} ({used} of "
          f"{len(images)} images finite, on {device}"
          f"{' (plain)' if args.plain else ''}, median "
          f"{np.median(seconds) * 1e3:.3f} ms an image)")

    res = analyze_erf(data + 1e-9)
    for t, r in res["ratios"].items():
        print(f"thresh {t}: side {r['side'] if r else None}, "
              f"area ratio {r['area_ratio'] if r else None}")
    if args.heatmap:
        heatmap(res["normalized"], args.heatmap)
        print(f"heatmap saved to {args.heatmap}")
    return {"data": data, "ratios": res["ratios"], "seconds": seconds,
            "used": used}


if __name__ == "__main__":
    main()
