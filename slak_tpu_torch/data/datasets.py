"""Datasets: port of ``slak_tpu/data/datasets.py``, the reference's
``build_dataset`` (``datasets.py:16-47``): ``IMNET`` (ImageFolder
train/val), ``CIFAR`` (CIFAR-100 from its pickles on disk, no download),
``image_folder``, and the synthetic dataset for smoke runs and benchmarks
that the reference lacks. Items are PIL images (opened with PIL, imported
when one is read) through the transform; labels are ints.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm")


class ImageFolderDataset:
    """``ds[i]`` -> (transform(image), class index)."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))
        self.nb_classes = len(classes)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image
        path, label = self.samples[idx]
        img = Image.open(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class CIFAR100Dataset:
    """The ``cifar-100-python`` pickles under ``root`` (train or test)."""

    def __init__(self, root: str, train: bool,
                 transform: Optional[Callable] = None):
        path = os.path.join(root, "cifar-100-python",
                            "train" if train else "test")
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="latin1")
        self.data = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = d["fine_labels"]
        self.transform = transform
        self.nb_classes = 100

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx: int):
        from PIL import Image
        img = Image.fromarray(self.data[idx])
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class SyntheticDataset:
    """Deterministic fake images: item i is uniform uint8 noise and a
    label, both from ``np.random.default_rng(seed + i)`` (no disk IO)."""

    def __init__(self, n: int = 1024, size: int = 224, nb_classes: int = 1000,
                 transform: Optional[Callable] = None, seed: int = 0):
        self.n, self.size, self.nb_classes = n, size, nb_classes
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        from PIL import Image
        rng = np.random.default_rng(self.seed + idx)
        arr = rng.integers(0, 256, (self.size, self.size, 3), np.uint8)
        img = Image.fromarray(arr)
        if self.transform is not None:
            img = self.transform(img)
        return img, int(rng.integers(0, self.nb_classes))


DATA_SETS = ("CIFAR", "IMNET", "image_folder", "synthetic")


def build_dataset(is_train: bool, data_set: str, data_path: Optional[str],
                  transform: Optional[Callable] = None,
                  eval_data_path: Optional[str] = None,
                  nb_classes: Optional[int] = None,
                  synthetic_len: int = 1024, synthetic_size: int = 224):
    """(dataset, nb_classes) as the reference's ``build_dataset``."""
    if data_set == "CIFAR":
        return CIFAR100Dataset(data_path, is_train, transform), 100
    if data_set == "IMNET":
        root = os.path.join(data_path, "train" if is_train else "val")
        return ImageFolderDataset(root, transform), 1000
    if data_set == "image_folder":
        root = data_path if is_train else (eval_data_path or data_path)
        ds = ImageFolderDataset(root, transform)
        return ds, nb_classes if nb_classes is not None else ds.nb_classes
    if data_set == "synthetic":
        ds = SyntheticDataset(n=synthetic_len, size=synthetic_size,
                              transform=transform,
                              nb_classes=nb_classes or 1000)
        return ds, ds.nb_classes
    raise ValueError(f"data_set {data_set!r}: one of {'/'.join(DATA_SETS)}")
