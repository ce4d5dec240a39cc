"""Image-folder dataset: port of ``ImageFolderDataset`` in
``slak_tpu/data/datasets.py`` (torchvision ImageFolder semantics: a class
per subdirectory, classes and files in sorted order). Items are opened
with PIL, imported when one is read; the other datasets are still to port.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

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
