"""Input pipeline of the port: so far what the ERF CLI's ``--data_path``
needs (the eval transform and the image-folder dataset)."""

from slak_tpu_torch.data.datasets import ImageFolderDataset
from slak_tpu_torch.data.transforms import (DEFAULT_CROP_PCT, IMAGENET_MEAN,
                                            IMAGENET_STD, EvalTransform)

__all__ = ["EvalTransform", "ImageFolderDataset", "IMAGENET_MEAN",
           "IMAGENET_STD", "DEFAULT_CROP_PCT"]
