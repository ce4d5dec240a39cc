"""Input pipeline of the port: host transforms (``transforms``,
``auto_augment``, the native library's binding ``native``), datasets,
the loader, and mixup / random erasing on the device."""

from slak_tpu_torch.data.auto_augment import (RandAugment,
                                              rand_augment_from_config)
from slak_tpu_torch.data.datasets import (CIFAR100Dataset,
                                          ImageFolderDataset,
                                          SyntheticDataset, build_dataset)
from slak_tpu_torch.data.loader import BatchLoader, device_prefetch
from slak_tpu_torch.data.mixup import MixupConfig, mixup_cutmix, mixup_target
from slak_tpu_torch.data.random_erasing import (RandomErasingConfig,
                                                random_erasing)
from slak_tpu_torch.data.transforms import (DEFAULT_CROP_PCT, IMAGENET_MEAN,
                                            IMAGENET_STD, EvalTransform,
                                            TrainTransform)

__all__ = ["TrainTransform", "EvalTransform", "IMAGENET_MEAN",
           "IMAGENET_STD", "DEFAULT_CROP_PCT", "RandAugment",
           "rand_augment_from_config", "MixupConfig", "mixup_cutmix",
           "mixup_target", "RandomErasingConfig", "random_erasing",
           "ImageFolderDataset", "CIFAR100Dataset", "SyntheticDataset",
           "build_dataset", "BatchLoader", "device_prefetch"]
