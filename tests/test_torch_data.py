"""The port's host input pipeline against ``slak_tpu.data`` on the CPU.

  * the train transform on the native path (crop, bicubic resample, flip
    and normalize in one pass of ``native/slak_host.cpp``, each package
    building its own library with the same flags), through PIL with
    RandAugment (the recipe), and through PIL with colour jitter and the
    random interpolation: the same bytes under the same ``random`` seed,
    over images of several sizes and modes; every RandAugment op at every
    magnitude, likewise;
  * the synthetic dataset and CIFAR-100 (from a pickle this test writes):
    the same items; ``build_dataset``'s class counts;
  * the loader: index order, rank sharding with wrap-around padding and
    ``drop_last`` equal to ``slak_tpu``'s ``BatchLoader`` for seeds x
    epochs x ranks, and the same batches through the thread workers;
    thread and process workers give the same bytes under the train
    transform's randomness; a worker's error fails the iteration.
"""

import os
import pickle
import random

import numpy as np
import pytest
import torch
from PIL import Image

from slak_tpu.data import auto_augment as jaa
from slak_tpu.data import datasets as jds
from slak_tpu.data import loader as jloader
from slak_tpu.data import transforms as jtf
from slak_tpu_torch.data import auto_augment as aa
from slak_tpu_torch.data import datasets as ds
from slak_tpu_torch.data import native
from slak_tpu_torch.data import transforms as tf
from slak_tpu_torch.data.loader import BatchLoader, ShardedBatchSampler

SIZE = 32


def _images(rng):
    """Source images of several sizes and modes."""
    out = []
    for h, w, mode in ((40, 56, "RGB"), (64, 48, "RGB"), (31, 31, "L"),
                       (50, 70, "RGBA")):
        ch = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        arr = rng.integers(0, 256, (h, w, ch), np.uint8)
        out.append(Image.fromarray(arr[..., 0] if ch == 1 else arr, mode))
    return out


@pytest.mark.parametrize("kind", ["native", "pil_randaugment",
                                  "pil_jitter_random_interp"])
def test_train_transform_matches_slak_tpu(kind):
    kw = {"native": dict(auto_augment=None, color_jitter_amount=None),
          "pil_randaugment": {},
          "pil_jitter_random_interp": dict(auto_augment=None,
                                           interpolation="random")}[kind]
    ours = tf.TrainTransform(SIZE, **kw)
    ref = jtf.TrainTransform(SIZE, **kw)
    assert ours.host_path() == ("native" if kind == "native" else "pil")
    images = _images(np.random.default_rng(0))
    for seed in range(6):
        for img in images:
            random.seed(seed)
            want = ref(img)
            random.seed(seed)
            got = ours(img)
            assert got.dtype == np.float32 and got.shape == (SIZE, SIZE, 3)
            np.testing.assert_array_equal(got, want)


def test_rand_augment_matches_slak_tpu():
    """Each op of the increasing list at magnitudes 0..10 (one sign draw
    each), then the policy under several seeds."""
    img = Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (SIZE, SIZE, 3), np.uint8))
    assert len(aa.RAND_INCREASING_OPS) == len(jaa.RAND_INCREASING_OPS)
    for op, jop in zip(aa.RAND_INCREASING_OPS, jaa.RAND_INCREASING_OPS):
        for m in np.linspace(0.0, 10.0, 6):
            random.seed(int(m * 10))
            want = np.asarray(jop(img, m))
            random.seed(int(m * 10))
            np.testing.assert_array_equal(np.asarray(op(img, m)), want)
    ours = aa.rand_augment_from_config("rand-m9-mstd0.5-inc1")
    ref = jaa.rand_augment_from_config("rand-m9-mstd0.5-inc1")
    for seed in range(20):
        random.seed(seed)
        want = np.asarray(ref(img))
        random.seed(seed)
        np.testing.assert_array_equal(np.asarray(ours(img)), want)


def test_datasets_match_slak_tpu(tmp_path):
    """SyntheticDataset items and labels; CIFAR-100 from a written
    pickle through the eval transform; build_dataset's class counts."""
    ours = ds.SyntheticDataset(n=5, size=SIZE, nb_classes=7, seed=3)
    ref = jds.SyntheticDataset(n=5, size=SIZE, nb_classes=7, seed=3)
    for i in range(5):
        (a, la), (b, lb) = ours[i], ref[i]
        assert la == lb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(2)
    root = tmp_path / "cifar-100-python"
    root.mkdir()
    for split, n in (("train", 6), ("test", 4)):
        with open(root / split, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         "fine_labels": rng.integers(0, 100, n).tolist()}, f)
    eval_tf = tf.EvalTransform(SIZE)
    for train in (True, False):
        got, n_got = ds.build_dataset(train, "CIFAR", str(tmp_path), eval_tf)
        want, n_want = jds.build_dataset(train, "CIFAR", str(tmp_path),
                                         jtf.EvalTransform(SIZE))
        assert n_got == n_want == 100 and len(got) == len(want)
        for i in range(len(got)):
            assert got[i][1] == want[i][1]
            np.testing.assert_array_equal(got[i][0], want[i][0])
    syn, n_syn = ds.build_dataset(True, "synthetic", None, None,
                                  nb_classes=10, synthetic_len=3)
    assert (len(syn), n_syn) == (3, 10)
    with pytest.raises(ValueError):
        ds.build_dataset(True, "MNIST", None)


class _Labels:
    """Items (index as a tiny image, index): the loader's batches show
    which indices they hold."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.float32), int(i)


def test_loader_order_matches_slak_tpu():
    for n, bs in ((23, 4), (16, 8)):
        for seed in (0, 5):
            for epoch in (0, 1, 7):
                for world in (1, 2, 3):
                    for rank in range(world):
                        for shuffle, drop_last in ((True, True),
                                                   (False, False)):
                            ref = jloader.BatchLoader(
                                _Labels(n), bs, shuffle, drop_last,
                                seed=seed, rank=rank, world_size=world)
                            ref.set_epoch(epoch)
                            ours = ShardedBatchSampler(
                                n, bs, shuffle, drop_last, seed, rank, world)
                            ours.set_epoch(epoch)
                            np.testing.assert_array_equal(ours.indices(),
                                                          ref._indices())
                            assert len(ours) == len(ref)
    ref = jloader.BatchLoader(_Labels(23), 4, seed=3, num_workers=3)
    ours = BatchLoader(_Labels(23), 4, seed=3, num_workers=3)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        ours.set_epoch(epoch)
        got = [(x.numpy(), y.numpy()) for x, y in ours]
        want = list(ref)
        assert len(got) == len(want) == len(ours)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gy, wy)
            np.testing.assert_array_equal(gx, wx)


class _Boom(_Labels):
    def __getitem__(self, i):
        if i == 5:
            raise KeyError("sample 5 is unreadable")
        return super().__getitem__(i)


def test_loader_workers_are_deterministic_and_fail_fast():
    """The train transform's random stream by worker: two thread runs and
    a run on two worker processes give the same bytes; an error in a
    worker fails the iteration."""
    data = ds.SyntheticDataset(n=12, size=SIZE,
                               transform=tf.TrainTransform(SIZE))

    def run(mode):
        loader = BatchLoader(data, 3, seed=1, num_workers=2, mode=mode)
        loader.set_epoch(2)
        return [x.numpy() for x, _ in loader]

    a, b, c = run("thread"), run("thread"), run("process")
    assert len(a) == 4
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    with pytest.raises(RuntimeError, match="loader worker"):
        list(BatchLoader(_Boom(12), 3, shuffle=False, num_workers=2))


def test_native_library_builds_into_the_port():
    """The port's own build of the host library, in its build directory,
    from the top-level source it only reads."""
    assert native.get_lib() is not None
    assert os.path.dirname(native.SO).endswith(
        os.path.join("slak_tpu_torch", "_build"))
    assert native.SRC.endswith(os.path.join("native", "slak_host.cpp"))
    img = np.random.default_rng(4).integers(0, 256, (20, 30, 3), np.uint8)
    with pytest.raises(ValueError):
        native.rrc_normalize(img, (25, 0, 10, 10), SIZE, False,
                             tf.IMAGENET_MEAN, tf.IMAGENET_STD)
    assert torch.from_numpy(native.rrc_normalize(
        img, (0, 0, 30, 20), SIZE, True, tf.IMAGENET_MEAN,
        tf.IMAGENET_STD)).isfinite().all()
