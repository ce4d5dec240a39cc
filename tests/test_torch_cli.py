"""The port's train CLI (``python -m slak_tpu_torch.train.main``) on the CPU,
against ``slak_tpu`` where the two meet; nothing here runs
``slak_tpu.train.main`` itself.

  * every flag of ``slak_tpu``'s parser parses here with the same default,
    type, choices and arity (``--device`` and ``--dist_backend`` are the
    port's own);
  * ``--eval true --finetune x.pth``: loss, top-1 and top-5 within 1e-4 of
    ``slak_tpu``'s ``make_eval_step`` on the same ``.pth`` (through
    ``slak_tpu.utils.load_torch_checkpoint``) and the same val images;
  * SLaK_debug at 32^2 on the synthetic set, sparse (SNIP, a DST refresh
    every 2 steps), EMA, the recipe's augmentation: a 2-epoch run equals
    its first epoch's checkpoint auto-resumed in a fresh directory, bit for
    bit (model, optimizer state, masks, ``fired``, EMA, step), with AdamW
    and with Adan + remat; the resumed run's first step starts from the
    checkpoint's state;
  * the retention window deletes what ``slak_tpu``'s deletes;
  * ``--n_devices 2``, ``--multi_host true`` and ``--tp_eval true`` raise
    where they cannot run as given, before any rank starts: NCCL on CPU
    ranks, no rendezvous in the environment, the channel-parallel eval
    without ``--eval``.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.models.slak import create_model as jax_create_model
from slak_tpu.train import checkpoint as jckpt
from slak_tpu.train.engine import make_eval_step as jax_make_eval_step
from slak_tpu.train.main import get_args_parser as jax_args_parser
from slak_tpu.utils import load_torch_checkpoint as jax_load_checkpoint
from slak_tpu_torch.data import EvalTransform, SyntheticDataset
from slak_tpu_torch.models import create_model
from slak_tpu_torch.train import checkpoint as ckpt
from slak_tpu_torch.train.engine import TrainConfig, create_train_state
from slak_tpu_torch.train.main import get_args_parser, main, parse_args


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEBUG = ["--device", "cpu", "--model", "SLaK_debug", "--kernel_size", "13",
         "11", "9", "7", "5", "--Decom", "true", "--data_set", "synthetic",
         "--input_size", "32", "--use_bf16", "false", "--num_workers", "2",
         "--print_freq", "100"]


def test_flags_match_slak_tpu():
    """Types compare by name: each package has its own str2bool."""
    def spec(a):
        return (a.option_strings, a.default, getattr(a.type, "__name__",
                                                     a.type),
                a.choices, a.nargs)
    ours = {a.dest: a for a in get_args_parser()._actions}
    for a in jax_args_parser()._actions:
        assert spec(ours.pop(a.dest)) == spec(a), a.dest
    assert set(ours) == {"device", "dist_backend"}


def test_eval_matches_slak_tpu_eval_step(tmp_path):
    """A reference-style .pth of random weights, 3 classes (accuracies
    away from 0 and 1), 8 val images in batches of 4."""
    model = create_model("SLaK_debug", device="cpu", seed=5,
                         kernel_size=(13, 11, 9, 7, 5), num_classes=3)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    path = str(tmp_path / "x.pth")
    torch.save({"model": model.state_dict(), "epoch": 4}, path)
    got = main(parse_args(DEBUG + ["--eval", "true", "--finetune", path,
                                   "--nb_classes", "3", "--batch_size", "4",
                                   "--synthetic_len", "32"]))

    params, state = jax_load_checkpoint(path)
    jmodel = jax_create_model("SLaK_debug", kernel_size=(13, 11, 9, 7, 5),
                              decom=True, branch_bn=True, num_classes=3,
                              conv_impl="xla", mlp_impl="xla")
    step = jax.jit(lambda b: jax_make_eval_step(jmodel)(params, state, b))
    val = SyntheticDataset(n=8, size=32, nb_classes=3,
                           transform=EvalTransform(32))
    tot = {"loss": 0.0, "acc1": 0.0, "acc5": 0.0}
    for lo in (0, 4):
        items = [val[i] for i in range(lo, lo + 4)]
        m = step((jnp.asarray(np.stack([x for x, _ in items])),
                  jnp.asarray([y for _, y in items])))
        for k in tot:
            tot[k] += float(m[k]) * 4 / 8
    assert 0.0 < tot["acc1"] < 1.0
    for k, v in tot.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def _flat(state_dict_like, prefix=""):
    """{dotted key: tensor or number} of a nested checkpoint."""
    out = {}
    items = state_dict_like.items() if isinstance(state_dict_like, dict) \
        else enumerate(state_dict_like)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


def _same(a, b, what):
    fa, fb = _flat({"": a}), _flat({"": b})
    assert set(fa) == set(fb), what
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), f"{what}: {k}"
        else:
            assert fa[k] == fb[k], f"{what}: {k}"


@pytest.mark.parametrize("extra", [[], ["--opt", "adan", "--remat", "true"]],
                         ids=["adamw", "adan_remat"])
def test_resumed_run_equals_the_uninterrupted_run(tmp_path, extra):
    argv = DEBUG + ["--epochs", "2", "--batch_size", "4", "--synthetic_len",
                    "16", "--warmup_epochs", "0", "--sparse", "-u", "2",
                    "--model_ema", "true", "--drop_path", "0.1",
                    "--nb_classes", "10"] + extra
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    main(parse_args(argv + ["--output_dir", whole]))
    # the run cut at the start of its second epoch: what it left on disk
    os.makedirs(cut)
    shutil.copy(os.path.join(whole, "checkpoint-0"), cut)
    saved = torch.load(os.path.join(cut, "checkpoint-0"), weights_only=False)
    seen = []

    def check_start(state, epoch, i):
        if not seen:
            seen.append((epoch, i))
            now = ckpt.state_dict(state, epoch - 1)
            for key in ("model", "optimizer", "mask_state", "ema", "step"):
                _same(now[key], saved[key], key)
    out = main(parse_args(argv + ["--output_dir", cut]), check_start)
    assert seen == [(1, 0)] and [s["epoch"] for s in out["epochs"]] == [1]

    a = torch.load(os.path.join(whole, "checkpoint-1"), weights_only=False)
    b = torch.load(os.path.join(cut, "checkpoint-1"), weights_only=False)
    assert a["step"] == b["step"] == 8
    for key in ("model", "optimizer", "mask_state", "ema"):
        _same(a[key], b[key], key)
    assert a["mask_state"]["masks"] and a["ema"]


def test_retention_window_matches_slak_tpu(tmp_path):
    """Checkpoints saved as the CLI saves them (every save_ckpt_freq
    epochs and the last, plus a 'best' tag), after each save the same
    names on disk as slak_tpu's (orbax directories there, files here)."""
    model = create_model("SLaK_debug", device="cpu",
                         kernel_size=(13, 11, 9, 7, 5), num_classes=10)
    state = create_train_state(model, TrainConfig())
    tree = {"w": np.zeros(2, np.float32)}
    epochs = 7
    for freq, num in ((1, 3), (2, 2)):
        ours, ref = tmp_path / f"ours{freq}{num}", tmp_path / f"ref{freq}{num}"
        ours.mkdir()
        ref.mkdir()
        for epoch in range(epochs):
            if (epoch + 1) % freq == 0 or epoch + 1 == epochs:
                ckpt.save_checkpoint(str(ours), state, epoch, None, freq, num)
                jckpt.save_checkpoint(str(ref), tree, epoch, None, freq, num)
            if epoch == 2:
                ckpt.save_checkpoint(str(ours), state, epoch, "best")
                jckpt.save_checkpoint(str(ref), tree, epoch, "best")
            assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)), epoch
        assert ckpt.latest_checkpoint(str(ours)).endswith(
            os.path.basename(jckpt.latest_checkpoint(str(ref))))


@pytest.mark.parametrize("flag", [["--n_devices", "2"],
                                  ["--multi_host", "true"],
                                  ["--tp_eval", "true"]])
def test_multi_device_flags_raise(flag, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    match = {"--n_devices": "nccl needs CUDA", "--multi_host":
             "no rank / world size", "--tp_eval": "with --eval"}[flag[0]]
    with pytest.raises((ValueError, RuntimeError), match=match):
        main(parse_args(DEBUG + flag))
