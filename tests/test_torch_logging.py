"""The port's observability (``slak_tpu_torch/utils/logging.py`` and the
train CLI's ``--log_dir``, ``--enable_wandb`` and ``--profile_dir``) on the
CPU.

  * the meters keep the tensors they are given and read them only when a
    statistic is asked for; the statistics then equal ``slak_tpu``'s
    meters fed the same numbers; ``MetricLogger.log_every`` prints at
    ``print_freq`` and at the last item, as ``slak_tpu``'s does;
  * ``EpochLogWriter`` appends one JSON line an epoch;
  * ``TensorboardLogger`` and ``WandbLogger`` against stand-in
    ``tensorboardX`` / ``wandb`` modules that record their calls, and as
    no-ops when the package does not import;
  * one CLI run of 22 steps with all three flags: TensorBoard scalars at
    every ``print_freq``-th step, the epoch's metrics and the checkpoint
    artifact to W&B, and a Chrome trace of steps [10, 20) (ten optimizer
    steps in it).
"""

import json
import os
import sys
import types

import pytest
import torch

from slak_tpu.utils import logging as jlog
from slak_tpu_torch.train.main import main, parse_args
from slak_tpu_torch.utils import logging as tlog


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """Every call made through it, as (name, args, kwargs)."""

    def __init__(self):
        self.calls = []

    def __call__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, args, kwargs))
        return record

    def named(self, name):
        return [(a, k) for n, a, k in self.calls if n == name]


def fake_tensorboardx(rec):
    mod = types.ModuleType("tensorboardX")

    class SummaryWriter:
        def __init__(self, logdir):
            rec("SummaryWriter")(logdir=logdir)
            self.add_scalar = rec("add_scalar")
            self.flush = rec("flush")
    mod.SummaryWriter = SummaryWriter
    return mod


def fake_wandb(rec):
    mod = types.ModuleType("wandb")
    mod.run = None

    def init(**kwargs):
        rec("init")(**kwargs)
        mod.run = types.SimpleNamespace(id="run0")

    class Artifact:
        def __init__(self, name, type):
            rec("Artifact")(name, type=type)
            self.add_dir = rec("add_dir")
    mod.init = init
    mod.Artifact = Artifact
    mod.define_metric = rec("define_metric")
    mod.log = rec("log")
    mod.log_artifact = rec("log_artifact")
    return mod


def test_meters_read_tensors_only_when_asked():
    vals = [0.5, 2.0, 1.25, 3.5, 0.75]
    ours, ref = tlog.SmoothedValue(window_size=4), jlog.SmoothedValue(4)
    for i, v in enumerate(vals):
        ours.update(torch.tensor(v), n=i + 1)
        ref.update(v, n=i + 1)
    assert len(ours._pending) == len(vals) and not ours.deque
    for stat in ("median", "avg", "global_avg", "max", "value"):
        assert getattr(ours, stat) == getattr(ref, stat), stat
    assert not ours._pending and str(ours) == str(ref)


def test_log_every_prints_where_slak_tpu_does(capsys):
    lines = []
    for mod in (tlog, jlog):
        logger = mod.MetricLogger()
        for _ in logger.log_every(range(7), 3, "Epoch: [0]"):
            logger.update(loss=torch.tensor(1.0) if mod is tlog else 1.0)
        out = capsys.readouterr().out.splitlines()
        lines.append([ln.split("  ")[0] for ln in out[:-1]])
    assert lines[0] == lines[1] == [
        "Epoch: [0] [0/7]", "Epoch: [0] [3/7]", "Epoch: [0] [6/7]"]


def test_epoch_log_writer_appends_json_lines(tmp_path):
    w = tlog.EpochLogWriter(str(tmp_path / "out"))
    w.write({"epoch": 0, "train_loss": 1.5})
    w.write({"epoch": 1, "train_loss": 1.25})
    with open(tmp_path / "out" / "log.txt") as f:
        assert [json.loads(ln) for ln in f] == [
            {"epoch": 0, "train_loss": 1.5}, {"epoch": 1, "train_loss": 1.25}]
    tlog.EpochLogWriter("").write({"epoch": 0})        # no directory: no-op


def test_tensorboard_logger(monkeypatch):
    rec = Recorder()
    monkeypatch.setitem(sys.modules, "tensorboardX", fake_tensorboardx(rec))
    tb = tlog.TensorboardLogger("runs/x")
    tb.set_step(4)
    tb.update(head="train", loss=torch.tensor(0.5), lr=None)
    tb.update(head="test", step=9, acc1=0.25)
    tb.set_step()
    tb.flush()
    assert rec.calls == [
        ("SummaryWriter", (), {"logdir": "runs/x"}),
        ("add_scalar", ("train/loss", 0.5, 4), {}),
        ("add_scalar", ("test/acc1", 0.25, 9), {}),
        ("flush", (), {})]
    assert tb.step == 5
    for name in ("tensorboardX", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)   # import fails
    off = tlog.TensorboardLogger("runs/y")
    assert off.writer is None
    off.update(loss=1.0)
    off.flush()


def test_wandb_logger(monkeypatch):
    rec = Recorder()
    monkeypatch.setitem(sys.modules, "wandb", fake_wandb(rec))
    args = types.SimpleNamespace(lr=0.004)
    wb = tlog.WandbLogger(args, "proj")
    assert wb.enabled
    wb.set_steps()
    wb.log_epoch_metrics({"epoch": 2, "train_loss": 1.0, "test_acc1": 0.5})
    wb.log_checkpoints("ckpts")
    assert rec.named("init") == [((), {"project": "proj",
                                       "config": {"lr": 0.004}})]
    assert [a for a, _ in rec.named("define_metric")] == [
        ("epoch",), ("Global Train/*",), ("Global Test/*",)]
    assert rec.named("log") == [(({"epoch": 2, "Global Train/train_loss": 1.0,
                                   "Global Test/test_acc1": 0.5},),
                                 {"commit": True})]
    assert rec.named("Artifact") == [(("run0_model",), {"type": "model"})]
    assert rec.named("add_dir") == [(("ckpts",), {})]
    assert len(rec.named("log_artifact")) == 1
    monkeypatch.setitem(sys.modules, "wandb", None)
    off = tlog.WandbLogger(args)
    assert not off.enabled
    off.set_steps()
    off.log_epoch_metrics({"train_loss": 1.0})
    off.log_checkpoints("ckpts")


def test_cli_sinks_and_profile_window(tmp_path, monkeypatch):
    tb, wb = Recorder(), Recorder()
    monkeypatch.setitem(sys.modules, "tensorboardX", fake_tensorboardx(tb))
    monkeypatch.setitem(sys.modules, "wandb", fake_wandb(wb))
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    main(parse_args([
        "--device", "cpu", "--model", "SLaK_debug", "--kernel_size", "13",
        "11", "9", "7", "5", "--Decom", "true", "--data_set", "synthetic",
        "--input_size", "32", "--use_bf16", "false", "--num_workers", "2",
        "--nb_classes", "10", "--batch_size", "2", "--synthetic_len", "44",
        "--epochs", "1", "--warmup_epochs", "0", "--disable_eval", "true",
        "--print_freq", "5", "--log_dir", str(tmp_path / "tb"),
        "--enable_wandb", "true", "--wandb_ckpt", "true",
        "--output_dir", out, "--profile_dir", prof]))

    scalars = [a for a, _ in tb.named("add_scalar")]
    assert [(tag, step) for tag, _, step in scalars] == [
        (tag, s) for s in (1, 6, 11, 16, 21)
        for tag in ("train/loss", "train/lr")]
    assert tb.named("flush")
    ((logged,), _), = wb.named("log")
    assert logged["epoch"] == 0 and "Global Train/train_loss" in logged
    assert wb.named("add_dir") == [((out,), {})]

    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events
             if e.get("name", "").startswith("Optimizer.step#")]
    assert len(steps) == 10
