"""Observability: windowed meters and epoch logs, port of
``slak_tpu/utils/logging.py`` (the reference's ``SmoothedValue`` /
``MetricLogger``, ``utils.py:25-168``; JSON-lines epoch logs,
``main.py:498-502``; TensorBoard and W&B sinks, ``utils.py:171-249``).

A meter takes device tensors as they come and keeps them: the values are
read (one transfer a meter) only when a meter is printed or its statistics
are asked for, so ``MetricLogger.update`` does not wait for the card on
every step. The TensorBoard and W&B sinks import their packages only when
one is built.

Under data parallel only rank 0 prints, writes the epoch log and feeds
TensorBoard / W&B (``slak_tpu``'s ``process_index() == 0`` gates):
:func:`setup_for_distributed` silences ``print`` on the other ranks, as
the reference's does (utils.py:252-264), and the CLI builds its sinks on
rank 0 only.
"""

from __future__ import annotations

import builtins
import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Optional

import torch


def setup_for_distributed(is_master: bool):
    """``print`` prints on the master rank only, unless called with
    ``force=True`` (reference utils.py:252-264)."""
    builtin_print = getattr(builtins.print, "_slak_builtin",
                            builtins.print)

    def print_(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    print_._slak_builtin = builtin_print
    builtins.print = print_


class SmoothedValue:
    """A window of values and the global average (utils.py:25-84)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt
        self._pending: List = []            # (value, n), tensors unread

    def update(self, value, n: int = 1):
        self._pending.append((value, n))

    def _sync(self):
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        tens = [v for v, _ in pend if isinstance(v, torch.Tensor)]
        read = iter(torch.stack([t.detach().float().reshape(()).to(
            tens[0].device) for t in tens]).tolist() if tens else [])
        for v, n in pend:
            v = next(read) if isinstance(v, torch.Tensor) else float(v)
            self.deque.append(v)
            self.count += n
            self.total += v * n

    @property
    def median(self):
        self._sync()
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        self._sync()
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        self._sync()
        return self.total / max(self.count, 1)

    @property
    def max(self):
        self._sync()
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        self._sync()
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Periodic iteration logging with ETA (utils.py:87-168)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is not None:
                self.meters[k].update(v)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}"
                                   for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        """Yield from ``iterable``; every ``print_freq`` items (and at the
        last) print the meters, the host time an item took and the time
        spent waiting for it."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                print(f"{header} [{i}{f'/{total}' if total else ''}]  {eta}"
                      f"{self}  time: {iter_time}  data: {data_time}",
                      flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)", flush=True)


class EpochLogWriter:
    """JSON-lines per-epoch log, ``log.txt`` in the output directory
    (main.py:498-502)."""

    def __init__(self, output_dir: Optional[str]):
        self.path = os.path.join(output_dir, "log.txt") if output_dir \
            else None
        if self.path:
            os.makedirs(output_dir, exist_ok=True)

    def write(self, stats: Dict):
        if not self.path:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(stats) + "\n")


class TensorboardLogger:
    """utils.py:171-192: scalars to TensorBoard (tensorboardX, else
    torch.utils.tensorboard); does nothing when neither imports."""

    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(logdir=log_dir)
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(log_dir=log_dir)
            except ImportError:
                self.writer = None
        self.step = 0

    def set_step(self, step: Optional[int] = None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step: Optional[int] = None,
               **kwargs):
        if self.writer is None:
            return
        for k, v in kwargs.items():
            if v is not None:
                self.writer.add_scalar(f"{head}/{k}", float(v),
                                       self.step if step is None else step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()


class WandbLogger:
    """utils.py:195-249: step-metric definitions, the run's config,
    checkpoint artifacts; does nothing when wandb does not import."""

    def __init__(self, args=None, project: Optional[str] = None):
        try:
            import wandb
            self._wandb = wandb
        except ImportError:
            self._wandb = None
            return
        if self._wandb.run is None:
            self._wandb.init(project=project or "slak-tpu",
                             config=vars(args) if args else None)

    @property
    def enabled(self):
        return self._wandb is not None

    def set_steps(self):
        if not self.enabled:
            return
        self._wandb.define_metric("epoch")
        self._wandb.define_metric("Global Train/*", step_metric="epoch")
        self._wandb.define_metric("Global Test/*", step_metric="epoch")

    def log_epoch_metrics(self, metrics: Dict, commit: bool = True):
        if not self.enabled:
            return
        out = {}
        for k, v in metrics.items():
            if "train" in k:
                out["Global Train/" + k] = v
            elif "test" in k:
                out["Global Test/" + k] = v
            else:
                out[k] = v
        self._wandb.log(out, commit=commit)

    def log_checkpoints(self, output_dir: str):
        if not self.enabled:
            return
        art = self._wandb.Artifact(self._wandb.run.id + "_model",
                                   type="model")
        art.add_dir(output_dir)
        self._wandb.log_artifact(art)
