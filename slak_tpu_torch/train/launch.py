"""Launcher of the port's data-parallel runs: port of
``slak_tpu/train/launch.py`` (the reference's SLURM / submitit stack and
its env:// rendezvous, ``run_with_submitit.py``, ``utils.py:296-332``).

One process a rank:

  * ``--nproc N`` starts N local ranks (spawned processes) that meet
    through a file in a temporary directory; each trains with
    ``cuda:<local rank mod card count>``, or the CPU with ``--device cpu``;
  * under ``torchrun`` (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT in the environment), or with the CLI's ``--multi_host
    true`` and those variables set by the user, this process is one rank
    and joins the env:// rendezvous, as the JAX launcher calls
    ``jax.distributed.initialize``.

The process group's backend is the train CLI's ``--dist_backend``: NCCL
(one card a rank, the default) or gloo (CPU ranks, or several ranks sharing
one card). Preemption recovery is the CLI's auto-resume.

``--kd`` runs the distillation CLI (``kd/main.py``) in each rank in place
of the train CLI.

Usage:
  python -m slak_tpu_torch.train.launch --nproc 2 -- <train args...>
  python -m slak_tpu_torch.train.launch --kd --nproc 2 -- <KD args...>
  torchrun --nproc_per_node 4 -m slak_tpu_torch.train.launch -- <args...>
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from slak_tpu_torch.parallel import mesh


def _rank_main(r, fn, fn_args, nproc, backend, device, tmp, init_timeout_s,
               threads):
    os.environ["LOCAL_WORLD_SIZE"] = str(nproc)
    dev = mesh.init_distributed(backend, f"file://{tmp}/rendezvous", r,
                                nproc, r, device, init_timeout_s)
    if dev.type == "cpu":       # the ranks share the caller's threads
        torch.set_num_threads(threads)
    try:
        out = fn(*fn_args)
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(tmp, f"result-{r}.pt"))


def run_ranks(fn: Callable, nproc: int, args: Sequence = (),
              backend: str = "nccl", device=None,
              timeout_s: Optional[float] = None,
              init_timeout_s: float = mesh.DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on ``nproc`` spawned local ranks of one process
    group (``backend``; each rank on ``mesh.rank_device(rank, device)``)
    and return their results in rank order (each picklable). A rank that
    raises fails the call with its error, after the others are stopped;
    ``timeout_s`` bounds the whole run, ``init_timeout_s`` every
    collective (and the rendezvous). CPU ranks split the caller's torch
    threads between them. ``fn`` must be importable by the spawned
    processes (a module-level function; a script that calls this must do
    so under ``if __name__ == "__main__"``, since each rank imports it)."""
    import torch.multiprocessing as tmp_mp
    threads = max(1, torch.get_num_threads() // nproc)
    tmp = tempfile.mkdtemp(prefix="slak_ranks_")
    try:
        ctx = tmp_mp.start_processes(
            _rank_main, args=(fn, tuple(args), nproc, backend, device, tmp,
                              init_timeout_s, threads),
            nprocs=nproc, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.time() + timeout_s
        try:
            while not ctx.join(timeout=5.0):
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(
                        f"{nproc} ranks of {getattr(fn, '__name__', fn)} "
                        f"still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(tmp, f"result-{r}.pt"),
                           weights_only=False) for r in range(nproc)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_rank(args):
    """One rank of the train CLI (``run_ranks``' function)."""
    from slak_tpu_torch.train.main import main as train_main
    return train_main(args)


def kd_rank(args):
    """One rank of the distillation CLI (``run_ranks``' function)."""
    from slak_tpu_torch.kd.main import main as kd_main
    return kd_main(args)


def main(argv=None):
    """Parse the launcher's flags, then the train CLI's (the distillation
    CLI's with ``--kd``) after ``--``, and run. Returns the CLI's result
    (rank 0's, for ``--nproc``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    launcher = argparse.ArgumentParser("SLaK (PyTorch) launcher")
    launcher.add_argument("--nproc", type=int, default=1,
                          help="local ranks to start")
    launcher.add_argument("--timeout", type=float, default=None,
                          help="seconds: the --nproc run's limit, and the "
                          "limit of each collective")
    launcher.add_argument("--kd", action="store_true",
                          help="launch the distillation CLI "
                          "(slak_tpu_torch.kd.main) instead of the train "
                          "CLI")
    if "--" in argv:
        split = argv.index("--")
        own, rest = argv[:split], argv[split + 1:]
    else:
        own, rest = [], argv
    args = launcher.parse_args(own)
    if args.kd:
        from slak_tpu_torch.kd.main import parse_args
        rank_fn = kd_rank
    else:
        from slak_tpu_torch.train.main import parse_args
        rank_fn = train_rank
    cli_args = parse_args(rest)
    if cli_args.multi_host or mesh.env_rank_world() is not None:
        cli_args.multi_host = True
        return rank_fn(cli_args)
    if args.nproc > 1:
        if cli_args.n_devices not in (None, args.nproc):
            raise ValueError(f"--n_devices {cli_args.n_devices} and "
                             f"--nproc {args.nproc} differ")
        cli_args.n_devices = args.nproc
        from slak_tpu_torch.train.main import spawn_ranks
        return spawn_ranks(cli_args, args.timeout, rank_fn)[0]
    return rank_fn(cli_args)


if __name__ == "__main__":
    main()
