"""The host transforms' random stream.

The train transforms and RandAugment draw from :func:`host_rng`: the
Python ``random`` module (as ``slak_tpu.data`` does), or, inside
:func:`seeded`, a ``random.Random`` of the calling thread's own. A loader
worker thread builds its batches inside ``seeded(worker_seed)``, so its
draws do not depend on how the threads interleave; a worker process seeds
the module itself.
"""

from __future__ import annotations

import contextlib
import random
import threading

_LOCAL = threading.local()


def host_rng():
    """The current thread's ``random.Random``, else the ``random``
    module."""
    return getattr(_LOCAL, "rng", None) or random


@contextlib.contextmanager
def seeded(seed: int):
    """Within, :func:`host_rng` on this thread is ``random.Random(seed)``."""
    before = getattr(_LOCAL, "rng", None)
    _LOCAL.rng = random.Random(seed)
    try:
        yield _LOCAL.rng
    finally:
        _LOCAL.rng = before
