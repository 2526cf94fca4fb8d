"""An exclusive lock between processes on one machine, held on a build
directory itself (no lock file is left in it): the first process to take
it builds, the others wait and then find the result (``ops/cuda/build.py``,
``utils/native.py``)."""
from __future__ import annotations

import contextlib
import fcntl
import os
from pathlib import Path


@contextlib.contextmanager
def dir_lock(path: Path):
    """Hold ``flock(LOCK_EX)`` on the directory ``path`` (created if
    missing) for the block. Each call opens it anew, so threads of one
    process exclude each other too."""
    path.mkdir(parents=True, exist_ok=True)
    fd = os.open(path, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)
