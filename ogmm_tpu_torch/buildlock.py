"""A lock across processes for the builds of the compiled libraries.

N processes of a fresh checkout (torchrun's ranks, a test's workers) may
all find a library missing at once; without a lock each would run the
compiler into the same build directory. `build_lock(dir)` holds an
exclusive `flock` on `dir/.build.lock` (created if missing): one process
builds, the others wait, then find the library there and load it.
"""
from __future__ import annotations

import contextlib
import fcntl
import os
from pathlib import Path


@contextlib.contextmanager
def build_lock(build_dir: Path):
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    fd = os.open(build_dir / ".build.lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
