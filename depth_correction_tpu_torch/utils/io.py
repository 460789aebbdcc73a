"""File writes under a lock file (counterpart of
``depth_correction_tpu/utils/io.py``).

Concurrent experiment jobs append to shared CSVs; a lock file created with
O_EXCL, retried at random intervals, serialises the writers across
processes (reference: src/depth_correction/io.py:7-65).
"""
from __future__ import annotations

import os
import random
import time

__all__ = ["PathLock", "append", "write"]


class PathLock:
    """``with PathLock(path):`` holds ``<path>.lock`` exclusively."""

    def __init__(self, path: str, interval: float = 0.01, timeout: float = 60.0):
        self.lock_path = path + ".lock"
        self.interval = interval
        self.timeout = timeout
        self._fd = None

    def __enter__(self):
        os.makedirs(os.path.dirname(self.lock_path) or ".", exist_ok=True)
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                self._fd = os.open(self.lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                return self
            except FileExistsError:
                if time.monotonic() > deadline:
                    raise TimeoutError("Could not acquire %s" % self.lock_path)
                time.sleep(self.interval * (1.0 + random.random()))

    def __exit__(self, *exc):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        try:
            os.remove(self.lock_path)
        except FileNotFoundError:
            pass
        return False


def write(path: str, text: str, mode: str = "w"):
    """Write ``text`` to ``path`` under its lock."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with PathLock(path):
        with open(path, mode) as f:
            f.write(text)


def append(path: str, text: str):
    """Append ``text`` to ``path`` under its lock (reference: io.py:16-21)."""
    write(path, text, mode="a")
