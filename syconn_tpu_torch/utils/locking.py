"""Inter-process file locking (fcntl-based, no external deps; counterpart of
``syconn_tpu/utils/locking.py``): a bounded-retry flock.
The pipeline is designed single-writer (each shard written by exactly
one worker), so locks are a safety net for the interactive API, not the
synchronization backbone.
"""

from __future__ import annotations

import errno
import fcntl
import os
import time


class LockTimeout(TimeoutError):
    pass


class InterProcessLock:
    """Advisory exclusive lock on a sidecar ``.lk`` file."""

    def __init__(self, path: str):
        self.path = path
        self._fd = None

    def acquire(self, timeout: float = 30.0, poll: float = 0.05) -> bool:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR)
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return True
            except OSError as e:
                if e.errno not in (errno.EACCES, errno.EAGAIN):
                    raise
                if time.monotonic() >= deadline:
                    os.close(self._fd)
                    self._fd = None
                    return False
                time.sleep(poll)

    def release(self):
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        if not self.acquire():
            raise LockTimeout(f"Could not acquire lock {self.path}")
        return self

    def __exit__(self, *exc):
        self.release()
