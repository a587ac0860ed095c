"""Console + file tee logger (the reference's Loger.Logger behaviour):
writes go to the console and a file, flush fsyncs, parent dirs are made."""
from __future__ import annotations

import os
import sys


def mkdir_if_missing(path: str) -> None:
    if path and not os.path.exists(path):
        os.makedirs(path, exist_ok=True)


class Logger:
    """sys.stdout tee; as a context manager it restores the stream on exit."""

    def __init__(self, fpath: str | None = None, mode: str = "a"):
        # append by default, as the reference does: repeated runs
        # accumulate into one log
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            mkdir_if_missing(os.path.dirname(fpath))
            self.file = open(fpath, mode)

    def __enter__(self):
        self._saved = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._saved
        self.close()

    def __del__(self):
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None
