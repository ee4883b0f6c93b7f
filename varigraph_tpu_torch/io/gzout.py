"""Buffered gz (or plain) text writer (reference include/save.hpp:27-78)."""

from __future__ import annotations

import gzip


class GzWriter:
    def __init__(self, path: str):
        self.path = path
        if path.endswith(".gz"):
            self._fh = gzip.open(path, "wt")
        else:
            self._fh = open(path, "wt")

    def write(self, text: str) -> None:
        self._fh.write(text)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
