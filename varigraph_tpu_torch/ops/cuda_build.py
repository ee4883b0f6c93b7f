"""Building and loading the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  At first use it
is compiled with ``nvcc`` for Hopper (sm_90a) into a shared library under
``BUILD_DIR`` (git-ignored) and loaded with ctypes; it is rebuilt when the
source is newer than the library.  A failed build raises: there is no fall
back to plain code on a CUDA tensor.

``LAUNCHES`` counts kernel launches by kernel name.  Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Callable

from .. import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# kernel launches by kernel name; incremented only where a kernel launches
LAUNCHES: collections.Counter = collections.Counter()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


class KernelLibrary:
    """One ``csrc/`` source and the shared library built from it.

    declare: sets ``argtypes``/``restype`` of the library's functions."""

    def __init__(self, source: str, library: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.source = os.path.join(CSRC, source)
        self.library = os.path.join(BUILD_DIR, library)
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def load(self) -> ctypes.CDLL:
        """Compile (if the library is missing or older than its source) and
        load.  Raises RuntimeError when nvcc fails."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            if (not os.path.exists(self.library)
                    or os.path.getmtime(self.library) < os.path.getmtime(self.source)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                                       capture_output=True, text=True)
                    if r.returncode != 0:
                        raise RuntimeError(f"nvcc failed to build {self.source}:\n"
                                           f"{r.stdout}{r.stderr}")
                    os.replace(tmp, self.library)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(self.library)
            self._declare(lib)
            self._lib = lib
            return lib
