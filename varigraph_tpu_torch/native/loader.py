"""On-demand build and ctypes loading of the native FASTQ reader.

The C++ source is the JAX package's ``varigraph_tpu/native/fastq_reader.cpp``
(read by path; reading a file imports nothing).  It is compiled with g++ into
``BUILD_DIR`` at first use.  Without a C++ toolchain, callers fall back to the
pure-Python reader.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

from .. import BUILD_DIR
from ..utils.log import log

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "varigraph_tpu", "native", "fastq_reader.cpp",
)
LIBRARY = os.path.join(BUILD_DIR, "libvgfastq.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build(out_path: str) -> bool:
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out_path))
    os.close(fd)
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp,
            SOURCE]
    error = ""
    try:
        # prefer libdeflate (whole-file inflate ~2-3x faster than zlib); fall
        # back to plain zlib when the library or its headers are absent
        for extra in (["-DVGF_USE_LIBDEFLATE", "-lz", "-ldeflate"], ["-lz"]):
            try:
                r = subprocess.run(base + extra, capture_output=True,
                                   text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                error = str(e)
                continue
            if r.returncode == 0:
                os.replace(tmp, out_path)
                return True
            lines = [ln for ln in r.stderr.splitlines() if "error" in ln]
            error = lines[0] if lines else f"g++ exit {r.returncode}"
        log(f"Warning: native FASTQ reader not built ({error}); "
            "reading FASTQ in Python, which is slower")
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_fastq_lib():
    """Returns the loaded ctypes library, or None if it cannot be built."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(SOURCE):
            return None
        if (not os.path.exists(LIBRARY)
                or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
            if not _build(LIBRARY):
                return None
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            log(f"Warning: native FASTQ reader not loaded ({e}); reading "
                "FASTQ in Python, which is slower")
            return None
        lib.vgf_open.restype = ctypes.c_void_p
        lib.vgf_open.argtypes = [ctypes.c_char_p]
        lib.vgf_next_batch_packed.restype = ctypes.c_long
        lib.vgf_next_batch_packed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.vgf_close.restype = None
        lib.vgf_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib
