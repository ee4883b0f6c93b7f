"""Timestamped stderr logging.

Mirrors the reference's uniform ``[func::YYYY-MM-DD HH:MM:SS]`` prefix
(reference src/get_time.cpp:6-12 and its use throughout main.cpp / *.cpp).
"""

import sys
import time
import inspect


def _now() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def log(msg: str, func: str | None = None) -> None:
    """Print a timestamped log line to stderr.

    If *func* is not given, the caller's function name is used, matching the
    reference's ``__func__`` convention.
    """
    if func is None:
        frame = inspect.currentframe()
        func = frame.f_back.f_code.co_name if frame and frame.f_back else "?"
    sys.stderr.write(f"[{func}::{_now()}] {msg}\n")
    sys.stderr.flush()


class _Logger:
    """Tiny helper so call sites can write ``logger.info(...)``."""

    def info(self, msg: str, func: str | None = None) -> None:
        if func is None:
            frame = inspect.currentframe()
            func = frame.f_back.f_code.co_name if frame and frame.f_back else "?"
        log(msg, func)

    def warn(self, msg: str, func: str | None = None) -> None:
        if func is None:
            frame = inspect.currentframe()
            func = frame.f_back.f_code.co_name if frame and frame.f_back else "?"
        log("Warning: " + msg, func)

    def error(self, msg: str, func: str | None = None) -> None:
        if func is None:
            frame = inspect.currentframe()
            func = frame.f_back.f_code.co_name if frame and frame.f_back else "?"
        log("Error: " + msg, func)


logger = _Logger()
