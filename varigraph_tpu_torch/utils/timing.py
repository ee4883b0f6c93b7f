"""Process resource reporting (reference include/sys.hpp:8-28)."""

import resource
import time

_T0 = time.monotonic()


def realtime() -> float:
    """Wall-clock seconds since process start (approximated by module import)."""
    return time.monotonic() - _T0


def cputime() -> float:
    """User + system CPU seconds of this process and its children."""
    ru_self = resource.getrusage(resource.RUSAGE_SELF)
    ru_child = resource.getrusage(resource.RUSAGE_CHILDREN)
    return (
        ru_self.ru_utime + ru_self.ru_stime + ru_child.ru_utime + ru_child.ru_stime
    )


def peakrss() -> float:
    """Peak resident set size in bytes."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    # ru_maxrss is KiB on Linux
    return ru.ru_maxrss * 1024.0


def report(prefix: str = "varigraph") -> str:
    return (
        f"[{prefix}] Real time: {realtime():.3f} sec; CPU: {cputime():.3f} sec; "
        f"Peak RSS: {peakrss() / 1024.0 / 1024.0 / 1024.0:.3f} GB"
    )
