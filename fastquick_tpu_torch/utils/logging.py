"""notice/warning/error loggers.

Mirrors the reference's printf-style loggers (statgen Error.cpp; externs at
reference src/FASTQuick.cpp:34-36) with wall/CPU timing helpers
(reference libbwa/utils.c realtime/cputime).
"""

from __future__ import annotations

import os
import sys
import time


def _stamp() -> str:
    return time.strftime("%Y/%m/%d %H:%M:%S")


def notice(fmt: str, *args) -> None:
    msg = fmt % args if args else fmt
    print(f"NOTICE [{_stamp()}] {msg}", file=sys.stderr, flush=True)


def warning(fmt: str, *args) -> None:
    msg = fmt % args if args else fmt
    print(f"WARNING [{_stamp()}] {msg}", file=sys.stderr, flush=True)


class FastQuickError(RuntimeError):
    pass


def error(fmt: str, *args) -> None:
    """Fatal error: raises instead of exit() so callers/tests can catch."""
    msg = fmt % args if args else fmt
    print(f"FATAL ERROR [{_stamp()}] {msg}", file=sys.stderr, flush=True)
    raise FastQuickError(msg)


def realtime() -> float:
    return time.time()


def cputime() -> float:
    t = os.times()
    return t.user + t.system
