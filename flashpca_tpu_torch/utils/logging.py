"""Timestamped logging.

Mirrors the reference's ``timestamp()`` prefix convention
(reference: util.cpp:270-283, flag --notime at flashpca.cpp:89,108):
every log line is prefixed with ``[asctime] `` unless timestamps are
globally disabled.
"""

from __future__ import annotations

import sys
import time

_show_timestamp = True
_default_stream = None          # None -> sys.stdout at call time


def set_show_timestamp(show: bool) -> None:
    global _show_timestamp
    _show_timestamp = bool(show)


def set_default_stream(stream) -> None:
    """Route every log()/note without an explicit ``file=`` to
    ``stream``.  bench.py points this at stderr so library notices can
    never break its one-JSON-line stdout contract (a tall-mode note on
    stdout cost a smoke test); the CLI keeps the reference's
    stdout convention.  Pass None to restore the default."""
    global _default_stream
    _default_stream = stream


def timestamp() -> str:
    if _show_timestamp:
        return "[" + time.asctime(time.localtime()) + "] "
    return ""


def log(*args, verbose: bool = True, file=None) -> None:
    """Print a timestamped log line (flushes immediately, like the
    reference's unitbuf stream)."""
    if not verbose:
        return
    out = (file if file is not None
           else (_default_stream if _default_stream is not None
                 else sys.stdout))
    print(timestamp() + " ".join(str(a) for a in args), file=out, flush=True)
