"""Leveled verbose logging (weed/glog analog over stdlib logging).

The port's copy of ``seaweedfs_tpu/util/glog.py``.

`V(n)` gates on the -v level like glog: `glog.V(3).infof(...)` only
emits when the configured verbosity is >= 3. Level set via set_level()
or the WEED_V env var.
"""

from __future__ import annotations

import logging
import os
import sys

_logger = logging.getLogger("seaweedfs_tpu_torch")
if not _logger.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        )
    )
    _logger.addHandler(handler)
    _logger.setLevel(logging.INFO)

_verbosity = int(os.environ.get("WEED_V", "0"))


def set_level(v: int) -> None:
    global _verbosity
    _verbosity = v


def _msg(fmt: str, args: tuple) -> str:
    """Format a log line; inside an active traced request the line is
    prefixed with the short trace id so logs correlate with
    `/debug/traces` / `trace.dump` output (log↔trace correlation; the
    WEED_V machinery still decides WHICH lines emit)."""
    msg = fmt % args if args else fmt
    from ..tracing import span as trace_span

    sp = trace_span.current()
    if sp is not None:
        return f"[{sp.trace_id[:8]}] {msg}"
    return msg


class _Verbose:
    def __init__(self, enabled: bool):
        self.enabled = enabled

    def infof(self, fmt: str, *args) -> None:
        if self.enabled:
            _logger.info(_msg(fmt, args))


def V(level: int) -> _Verbose:  # noqa: N802 - glog naming
    return _Verbose(_verbosity >= level)


def infof(fmt: str, *args) -> None:
    _logger.info(_msg(fmt, args))


def warningf(fmt: str, *args) -> None:
    _logger.warning(_msg(fmt, args))


def errorf(fmt: str, *args) -> None:
    _logger.error(_msg(fmt, args))
