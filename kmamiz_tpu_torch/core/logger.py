"""Leveled logger with the reference's fatal semantics.

A copy of kmamiz_tpu/core/logger.py (KMamiz src/utils/Logger.ts): the
stdlib logging stack with verbose/info/warn/error levels driven by the
LOG_LEVEL setting, and a `fatal()` that logs and signals the process to
terminate (Logger.ts:45-52 sends SIGTERM, so the graceful-exit hook of
kmamiz_tpu_torch.api.app.main flushes the caches first). Both servers'
`main()` apply LOG_LEVEL through `configure`.
"""
from __future__ import annotations

import logging
import os
import signal
from typing import Optional

VERBOSE = 5
logging.addLevelName(VERBOSE, "VERBOSE")

_LEVELS = {
    "verbose": VERBOSE,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}


def configure(level: Optional[str] = None) -> None:
    """Apply LOG_LEVEL (verbose|info|warn|error, Logger.ts:22-30) to the
    package's loggers."""
    from kmamiz_tpu_torch.config import settings

    name = (level or settings.log_level or "info").lower()
    logging.getLogger("kmamiz_tpu_torch").setLevel(_LEVELS.get(name, logging.INFO))


def get(name: str) -> logging.Logger:
    """Prefixed child logger (Logger.prefixed)."""
    return logging.getLogger(f"kmamiz_tpu_torch.{name}")


def verbose(logger: logging.Logger, msg: str, *args) -> None:
    logger.log(VERBOSE, msg, *args)


def fatal(logger: logging.Logger, msg: str, *args) -> None:
    """Log at error level and terminate through SIGTERM (Logger.ts:45-52)."""
    logger.error("FATAL: " + msg, *args)
    os.kill(os.getpid(), signal.SIGTERM)
