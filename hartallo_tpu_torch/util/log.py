"""Leveled logging with an injectable callback.

Analog of the reference's debug subsystem (``hl_debug.h``,
``hl_api.h:41-43``: hl_debug_set_level + hl_debug_set_*_cb): a process
level filter and an optional user callback that receives every record
(level, module, message) before/instead of the standard handler.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

FATAL = logging.CRITICAL
ERROR = logging.ERROR
WARN = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG

_logger = logging.getLogger("hartallo_tpu")
_logger.addHandler(logging.NullHandler())
_callback: Optional[Callable[[int, str, str], None]] = None


def set_level(level: int) -> None:
    """Process-wide level filter (hl_debug_set_level analog)."""
    _logger.setLevel(level)


def set_callback(cb: Optional[Callable[[int, str, str], None]]) -> None:
    """Install a user callback receiving (level, module, message); pass
    None to restore default logging (hl_debug_set_*_cb analog)."""
    global _callback
    _callback = cb


def log(level: int, module: str, msg: str, *args) -> None:
    if args:
        msg = msg % args
    if _callback is not None:
        _callback(level, module, msg)
        return
    _logger.log(level, "[%s] %s", module, msg)


def warn(module: str, msg: str, *args) -> None:
    log(WARN, module, msg, *args)


def info(module: str, msg: str, *args) -> None:
    log(INFO, module, msg, *args)


def error(module: str, msg: str, *args) -> None:
    log(ERROR, module, msg, *args)
