"""Structured logger with the launchers' human-readable console format.

Replaces the ad-hoc ``print(f"[serve] ...")`` pattern: the same
``[name] message key=value`` lines land on stdout, but now behind a level
filter (``REPRO_LOG=debug|info|warning|error`` or ``--log-level``), with
%-style lazy formatting (suppressed records never format their message), and
— when tracing is enabled — mirrored into the trace as ``log`` events so a
Chrome/Perfetto timeline shows the narration alongside the spans.

Zero stdlib-``logging`` machinery: one module-level threshold, one class.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict

DEBUG, INFO, WARNING, ERROR = 10, 20, 30, 40
_LEVELS: Dict[str, int] = {"debug": DEBUG, "info": INFO,
                           "warning": WARNING, "error": ERROR}
_level = _LEVELS.get(os.environ.get("REPRO_LOG", "").lower(), INFO)


def set_level(level: str | int) -> None:
    """Set the process log threshold (name or numeric)."""
    global _level
    if isinstance(level, str):
        try:
            _level = _LEVELS[level.lower()]
        except KeyError:
            raise ValueError(f"unknown log level {level!r}; "
                             f"choose from {sorted(_LEVELS)}") from None
    else:
        _level = int(level)


def level_name() -> str:
    for name, v in _LEVELS.items():
        if v == _level:
            return name
    return str(_level)


class Logger:
    """Named logger: ``log.info("planned %d layers", n, path=str(p))``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _emit(self, level: int, level_name: str, msg: str, args, fields
              ) -> None:
        if level < _level:
            return
        if args:
            msg = msg % args
        if fields:
            msg = msg + " " + " ".join(
                f"{k}={v}" for k, v in fields.items())
        print(f"[{self.name}] {msg}", flush=True)
        from . import trace
        if trace._enabled:
            trace.record_event({
                "ev": "log", "level": level_name, "name": self.name,
                "msg": msg, "tid": threading.get_ident()})

    def debug(self, msg: str, *args, **fields) -> None:
        self._emit(DEBUG, "debug", msg, args, fields)

    def info(self, msg: str, *args, **fields) -> None:
        self._emit(INFO, "info", msg, args, fields)

    def warning(self, msg: str, *args, **fields) -> None:
        self._emit(WARNING, "warning", msg, args, fields)

    def error(self, msg: str, *args, **fields) -> None:
        self._emit(ERROR, "error", msg, args, fields)
        sys.stdout.flush()


_loggers: Dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    log = _loggers.get(name)
    if log is None:
        log = _loggers[name] = Logger(name)
    return log
