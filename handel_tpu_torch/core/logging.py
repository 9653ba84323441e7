"""Structured key-value logger — a copy of handel_tpu/core/logging.py
(reference: log.go:13-78).

A thin adapter over stdlib logging that mirrors the reference's leveled KV
interface (`Debug/Info/Warn/Error` with alternating key/value args and a
`with_fields` context, log.go:13-21).
"""

from __future__ import annotations

import logging


def _fmt(args) -> str:
    if not args:
        return ""
    if len(args) == 1:
        return str(args[0])
    pairs = []
    it = iter(args)
    for k in it:
        v = next(it, "")
        pairs.append(f"{k}={v}")
    return " ".join(pairs)


class Logger:
    """Leveled KV logger with bound context fields."""

    def __init__(self, name: str = "handel", fields: dict | None = None):
        self._log = logging.getLogger(name)
        self._fields = fields or {}

    def with_fields(self, **fields) -> "Logger":
        merged = {**self._fields, **fields}
        return Logger(self._log.name, merged)

    def _prefix(self) -> str:
        if not self._fields:
            return ""
        return " ".join(f"{k}={v}" for k, v in self._fields.items()) + " "

    def debug(self, *args):
        self._log.debug("%s%s", self._prefix(), _fmt(args))

    def info(self, *args):
        self._log.info("%s%s", self._prefix(), _fmt(args))

    def warn(self, *args):
        self._log.warning("%s%s", self._prefix(), _fmt(args))

    def error(self, *args):
        self._log.error("%s%s", self._prefix(), _fmt(args))


DEFAULT_LOGGER = Logger()
