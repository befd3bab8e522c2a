"""Tiny leveled logger for the CLIs and benchmark harness.

Source of truth: the only place ``--quiet``/``--verbose`` semantics live —
``launch.serve`` and ``benchmarks.run`` report through here instead of
ad-hoc ``print`` calls.

Deliberately not ``logging``: at the default level, ``info`` output is the
message verbatim on stdout (flushed), so existing consumers of the CLI /
benchmark output see byte-identical text; ``debug`` adds a dim prefix and
only appears under ``--verbose``; ``warning``/``error`` go to stderr and
survive ``--quiet``.
"""
from __future__ import annotations

import sys

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

_level = LEVELS["info"]


def set_level(name: str):
    """Set the global threshold ("debug" | "info" | "warning" | "error")."""
    global _level
    if name not in LEVELS:
        raise ValueError(f"unknown log level {name!r}, "
                         f"expected one of {sorted(LEVELS)}")
    _level = LEVELS[name]


def level_from_flags(quiet: bool = False, verbose: bool = False) -> str:
    """The CLI mapping: --quiet -> warning, --verbose -> debug."""
    if quiet and verbose:
        raise ValueError("--quiet and --verbose are mutually exclusive")
    return "warning" if quiet else "debug" if verbose else "info"


class Logger:
    def __init__(self, name: str = "repro"):
        self.name = name

    def debug(self, msg: str):
        if _level <= LEVELS["debug"]:
            print(f"[{self.name}] {msg}", flush=True)

    def info(self, msg: str):
        if _level <= LEVELS["info"]:
            print(msg, flush=True)

    def warning(self, msg: str):
        if _level <= LEVELS["warning"]:
            print(f"[{self.name}] warning: {msg}", file=sys.stderr,
                  flush=True)

    def error(self, msg: str):
        if _level <= LEVELS["error"]:
            print(f"[{self.name}] error: {msg}", file=sys.stderr, flush=True)


def get_logger(name: str = "repro") -> Logger:
    return Logger(name)
