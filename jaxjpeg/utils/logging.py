"""Category x level logging, env-configured.

Analogue of the reference's logging subsystem (logging.{h,c}):
categories crossed with levels, configured once from the environment variable
``JAXJPEG_LOG`` using the same grammar as the reference's ``GLJ_LOG``
(logging.c:76-123): a comma-separated list of ``category:LEVEL`` entries,
e.g. ``JAXJPEG_LOG=generic:DEBUG,entropy:INFO``.  The pseudo-category
``all`` sets every category.

Implemented on top of stdlib logging so sinks are pluggable
(cf. the reference's settable logger function, logging.h:41-42).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

CATEGORIES = ("generic", "entropy", "kernel", "engine", "parallel", "test")

_LEVELS: Dict[str, int] = {
    "FATAL": logging.CRITICAL,
    "ERROR": logging.ERROR,
    "WARN": logging.WARNING,
    "WARNING": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
}

_initialized = False


def _parse_env(spec: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry or ":" not in entry:
            continue
        cat, _, level = entry.partition(":")
        cat = cat.strip().lower()
        lvl = _LEVELS.get(level.strip().upper())
        if lvl is None:
            continue
        if cat == "all":
            for c in CATEGORIES:
                out[c] = lvl
        elif cat in CATEGORIES:
            out[cat] = lvl
    return out


def init(spec: str | None = None) -> None:
    """Initialise logging once (cf. glj_log_init, logging.c:76)."""
    global _initialized
    if _initialized:
        return
    _initialized = True
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("[%(name)s] %(levelname)s: %(message)s")
    )
    root = logging.getLogger("jaxjpeg")
    root.addHandler(handler)
    root.setLevel(logging.WARNING)
    root.propagate = False
    if spec is None:
        spec = os.environ.get("JAXJPEG_LOG", "")
    for cat, lvl in _parse_env(spec).items():
        logging.getLogger(f"jaxjpeg.{cat}").setLevel(lvl)


def get_logger(category: str = "generic") -> logging.Logger:
    if category not in CATEGORIES:
        raise ValueError(f"unknown log category {category!r}; use one of {CATEGORIES}")
    init()
    return logging.getLogger(f"jaxjpeg.{category}")
